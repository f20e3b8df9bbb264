"""The port's sharded serve step (``launch.serve_mesh.ShardedServer``) on
CPU process groups (gloo).

Multi-rank runs are 2 or 4 processes started by
``torch_mesh_workers.launch``; world-of-one runs join a 1-rank gloo group
in this process. Every group is destroyed after its test.

Held:
* a world of one (every region of one rank) against ``lm.prefill`` and
  ``lm.decode_step`` on the same weights, a prefill of 4 x 8 tokens and 8
  greedy decode steps, bit for bit: logits, tokens and every cache leaf,
  for the qwen3, jamba, dbrx, llama4, llama-3.2-vision and whisper smoke
  configs (bf16, as published); every attention and FFN module a region,
  every weight filled once at ``load``, no region left set after a step;
  with ``BIG_MODEL_B`` at 0 (dbrx) the same bits with every weight but
  the norms filled for each step, a period at a time;
* (1, 2): the qwen3 (qk-norm, one KV head a rank), jamba (Mamba channels,
  attention, experts), dbrx (top-2 experts) and llama-3.2-vision
  (cross-attention) smoke configs in f32, each rank's greedy tokens equal
  to one rank's without a mesh and its logits within 1e-5 x max|logit|,
  every MoE call's choices and drops equal; each rank's self-attention
  K/V at every KV head and its half of the positions (rank 1's block
  starts empty, and the decode steps cross the blocks' edge), the two
  blocks together equal to one rank's cache within 1e-5 x max|k|, and the
  cache's bytes those of the reference's ``cache_specs``; its Mamba
  channels (half) and cross K/V at every KV head and its half of the
  patch tokens; every weight resident and filled at the rank's block;
* the (1, 2) qwen3 run's logits against the reference's ``lm.prefill`` /
  ``lm.decode_step`` (JAX, CPU) from the same initial parameters, fed the
  same tokens, within ``tests/test_torch_model.py``'s f32 tolerance;
* (2, 2): the llama4 smoke config with ``BIG_MODEL_B`` at 0, so that its
  serve placements also split over 'data': each data-parallel rank serves
  its 2 rows, equal to one rank serving those rows (tokens; logits within
  1e-5 x max|logit|), only the norms resident and every other weight
  filled for each step, the blocks' a period at a time, a region's at the
  rank's block.
"""
import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_workers as workers
from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve_mesh import ShardedServer
from repro_torch.models import lm, moe
from repro_torch.models import sharding
from repro_torch.models.tensor_parallel import Region

#: the smoke configs held bit for bit on a world of one
ONE_ARCHS = ("qwen3-1.7b", "jamba-v0.1-52b", "dbrx-132b",
             "llama4-maverick-400b-a17b", "llama-3.2-vision-11b",
             "whisper-tiny")
#: test_torch_model.py's f32 tolerance against the reference
REF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    """A 1-rank gloo process group in this process, destroyed after."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rdv1'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _module_names(cfg, kinds):
    return {n for n, mod in lm.LM(cfg, "meta").named_modules()
            if type(mod).__name__ in kinds}


def _world_of_one(arch):
    """(plain results, sharded results, the server, its fills) of
    ``arch``'s smoke config on a world of one."""
    cfg = get(arch).smoke()
    model = workers._model(cfg)
    tokens, cross = workers.serve_inputs(cfg)
    plain = workers.plain_serve(model, cfg, tokens, cross)
    server = ShardedServer(cfg, make_host_mesh(model=1, device="cpu"),
                           "cpu")
    fills, fill = [], server._fill

    def recording_fill(params, names, whole=False):
        fill(params, names, whole)
        fills.append(list(names))

    server._fill = recording_fill
    server.load(model)
    return plain, workers.sharded_serve(server, tokens, cross), server, fills


def _bits_equal(plain, sharded):
    (logits, chosen, cache), (logits_m, chosen_m, cache_m) = plain, sharded
    assert torch.equal(logits, logits_m)
    assert torch.equal(chosen, chosen_m)
    for f in ("k", "v", "kv_len"):
        assert torch.equal(getattr(cache, f), getattr(cache_m, f)), f
    assert set(cache.state) == set(cache_m.state)
    for k, t in cache.state.items():
        assert torch.equal(t, cache_m.state[k]), k


@pytest.mark.parametrize("arch", ONE_ARCHS)
def test_world_of_one_serve_bit_equal(world_of_one, arch):
    plain, sharded, server, fills = _world_of_one(arch)
    _bits_equal(plain, sharded)
    cfg = server.cfg
    assert server.region is not None and server.region.size == 1
    assert {"", "blocks.0.ffn"} | _module_names(
        cfg, ("Attention", "FFN", "MoE", "Mamba")) <= set(server.split)
    # every weight filled once, at load; no step fills, no region stays
    assert len(fills) == 1 and not server.params
    assert set(server.resident) == set(dict(server.model.named_parameters()))
    assert all(getattr(m, "tp", None) is None
               for m in server.model.modules())


def test_world_of_one_serve_fills_per_period(world_of_one, monkeypatch):
    """dbrx's smoke config with BIG_MODEL_B at 0: its serve placements
    split the weights over 'data' (of size 1), so only the replicated ones
    (norms) are resident and each step fills the other outside weights,
    then each period, one at a time; the same bits."""
    monkeypatch.setattr(sharding, "BIG_MODEL_B", 0)
    plain, sharded, server, fills = _world_of_one("dbrx-132b")
    _bits_equal(plain, sharded)
    cfg = server.cfg
    names = list(dict(server.model.named_parameters()))
    assert server.resident == tuple(
        k for k in names if not any(server.pspecs[k]))
    assert all(k.endswith(".g") for k in server.resident)
    assert sorted(server.params) == sorted(set(names)
                                           - set(server.resident))
    outside = [n for n in server.params if not n.startswith("blocks.")]
    per_step = [sorted(outside)] + [
        sorted(n for n in server.params if n.startswith(f"blocks.{li}."))
        for li in range(cfg.n_layers)]
    steps = 1 + workers.SERVE["steps"]
    assert [sorted(f) for f in fills] == [sorted(server.resident)] + \
        per_step * steps
    # between steps only the resident weights hold storage
    assert {k for k, p in server.model.named_parameters()
            if p.untyped_storage().nbytes()} == set(server.resident)


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _one_rank(arch, model=None, rows=None):
    """The plain serve of ``arch``'s f32 smoke config from ``model``
    (default ``workers._model``) on ``rows`` of the inputs (default
    all): (logits, tokens, cache, MoE routing)."""
    cfg = workers._train_cfg(arch)
    tokens, cross = workers.serve_inputs(cfg)
    if rows is not None:
        tokens = tokens[rows]
        cross = {k: x[rows] for k, x in cross.items()}
    moe.ROUTING = []
    try:
        out = workers.plain_serve(model or workers._model(cfg), cfg, tokens,
                                  cross)
        return (*out, [(e, int(d)) for e, d in moe.ROUTING])
    finally:
        moe.ROUTING = None


def _held_to_one_rank(run, want):
    logits, chosen, _, routing = want
    assert torch.equal(run["tokens"], chosen)
    assert _rel_err(run["logits"], logits) <= 1e-5
    assert len(run["routing"]) == len(routing)
    for (e, d), (we, wd) in zip(run["routing"], routing):
        assert torch.equal(e, we) and d == wd


def _ref_init(arch):
    """(the reference's f32 smoke config, its ``lm.init`` parameters, the
    port's model from them)."""
    rcfg = dataclasses.replace(ref_get(arch).smoke(), dtype="float32")
    params = rlm.init(jax.random.key(0), rcfg)
    return rcfg, params, lm_params_from_numpy(
        jax.tree.map(np.asarray, params), workers._train_cfg(arch), "cpu")


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """The SERVE_JOBS on (1, 2), each rank's runs by arch; qwen3 starts
    from the reference's initial parameters."""
    runs = [{} for _ in range(2)]
    for job, archs in workers.SERVE_JOBS.items():
        tmp = tmp_path_factory.mktemp(job)
        if "qwen3-1.7b" in archs:
            torch.save(_ref_init("qwen3-1.7b")[2].state_dict(),
                       tmp / "init_qwen3-1.7b.pt")
        for mine, got in zip(runs, workers.launch(job, 2, tmp)):
            mine.update(got)
    return runs


@pytest.mark.parametrize("arch", workers.SERVE_ARCHS)
def test_serve_1x2_matches_one_rank(serve_runs, arch):
    cfg = workers._train_cfg(arch)
    model = _ref_init(arch)[2] if arch == "qwen3-1.7b" else None
    want = _one_rank(arch, model)
    assert bool(want[3]) == (cfg.moe is not None)
    names = dict(workers._model(cfg).named_parameters())
    for r, run in enumerate((ranks[arch] for ranks in serve_runs)):
        assert run["tp_cleared"]
        assert run["rows"].tolist() == list(range(workers.SERVE["rows"]))
        _held_to_one_rank(run, want)
        # every weight resident, filled once at the rank's block
        assert set(run["resident"]) == set(names) and not run["stored"]
        assert len(run["fills"]) == 1
        split = {k: sp for ds in run["split"].values()
                 for k, sp in ds.items()}
        for k, shape in run["fills"][0].items():
            sp = split.get(k)
            if sp is not None and sp.dim is not None:
                assert shape[sp.dim] == sum(b - a for a, b in sp.ranges[r])
            else:
                assert shape == tuple(names[k].shape), k
        # the self-attention K/V: every KV head at the rank's 12 of the 24
        # positions (the prompt's 8 in rank 0's; the decode steps write
        # 8..15, across the edge), as the reference's cache_specs; half the
        # Mamba channels, cross K/V every KV head at the rank's half of the
        # patch tokens
        S, half = workers.SERVE["max_seq"], workers.SERVE["max_seq"] // 2
        assert workers.SERVE["prompt"] < half < (
            workers.SERVE["prompt"] + workers.SERVE["steps"])
        assert run["cache"]["k"] == (lm.n_attn(cfg), workers.SERVE["rows"],
                                     half, cfg.n_kv_heads, cfg.hd)
        assert run["cache_max_seq"] == S
        assert run["cache_bytes"]["port"] == run["cache_bytes"]["spec"]
        assert sum(t.nbytes for t in run["cache_kv"]) == \
            run["cache_bytes"]["kv_spec"]
        blocks = lm.cache_widths(cfg, Region(None, 2, r))
        if "mamba.h" in run["cache"]:
            di = blocks["mamba.h"].hi - blocks["mamba.h"].lo
            assert run["cache"]["mamba.h"][2] == di
            assert run["cache"]["mamba.conv"][3] == di
            assert 2 * di == cfg.ssm.expand * cfg.d_model
        if "cross.k" in run["cache"]:
            T = cfg.cross_kv_tokens
            assert blocks["cross.k"] == (1, r * T // 2, (r + 1) * T // 2)
            assert run["cache"]["cross.k"][2:] == (T // 2, cfg.n_kv_heads,
                                                   cfg.hd)
    # the ranks' blocks, in rank order, are the one-rank cache
    cache = want[2]
    for i, whole in enumerate((cache.k, cache.v)):
        got = torch.cat([ranks[arch]["cache_kv"][i] for ranks in serve_runs],
                        dim=2)
        assert got.shape == whole.shape
        assert _rel_err(got, whole) <= 1e-5


def test_serve_1x2_matches_reference(serve_runs):
    """The (1, 2) qwen3 run's logits, prefill and every decode step fed the
    tokens it chose, against the reference's lm.prefill / decode_step."""
    rcfg, params, _ = _ref_init("qwen3-1.7b")
    tokens, _ = workers.serve_inputs(workers._train_cfg("qwen3-1.7b"))
    rlogits, rcache = rlm.prefill(
        params, rcfg, {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)},
        max_seq=workers.SERVE["max_seq"])
    want = [np.asarray(rlogits)]
    run = serve_runs[0]["qwen3-1.7b"]
    for step in range(workers.SERVE["steps"]):
        tok = run["tokens"][:, step:step + 1].numpy().astype(np.int32)
        rlogits, rcache = rlm.decode_step(params, rcfg, jnp.asarray(tok),
                                          rcache)
        want.append(np.asarray(rlogits))
    for ranks in serve_runs:
        np.testing.assert_allclose(ranks["qwen3-1.7b"]["logits"].numpy(),
                                   np.stack(want), atol=REF_TOL,
                                   rtol=REF_TOL)


def test_serve_2x2_fills_each_period(tmp_path):
    """llama4's smoke config on (2, 2), BIG_MODEL_B at 0: each
    data-parallel rank's 2 rows against one rank serving them; every
    weight but the norms filled for each step, the outside ones first and
    then each period of 2 layers, a region's weights at the rank's
    block."""
    ranks = workers.launch("serve4", 4, tmp_path)
    arch = workers.MOE_ARCHS[0]
    cfg = workers._train_cfg(arch)
    P = len(cfg.pattern)
    names = dict(workers._model(cfg).named_parameters())
    stored = sorted(n for n in names if not n.endswith(".g"))
    outside = [n for n in stored if not n.startswith("blocks.")]
    periods = [[n for n in stored if n.startswith("blocks.")
                and int(n.split(".")[1]) // P == p]
               for p in range(cfg.n_layers // P)]
    for rank, run in enumerate(ranks):
        rows = [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert run["rows"].tolist() == rows and run["tp_cleared"]
        _held_to_one_rank(run, _one_rank(arch, rows=rows))
        # only the norms (replicated) are resident
        assert run["stored"] == stored
        assert sorted(run["resident"]) == sorted(set(names) - set(stored))
        steps = [sorted(f) for f in run["fills"]]
        assert steps == [sorted(run["resident"])] + (
            [outside] + periods) * (1 + workers.SERVE["steps"])
        split = {k: sp for ds in run["split"].values()
                 for k, sp in ds.items()}
        for fill in run["fills"]:
            for k, shape in fill.items():
                sp = split.get(k)
                if sp is not None and sp.dim is not None:
                    assert shape[sp.dim] == sum(
                        b - a for a, b in sp.ranges[rank % 2]), k
                else:
                    assert shape == tuple(names[k].shape), k


def test_server_refuses_a_mesh_on_another_device(world_of_one):
    with pytest.raises(ValueError, match="mesh on cpu"):
        ShardedServer(get("qwen3-1.7b").smoke(),
                      make_host_mesh(model=1, device="cpu"), "meta")


def test_server_runs_on_the_card_unless_told(world_of_one, monkeypatch):
    """Without a device the server resolves CUDA, and where torch sees no
    card it raises instead of taking the CPU mesh on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on CUDA by default"):
        ShardedServer(get("qwen3-1.7b").smoke(),
                      make_host_mesh(model=1, device="cpu"))
