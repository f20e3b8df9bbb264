"""The sharded serve step's cross-attention K/V and xLSTM states, laid out
as the reference's ``sharding.cache_specs`` lays them out
(``launch.serve_mesh.ShardedServer``), on CPU process groups (gloo).

Multi-rank runs are processes started by ``torch_mesh_workers.launch``
(``STATE_JOBS``); world-of-one runs join a 1-rank gloo group in this
process. Every group is destroyed after its test.

Held:
* a world of one against ``lm.prefill`` and ``lm.decode_step``, a prefill
  of 4 x 8 tokens and 8 greedy steps, bit for bit (logits, tokens, every
  cache leaf), for the xlstm-1.3b and whisper-tiny smoke configs (bf16):
  xLSTM's states split over the region of one rank, so its decode runs
  the block steps;
* (1, 4), f32, 2 rows: xlstm (C split over its value axis, m whole) and
  whisper (attention no region, cross K/V over its 64 frames); (1, 2), 3
  rows: xlstm (C and m over heads). Each rank's tokens equal one rank's,
  its logits within 1e-5 x max|logit|; each leaf's shape the block that
  ``cache_specs`` gives it, the ranks' blocks joined along the spec's axis
  equal to one rank's leaf within 1e-5 x max, and the port's bytes the
  spec's;
* the (1, 4) xlstm run's logits against the reference's ``lm.prefill`` /
  ``lm.decode_step`` (JAX, CPU) from the same initial parameters, within
  the tolerance ``test_torch_families.py`` holds xlstm to;
* with no process group: ``_mlstm_chunk`` on a head block and on a block
  of C's value axis against the whole call's slice; the cross partial
  over 1, 2 and 4 blocks of the positions, merged, against
  ``_plain_attention``; ``make_cache(tp=)`` of the full vision, whisper
  and xlstm configs against ``local_shape`` under ``cache_specs`` on (16,
  16); a state layout that the axis cannot meet raises.
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
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import sharding
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import xlstm as X
from repro_torch.models.tensor_parallel import Region

#: the f32 tolerance against the reference that test_torch_families.py
#: holds xlstm's plain prefill and decode to (1e-5 elsewhere): the
#: port's plain serve of this run is itself 1.7e-5 from it
REF_TOL = 5e-5
XLSTM = "xlstm-1.3b"


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


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", (XLSTM, "whisper-tiny"))
def test_world_of_one_state_bit_equal(world_of_one, arch):
    cfg = get(arch).smoke()
    model = workers._model(cfg)
    tokens, cross = workers.serve_inputs(cfg)
    plain = workers.plain_serve(model, cfg, tokens, cross)
    server = ShardedServer(cfg, make_host_mesh(model=1, device="cpu"),
                           "cpu")
    server.load(model)
    sharded = workers.sharded_serve(server, tokens, cross)
    (logits, chosen, cache), (logits_m, chosen_m, cache_m) = plain, sharded
    assert torch.equal(logits, logits_m) and torch.equal(chosen, chosen_m)
    for f in ("k", "v", "kv_len"):
        assert torch.equal(getattr(cache, f), getattr(cache_m, f)), f
    assert set(cache.state) == set(cache_m.state)
    for k, t in cache.state.items():
        assert torch.equal(t, cache_m.state[k]), k
    assert cache_m.max_seq == workers.SERVE["max_seq"]
    # xLSTM: the states split over the region of one rank (block steps)
    assert server.split_states is (True if arch == XLSTM else None)
    assert all(getattr(m, "tp", None) is None for m in model.modules())


# ---------------------------------------------------------------------------
# (1, 4) and (1, 2)
# ---------------------------------------------------------------------------

def _ref_init(arch):
    """(the reference's f32 smoke config, its ``lm.init`` parameters, the
    port's model from them)."""
    rcfg = dataclasses.replace(ref_get(arch).smoke(), dtype="float32")
    params = rlm.init(jax.random.key(0), rcfg)
    return rcfg, params, lm_params_from_numpy(
        jax.tree.map(np.asarray, params), workers._train_cfg(arch), "cpu")


@pytest.fixture(scope="module")
def state_runs(tmp_path_factory):
    """{job: each rank's runs by arch}; xlstm on (1, 4) starts from the
    reference's initial parameters."""
    out = {}
    for job, (mesh_shape, _, archs) in workers.STATE_JOBS.items():
        tmp = tmp_path_factory.mktemp(job)
        if job == "serve_state4":
            torch.save(_ref_init(XLSTM)[2].state_dict(),
                       tmp / f"init_{XLSTM}.pt")
        out[job] = workers.launch(job, mesh_shape[1], tmp)
    return out


def _one_rank(arch, rows, model=None):
    """The plain serve of ``arch``'s f32 smoke config on ``rows`` rows."""
    cfg = workers._train_cfg(arch)
    tokens, cross = workers.serve_inputs(cfg, rows)
    return workers.plain_serve(model or workers._model(cfg), cfg, tokens,
                               cross)


def _model_axis(spec):
    """The axis a cache spec splits over 'model', or None."""
    for i, a in enumerate(spec):
        if a == "model" or (isinstance(a, tuple) and "model" in a):
            return i
    return None


STATE_CASES = [(job, arch) for job, (_, _, archs) in
               workers.STATE_JOBS.items() for arch in archs]


@pytest.mark.parametrize("job,arch", STATE_CASES)
def test_state_layout_matches_one_rank(state_runs, job, arch):
    (_, n), rows, _ = workers.STATE_JOBS[job]
    cfg = workers._train_cfg(arch)
    model = _ref_init(arch)[2] if job == "serve_state4" and arch == XLSTM \
        else None
    logits, chosen, cache = _one_rank(arch, rows, model)
    runs = [ranks[arch] for ranks in state_runs[job]]
    whole = {"k": cache.k, **cache.state}
    for run in runs:
        assert run["tp_cleared"]
        # rows the 'model' ranks share: each rank serves all of them
        assert run["rows"].tolist() == list(range(rows))
        assert torch.equal(run["tokens"], chosen)
        assert _rel_err(run["logits"], logits) <= 1e-5
        assert {k: run["cache"][k] for k in run["spec_shapes"]} == \
            run["spec_shapes"]
        assert run["cache_bytes"]["port"] == run["cache_bytes"]["spec"]
    for key, want in whole.items():
        if key == "k" and not lm.n_attn(cfg):
            continue
        blocks = [run["cache_kv"][0] if key == "k"
                  else run["cache_state"][key] for run in runs]
        axis = _model_axis(runs[0]["cache_specs"][key])
        got = blocks if axis is None else [torch.cat(blocks, dim=axis)]
        for g in got:
            assert g.shape == want.shape, key
            assert _rel_err(g, want) <= 1e-5, key
    if arch == XLSTM:
        spec = runs[0]["cache_specs"]
        H, (_, Dh) = cfg.n_heads, X.m_dims(cfg)
        assert all(run["split_states"] for run in runs)
        if n == 4:      # H = 2 on 4: C over its value axis, m whole
            assert _model_axis(spec["mlstm.C"]) == 4
            assert runs[0]["cache"]["mlstm.C"][2:] == (H, Dh, Dh // 4)
            assert _model_axis(spec["mlstm.m"]) is None
        else:           # H = 2 on 2: C and m over heads
            assert _model_axis(spec["mlstm.C"]) == 2
            assert runs[0]["cache"]["mlstm.C"][2:] == (1, Dh, Dh)
            assert _model_axis(spec["mlstm.m"]) == 2
        assert runs[0]["cache"]["mlstm.n"][-1] == Dh // n
    else:               # whisper on (1, 4): attention is no region
        assert not any(k.endswith("mixer") or k.endswith("mixer2")
                       for k in runs[0]["split"])
        assert _model_axis(runs[0]["cache_specs"]["cross.k"]) == 2
        T = cfg.cross_kv_tokens
        assert runs[0]["cache"]["cross.k"][2:] == (T // n, cfg.n_kv_heads,
                                                   cfg.hd)


def test_state_1x4_matches_reference(state_runs):
    """The (1, 4) xlstm run's logits, prefill and every decode step fed the
    tokens it chose, against the reference's lm.prefill / decode_step."""
    rcfg, params, _ = _ref_init(XLSTM)
    rows = workers.STATE_JOBS["serve_state4"][1]
    tokens, _ = workers.serve_inputs(workers._train_cfg(XLSTM), rows)
    rlogits, rcache = rlm.prefill(
        params, rcfg, {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)},
        max_seq=workers.SERVE["max_seq"])
    want = [np.asarray(rlogits)]
    run = state_runs["serve_state4"][0][XLSTM]
    for step in range(workers.SERVE["steps"]):
        tok = run["tokens"][:, step:step + 1].numpy().astype(np.int32)
        rlogits, rcache = rlm.decode_step(params, rcfg, jnp.asarray(tok),
                                          rcache)
        want.append(np.asarray(rlogits))
    for ranks in state_runs["serve_state4"]:
        np.testing.assert_allclose(ranks[XLSTM]["logits"].numpy(),
                                   np.stack(want), atol=REF_TOL,
                                   rtol=REF_TOL)


# ---------------------------------------------------------------------------
# no process group
# ---------------------------------------------------------------------------

def _mlstm_inputs(B=2, H=4, Lc=8, Dh=16, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = t(B, H, Lc, Dh), t(B, H, Lc, Dh), t(B, H, Lc, Dh)
    li = t(B, H, Lc)
    lf = torch.nn.functional.logsigmoid(t(B, H, Lc) + 2.0)
    state = (t(B, H, Dh, Dh), t(B, H, Dh), t(B, H))
    return q, k, v, li, lf, state


@pytest.mark.parametrize("split", ("heads", "values"))
def test_mlstm_chunk_on_a_block(split):
    """The chunk on a block of heads, or on a block of C's value axis (v
    and C alone sliced; n and m whole), is the whole call's block."""
    q, k, v, li, lf, (C, n, m) = _mlstm_inputs()
    h, (C1, n1, m1) = X._mlstm_chunk(q, k, v, li, lf, (C, n, m))
    if split == "heads":
        s = slice(1, 3)
        hb, (Cb, nb, mb) = X._mlstm_chunk(q[:, s], k[:, s], v[:, s],
                                          li[:, s], lf[:, s],
                                          (C[:, s], n[:, s], m[:, s]))
        pairs = [(hb, h[:, s]), (Cb, C1[:, s]), (nb, n1[:, s]),
                 (mb, m1[:, s])]
    else:
        e = slice(4, 8)
        hb, (Cb, nb, mb) = X._mlstm_chunk(q, k, v[..., e], li, lf,
                                          (C[..., e], n, m))
        pairs = [(hb, h[..., e]), (Cb, C1[..., e]), (nb, n1), (mb, m1)]
    for got, want in pairs:
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", ((torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)))
def test_cross_partial_merged(dtype, tol):
    """The cross partial over one block is _plain_attention's bits after
    the cast; over 2 and 4 blocks of the positions, merged, within
    ``tol`` x max of it."""
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    B, Hq, Hkv, T, D = 2, 8, 2, 64, 32
    q, k, v = t(B, 1, Hq, D), t(B, T, Hkv, D), t(B, T, Hkv, D)
    want = L._plain_attention(q, k, v)
    o, lse = L._attention_partial(q, k, v)
    assert torch.equal(TP.merge(o[None], lse[None]).to(dtype), want)
    for n in (2, 4):
        parts = [L._attention_partial(q, k[:, a:b], v[:, a:b])
                 for (a, b), in sharding.even_ranges(T, n)]
        got = TP.merge(torch.stack([p[0] for p in parts]),
                       torch.stack([p[1] for p in parts])).to(dtype)
        err = (got.float() - want.float()).abs().max()
        assert float(err) <= tol * float(want.float().abs().max())


@pytest.mark.parametrize("arch", ("llama-3.2-vision-11b", "whisper-tiny",
                                  XLSTM))
@pytest.mark.parametrize("r", (0, 7, 15))
def test_make_cache_blocks_are_the_spec(arch, r):
    """make_cache(tp=) of the full config on a rank of 16 'model' ranks
    (its 2 rows of a batch of 32 over 'data') gives each leaf the shape
    that cache_specs gives a rank of (16, 16)."""
    cfg = get(arch).config()
    mesh = sharding.AbstractMesh({"data": 16, "model": 16})
    B, S = 32, 1024
    whole = lm.make_cache(cfg, B, S, "meta")
    specs = sharding.cache_specs(cfg, whole, mesh)
    mine = lm.make_cache(cfg, B // 16, S, "meta", tp=Region(None, 16, r))
    assert tuple(mine.k.shape) == sharding.local_shape(whole.k.shape, mesh,
                                                       specs.k)
    assert set(mine.state) == set(whole.state)
    for k, t in whole.state.items():
        assert tuple(mine.state[k].shape) == sharding.local_shape(
            t.shape, mesh, specs.state[k]), k


def test_state_layout_that_cannot_be_met_raises():
    """xlstm's smoke config on 3 'model' ranks: neither C's 2 heads nor
    its 64 value columns divide, so no layout splits it, and the cache
    refuses to hold it whole."""
    cfg = get(XLSTM).smoke()
    with pytest.raises(ValueError, match="cannot be laid out"):
        X.state_blocks(cfg, 3, 0)
    with pytest.raises(ValueError, match="cannot be laid out"):
        lm.make_cache(cfg, 1, 8, "meta", tp=Region(None, 3, 0))


def test_server_needs_the_rows_for_xlstm(world_of_one):
    """The xLSTM states' layout follows the batch's rows: before rows() the
    server cannot lay out a cache."""
    server = ShardedServer(get(XLSTM).smoke(),
                           make_host_mesh(model=1, device="cpu"), "cpu")
    with pytest.raises(RuntimeError, match="rows"):
        server.make_cache(2, 8)
    server.rows(torch.arange(2))
    assert server.make_cache(2, 8).max_seq == 8
