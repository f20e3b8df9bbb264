"""The port's mesh tail on CPU process groups (gloo): the sharded trainer,
its checkpoints, ``psum_compressed`` and the population-sharded fitness.

Multi-rank runs are 2 (or 4) processes started by
``torch_mesh_workers.launch`` (a ``file://`` rendezvous under
``tmp_path``, a timeout on every rank);
world-of-one runs join a 1-rank gloo group in this process. Every group is
destroyed after its test.

Held:
* the train step (adamw, the stablelm-3b smoke config in f32, global batch
  4) on a (2, 1) mesh (2 data-parallel ranks of 2 rows) and on (1, 2) (the
  FFN, the embedding and the head split over 'model') against one rank
  without a mesh on the whole batch: loss within 1e-5 relative; the
  gradients, through adamw's first moment m = 0.1 g of the clipped
  gradient, within 1e-5 x max|g|;
  v within 1e-5 x max|v|; each run's parameters equal to adamw's step
  recomputed from its own moments within 1e-6 x max|delta p|. (A missing
  mean over the DP ranks doubles g on (2, 1).) A world of one equals
  ``Trainer()`` bit for bit;
* the 'model'-parallel regions on (1, 2): one adamw step of the llama4
  (top-1 experts, dense FFN every other layer) and dbrx (top-2 experts)
  smoke configs against one rank at the same tolerances, every MoE call's
  routing and drops exactly; llama4 on (2, 2) against one rank taking the
  data-parallel ranks' rows as microbatches; no rank ever fills a whole
  expert stack, embedding, head or dense FFN; a world of one with a
  region equals ``Trainer()`` bit for bit for MoE configs too;
* attention's heads and Mamba's channels over 'model' on (1, 2): one
  adamw step of the qwen3-1.7b (qk-norm: partial gain gradients summed),
  stablelm-12b (one KV head both ranks read), jamba (Mamba channels,
  attention and experts), llama-3.2-vision (cross-attention) and whisper
  (bidirectional encoder and cross-attention) smoke configs, and on (1, 4)
  qwen3's at 6 query heads on 2 KV heads (ranks of 1, 2, 1 and 2 heads,
  two ranks a KV head, columns that storage cuts mid-head), each against
  one rank at the tolerances above, MoE drops exactly; the qwen3 run's
  gathered gradients and loss against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` from its own initial parameters (1e-4 x
  max|g|); no rank fills a whole attention or Mamba weight (each at the
  rank's heads, KV heads or channels); a world of one equals
  ``Trainer()`` bit for bit for jamba and qwen3 too (with the MoE
  configs);
* adamw8bit and adafactor updated on (1, 2) from each rank's blocks
  (``optim``'s ``layouts``), gathered: against the reference's update of
  the whole arrays at the one-rank twins' tolerances (parameters and
  state within 1e-6 relative; adamw8bit's int8 codes and scales exactly,
  the gradients under the clip), and against the port's own whole-array
  update (adamw8bit bit for bit), with quantization blocks straddling the
  ranks;
* a checkpoint saved on 2 ranks restores on 1 rank (no mesh) and on (1, 2)
  bit for bit; the twin of ``tests/test_training.py::
  test_checkpoint_elastic_reshard``;
* ``psum_compressed``'s three methods, different gradients on each rank,
  against the reference's arithmetic from its ``compress_int8`` /
  ``compress_topk`` on one process: the int8 payloads' int32 sums exactly,
  the f32 means within 1e-6 relative;
* the sharded fitness on 3 genomes (padding by row 0 runs) under slo / qoe
  and threshold / paper bit-equal to the unsharded port and within the
  reference's rtol 1e-5 of the reference; a 4-generation NSGA-II run under
  it leaves both ranks' states bit-equal; the twins of
  ``tests/test_hotpath.py::test_sharded_fitness_*``.
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
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.configs import get as ref_get
from repro.core.fitness import EvalConfig as RefEvalConfig
from repro.core.fitness import TraceEvaluator as RefEvaluator
from repro.models import lm as rlm
from repro.training import grad_compress as rgc
from repro.training import optim as ropt
from repro.workload.slo import attach_slos as ref_attach_slos
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch.checkpoint.manager import (_flatten, load_checkpoint,
                                            save_checkpoint)
from repro_torch.convert import lm_named_from_numpy, lm_params_from_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.training.optim import (OptConfig, _bias_corrections,
                                        make_optimizer)
from repro_torch.training.trainer import TrainConfig, Trainer


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


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    ranks = workers.launch("train", 2, tmp)
    cfg = workers._train_cfg()
    model, state, hist = Trainer(cfg, TrainConfig(**workers.TRAIN),
                                 device="cpu").run(model=workers._model(cfg),
                                                   resume=False)
    one = {"hist": hist, "m": state["m"], "v": state["v"],
           "params": {k: p.detach() for k, p in model.named_parameters()}}
    return ranks, one


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    return workers.launch("train_moe", 2,
                          tmp_path_factory.mktemp("train_moe"))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("mesh_shape", ["2x1", "1x2"])
def test_sharded_train_step_matches_one_rank(train_runs, mesh_shape):
    ranks, one = train_runs
    runs = [r[mesh_shape] for r in ranks]
    assert runs[0]["n_dp"] == (2 if mesh_shape == "2x1" else 1)
    for run in runs:
        loss, want = run["hist"][0]["loss"], one["hist"][0]["loss"]
        assert abs(loss - want) <= 1e-5 * abs(want)
        assert abs(run["hist"][0]["gnorm"] - one["hist"][0]["gnorm"]) \
            <= 1e-5 * one["hist"][0]["gnorm"]
    p0 = {k: p.detach() for k, p in workers._model(
        workers._train_cfg()).named_parameters()}
    opt = OptConfig()
    b1c, b2c = _bias_corrections(opt, torch.tensor(1, dtype=torch.int32))
    for k, want_m in one["m"].items():
        for run in runs:
            assert _rel(run["m"][k], want_m) <= 1e-5, k   # 0.1 x gradient
            assert _rel(run["v"][k], one["v"][k]) <= 1e-5, k
            assert torch.equal(run["params"][k], run["model"][k])
            assert run["model_empty"]   # between steps
            m, v = run["m"][k], run["v"][k]
            step = p0[k] - opt.lr * ((m / b1c) / (torch.sqrt(v / b2c)
                                                  + opt.eps)
                                     + opt.weight_decay * p0[k])
            delta = float((one["params"][k] - p0[k]).abs().max())
            assert float((run["params"][k] - step).abs().max()) \
                <= 1e-6 * delta, k
        # both ranks hold the same whole arrays
        assert torch.equal(runs[0]["params"][k], runs[1]["params"][k])
    # storage is sharded: a rank keeps half of the embedding on either mesh
    for run in runs:
        assert run["local_shapes"]["embed"] != tuple(p0["embed"].shape)


def test_world_of_one_trainer_bit_equal(world_of_one, tmp_path):
    """Trainer(mesh=make_host_mesh(model=1)) against Trainer() on the same
    seed, 2 steps: metrics, parameters and moments bit for bit; its
    checkpoint (with specs) restored onto the mesh bit for bit."""
    cfg = workers._train_cfg()
    tcfg = TrainConfig(**{**workers.TRAIN, "steps": 2})
    model, state, hist = Trainer(cfg, tcfg, device="cpu").run(resume=False)
    mesh = make_host_mesh(model=1, device="cpu")
    tr = Trainer(cfg, dataclasses.replace(
        tcfg, checkpoint_dir=str(tmp_path / "ck")), device="cpu", mesh=mesh)
    model_m, state_m, hist_m = tr.run(resume=False)
    assert [(h["loss"], h["nll"], h["gnorm"]) for h in hist] == \
        [(h["loss"], h["nll"], h["gnorm"]) for h in hist_m]
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), tr.params[k].full_tensor()), k
        for mom in ("m", "v"):
            assert torch.equal(state[mom][k], state_m[mom][k].full_tensor())
    (params, st), man = tr.ckpt.restore((tr.params, state_m), mesh=mesh,
                                        specs=(tr.pspecs, tr.sspecs))
    assert man["specs"]["/0/embed"] == list(tr.pspecs["embed"])
    for (_, a), (_, b) in zip(_flatten((params, st)),
                              _flatten((tr.params, state_m))):
        assert a.placements == b.placements
        assert torch.equal(a.full_tensor(), b.full_tensor())


@pytest.mark.parametrize("optimizer,microbatches,remat", [
    ("adamw", 2, True), ("adamw", 1, False), ("adamw8bit", 1, True),
    ("adafactor", 2, True)])
def test_world_of_one_mesh_step_variants_bit_equal(world_of_one, optimizer,
                                                   microbatches, remat):
    """The other optimizers (updated on the blocks in place, their
    reductions over split axes as collectives of one rank), microbatches
    and no remat on a world of one: metrics, parameters and every
    optimizer-state leaf bit for bit against Trainer()."""
    cfg = workers._train_cfg()
    tcfg = TrainConfig(**{**workers.TRAIN, "steps": 2,
                          "optimizer": optimizer,
                          "microbatches": microbatches, "remat": remat})
    model, state, hist = Trainer(cfg, tcfg, device="cpu").run(resume=False)
    tr = Trainer(cfg, tcfg, device="cpu",
                 mesh=make_host_mesh(model=1, device="cpu"))
    _, state_m, hist_m = tr.run(resume=False)
    assert [(h["loss"], h["nll"], h["gnorm"]) for h in hist] == \
        [(h["loss"], h["nll"], h["gnorm"]) for h in hist_m]
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), tr.params[k].full_tensor()), k
    # every optimizer updates the blocks in place: nothing gathered
    assert tr.peak_bytes["update"] == 0
    want = dict(_flatten(state))
    got = {k: t.full_tensor() for k, t in _flatten(state_m)}
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(t, got[k]), k


def test_mesh_step_fills_one_period_at_a_time(world_of_one, monkeypatch):
    """A step on the mesh fills each period of the smoke config (4
    periods of one layer) before its forward and again before its
    recompute (the last stays filled from its forward into its backward),
    never holds two periods filled at once, and leaves none filled."""
    events = []
    fill = Trainer._fill

    def recording_fill(self, params, names):
        fill(self, params, names)
        filled = {int(k.split(".")[1]) for k, p in params.items()
                  if k.startswith("blocks.")
                  and p.untyped_storage().nbytes()}
        events.append((sorted({int(k.split(".")[1]) for k in names
                               if k.startswith("blocks.")}), filled))

    monkeypatch.setattr(Trainer, "_fill", recording_fill)
    cfg = workers._train_cfg()
    tr = Trainer(cfg, TrainConfig(**workers.TRAIN), device="cpu",
                 mesh=make_host_mesh(model=1, device="cpu"))
    model, _, _ = tr.run(resume=False)
    periods = [e[0] for e in events if e[0]]
    assert periods == [[0], [1], [2], [3], [2], [1], [0]]
    assert all(len(filled) <= 1 for _, filled in events)
    assert all(p.untyped_storage().nbytes() == 0 for p in model.parameters())


def _one_rank(cfg, model=None):
    """One adamw step of ``cfg`` without a mesh, from ``model`` (default
    ``workers._model``), with the cross inputs the mesh runs get:
    (history, m, routing)."""
    moe.ROUTING = []
    try:
        trainer = workers.with_cross(Trainer(cfg, TrainConfig(
            **workers.TRAIN), device="cpu"))
        _, state, hist = trainer.run(model=model or workers._model(cfg),
                                     resume=False)
        return hist, state["m"], [(e, int(d)) for e, d in moe.ROUTING]
    finally:
        moe.ROUTING = None


@pytest.mark.parametrize("arch", workers.MOE_ARCHS)
def test_model_parallel_moe_step_matches_one_rank(moe_runs, arch):
    """(1, 2): the experts, the dense FFN, the embedding and the head
    split over 'model' (each rank's blocks), the step against one rank on
    the whole batch: loss 1e-5 relative, each gradient (m = 0.1 g) within
    1e-5 x max|g|, every MoE call's expert choices and drop count
    equal."""
    assert _held_to_one_rank([r[arch] for r in moe_runs],
                             workers._train_cfg(arch))


def _held_to_one_rank(runs, cfg, model=None):
    """Each rank's (1, n) run of ``cfg`` against one rank on the whole
    batch from ``model``: loss 1e-5 relative, each gradient (m = 0.1 g)
    within 1e-5 x max|g|, every MoE call's expert choices and drop count
    equal, every rank's m alike. Returns the one rank's routing."""
    hist, m, routing = _one_rank(cfg, model)
    for run in runs:
        assert run["n_dp"] == 1
        assert abs(run["hist"][0]["loss"] - hist[0]["loss"]) \
            <= 1e-5 * abs(hist[0]["loss"])
        for k, want in m.items():
            assert _rel(run["m"][k], want) <= 1e-5, k
            assert torch.equal(run["m"][k], runs[0]["m"][k]), k
        assert len(run["routing"]) == len(routing)
        for (e, d), (we, wd) in zip(run["routing"], routing):
            assert torch.equal(e, we) and d == wd
    return routing


def test_model_parallel_step_on_2x2_matches_microbatches(tmp_path):
    """llama4's smoke config on (2, 2): 2 data-parallel ranks of 2 rows,
    each with its regions over 2 'model' ranks, against one rank that
    takes the same rows as 2 microbatches (a MoE call sees the same
    tokens, so capacity and drops are alike): loss 1e-5 relative, each
    gradient (m) within 1e-5 x max|g|, each rank's routing and drops
    those of its microbatch."""
    ranks = workers.launch("train4", 4, tmp_path)
    cfg = workers._train_cfg(workers.MOE_ARCHS[0])
    moe.ROUTING = []
    try:
        _, state, hist = Trainer(cfg, TrainConfig(**{
            **workers.TRAIN, "microbatches": 2}), device="cpu").run(
                model=workers._model(cfg), resume=False)
        routing = [(e, int(d)) for e, d in moe.ROUTING]
    finally:
        moe.ROUTING = None
    half = len(routing) // 2
    for rank, run in enumerate(ranks):
        assert run["n_dp"] == 2
        assert abs(run["hist"][0]["loss"] - hist[0]["loss"]) \
            <= 1e-5 * abs(hist[0]["loss"])
        for k, want in state["m"].items():
            assert _rel(run["m"][k], want) <= 1e-5, k
        mine = routing[half * (rank // 2):half * (rank // 2 + 1)]
        assert len(run["routing"]) == len(mine) > 0
        for (e, d), (we, wd) in zip(run["routing"], mine):
            assert torch.equal(e, we) and d == wd


#: Mamba's weights by the dimension of its channels
_MAMBA = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
          "dt_proj_w": 1, "dt_proj_b": 0, "A_log": 0, "D": 0,
          "out_proj": 0}


def _compute_shape(cfg, name, shape, r, n):
    """The shape rank r of n fills ``name`` (whole ``shape``) at, and
    whether a region splits it: the vocabulary, a dense FFN's wi / wg
    columns and wo rows and a MoE's experts over n; attention's query
    heads [r H / n, (r + 1) H / n) (wq's columns, wo's rows) and the
    max(1, Hkv / n) KV heads they read (wk, wv); Mamba's d_inner / n
    channels; qk-norm's gains whole, the rest whole."""
    leaf, H, Hkv, hd = name.split(".")[-1], cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    out, dim = list(shape), None
    if name in ("embed", "head"):
        dim, size = 0, shape[0] // n
    elif ".ffn." in name and leaf in ("wi", "wg", "wo"):
        dim = 0 if len(shape) == 3 or leaf == "wo" else 1
        size = shape[dim] // n
    elif ".mixer" in name and leaf in ("wq", "wk", "wv", "wo"):
        assert n <= H and (Hkv % n == 0 or n % Hkv == 0)
        heads = ((r + 1) * H // n - r * H // n if leaf in ("wq", "wo")
                 else max(1, Hkv // n))
        dim, size = (0 if leaf == "wo" else 1), heads * hd
    elif ".mixer." in name and leaf in _MAMBA:
        dim = _MAMBA[leaf]
        size = shape[dim] // n
    elif leaf in ("qnorm", "knorm"):
        return tuple(shape), True
    if dim is not None:
        out[dim] = size
    return tuple(out), dim is not None


def _runs(request, arch):
    """Each rank's run of ``arch`` (or "heads4") on (1, n)."""
    if arch == workers.TRAIN_ARCH:
        return [r["1x2"] for r in request.getfixturevalue("train_runs")[0]]
    if arch == "heads4":
        return request.getfixturevalue("heads4_runs")
    fixture = "moe_runs" if arch in workers.MOE_ARCHS else "head_runs"
    return [r[arch] for r in request.getfixturevalue(fixture)]


def _cfg(arch):
    if arch == "heads4":
        return workers._train_cfg(workers.HEADS4[0], **workers.HEADS4[1])
    return workers._train_cfg(arch)


@pytest.mark.parametrize("arch", (workers.TRAIN_ARCH,) + workers.MOE_ARCHS
                         + workers.HEAD_ARCHS + ("heads4",))
def test_model_parallel_fills_blocks_only(request, arch):
    """On (1, 2) (and (1, 4)) no rank fills a whole expert stack,
    embedding, head, dense FFN, attention or Mamba weight: each is filled,
    at every fill of the step, as the rank's block along the dimension
    'model' splits (attention's at the rank's query heads or the KV heads
    they read, Mamba's at its channels; stablelm-12b's one KV head is all
    of wk and wv); only routers, norms and the qk-norm gains are
    whole."""
    runs = _runs(request, arch)
    cfg = _cfg(arch)
    whole = {k: tuple(p.shape)
             for k, p in workers._model(cfg).named_parameters()}
    n = len(runs)
    for r, run in enumerate(runs):
        split = {k: sp for dims in run["split"].values()
                 for k, sp in dims.items()}
        assert set(split) == {k for k, shp in whole.items()
                              if _compute_shape(cfg, k, shp, r, n)[1]}
        for k, shp in whole.items():
            want, in_region = _compute_shape(cfg, k, shp, r, n)
            assert run["filled_shapes"][k] == {want}, (k, r)
            if in_region and split[k].dim is not None:
                # one KV head is all of wk / wv, and every rank reads it
                assert want != shp or (k[-2:] in ("wk", "wv")
                                       and cfg.n_kv_heads == 1), k
            else:   # routers, norms, qk-norm gains: whole
                assert k.split(".")[-1] in ("router", "g", "b", "qnorm",
                                            "knorm", "pos"), k


@pytest.fixture(scope="module")
def head_runs(tmp_path_factory):
    """The HEAD_JOBS on (1, 2), each rank's runs by arch; qwen3 starts from
    the reference's initial parameters."""
    runs = [{} for _ in range(2)]
    for job in workers.HEAD_JOBS:
        tmp = tmp_path_factory.mktemp(job)
        if "qwen3-1.7b" in workers.HEAD_JOBS[job]:
            torch.save(_ref_init("qwen3-1.7b")[1].state_dict(),
                       tmp / "init_qwen3-1.7b.pt")
        for mine, got in zip(runs, workers.launch(job, 2, tmp)):
            mine.update(got)
    return runs


@pytest.fixture(scope="module")
def heads4_runs(tmp_path_factory):
    return workers.launch("train_heads4", 4,
                          tmp_path_factory.mktemp("train_heads4"))


def _mixers(cfg):
    """The names of ``cfg``'s attention and Mamba modules (not empty)."""
    out = {n for n, mod in workers._model(cfg).named_modules()
           if type(mod).__name__ in ("Attention", "Mamba")}
    assert out
    return out


def _ref_init(arch):
    """(the reference's f32 smoke config, its ``lm.init`` parameters as
    numpy, the port's model from them)."""
    rcfg = dataclasses.replace(ref_get(arch).smoke(), dtype="float32")
    params = jax.tree.map(np.asarray, rlm.init(jax.random.key(0), rcfg))
    return rcfg, lm_params_from_numpy(params, workers._train_cfg(arch),
                                      "cpu"), params


@pytest.mark.parametrize("arch", workers.HEAD_ARCHS + ("heads4",))
def test_heads_and_channels_step_matches_one_rank(request, arch):
    """Attention (and jamba's Mamba) over 'model': one step on (1, 2), or
    (1, 4) for uneven heads, against one rank on the whole batch: loss
    1e-5 relative, each gradient (m = 0.1 g) within 1e-5 x max|g|, every
    MoE call's choices and drops equal; every attention (and Mamba)
    module is a region."""
    runs, cfg = _runs(request, arch), _cfg(arch)
    model = _ref_init(arch)[1] if arch == "qwen3-1.7b" else None
    assert all(_mixers(cfg) <= set(run["split"]) for run in runs)
    routing = _held_to_one_rank(runs, cfg, model)
    assert bool(routing) == (cfg.moe is not None)


def test_heads_split_gradients_match_reference(head_runs):
    """qwen3-1.7b's smoke config (qk-norm) on (1, 2) from the reference's
    initial parameters: the step's loss within 1e-5 relative and every
    gathered gradient within 1e-4 x max|g| of ``jax.value_and_grad`` of
    the reference's ``loss_fn`` on the same batch."""
    arch = "qwen3-1.7b"
    rcfg, model, params = _ref_init(arch)
    cfg = workers._train_cfg(arch)
    batch = next(Trainer(cfg, TrainConfig(**workers.TRAIN),
                         device="cpu").data.iterator(start_step=0))
    (loss, _), grads = jax.value_and_grad(
        lambda p: rlm.loss_fn(p, rcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              remat=True), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    want = lm_named_from_numpy(jax.tree.map(np.asarray, grads), cfg, model)
    for run in (r[arch] for r in head_runs):
        assert abs(run["hist"][0]["loss"] - float(loss)) \
            <= 1e-5 * abs(float(loss))
        assert set(run["grads"]) == set(want)
        for k, w in want.items():
            g = run["grads"][k].numpy()
            assert g.shape == w.shape, k
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


@pytest.fixture(scope="module")
def optim_runs(tmp_path_factory):
    return workers.launch("optim", 2, tmp_path_factory.mktemp("optim"))


def _ref_tree(tree):
    return {k: _ref_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw8bit", "adafactor"])
def test_optimizer_blocks_match_whole_array_update(optim_runs, name):
    params, grads, state = workers.optim_case(name)
    stacks = workers.OPT_STACKS
    rp, rg = dict(params), dict(grads)
    if name == "adafactor":     # the reference's stacked leaves
        for key, members in stacks.items():
            for t in (rp, rg):
                t[key] = np.stack([t.pop(n) for n in members])
    ref_p, ref_s = ropt.make_optimizer(name, ropt.OptConfig(lr=1e-2)).update(
        _ref_tree(rg), _ref_tree(state), _ref_tree(rp))
    own_p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    own_s = workers._tree_torch(state)
    _, own_s = make_optimizer(name, OptConfig(lr=1e-2),
                              workers.opt_stacks).update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, own_s, own_p)
    for r in optim_runs:
        got = r[name]["whole"]
        for k, (shape, spec) in workers.OPT_LEAVES.items():
            local = list(shape)
            local[spec.index("model")] //= 2
            assert r[name]["local_shapes"][k] == tuple(local)
            want = next((ref_p[key][members.index(k)]
                         for key, members in stacks.items()
                         if name == "adafactor" and k in members), None)
            want = ref_p[k] if want is None else want
            _close(got["params"][k], want)
            if name == "adamw8bit":
                assert torch.equal(got["params"][k], own_p[k]), k
        assert int(got["state"]["step"]) == int(ref_s["step"])
        if name == "adamw8bit":
            for mom in ("m", "v"):
                for k in params:
                    for f in ("q", "s"):
                        t = got["state"][mom][k][f]
                        np.testing.assert_array_equal(
                            t.numpy(), np.asarray(ref_s[mom][k][f]))
                        assert torch.equal(t, own_s[mom][k][f])
        else:
            for k, fac in ref_s["f"].items():
                for f, v in fac.items():
                    _close(got["state"]["f"][k][f], v)
                    _close(got["state"]["f"][k][f], own_s["f"][k][f])


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()),
                                              1e-30))


@pytest.mark.parametrize("arch,optimizer", [
    ("llama4-maverick-400b-a17b", "adafactor"), ("dbrx-132b", "adamw8bit"),
    ("jamba-v0.1-52b", "adamw"), ("qwen3-1.7b", "adafactor")])
def test_world_of_one_moe_bit_equal(world_of_one, arch, optimizer):
    """A MoE config (and jamba's Mamba channels; qwen3's qk-norm) on a
    world of one, its regions of one rank (experts, dense FFN, vocabulary,
    attention, Mamba) run, not skipped: 2 steps' metrics, parameters and
    optimizer state bit for bit against Trainer()."""
    cfg = workers._train_cfg(arch)
    tcfg = TrainConfig(**{**workers.TRAIN, "steps": 2,
                          "optimizer": optimizer})
    model, state, hist = Trainer(cfg, tcfg, device="cpu").run(resume=False)
    tr = Trainer(cfg, tcfg, device="cpu",
                 mesh=make_host_mesh(model=1, device="cpu"))
    assert tr.region is not None and tr.region.size == 1
    assert {"", "blocks.0.ffn"} | _mixers(cfg) <= set(tr.split)
    _, state_m, hist_m = tr.run(resume=False)
    assert [(h["loss"], h["nll"], h["gnorm"]) for h in hist] == \
        [(h["loss"], h["nll"], h["gnorm"]) for h in hist_m]
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), tr.params[k].full_tensor()), k
    want = dict(_flatten(state))
    got = {k: t.full_tensor() for k, t in _flatten(state_m)}
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(t, got[k]), k


def test_checkpoint_saved_on_2_ranks_restores_on_1_and_1x2(train_runs):
    ranks, _ = train_runs
    saved = ranks[0]["2x1"]
    names = {k: 0 for k in saved["params"]}
    tree, man = load_checkpoint(ranks[0]["ckpt_dir"], (names, {
        "m": names, "v": names, "step": 0, "gnorm": 0}))
    assert man["step"] == 1 and man["specs"] is not None
    flat = dict(_flatten(tree))
    for k, p in saved["params"].items():
        assert torch.equal(flat[f"/0/{k}"], p), k
        for mom in ("m", "v"):
            assert torch.equal(flat[f"/1/{mom}/{k}"], saved[mom][k])
    for r in ranks:
        back = r["restore"]
        assert back["start"] == 1
        assert set(back["whole"]) == set(flat)
        for path, t in back["whole"].items():
            assert torch.equal(t, flat[path]), path
        assert back["placements"]["/0/embed"] == ["S(1)", "S(0)"]
        assert back["model_empty"]
        for k, p in saved["params"].items():
            assert torch.equal(back["model"][k], p)


def test_checkpoint_elastic_reshard(world_of_one, tmp_path):
    """Save unsharded with specs, restore onto a 1-rank mesh."""
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    save_checkpoint(tmp_path, 0, tree, specs={"w": (None, "model")})
    mesh = make_host_mesh(model=1, device="cpu")
    restored, manifest = load_checkpoint(tmp_path, tree, mesh=mesh)
    assert torch.equal(restored["w"].full_tensor(), tree["w"])
    assert manifest["specs"]["w"] == [None, "model"]


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    return workers.launch("psum", 2, tmp_path_factory.mktemp("psum"))


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
def test_psum_compressed_matches_reference_arithmetic(psum_runs, method):
    n = len(psum_runs)
    grads = [{k: jnp.asarray(v.numpy()) for k, v in r["grads"].items()}
             for r in psum_runs]
    res = rgc.init_residual(grads[0])
    if method == "int8":
        qs, ss = zip(*(rgc.compress_int8(g, res)[:2] for g in grads))
        for k in grads[0]:
            ref_sum = sum(np.asarray(q[k]).astype(np.int32) for q in qs)
            port_sum = sum(r["q"][k].to(torch.int32) for r in psum_runs)
            np.testing.assert_array_equal(port_sum.numpy(), ref_sum)
        want = {k: rgc._dequantize_int8(
            jnp.asarray(sum(np.asarray(q[k]).astype(np.int32) for q in qs),
                        jnp.float32) / n,
            sum(s[k] for s in ss) / n, grads[0][k].shape) for k in grads[0]}
    elif method == "topk":
        sents = [rgc.compress_topk(g, res)[0] for g in grads]
        want = {k: sum(s[k] for s in sents) / n for k in grads[0]}
    else:
        want = {k: sum(g[k] for g in grads) / n for k in grads[0]}
    for r in psum_runs:
        mean, _ = r[method]
        for k, w in want.items():
            w = np.asarray(w)
            got = mean[k].numpy()
            assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max(), k
        assert torch.equal(mean["w"], psum_runs[0][method][0]["w"])


def test_sharded_fitness_single_device_mesh_equivalence(world_of_one):
    ev, mesh, plain, sharded = workers._fitness_case("slo", "qoe",
                                                     workers.SLO_GENOMES)
    assert mesh.size() == 1
    assert torch.equal(plain[0], sharded[0])
    assert torch.equal(plain[1], sharded[1])


@pytest.fixture(scope="module")
def fitness_runs(tmp_path_factory):
    return workers.launch("fitness", 2, tmp_path_factory.mktemp("fitness"))


@pytest.mark.parametrize("policy, objectives", [("slo", "qoe"),
                                                ("threshold", "paper")])
def test_sharded_fitness_multi_rank(fitness_runs, policy, objectives):
    tr = ref_build_trace(40, seed=0)
    ref_attach_slos(tr, seed=0)
    ev = RefEvaluator(tr, ref_testbed(), RefEvalConfig(concurrency=4),
                      bucket="pow2")
    genomes = (workers.SLO_GENOMES if policy == "slo"
               else workers.THRESHOLD_GENOMES)
    F0, v0 = ev.make_fitness(policy, objectives=objectives)(
        jnp.asarray(genomes, jnp.float32), jax.random.key(0))
    for r in fitness_runs:
        (Fp, vp), (Fs, vs) = r[policy]["plain"], r[policy]["sharded"]
        assert Fs.shape[0] == len(genomes)
        assert torch.equal(Fp, Fs) and torch.equal(vp, vs)
        assert np.allclose(Fs.numpy(), np.asarray(F0), rtol=1e-5, atol=1e-7)
        assert np.allclose(vs.numpy(), np.asarray(v0))


def test_sharded_nsga2_states_equal_across_ranks(fitness_runs):
    a, b = (r["nsga2"] for r in fitness_runs)
    assert a["generation"] == b["generation"] == 4
    for f, t in a.items():
        if torch.is_tensor(t):
            assert torch.equal(t, b[f]), f
