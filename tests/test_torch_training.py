"""The port's training substrate against the reference's: the optimizers,
the gradient-compression operators, the trainer with microbatching, and
checkpoint/restart. The first eleven tests are the single-device tests of
``tests/test_training.py`` run on the port (the elastic reshard onto a mesh
is in ``tests/test_torch_mesh_train.py``); the rest hold the port to the
reference on the same inputs, made with numpy from seeds.

Tolerances: optimizer parameters and moments within 1e-6 relative (1e-6
of the leaf's max|x| absolute) after 3 updates from the reference's state —
the same f32 expressions, whose reductions (the global norm, adafactor's
means) run in another order; adamw8bit's int8 payloads and the int8
compressor's exactly (gradients kept under the clip, so the scale is 1
exactly on both sides). Three trainer steps from the reference's initial
parameters: nll and gnorm within 1e-4 relative (a 4-layer model's f32
forward and backward in another order of summation, then two optimizer
steps through it).
"""
import collections
import contextlib
import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro.training import grad_compress as rgc
from repro.training import optim as ropt
from repro.training.trainer import TrainConfig as RefTrainConfig
from repro.training.trainer import Trainer as RefTrainer
from repro_torch import convert
from repro_torch.checkpoint import manager as ckm
from repro_torch.configs import get
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels import flash_attention
from repro_torch.models import lm
from repro_torch.training.grad_compress import (compress_int8, compress_topk,
                                                decompress_int8,
                                                init_residual)
from repro_torch.training.optim import (OptConfig, _dq8, _q8, adafactor,
                                        adamw8bit, make_optimizer,
                                        optimizer_for_arch)
from repro_torch.training.trainer import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES)
    yield
    assert (flash_attention.LAUNCHES,
            flash_attention.BWD_LAUNCHES) == before


# ---------------------------------------------------------------------------
# optimizers (twins of tests/test_training.py)
# ---------------------------------------------------------------------------
def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5]),
            "b": torch.tensor([[1.0, -1.0]])}


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_optimizers_minimize_quadratic(name):
    opt = make_optimizer(name, OptConfig(lr=0.05, weight_decay=0.0))
    params = _quadratic_params()
    state = opt.init(params)

    def loss(p):
        return sum(torch.sum(x ** 2) for x in p.values())

    l0 = float(loss(params))
    for _ in range(60):
        grads = {k: 2 * v for k, v in params.items()}
        params, state = opt.update(grads, state, params)
    assert float(loss(params)) < 0.05 * l0, name


def test_optimizer_states_match_param_shapes():
    params = {"a": torch.zeros((8, 16)), "b": torch.zeros((5,))}
    st8 = adamw8bit().init(params)
    assert st8["m"]["a"]["q"].shape == (8, 16)
    assert st8["m"]["a"]["q"].dtype == torch.int8
    stf = adafactor().init(params)
    assert stf["f"]["a"]["vr"].shape == (8,)
    assert stf["f"]["a"]["vc"].shape == (16,)
    assert stf["f"]["b"]["v"].shape == (5,)


@pytest.mark.parametrize("seed", range(15))
def test_int8_quant_roundtrip_error_bounded(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((7, 300)) * 10)
                         .astype(np.float32))
    q, s = _q8(x)
    back = _dq8(q, s, x.shape)
    err = (back - x).abs().numpy()
    # blockwise absmax int8: error <= scale/2 per block
    scale = s.numpy()
    assert (err <= np.repeat(scale, 256, axis=-1)[:, :300] * 0.5
            + 1e-6).all()


def test_optimizer_tiering():
    assert optimizer_for_arch(2e9) == "adamw"
    assert optimizer_for_arch(130e9) == "adamw8bit"
    assert optimizer_for_arch(400e9) == "adafactor"


# ---------------------------------------------------------------------------
# gradient compression (twins)
# ---------------------------------------------------------------------------
def test_int8_error_feedback_telescopes():
    """Sum of dequantized payloads + final residual == sum of raw grads."""
    rng = np.random.default_rng(0)
    grads_seq = [{"w": torch.from_numpy(rng.standard_normal((4, 300))
                                        .astype(np.float32))}
                 for _ in range(5)]
    residual = init_residual(grads_seq[0])
    sent_total = torch.zeros((4, 300))
    for g in grads_seq:
        q, s, residual = compress_int8(g, residual)
        sent_total = sent_total + decompress_int8(q, s, g)["w"]
    raw_total = sum(g["w"] for g in grads_seq)
    np.testing.assert_allclose((sent_total + residual["w"]).numpy(),
                               raw_total.numpy(), rtol=1e-4, atol=1e-4)


def test_topk_keeps_largest():
    g = {"w": torch.arange(100, dtype=torch.float32)}
    res = init_residual(g)
    sent, new_res = compress_topk(g, res, frac=0.1)
    nz = np.flatnonzero(sent["w"].numpy())
    assert set(nz) == set(range(90, 100))
    np.testing.assert_allclose((sent["w"] + new_res["w"]).numpy(),
                               g["w"].numpy())


# ---------------------------------------------------------------------------
# trainer and checkpoints (twins)
# ---------------------------------------------------------------------------
def test_trainer_loss_decreases():
    cfg = get("stablelm-3b").smoke()
    t = Trainer(cfg, TrainConfig(seq_len=64, global_batch=8, steps=80,
                                 log_every=10, data_vocab=64, data_chains=1,
                                 data_branch=4,
                                 opt=OptConfig(lr=3e-3, weight_decay=0.0)),
                device="cpu")
    _, _, hist = t.run()
    first, last = hist[0]["nll"], hist[-1]["nll"]
    assert last < first - 0.5, (first, last)


def test_trainer_microbatching_matches_full_batch():
    """Same data, same init: one step with 2 microbatches equals the full
    batch (every row has as many labels, so the mean of the halves' means
    is the full mean) within f32 rounding, as do the updated parameters;
    the reference's own test asks for the first loss within 2e-2."""
    cfg = dataclasses.replace(get("qwen3-1.7b").smoke(), dtype="float32")
    kw = dict(seq_len=32, global_batch=4, steps=3, log_every=1,
              opt=OptConfig(lr=1e-3))
    runs = []
    for mb in (1, 2):
        model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        _, _, hist = Trainer(cfg, TrainConfig(microbatches=mb, **kw),
                             device="cpu").run(model=model)
        runs.append((model, hist))
    (m1, h1), (m2, h2) = runs
    assert abs(h1[0]["loss"] - h2[0]["loss"]) < 2e-2
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["gnorm"], b["gnorm"], rtol=1e-4)
    for (k, a), b in zip(m1.named_parameters(), m2.parameters()):
        d = (a - b).abs().max().item()
        assert d <= 1e-5 * max(a.abs().max().item(), 1e-30) + 1e-7, k


def test_checkpoint_restart_resumes_exactly(tmp_path):
    cfg = get("stablelm-3b").smoke()
    common = dict(seq_len=32, global_batch=4, log_every=1,
                  checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=5,
                  opt=OptConfig(lr=1e-3))
    # run 10 steps straight through
    p_full, _, h_full = Trainer(cfg, TrainConfig(steps=10, **common),
                                device="cpu").run(resume=False)
    # wipe and run 5, "crash", resume to 10
    shutil.rmtree(tmp_path / "ck")
    Trainer(cfg, TrainConfig(steps=5, **common), device="cpu").run(
        resume=False)
    t_b = Trainer(cfg, TrainConfig(steps=10, **common), device="cpu")
    p_b, _, h_b = t_b.run(resume=True)
    assert t_b.ckpt.latest_step() == 10
    for a, b in zip(p_full.parameters(), p_b.parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=2e-2, atol=2e-2)
    # on the CPU the resumed run is the uninterrupted one, bit for bit
    for a, b in zip(p_full.parameters(), p_b.parameters()):
        assert torch.equal(a, b)
    assert [h["loss"] for h in h_full[5:]] == [h["loss"] for h in h_b]


class _Crash(Exception):
    pass


def test_checkpoint_resume_after_crashes_is_uninterrupted(tmp_path):
    """Crash mid-run (after an in-loop save), resume and stop cleanly,
    resume and crash again right after the resumed step, resume to the
    end: every step's loss and the final parameters equal an uninterrupted
    run's bit for bit (the CPU). The checkpoint of step N holds N updates,
    the resumed run's first step is not saved over the committed one, and
    saving a committed step raises, on the caller's thread or at the async
    manager's ``wait()``, leaving the committed step as it was."""
    cfg = get("stablelm-3b").smoke()
    common = dict(seq_len=32, global_batch=4, log_every=1,
                  checkpoint_every=3, opt=OptConfig(lr=1e-3))
    full_model, _, full = Trainer(cfg, TrainConfig(
        steps=10, checkpoint_dir=str(tmp_path / "a"), **common),
        device="cpu").run(resume=False)
    want = {h["step"]: h["loss"] for h in full}
    ck = str(tmp_path / "b")
    seen = {}

    def run(steps, resume, crash_at=None):
        def cb(step, m):
            seen.setdefault(step, []).append(m["loss"])
            if step == crash_at:
                raise _Crash
        t = Trainer(cfg, TrainConfig(steps=steps, checkpoint_dir=ck,
                                     **common), device="cpu")
        try:
            model, _, _ = t.run(resume=resume, callback=cb)
        except _Crash:
            t.ckpt.wait()
            model = None
        return t.ckpt.latest_step(), model

    assert run(10, False, crash_at=4)[0] == 3     # saved after 3 updates
    assert run(6, True)[0] == 6                    # a clean stop at 6
    assert run(10, True, crash_at=7)[0] == 6       # step 6 not saved over
    latest, model = run(10, True)
    assert latest == 10
    assert sorted(seen) == list(range(10))
    for step, losses in seen.items():
        assert losses == [want[step]] * len(losses), step
    for a, b in zip(full_model.parameters(), model.parameters()):
        assert torch.equal(a, b)

    committed = tmp_path / "b" / "step_00000010"
    before = sorted(p.name for p in committed.rglob("*"))
    with pytest.raises(FileExistsError):
        ckm.save_checkpoint(tmp_path / "b", 10, {"x": torch.zeros(2)})
    mgr = ckm.CheckpointManager(tmp_path / "b", keep=2)
    mgr.save(10, {"x": torch.zeros(2)})
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                                     # the error is raised once
    assert sorted(p.name for p in committed.rglob("*")) == before
    assert not list((tmp_path / "b").glob("*.tmp"))
    assert ckm.latest_step(tmp_path / "b") == 10


def test_checkpoint_atomic_no_partial_state(tmp_path):
    tree = {"x": torch.arange(10)}
    ckm.save_checkpoint(tmp_path, 1, tree)
    # simulate a crashed writer: stray tmp dir must be ignored + cleaned
    (tmp_path / "step_00000002.tmp").mkdir()
    assert ckm.latest_step(tmp_path) == 1
    ckm.save_checkpoint(tmp_path, 3, tree)
    assert ckm.latest_step(tmp_path) == 3
    assert not (tmp_path / "step_00000002.tmp").exists()


def test_data_deterministic_and_host_sharded():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4)
    a = SyntheticLMData(cfg).batch(7)
    b = SyntheticLMData(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # two hosts partition the global batch exactly
    h0 = SyntheticLMData(cfg, host_index=0, n_hosts=2).batch(7)
    h1 = SyntheticLMData(cfg, host_index=1, n_hosts=2).batch(7)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), a["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def _tree():
    """A parameter dict of the shapes that matter: stacked matrices, a
    ragged last axis for the int8 blocks, a 1-D leaf."""
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((3, 8, 300)).astype(np.float32),
            "m": rng.standard_normal((20, 16)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in _tree().items()}


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_optimizer_parity_from_reference_state(name, scale):
    """One reference update to leave the init, then the port picks up the
    reference's state (``convert.opt_state_from_numpy``) and both take 3
    updates on the same gradients. ``scale`` 0.01 keeps the global norm
    under the clip, where adamw8bit's payloads must agree exactly; at 1.0
    the clip is active."""
    cfg = OptConfig(lr=1e-2)
    ropt_ = ropt.make_optimizer(name, ropt.OptConfig(lr=1e-2))
    popt = make_optimizer(name, cfg)
    rp = {k: jnp.asarray(v) for k, v in _tree().items()}
    rs = ropt_.init(rp)
    rp, rs = ropt_.update({k: jnp.asarray(v)
                           for k, v in _grads(0, scale).items()}, rs, rp)
    np_ = jax.tree.map(np.asarray, (rp, rs))
    params = {k: torch.from_numpy(np.array(v)) for k, v in np_[0].items()}
    state = convert.opt_state_from_numpy(np_[1], "cpu")
    for step in range(1, 4):
        g = _grads(step, scale)
        rp, rs = ropt_.update({k: jnp.asarray(v) for k, v in g.items()},
                              rs, rp)
        params, state = popt.update({k: torch.from_numpy(v)
                                     for k, v in g.items()}, state, params)
        for k in params:
            _close(params[k].numpy(), rp[k])
        assert int(state["step"]) == int(rs["step"]) == step + 1
        _close(float(state["gnorm"]), float(rs["gnorm"]))
        if name == "adamw":
            for key in ("m", "v"):
                for k in params:
                    _close(state[key][k].numpy(), rs[key][k])
        elif name == "adamw8bit":
            for key in ("m", "v"):
                for k in params:
                    got, want = state[key][k], rs[key][k]
                    _close(got["s"].numpy(), want["s"])
                    if scale < 1:
                        np.testing.assert_array_equal(got["q"].numpy(),
                                                      np.asarray(want["q"]))
                    else:   # a scale one ulp off may round one step apart
                        assert np.abs(got["q"].numpy().astype(int) - np.asarray(
                            want["q"]).astype(int)).max() <= 1
        else:
            for k in params:
                for f, v in rs["f"][k].items():
                    _close(state["f"][k][f].numpy(), v)


def test_int8_compressor_payloads_equal_reference():
    """compress_int8 / decompress_int8 / compress_topk on the same
    gradients and residuals: int8 payloads exactly, scales, residuals and
    the sent top-k bit for bit (round half to even on both sides)."""
    g = {k: v for k, v in _grads(1, 1.0).items()}
    r = {k: v * 0.1 for k, v in _grads(2, 1.0).items()}
    # half-integers after scaling: round half to even must agree
    g["b"] = np.array([0.5, 1.5, 2.5, -0.5, 127.0], np.float32)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tr = {k: torch.from_numpy(v) for k, v in r.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jr = {k: jnp.asarray(v) for k, v in r.items()}
    q, s, res = compress_int8(tg, tr)
    rq, rs_, rres = rgc.compress_int8(jg, jr)
    for k in g:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(rq[k]))
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(rs_[k]))
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(rres[k]))
    d, rd = decompress_int8(q, s, tg), rgc.decompress_int8(rq, rs_, jg)
    for k in g:
        np.testing.assert_array_equal(d[k].numpy(), np.asarray(rd[k]))
    sent, res = compress_topk(tg, tr, frac=0.05)
    rsent, rres = rgc.compress_topk(jg, jr, frac=0.05)
    for k in g:
        np.testing.assert_array_equal(sent[k].numpy(), np.asarray(rsent[k]))
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(rres[k]))


def test_lm_optimizer_state_converts_per_layer():
    """The reference's state over an ``lm.init`` pytree, re-keyed by the
    port's parameter names: adamw's and adamw8bit's sliced to layers,
    exactly; adafactor's stacked leaves whole under their stacks' names,
    exactly (a norm's gain stacked over layers is a factored matrix)."""
    rcfg = dataclasses.replace(ref_get("qwen3-1.7b").smoke(),
                               dtype="float32")
    cfg = dataclasses.replace(get("qwen3-1.7b").smoke(), dtype="float32")
    params = rlm.init(jax.random.key(0), rcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, p.dtype), params)
    names = dict(model.named_parameters())
    for name in ("adamw", "adamw8bit"):
        o = ropt.make_optimizer(name)
        _, st = jax.jit(o.update)(grads, o.init(params), params)
        st = jax.tree.map(np.asarray, st)
        port = convert.opt_state_from_numpy(st, cfg=cfg, model=model)
        for key in ("m", "v"):
            assert set(port[key]) == set(names)
            if name == "adamw":
                want = convert.lm_named_from_numpy(st[key], cfg, model)
                for k in names:
                    np.testing.assert_array_equal(port[key][k].numpy(),
                                                  want[k])
            else:
                for f in ("q", "s"):
                    want = convert.lm_named_from_numpy(
                        jax.tree.map(lambda d: d[f], st[key],
                                     is_leaf=lambda d: isinstance(d, dict)
                                     and "q" in d), cfg, model)
                    for k in names:
                        np.testing.assert_array_equal(
                            port[key][k][f].numpy(), want[k])
        # the port's optimizer takes the converted state as it is
        make_optimizer(name).update(
            {k: torch.full_like(p, 1e-3) for k, p in names.items()}, port,
            {k: p.detach().clone() for k, p in names.items()})
    o = ropt.adafactor()
    _, st = jax.jit(o.update)(grads, o.init(params), params)
    st = jax.tree.map(np.asarray, st)
    port = convert.opt_state_from_numpy(st, cfg=cfg, model=model)
    stacks = lm.param_stacks(cfg, names)
    alone = set(names) - {n for ms in stacks.values() for n in ms}
    assert alone == {"embed", "head", "final_norm.g"}
    assert set(port["f"]) == alone | set(stacks)
    assert stacks["blocks.0.norm1.g"] == [f"blocks.{i}.norm1.g"
                                          for i in range(cfg.n_layers)]
    for got, want in ((port["f"]["blocks.0.norm1.g"],
                       st["f"]["blocks"][0]["norm1"]["g"]),
                      (port["f"]["blocks.0.ffn.wi"],
                       st["f"]["blocks"][0]["ffn"]["wi"]["w"]),
                      (port["f"]["final_norm.g"], st["f"]["final_norm"]["g"])):
        assert set(got) == set(want)
        for f in want:
            np.testing.assert_array_equal(got[f].numpy(), want[f])
    make_optimizer("adafactor", stacks=functools.partial(
        lm.param_stacks, cfg)).update(
        {k: torch.full_like(p, 1e-3) for k, p in names.items()}, port,
        {k: p.detach().clone() for k, p in names.items()})


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-v0.1-52b",
                                  "whisper-tiny"])
def test_adafactor_lm_steps_match_reference(arch):
    """Adafactor over a whole LM: one reference update to leave the init,
    then the port takes the reference's state and both take 3 updates on
    the same random gradients (laid out as the reference's pytree, so the
    global-norm clip is active). Each stack of per-layer parameters is one
    leaf as in the reference: second moments factored over the stacked
    shape and one update-clip RMS over the stack. Parameters and state
    within 1e-6 relative; f32 weights, smoke widths (qwen3: 4 layers of
    one pattern position; jamba: 8 positions of one layer; whisper: the
    encoder's blocks stacked too)."""
    rcfg = dataclasses.replace(ref_get(arch).smoke(), dtype="float32")
    cfg = dataclasses.replace(get(arch).smoke(), dtype="float32")
    rp = rlm.init(jax.random.key(1), rcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                         cfg, "cpu")
    rng = np.random.default_rng(5)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), rp)

    o = ropt.adafactor(ropt.OptConfig(lr=1e-2))
    upd = jax.jit(o.update)
    rp, rs = upd(grads(), o.init(rp), rp)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                         cfg, "cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, rs),
                                         cfg=cfg, model=model)
    params = dict(model.named_parameters())
    popt = make_optimizer("adafactor", OptConfig(lr=1e-2),
                          functools.partial(lm.param_stacks, cfg))
    for step in range(1, 4):
        g = grads()
        rp, rs = upd(g, rs, rp)
        gp = convert.lm_named_from_numpy(jax.tree.map(np.asarray, g),
                                         cfg, model)
        params, state = popt.update({k: torch.from_numpy(np.array(v))
                                     for k, v in gp.items()}, state, params)
        want = convert.lm_named_from_numpy(jax.tree.map(np.asarray, rp),
                                           cfg, model)
        for k, p in params.items():
            _close(p.numpy(), want[k])
        _close(float(state["gnorm"]), float(rs["gnorm"]))
        want_f = convert.opt_state_from_numpy(
            jax.tree.map(np.asarray, rs), cfg=cfg, model=model)["f"]
        assert set(state["f"]) == set(want_f)
        for k, f in want_f.items():
            for name, v in f.items():
                _close(state["f"][k][name].numpy(), v.numpy())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_steps_match_reference(microbatches):
    """Three steps of the port's Trainer against the reference's from the
    same initial parameters (the reference's ``lm.init``, carried over),
    the same data: nll and gnorm within 1e-4 relative at every step."""
    rcfg = dataclasses.replace(ref_get("qwen3-1.7b").smoke(),
                               dtype="float32")
    cfg = dataclasses.replace(get("qwen3-1.7b").smoke(), dtype="float32")
    kw = dict(seq_len=32, global_batch=4, microbatches=microbatches,
              steps=3, log_every=1)
    _, _, want = RefTrainer(rcfg, RefTrainConfig(
        opt=ropt.OptConfig(lr=1e-3), **kw)).run()
    params = rlm.init(jax.random.key(0), rcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    _, state, got = Trainer(cfg, TrainConfig(opt=OptConfig(lr=1e-3), **kw),
                            device="cpu").run(model=model)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["nll"], b["nll"], rtol=1e-4)
        np.testing.assert_allclose(a["gnorm"], b["gnorm"], rtol=1e-4)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    assert int(state["step"]) == 3


def _remat_grads(cfg, batch, remat, policy="full", count=None):
    """(loss, gradients) of a fresh model from seed 0; ``count`` (a
    dispatch mode) sees the backward."""
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    loss, aux = lm.loss_fn(model, cfg, batch, remat=remat,
                           remat_policy=policy)
    with count or contextlib.nullcontext():
        loss.backward()
    return loss.detach(), [p.grad for p in model.parameters()]


def _lm_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))}


def test_loss_remat_changes_nothing():
    """The checkpointed loss and its gradients equal the plain ones bit for
    bit (the recompute runs the same ops on the same inputs), under both
    remat policies."""
    cfg = dataclasses.replace(get("jamba-v0.1-52b").smoke(), dtype="float32")
    batch = _lm_batch(cfg)
    out = [_remat_grads(cfg, batch, False),
           _remat_grads(cfg, batch, True),
           _remat_grads(cfg, batch, True, "save_ffn_hidden")]
    for loss, grads in out[1:]:
        assert torch.equal(out[0][0], loss)
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], grads))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama-3.2-vision-11b"])
def test_save_ffn_hidden_keeps_the_hidden_products(arch):
    """``remat_policy="save_ffn_hidden"``: loss and every gradient equal
    "full"'s bit for bit in f32, and the backward (recompute included)
    runs two ``mm`` fewer for each dense FFN (its x @ wi and x @ wg come
    from the forward), so a policy that saves nothing fails."""
    cfg = dataclasses.replace(get(arch).smoke(), dtype="float32")
    batch = _lm_batch(cfg, 1)
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(np.random.default_rng(2)
                                            .standard_normal(
            (2, cfg.cross_kv_tokens, cfg.d_model)).astype(np.float32))
    counts = {}
    res = {}
    for policy in ("full", "save_ffn_hidden"):
        counts[policy] = _OpCount()
        res[policy] = _remat_grads(cfg, batch, True, policy,
                                   counts[policy])
    assert torch.equal(res["full"][0], res["save_ffn_hidden"][0])
    assert all(torch.equal(a, b) for a, b in zip(res["full"][1],
                                                 res["save_ffn_hidden"][1]))
    n_dense = sum(f == "dense" for _, f in map(cfg.block_at,
                                                 range(cfg.n_layers)))
    assert counts["full"].ops["mm"] - counts["save_ffn_hidden"].ops["mm"] \
        == 2 * n_dense


def test_checkpoint_bf16_bits_and_layout(tmp_path):
    """bf16 goes to disk as its raw 16 bits with "bfloat16" in the
    manifest, in the reference's layout, and comes back bit for bit; the
    reference's loader reads the port's checkpoint; the async manager's
    save is isolated from later in-place updates; specs are recorded in
    the reference's JSON, which its loader reads back."""
    x = torch.randn(3, 300).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    saved = x.clone()
    tree = ({"w": x, "n": torch.arange(5, dtype=torch.int32)},
            {"step": torch.tensor(7, dtype=torch.int32)})
    mgr = ckm.CheckpointManager(tmp_path, keep=2, save_interval_steps=1)
    mgr.save(3, tree, metadata={"arch": "t"})
    x.add_(1.0)                      # after save() returned: not in the file
    mgr.wait()
    d = tmp_path / "step_00000003"
    man = json.loads((d / "manifest.json").read_text())
    assert man["entries"]["/0/w"] == {"shape": [3, 300], "dtype": "bfloat16"}
    assert man["metadata"] == {"arch": "t"} and man["step"] == 3
    assert (d / "host_0" / "arrays.npz").is_file()
    back, _ = mgr.restore(tree)
    assert back[0]["w"].dtype == torch.bfloat16
    assert torch.equal(back[0]["w"].view(torch.int16),
                       saved.view(torch.int16))
    assert torch.equal(back[1]["step"], tree[1]["step"])
    from repro.checkpoint.manager import load_checkpoint as ref_load
    ref_tree, _ = ref_load(tmp_path, ({"w": 0, "n": 0}, {"step": 0}))
    np.testing.assert_array_equal(
        np.asarray(ref_tree[0]["w"]).view(np.uint16),
        back[0]["w"].view(torch.int16).numpy().view(np.uint16))
    for _ in range(3):
        mgr.save(4 + _, tree, blocking=True)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000005", "step_00000006"]
    assert json.loads((tmp_path / "step_00000006" / "manifest.json")
                      .read_text())["specs"] is None
    specs = ({"w": (None, ("data", "model")), "n": ("data",)},
             {"step": ()})
    mgr.save(7, tree, specs=specs, blocking=True)
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["specs"] == {"/0/w": [None, ["data", "model"]],
                            "/0/n": ["data"], "/1/step": []}
    from repro.checkpoint.manager import _spec_from_json
    assert tuple(_spec_from_json(man["specs"]["/0/w"])) == \
        (None, ("data", "model"))
