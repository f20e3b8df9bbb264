"""Parity of the port's fault schedules with the JAX package's: the copied
vocabulary, ``compile`` and presets are bit-equal to the reference's, and
the torch lookups (batched over decision times) equal the ``*_np`` and
``*_jnp`` twins at seeded times and on window edges. The transient-error
hash keeps uint32 arithmetic in int64 with a mask after each product; it
is held bit for bit against the Python-int hash on the values where
wrapping, sign and rounding to f32 matter."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as rf
from repro.faults import schedule as rs
from repro_torch import faults as tf
from repro_torch.faults import schedule as ts

N_NODES = 4
EDGE_CASES = (0, 1, 2**16 - 1, 2**16, 2**24 - 1, 2**24, 2**24 + 1, 2**31 - 1,
              2**31, 2**32 - 2, 2**32 - 1, 0x9E3779B9, 0x45D9F3B)


def _schedules(mod):
    """Hand-built and preset schedules, built the same way in both
    packages."""
    sched = mod.FaultSchedule(
        crashes=(mod.CrashWindow(1, 2.0, 5.0), mod.CrashWindow(1, 9.0, 12.5),
                 mod.CrashWindow(3, 0.0, 1.0)),
        stragglers=(mod.Straggler(0, 0.0, 1e9, 3.0),
                    mod.Straggler(2, 4.0, 8.0, 2.5),
                    mod.Straggler(2, 6.0, 7.0, 4.0)),
        link_flaps=(mod.LinkFlap(1.0, 3.0, 20.0),
                    mod.LinkFlap(2.5, 4.0, 5.0)),
        heartbeat_losses=(mod.HeartbeatLoss(2, 3.0, 6.0),),
        transient=mod.TransientErrors(rate=0.3, backoff=0.07, jitter=0.4,
                                      seed=2**31 + 12345))
    out = [sched, mod.FaultSchedule(),
           mod.FaultSchedule(stragglers=(mod.Straggler(0, 0.0, 1e9, 3.0),)),
           mod.FaultSchedule(transient=mod.TransientErrors(
               rate=0.9, seed=2**32 - 1))]
    for seed in (0, 3, 11):
        out += [mod.FaultSchedule.crash_storm(N_NODES, seed=seed, spare=1),
                mod.FaultSchedule.link_flap(seed=seed),
                mod.FaultSchedule.straggler_storm(N_NODES, seed=seed)]
    return out


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def test_schedules_presets_and_compile_bit_equal():
    for got, want in zip(_schedules(tf), _schedules(rf)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        ft, rt = got.compile(N_NODES), want.compile(N_NODES)
        assert ft._fields == rt._fields
        for a, b in zip(ft, rt):
            _bit_equal(a, b)
        tt = tf.torch_tables(ft, "cpu")
        for a, b in zip(tt, rt):
            _bit_equal(a.numpy(), b)
    with pytest.raises(AssertionError, match="node 7"):
        tf.FaultSchedule(crashes=(tf.CrashWindow(7, 0, 1),)).compile(4)


def test_mix32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    xs = list(EDGE_CASES) + [int(v) for v in rng.integers(0, 2**32, 500)]
    got = ts.mix32_torch(torch.tensor(xs, dtype=torch.int64)).tolist()
    want = [rs._mix32_py(x) for x in xs]
    jx = np.asarray(rs._mix32_jnp(jnp.asarray(np.asarray(xs, np.uint32))))
    assert got == want == [int(v) for v in jx]
    assert [ts._mix32_py(x) for x in xs] == want
    # f32 rounding of the hash (round to nearest, as uint32 -> f32 does)
    f = ts.mix32_torch(torch.tensor(xs)).to(torch.float32).numpy()
    _bit_equal(f, np.asarray(want, np.uint32).astype(np.float32))
    for seed, rid, attempt in ((0, 0, 0), (-7, 2**31, 3), (2**32 - 1, 5, 9)):
        assert ts.backoff_jitter_u(seed, rid, attempt) == \
            rs.backoff_jitter_u(seed, rid, attempt)


@pytest.mark.parametrize("k", [0, 4, 5, 6])
def test_lookups_equal_np_and_jnp_twins(k):
    """Seeded times plus every window edge (just below, on, just above),
    batched as one (P,) vector of decision times, for the hand-built
    schedule and a crash storm, a link flap and a straggler storm. XLA on
    the CPU flushes subnormal inputs to zero, so the jnp twins are held at
    the normal times only (the neighbours of a window edge at 0 are
    subnormal)."""
    ft, rt = _schedules(tf)[k].compile(N_NODES), _schedules(rf)[k].compile(
        N_NODES)
    tt, jt = tf.torch_tables(ft, "cpu"), rf.jnp_tables(rt)
    edges = np.concatenate([np.ravel(a) for a in (
        ft.crash_start, ft.crash_end, ft.slow_start, ft.slow_end,
        ft.link_start, ft.link_end)]).astype(np.float32)
    edges = edges[np.isfinite(edges)]
    times = np.concatenate([
        edges, np.nextafter(edges, np.float32(-np.inf)),
        np.nextafter(edges, np.float32(np.inf)),
        np.random.default_rng(k).uniform(0, 60, 200),
        [0.0, 1e9, np.inf]]).astype(np.float32)
    t = torch.from_numpy(times)
    avail = tf.node_available_torch(tt, t).numpy()
    slow = tf.node_slowdown_torch(tt, t).numpy()
    link = tf.link_slowdown_torch(tt, t).numpy()
    assert avail.shape == slow.shape == (len(times), N_NODES)
    tiny = np.finfo(np.float32).tiny
    for j, x in enumerate(times):
        _bit_equal(avail[j], rf.node_available_np(rt, x))
        _bit_equal(slow[j], rf.node_slowdown_np(rt, x))
        _bit_equal(link[j], rf.link_slowdown_np(rt, x))
        _bit_equal(tf.node_available_np(ft, x), rf.node_available_np(rt, x))
        _bit_equal(tf.node_slowdown_np(ft, x), rf.node_slowdown_np(rt, x))
        _bit_equal(tf.link_slowdown_np(ft, x), rf.link_slowdown_np(rt, x))
        if x == 0 or abs(x) >= tiny:
            jx = jnp.float32(x)
            _bit_equal(avail[j], np.asarray(rf.node_available_jnp(jt, jx)))
            _bit_equal(slow[j], np.asarray(rf.node_slowdown_jnp(jt, jx)))
            _bit_equal(link[j], np.asarray(rf.link_slowdown_jnp(jt, jx)))
    sched = _schedules(tf)[k]
    assert (~avail).any() == bool(sched.crashes)
    assert (slow > 1).any() == bool(sched.stragglers)
    assert (link > 1).any() == bool(sched.link_flaps)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31, 2**31 + 12345,
                                  2**32 - 1])
def test_transient_delays_equal_reference(seed):
    """Request indexes 0..., the hash edge cases and indexes past 2**24:
    the torch delays equal ``transient_delay_np`` and ``_jnp`` bit for bit,
    and the hit flags ``transient_hit_np``. Seeds from 2**31 up compile to
    a negative int32 ``err_seed``, which the hash reads as its bits."""
    sched_t = tf.FaultSchedule(transient=tf.TransientErrors(
        rate=0.35, backoff=0.05, jitter=0.5, seed=seed))
    sched_r = rf.FaultSchedule(transient=rf.TransientErrors(
        rate=0.35, backoff=0.05, jitter=0.5, seed=seed))
    ft, rt = sched_t.compile(N_NODES), sched_r.compile(N_NODES)
    _bit_equal(ft.err_seed, rt.err_seed)
    assert (int(ft.err_seed) < 0) == (seed >= 2**31)
    idx = np.asarray(list(range(300)) + [2**24 - 1, 2**24, 2**24 + 3,
                                         2**30 + 17, 2**31 - 1], np.int64)
    got = tf.transient_delay_torch(tf.torch_tables(ft, "cpu"),
                                   torch.from_numpy(idx)).numpy()
    jt = rf.jnp_tables(rt)
    hits = 0
    for k, i in enumerate(idx):
        want = rf.transient_delay_np(rt, int(i))
        _bit_equal(got[k], want)
        _bit_equal(tf.transient_delay_np(ft, int(i)), want)
        _bit_equal(got[k], np.asarray(rf.transient_delay_jnp(
            jt, jnp.int32(i))))
        assert tf.transient_hit_np(ft, int(i)) == rf.transient_hit_np(rt,
                                                                       int(i))
        hits += bool(got[k] > 0)
    assert 0 < hits < len(idx)


def test_heartbeat_loss_is_host_side():
    sched_t, sched_r = _schedules(tf)[0], _schedules(rf)[0]
    for node in range(N_NODES):
        for t in (2.9, 3.0, 5.9, 6.0):
            assert tf.heartbeat_lost(sched_t, node, t) == \
                rf.heartbeat_lost(sched_r, node, t)
