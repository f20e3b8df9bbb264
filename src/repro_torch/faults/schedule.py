"""Deterministic, declarative fault schedules.

A :class:`FaultSchedule` is a seed-reproducible description of *when the
cluster misbehaves*: node crash/recover windows, straggler slowdowns,
KV-link degradation/flaps, heartbeat loss without a crash, and per-request
transient dispatch errors. It compiles into a :class:`FaultTables`
NamedTuple of dense float32 arrays that the evaluator's loop
(``core/fitness.py``, ``EvalConfig(faulty=True)``) reads, so NSGA-II can
tune a genome *against* a degraded regime.

The port of ``repro.faults.schedule``: the numpy half (the vocabulary,
``compile``, the presets and the ``*_np`` lookups) is a copy, and the
time-varying lookups have torch twins (:func:`node_available_torch` ≡
:func:`node_available_np`, …) computed op for op in float32 and batched
over a leading population axis of decision times.

Transient errors are *counter-hashed*, not sampled: request index ``i`` is
mixed through a splitmix-style uint32 finalizer, so whether request ``i``
hits a transient error, and its backoff jitter, is a pure function of
``(seed, i)``. Torch has no wrapping uint32 arithmetic, so
:func:`mix32_torch` keeps the values in int64 and masks each product back
to 32 bits (the products stay below 2**59).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import Device, resolve

_INF = np.float32(np.inf)
_MIX_C = np.uint32(0x45D9F3B)
_MIX_PHI = 0x9E3779B9   # golden-ratio constant decorrelating hash streams
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# declarative fault vocabulary

@dataclass(frozen=True)
class CrashWindow:
    """Node ``node`` is down (unavailable, fails heartbeats) on
    ``start <= t < end``."""
    node: int
    start: float
    end: float


@dataclass(frozen=True)
class Straggler:
    """Node ``node`` executes ``factor``x slower on ``start <= t < end``
    (factor >= 1). The evaluator scales prefill/decode service time."""
    node: int
    start: float
    end: float
    factor: float


@dataclass(frozen=True)
class LinkFlap:
    """The cluster-wide KV link runs ``factor``x slower on
    ``start <= t < end`` (factor >= 1); transfer times stretch by it."""
    start: float
    end: float
    factor: float


@dataclass(frozen=True)
class HeartbeatLoss:
    """Node ``node`` stops heartbeating on ``start <= t < end`` while its
    engines keep running — the monitor marks it stale and routing avoids
    it, but inflight work completes. A monitoring-plane fault only: the
    evaluator models data-plane time and treats it as a no-op."""
    node: int
    start: float
    end: float


@dataclass(frozen=True)
class TransientErrors:
    """Per-request transient dispatch failures. Request ``i`` fails its
    first attempt iff ``mix32(seed ^ i) / 2^32 < rate``; the retry lands
    after ``backoff * (1 + jitter * u_i)`` seconds where ``u_i`` is a
    second independent hash stream. Deterministic in ``(seed, i)``."""
    rate: float
    backoff: float = 0.05
    jitter: float = 0.5
    seed: int = 0


# ---------------------------------------------------------------------------
# compiled representation

class FaultTables(NamedTuple):
    """Dense float32 compilation of a FaultSchedule.

    Window arrays are padded to at least one column so the structure is
    identical whether a fault class is present or not: crash pads with
    empty ``[inf, inf)`` windows, slowdown pads with factor-1.0 windows.
    Fields are numpy arrays after ``compile`` and tensors after
    :func:`torch_tables`.
    """
    crash_start: np.ndarray    # (n_nodes, Kc) f32, inf-padded
    crash_end: np.ndarray      # (n_nodes, Kc) f32
    slow_start: np.ndarray     # (n_nodes, Ks) f32
    slow_end: np.ndarray       # (n_nodes, Ks) f32
    slow_factor: np.ndarray    # (n_nodes, Ks) f32, 1.0-padded
    link_start: np.ndarray     # (Kl,) f32
    link_end: np.ndarray       # (Kl,) f32
    link_factor: np.ndarray    # (Kl,) f32, 1.0-padded
    err_rate: np.ndarray       # () f32
    err_backoff: np.ndarray    # () f32
    err_jitter: np.ndarray     # () f32
    err_seed: np.ndarray       # () int32


@dataclass(frozen=True)
class FaultSchedule:
    """A declarative, seed-reproducible fault scenario."""
    crashes: Tuple[CrashWindow, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    link_flaps: Tuple[LinkFlap, ...] = ()
    heartbeat_losses: Tuple[HeartbeatLoss, ...] = ()
    transient: TransientErrors = field(
        default_factory=lambda: TransientErrors(rate=0.0))

    def compile(self, n_nodes: int) -> FaultTables:
        """Compile to dense per-node window tables for ``n_nodes``."""
        def windows(items, get_node, cols):
            k = max(1, max((len([w for w in items if get_node(w) == n])
                            for n in range(n_nodes)), default=0))
            out = [np.full((n_nodes, k), pad, np.float32)
                   for pad in cols.values()]
            fill = [0] * n_nodes
            for w in items:
                n = get_node(w)
                assert 0 <= n < n_nodes, f"fault names node {n} of {n_nodes}"
                j = fill[n]
                fill[n] = j + 1
                for out_a, attr in zip(out, cols.keys()):
                    out_a[n, j] = np.float32(getattr(w, attr))
            return out

        crash_start, crash_end = windows(
            self.crashes, lambda w: w.node,
            {"start": _INF, "end": _INF})
        slow_start, slow_end, slow_factor = windows(
            self.stragglers, lambda w: w.node,
            {"start": _INF, "end": _INF, "factor": np.float32(1.0)})
        kl = max(1, len(self.link_flaps))
        link_start = np.full((kl,), _INF, np.float32)
        link_end = np.full((kl,), _INF, np.float32)
        link_factor = np.ones((kl,), np.float32)
        for j, w in enumerate(self.link_flaps):
            link_start[j] = np.float32(w.start)
            link_end[j] = np.float32(w.end)
            link_factor[j] = np.float32(w.factor)
        t = self.transient
        return FaultTables(
            crash_start=crash_start, crash_end=crash_end,
            slow_start=slow_start, slow_end=slow_end,
            slow_factor=slow_factor,
            link_start=link_start, link_end=link_end,
            link_factor=link_factor,
            err_rate=np.float32(t.rate), err_backoff=np.float32(t.backoff),
            err_jitter=np.float32(t.jitter),
            err_seed=np.int32(np.uint32(t.seed).view(np.int32)))

    # -- seeded preset generators ------------------------------------------
    @classmethod
    def crash_storm(cls, n_nodes: int, *, seed: int = 0, n_crashes: int = 4,
                    horizon: float = 60.0, mean_down: float = 8.0,
                    spare: int = 0) -> "FaultSchedule":
        """Repeated node crashes across the horizon. Nodes ``< spare``
        never crash (keeps a fallback alive)."""
        rng = np.random.default_rng(seed)
        eligible = list(range(spare, n_nodes))
        crashes = []
        for _ in range(n_crashes):
            node = int(rng.choice(eligible))
            start = float(rng.uniform(0.05, 0.75) * horizon)
            down = float(rng.exponential(mean_down)) + 1.0
            crashes.append(CrashWindow(node, start, start + down))
        return cls(crashes=tuple(crashes))

    @classmethod
    def link_flap(cls, *, seed: int = 0, n_flaps: int = 3,
                  horizon: float = 60.0, factor: float = 20.0,
                  mean_len: float = 5.0) -> "FaultSchedule":
        """The KV link degrades ``factor``x in short repeated windows."""
        rng = np.random.default_rng(seed)
        flaps = []
        for _ in range(n_flaps):
            start = float(rng.uniform(0.0, 0.8) * horizon)
            dur = float(rng.exponential(mean_len)) + 0.5
            flaps.append(LinkFlap(start, start + dur, factor))
        return cls(link_flaps=tuple(flaps))

    @classmethod
    def straggler_storm(cls, n_nodes: int, *, seed: int = 0,
                        n_stragglers: int = 2, horizon: float = 60.0,
                        factor: float = 4.0,
                        mean_len: float = 15.0) -> "FaultSchedule":
        """A few nodes run ``factor``x slow for stretches of the run."""
        rng = np.random.default_rng(seed)
        slows = []
        for _ in range(n_stragglers):
            node = int(rng.integers(0, n_nodes))
            start = float(rng.uniform(0.0, 0.6) * horizon)
            dur = float(rng.exponential(mean_len)) + 2.0
            slows.append(Straggler(node, start, start + dur, factor))
        return cls(stragglers=tuple(slows))


# ---------------------------------------------------------------------------
# counter hash (splitmix-style uint32 finalizer)

def _mix32_py(x: int) -> int:
    """uint32 avalanche hash on Python ints, masked to 32 bits."""
    x &= _U32
    x = (((x >> 16) ^ x) * int(_MIX_C)) & _U32
    x = (((x >> 16) ^ x) * int(_MIX_C)) & _U32
    return ((x >> 16) ^ x) & _U32


def mix32_torch(x: torch.Tensor) -> torch.Tensor:
    """The same hash on an int64 tensor of values in [0, 2**32): each
    product is masked back to 32 bits, as uint32 arithmetic wraps."""
    c = int(_MIX_C)
    x = x & _U32
    x = (((x >> 16) ^ x) * c) & _U32
    x = (((x >> 16) ^ x) * c) & _U32
    return (x >> 16) ^ x


def _u32(a) -> int:
    """The uint32 value of an int32 seed (its bit pattern)."""
    return int(np.uint32(np.asarray(a).view(np.uint32)))


# ---------------------------------------------------------------------------
# time-varying lookup twins (float32 op-for-op)

def node_available_np(ft: FaultTables, t) -> np.ndarray:
    """(n_nodes,) bool — node NOT inside any crash window at time t."""
    t = np.float32(t)
    hit = (t >= ft.crash_start) & (t < ft.crash_end)
    return ~np.any(hit, axis=1)


def node_slowdown_np(ft: FaultTables, t) -> np.ndarray:
    """(n_nodes,) f32 — max slowdown factor of active windows, else 1."""
    t = np.float32(t)
    active = (t >= ft.slow_start) & (t < ft.slow_end)
    fac = np.where(active, ft.slow_factor, np.float32(1.0))
    return np.max(fac, axis=1).astype(np.float32)


def link_slowdown_np(ft: FaultTables, t) -> np.float32:
    """() f32 — max active KV-link slowdown factor, else 1."""
    t = np.float32(t)
    active = (t >= ft.link_start) & (t < ft.link_end)
    fac = np.where(active, ft.link_factor, np.float32(1.0))
    return np.float32(np.max(fac))


def node_available_torch(ft: FaultTables, t: torch.Tensor) -> torch.Tensor:
    """(P, n_nodes) bool for (P,) f32 decision times ``t``."""
    t = t.to(torch.float32)[:, None, None]
    hit = (t >= ft.crash_start) & (t < ft.crash_end)
    return ~hit.any(dim=2)


def node_slowdown_torch(ft: FaultTables, t: torch.Tensor) -> torch.Tensor:
    """(P, n_nodes) f32 for (P,) decision times ``t``."""
    t = t.to(torch.float32)[:, None, None]
    active = (t >= ft.slow_start) & (t < ft.slow_end)
    fac = torch.where(active, ft.slow_factor, 1.0)
    return fac.amax(dim=2)


def link_slowdown_torch(ft: FaultTables, t: torch.Tensor) -> torch.Tensor:
    """(P,) f32 for (P,) decision times ``t``."""
    t = t.to(torch.float32)[:, None]
    active = (t >= ft.link_start) & (t < ft.link_end)
    fac = torch.where(active, ft.link_factor, 1.0)
    return fac.amax(dim=1)


_U32_SCALE = np.float32(1.0 / 4294967296.0)


def transient_hit_np(ft: FaultTables, i: int) -> bool:
    """Does request ``i`` hit a transient error on its first attempt?"""
    seed = _u32(ft.err_seed)
    u = np.float32(_mix32_py(seed ^ int(i)) * _U32_SCALE)
    return bool(u < np.float32(ft.err_rate))


def transient_delay_np(ft: FaultTables, i: int) -> np.float32:
    """Added latency (seconds) request ``i`` pays for its transient
    retry; 0 when the request does not hit an error."""
    seed = _u32(ft.err_seed)
    u = np.float32(_mix32_py(seed ^ int(i)) * _U32_SCALE)
    j = np.float32(_mix32_py(seed ^ int(i) ^ _MIX_PHI) * _U32_SCALE)
    delay = np.float32(ft.err_backoff) * (
        np.float32(1.0) + np.float32(ft.err_jitter) * j)
    return np.where(u < np.float32(ft.err_rate), delay,
                    np.float32(0.0)).astype(np.float32)


def transient_delay_torch(ft: FaultTables, i: torch.Tensor) -> torch.Tensor:
    """f32 retry delay of every request index in the int64 tensor ``i``
    (0 where a request does not hit an error). The hash values are
    rounded to f32 to nearest, as uint32 -> f32 conversion rounds."""
    seed = ft.err_seed.to(torch.int64) & _U32     # the int32's bit pattern
    i = i.to(torch.int64) & _U32
    u = mix32_torch(seed ^ i).to(torch.float32) * float(_U32_SCALE)
    j = mix32_torch(seed ^ i ^ _MIX_PHI).to(torch.float32) * float(_U32_SCALE)
    delay = ft.err_backoff * (1.0 + ft.err_jitter * j)
    return torch.where(u < ft.err_rate, delay, 0.0)


def backoff_jitter_u(seed: int, rid: int, attempt: int) -> float:
    """Uniform [0, 1) jitter for retry ``attempt`` of request ``rid`` —
    the runtime's deterministic exponential-backoff jitter stream."""
    return _mix32_py((int(seed) ^ int(rid) ^ (int(attempt) * _MIX_PHI))
                     & _U32) / 4294967296.0


def heartbeat_lost(schedule: FaultSchedule, node: int, t: float) -> bool:
    """Is ``node`` inside a heartbeat-loss window at time ``t``? (Host-side
    only — the monitoring plane is not part of the analytic model.)"""
    return any(w.node == node and w.start <= t < w.end
               for w in schedule.heartbeat_losses)


def torch_tables(ft: FaultTables, device: Device = None) -> FaultTables:
    """The tables as tensors on ``device`` (CUDA unless asked), for the
    evaluator's loop."""
    dev = resolve(device)
    return FaultTables(*(torch.as_tensor(np.array(a)).to(dev) for a in ft))
