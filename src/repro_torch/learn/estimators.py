"""Per-(node, category) online estimators for TTFT, TPOT and quality.

Residual parametrization (the cold-start contract)
--------------------------------------------------
The estimators never re-learn the static pair tables — they learn *residuals*
against them, and the corrected estimate a policy sees is

    prefill' = prefill_table · (1 + d_p)        (multiplicative)
    tpot'    = tpot_table    · (1 + d_t)        (multiplicative)
    quality' = clip(quality_mean_table + d_q, 0, 1)   (additive)

with all residuals seeded at **zero**, so ``x · (1 + 0.0)`` and ``q + 0.0``
reproduce the static tables bitwise and cold-start routing equals the
static-prior routing.

Two estimator kinds, selected by ``LearnConfig.kind``:

* ``"ewma"`` — per-(node, category, signal) scalar residual EWMA
  ``r ← r + α (y − r)`` plus an observation count; uncertainty is
  ``1/√(1+n)``.
* ``"blr"`` — per-(node, category, signal) Bayesian linear regression of the
  residual over request features ``x = [1, prompt/512, complexity,
  min(queue/conc, 4)]``, kept as A⁻¹ by Sherman–Morrison rank-1 updates;
  uncertainty is the LinUCB width ``√(xᵀ A⁻¹ x)``.

The port of ``repro.learn.estimators``. The numpy half (``LearnConfig``,
``init_state``, ``predict_np``, ``update_np``, :class:`OnlineEstimator`) is
a copy; ``predict_torch``/``update_torch`` are the twins of the reference's
scan-carry functions, batched over P genomes with state ``(P,
state_size)``. Every update and prediction is written as explicit
fixed-association float32 element-wise operations (no ``matmul``, ``sum``
or fused ``addcmul``/``lerp``), the same trees in both halves, so the
states stay bit-equal across numpy, JAX and torch on either device.

Observation contract: the latency signals are speed ratios computed from
shared float32 table values — ``y = (static · slow) / static − 1`` — so a
fault-free run observes exactly 0; the quality signal is the realized minus
the expected quality. Disaggregated routes attribute the prefill residual
to the prefill node and the TPOT/quality residuals to the decode node.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: signal indices within a (node, category) slot group
N_SIGNALS = 3           # 0 = prefill ratio, 1 = tpot ratio, 2 = quality delta
#: pred_category cardinality (workload.classifier.CATEGORIES)
N_CATEGORIES = 3
#: BLR feature vector [1, prompt_norm, complexity, queue_norm]
FEAT_DIM = 4

_PROMPT_NORM = np.float32(512.0)   # prompt-token feature scale
_QUEUE_CAP = np.float32(4.0)       # queue/conc feature cap (masks DEAD_QUEUE)
_EPS = np.float32(1e-6)
_ONE = np.float32(1.0)
_ZERO = np.float32(0.0)

_EWMA_SLOT = 2                     # [residual, count]
_BLR_SLOT = FEAT_DIM * FEAT_DIM + FEAT_DIM   # [A⁻¹ (16), b (4)]


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    """Hashable estimator configuration.

    kind: "ewma" | "blr". alpha: EWMA step size. prior: BLR prior precision
    λ (A⁻¹ seeded at I/λ; larger = slower to move off the static tables).
    rel_clip: upper clip of the multiplicative residuals (lower clip is
    -0.9 so corrected times stay positive; quality deltas clip to ±1).
    """

    kind: str = "ewma"
    alpha: float = 0.25
    prior: float = 25.0
    rel_clip: float = 4.0

    def __post_init__(self):
        assert self.kind in ("ewma", "blr"), self.kind
        assert 0.0 < self.alpha <= 1.0
        assert self.prior > 0.0 and self.rel_clip > 0.0

    @property
    def slot(self) -> int:
        return _EWMA_SLOT if self.kind == "ewma" else _BLR_SLOT


def state_size(cfg: LearnConfig, n_nodes: int) -> int:
    """Flat float32 state length."""
    return n_nodes * N_CATEGORIES * N_SIGNALS * cfg.slot


def init_state(cfg: LearnConfig, n_nodes: int) -> np.ndarray:
    """Neutral (static-table-seeded) state: zero residuals everywhere.

    EWMA slots start at [r=0, n=0]; BLR slots at [A⁻¹=I/λ, b=0] whose
    posterior mean is the zero vector — either way the first prediction is
    a zero residual and corrected estimates equal the static tables bitwise.
    """
    s = np.zeros((n_nodes, N_CATEGORIES, N_SIGNALS, cfg.slot), np.float32)
    if cfg.kind == "blr":
        eye = (np.eye(FEAT_DIM, dtype=np.float32)
               / np.float32(cfg.prior)).reshape(-1)
        s[..., :FEAT_DIM * FEAT_DIM] = eye
    return s.reshape(-1)


def _clip(xp, x, lo, hi):
    if xp is np:
        return np.clip(x, lo, hi)
    return torch.clamp(x, min=float(lo), max=float(hi))


def _sqrt(xp, x):
    """Correctly rounded f32 square root. torch's vectorized f32 sqrt on
    the CPU is not (it differs from IEEE in the last bit on ~0.7% of
    inputs); the f64 root rounded to f32 is, on the CPU and on the card."""
    if xp is np:
        return np.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def features(xp, prompt_tokens, complexity, queue_len, node_conc):
    """Decision-time feature triple (x1 scalar, x2 scalar, x3 per-node).

    ``queue_len`` is the policy-visible (possibly fault-masked) busy-slot
    view, ``(n_nodes,)`` or ``(P, n_nodes)``; the cap at ``_QUEUE_CAP``
    keeps DEAD_QUEUE sentinels from poisoning the regression features.
    ``xp`` is numpy or torch.
    """
    if xp is np:
        x1 = np.float32(prompt_tokens) / _PROMPT_NORM
        x2 = np.float32(complexity)
        load = (queue_len.astype(np.float32)
                / node_conc.astype(np.float32))
        return x1, x2, np.minimum(load, _QUEUE_CAP)
    x1 = prompt_tokens / float(_PROMPT_NORM)
    load = queue_len.to(torch.float32) / node_conc.to(torch.float32)
    return x1, complexity, torch.clamp(load, max=float(_QUEUE_CAP))


def _blr_matvec(A, v0, v1, v2, v3):
    """A (…, 4, 4) · v, unrolled with fixed association (bit-stable)."""
    u0 = (A[..., 0, 0] * v0 + A[..., 0, 1] * v1) + \
         (A[..., 0, 2] * v2 + A[..., 0, 3] * v3)
    u1 = (A[..., 1, 0] * v0 + A[..., 1, 1] * v1) + \
         (A[..., 1, 2] * v2 + A[..., 1, 3] * v3)
    u2 = (A[..., 2, 0] * v0 + A[..., 2, 1] * v1) + \
         (A[..., 2, 2] * v2 + A[..., 2, 3] * v3)
    u3 = (A[..., 3, 0] * v0 + A[..., 3, 1] * v1) + \
         (A[..., 3, 2] * v2 + A[..., 3, 3] * v3)
    return u0, u1, u2, u3


def _dot4(a0, a1, a2, a3, b0, b1, b2, b3):
    return (a0 * b0 + a1 * b1) + (a2 * b2 + a3 * b3)


def _predict(xp, cfg: LearnConfig, sl, x1, x2, x3):
    """(d_prefill, d_tpot, d_quality, unc) from the (…, n_nodes, 3, slot)
    slots of the request's category."""
    if cfg.kind == "ewma":
        d_p, d_t, d_q = sl[..., 0, 0], sl[..., 1, 0], sl[..., 2, 0]
        unc = _ONE / _sqrt(xp, _ONE + sl[..., 2, 1])
    else:
        shape = sl.shape[:-2] + (FEAT_DIM, FEAT_DIM)
        ds = []
        for sig in range(N_SIGNALS):
            A = sl[..., sig, :FEAT_DIM * FEAT_DIM].reshape(shape)
            b = sl[..., sig, FEAT_DIM * FEAT_DIM:]
            w0, w1, w2, w3 = _blr_matvec(A, b[..., 0], b[..., 1], b[..., 2],
                                         b[..., 3])
            ds.append(_dot4(w0, w1, w2, w3, _ONE, x1, x2, x3))
        d_p, d_t, d_q = ds
        Aq = sl[..., 2, :FEAT_DIM * FEAT_DIM].reshape(shape)
        u0, u1, u2, u3 = _blr_matvec(Aq, _ONE, x1, x2, x3)
        dot = _dot4(u0, u1, u2, u3, _ONE, x1, x2, x3)
        unc = _sqrt(xp, np.maximum(dot, _ZERO) if xp is np
                    else torch.clamp(dot, min=0.0))
    lo, hi = np.float32(-0.9), np.float32(cfg.rel_clip)
    return (_clip(xp, d_p, lo, hi), _clip(xp, d_t, lo, hi),
            _clip(xp, d_q, -_ONE, _ONE), unc)


def predict_np(cfg: LearnConfig, state, n_nodes: int, cat, x1, x2, x3):
    s4 = state.reshape(n_nodes, N_CATEGORIES, N_SIGNALS, cfg.slot)
    return _predict(np, cfg, s4[:, int(cat)], np.float32(x1),
                    np.float32(x2), np.asarray(x3, np.float32))


def predict_torch(cfg: LearnConfig, state: torch.Tensor, n_nodes: int,
                  cat: int, x1, x2, x3: torch.Tensor):
    """Batched twin of :func:`predict_np`: ``state`` (P, state_size), ``x3``
    (P, n_nodes); each output (P, n_nodes)."""
    s5 = state.reshape(-1, n_nodes, N_CATEGORIES, N_SIGNALS, cfg.slot)
    return _predict(torch, cfg, s5[:, :, int(cat)], x1, x2, x3)


def _slot_update(xp, cfg: LearnConfig, slot, x1, x2, x3, y):
    """Next value of (…, slot) slots after observing y (…,)."""
    if cfg.kind == "ewma":
        a = np.float32(cfg.alpha)
        r, n = slot[..., 0], slot[..., 1]
        return xp.stack([r + a * (y - r), n + _ONE], -1)
    A = slot[..., :FEAT_DIM * FEAT_DIM].reshape(slot.shape[:-1]
                                                + (FEAT_DIM, FEAT_DIM))
    b = slot[..., FEAT_DIM * FEAT_DIM:]
    u0, u1, u2, u3 = _blr_matvec(A, _ONE, x1, x2, x3)
    inv = _ONE / (_ONE + _dot4(u0, u1, u2, u3, _ONE, x1, x2, x3))
    u = xp.stack([u0, u1, u2, u3], -1)
    # Sherman–Morrison, the reference's (u uᵀ) · inv
    A_new = A - (u[..., :, None] * u[..., None, :]) * inv[..., None, None]
    b_new = b + xp.stack([_ONE * y, x1 * y, x2 * y, x3 * y], -1)
    return xp.concatenate([A_new.reshape(b.shape[:-1]
                                         + (FEAT_DIM * FEAT_DIM,)),
                           b_new], -1)


#: (signal, which node observes it): prefill on the prefill node, tpot and
#: quality on the decode node (identical nodes on colocated routes)
_SIGNAL_NODES = ((0, "p"), (1, "q"), (2, "q"))


def update_np(cfg: LearnConfig, state, n_nodes: int, cat, node_p, node_q,
              x1, x2, x3, y_p, y_t, y_q) -> np.ndarray:
    """One observation into a fresh copy of the state."""
    s4 = np.array(state, np.float32).reshape(n_nodes, N_CATEGORIES,
                                             N_SIGNALS, cfg.slot)
    cat = int(cat)
    ys = (np.float32(y_p), np.float32(y_t), np.float32(y_q))
    x3 = np.asarray(x3, np.float32)
    for sig, leg in _SIGNAL_NODES:
        node = int(node_p) if leg == "p" else int(node_q)
        s4[node, cat, sig] = _slot_update(np, cfg, s4[node, cat, sig],
                                          np.float32(x1), np.float32(x2),
                                          x3[node], ys[sig])
    return s4.reshape(-1)


def update_torch(cfg: LearnConfig, state: torch.Tensor, n_nodes: int,
                 cat: int, node_p: torch.Tensor, node_q: torch.Tensor,
                 x1, x2, x3: torch.Tensor, y_p, y_t, y_q) -> torch.Tensor:
    """Batched twin of :func:`update_np`: genome p's observation goes into
    its own row, at its own (P,) nodes. The three signals are written one
    after another in the reference's order, so a colocated route (node_p ==
    node_q) reads what the earlier signal wrote."""
    P = state.shape[0]
    rows = torch.arange(P, device=state.device)
    s5 = state.reshape(P, n_nodes, N_CATEGORIES, N_SIGNALS, cfg.slot).clone()
    ys = (y_p, y_t, y_q)
    cat = int(cat)
    for sig, leg in _SIGNAL_NODES:
        node = node_p if leg == "p" else node_q
        s5[rows, node, cat, sig] = _slot_update(
            torch, cfg, s5[rows, node, cat, sig], x1, x2, x3[rows, node],
            ys[sig])
    return s5.reshape(P, -1)


def observations(xp, prefill_static, slow_p, tpot_static, slow_q, q_real,
                 q_mean):
    """(y_p, y_t, y_q) residual targets from shared float32 table values.

    Latency signals are speed ratios of the *full* static phase time —
    ``(static · slow)/static − 1`` — so a fault-free run observes exactly
    zero; the quality signal is realized minus expected.
    """
    if xp is np:
        floor = lambda x: np.maximum(x, _EPS)  # noqa: E731
    else:
        floor = lambda x: torch.clamp(x, min=float(_EPS))  # noqa: E731
    y_p = xp.where(prefill_static > _EPS,
                   (prefill_static * slow_p) / floor(prefill_static) - _ONE,
                   _ZERO)
    y_t = xp.where(tpot_static > _EPS,
                   (tpot_static * slow_q) / floor(tpot_static) - _ONE,
                   _ZERO)
    return y_p, y_t, q_real - q_mean


def corrected_rows(xp, prefill_row, tpot_row, quality_row, d_p, d_t, d_q,
                   unc, pair_node):
    """Apply per-node residuals (…, n_nodes) to the per-pair estimate rows.

    Zero residuals reproduce the inputs bitwise (×1.0 and +0.0 are float32
    identities) — the cold-start contract policies rely on.
    """
    prefill_c = prefill_row * (_ONE + d_p[..., pair_node])
    tpot_c = tpot_row * (_ONE + d_t[..., pair_node])
    quality_c = _clip(xp, quality_row + d_q[..., pair_node], _ZERO, _ONE)
    return prefill_c, tpot_c, quality_c, unc[..., pair_node]


class OnlineEstimator:
    """Live (runtime) numpy estimator held by ``ClusterMonitor``.

    The router applies :meth:`predict` corrections on its hot path and
    ``RequestRouter.record`` feeds :meth:`observe` with realized-vs-
    estimated ratios in the caller's own clock domain (the multiplicative
    residual absorbs the unit scale).
    """

    def __init__(self, cfg: LearnConfig = LearnConfig(), n_nodes: int = 0,
                 node_conc=None):
        assert n_nodes > 0, "OnlineEstimator needs the cluster's node count"
        self.cfg = cfg
        self.n_nodes = n_nodes
        # per-node concurrency for the queue-load feature (ones when the
        # caller never provides queue context)
        self.node_conc = (np.ones(n_nodes, np.int64) if node_conc is None
                          else np.asarray(node_conc, np.int64))
        self.state = init_state(cfg, n_nodes)
        self.n_obs = 0

    def predict(self, cat, prompt_tokens, complexity, queue_len, node_conc):
        """(d_prefill, d_tpot, d_quality, unc) per node for one request."""
        x1, x2, x3 = features(np, prompt_tokens, complexity,
                              np.asarray(queue_len, np.int64),
                              np.asarray(node_conc))
        return predict_np(self.cfg, self.state, self.n_nodes, cat, x1, x2,
                          x3)

    @staticmethod
    def ratio(expected: float, realized: float) -> float:
        """Residual target ``realized/expected − 1`` (0 when unobservable)."""
        e = float(expected)
        if e <= 1e-6:
            return 0.0
        return float(np.float32(realized) / np.float32(e) - _ONE)

    def observe(self, cat, node_p, node_q, prompt_tokens, complexity,
                queue_len, node_conc, y_prefill, y_tpot,
                y_quality=0.0) -> None:
        """Feed one completed request's residual targets."""
        x1, x2, x3 = features(np, prompt_tokens, complexity,
                              np.asarray(queue_len, np.int64),
                              np.asarray(node_conc))
        self.state = update_np(self.cfg, self.state, self.n_nodes, cat,
                               node_p, node_q, x1, x2, x3, y_prefill, y_tpot,
                               y_quality)
        self.n_obs += 1
