"""The plain reference of the served models: a teacher-forced forward of
whole sequences in float32 (or, for the control, with every matrix
product's operands rounded to float8 e4m3), layer by layer.

It follows the configuration file as run (``spec.Model``): RMSNorm, rotary
q and k (halves, every channel), grouped-query causal softmax attention
with optional per-head q/k RMSNorm, SwiGLU; the Mamba mixer as a plain
sequential recurrence; the top-k MoE with its capacity, which drops the
assignments past an expert's capacity C in token order when a prompt is
prefilled alone (C = max(8, ceil(T k c / E) rounded up to 8) over the
prompt's T tokens) and none at decode, where a batch of 8 rows never fills
an expert's 8 places. Weights are read from the benchmark's checkpoint
(``spec.leaves`` names) and widened a layer, or an expert, at a time.
Imports nothing of the program.

For ``witness_moe.py``, the MoE layers also give their own top-k
(``Ref.topk``) and router margin at each position (the k-th largest
router logit less the (k+1)-th, the least over the layers:
``Ref.margins``), and take forced experts in place of their own
(``Ref.force``). Where the margin is small the top-k set turns on
rounding, and a bf16 program may send the token to other experts than
this float32 reference does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .spec import Model

#: float8 e4m3's largest finite value
FP8_MAX = 448.0


def _q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor."""
    amax = t.abs().max().clamp(min=1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Ref:
    """The reference over one model's weights ``W`` (name -> tensor, any
    dtype, on ``device``); ``prec`` "f32" or "fp8" (the control)."""

    def __init__(self, m: Model, W: Dict[str, torch.Tensor], prec: str,
                 device: torch.device):
        self.m, self.W, self.prec, self.dev = m, W, prec, device
        #: {layer: (B, S, k) expert ids} the MoE layers take in place of
        #: their own top-k, or None
        self.force = None
        #: after ``logits``: per sequence, the least router margin over the
        #: MoE layers at each row of its logits (None without MoE layers)
        self.margins = None
        self._margin = None
        #: after ``logits``: {MoE layer: (B, S, k) its own top-k experts}
        self.topk = {}

    def w(self, name: str) -> torch.Tensor:
        return self.W[name].to(self.dev, torch.float32)

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.prec == "fp8":
            a, w = _q8(a), _q8(w)
        return a @ w

    def norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.m.eps) * g

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, H, D), positions 0..S-1, rotated by halves."""
        S, D = x.shape[1], x.shape[-1]
        half = D // 2
        freqs = self.m.rope_theta ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
            * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    # -- mixers ----------------------------------------------------------------
    def attention(self, p: str, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        B, S, _ = h.shape
        q = self.mm(h, self.w(p + "wq")).view(B, S, m.n_heads, m.head_dim)
        k = self.mm(h, self.w(p + "wk")).view(B, S, m.n_kv_heads, m.head_dim)
        v = self.mm(h, self.w(p + "wv")).view(B, S, m.n_kv_heads, m.head_dim)
        if m.qk_norm:
            q = self.norm(q, self.w(p + "qnorm"))
            k = self.norm(k, self.w(p + "knorm"))
        q, k = self.rope(q), self.rope(k)
        if self.prec == "fp8":
            q, k, v = _q8(q), _q8(k), _q8(v)
        G = m.n_heads // m.n_kv_heads
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(m.head_dim)
        mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        if self.prec == "fp8":
            w = _q8(w)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.mm(out.reshape(B, S, -1), self.w(p + "wo"))

    def mamba(self, p: str, h: torch.Tensor) -> torch.Tensor:
        m, s = self.m, self.m.ssm
        B, S, _ = h.shape
        xi, z = self.mm(h, self.w(p + "in_proj")).chunk(2, dim=-1)
        conv_w = self.w(p + "conv_w")
        xpad = F.pad(xi, (0, 0, s.d_conv - 1, 0))
        xc = sum(xpad[:, i:i + S] * conv_w[i] for i in range(s.d_conv))
        xc = F.silu(xc + self.w(p + "conv_b"))
        proj = self.mm(xc, self.w(p + "x_proj"))
        dt_in, Bv, Cv = proj.split([s.dt_rank, s.d_state, s.d_state], dim=-1)
        dt = F.softplus(self.mm(dt_in, self.w(p + "dt_proj_w"))
                        + self.w(p + "dt_proj_b"))
        A = -torch.exp(self.w(p + "A_log"))
        hs = torch.zeros(B, m.d_inner, s.d_state, device=h.device)
        ys = []
        for t in range(S):
            hs = (torch.exp(dt[:, t, :, None] * A) * hs
                  + (dt[:, t] * xc[:, t])[:, :, None] * Bv[:, t, None, :])
            ys.append(torch.einsum("bds,bs->bd", hs, Cv[:, t]))
        y = torch.stack(ys, dim=1) + self.w(p + "D") * xc
        return self.mm(y * F.silu(z), self.w(p + "out_proj"))

    # -- FFNs --------------------------------------------------------------------
    def dense(self, p: str, h: torch.Tensor) -> torch.Tensor:
        g = F.silu(self.mm(h, self.w(p + "wg")))
        return self.mm(g * self.mm(h, self.w(p + "wi")), self.w(p + "wo"))

    def moe(self, p: str, h: torch.Tensor,
            prompt_lens: Sequence[int], layer: int = -1) -> torch.Tensor:
        e = self.m.moe
        B, S, d = h.shape
        logit = self.mm(h, self.w(p + "router"))
        probs = torch.softmax(logit, dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        srt = torch.sort(logit, dim=-1, descending=True).values
        margin = srt[..., e.top_k - 1] - srt[..., e.top_k]
        self._margin = margin if self._margin is None else \
            torch.minimum(self._margin, margin)
        top_w, top_e = top_w[..., :e.top_k], top_e[..., :e.top_k]
        self.topk[layer] = top_e
        if self.force is not None and layer in self.force:
            top_e = self.force[layer].to(h.device)
            top_w = probs.gather(-1, top_e)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
        keep = torch.ones_like(top_e, dtype=torch.bool)
        for b, L in enumerate(prompt_lens):
            # the prompt's prefill alone: the first C assignments of each
            # expert in (token, choice) order are kept
            C = max(8, 8 * math.ceil(math.ceil(
                L * e.top_k * e.capacity_factor / e.n_experts) / 8))
            seen = [0] * e.n_experts
            kb = []
            for ex in top_e[b, :L].reshape(-1).tolist():
                kb.append(seen[ex] < C)
                seen[ex] += 1
            kb = torch.tensor(kb, dtype=torch.bool, device=h.device)
            keep[b, :L] = kb.view(L, e.top_k)
        y = torch.zeros(B, S, d, device=h.device)
        hf = h.reshape(-1, d)
        yf = y.view(-1, d)
        sel_e, sel_w = top_e.reshape(-1, e.top_k), top_w.reshape(-1, e.top_k)
        sel_k = keep.reshape(-1, e.top_k)
        for ex in torch.unique(top_e).tolist():
            rows, j = torch.nonzero((sel_e == ex) & sel_k, as_tuple=True)
            if rows.numel() == 0:
                continue
            x = hf[rows]
            wi = self.W[p + "wi"][ex].to(self.dev, torch.float32)
            wg = self.W[p + "wg"][ex].to(self.dev, torch.float32)
            wo = self.W[p + "wo"][ex].to(self.dev, torch.float32)
            out = self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wi), wo)
            yf.index_add_(0, rows, out * sel_w[rows, j][:, None])
        return y

    # -- the whole model -------------------------------------------------------------
    def logits(self, seqs: List[List[int]], prompt_lens: Sequence[int]
               ) -> List[torch.Tensor]:
        """For each sequence (prompt + served tokens but the last), the
        f32 logits at positions prompt_len - 1 .. len - 1: the ones that
        chose the served tokens."""
        m = self.m
        B, S = len(seqs), max(map(len, seqs))
        tok = torch.zeros(B, S, dtype=torch.int64, device=self.dev)
        for b, s in enumerate(seqs):
            tok[b, :len(s)] = torch.tensor(s, device=self.dev)
        x = self.w("embed")[tok]
        self._margin, self.topk = None, {}
        for i, (mixer, ffn) in enumerate(m.layers):
            p = f"blocks.{i}."
            h = self.norm(x, self.w(p + "norm1.g"))
            x = x + (self.attention(p + "mixer.", h) if mixer == "attn"
                     else self.mamba(p + "mixer.", h))
            h = self.norm(x, self.w(p + "norm2.g"))
            x = x + (self.moe(p + "ffn.", h, prompt_lens, i) if ffn == "moe"
                     else self.dense(p + "ffn.", h))
        x = self.norm(x, self.w("final_norm.g"))
        head = self.w("embed" if m.tie else "head")
        out = []
        for b, s in enumerate(seqs):
            rows = x[b, prompt_lens[b] - 1:len(s)]
            out.append(self.mm(rows, head.T))
        self.margins = None if self._margin is None else [
            self._margin[b, prompt_lens[b] - 1:len(s)]
            for b, s in enumerate(seqs)]
        return out
