"""The system under test, built from a configuration file: the port's
models at the file's sizes with the benchmark's weights, and the port's
cluster server over the file's testbed.

The weights are the benchmark's own: drawn on the device from the seed in
the dtype they are served in, one ``normal_`` call per (dtype, scale)
group into one flat buffer, and handed to the port as views (the port's
modules are built on the meta device, so nothing is allocated twice). The
same tensors go to the reference after the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..reference import spec as S

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_seed(seed: int, offset: int) -> int:
    """One 63-bit generator seed from the run's seed and a model's
    offset."""
    st = np.random.SeedSequence([int(seed), int(offset)]).generate_state(
        2, np.uint32)
    return (int(st[0]) << 31) ^ int(st[1])


def make_weights(m: S.Model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``m`` (``spec.leaves``), filled from ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    groups: Dict[Tuple[str, float], list] = {}
    W: Dict[str, torch.Tensor] = {}
    for leaf in S.leaves(m):
        if leaf.fill == "normal":
            groups.setdefault((leaf.dtype, leaf.scale), []).append(leaf)
            continue
        dt = DTYPES[leaf.dtype]
        if leaf.fill == "ones":
            t = torch.ones(leaf.shape, dtype=dt, device=device)
        elif leaf.fill == "zeros":
            t = torch.zeros(leaf.shape, dtype=dt, device=device)
        elif leaf.fill == "dt_bias":
            t = torch.full(leaf.shape, S.DT_BIAS, dtype=dt, device=device)
        else:   # a_log: log(1..d_state) in every channel
            a = torch.arange(1, leaf.shape[1] + 1, dtype=dt, device=device)
            t = torch.log(a)[None, :].expand(leaf.shape).contiguous()
        W[leaf.name] = t
    for (dtype, scale), ls in sorted(groups.items()):
        n = sum(int(np.prod(leaf.shape)) for leaf in ls)
        flat = torch.empty(n, dtype=DTYPES[dtype], device=device)
        flat.normal_(0.0, scale, generator=gen)
        o = 0
        for leaf in ls:
            k = int(np.prod(leaf.shape))
            W[leaf.name] = flat[o:o + k].view(leaf.shape)
            o += k
    return W


def port_config(group: dict, m: S.Model):
    """The port's ModelConfig of a model group at the file's depth, with
    the file's layer order, norm epsilon and head tying where the port's
    config differs in those (options the port has); raises where the
    port's widths differ from the file's."""
    from repro_torch.configs import get

    mod = get(group["port_config"])
    cfg = mod.smoke() if group.get("port_size") == "smoke" else mod.config()
    if cfg.n_layers != m.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=m.n_layers)
    if tuple(cfg.block_at(i) for i in range(cfg.n_layers)) != m.layers:
        cfg = dataclasses.replace(cfg, pattern=m.layers)
    cfg = dataclasses.replace(cfg, norm_eps=m.eps, tie_embeddings=m.tie)
    want = dict(d_model=m.d, n_heads=m.n_heads, n_kv_heads=m.n_kv_heads,
                hd=m.head_dim, vocab=m.vocab, rope_theta=m.rope_theta,
                qk_norm=m.qk_norm, norm="rmsnorm", activation="swiglu",
                dtype="bfloat16")
    have = {k: getattr(cfg, k) for k in want}
    if m.moe is not None:
        have["moe"] = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff,
                       cfg.moe.capacity_factor)
        want["moe"] = (m.moe.n_experts, m.moe.top_k, m.moe.d_ff,
                       m.moe.capacity_factor)
        have["ssm"] = (cfg.ssm.d_state, cfg.ssm.d_conv, cfg.ssm.expand,
                       max(1, cfg.d_model // 16))
        want["ssm"] = (m.ssm.d_state, m.ssm.d_conv, m.ssm.expand,
                       m.ssm.dt_rank)
    else:
        have["d_ff"], want["d_ff"] = cfg.d_ff, m.d_ff
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if bad:
        raise ValueError(f"{group['port_config']}: the port's config differs "
                         f"from the file (port, file): {bad}")
    return cfg


def port_lm(cfg, W: Dict[str, torch.Tensor]):
    """The port's LM over the benchmark's tensors ``W``."""
    from repro_torch.models import lm

    model = lm.LM(cfg, "meta")
    names = dict(model.named_parameters())
    if set(names) != set(W):
        raise ValueError(f"{cfg.name}: checkpoint and port differ in "
                         f"{sorted(set(names) ^ set(W))[:8]}")
    for name, p in names.items():
        t = W[name]
        if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
            raise ValueError(f"{cfg.name}.{name}: port {tuple(p.shape)} "
                             f"{p.dtype}, checkpoint {tuple(t.shape)} "
                             f"{t.dtype}")
        prefix, _, leaf = name.rpartition(".")
        mod = model.get_submodule(prefix) if prefix else model
        setattr(mod, leaf, nn.Parameter(t, requires_grad=False))
    return model


@dataclasses.dataclass
class Side:
    """One model of the deployment: its plain sizes, the port's config and
    LM, and the benchmark's tensors."""
    m: S.Model
    cfg: object
    lm: object
    W: Dict[str, torch.Tensor]


def build_models(conf: dict, seed: int, device) -> Dict[str, Side]:
    """{"cloud": Side, "edge": Side} of a configuration file."""
    out = {}
    for role, group in (("cloud", conf), ("edge", conf["edge"])):
        m = S.model(group)
        cfg = port_config(group, m)
        W = make_weights(m, model_seed(seed, group["weights_seed_offset"]),
                         device)
        out[role] = Side(m, cfg, port_lm(cfg, W), W)
    return out


def build_server(conf: dict, sides: Dict[str, Side], device):
    """The port's ClusterServer over the file's testbed."""
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.serving import ClusterServer, EngineConfig

    tb = conf["testbed"]
    spec = paper_testbed()
    have = [(spec.nodes[j].name, spec.models[k].name)
            for j, k in spec.pairs()]
    want = [(n["name"], name) for n in tb["nodes"] for name in n["models"]]
    if have != want:
        raise ValueError(f"testbed pairs differ: port {have}, file {want}")
    models = {name: (sides[role].cfg, sides[role].lm)
              for name, role in tb["served_by"].items()}
    e = tb["engine"]
    return ClusterServer(
        spec, models, np.asarray(tb["thresholds"], np.float32),
        EngineConfig(max_slots=e["max_slots"], max_seq=e["max_seq"],
                     prefill_bucket=e["prefill_bucket"]),
        hedge_after=tb["hedge_after"], fleet=tb["fleet"], device=device)
