"""The port's sharding rules against the reference's: every parameter,
KV-cache, batch and optimizer-state spec of the ten configs at their
published widths on the production meshes ((16, 16) and (2, 16, 16),
abstract: names and sizes only) equals the reference's ``PartitionSpec``
exactly (a stacked reference leaf's period axis dropped); the twins of the
spec tests of ``tests/test_distributed.py``; the production meshes on the
fake process group; and ``to_placements`` against JAX's
``NamedSharding.devices_indices_map`` on 8 fabricated host devices (JAX in
a subprocess, so the fabricated devices never reach this process).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import all_ids
from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro.models import sharding as rshard
from repro_torch.configs import get
from repro_torch.convert import lm_ref_paths
from repro_torch.launch.dryrun import opt_state_specs
from repro_torch.launch.mesh import make_production_mesh, production_world
from repro_torch.models import lm
from repro_torch.models import sharding as shard

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(kind):
    shape, names = MESHES[kind]
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def _mesh(kind):
    shape, names = MESHES[kind]
    return shard.AbstractMesh(zip(names, shape))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get(arch).config()
    return jax.eval_shape(lambda k: rlm.init(k, cfg), jax.random.key(0))


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) \
            and not isinstance(tree, P) else tree[key]
    return tree


def _is_p(x):
    return isinstance(x, P)


def _ref_opt_state_specs(*args):
    """The reference's ``opt_state_specs``. Its module sets XLA_FLAGS to
    fabricate 512 host devices when imported; the flag is put back at
    once, so no later JAX initialization in this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import opt_state_specs
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return opt_state_specs(*args)


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", all_ids())
def test_param_specs_equal_reference(arch, kind):
    """Train and serve specs of every parameter equal the reference's leaf
    spec with its stacked axis dropped."""
    cfg = get(arch).config()
    model = lm.LM(cfg, "meta")
    paths = lm_ref_paths(model, cfg)
    assert set(paths) == {n for n, _ in model.named_parameters()}
    for mode in ("train", "serve"):
        ref = rshard.param_specs(ref_get(arch).config(), _ref_params(arch),
                                 _ref_mesh(kind), mode=mode)
        got = shard.param_specs(cfg, model, _mesh(kind), mode=mode)
        for name, (path, stacked) in paths.items():
            want = tuple(_leaf(ref, path))
            assert got[name] == (want[1:] if stacked else want), \
                (mode, name, path)


def test_param_specs_cover_all_leaves_and_divide():
    mesh = _mesh("single")
    for arch in ("qwen3-4b", "dbrx-132b", "jamba-v0.1-52b", "xlstm-1.3b",
                 "whisper-tiny"):
        cfg = get(arch).config()
        model = lm.LM(cfg, "meta")
        specs = shard.param_specs(cfg, model, mesh, mode="train")
        assert set(specs) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            assert len(specs[name]) == p.dim()
            for dim, axis in zip(p.shape, specs[name]):
                assert dim % shard._axis_size(mesh, axis) == 0, \
                    (arch, name, specs[name])


def test_serve_specs_replicate_fsdp_for_small_archs():
    cfg = get("qwen3-1.7b").config()
    specs = shard.param_specs(cfg, lm.LM(cfg, "meta"), _mesh("single"),
                              mode="serve")
    for spec in specs.values():
        assert "data" not in [a for a in spec if a is not None]


def test_big_arch_serve_specs_keep_fsdp():
    cfg = get("dbrx-132b").config()
    specs = shard.param_specs(cfg, lm.LM(cfg, "meta"), _mesh("single"),
                              mode="serve")
    assert "data" in {a for spec in specs.values() for a in spec if a}


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert shard.constrain(x, "dp", None) is x
    assert shard.constrain(x, "dp", "model") is x


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", all_ids())
def test_cache_and_batch_specs_equal_reference(arch, kind):
    """The decode_32k cache's specs leaf by leaf (the port stacks layers
    where the reference stacks periods: the leaf's other dims are the
    same), kv_len's, and the batch's."""
    B, S = 128, 32768
    rcfg, cfg = ref_get(arch).config(), get(arch).config()
    rcache = jax.eval_shape(lambda: rlm.make_cache(
        rcfg, B, S, kv_len=jnp.full((B,), S - 1, jnp.int32)))
    rspecs = rshard.cache_specs(rcfg, rcache, _ref_mesh(kind))
    by_shape = {}
    for leaf, spec in zip(jax.tree.leaves(rcache),
                          jax.tree.leaves(rspecs, is_leaf=_is_p)):
        if leaf.ndim >= 3:
            by_shape.setdefault(tuple(leaf.shape[1:]), set()).add(
                tuple(spec))
    cache = lm.make_cache(cfg, B, S, "meta")
    got = shard.cache_specs(cfg, cache, _mesh(kind))
    ported = [(cache.k, got.k), (cache.v, got.v)] if cache.k.shape[0] \
        else []
    ported += [(cache.state[k], got.state[k]) for k in cache.state]
    for t, spec in ported:
        assert by_shape[tuple(t.shape[1:])] == {spec}, (t.shape, spec)
    assert got.kv_len == tuple(rspecs.kv_len)
    rbatch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "frames": jax.ShapeDtypeStruct((B, 7, 3), jnp.bfloat16)}
    want = rshard.batch_specs(rcfg, rbatch, _ref_mesh(kind))
    got = shard.batch_specs(cfg, {k: torch.empty(v.shape, device="meta")
                                  for k, v in rbatch.items()}, _mesh(kind))
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "adafactor"])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_opt_state_specs_equal_reference(arch, opt_name):
    """Optimizer-state specs against the reference's: adamw's and
    adamw8bit's per parameter (stacked axis dropped), adafactor's per
    stack exactly as the reference's stacked leaf."""
    rcfg, cfg = ref_get(arch).config(), get(arch).config()
    mesh, rmesh = _mesh("single"), _ref_mesh("single")
    rparams = _ref_params(arch)
    rp = rshard.param_specs(rcfg, rparams, rmesh)
    rstate = _ref_opt_state_specs(opt_name, rparams, rp)
    model = lm.LM(cfg, "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = opt_state_specs(opt_name, shapes,
                          shard.param_specs(cfg, model, mesh),
                          functools.partial(lm.param_stacks, cfg))
    assert got["step"] == tuple(rstate["step"]) == ()
    paths = lm_ref_paths(model, cfg)
    for name, (path, stacked) in paths.items():
        drop = (lambda s: tuple(s)[1:]) if stacked else tuple
        if opt_name == "adamw":
            assert got["m"][name] == drop(_leaf(rstate["m"], path))
        elif opt_name == "adamw8bit":
            for part in ("q", "s"):
                assert got["v"][name][part] == \
                    drop(_leaf(rstate["v"], path)[part]), (name, part)
        elif name in got["f"]:
            want = _leaf(rstate["f"], path)
            assert got["f"][name] == {k: tuple(v) for k, v in want.items()}
    if opt_name == "adafactor":
        assert len(got["f"]) == len(jax.tree.leaves(
            rstate["f"], is_leaf=lambda x: isinstance(x, dict)
            and ("vr" in x or "v" in x)))


@pytest.fixture
def fake_world():
    """A fake process group of the requested size, destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_production_mesh_shapes(fake_world):
    for multi_pod, want in ((False, {"data": 16, "model": 16}),
                            (True, {"pod": 2, "data": 16, "model": 16})):
        fake_world(production_world(multi_pod))
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert shard.axis_sizes(mesh) == want
        assert list(mesh.mesh_dim_names) == list(want)
        assert shard.dp_axes(mesh) == tuple(a for a in ("pod", "data")
                                            if a in want)


PLACEMENT_CASES = [
    ((2, 4), ("data", "model"), (8, 16), ("data", "model")),
    ((2, 4), ("data", "model"), (8, 16), ("model", "data")),
    ((2, 4), ("data", "model"), (16, 4), (("data", "model"), None)),
    ((2, 4), ("data", "model"), (3, 8), (None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6), (("pod", "data"),
                                                      "model", None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8), (None, ("pod", "data",
                                                          "model"))),
    ((2, 2, 2), ("pod", "data", "model"), (4, 2), ("model", "pod")),
]

_JAX_INDEX_MAP = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = []
for mshape, names, shape, spec in json.loads(sys.argv[1]):
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(mshape))])
                .reshape(mshape), tuple(names))
    spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out.append({d.id: [[s.start or 0, s.stop if s.stop is not None else n]
                       for s, n in zip(idx, shape)]
                for d, idx in m.items()})
print(json.dumps(out))
"""


def test_to_placements_matches_jax_index_map(fake_world):
    """Each rank's local block of a DTensor placed by ``to_placements``
    equals the index block JAX gives the device at the same mesh
    coordinate."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_INDEX_MAP),
         json.dumps(PLACEMENT_CASES)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    maps = json.loads(proc.stdout.strip().splitlines()[-1])
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    for case, index_map in zip(PLACEMENT_CASES, maps):
        mshape, names, shape, spec = case
        world = int(np.prod(mshape))
        x = torch.arange(int(np.prod(shape))).reshape(shape)
        for rank in range(world):
            fake_world(world, rank)
            mesh = init_device_mesh("cpu", mshape, mesh_dim_names=names)
            local = distribute_tensor(
                x, mesh, shard.to_placements(mesh, spec),
                src_data_rank=None).to_local()
            block = index_map[str(rank)]
            want = x[tuple(slice(a, b) for a, b in block)]
            assert torch.equal(local, want), (case, rank)
            assert tuple(local.shape) == shard.local_shape(
                shape, shard.AbstractMesh(zip(names, mshape)), spec)


def test_to_placements_refuses_out_of_order_axes(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="order"):
        shard.to_placements(mesh, (("model", "data"), None))
    with pytest.raises(ValueError, match="twice"):
        shard.to_placements(mesh, ("data", "data"))
