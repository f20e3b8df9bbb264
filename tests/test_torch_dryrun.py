"""The port's dry run, model cards and policy shim against the reference.

One dry-run cell of each kind for qwen3-1.7b on the (16, 16) production
mesh (a fake process group of 256 ranks, fake tensors): train_4k,
prefill_32k, decode_32k, and long_500k skipped with the reference's
reason; and the train_4k cells of llama4-maverick (adafactor) and
dbrx-132b (adamw8bit), each in a process of its own (the dry run's own
CLI) while the qwen3 cells run. Held per rank:

* the parameters' local blocks, summed over each parameter's distinct
  shards, give the model's whole bytes: bf16 weights at 2 bytes and f32
  norms at 4, over ``param_counts()["total"]`` parameters plus what that
  count leaves out (``chip_smoke.uncounted_params``: the final norm);
* adamw's state is 8 bytes for each parameter of the rank's blocks, the
  batch 8-byte tokens (and labels) of the rank's rows; the train step,
  run by the sharded trainer itself, keeps 4-byte gradient blocks,
  updates the blocks in place for every optimizer (gathers nothing) and
  fills exactly the embedding, the head and the final norm plus its
  largest period, the 'model'-parallel weights (embedding, head, dense
  FFN, experts) as 1/16 blocks, attention at rank 0's query heads (wq's
  columns, wo's rows: 1 of qwen3's 16, 2 of llama4's 40, 3 of dbrx's 48)
  and the one KV head they read (1 of 8), and the rest whole; the record
  gives those heads a rank; its collectives are counted; llama4's fill is
  under 2.5 GB and its step under 15 GB a rank (37.11 GB and 782.6 GB when
  every weight was filled whole and adafactor gathered its stacks);
* the serving cells run the sharded server itself (``ShardedServer``):
  it holds every weight as the blocks it computes on (the train fill's
  blocks, every weight resident, nothing filled in a step, 0.27 GB a
  rank); its cache holds every KV head at the rank's 1/16 of the
  positions, the reference spec's sequence slice, 469,762,048 bytes at
  prefill_32k and 1,879,048,192 at decode_32k; its collectives are the
  embedding's and each layer's attention and FFN sums (57 all-reduces of
  the rows' (B, S, 2048) bf16) and one all-gather of the (B, 151,936) f32
  logits; prefill moves each layer's K/V to the ranks whose positions
  they are (28 all-to-alls, receiving the rank's cache block), and a
  decode step gathers each layer's new-token q, k and v (16 ranks x 8
  rows x 3 heads of 128 bf16) and the decode kernel's partial (o, lse)
  (16 x 8 x 16 heads x 129 f32): 57 all-gathers;
* FLOPs against ``model_flops_per_token()`` x the rank's tokens, within
  the factor the step's structure gives. Train runs the forward, the remat
  recompute of every period (not the head) and the backward: at least
  (8 N - 2 head) / 6 N of 6 N, and at most 4/3 plus the attention
  scores, which the plain attention computes over the whole S x S square
  (4 L S q_dim a token forward, at the rank's share of the query heads);
  N is the active parameters less the embedding, with the FFN's and the
  head's at 1/16 and attention's at the rank's heads (the rank computes
  on its 'model' blocks of them, in every cell); qwen3's train step is at
  most 1.0e14 FLOPs a rank (4.704e14 with attention whole on every rank),
  llama4's 0.8e15. Prefill reads the head at one row; decode reads the
  S-deep cache at the rank's query heads.
* ``card()``'s fields equal the reference's when ``make_card`` gets the
  reference's own chip constants (197 TFLOP/s, 819 GB/s).
"""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.policy as ref_policy
from repro.configs import all_ids
from repro.configs import get as ref_get
from repro_torch.configs import get
from repro_torch.configs._base import make_card
from repro_torch.core import policy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.models import lm
from repro_torch.models import sharding as shard

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCH = "qwen3-1.7b"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: train_4k cells of the archs whose experts and vocabulary dominated the
#: fill, and their optimizers (``optimizer_for_arch``)
MOE_TRAIN = {"llama4-maverick-400b-a17b": "adafactor",
             "dbrx-132b": "adamw8bit"}
SRC = Path(__file__).resolve().parent.parent / "src"
#: parameters that a 'model'-parallel region fills as 1/16 blocks
REGION = re.compile(r"embed|head|blocks\.\d+\.ffn\.(wi|wg|wo)")
#: attention's weights, which it fills at the rank's heads
HEADS = re.compile(r"blocks\.\d+\.mixer2?\.(wq|wk|wv|wo)")
N_MODEL = 16


def _rank0_heads(cfg):
    """(query heads, KV heads) of rank 0 of the 16-wide 'model' axis: the
    query heads [0, H / 16) rounded down, and the one KV head they read
    (or Hkv / 16 of them)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    assert N_MODEL <= H and (Hkv % N_MODEL == 0 or N_MODEL % Hkv == 0)
    return H // N_MODEL, max(1, Hkv // N_MODEL)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}"
           f"{os.environ.get('PYTHONPATH', '')}", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--mesh", "single", "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch in MOE_TRAIN]
    try:
        got = {s: dryrun.run_cell(ARCH, s, "single", out) for s in SHAPES}
        for p in procs:
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for arch in MOE_TRAIN:
        got[arch] = json.loads(
            (out / f"{arch}__train_4k__single.json").read_text())
    return got


def _block_bytes(cfg, n, p):
    """Bytes of rank 0's compute block of the parameter ``n``: a region's
    weights at 1/16, attention's at rank 0's heads, the rest whole."""
    Hq, Hkv = _rank0_heads(cfg)
    b = p.numel() * p.element_size()
    if HEADS.fullmatch(n):
        kv = n[-2:] in ("wk", "wv")
        return b // (cfg.n_kv_heads if kv else cfg.n_heads) * (
            Hkv if kv else Hq)
    return b // 16 if REGION.fullmatch(n) else b


def _fill_reckoning(cfg):
    """The most bytes a train step fills at once: the parameters outside
    the blocks (for the step) and the largest period, each at rank 0's
    compute block (``_block_bytes``)."""
    named = list(lm.LM(cfg, "meta").named_parameters())

    def nbytes(n, p):
        return _block_bytes(cfg, n, p)

    outside = sum(nbytes(n, p) for n, p in named
                  if not n.startswith("blocks."))
    P = len(cfg.pattern)
    periods = [0] * cfg.n_periods
    for n, p in named:
        if n.startswith("blocks."):
            periods[int(n.split(".")[1]) // P] += nbytes(n, p)
    return outside + max(periods)


def test_dryrun_records_each_kind(cells):
    for s in SHAPES[:3]:
        rec = cells[s]
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["n_chips"] == 256 and rec["mesh_shape"] == {
            "data": 16, "model": 16}
        assert rec["memory"] is None and rec["cost_analysis"] is None
        assert "no torch counterpart" in rec["null_because"]
    train = cells["train_4k"]["collectives"]
    assert train["total_count"] > 0
    # qwen3's wk / wv are stored at half a KV head a rank: the fill moves
    # the rank's head by an all-to-all (and its gradient back)
    assert set(train["count"]) == set(train["bytes"]) == {
        "c10d_functional.all_gather_into_tensor", "c10d.allreduce_",
        "c10d.alltoall_base_"}
    # the serving step: the embedding's and each layer's attention and FFN
    # sums of the rows' activations, the logits gathered; blocks filled
    # at load. Prefill sends each layer's K/V to the ranks whose positions
    # they are: one all-to-all a layer, receiving the rank's cache block.
    # Decode gathers each layer's new-token q, k and v (1 + 1 + 1 heads a
    # rank) and the ranks' partial (o, lse): two all-gathers a layer
    cfg = get(ARCH).config()
    n, L, hd = N_MODEL, cfg.n_layers, cfg.hd
    for s, rows, S in (("prefill_32k", 2, 32768), ("decode_32k", 8, 1)):
        got = cells[s]["collectives"]
        sums = 1 + 2 * L
        logits = rows * cfg.vocab * 4
        if s == "prefill_32k":
            block = 2 * rows * (S // n) * cfg.n_kv_heads * hd * 2
            count = {"c10d.allreduce_": sums, "c10d._allgather_base_": 1,
                     "c10d.alltoall_base_": L}
            moved = {"c10d._allgather_base_": logits,
                     "c10d.alltoall_base_": L * block}
            assert L * block == cells[s]["cache_bytes_per_rank"]
        else:
            qkv = n * rows * 3 * hd * 2
            partial = n * rows * cfg.n_heads * (hd + 1) * 4
            assert (qkv, partial) == (98_304, 1_056_768)
            count = {"c10d.allreduce_": sums,
                     "c10d._allgather_base_": 1 + 2 * L}
            moved = {"c10d._allgather_base_": logits + L * (qkv + partial)}
        assert got["count"] == count
        assert got["bytes"] == {
            "c10d.allreduce_": sums * rows * S * cfg.d_model * 2, **moved}
        assert got["total_count"] == sum(count.values())
    skipped = cells["long_500k"]
    assert skipped["status"] == "skipped"
    assert skipped["reason"].startswith("full-attention arch")


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_dryrun_bytes_per_rank(cells, shape):
    rec = cells[shape]
    cfg = get(ARCH).config()
    mesh = shard.AbstractMesh({"data": 16, "model": 16})
    mode = "train" if shape == "train_4k" else "serve"
    model = lm.LM(cfg, "meta")
    specs = shard.param_specs(cfg, model, mesh, mode=mode)
    local = whole = numel = 0
    for name, p in model.named_parameters():
        n_local = int(np.prod(shard.local_shape(p.shape, mesh, specs[name])))
        n_shards = p.numel() // n_local
        local += n_local * p.element_size()
        whole += n_local * n_shards * p.element_size()
        numel += p.numel()
    if shape == "train_4k":     # the trainer stores the placements' blocks
        assert rec["param_bytes_per_rank"] == local
    else:   # the server keeps every weight as its compute block, ~0.27 GB
        held = sum(_block_bytes(cfg, n, p)
                   for n, p in model.named_parameters())
        assert rec["param_bytes_per_rank"] == held
        assert 0.26e9 < held < 0.28e9
        assert rec["filled_param_bytes_peak"] == held
        assert rec["filled_each_step_params"] == 0
        assert rec["resident_params"] == len(specs)
        # the cache at every KV head and the rank's S / 16 positions: the
        # reference spec's sequence slice
        cache = {"prefill_32k": 469_762_048,
                 "decode_32k": 1_879_048_192}[shape]
        assert rec["cache_bytes_per_rank"] == cache
        assert rec["cache_bytes_per_rank_reference_spec"] == cache
        assert rec["split"] == {"query_heads": {"min": 1, "max": 1,
                                                "rank_0": 1},
                                "kv_heads": {"min": 1, "max": 1,
                                             "rank_0": 1},
                                "mamba_channels": None}
    assert rec["param_bytes_total"] == whole
    assert numel == cfg.param_counts()["total"] + \
        chip_smoke.uncounted_params(cfg)
    f32 = sum(p.numel() for p in model.parameters() if p.element_size() == 4)
    assert whole == 2 * (numel - f32) + 4 * f32
    rows = {"train_4k": 16, "prefill_32k": 2, "decode_32k": 8}[shape]
    assert rec["batch_local"] == rows and rec["batch_axes"] == ["data"]
    width = {"train_4k": 4096, "prefill_32k": 32768, "decode_32k": 1}[shape]
    assert rec["batch_bytes_per_rank"] == \
        rows * width * 8 * (2 if shape == "train_4k" else 1)
    if shape == "train_4k":
        assert rec["optimizer"] == "adamw"
        n_local = sum(np.prod(shard.local_shape(p.shape, mesh, specs[n]))
                      for n, p in model.named_parameters())
        assert rec["opt_state_bytes_per_rank"] == 8 * n_local + 8
        # the step: f32 gradient blocks; adamw updates the blocks in
        # place (gathers nothing); the filled parameters are the
        # embedding, the head, the final norm and one period, the
        # vocabulary and the FFN as 'model' blocks
        assert rec["grad_bytes_per_rank"] == 4 * n_local
        assert rec["update_group_bytes_peak"] == 0
        assert rec["filled_param_bytes_peak"] == _fill_reckoning(cfg)
        assert rec["step_bytes_per_rank"] == (
            rec["param_bytes_per_rank"] + rec["opt_state_bytes_per_rank"]
            + rec["grad_bytes_per_rank"] + rec["filled_param_bytes_peak"])
        assert rec["split"] == {"query_heads": {"min": 1, "max": 1,
                                                "rank_0": 1},
                                "kv_heads": {"min": 1, "max": 1,
                                             "rank_0": 1},
                                "mamba_channels": None}


@pytest.mark.parametrize("arch", MOE_TRAIN)
def test_dryrun_train_fills_model_blocks(cells, arch):
    """The experts' and the vocabulary's cells: nothing gathered for the
    update, the fill of 'model' blocks as reckoned, the step's bytes."""
    rec = cells[arch]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["optimizer"] == MOE_TRAIN[arch]
    assert rec["update_group_bytes_peak"] == 0
    assert rec["filled_param_bytes_peak"] == _fill_reckoning(
        get(arch).config())
    assert rec["step_bytes_per_rank"] == (
        rec["param_bytes_per_rank"] + rec["opt_state_bytes_per_rank"]
        + rec["grad_bytes_per_rank"] + rec["filled_param_bytes_peak"])
    cfg = get(arch).config()
    H = cfg.n_heads
    sizes = [(r + 1) * H // N_MODEL - r * H // N_MODEL
             for r in range(N_MODEL)]
    assert rec["split"]["query_heads"] == {
        "min": min(sizes), "max": max(sizes), "rank_0": _rank0_heads(cfg)[0]}
    assert rec["split"]["kv_heads"] == {"min": 1, "max": 1, "rank_0": 1}
    if arch.startswith("llama4"):    # 40 heads: 2 or 3 a rank
        assert (min(sizes), max(sizes)) == (2, 3)
        assert rec["filled_param_bytes_peak"] <= 2.5e9
        assert rec["step_bytes_per_rank"] <= 15e9
        assert rec["flops_per_rank"] <= 0.8e15
    assert rec["collectives"]["bytes"]["c10d.alltoall_base_"] > 0


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_dryrun_flops_against_model_flops(cells, shape):
    rec = cells[shape]
    cfg = get(ARCH).config()
    counts = cfg.param_counts()
    N = counts["active"] - counts["embed"]
    head = counts["head"]
    S = 4096 if shape == "train_4k" else 32768
    attn = 4 * cfg.n_layers * S * cfg.q_dim           # a token, forward
    ratio = rec["flops_per_rank"] / rec["model_flops_per_rank"]
    # every cell: the FFN, head and attention on rank 0's blocks
    Hq, Hkv = _rank0_heads(cfg)
    d, L = cfg.d_model, cfg.n_layers
    dropped = ((3 * d * cfg.d_ff * L + head) * 15 / 16
               + 2 * d * cfg.q_dim * L * (1 - Hq / cfg.n_heads)
               + 2 * d * cfg.kv_dim * L * (1 - Hkv / cfg.n_kv_heads))
    ratio *= N / (N - dropped)
    N, head, attn = N - dropped, head / 16, attn * Hq / cfg.n_heads
    if shape == "train_4k":
        lo, hi = (8 * N - 2 * head) / (6 * N), 4 / 3 + 4 * attn / (6 * N)
        assert rec["flops_per_rank"] <= 1.0e14
    elif shape == "prefill_32k":
        lo, hi = (N - head) / N, 1 + attn / (2 * N)
    else:
        lo, hi = 1.0, 1 + attn / (2 * N)
    assert lo <= ratio <= hi, (shape, lo, ratio, hi)


def test_dryrun_cli_writes_records(tmp_path):
    assert dryrun.main(["--arch", ARCH, "--shape", "long_500k", "--mesh",
                        "both", "--out", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == [f"{ARCH}__long_500k__multipod.json",
                     f"{ARCH}__long_500k__single.json"]


@pytest.mark.parametrize("arch", all_ids())
def test_card_equals_reference(arch):
    ref = ref_get(arch).card()
    mod = get(arch)
    got = make_card(mod.NAME, mod.config(), peak_flops=197e12,
                    hbm_bw=819e9)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    card = mod.card()                     # the H100's constants
    na = card.active_params_b
    assert card.decode_tps == HBM_BW / max(2e9 * na, 1e6)
    assert card.prefill_tps == PEAK_FLOPS_BF16 / max(2e9 * na, 1e6)


def test_policy_shim_exports_the_reference_names():
    for name in ref_policy.__all__:
        assert hasattr(policy, name), name
        assert name in policy.__all__
        ref, got = getattr(ref_policy, name), getattr(policy, name)
        if isinstance(ref, (np.ndarray, int, float, tuple)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert policy.decide_pair_jnp is policy.decide_pair_torch
    assert policy.decide_pair_slo_jnp is policy.decide_pair_slo_torch
    assert policy.decide_pair_affinity_jnp is \
        policy.decide_pair_affinity_torch
    g = np.arange(6, dtype=np.float32)
    assert policy.Thresholds.from_genome(g).q == 3.0
