#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and runs
the port's paths on the card, the routing loop, the serving engine and its
prefix reuse on session traffic, the runtime router's rolling-horizon
re-fit on open-loop SLO traffic, the whole policy registry on the policy
matrix, the cluster server end to end, every non-dense model family in the
serving engine, training, and the mesh tail on a world of one, in phases
that each print one JSON line (run in the order 1-5, 9, 13, 14, 6, 10, 7,
8, 11, 12, 15, 16, 17, 18):

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time;
2. kernels: the dominance kernel against its plain PyTorch version on the
   card (exact) over P in {1, 7, 15, 16, 17, 32, 64, 100, 130, 200, 1000,
   4096, 4099, 4104}, M in {1, 2, 3, 4, 8, 9, 32, 33, 64}, f32/bf16/f16 and
   f32 with +-inf, NaN, signed zeros, subnormals and +-3.4e38; by the
   profiled names, M 3 runs the register kernel
   (``dominance_matrix_kernel<3>``), M 9 the shared-memory one (``<0>``)
   and M 33 the chunked one (``dominance_matrix_chunked_kernel``, 32
   objectives at a time); its time at P = 200, 4096 and 4104 beside the
   plain version's and the card's bound, and the shared-memory and chunked
   variants' at P = 4096, M 9, 32, 33, 64;
3. main path: ``repro_torch.quickstart.run_quickstart()`` at full size (500
   requests, pop 100, 60 generations); the dominance kernel must launch
   exactly 61 times (init + 60 generations), the attention kernels never;
   then one population evaluation is profiled (host wall time against the
   card's busy time);
4. device against CPU: the same evaluator on the card and on the CPU must
   route every request identically;
5. large population: a direct-assignment NSGA-II at a combined population
   of 4096 over the same trace, kernel on;
6. attention kernels: the decode and flash kernels against their plain
   versions on the card, f32 (2e-5) and bf16 (2e-2), over ragged shapes,
   kv_len 0 (zeros) and past Smax, the cache past kv_len filled with
   +-999 and NaN (output unchanged); bf16 flash must run the tensor-core
   kernel and f32 flash the CUDA-core one (by the profiled kernel names),
   decode must split every (b, kv head) over several blocks at Smax 512
   and 1,088, and unaligned inputs must raise; then each timed at the
   serving shapes (flash at S 64, 128 and 512) beside its plain version,
   SDPA and its bound;
7. serve: ``repro_torch.serve.run_serve`` answers the trace's first 32
   requests with qwen3-1.7b at its published width and depth (28 layers,
   random weights from a seed) on 8 slots of 512 positions, in chunks of 8
   decode iterations; the decode kernel must launch 28 times per decode
   iteration, the flash kernel 28 times per admission, the dominance
   kernel never; then one decode iteration is profiled (the card's idle
   share, its top device ops and host ops);
8. serve check: every served token is a teacher-forced maximum of
   ``train_logits`` on the card (within 2e-2 of the row's max|logit|), and
   the same engine at full width and 2 layers gives the CPU's greedy
   tokens, except at the CPU's own near-ties;
9. counts kernel: the dominator-counts kernel exactly equal to its plain
   version and to the column sums of the matrix kernel, over P in {1, 63,
   64, 65, 200, 4096, 4099}, M 1-9 and 33, f32/bf16/f16, ties, duplicates
   and NaN rows, and on every objective matrix that phases 3 and 5 sorted;
   two calls equal, P 4096 then 200 then 4096 again exact, a call on a
   second stream exact; one device operation a call (the profiled names
   and events a call);
   timed at P = 200 and 4096 with its share of the bound;
10. paged kernel: the paged decode kernel against its plain version (2e-5
   f32, 2e-2 bf16) and bit for bit equal to the decode kernel on the
   gathered cache (the same split kernel with other row addresses), in
   the TPU pool layout and the serving store's, block sizes 8 and 16, pad
   entries, negative ids, kv_len 0, NaN in unreferenced blocks (output bit
   for bit unchanged); unaligned pools must raise;
11. serve sessions: the 47 requests of the multi-turn session trace with
   the same model on 8 slots of 1,088 positions, with the paged prefix
   cache (16-token blocks) and without, in turns (on, off, off, on);
   in every run flash launches = 28 per admission, decode launches = 28
   per iteration, paged and counts kernels never; the cache counters, zero leaked blocks, every token a
   teacher-forced maximum, the two runs' tokens parting only at near-ties;
   one decode iteration profiled; the decode kernel timed at that
   iteration's cache fills (Smax 1,088) and the flash kernel's
   prefix-extend variant at the run's median admission;
12. paged on pools: block tables from the served prompts' cached blocks,
   8 rows a batch, the paged kernel held on all 28 layers of the store's
   pools bit for bit against the decode kernel on the gathered cache and
   against the plain version (one row ending mid-block), and timed there
   beside the decode kernel on the gathered cache; by the profiled trace,
   a paged call launches splits x Hkv x B blocks of the split kernel;
13. online: ``repro_torch.online.run_online()`` at the reference's sizes
   (the mix-shift and burst scenarios, 4 open-loop windows of 60 requests
   with SLO deadlines, pop 16 x 10 generations for window 0's tuning and
   every re-fit, QoE objectives); the dominance kernel must launch 11 times
   per evolve (5 a scenario) and run ``dominance_matrix_kernel<4>`` (by
   the profiled name); in every window the card's assignments under the
   static, adaptive and cloud-only policies equal the CPU's exactly, the
   objectives agree within 1e-5, and the re-fit's evaluator padded to 64
   rows gives the 60-row one's rows bit for bit; then one
   ``RequestRouter.maybe_reoptimize`` at the router's defaults (window 256,
   pop 32, 20 generations: 21 launches) on 256 recorded requests of the
   burst phase, one population evaluation of its 256-row table profiled,
   and the kernel timed at the re-fit's P = 32 and 64, M = 4; last, every
   objective matrix that these sorts saw (131) goes through the matrix and
   counts kernels again, each exactly equal to its plain version;
14. policy matrix: ``repro_torch.policy_matrix.run()`` at the reference's
   full size (192 session requests with SLO deadlines, the prefix cache
   on, pop 16 x 12 generations a policy, QoE objectives): a tuned row for
   every registered policy; the dominance kernel must launch 13 times a
   fit (117 for the nine policies) and run ``dominance_matrix_kernel<4>``;
   every row's genome, replayed on the card in the three configurations
   of its decision space (clean, straggler on static priors, straggler
   with the learned estimators), equals a CPU evaluator's assignments
   exactly, with rows and QoE objectives within 1e-6; one population
   evaluation profiled per configuration (six); ``route()`` timed for
   every runtime policy, static and learned; the learned ``affinity`` and
   ``disagg`` routers driven over the trace with ``record(ttft=, tpot=)``
   (decisions and estimator state equal to a CPU router's), then one
   ``maybe_reoptimize`` each at the router's defaults (21 launches each);
   last, both dominance kernels exactly equal to their plain versions on
   all 159 matrices those sorts saw;
15. cluster: the serving launcher (``repro_torch.launch.serve.run_launch``)
   at the published widths, stablelm-3b for the cloud pair and one
   qwen3-1.7b shared by the 9 edge pairs (2 cohorts: 1 and 9 members),
   random bf16 weights from seeds 0 and 1, engines of 8 slots x 128
   positions. Run A: NSGA-II tunes the thresholds (pop 48 x 30 generations
   on the 64-request trace), then the trace's 64 requests are served in
   ticks of 8 decode iterations, node 1 failing after the 6th submission
   (the tuned router sends every request to the cloud, so node 1 holds no
   flight then and only hedges reach the edge). Run B: the same with the
   paper's default thresholds, under which node 1 holds live flights when
   it fails; at least one is cancelled and re-routed. Asserted for each:
   every request done with its budget of tokens; each node's dispatches
   closed as completed, failed or cancelled, queues drained; no block
   leaked (vacuous: these engines keep no prefix cache); an engine's own
   tokens (its count less its cohort's) only from decodes of its own;
   node 1 the only node down, no request served there, its failures equal
   to the reroutes; every token a teacher-forced maximum; launches exactly
   31 dominance in A (1 + generations) and none in B, flash n_layers per
   admission, decode n_layers per cohort iteration (one launch a layer for
   all of a cohort's rows) plus per engine-own iteration, paged and counts
   never. Then a saturated tick (every slot busy) timed fleet against the
   per-engine loop in turns, the two servers' tokens compared slot by slot
   (parting only at near-ties, reported), one fleet tick profiled (the
   card's idle share), the decode kernel timed at the cohort's 72 rows and
   the cloud's 8 beside SDPA and the bound; last the launcher's run at
   full width and 2 layers a model, fleet on and off, under the tuned and
   the default thresholds: the same routing decisions (audit records),
   QoE records and token counts, node 1 the only node down, tokens parting
   only at near-ties (counted and reported);
16. families: each non-dense family at its published widths through
   ``LLMEngine`` (8 slots x 256 positions, the trace's first 8 requests,
   16 tokens each, decode chunks of 8), one model at a time from random
   bf16 weights, depth cut only where the weights would not fit:
   jamba-v0.1-52b 8 of 32 layers (one period: 1 attention + 7 Mamba, MoE
   on 4), dbrx-132b 4 of 40, llama4-maverick-400b-a17b 2 of 48 (one
   period: MoE then dense), xlstm-1.3b, llama-3.2-vision-11b (1,600 patch
   tokens) and whisper-tiny (its encoder over 1,504 frames) whole; frames
   and patches seeded, through ``submit(extra=)``. For each: the built
   parameters equal ``param_counts()`` plus what it leaves out
   (``uncounted_params``); launches exactly flash = (self-attention +
   encoder layers) x admissions, decode = self-attention layers x decode
   iterations (xLSTM neither); every token a near-tie maximum of its
   request replayed alone (prefill, then decode) and of the full forward
   (for MoE, requests whose passes drop an assignment held against the
   replay only, and a token off a near tie accepted only after a reported
   routing parting); prefill-then-decode logits within 5e-2 of max|logit|
   of the full forward's; xLSTM, whose random-weight recurrences turn
   bf16 rounding into diverging tokens, reported in bf16 and held in f32;
   tokens/s, ms an admission and a decode iteration, one profiled
   iteration, peak memory, and for xLSTM the sLSTM layers' share of an
   admission. Then, in a fresh process (whose profiler has recorded
   nothing yet), flash and decode against their plain versions at groups
   5 and 6 (hd 128) and whisper's 6 heads of 64 (flash non-causal at S
   1,500 and 1,504), timed beside SDPA and their bounds.

17. train: the flash backward kernels (``csrc/flash_attention_bwd.cu``)
   against autograd of the plain version, f32 within 1e-4 and bf16 within
   2e-2 of each gradient's max|g| (exactly 0 where that is 0), over the
   training heads (B 4, 16 / 8 heads of 128), D 64 / 80 / 128, groups 1,
   2, 4, 5, 6, S in {1, 17, 64, 127, 128, 129, 512}, causal and not, and
   whisper's non-causal S 1,504 at D 64; the forward's lse against the
   plain log-sum-exp and its output bits unchanged by writing it; inputs
   past S of +-999 and NaN leaving every gradient bit for bit unchanged;
   two calls bit-equal; bf16 on the tensor-core kernels
   (``flash_bwd_dq_wgmma<128>``, ``flash_bwd_dkdv_wgmma<128>``) and f32
   on the CUDA-core ones, by their profiled names
   (``flash_attention.backward_route``); unaligned bf16 views refused.
   Then qwen3-1.7b at
   its published widths (2.03 B parameters, random bf16 weights from a
   seed) trains through ``repro_torch.launch.train.run_train`` for 4 steps
   at TrainConfig's defaults (seq 128, global batch 8) in 2 microbatches,
   adamw, remat: finite loss, nll and gnorm each step, launches held exact
   for each step (flash forward 28 layers x 2 microbatches x 2, the
   forward and the remat recompute; backward 28 x 2 x its 2 kernels),
   decode, paged and dominance never; step wall time, tokens/s, peak
   memory and step 2 profiled (idle share, top device ops). Then one
   trainer step at the full width and 2 layers in f32 on 2 x 64 tokens on
   the card and on the CPU from the same parameters (loss within 1e-5
   relative; the gradients, through each leaf's moments m = 0.1 g and v =
   0.05 g^2, within 1e-4 of the leaf's max; the card's parameters equal
   to adamw's step from the card's m and v recomputed on the CPU, within
   1e-4 x max|delta p| plus f32's spacing; the card's parameters against
   the CPU's reported: adamw's sign-like first step g / (|g| + eps)
   amplifies last-bit differences of g near eps); crash and resume at 2 layers in bf16 (4 steps straight; 2 steps
   and a checkpoint under build/, restored bit for bit; a fresh trainer
   resumes to step 4 within 1e-3 relative of the straight run's losses;
   bytes, save and restore seconds); last, in a fresh process, the
   backward (with the dq and dk/dv kernels' device times apart) and
   forward + backward timed at the training shape and at B 1, S 1,024
   beside the plain version, SDPA's forward + backward and the bound.
18. mesh: first the flash forward and backward kernels at the heads one
   rank holds when attention splits over a 16-wide 'model' axis ((H_r,
   Hkv_r) = (1, 1), (2, 1), (3, 1); bf16, causal, B 4, S 128, hd 128)
   against their plain versions. Then a world of one on NCCL (a
   ``file://`` rendezvous under build/,
   ``make_host_mesh(model=1)``; no fallback: a failure to init NCCL or
   build the mesh fails the phase), every attention layer a region of one
   rank (its heads, KV heads and qk-norm gradients through the region's
   fills and reductions). ``Trainer(mesh=)`` at qwen3-1.7b's
   published widths cut to 4 of 28 layers (``reduced``: depth, to keep the
   comparison short), 2 steps of TRAIN_RUN's batch under each of adamw,
   adamw8bit and adafactor (updated on the blocks in place), held bit for
   bit against ``Trainer()`` on the same seed, run one after the other:
   loss, nll and gnorm, every parameter and optimizer-state leaf, and the
   flash forward and backward launches (32 + 32); the adamw and adafactor
   checkpoints, saved with the specs, restored onto the mesh bit for bit;
   dbrx-132b at its published widths cut to 1 of 40 layers (its experts,
   vocabulary and region's collectives on one rank), 2 adamw8bit steps of
   seq 128 x batch 8, held alike, with each run's peak memory; then one
   mesh step at full depth (112 + 112 launches, peak memory). ``psum_compressed`` for its three
   methods equal to the local formula; the quickstart evaluator's fitness
   on ``population_mesh()`` bit for bit equal to the unsharded one on 101
   genomes, then a 5-generation NSGA-II run on it (6 dominance launches).
   Then the sharded serve step (``launch.serve_mesh.ShardedServer``) on
   the same world of one: the decode kernel at the local heads a rank of
   a 16-wide 'model' axis holds ((1, 1), (2, 1), (3, 1); bf16, hd 128, B
   8, Smax 4,096, ragged kv_len, over one layer of a stacked cache at
   those KV heads, as a sharded decode reads it) against its plain
   version, and its partial mode there (o within 2e-2 and lse within
   1e-3 of ``ref.gqa_decode_partial``, o rounded to bf16 bit for bit the
   default mode's output, two default calls bit for bit); the
   split-sequence decode on one card: a 16 / 8-head cache cut into 2 and
   4 sequence blocks, the partial mode on each, merged by
   ``tensor_parallel.merge``, against the default mode over the whole
   cache within 2e-2 (rows of kv_len 0, on a block's edge, in one block
   only, past Smax); qwen3-1.7b at its published widths and full depth,
   a prefill of B 4 x S 128 then 16 greedy decode steps, bit for bit
   against ``lm.prefill`` + ``lm.decode_step`` on the same weights
   (logits, tokens, every cache leaf), flash and decode launches equal to
   the plain run's (28 and 28 x 16; the mesh run's decode launches all
   the partial mode's: its cache split over the sequence, its decode
   merged over the ranks' (o, lse)), every ``blocks.i.mixer`` and
   ``blocks.i.ffn`` a region; and dbrx-132b at its published widths cut
   to 1 of 40 layers, the same check with ``BIG_MODEL_B`` at 0, so that
   its serve placements split over 'data' (of size 1) and every step
   fills the weights, a period at a time (the fills counted).

Phase 6 also holds the flash kernel's prefix-extend variant against its
plain version (bucketed and exact-length, garbage and NaN past prefix_len).
Then the ``{"kernels": [...]}`` line (all six kernels) and, last, the
``{"ok": true, ...}`` line. Any failure raises and exits non-zero. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing anything.
"""
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DEC_HEADS = ((16, 8, 128), (32, 32, 80), (8, 1, 64))   # (Hq, Hkv, D)
# 1,088 is the session engine's Smax: 9 splits of 128 positions
DEC_SMAX = (64, 512, 520, 1088)
FA_S = (1, 17, 64, 128, 192, 200, 512)
SERVE_MODEL, SERVE_REQUESTS = "qwen3-1.7b", 32
CHECK_LAYERS, CHECK_REQUESTS = 2, 8
DOM_CASES_P = (1, 7, 15, 16, 17, 32, 64, 100, 130, 200, 1000, 4096, 4099,
               4104)
DOM_CASES_M = (1, 2, 3, 4, 8, 9, 32, 33, 64)
# the split decode kernel's two instantiations, by their profiled names
DECODE_KERNEL = "ContiguousRows"
PAGED_KERNEL = "PagedRows"
COUNT_CASES_P = (1, 63, 64, 65, 200, 4096, 4099)
COUNT_CASES_M = tuple(range(1, 10)) + (33,)
# (B, Hq, Hkv, n_blocks, block_size, max_blocks, D): tests/test_kernels.py's
# shapes, and the serving heads at block sizes 8 and 16
PAGED_CASES = ((1, 8, 8, 16, 16, 4, 64), (2, 8, 2, 24, 16, 4, 64),
               (3, 4, 1, 12, 8, 6, 32), (8, 16, 8, 96, 8, 40, 128),
               (8, 16, 8, 96, 16, 24, 128))
# (S_pre, Sq, prefix_len): prefix_len None is the exact-length extend
EXT_CASES = ((16, 8, None), (200, 1, None), (64, 17, 40), (32, 33, 0),
             (1088, 64, 16), (1088, 64, 512), (1088, 128, 960))
QUICKSTART = dict(n_requests=500, pop_size=100, n_generations=60)
LARGE_POP, LARGE_GENS = 2048, 5
# the router's own re-fit defaults, on a window of the burst phase
REFIT_REQUESTS, REFIT_POP, REFIT_GENS = 256, 32, 20
# the serving launcher's runs: 64 requests, 30 generations of tuning, node 1
# failed after the 6th submission
CLUSTER_REQUESTS, CLUSTER_GENS, CLUSTER_FAIL = 64, 30, (1, 5)
# phase 16: (model, layers built) at the published widths; depth is cut
# only where the weights would not fit the card beside the run
FAMILIES = (("jamba-v0.1-52b", 8), ("dbrx-132b", 4),
            ("llama4-maverick-400b-a17b", 2), ("xlstm-1.3b", 48),
            ("llama-3.2-vision-11b", 40), ("whisper-tiny", 4))
FAMILY_ENGINE = dict(max_slots=8, max_seq=256, max_new_tokens=16,
                     prefill_bucket=64)
FAMILY_REQUESTS, FAMILY_BUDGET, FAMILY_CHUNK = 8, 16, 8
# served in bf16 and checked in f32 as well: random-weight xLSTM amplifies
# bf16 rounding from layer to layer into diverging tokens (the reference's
# own prefill-then-decode parts from its full forward the same way)
FAMILY_F32_CHECK = ("xlstm-1.3b",)
# (Hq, Hkv, D, S, causal): llama4's group 5, dbrx's 6, whisper's encoder
# (non-causal over 1,504 frames) and decoder
FAMILY_FLASH = ((40, 8, 128, 64, True), (40, 8, 128, 131, True),
                (48, 8, 128, 64, True), (48, 8, 128, 200, True),
                (6, 6, 64, 1504, False), (6, 6, 64, 1500, False),
                (6, 6, 64, 97, True))
FAMILY_DECODE_HEADS = ((40, 8, 128), (48, 8, 128), (6, 6, 64))
# phase 17: qwen3-1.7b trained at TrainConfig's defaults (seq 128, global
# batch 8) in 2 microbatches, adamw, remat, 4 steps; step 2 profiled
TRAIN_MODEL = "qwen3-1.7b"
TRAIN_RUN = dict(seq_len=128, global_batch=8, microbatches=2, steps=4)
TRAIN_PROFILED_STEP = 2
# phase 18: the sharded trainer on a world of one, qwen3-1.7b cut to 4 of 28
# layers for the bit-for-bit comparison under each optimizer (then one
# adamw step at full depth)
MESH_LAYERS = 4
MESH_TRAIN = dict(seq_len=128, global_batch=8, microbatches=2, steps=2,
                  optimizer="adamw", log_every=1)
MESH_OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
MESH_CHECKPOINTED = ("adamw", "adafactor")  # saved, restored onto the mesh
# and the experts and vocabulary split over 'model': dbrx-132b at its
# published widths cut to 1 of 40 layers, under adamw8bit
# (optimizer_for_arch's choice for the whole model)
MESH_MOE_MODEL = "dbrx-132b"
MESH_MOE_LAYERS = 1
MESH_MOE_TRAIN = dict(seq_len=128, global_batch=8, microbatches=1, steps=2,
                      optimizer="adamw8bit", log_every=1)
MESH_FITNESS = dict(pop_size=100, n_generations=5)
# the flash kernels at the heads one rank holds when attention splits over
# a 16-wide 'model' axis, (H_r, Hkv_r): qwen3-1.7b's (1, 1); 2 heads on one
# KV head (qwen3-4b, stablelm-12b, jamba, the vision model, llama4's
# smaller share); dbrx-132b's and llama4's larger share (3, 1); bf16,
# causal, at this (B, S, D)
MESH_LOCAL_HEADS = ((1, 1), (2, 1), (3, 1))
MESH_LOCAL_SHAPE = (4, 128, 128)
# the decode kernel at those local heads, over layer 1 of a 2-layer stacked
# (layers, B, Smax, H_r, hd) bf16 cache, B rows of ragged kv_len
MESH_DECODE_SHAPE = (8, 4096, 128)
MESH_DECODE_LENS = (4096, 1, 1000, 4095, 17, 2048, 3333, 512)
# the partial mode's lse against the plain log-sum-exp
MESH_LSE_TOL = 1e-3
# the split-and-merge check's kv_len over MESH_DECODE_SHAPE's cache cut in
# 2 and 4 blocks: empty, on the edges 1,024 / 2,048 / 3,072, in the first
# block only (17, 1,000), across an edge (2,049) and past Smax (5,000)
MESH_SPLIT_LENS = (0, 1024, 2048, 3072, 17, 5000, 1000, 2049)
# the sharded serve step on the world of one: a prefill of B x S prompt
# tokens, then greedy decode steps, for qwen3-1.7b whole and dbrx-132b at
# MESH_MOE_LAYERS layers with its per-period fills forced
MESH_SERVE = dict(rows=4, prompt=128, steps=16)
# the same against the cache leaves that cache_specs splits beyond the self
# K/V, at published widths: the cross K/V of llama-3.2-vision-11b (1 of 8
# periods: 5 of 40 layers; 1,600 patch tokens) and whisper-tiny (whole;
# 1,504 frames through its 4 encoder layers), and xLSTM's states
# (xlstm-1.3b at 1 of 6 periods: 8 of 48 layers); (model, layers or None)
MESH_SERVE_STATE = (("llama-3.2-vision-11b", 5), ("whisper-tiny", None),
                    ("xlstm-1.3b", 8))
# the backward kernel against its plain version: gradients within this
# times max|g| of each of dq, dk, dv
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_S = (1, 17, 64, 127, 128, 129, 512)
# the backward's kernels by route (flash_attention.backward_route)
BWD_KERNEL_NAMES = {"wgmma": ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma"),
                    "cuda_cores": ("flash_bwd_dq_kernel",
                                   "flash_bwd_dkdv_kernel")}
# (B, Hq, Hkv, D): the training heads; D 64 / 80 / 128 at group 2; groups
# 1, 2, 4, 5, 6 at D 128
BWD_HEADS = ((4, 16, 8, 128),) + tuple((1, 4, 2, d) for d in (64, 80)) + \
    tuple((1, 2 * g, 2, 128) for g in (1, 2, 4, 5, 6))


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, *args, iters=50, reps=7):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn(*args)
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def _device_events(fn, *args, iters=20):
    """(name, µs) of every device kernel that ``iters`` calls of ``fn`` run
    after a warm-up call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
            if ev.device_type.name == "CUDA"]


def _profiled(events, attempts):
    """The first non-empty result of ``events()`` over ``attempts`` windows
    (the profiler now and then records no device activity for a window),
    or []. No pause between them: once this process's profiler has stopped
    recording, waiting did not bring it back."""
    for _ in range(attempts):
        out = events()
        if out:
            return out
    return []


def device_kernel_ms(fn, *args, name="dominance_matrix", iters=20,
                     attempts=3):
    """Median device time of the named kernel from torch.profiler, or None
    when no profiled window records it."""
    us = _profiled(lambda: [t for n, t in _device_events(fn, *args,
                                                         iters=iters)
                            if name in n], attempts)
    return statistics.median(us) / 1e3 if us else None


def device_total_ms(fn, *args, iters=20, attempts=3):
    """Device time of one call of ``fn``, all its kernels together (the
    mean over ``iters`` calls), or None when no profiled window records
    device activity."""
    us = _profiled(lambda: [t for _, t in _device_events(fn, *args,
                                                         iters=iters)],
                   attempts)
    return sum(us) / iters / 1e3 if us else None


def device_kernel_names(fn, *args, iters=5, attempts=3, fresh=True,
                        events=False):
    """The names of the device kernels that calls of ``fn`` run (an empty
    window is profiled again; with ``fresh``, when every window is empty,
    in a new process: ``in_fresh_process``). With ``events``, (names, the
    device operations that the ``iters`` calls recorded, memsets and copies
    included): the profiler may drop a few events of a window, never add
    one."""
    evs = _profiled(lambda: _device_events(fn, *args, iters=iters),
                    attempts)
    if not evs and fresh:
        return _fresh(fn, args, "device_kernel_names", iters=iters,
                      events=events)
    names = sorted({n for n, _ in evs})
    return (names, len(evs)) if events else names


def _idle(busy, wall):
    """The card's idle share of a host wall time, or None where the
    profiler recorded no device activity (not measured)."""
    return None if busy is None else 1 - busy / wall


def device_kernel_grids(fn, *args, name, iters=3, attempts=8,
                        fresh=True):
    """(grids, windows): the grids (blocks along x, y, z) of the device
    kernels whose name holds ``name`` over ``iters`` calls of ``fn``, from
    the profiler's Chrome trace (written under build/, read and removed),
    and, for each profiled window, the trace's kernel events and the
    profiler's own device events (``prof.events()``) whose name holds
    ``name``. A window whose trace holds no such kernel is profiled again
    after a pause that doubles from 0.5 s to 4 s, up to ``attempts`` times
    (the profiler now and then records nothing for a window, and once for
    eight windows 0.5 s apart); the windows are reported so that a
    recurring dropout, or a kernel that really goes missing, shows (and
    which of the two records lost it). With ``fresh``, when no window has
    the kernel, the same calls are profiled in a new process
    (``in_fresh_process``), reported as one more window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(exist_ok=True)
    fn(*args)
    torch.cuda.synchronize()
    windows = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        kernels = [e for e in events if e.get("cat") == "kernel"]
        grids = [tuple(e["args"]["grid"]) for e in kernels
                 if name in e.get("name", "") and "grid" in e.get("args", {})]
        windows.append({"trace_kernels": len(kernels),
                        "trace_named": len(grids),
                        "profiler_named": sum(
                            1 for ev in prof.events()
                            if ev.device_type.name == "CUDA"
                            and name in ev.name)})
        if grids:
            return grids, windows
        time.sleep(min(0.5 * 2 ** (len(windows) - 1), 4.0))
    if not fresh:
        return [], windows
    grids, inner = _fresh(fn, args, "device_kernel_grids", name=name,
                          iters=iters)
    return [tuple(g) for g in grids], windows + [{"fresh_process": inner}]


def in_fresh_process(call, setup=""):
    """Evaluate ``call`` (an expression over this module, ``chip_smoke``,
    after the statements ``setup``) in a new process and return its JSON
    result. The new process loads the kernels this one built and profiles
    with its own CUPTI state: late in a long run this process's profiler
    drops windows, or records nothing at all (every window of phase 12 in
    two runs, with the earlier phases' device times already missing)."""
    root = Path(__file__).resolve().parent
    code = (f"import json, sys\nsys.path[:0] = [{str(root)!r}, "
            f"{str(root / 'src')!r}]\nimport torch, chip_smoke\n{setup}\n"
            f"print(json.dumps({call}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _fresh(fn, args, helper, **kw):
    """``helper(fn, *args, fresh=False, **kw)`` of this module run by
    ``in_fresh_process`` on copies of ``args`` (tensors keep their
    strides; saved under build/)."""
    import torch
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_args.pt"
    torch.save([a.clone() if torch.is_tensor(a) else a for a in args], path)
    try:
        return in_fresh_process(
            f"chip_smoke.{helper}(fn, *args, fresh=False, **{kw!r})",
            f"from {fn.__module__} import {fn.__name__} as fn\n"
            f"args = torch.load({str(path)!r})")
    finally:
        path.unlink(missing_ok=True)


def dominance_bound_ms(P, M):
    """Least time for the function: F read once (P*M*4 bytes), D written
    once (P*P bytes), 2*P*P*M f32 comparisons."""
    return 1e3 * max((P * M * 4 + P * P) / HBM_BYTES_PER_S,
                     2 * P * P * M / F32_OPS_PER_S)


def uncounted_params(cfg):
    """Parameters a built model holds beyond ``cfg.param_counts()["total"]``
    (the reference's arithmetic, copied): it leaves out the final norm,
    LayerNorm biases, the third norm of a cross block (and counts two norms
    where a block without FFN has one), the Mamba Δt path, ``A_log``, ``D``
    and conv bias, the mLSTM's and sLSTM's own norms, the sLSTM's
    recurrent matrices and the encoder's positions and final LayerNorm,
    and it counts a GELU MLP as a SwiGLU one."""
    d = cfg.d_model
    nd = 2 * d if cfg.norm == "layernorm" else d      # one norm's params
    mlp = -d * cfg.d_ff if cfg.activation == "gelu" else 0
    gap = nd                                          # the final norm
    for li in range(cfg.n_layers):
        mixer, ffn = cfg.block_at(li)
        norms = 1 + (mixer == "attn_cross") + (ffn != "none")
        gap += norms * nd - 2 * d + (mlp if ffn == "dense" else 0)
        if mixer == "mamba":
            di = cfg.ssm.expand * d
            gap += di * (2 * max(1, d // 16) + cfg.ssm.d_state + 1)
        elif mixer == "mlstm":
            gap += int(cfg.xlstm.proj_factor_m * d)
        elif mixer == "slstm":
            gap += 4 * d * (d // cfg.n_kv_heads) + d
    if cfg.encoder is not None:
        gap += cfg.encoder.n_frames * d + 2 * d       # positions, LayerNorm
        gap += cfg.encoder.n_layers * (2 * nd - 2 * d + mlp)
    return gap


def phase_card():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": _build.BUILD_SECONDS, "kernel_load_s": load_s})
    return smi


def _dominance_input(P, M, dtype, gen):
    import torch
    F = torch.round(torch.rand((P, M), generator=gen) * 8) / 8   # ties
    if P > 3:
        F[P // 2] = F[0]                  # a duplicated row
        F[P - 1, M - 1] = float("nan")    # a NaN row
    return F.to(dtype).cuda()


def _dominance_special(P, M, gen):
    """f32 objectives where the kernel's subtraction path could go wrong
    and where it must step aside: +-inf, NaN, signed zeros, subnormals and
    the largest finite values (their differences overflow)."""
    import torch
    F = torch.round(torch.rand((P, M), generator=gen) * 8) / 8 - 0.5
    big = torch.finfo(torch.float32).max
    edge = [float("inf"), float("-inf"), float("nan"), -0.0, 0.0, 1e-45,
            -1e-45, big, -big]
    for r in range(min(P, 3 * len(edge))):
        F[r, r % M] = edge[r % len(edge)]
    if P > 1:
        F[P - 1] = F[0]
    return F.cuda()


def phase_kernels():
    import torch
    from repro_torch.kernels import dominance, ops, ref
    gen = torch.Generator().manual_seed(0)
    n_cases = n_exact = 0
    max_err = 0
    for P in DOM_CASES_P:
        for M in DOM_CASES_M:
            for dtype in (torch.float32, torch.bfloat16, torch.float16,
                          "special"):
                F = (_dominance_special(P, M, gen) if dtype == "special"
                     else _dominance_input(P, M, dtype, gen))
                got = ops.dominance_matrix(F)
                torch.cuda.synchronize()
                want = ref.dominance_matrix(F)
                assert got.dtype == torch.bool and got.shape == (P, P)
                err = int((got.to(torch.int8) - want.to(torch.int8)).abs()
                          .max())
                max_err = max(max_err, err)
                n_cases += 1
                n_exact += bool(torch.equal(got, want))
    assert n_exact == n_cases, f"kernel != plain in {n_cases - n_exact} cases"
    # M <= 8 keeps the column objectives in registers (a kernel per M), M
    # up to 32 in shared memory (<0>), a larger M 32 objectives at a time
    names = {}
    for M, want in ((3, "dominance_matrix_kernel<3>"),
                    (9, "dominance_matrix_kernel<0>"),
                    (33, "dominance_matrix_chunked_kernel")):
        F = torch.rand((4096, M), device="cuda")
        got = {_kernel_name(n) for n in device_kernel_names(
            ops.dominance_matrix, F) if "dominance_matrix" in n}
        assert got == {want}, (M, got)
        names[f"M{M}"] = want
    timing = {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for P in (200, 4096, 4104):
        F = torch.rand((P, 3), device="cuda")
        timing[P] = dict(
            ms=time_ms(ops.dominance_matrix, F),
            plain_ms=time_ms(ref.dominance_matrix, F),
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(P, 3),
            grid=list(dominance.dominance_grid(P, n_sm)))
    # at P = 4096 the shared-memory variant (M 9, 32) and the chunked one
    # (two chunks of objectives: M 33, 64)
    any_m = {}
    for M in (9, 32, 33, 64):
        F = torch.rand((4096, M), device="cuda")
        ops_bound = (2 * 4096 * 4096 * M / F32_OPS_PER_S * 1e3
                     >= dominance_bound_ms(4096, M))
        any_m[f"m{M}"] = dict(
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(4096, M),
            bound_by="operations" if ops_bound else "bytes")
    row = {"phase": "kernels", "name": "dominance_matrix", "cases": n_cases,
           "exact": n_exact == n_cases, "max_abs_err": max_err,
           "kernel_names": names,
           "timing": {str(P): t for P, t in timing.items()},
           "timing_p4096_shared": any_m}
    emit(row)
    return row


def zero_launches():
    from repro_torch.kernels import (decode_attention, dominance,
                                     flash_attention, paged_attention)
    dominance.LAUNCHES = dominance.COUNTS_LAUNCHES = 0
    flash_attention.LAUNCHES = decode_attention.LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = paged_attention.LAUNCHES = 0
    decode_attention.PARTIAL_LAUNCHES = 0


def launch_counts(**expected):
    """Every kernel's launch count since ``zero_launches``; a kernel not
    named in ``expected`` must not have launched. The decode kernel's
    partial mode counts among its launches and alone as well."""
    from repro_torch.kernels import (decode_attention, dominance,
                                     flash_attention, paged_attention)
    got = {"dominance_matrix": dominance.LAUNCHES,
           "dominance_counts": dominance.COUNTS_LAUNCHES,
           "flash_attention": flash_attention.LAUNCHES,
           "flash_attention_backward": flash_attention.BWD_LAUNCHES,
           "gqa_decode_attention": decode_attention.LAUNCHES,
           "gqa_decode_partial": decode_attention.PARTIAL_LAUNCHES,
           "paged_gqa_decode_attention": paged_attention.LAUNCHES}
    want = {k: expected.get(k, 0) for k in got}
    assert got == want, f"launches {got}, want {want}"
    return got


class SortedObjectives:
    """Keeps a copy of every objective matrix the NSGA-II sort hands to the
    dominance kernel while it is entered (the counts phase holds the counts
    kernel on them); the sort itself runs unchanged."""

    def __init__(self):
        self.Fs = []

    def __enter__(self):
        from repro_torch.core import pareto
        self._orig = orig = pareto.dominance_matrix

        def record(F):
            self.Fs.append(F.detach().clone())
            return orig(F)

        pareto.dominance_matrix = record
        return self

    def __exit__(self, *exc):
        from repro_torch.core import pareto
        pareto.dominance_matrix = self._orig


def phase_main_path(sorted_F):
    import numpy as np
    from repro_torch.quickstart import format_table, run_quickstart
    zero_launches()
    t0 = time.perf_counter()
    with sorted_F:
        res = run_quickstart(**QUICKSTART)
    wall = time.perf_counter() - t0
    launches = launch_counts(
        dominance_matrix=1 + QUICKSTART["n_generations"])["dominance_matrix"]
    F = res.state.F_raw.cpu().numpy()
    assert F.shape == (QUICKSTART["pop_size"], 3) and np.isfinite(F).all()
    for r in res.rows.values():
        assert all(math.isfinite(v) for v in r.values()), r
    assert int(res.state.rank[res.index]) == 0
    assert float(res.state.violation[res.index]) <= 0
    print(format_table(res), flush=True)
    emit({"phase": "main_path", "launches": {"dominance_matrix": launches},
          "evolve_s": res.evolve_s, "wall_s": wall, "rows": res.rows,
          "overall": res.overall, "genome": res.genome})
    return res, launches


def profile_fitness(fit, genomes, n_requests):
    """Host wall time of one population evaluation against the card's busy
    time in it (torch.profiler), its device events and top device ops."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    fit(genomes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(genomes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fit(genomes)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    n_events = 0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            n_events += 1
    busy = sum(by_name.values()) / 1e6 if n_events else None
    return {"what": f"one fitness call, pop {genomes.shape[0]} x "
            f"{n_requests} requests", "wall_s": wall, "device_busy_s": busy,
            "idle_share": _idle(busy, wall), "device_events": n_events,
            "us_per_request_step": wall / n_requests * 1e6,
            "top_device_us": by_name.most_common(6)}


def phase_profile(genomes):
    """Where one population evaluation of the main path spends its time:
    host wall time against the card's busy time (torch.profiler)."""
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.workload.trace import build_trace
    ev = TraceEvaluator(build_trace(500, seed=0), paper_testbed(),
                        EvalConfig(concurrency=1), device="cuda")
    emit({"phase": "profile",
          **profile_fitness(ev.make_fitness("threshold"), genomes, 500)})


def phase_device_vs_cpu(genome):
    import torch
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.policies.threshold import BOUNDS_HI, BOUNDS_LO
    from repro_torch.workload.trace import build_trace
    trace, cluster = build_trace(500, seed=0), paper_testbed()
    g = torch.Generator().manual_seed(1)
    lo, hi = torch.from_numpy(BOUNDS_LO), torch.from_numpy(BOUNDS_HI)
    G = torch.cat([torch.as_tensor(genome)[None],
                   lo + torch.rand((32, 6), generator=g) * (hi - lo)])
    out = {"phase": "device_vs_cpu", "genomes": int(G.shape[0])}
    for conc in (1, 4):
        cfg = EvalConfig(concurrency=conc)
        dev = TraceEvaluator(trace, cluster, cfg, device="cuda")
        cpu = TraceEvaluator(trace, cluster, cfg, device="cpu")
        a = dev.run_population("threshold", G)
        b = cpu.run_population("threshold", G)
        mism = int((a.assign.cpu() != b.assign).sum())
        rel = 0.0
        for f in ("q", "cost", "rt", "ttft", "tpot"):
            x, y = getattr(a, f).cpu(), getattr(b, f)
            assert torch.allclose(x, y, rtol=1e-5, atol=1e-6), f
            rel = max(rel, float(((x - y).abs() / y.abs().clamp(min=1e-12))
                                 .max()))
        assert mism == 0, f"{mism} assignment mismatches at concurrency {conc}"
        out[f"concurrency_{conc}"] = {"assign_mismatches": mism,
                                      "max_rel_err": rel}
    emit(out)


def phase_large_population(sorted_F):
    import torch
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.baselines import heuristic_bias_init
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.nsga2 import NSGA2, NSGA2Config
    from repro_torch.workload.trace import build_trace
    trace, cluster = build_trace(500, seed=0), paper_testbed()
    ev = TraceEvaluator(trace, cluster, EvalConfig(concurrency=1),
                        device="cuda")
    cfg = NSGA2Config(pop_size=LARGE_POP, n_generations=LARGE_GENS,
                      genome="discrete", n_choices=cluster.n_pairs,
                      genome_length=trace.n_requests)
    pop = heuristic_bias_init(trace, cluster, LARGE_POP, seed=0)
    opt = NSGA2(ev.make_fitness("direct"), cfg,
                init_fn=lambda _: torch.as_tensor(pop, device="cuda"),
                device="cuda")
    stamps = []

    def tick(_state=None):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    zero_launches()
    tick()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with sorted_F:
        state = opt.evolve(gen, LARGE_GENS, callback=tick)
    launches = launch_counts(dominance_matrix=1 + LARGE_GENS)[
        "dominance_matrix"]
    assert state.genomes.shape == (LARGE_POP, trace.n_requests)
    assert bool(torch.isfinite(state.F_raw).all())
    per_gen = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    emit({"phase": "large_population", "pop": LARGE_POP,
          "combined": 2 * LARGE_POP, "generations": LARGE_GENS,
          "launches": launches, "init_plus_first_gen_s": stamps[1] - stamps[0],
          "gen_s": per_gen, "median_gen_s": statistics.median(per_gen),
          "front0": int((state.rank == 0).sum())})
    return launches


def counts_bound(P, M):
    """Least time for the counts: F read once (P*M*4 bytes), the counts
    written once (P*4), 2*P*P*M f32 comparisons; and which bounds it."""
    t_bytes = (P * M * 4 + P * 4) / HBM_BYTES_PER_S
    t_ops = 2 * P * P * M / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_counts(F):
    """The counts kernel on F exactly equal to its plain version and to the
    column sums of the matrix kernel; returns the largest difference."""
    import torch
    from repro_torch.kernels import ops, ref
    got = ops.dominance_counts(F)
    torch.cuda.synchronize()
    want = ref.dominance_counts(F)
    cols = ops.dominance_matrix(F).sum(dim=0, dtype=torch.int32)
    assert got.dtype == torch.int32 and got.shape == (F.shape[0],)
    err = int((got - want).abs().max())
    assert torch.equal(got, want), ("counts != plain", tuple(F.shape),
                                    F.dtype, err)
    assert torch.equal(got, cols), ("counts != matrix columns",
                                    tuple(F.shape), F.dtype)
    return err


def _check_sorted(Fs):
    """Every recorded objective matrix through both dominance kernels, each
    exactly equal to its plain version; returns how many were checked."""
    import torch
    from repro_torch.kernels import ops, ref
    for F in Fs:
        got = ops.dominance_matrix(F)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.dominance_matrix(F)), (
            "matrix != plain", tuple(F.shape))
        _check_counts(F)
    return len(Fs)


def _check_counts_state():
    """The counts kernel keeps nothing between calls: two calls give equal
    counts, P 4096 then 200 then 4096 again are exact, and so is a call on
    a second stream; returns how many calls were checked."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(8)
    Fa = torch.rand((4096, 3), generator=gen).cuda()
    Fb = torch.rand((200, 3), generator=gen).cuda()
    first, again = ops.dominance_counts(Fa), ops.dominance_counts(Fa)
    small, third = ops.dominance_counts(Fb), ops.dominance_counts(Fa)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = ops.dominance_counts(Fa)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    want = ref.dominance_counts(Fa)
    assert torch.equal(first, again), "two calls differ"
    assert torch.equal(third, want) and torch.equal(
        small, ref.dominance_counts(Fb)), "P 4096, 200, 4096 not exact"
    assert torch.equal(on_side, want), "a second stream not exact"
    return 5


def phase_counts_kernel(sorted_F):
    """The dominator-counts kernel exactly equal to its plain version and to
    the column sums of the matrix kernel: synthetic cases, then every
    objective matrix the quickstart's and the pop-4096 run's sorts saw; no
    state between calls; one device operation a call."""
    import torch
    from repro_torch.kernels import dominance, ops, ref
    gen = torch.Generator().manual_seed(5)
    check = _check_counts
    n = max_err = 0
    for P in COUNT_CASES_P:
        for M in COUNT_CASES_M:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                max_err = max(max_err, check(_dominance_input(P, M, dtype,
                                                              gen)))
                n += 1
    shapes = Counter()
    for F in sorted_F.Fs:
        max_err = max(max_err, check(F))
        shapes[str(tuple(F.shape))] += 1
    assert shapes, "the main path sorted no population"
    state_calls = _check_counts_state()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    timing = {}
    for P in (200, 4096):
        F = torch.rand((P, 3), device="cuda")
        bound, by = counts_bound(P, 3)
        # one device operation a call: a counts kernel and nothing else (a
        # memset would show by name), at most once a call (the profiler
        # drops events now and then, so fewer is taken)
        iters = 20
        names, events = device_kernel_names(ops.dominance_counts, F,
                                            iters=iters, events=True)
        assert names and all("dominance_counts" in nm for nm in names) and (
            0 < events <= iters), ("one device operation a call", names,
                                   events)
        dev = device_kernel_ms(ops.dominance_counts, F,
                               name="dominance_counts")
        timing[str(P)] = dict(
            ms=time_ms(ops.dominance_counts, F),
            plain_ms=time_ms(ref.dominance_counts, F),
            device_ms=dev, bound_ms=bound, bound_by=by, library_ms=None,
            share_of_bound=None if dev is None else bound / dev,
            profiled_ops_per_call=events / iters,
            profiled_op_names=names,
            grid=list(dominance.dominance_counts_grid(P, n_sm)))
    row = {"phase": "counts_kernel", "cases": n,
           "main_path_matrices": len(sorted_F.Fs),
           "main_path_shapes": dict(shapes), "exact": True,
           "state_calls": state_calls, "max_abs_err": max_err,
           "timing": timing,
           "library": "none: no single PyTorch call counts dominators"}
    emit(row)
    return row


def _online_window_checks(res, cluster):
    """One scenario's windows against the CPU: the card's per-request rows
    under the static, adaptive and cloud-only policies (assignments exact,
    rows and QoE objectives within 1e-5), and the re-fit's evaluator padded
    to 64 rows against the 60-row one on the card (rows bit for bit)."""
    import numpy as np
    import torch
    from repro_torch import online
    from repro_torch.core import baselines
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    mism = padded_equal = 0
    rel = obj_rel = 0.0
    cfg = EvalConfig(mode="open")
    for w in res.windows:
        cpu = TraceEvaluator(w.trace, cluster, cfg, device="cpu")
        want = {s: cpu.run_thresholds(w.genomes[s])
                for s in ("static", "adaptive")}
        want["cloud_only"] = cpu.run_assignment(
            baselines.cloud_only(w.trace, cluster))
        for s in online.STRATEGIES:
            a, b = w.results[s], want[s]
            mism += int((a.assign.cpu() != b.assign).sum())
            for f in ("q", "cost", "rt", "ttft", "tpot"):
                x, y = getattr(a, f).cpu(), getattr(b, f)
                assert torch.allclose(x, y, rtol=1e-5, atol=1e-6), (s, f)
                rel = max(rel, float(((x - y).abs()
                                      / y.abs().clamp(min=1e-12)).max()))
        G = torch.as_tensor(np.stack([w.genomes["static"],
                                      w.genomes["adaptive"]]))
        dev = TraceEvaluator(w.trace, cluster, cfg, device="cuda")
        Fd, _ = dev.make_fitness("threshold", "qoe")(G)
        Fc, _ = cpu.make_fitness("threshold", "qoe")(G)
        assert torch.allclose(Fd.cpu(), Fc, rtol=1e-5, atol=1e-7), (Fd, Fc)
        obj_rel = max(obj_rel, float(((Fd.cpu() - Fc).abs()
                                      / Fc.abs().clamp(min=1e-12)).max()))
        plain = TraceEvaluator(w.refit_trace, cluster, cfg, device="cuda")
        padded = TraceEvaluator(w.refit_trace, cluster, cfg, bucket="pow2",
                                device="cuda")
        assert (plain.n_padded, padded.n_padded) == (60, 64)
        a = plain.run_population("threshold", G)
        b = padded.run_population("threshold", G)
        for f in ("q", "cost", "rt", "assign", "ttft", "tpot"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        padded_equal += 1
    assert mism == 0, f"{mism} device/CPU assignment mismatches"
    return {"windows": len(res.windows), "assign_mismatches": mism,
            "max_rel_err_rows": rel, "max_rel_err_objectives": obj_rel,
            "padded_64_equal_to_60_windows": padded_equal}


def phase_online():
    """The runtime router's rolling-horizon loop on the card: run_online()
    as a user calls it, then one re-fit at the router's defaults."""
    import numpy as np
    import torch
    from repro_torch import online
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.router import RequestRouter
    from repro_torch.kernels import ops, ref
    from repro_torch.workload.arrivals import build_open_loop_trace
    from repro_torch.workload.slo import attach_slos
    cluster = paper_testbed()
    per_evolve = 1 + online.GENS          # the init sort + one a generation
    per_scenario = per_evolve * (1 + online.N_WINDOWS)
    sorted_F = SortedObjectives()
    zero_launches()
    t0 = time.perf_counter()
    with sorted_F:
        results = online.run_online()
    wall = time.perf_counter() - t0
    launches = launch_counts(dominance_matrix=per_scenario * len(results))[
        "dominance_matrix"]
    # the scenarios run in turn, each sorting per_scenario matrices
    assert len(sorted_F.Fs) == launches, (len(sorted_F.Fs), launches)
    row = {"phase": "online", "wall_s": wall, "launches": launches,
           "scenarios": {}}
    for turn, (name, res) in enumerate(results.items()):
        f0, f1 = turn * per_scenario, (turn + 1) * per_scenario
        n = f1 - f0
        shapes = Counter(str(tuple(F.shape)) for F in sorted_F.Fs[f0:f1])
        assert shapes == {f"({online.POP}, 4)": 1 + online.N_WINDOWS,
                          f"({2 * online.POP}, 4)":
                              online.GENS * (1 + online.N_WINDOWS)}, shapes
        F32 = sorted_F.Fs[f1 - 1]
        names = {_kernel_name(k) for k in device_kernel_names(
            ops.dominance_matrix, F32) if "dominance_matrix" in k}
        assert names == {"dominance_matrix_kernel<4>"}, names
        a, st = res.summary["adaptive"], res.summary["static"]
        row["scenarios"][name] = {
            "post_drift": {s: dict(quality=v.quality, cost=v.cost,
                                   attainment=v.attainment, rt=v.rt)
                           for s, v in res.summary.items()},
            "composite": res.composite,
            "adaptive_beats_static": (res.composite["adaptive"]
                                      > res.composite["static"]
                                      and a.attainment >= st.attainment),
            "tune_window0_s": res.tune_s,
            "refit_s": [w.refit_s for w in res.windows],
            "launches": n, "sorted_shapes": dict(shapes),
            "kernel": sorted(names),
            "checks": _online_window_checks(res, cluster)}
        for r in res.rows:
            print(",".join(str(x) for x in r), flush=True)

    # one re-fit at the router's defaults on 256 requests of the burst phase
    burst = online.SCENARIOS["burst"][1]
    tr = attach_slos(build_open_loop_trace(REFIT_REQUESTS, (burst,), seed=7),
                     seed=7)
    router = RequestRouter(cluster, results["burst"].windows[-1]
                           .genomes["adaptive"], device="cuda")
    ev = TraceEvaluator(tr, cluster, EvalConfig(mode="open"), device="cuda")
    online._record_window(router, tr, ev.run_thresholds(router.thresholds))
    refit_F = SortedObjectives()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with refit_F:
        genome = router.maybe_reoptimize(
            force=True, window=REFIT_REQUESTS, generations=REFIT_GENS,
            pop_size=REFIT_POP, weights=online.WEIGHTS)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    refit_launches = launch_counts(dominance_matrix=1 + REFIT_GENS)[
        "dominance_matrix"]
    assert genome is not None and np.isfinite(genome).all()
    window = TraceEvaluator(router.window_trace(REFIT_REQUESTS), cluster,
                            EvalConfig(mode="open"), bucket="pow2",
                            device="cuda")
    assert window.n_padded == REFIT_REQUESTS
    prof = profile_fitness(window.make_fitness("threshold", "qoe"),
                           torch.as_tensor(router._archive, device="cuda"),
                           REFIT_REQUESTS)
    timing = {}
    for P, F in ((2 * online.POP, sorted_F.Fs[-1]),
                 (2 * REFIT_POP, refit_F.Fs[-1])):
        assert tuple(F.shape) == (P, 4), F.shape
        timing[f"p{P}_m4"] = dict(
            ms=time_ms(ops.dominance_matrix, F),
            plain_ms=time_ms(ref.dominance_matrix, F),
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(P, 4), bound_by="bytes",
            library_ms=None)
    # every matrix the online sorts saw, through both kernels again
    assert len(refit_F.Fs) == refit_launches, (len(refit_F.Fs),
                                               refit_launches)
    row["matrices_checked"] = _check_sorted(sorted_F.Fs + refit_F.Fs)
    row["refit_256"] = {"requests": REFIT_REQUESTS, "pop": REFIT_POP,
                        "generations": REFIT_GENS, "wall_s": refit_s,
                        "launches": refit_launches, "genome":
                            [float(x) for x in genome],
                        "profile": prof}
    row["timing"] = timing
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the policy matrix: every registered policy, every evaluator mode
# ---------------------------------------------------------------------------

def _qoe_objectives(ev, res):
    """(P, 4) QoE objectives of (P, n_valid) results, by the evaluator's own
    masked-mean arithmetic over the real requests, on the results'
    device."""
    import types
    from repro_torch.core import fitness
    t, n, dev = ev.tables, ev.n_valid, res.q.device
    view = types.SimpleNamespace(valid=t.valid[:n].to(dev),
                                 ttft_deadline=t.ttft_deadline[:n].to(dev),
                                 tpot_deadline=t.tpot_deadline[:n].to(dev))
    return fitness._objectives(res, view, "qoe")


def _matrix_replays(rows, trace, cluster):
    """Every row's genome (default and tuned) on a CPU evaluator of each
    configuration of its decision space, a policy's rows as one
    population, against the card's results behind the rows: assignments
    exact, per-request rows and QoE objectives within 1e-6 (relative past
    1)."""
    import numpy as np
    import torch
    from repro_torch import policy_matrix as pm
    cpu = pm.evaluators(trace, cluster, "cpu")
    mism = replays = 0
    row_rel = obj_rel = 0.0
    configs = set()
    rel = lambda x, y: float(((x - y).abs()  # noqa: E731
                              / y.abs().clamp(min=1.0)).max())
    for policy in dict.fromkeys(r.policy for r in rows):
        mine = [r for r in rows if r.policy == policy]
        space = pm.space_of(policy)
        G = np.stack([r.genome for r in mine])
        for regime in pm.REGIMES:
            ev = cpu[space, regime]
            b = ev.run_population(policy, G)
            for k, r in enumerate(mine):
                a, bk = r.results[regime], type(b)(*(t[k:k + 1]
                                                     for t in b))
                mism += int((a.assign.cpu() != bk.assign).sum())
                for f in ("q", "cost", "rt", "ttft", "tpot", "hit",
                          "transfer"):
                    x, y = getattr(a, f).cpu(), getattr(bk, f)
                    assert torch.allclose(x, y, rtol=1e-6, atol=1e-6), (
                        policy, regime, f, rel(x, y))
                    row_rel = max(row_rel, rel(x, y))
                Fd = _qoe_objectives(ev, a).cpu()
                Fc = _qoe_objectives(ev, bk)
                assert torch.allclose(Fd, Fc, rtol=1e-6, atol=1e-6), (Fd, Fc)
                obj_rel = max(obj_rel, rel(Fd, Fc))
                replays += 1
            configs.add((space, regime))
    assert mism == 0, f"{mism} card/CPU assignment mismatches"
    assert len(configs) == 6, configs
    return {"replays": replays, "configurations": len(configs),
            "assign_mismatches": mism, "max_rel_err_rows": row_rel,
            "max_rel_err_objectives": obj_rel}


def _drive_router(router, trace, block=16):
    """Route the matrix trace through ``router`` as a serving loop would:
    dispatch, the served prefix recorded on the serving node(s), a
    completion four requests later, and ``record`` with realized TTFT and
    TPOT (the cloud node three times slower than the tables). Returns the
    decisions and the host microseconds per ``route()`` call."""
    mon = router.monitor
    decisions, inflight, route_s = [], [], 0.0
    for i, req in enumerate(trace.requests):
        now = float(trace.arrival_time[i])
        dl = dict(ttft_deadline=float(trace.ttft_deadline[i]),
                  tpot_deadline=float(trace.tpot_deadline[i]))
        t0 = time.perf_counter()
        d = router.route(req, now=now, **dl)
        route_s += time.perf_counter() - t0
        mon.on_dispatch(d.node)
        legs = {d.node} if d.prefill_pair is None else {
            d.node, int(router.arrays.pair_node[d.prefill_pair])}
        for node in sorted(legs):
            if req.session_id >= 0:
                mon.record_prefix(node, ("sess", req.session_id),
                                  req.prompt_tokens // block * block)
            if req.sys_id >= 0:
                mon.record_prefix(node, ("sys", req.sys_id),
                                  req.sys_tokens // block * block)
        inflight.append(d.node)
        if len(inflight) > 4:
            mon.on_complete(inflight.pop(0), 1.0)
        slow = 3.0 if d.node == 0 else 1.0
        router.record(req, d, quality=0.5, cost=d.est_cost, rt=1.0, now=now,
                      ttft=d.est_ttft * slow, tpot=d.est_tpot * slow, **dl)
        decisions.append(d)
    return decisions, route_s / len(trace.requests) * 1e6


def phase_policy_matrix():
    """The whole routing-policy registry on the policy-matrix path, on the
    card: ``policy_matrix.run()`` as a user calls it, its rows replayed on
    the CPU, one population evaluation profiled per evaluator
    configuration, ``route()`` timed for every runtime policy, and the
    learned affinity and disagg routers driven and re-fit on the card."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch import policy_matrix as pm
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.policies import (get_policy, list_policies,
                                           runtime_policies)
    from repro_torch.core.router import RequestRouter
    from repro_torch.kernels import ops
    n_pol = len(list_policies())
    per_fit = 1 + pm.GENS               # the init sort + one a generation
    sorted_F = SortedObjectives()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sorted_F:
        rows = pm.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(dominance_matrix=per_fit * n_pol)[
        "dominance_matrix"]
    assert len(sorted_F.Fs) == launches, (len(sorted_F.Fs), launches)
    shapes = Counter(str(tuple(F.shape)) for F in sorted_F.Fs)
    assert shapes == {f"({pm.POP}, 4)": n_pol,
                      f"({2 * pm.POP}, 4)": pm.GENS * n_pol}, shapes
    names = {_kernel_name(k) for k in device_kernel_names(
        ops.dominance_matrix, sorted_F.Fs[-1]) if "dominance_matrix" in k}
    assert names == {"dominance_matrix_kernel<4>"}, names
    tuned = {r.policy for r in rows if r.variant == "tuned"}
    assert tuned == set(list_policies()), tuned
    for r in rows:
        assert all(math.isfinite(c) for c in r.cells()[2:]), r
    cluster = paper_testbed()
    trace = pm.workload(pm.N_REQUESTS)
    parts = {"matrix_s": wall}
    t0 = time.perf_counter()
    checks = _matrix_replays(rows, trace, cluster)
    parts["cpu_replays_s"] = time.perf_counter() - t0

    # one population evaluation per evaluator configuration, profiled
    t0 = time.perf_counter()
    evs = pm.evaluators(trace, cluster, "cuda")
    gen = torch.Generator().manual_seed(3)
    profiles = {}
    for (space, regime), ev in evs.items():
        policy = "disagg" if space == "route" else "affinity"
        spec = get_policy(policy).genome_spec
        lo, hi = (torch.as_tensor(b) for b in (spec.lo, spec.hi))
        G = (lo + torch.rand((pm.POP, len(lo)), generator=gen) * (hi - lo))
        profiles[f"{space}/{regime}"] = {"policy": policy, **profile_fitness(
            ev.make_fitness(policy, "qoe"), G.cuda(), trace.n_requests)}

    parts["profiles_s"] = time.perf_counter() - t0

    # route() on the host, every runtime policy, static and learned
    t0 = time.perf_counter()
    route_us = {}
    for mode in runtime_policies():
        for learned in (False, True):
            router = RequestRouter(cluster, mode=mode, learned=learned,
                                   device="cuda")
            _, us = _drive_router(router, trace)
            route_us[f"{mode}{'/learned' if learned else ''}"] = us

    parts["routers_s"] = time.perf_counter() - t0

    # the learned affinity and disagg routers on the card: decisions equal
    # a CPU router's, then one re-fit each at the router's defaults
    t0 = time.perf_counter()
    refits, refit_Fs = {}, []
    for mode in ("affinity", "disagg"):
        card = RequestRouter(cluster, mode=mode, learned=True, device="cuda")
        host = RequestRouter(cluster, mode=mode, learned=True, device="cpu")
        got, _ = _drive_router(card, trace)
        want, _ = _drive_router(host, trace)
        assert [dc.astuple(d) for d in got] == [dc.astuple(d) for d in want]
        assert (card.monitor.estimator.state.tobytes()
                == host.monitor.estimator.state.tobytes())
        refit_F = SortedObjectives()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with refit_F:
            genome = card.maybe_reoptimize(force=True)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        n = launch_counts(dominance_matrix=1 + REFIT_GENS)[
            "dominance_matrix"]
        assert genome is not None and np.isfinite(genome).all()
        assert len(refit_F.Fs) == n
        refit_Fs += refit_F.Fs
        refits[mode] = {"window": trace.n_requests, "padded_to": 256,
                        "pop": REFIT_POP, "generations": REFIT_GENS,
                        "wall_s": refit_s, "launches": n,
                        "decisions_equal_cpu": len(got),
                        "genome": [float(x) for x in genome]}
    parts["learned_routers_and_refits_s"] = time.perf_counter() - t0
    # every matrix the matrix's fits and the re-fits sorted, through both
    # dominance kernels again, each exactly equal to its plain version
    t0 = time.perf_counter()
    matrices = _check_sorted(sorted_F.Fs + refit_Fs)
    parts["matrix_checks_s"] = time.perf_counter() - t0

    row = {"phase": "policy_matrix", "wall_s": wall,
           "requests": trace.n_requests, "pop": pm.POP,
           "generations": pm.GENS, "policies": n_pol, "launches": launches,
           "sorted_shapes": dict(shapes), "kernel": sorted(names),
           "matrices_checked": matrices,
           "fit_s": {r.policy: r.nsga2_fit_s for r in rows
                     if r.variant == "tuned"},
           "rows": {f"{r.policy}.{r.variant}": dict(zip(
               pm.COLUMNS[2:], r.cells()[2:])) for r in rows},
           "checks": checks, "profiles": profiles,
           "route_us_per_decision": route_us, "refits": refits,
           "parts_s": parts}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def _err(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def _check_close(name, got, want, dtype, case):
    import torch
    tol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape, case
    assert torch.isfinite(got).all(), (name, case)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    assert ok, f"{name} {case}: max abs err {_err(got, want)}"
    return _err(got, want)


def _dtypes():
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dec_case(B, Hq, Hkv, D, Smax, lens, dt, gen, engine_layout):
    import torch
    q = torch.randn((B, Hq, D), generator=gen).to(dt).cuda()
    if engine_layout:   # one layer of the engine's (B, Smax, Hkv, D) cache
        k = torch.randn((B, Smax, Hkv, D), generator=gen).to(dt).cuda()
        v = torch.randn((B, Smax, Hkv, D), generator=gen).to(dt).cuda()
        k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    else:
        k = torch.randn((B, Hkv, Smax, D), generator=gen).to(dt).cuda()
        v = torch.randn((B, Hkv, Smax, D), generator=gen).to(dt).cuda()
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda")


def check_decode_kernel():
    """Every decode case against the plain version; kv_len 0 gives zeros;
    garbage past kv_len leaves the output bit for bit unchanged."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(1)
    n = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D in DEC_HEADS:
            for Smax in DEC_SMAX:
                edge = min(32, Smax)
                b8 = [1, edge, edge + 1, Smax, Smax + 25, 0, Smax // 3,
                      Smax - 1]
                runs = [[x] for x in (1, edge, Smax, Smax + 25, 0)] + [b8]
                for lens in runs:
                    for layout in (False, True):
                        q, k, v, kl = _dec_case(len(lens), Hq, Hkv, D, Smax,
                                                lens, dt, gen, layout)
                        case = (dname, Hq, Hkv, D, Smax, lens, layout)
                        got = ops.gqa_decode_attention(q, k, v, kl)
                        torch.cuda.synchronize()
                        want = ref.gqa_decode(q, k, v, kl)
                        errs[dname] = max(errs[dname], _check_close(
                            "decode", got, want, dname, case))
                        for b, x in enumerate(lens):
                            if x <= 0:
                                assert not got[b].any(), ("kv_len 0", case)
                        n += 1
                # the cache past kv_len: +-999, then NaN
                lens = [1, edge, Smax // 2, Smax, 3, edge + 1, 0, 7]
                q, k, v, kl = _dec_case(8, Hq, Hkv, D, Smax, lens, dt, gen,
                                        True)
                clean = ops.gqa_decode_attention(q, k, v, kl)
                for junk in (999.0, float("nan")):
                    k2, v2 = k.clone(), v.clone()
                    for b, x in enumerate(lens):
                        k2[b, :, x:] = junk
                        v2[b, :, x:] = -junk
                    dirty = ops.gqa_decode_attention(q, k2, v2, kl)
                    assert torch.equal(dirty, clean), ("garbage", junk, Hq,
                                                       Smax, dname)
                    n += 1
    return n, errs


def check_flash_kernel():
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(2)
    n = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D in DEC_HEADS:
            for S in FA_S:
                for causal in (True, False):
                    # the model's layout: (B, S, H, D) projections viewed as
                    # (B, H, S, D); B = 2 on one head shape
                    B = 2 if Hq == 16 else 1
                    q, k, v = (torch.randn((B, S, h, D), generator=gen)
                               .to(dt).cuda().transpose(1, 2)
                               for h in (Hq, Hkv, Hkv))
                    got = ops.flash_attention(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    want = ref.mha_prefill(q, k, v, causal=causal)
                    errs[dname] = max(errs[dname], _check_close(
                        "flash", got, want, dname,
                        (dname, Hq, Hkv, D, S, causal)))
                    n += 1
    return n, errs


def _serving_kv_lens(n=8):
    """The fills the serve phase's first 8 slots reach midway through their
    answers: prompt length plus half the budget."""
    from repro_torch.serve import budget, tokenize
    from repro_torch.workload.trace import build_trace
    tr = build_trace(500, seed=0)
    return [len(tokenize(r, 151936)) + budget(tr.resp_tokens_mean[i]) // 2
            for i, r in enumerate(tr.requests[:n])]


def decode_timing(lens, Smax=512, Hq=16, Hkv=8, D=128):
    """The decode kernel at the serve phase's shapes (bf16, one layer of
    the engine's cache read in place) beside its plain version, SDPA with a
    boolean kv_len mask, and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(3)
    B = len(lens)
    q, k, v, kl = _dec_case(B, Hq, Hkv, D, Smax, lens, torch.bfloat16, gen,
                            True)
    mask = (torch.arange(Smax, device="cuda")[None, :]
            < kl.clamp(max=Smax)[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                              enable_gqa=True)

    n_read = sum(min(x, Smax) for x in lens)
    nbytes = 2 * (2 * B * Hq * D + 2 * n_read * Hkv * D) + 4 * B
    ops_n = 4 * n_read * Hq * D
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S)
    out = dict(shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "Smax": Smax,
                      "kv_len": list(lens), "dtype": "bfloat16"},
               ms=time_ms(ops.gqa_decode_attention, q, k, v, kl),
               device_ms=device_kernel_ms(ops.gqa_decode_attention, q, k, v,
                                          kl, name=DECODE_KERNEL),
               plain_ms=time_ms(ref.gqa_decode, q, k, v, kl),
               bound_ms=bound,
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    got = ops.gqa_decode_attention(q, k, v, kl)
    out["max_abs_err"] = _check_close("decode", got, ref.gqa_decode(
        q, k, v, kl), "bfloat16", out["shape"])
    try:
        torch.testing.assert_close(library()[:, :, 0], got, atol=2e-2,
                                   rtol=2e-2)
        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = device_total_ms(library)
    except (TypeError, RuntimeError) as e:   # SDPA without enable_gqa
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def flash_timing(S, causal=True, B=1, Hq=16, Hkv=8, D=128):
    """The flash kernel at a serve phase prefill shape (bf16, the model's
    (B, S, H, D) projections read in place) beside its plain version,
    SDPA and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((B, S, h, D), generator=gen).to(torch.bfloat16)
               .cuda().transpose(1, 2) for h in (Hq, Hkv, Hkv))

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    ops_n = 4 * B * Hq * pairs * D
    out = dict(shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S": S,
                      "causal": causal, "dtype": "bfloat16"},
               ms=time_ms(ops.flash_attention, q, k, v, causal),
               device_ms=device_kernel_ms(ops.flash_attention, q, k, v,
                                          causal,
                                          name="flash_attention_kernel"),
               plain_ms=time_ms(ref.mha_prefill, q, k, v, causal),
               bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops_n / BF16_OPS_PER_S),
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    got = ops.flash_attention(q, k, v, causal)
    out["max_abs_err"] = _check_close("flash", got, ref.mha_prefill(
        q, k, v, causal=causal), "bfloat16", out["shape"])
    try:
        torch.testing.assert_close(library(), got, atol=2e-2, rtol=2e-2)
        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = device_total_ms(library)
    except (TypeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def flash_groups_timing():
    """Device time of the bf16 flash kernel with one and with two
    warpgroups a block, forced, at the serving heads: the evidence for
    ``flash_attention.flash_groups``' choice."""
    import torch
    from repro_torch.kernels import flash_attention, ops
    gen = torch.Generator().manual_seed(11)
    auto = flash_attention.flash_groups
    out = {}
    try:
        for S in (64, 128, 512, 1088):
            q, k, v = (torch.randn((1, S, h, 128), generator=gen)
                       .to(torch.bfloat16).cuda().transpose(1, 2)
                       for h in (16, 8, 8))
            for g in (1, 2):
                flash_attention.flash_groups = lambda *a, g=g: g
                out[f"S{S}_groups{g}_device_ms"] = device_kernel_ms(
                    ops.flash_attention, q, k, v, True,
                    name="flash_attention_kernel")
        q, kp, vp, k, v = _ext_case(1, 16, 8, 128, 1088, 128, torch.bfloat16,
                                    gen)
        for g in (1, 2):
            flash_attention.flash_groups = lambda *a, g=g: g
            out[f"extend_1088_128_224_groups{g}_device_ms"] = \
                device_kernel_ms(ops.flash_attention_extend, q, kp, vp, k,
                                 v, 224, name="flash_attention_kernel")
    finally:
        flash_attention.flash_groups = auto
    return out


def _ext_case(B, Hq, Hkv, D, S_pre, Sq, dt, gen):
    """q, prefix k/v, suffix k/v in the model's layout: (B, S, H, D)
    tensors viewed as (B, H, S, D)."""
    import torch
    return [torch.randn((B, S, h, D), generator=gen).to(dt).cuda()
            .transpose(1, 2)
            for S, h in ((Sq, Hq), (S_pre, Hkv), (S_pre, Hkv), (Sq, Hkv),
                         (Sq, Hkv))]


def check_flash_extend():
    """The prefix-extend variant against its plain version; in the
    bucketed mode, +-999 and NaN in the prefix rows past prefix_len leave
    the output bit for bit unchanged."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(6)
    n = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D in DEC_HEADS:
            for S_pre, Sq, plen in EXT_CASES:
                B = 2 if Hq == 16 and S_pre < 1000 else 1
                q, kp, vp, k, v = _ext_case(B, Hq, Hkv, D, S_pre, Sq, dt, gen)
                case = (dname, Hq, Hkv, D, S_pre, Sq, plen)
                got = ops.flash_attention_extend(q, kp, vp, k, v, plen)
                torch.cuda.synchronize()
                want = ref.mha_prefill_extend(q, kp, vp, k, v, plen)
                errs[dname] = max(errs[dname], _check_close(
                    "flash_extend", got, want, dname, case))
                n += 1
                if plen is None:
                    continue
                for junk in (999.0, float("nan")):
                    kp2, vp2 = kp.clone(), vp.clone()
                    kp2[:, :, plen:] = junk
                    vp2[:, :, plen:] = -junk
                    dirty = ops.flash_attention_extend(q, kp2, vp2, k, v,
                                                       plen)
                    assert torch.equal(dirty, got), ("garbage", junk, case)
                    n += 1
    return n, errs


def extend_timing(S_pre, Sq, plen, B=1, Hq=16, Hkv=8, D=128):
    """The flash kernel's prefix-extend variant at a session admission's
    shape (bf16, the model's layout read in place) beside its plain
    version, SDPA over the concatenated K/V with the boolean mask, and its
    bound (the prefix rows it must read: plen, not S_pre)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(7)
    q, kp, vp, k, v = _ext_case(B, Hq, Hkv, D, S_pre, Sq, torch.bfloat16,
                                gen)
    kf, vf = torch.cat([kp, k], dim=2), torch.cat([vp, v], dim=2)
    col = torch.arange(S_pre + Sq, device="cuda")[None, :]
    row = torch.arange(Sq, device="cuda")[:, None]
    mask = torch.where(col < S_pre, col < plen, (col - S_pre) <= row)

    def library():
        return F.scaled_dot_product_attention(q, kf, vf, attn_mask=mask,
                                              enable_gqa=True)

    pairs = Sq * plen + Sq * (Sq + 1) // 2
    nbytes = 2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * (plen + Sq) * D)
    ops_n = 4 * B * Hq * pairs * D
    out = dict(shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S_pre": S_pre,
                      "Sq": Sq, "prefix_len": plen, "dtype": "bfloat16"},
               ms=time_ms(ops.flash_attention_extend, q, kp, vp, k, v, plen),
               device_ms=device_kernel_ms(ops.flash_attention_extend, q, kp,
                                          vp, k, v, plen,
                                          name="flash_attention_kernel"),
               plain_ms=time_ms(ref.mha_prefill_extend, q, kp, vp, k, v,
                                plen),
               bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops_n / BF16_OPS_PER_S),
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    got = ops.flash_attention_extend(q, kp, vp, k, v, plen)
    out["max_abs_err"] = _check_close("flash_extend", got,
                                      ref.mha_prefill_extend(q, kp, vp, k, v,
                                                             plen),
                                      "bfloat16", out["shape"])
    try:
        torch.testing.assert_close(library(), got, atol=2e-2, rtol=2e-2)
        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = device_total_ms(library)
    except (TypeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def _kernel_name(signature, stem=r"\w+_kernel\w*"):
    """A profiled kernel's name (``stem``, a regex, and its template
    arguments) without its namespace and arguments."""
    import re
    return re.search(stem + r"(<[^>]*>)?", signature).group(0)


def check_kernel_routes():
    """bf16 flash runs the tensor-core (wgmma) kernel and f32 flash the
    CUDA-core one, by the names the profiler records; the decode kernel
    splits every (b, kv head) over several blocks at the serving Smax;
    inputs the 16-byte copies cannot take raise ValueError."""
    import torch
    from repro_torch.kernels import decode_attention, ops
    gen = torch.Generator().manual_seed(10)
    routes = {}
    for dname, dt in _dtypes().items():
        q, k, v = (torch.randn((1, 128, h, 128), generator=gen).to(dt)
                   .cuda().transpose(1, 2) for h in (16, 8, 8))
        every = device_kernel_names(ops.flash_attention, q, k, v, True)
        names = [n for n in every if "flash_attention_kernel" in n]
        want = {"bfloat16": "flash_attention_kernel_wgmma",
                "float32": "flash_attention_kernel<float>"}[dname]
        assert names and all(want in n for n in names), (dname, every)
        routes[dname] = sorted({_kernel_name(n) for n in names})
    # bf16 warpgroups per block, as flash_attention.flash_groups picks them:
    # one for a single key tile (S 64), two from two tiles on (S 128)
    for S, groups in ((64, 1), (128, 2)):
        qs, ks, vs = (torch.randn((1, S, h, 128), generator=gen)
                      .to(torch.bfloat16).cuda().transpose(1, 2)
                      for h in (16, 8, 8))
        got = {_kernel_name(n) for n in device_kernel_names(
            ops.flash_attention, qs, ks, vs, True)
            if "flash_attention_kernel" in n}
        assert got == {f"flash_attention_kernel_wgmma<128, {groups}>"}, got
        routes[f"bfloat16_S{S}"] = sorted(got)
    qd, kd, vd, kl = _dec_case(8, 16, 8, 128, 512, [512] * 8,
                               torch.bfloat16, gen, True)
    dec_names = [n for n in device_kernel_names(ops.gqa_decode_attention,
                                                qd, kd, vd, kl)
                 if "split_decode_kernel" in n and DECODE_KERNEL in n]
    # the split kernel's ticket buffer: an int* (mangled "Pi") parameter
    assert len(dec_names) == 1 and ("int*" in dec_names[0]
                                    or "PfPi" in dec_names[0]), dec_names
    splits = {Smax: decode_attention.decode_split(8, 8, Smax, torch.cuda
                                                  .get_device_properties(0)
                                                  .multi_processor_count)
              for Smax in (512, 1088)}
    assert all(sp > 1 for _, sp in splits.values()), splits

    def unaligned(shape):
        """A view whose row stride is not a multiple of 16 bytes, and one
        2 bytes past an aligned address."""
        n = math.prod(shape)
        odd = torch.zeros(shape[:-1] + (shape[-1] + 4,), dtype=torch.bfloat16,
                          device="cuda")[..., :shape[-1]]
        raw = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")
        return odd, raw[1:1 + n].view(shape)

    def refuses(fn, *args):
        try:
            fn(*args)
        except ValueError:
            return True
        return False

    qb = q.to(torch.bfloat16)
    refused = sum(refuses(ops.gqa_decode_attention, qd, bad, bad, kl)
                  for bad in unaligned((8, 8, 512, 128)))
    refused += sum(refuses(ops.flash_attention, qb, bad, bad, True)
                   for bad in unaligned((1, 8, 128, 128)))
    assert refused == 4, refused
    return {"flash_kernels": routes,
            "decode_kernel": _kernel_name(dec_names[0]),
            "decode_split": {str(k): list(v) for k, v in splits.items()},
            "unaligned_refused": refused}


def phase_attention_kernels():
    n_dec, dec_err = check_decode_kernel()
    n_fa, fa_err = check_flash_kernel()
    n_ext, ext_err = check_flash_extend()
    routes = check_kernel_routes()
    lens = _serving_kv_lens()
    row = {"phase": "attention_kernels", "routes": routes,
           "decode": {"cases": n_dec, "max_abs_err": dec_err,
                      "serving": decode_timing(lens),
                      "full_cache": decode_timing([512] * 8)},
           "flash": {"cases": n_fa, "max_abs_err": fa_err,
                     "serving": flash_timing(128),
                     "s64": flash_timing(64),
                     "s512": flash_timing(512),
                     "groups": flash_groups_timing()},
           "flash_extend": {"cases": n_ext, "max_abs_err": ext_err}}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _profile_step(engine, n_steps=5):
    """Host wall time of one decode iteration (median of ``n_steps``
    unprofiled) and the card's busy time in one profiled iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # the kv_len the decode kernel reads in the profiled iteration
    decode_kv_len = (engine.cache.kv_len + 1).tolist()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name, host = Counter(), Counter()
    n_events = 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by_name[ev.name[:60]] += ev.time_range.elapsed_us()
            n_events += 1
        else:   # where the host's time goes (inflated by the profiler)
            host[ev.name[:60]] += ev.self_cpu_time_total
    busy = sum(by_name.values()) / 1e6 if n_events else None
    wall = statistics.median(walls)
    return {"step_wall_s": wall, "profiled_step_wall_s": prof_wall,
            "device_busy_s": busy, "idle_share": _idle(busy, wall),
            "device_events": n_events, "decode_kv_len": decode_kv_len,
            "top_device_us": by_name.most_common(8),
            "top_host_self_us": host.most_common(8)}


def phase_serve():
    import torch
    from repro_torch import serve
    from repro_torch.configs import get
    cfg = get(SERVE_MODEL).config()
    t0 = time.perf_counter()
    model = serve.build_model(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve.run_serve(cfg=cfg, model=model, n_requests=2, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    run = serve.run_serve(cfg=cfg, model=model, n_requests=SERVE_REQUESTS,
                          device="cuda")
    e = run.engine
    launches = launch_counts(gqa_decode_attention=cfg.n_layers * e._steps,
                             flash_attention=cfg.n_layers * e.admissions)

    assert sorted(run.results) == list(range(SERVE_REQUESTS))
    for rid, r in run.results.items():
        assert len(r["tokens"]) == run.budgets[rid], rid
        assert all(0 <= t < cfg.vocab for t in r["tokens"]), rid
    assert e.admissions == SERVE_REQUESTS
    tokens = sum(len(r["tokens"]) for r in run.results.values())
    print("\n".join(serve.format_run(run)[:4] + ["  ..."]), flush=True)

    # one decode iteration with every slot busy, profiled
    from repro_torch.serving import LLMEngine
    prof_eng = LLMEngine(cfg, model, serve.SERVE_ENGINE, device="cuda")
    tr = serve.build_trace(500, seed=0)
    for rid, req in enumerate(tr.requests[:serve.SERVE_ENGINE.max_slots]):
        prof_eng.submit(rid, serve.tokenize(req, cfg.vocab),
                        max_new_tokens=64)
    prof = _profile_step(prof_eng)
    row = {"phase": "serve", "model": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_counts()["total"],
           "engine": dataclasses.asdict(serve.SERVE_ENGINE),
           "chunk": serve.CHUNK, "requests": SERVE_REQUESTS,
           "launches": launches, "decode_iterations": e._steps,
           "admissions": e.admissions, "tokens": tokens,
           "init_s": init_s, "wall_s": run.wall_s,
           "tokens_per_s": tokens / run.wall_s,
           "prefill_ms_mean": 1e3 * e.prefill_seconds / e.admissions,
           "decode_iteration_ms_mean": 1e3 * e.decode_seconds / e._steps,
           "host_syncs": e.host_syncs,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "qoe": e.qoe_summary(), "decode_iteration_profile": prof}
    emit(row)
    return run, model, row


def _near_tie_ok(logits_row, tok):
    """(ok, gap / max|logit|): the token's logit lies within 2e-2 of the
    row's max|logit| below the row's max."""
    scale = float(logits_row.abs().max())
    gap = float(logits_row.max() - logits_row[tok])
    return gap <= 2e-2 * scale, gap / scale


def phase_serve_check(run, model):
    import torch
    from repro_torch import serve
    from repro_torch.models import lm
    cfg = run.cfg
    n_tok, worst = _teacher_forced(model, cfg, run)

    # the card against the CPU: full width, 2 layers, the same weights
    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    cpu_model = serve.build_model(cfg2, "cpu", seed=1)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    kw = dict(cfg=cfg2, n_requests=CHECK_REQUESTS)
    cpu = serve.run_serve(model=cpu_model, device="cpu", **kw)
    card = serve.run_serve(model=card_model, device="cuda", **kw)
    diverged, differing, ties = 0, 0, []
    for rid, want in cpu.results.items():
        a, b = card.results[rid]["tokens"], want["tokens"]
        differing += sum(x != y for x, y in zip(a, b))
        if a == b:
            continue
        diverged += 1
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = list(cpu.prompts[rid]) + b[:j]
        row = lm.train_logits(cpu_model, cfg2, torch.tensor([seq]))[0][0, -1]
        top2 = row.topk(2).values
        gap = float(top2[0] - top2[1]) / float(row.abs().max())
        ties.append({"request": rid, "position": j, "cpu_top2_gap": gap})
        assert gap < 2e-2, ("card and CPU differ away from a near-tie", rid,
                            j, gap)
    out = {"phase": "serve_check", "teacher_forced_tokens": n_tok,
           "worst_gap_over_max_logit": worst,
           "card_vs_cpu": {"layers": CHECK_LAYERS, "requests": CHECK_REQUESTS,
                           "tokens": sum(len(r["tokens"])
                                         for r in cpu.results.values()),
                           "diverged_requests": diverged,
                           "differing_tokens": differing,
                           "divergences": ties}}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the paged decode kernel
# ---------------------------------------------------------------------------

def _paged_case(B, Hq, Hkv, nb, bs, mb, D, dt, gen, store_layout):
    """q, pools (the TPU layout (n_blocks, Hkv, bs, D), or the serving
    store's (n_blocks, bs, Hkv, D) permuted to it in place), a block table
    of distinct ids per row with pad entries past kv_len (-1 on odd rows,
    other ids on even ones) and a negative id in a live entry, kv_len with a
    0 and a mid-block end."""
    import torch
    q = torch.randn((B, Hq, D), generator=gen).to(dt).cuda()
    if store_layout:
        k, v = (torch.randn((nb, bs, Hkv, D), generator=gen).to(dt).cuda()
                .permute(0, 2, 1, 3) for _ in range(2))
    else:
        k, v = (torch.randn((nb, Hkv, bs, D), generator=gen).to(dt).cuda()
                for _ in range(2))
    bt = torch.stack([torch.randperm(nb, generator=gen)[:mb]
                      for _ in range(B)]).to(torch.int32)
    lens = torch.randint(1, mb * bs + 1, (B,), generator=gen)
    if B > 1:
        lens[0] = 0
    lens[-1] = bs + bs // 2
    for b in range(B):
        live = -(-int(lens[b]) // bs)
        if b % 2:
            bt[b, live:] = -1
        if b == 1 and live > 1:
            bt[b, 0] = -3                   # reads block 0
    return q, k, v, bt.cuda(), lens.to(torch.int32).cuda()


def _gather_rows(pool, bt):
    """(n_blocks, Hkv, bs, D) pool -> (B, Hkv, max_blocks * bs, D) cache."""
    B, mb = bt.shape
    g = pool[bt.long().clamp(min=0)]            # (B, mb, Hkv, bs, D)
    return g.permute(0, 2, 1, 3, 4).reshape(B, pool.shape[1],
                                            mb * pool.shape[2], -1)


def phase_paged_kernel():
    """The paged kernel against its plain version, and bit for bit equal to
    the decode kernel on the gathered cache (max_blocks * bs positions: the
    same spans and splits); NaN in unreferenced blocks changes nothing;
    pools the 16-byte copies cannot take raise ValueError."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(8)
    n = n_equal = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for B, Hq, Hkv, nb, bs, mb, D in PAGED_CASES:
            for layout in (False, True):
                q, k, v, bt, lens = _paged_case(B, Hq, Hkv, nb, bs, mb, D,
                                                dt, gen, layout)
                case = (dname, B, Hq, Hkv, nb, bs, mb, D, layout)
                got = ops.paged_gqa_decode_attention(q, k, v, bt, lens)
                torch.cuda.synchronize()
                want = ref.paged_gqa_decode(q, k, v, bt, lens)
                errs[dname] = max(errs[dname], _check_close(
                    "paged", got, want, dname, case))
                dec = ops.gqa_decode_attention(q, _gather_rows(k, bt),
                                               _gather_rows(v, bt), lens)
                assert torch.equal(got, dec), ("paged != decode on the "
                                               "gathered cache", case,
                                               _err(got, dec))
                n_equal += 1
                for b in range(B):
                    if int(lens[b]) <= 0:
                        assert not got[b].any(), ("kv_len 0", case)
                # NaN in every block no live position references
                live = set()
                for b in range(B):
                    for j in range(-(-int(lens[b]) // bs)):
                        live.add(max(int(bt[b, j]), 0))
                dead = [x for x in range(nb) if x not in live]
                k2, v2 = k.clone(), v.clone()
                k2[dead] = float("nan")
                v2[dead] = float("nan")
                dirty = ops.paged_gqa_decode_attention(q, k2, v2, bt, lens)
                assert torch.equal(dirty, got), ("unreferenced NaN", case)
                n += 2
    # a pool view with a row stride of 264 bytes, and one 2 bytes past an
    # aligned address
    q, k, v, bt, lens = _paged_case(8, 16, 8, 96, 16, 24, 128,
                                    torch.bfloat16, gen, True)
    odd = torch.zeros((96, 8, 16, 132), dtype=torch.bfloat16,
                      device="cuda")[..., :128]
    raw = torch.zeros(k.numel() + 8, dtype=torch.bfloat16, device="cuda")
    refused = 0
    for bad in (odd, raw[1:1 + k.numel()].view(96, 8, 16, 128)):
        try:
            ops.paged_gqa_decode_attention(q, bad, bad, bt, lens)
        except ValueError:
            refused += 1
    assert refused == 2, refused
    row = {"phase": "paged_kernel", "cases": n, "max_abs_err": errs,
           "equal_to_decode_kernel": n_equal, "unaligned_refused": refused}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the session serving path with prefix reuse
# ---------------------------------------------------------------------------

def _teacher_forced(model, cfg, run):
    """Every served token of ``run`` a teacher-forced maximum of
    ``train_logits`` on the card; returns (tokens checked, worst gap)."""
    import torch
    from repro_torch.models import lm
    worst, n = 0.0, 0
    for rid, r in run.results.items():
        toks = r["tokens"]
        L = len(run.prompts[rid])
        seq = list(run.prompts[rid]) + toks[:-1]
        logits = lm.train_logits(model, cfg, torch.tensor(
            [seq], device="cuda"))[0][0, L - 1:]
        for j, t in enumerate(toks):
            ok, rel = _near_tie_ok(logits[j], t)
            assert ok, (rid, j, rel)
            worst = max(worst, rel)
            n += 1
        del logits
    return n, worst


def _median_extend_shape(run):
    """(S_pre buffer, padded suffix, prefix_len) of the cached run's median
    admission by prefix length, as the engine ran it."""
    e = run.engine.ecfg
    hits = sorted((r["cached_tokens"], len(run.prompts[rid]))
                  for rid, r in run.results.items() if r["cached_tokens"])
    plen, L = hits[len(hits) // 2]
    Sn_pad = min(-(-(L - plen) // e.prefill_bucket) * e.prefill_bucket,
                 e.max_seq)
    if plen + Sn_pad <= e.max_seq:          # the bucketed admission
        return (e.max_seq // e.block_size) * e.block_size, Sn_pad, plen
    return plen, L - plen, plen


def phase_serve_sessions(model, cfg):
    import torch
    from repro_torch import serve
    from repro_torch.serving import LLMEngine
    tr = serve.build_session_trace(serve.SessionConfig(), seed=0)
    # warm-up at the session engine's shapes (the first 6 requests)
    warm = LLMEngine(cfg, model, serve.SESSION_ENGINE, device="cuda")
    for rid, req in enumerate(tr.requests[:6]):
        warm.submit(rid, serve.tokenize(req, cfg.vocab), max_new_tokens=4)
    warm.run_to_completion(chunk=serve.CHUNK)
    del warm

    # with and without reuse in turns (on, off, off, on): the host's speed
    # drifts within a call, so each mode's mean spans the same window
    runs, out = {}, {"prefix_cache": [], "no_prefix_cache": []}
    for cache in (True, False, False, True):
        zero_launches()
        run = serve.run_serve(cfg=cfg, model=model, device="cuda",
                              sessions=True, prefix_cache=cache)
        e = run.engine
        launches = launch_counts(
            gqa_decode_attention=cfg.n_layers * e._steps,
            flash_attention=cfg.n_layers * e.admissions)
        assert sorted(run.results) == list(range(tr.n_requests))
        assert e.admissions == tr.n_requests
        for rid, r in run.results.items():
            assert len(r["tokens"]) == run.budgets[rid], rid
            assert all(0 <= t < cfg.vocab for t in r["tokens"]), rid
        tokens = sum(len(r["tokens"]) for r in run.results.values())
        runs.setdefault(cache, run)
        out["prefix_cache" if cache else "no_prefix_cache"].append({
            "launches": launches, "decode_iterations": e._steps,
            "admissions": e.admissions, "tokens": tokens,
            "wall_s": run.wall_s, "tokens_per_s": tokens / run.wall_s,
            "admission_ms_mean": 1e3 * e.prefill_seconds / e.admissions,
            "decode_iteration_ms_mean": 1e3 * e.decode_seconds / e._steps,
            "host_syncs": e.host_syncs, "qoe": e.qoe_summary(),
            "cache_stats": e.cache_stats()})
    means = {name: {k: statistics.mean(r[k] for r in rs)
                    for k in ("tokens_per_s", "admission_ms_mean",
                              "decode_iteration_ms_mean")}
             for name, rs in out.items()}
    cached, plain = runs[True], runs[False]
    st = cached.engine.cache_stats()
    assert st["lookups"] == tr.n_requests and st["evictions"] == 0
    assert st["prefill_tokens_run"] < st["prefill_tokens_total"]
    pool = cached.engine.kv.cache.pool
    leaked = int((pool.ref > 0).sum())
    assert leaked == 0, f"{leaked} blocks still pinned"
    cached.engine.kv.cache.check_invariants()
    print("\n".join(serve.format_run(cached)[:3] + ["  ..."]
                    + serve.format_run(cached)[-2:]), flush=True)

    checked = {}
    for name, run in (("prefix_cache", cached), ("no_prefix_cache", plain)):
        n_tok, worst = _teacher_forced(model, cfg, run)
        checked[name] = {"teacher_forced_tokens": n_tok,
                         "worst_gap_over_max_logit": worst}
    # where the two runs part, the uncached run's row is a near-tie
    from repro_torch.models import lm
    parts = []
    differing = 0
    for rid, want in plain.results.items():
        a, b = cached.results[rid]["tokens"], want["tokens"]
        differing += sum(x != y for x, y in zip(a, b))
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = list(plain.prompts[rid]) + b[:j]
        row = lm.train_logits(model, cfg, torch.tensor(
            [seq], device="cuda"))[0][0, -1]
        top2 = row.topk(2).values
        gap = float(top2[0] - top2[1]) / float(row.abs().max())
        parts.append({"request": rid, "position": j, "top2_gap": gap})
        assert gap < 2e-2, ("cached and uncached runs part away from a "
                            "near-tie", rid, j, gap)

    # one decode iteration with every slot busy, profiled
    prof_eng = LLMEngine(cfg, model, serve.SESSION_ENGINE, device="cuda")
    for rid, req in enumerate(tr.requests[:serve.SESSION_ENGINE.max_slots]):
        prof_eng.submit(rid, serve.tokenize(req, cfg.vocab),
                        max_new_tokens=64)
    prof = _profile_step(prof_eng)
    del prof_eng
    S_pre, Sq, plen = _median_extend_shape(cached)
    row = {"phase": "serve_sessions", "model": cfg.name,
           "engine": dataclasses.asdict(serve.SESSION_ENGINE),
           "chunk": serve.CHUNK, "requests": tr.n_requests,
           "prompt_tokens": st["prefill_tokens_total"], "runs": out,
           "means": means,
           "prefill_tokens_run_over_total": (st["prefill_tokens_run"]
                                             / st["prefill_tokens_total"]),
           "leaked_blocks": leaked, "checks": checked,
           "cached_vs_uncached": {"diverged_requests": len(parts),
                                  "differing_tokens": differing,
                                  "divergences": parts},
           "decode_iteration_profile": prof,
           "decode_at_profiled_iteration": decode_timing(
               prof["decode_kv_len"], Smax=serve.SESSION_ENGINE.max_seq),
           "flash_extend_at_median_admission": extend_timing(S_pre, Sq,
                                                             plen)}
    emit(row)
    return cached, row


def paged_bound(lens, B, mb, Hq=16, Hkv=8, D=128):
    """Least time of one paged decode call (bf16): q read and out written
    once, the K/V rows up to each kv_len read once, the table and kv_len
    read once; 4 * sum(kv_len) * Hq * D operations."""
    n_read = sum(lens)
    nbytes = 2 * (2 * B * Hq * D + 2 * n_read * Hkv * D) + 4 * B * mb + 4 * B
    ops_n = 4 * n_read * Hq * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_paged_on_pools(run, cfg):
    """The paged kernel over the pools the session run filled: block tables
    from each served prompt's cached blocks (``index.match``), 8 rows a
    batch, the last row ending mid-block; on every layer bit for bit equal
    to the decode kernel on the gathered cache, and against the plain
    version."""
    import torch
    from repro_torch.kernels import decode_attention, ops, ref
    store = run.engine.kv
    bs = store.block_size
    tables = [store.cache.index.match(run.prompts[rid])
              for rid in sorted(run.prompts)]
    tables = [t for t in tables if t]
    gen = torch.Generator().manual_seed(9)
    B = run.engine.ecfg.max_slots
    n = 0
    err = 0.0
    timing = None
    for i0 in range(0, len(tables), B):
        rows = tables[i0:i0 + B]
        mb = max(len(t) for t in rows)
        bt = torch.full((len(rows), mb), -1, dtype=torch.int32)
        for b, t in enumerate(rows):
            bt[b, :len(t)] = torch.tensor(t, dtype=torch.int32)
        lens = [len(t) * bs for t in rows]
        lens[-1] -= bs // 2
        bt, kl = bt.cuda(), torch.tensor(lens, dtype=torch.int32,
                                         device="cuda")
        gk, gv = (torch.stack([x[:, 0] for x in pair], dim=1)
                  for pair in zip(*(store.gather(t, pad_to=mb)
                                    for t in rows)))   # (L, B, S, H, D)
        for li in range(cfg.n_layers):
            q = torch.randn((len(rows), cfg.n_heads, cfg.hd),
                            generator=gen).to(store.k.dtype).cuda()
            kp = store.k[li].permute(0, 2, 1, 3)
            vp = store.v[li].permute(0, 2, 1, 3)
            got = ops.paged_gqa_decode_attention(q, kp, vp, bt, kl)
            torch.cuda.synchronize()
            dec_kv = (gk[li].permute(0, 2, 1, 3), gv[li].permute(0, 2, 1, 3))
            dec = ops.gqa_decode_attention(q, *dec_kv, kl)
            plain = ref.paged_gqa_decode(q, kp, vp, bt, kl)
            case = ("pools", i0, li)
            err = max(err, _check_close("paged on pools", got, plain,
                                        "bfloat16", case))
            assert torch.equal(got, dec), ("paged != decode on the gathered "
                                           "cache", case, _err(got, dec))
            n += 1
            if timing is None and len(rows) == B:
                bound, by = paged_bound(lens, B, mb, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd)
                timing = dict(
                    shape={"B": B, "Hq": cfg.n_heads, "Hkv": cfg.n_kv_heads,
                           "D": cfg.hd, "block_size": bs,
                           "n_blocks": store.k.shape[1], "max_blocks": mb,
                           "kv_len": lens, "dtype": "bfloat16",
                           "layout": "store (n_blocks, bs, Hkv, D)"},
                    ms=time_ms(ops.paged_gqa_decode_attention, q, kp, vp, bt,
                               kl),
                    device_ms=device_kernel_ms(
                        ops.paged_gqa_decode_attention, q, kp, vp, bt, kl,
                        name=PAGED_KERNEL),
                    plain_ms=time_ms(ref.paged_gqa_decode, q, kp, vp, bt, kl),
                    decode_kernel_on_gathered_ms=time_ms(
                        ops.gqa_decode_attention, q, *dec_kv, kl),
                    decode_kernel_on_gathered_device_ms=device_kernel_ms(
                        ops.gqa_decode_attention, q, *dec_kv, kl,
                        name=DECODE_KERNEL),
                    bound_ms=bound, bound_by=by, library_ms=None)
                span, splits = decode_attention.decode_split(
                    B, cfg.n_kv_heads, mb * bs, torch.cuda
                    .get_device_properties(0).multi_processor_count)
                grids, windows = device_kernel_grids(
                    ops.paged_gqa_decode_attention, q, kp, vp, bt, kl,
                    name=PAGED_KERNEL)
                assert grids and set(grids) == {
                    (splits, cfg.n_kv_heads, B)}, (grids, splits, windows)
                timing.update(span=span, splits=splits,
                              blocks_per_call=splits * cfg.n_kv_heads * B,
                              grid_profile_windows=windows)
    assert n and timing is not None
    row = {"phase": "paged_on_pools", "prompts": len(tables),
           "calls": n, "layers": cfg.n_layers, "max_abs_err": err,
           "equal_to_decode_kernel": n, "timing": timing,
           "library": "none: no PyTorch call reads a block table"}
    emit(row)
    return row



# ---------------------------------------------------------------------------
# the cluster server end to end
# ---------------------------------------------------------------------------

def _served_by(srv, rid, res):
    """The pair whose engine produced the result ``res`` of request
    ``rid``."""
    return next(p for p, e in srv.engines.items()
                if e.results.get(rid) is res)


def _cluster_teacher_forced(run):
    """Every served token of a launcher run a teacher-forced maximum of its
    pair's model (``train_logits`` on the card); (tokens checked, worst gap
    over max|logit|)."""
    import torch
    from repro_torch.models import lm
    srv, worst, n = run.server, 0.0, 0
    for rid, r in run.done.items():
        e = srv.engines[_served_by(srv, rid, r)]
        prompt = srv._tokenize(run.trace.requests[rid], e.cfg.vocab)
        seq = list(prompt) + r["tokens"][:-1]
        logits = lm.train_logits(e.model, e.cfg, torch.tensor(
            [seq], device="cuda"))[0][0, len(prompt) - 1:]
        for j, t in enumerate(r["tokens"]):
            ok, rel = _near_tie_ok(logits[j], t)
            assert ok, (rid, j, rel)
            worst = max(worst, rel)
            n += 1
        del logits
    return n, worst


def _own_tokens(e):
    """Tokens an engine emitted in its own decodes: an adopted engine's
    count less what its cohort's dispatches committed for it."""
    if e._fleet is None:
        return e.tokens_emitted
    cohort, m = e._fleet
    return e.tokens_emitted - int(cohort.counters.emitted[m])


def _cluster_accounting(run):
    """Completion, conservation, drained queues, the fleet counters against
    the engines, and the failed node (the only node down) left with no
    served request, its failures the reroutes."""
    srv = run.server
    assert sorted(run.done) == list(range(CLUSTER_REQUESTS))
    for rid, r in run.done.items():
        assert len(r["tokens"]) == run.budgets[rid], rid
    for node, s in srv.monitor.stats.items():
        assert s.total_dispatched == (s.total_completed + s.total_failed
                                      + s.total_cancelled), (node, s)
        assert s.outstanding == 0, (node, s)
    st = srv.stats()
    assert all(q == 0 for q in st["queue_lengths"]), st["queue_lengths"]
    assert st["active"] == st["queued"] == 0
    engines = list(srv.engines.values())
    assert st["active"] == sum(e.active_count for e in engines)
    emitted = sum(e.tokens_emitted for e in engines)
    assert st["fleet"]["emitted"] == sum(c["emitted"] for c in st["cohorts"])
    own = [_own_tokens(e) for e in engines]
    # an engine emits tokens of its own only in decodes of its own
    for e, n in zip(engines, own):
        assert 0 <= n <= e.decode_iterations * e.ecfg.max_slots, (n, e)
    # no prefix cache at these engines: the check holds only vacuously
    leaked = sum(int((e.kv.cache.pool.ref > 0).sum()) for e in engines
                 if e.kv is not None)
    assert leaked == 0
    assert srv._down_nodes == {CLUSTER_FAIL[0]}, srv._down_nodes
    pair_node = srv.router.arrays.pair_node
    served_on = {int(pair_node[_served_by(srv, rid, r)])
                 for rid, r in run.done.items()}
    assert CLUSTER_FAIL[0] not in served_on, served_on
    assert (srv.monitor.stats[CLUSTER_FAIL[0]].total_failed
            == st["reroutes"]), st["reroutes"]
    return st, emitted, sum(own), leaked


def _cluster_launches(srv, tuned):
    """The run's launches, held to the arithmetic: dominance 1 + generations
    when tuned, flash n_layers per admission, decode n_layers per cohort
    iteration plus per engine-own iteration."""
    engines = list(srv.engines.values())
    return launch_counts(
        dominance_matrix=1 + CLUSTER_GENS if tuned else 0,
        flash_attention=sum(e.cfg.n_layers * e.admissions for e in engines),
        gqa_decode_attention=(
            sum(c.cfg.n_layers * c.counters.iterations for c in srv._cohorts)
            + sum(e.cfg.n_layers * e.decode_iterations for e in engines)))


def _parting(e, prompt, ta, tb, **key):
    """Where two token streams of one request first part, both tokens are
    near-tie maxima of the model's logits there (teacher forcing on the
    card); the parting with its top-2 gap over max|logit|."""
    import torch
    from repro_torch.models import lm
    j = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
    row = lm.train_logits(e.model, e.cfg, torch.tensor(
        [list(prompt) + list(ta[:j])], device="cuda"))[0][0, -1]
    for t in (ta[j], tb[j]):
        ok, rel = _near_tie_ok(row, t)
        assert ok, ("token streams part away from a near-tie", key, j, t,
                    rel)
    top2 = row.topk(2).values
    return dict(key, position=j,
                top2_gap=float(top2[0] - top2[1]) / float(row.abs().max()))


def _saturated_server(models, fleet):
    """A full-width server with every slot of every engine busy (64-token
    budgets), admitted directly on each pair."""
    from repro_torch.core.policies.threshold import PAPER_DEFAULTS
    from repro_torch.launch import serve as launch
    from repro_torch.serving import ClusterServer, ServeRequest
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.workload.trace import build_trace
    srv = ClusterServer(paper_testbed(), models, PAPER_DEFAULTS,
                        launch.FULL_ENGINE, hedge_after=10 ** 9,
                        fleet=fleet, device="cuda")
    tr = build_trace(64, seed=0)
    rid = 0
    for pair in srv.engines:
        for _ in range(launch.FULL_ENGINE.max_slots):
            srv._dispatch(ServeRequest(request_id=rid,
                                       req=tr.requests[rid % 64],
                                       max_new_tokens=64), pair)
            rid += 1
    assert all(e.active_count == launch.FULL_ENGINE.max_slots
               for e in srv.engines.values())
    return srv


def _saturated_partings(a, b):
    """Every slot's generated tokens of two saturated servers that took the
    same requests and ticks (fleet on and off): the same lengths, parting
    only at near-ties. Returns (tokens compared, partings)."""
    from repro_torch.workload.trace import build_trace
    tr = build_trace(64, seed=0)
    n, parts = 0, []
    for pair, ea in a.engines.items():
        eb = b.engines[pair]
        for sa, sb in zip(ea.slots, eb.slots):
            assert sa.request_id == sb.request_id, pair
            ta, tb = sa.generated, sb.generated
            assert len(ta) == len(tb), (pair, sa.request_id)
            n += len(ta)
            if ta != tb:
                prompt = a._tokenize(tr.requests[sa.request_id % 64],
                                     ea.cfg.vocab)
                parts.append(_parting(ea, prompt, ta, tb, pair=pair,
                                      request=sa.request_id))
    return n, parts


def _tick_walls(srv, n=5):
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _profile_tick(srv, wall):
    """One saturated tick profiled: the card's busy time against ``wall``,
    the median host time of an unprofiled tick (the profiler inflates the
    host's), and the top device and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name, host = Counter(), Counter()
    n_events = 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by_name[ev.name[:60]] += ev.time_range.elapsed_us()
            n_events += 1
        else:
            host[ev.name[:60]] += ev.self_cpu_time_total
    busy = sum(by_name.values()) / 1e6 if n_events else None
    return {"tick_wall_s": wall, "profiled_tick_wall_s": prof_wall,
            "device_busy_s": busy, "idle_share": _idle(busy, wall),
            "device_events": n_events,
            "top_device_us": by_name.most_common(8),
            "top_host_self_us": host.most_common(8)}


def _check_models():
    """The launcher's model map at full width and 2 layers a model."""
    from repro_torch import serve
    from repro_torch.configs import get
    from repro_torch.launch import serve as launch
    models = {}
    for names, arch, seed in ((launch.CLOUD_NAMES, launch.CLOUD_MODEL, 0),
                              (launch.EDGE_NAMES, launch.EDGE_MODEL, 1)):
        cfg = dataclasses.replace(get(arch).config(),
                                  n_layers=CHECK_LAYERS)
        m = serve.build_model(cfg, "cuda", seed=seed)
        models.update({n: (cfg, m) for n in names})
    return models


def _fleet_vs_engines(models, thresholds):
    """The launcher's run on ``models``, fleet on and off, on the card:
    the same routing decisions, QoE records and token counts, node 1 the
    only node down with its failures the reroutes; tokens may part only at
    near-ties (teacher forcing on the card)."""
    from repro_torch.launch import serve as launch
    from repro_torch.obs import Obs
    runs = {}
    for fleet in (True, False):
        o = Obs()
        runs[fleet] = (launch.run_launch(
            CLUSTER_REQUESTS, device="cuda", models=models,
            thresholds=thresholds, fail_node=CLUSTER_FAIL[0],
            fail_at=CLUSTER_FAIL[1], fleet=fleet, obs=o), o)
    (a, oa), (b, ob) = runs[True], runs[False]
    assert [r.key() for r in oa.audit.records()] == \
        [r.key() for r in ob.audit.records()]
    assert sorted(a.done) == sorted(b.done)
    sa, sb = a.server.stats(), b.server.stats()
    for k in sa:
        if k not in ("cohorts", "decode_dispatches", "fleet"):
            assert sa[k] == sb[k], k
    for srv in (a.server, b.server):
        assert srv._down_nodes == {CLUSTER_FAIL[0]}, srv._down_nodes
    assert (a.server.monitor.stats[CLUSTER_FAIL[0]].total_failed
            == sa["reroutes"]), sa["reroutes"]
    parts, differing = [], 0
    for rid, ra in a.done.items():
        rb = b.done[rid]
        assert {k: v for k, v in ra.items() if k != "tokens"} == \
            {k: v for k, v in rb.items() if k != "tokens"}, rid
        ta, tb = ra["tokens"], rb["tokens"]
        assert len(ta) == len(tb), rid
        differing += sum(x != y for x, y in zip(ta, tb))
        if ta != tb:
            e = a.server.engines[_served_by(a.server, rid, ra)]
            prompt = a.server._tokenize(a.trace.requests[rid], e.cfg.vocab)
            parts.append(_parting(e, prompt, ta, tb, request=rid))
    return {"layers": CHECK_LAYERS, "requests": len(a.done),
            "reroutes": sa["reroutes"], "hedges": sa["hedges"],
            "route_decisions": len(oa.audit),
            "tokens": sum(len(r["tokens"]) for r in a.done.values()),
            "fleet_decode_dispatches": sa["decode_dispatches"],
            "engine_decode_dispatches": sb["decode_dispatches"],
            "fleet_wall_s": a.wall_s, "engine_wall_s": b.wall_s,
            "diverged_requests": len(parts), "differing_tokens": differing,
            "divergences": parts}


def _served_summary(run, st, emitted, own):
    srv = run.server
    tokens = sum(len(r["tokens"]) for r in run.done.values())
    return {"requests": len(run.done), "tokens": tokens,
            "wall_s": run.wall_s, "tokens_per_s": tokens / run.wall_s,
            "ticks": srv.ticks, "reroutes": st["reroutes"],
            "hedges": st["hedges"], "cancelled": st["cancelled"],
            "decode_dispatches": st["decode_dispatches"],
            "cohort_participants": [int(x) for x in srv.metrics.counter(
                "cohort_participants").values],
            "fleet": st["fleet"], "engine_tokens_emitted": emitted,
            "engine_own_tokens_emitted": own,
            "percentiles": {k: st["percentiles"][k]
                            for k in ("latency", "ttft", "tpot")}}


def _cohort_rows(srv):
    return [{"model": c.cfg.name, "layers": c.cfg.n_layers,
             "members": len(c), "rows": len(c) * c.ecfg.max_slots,
             "dispatches": c.counters.dispatches,
             "iterations": c.counters.iterations,
             "emitted": int(c.counters.emitted.sum()),
             "decode_ms_per_iteration": (
                 1e3 * c.counters.decode_seconds / c.counters.iterations
                 if c.counters.iterations else None)}
            for c in srv._cohorts]


def phase_cluster():
    import torch
    from repro_torch.core.policies.threshold import PAPER_DEFAULTS
    from repro_torch.launch import serve as launch
    t0 = time.perf_counter()
    models = launch.build_models("cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # warm-up: both models admit and decode at the engines' shapes
    launch.run_launch(4, device="cuda", models=models)
    torch.cuda.reset_peak_memory_stats()

    # run A: the launcher's tuned router
    zero_launches()
    run = launch.run_launch(CLUSTER_REQUESTS, device="cuda",
                            optimize_router=True, generations=CLUSTER_GENS,
                            fail_node=CLUSTER_FAIL[0],
                            fail_at=CLUSTER_FAIL[1], models=models)
    srv = run.server
    engines = list(srv.engines.values())
    launches = _cluster_launches(srv, tuned=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st, emitted, own, leaked = _cluster_accounting(run)
    n_tok, worst = _cluster_teacher_forced(run)
    by_model = {}
    for e in engines:
        m = by_model.setdefault(e.cfg.name, {
            "layers": e.cfg.n_layers, "engines": 0, "admissions": 0,
            "own_decode_iterations": 0, "prefill_s": 0.0})
        m["engines"] += 1
        m["admissions"] += e.admissions
        m["own_decode_iterations"] += e.decode_iterations
        m["prefill_s"] += e.prefill_seconds
    cohorts = _cohort_rows(srv)
    served = _served_summary(run, st, emitted, own)
    served.update(tuning_s=run.tuned.seconds,
                  thresholds=[float(x) for x in run.tuned.thresholds],
                  objectives=[float(x) for x in run.tuned.objectives])
    thresholds = run.tuned.thresholds
    print(f"cluster: {len(run.done)} requests, {served['tokens']} tokens "
          f"in {run.wall_s:.3f} s, {srv.ticks} ticks, reroutes "
          f"{st['reroutes']}, hedges {st['hedges']}", flush=True)
    del run, srv, engines

    # run B: the paper's default thresholds, which send node 1 traffic, so
    # its failure cancels and re-routes live flights
    zero_launches()
    run = launch.run_launch(CLUSTER_REQUESTS, device="cuda",
                            thresholds=PAPER_DEFAULTS,
                            fail_node=CLUSTER_FAIL[0],
                            fail_at=CLUSTER_FAIL[1], models=models)
    launches_b = _cluster_launches(run.server, tuned=False)
    st_b, emitted_b, own_b, _ = _cluster_accounting(run)
    assert st_b["reroutes"] > 0, "node 1 held no flight when it failed"
    n_tok_b, worst_b = _cluster_teacher_forced(run)
    served_b = _served_summary(run, st_b, emitted_b, own_b)
    served_b.update(cohorts=_cohort_rows(run.server),
                    teacher_forced_tokens=n_tok_b,
                    worst_gap_over_max_logit=worst_b, launches=launches_b)
    print(f"cluster, paper defaults: {served_b['tokens']} tokens in "
          f"{run.wall_s:.3f} s, reroutes {st_b['reroutes']}, hedges "
          f"{st_b['hedges']}", flush=True)
    del run

    # a saturated tick, fleet against the per-engine loop, in turns
    walls = {True: [], False: []}
    sat = {f: _saturated_server(models, f) for f in (True, False)}
    for f in (True, False, False, True):
        walls[f] += _tick_walls(sat[f], n=3)
    sat_tokens, sat_parts = _saturated_partings(sat[True], sat[False])
    fsrv = sat[True]
    edge = max(fsrv._cohorts, key=len)
    cloud = min(fsrv._cohorts, key=len)
    lens = (edge.state.cache.kv_len + 1).tolist()   # the profiled tick's
    cloud_lens = (cloud.state.cache.kv_len + 1).tolist()
    prof = _profile_tick(fsrv, statistics.median(walls[True]))
    prof.update(decode_kv_len=lens, cloud_decode_kv_len=cloud_lens)
    del sat, fsrv
    Smax = launch.FULL_ENGINE.max_seq
    dec = decode_timing(lens, Smax=Smax, Hq=edge.cfg.n_heads,
                        Hkv=edge.cfg.n_kv_heads, D=edge.cfg.hd)
    dec_cloud = decode_timing(cloud_lens, Smax=Smax, Hq=cloud.cfg.n_heads,
                              Hkv=cloud.cfg.n_kv_heads, D=cloud.cfg.hd)
    del edge, cloud
    small = _check_models()
    check = {"tuned": _fleet_vs_engines(small, thresholds),
             "paper_defaults": _fleet_vs_engines(small, PAPER_DEFAULTS)}
    assert check["paper_defaults"]["reroutes"] > 0
    del small
    total = {k: launches[k] + launches_b[k] for k in launches}
    row = {"phase": "cluster", "requests": CLUSTER_REQUESTS,
           "models": {c.name: {"layers": c.n_layers,
                               "params": c.param_counts()["total"]}
                      for c, _ in models.values()},
           "engine": dataclasses.asdict(launch.FULL_ENGINE),
           "chunk": launch.FULL_CHUNK, "generations": CLUSTER_GENS,
           "pop": launch.POP, "fail_node_after": list(CLUSTER_FAIL),
           "init_s": init_s, "launches": total, "launches_tuned": launches,
           "served": served, "by_model": by_model, "cohorts": cohorts,
           "served_paper_defaults": served_b,
           "leaked_blocks": leaked, "teacher_forced_tokens": n_tok,
           "worst_gap_over_max_logit": worst, "peak_memory_gb": peak_gb,
           "saturated_tick_s": {
               "fleet": walls[True], "per_engine": walls[False],
               "fleet_median": statistics.median(walls[True]),
               "per_engine_median": statistics.median(walls[False])},
           "saturated_tokens_compared": sat_tokens,
           "saturated_partings": sat_parts,
           "saturated_tick_profile": prof,
           "decode_at_cohort_rows": dec, "decode_at_cloud_rows": dec_cloud,
           "fleet_vs_per_engine": check}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the non-dense families in the serving engine
# ---------------------------------------------------------------------------

def _moe_routing(fn, *args, **kw):
    """(fn's result, [(choices, drops)] of every ``moe_apply`` it ran)."""
    from repro_torch.models import moe
    moe.ROUTING = []
    try:
        out = fn(*args, **kw)
        rec = [(e, int(d)) for e, d in moe.ROUTING]
    finally:
        moe.ROUTING = None
    return out, rec


def _per_layer(rec, n_moe):
    """Calls recorded over a prefill and its decode steps (one call a MoE
    layer a pass, in layer order) -> each layer's choices by position."""
    import torch
    return [torch.cat([e for e, _ in rec[i::n_moe]]) for i in range(n_moe)]


def _first_routing_parting(a, b):
    """First position whose expert set differs in any layer, or None."""
    import torch
    firsts = []
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        diff = (torch.sort(x[:n], -1).values
                != torch.sort(y[:n], -1).values).any(-1).nonzero()
        if len(diff):
            firsts.append(int(diff[0]))
    return min(firsts) if firsts else None


def _family_replay(model, cfg, prompt, toks, cross):
    """Prefill the prompt, then decode ``toks`` one by one (B = 1): the
    logits of every step (the prefill's last row first) and the routing
    of every ``moe_apply``."""
    import torch
    from repro_torch.models import lm

    def run():
        x = torch.tensor([list(prompt)], device="cuda")
        logits, cache = lm.prefill(model, cfg, x,
                                   max_seq=len(prompt) + len(toks), **cross)
        rows = [logits[0]]
        for t in toks:
            logits, cache = lm.decode_step(
                model, cfg, torch.tensor([[t]], device="cuda"), cache)
            rows.append(logits[0])
        return torch.stack(rows)

    return _moe_routing(run)


def _family_full(model, cfg, seq, cross):
    """``train_logits`` over ``seq`` (B = 1) and its routing."""
    import torch
    from repro_torch.models import lm
    (logits, _), rec = _moe_routing(lm.train_logits, model, cfg,
                                    torch.tensor([list(seq)], device="cuda"),
                                    **cross)
    return logits[0], rec


def _served_routing(routing, prompts, n_moe):
    """Each request's expert choices by layer and position on the served
    path, from the calls recorded over the run: the admissions first (the
    8 requests, admitted at submission into slots 0-7 in order), then the
    decode iterations over all 8 rows (row = slot)."""
    import torch
    rids = sorted(prompts)
    adm = routing[:len(rids) * n_moe]
    dec = routing[len(rids) * n_moe:]
    out = {}
    for s, rid in enumerate(rids):
        pre = adm[s * n_moe:(s + 1) * n_moe]
        assert all(len(e) == len(prompts[rid]) for e, _ in pre)
        out[rid] = [torch.cat([pre[i][0]] + [e[s:s + 1] for e, _ in
                                             dec[i::n_moe]])
                    for i in range(n_moe)]
    return out


def _family_check(model, cfg, prompts, results, extras, n_moe, served,
                  strict=True):
    """Each request replayed alone (B = 1: the prompt prefilled, then its
    served tokens decoded one by one) and run as a full forward
    (``train_logits`` over the prompt and the tokens before the last).

    * Every served token is a near-tie maximum of the replay's logits: the
      engine (batching, slot splices, state carried) serves what the model
      computes for the request alone.
    * Every served token is a near-tie maximum of the full forward, except
      in a MoE request whose full forward or admission prefill drops an
      assignment (capacity depends on the token count, so the passes
      compute different functions: reported). Decode at 8 rows drops
      nothing (capacity >= 8), so the replay drops what the admission
      dropped.
    * For MoE, a token off either near tie is accepted only at or after
      the first position that the two passes compared route to other
      experts (``served``: the choices recorded over the run, against the
      replay's, and the replay's against the full forward's): bf16
      activations rounded at other places by GEMMs of other shapes tip a
      near-tie of router probabilities, and the token that takes another
      expert moves by O(1). Each such parting is reported.
    * The replay's first 4 rows (the prefill's last, 3 decode steps)
      against the full forward's, within 5e-2 of the row's max|logit|, for
      the first two requests without drops, the MoE rows before the first
      routing parting: bf16 activations (8 mantissa bits) are rounded at
      other places by the two passes (the decode kernel against flash, the
      recurrent step against the chunked scan, GEMMs of other shapes) over
      up to 48 layers. Without such a request the same on a 5-token prompt
      of the first request with 3 greedy steps: 8 tokens, which no
      capacity can drop.

    ``strict=False`` asserts nothing and reports what would not hold: for
    xLSTM in bf16, whose random-weight recurrences turn bf16 rounding into
    diverging tokens (``phase_families`` holds it in f32 instead)."""
    out = {"tokens": 0, "held_replay": 0, "held_full_forward": 0,
           "not_held": [], "routing_partings": [],
           "worst_gap_over_max_logit": {"replay": 0.0, "full_forward": 0.0},
           "drops": {}, "logits_vs_full": []}

    def parting(a, b):
        return (_first_routing_parting(_per_layer(a, n_moe),
                                       _per_layer(b, n_moe))
                if n_moe else None)

    def window(label, prompt, rows, full, rrec, rec):
        p = parting(rrec, rec)
        n = 4 if p is None else min(4, p - (len(prompt) - 1))
        err = _row_errors(rows[:max(n, 0)], full[:max(n, 0)])
        assert not strict or all(e <= 5e-2 for e in err), (cfg.name, label,
                                                           err)
        if n > 0:
            out["logits_vs_full"].append({
                "request": label, "prompt_tokens": len(prompt),
                "rows_held": n, "first_routing_parting": p,
                "max_err_over_max_logit": max(err)})

    def hold(rid, j, against, row, t, first_parting, pos):
        ok, rel = _near_tie_ok(row, t)
        if ok:
            out["held_" + against] += 1
            worst = out["worst_gap_over_max_logit"]
            worst[against] = max(worst[against], rel)
            return
        entry = {"request": rid, "token": j, "against": against,
                 "gap": rel, "first_routing_parting": first_parting}
        if first_parting is not None and first_parting <= pos:
            out["routing_partings"].append(entry)
            return
        assert not strict, (cfg.name, entry)
        out["not_held"].append(entry)

    for rid, r in sorted(results.items()):
        toks, prompt, cross = r["tokens"], prompts[rid], extras[rid]
        L = len(prompt)
        rows, rrec = _family_replay(model, cfg, prompt, toks[:-1], cross)
        full, rec = _family_full(model, cfg, list(prompt) + toks[:-1], cross)
        full = full[L - 1:]
        drops = 0
        p_served = p_full = None
        if n_moe:
            d = {"full_forward": sum(x for _, x in rec),
                 "admission_prefill": sum(x for _, x in rrec[:n_moe])}
            out["drops"][rid] = d
            drops = sum(d.values())
            p_served = _first_routing_parting(served[rid],
                                              _per_layer(rrec, n_moe))
            p_full = parting(rrec, rec)
        for j, t in enumerate(toks):
            out["tokens"] += 1
            hold(rid, j, "replay", rows[j], t, p_served, L - 1 + j)
            if not drops:
                both = [p for p in (p_served, p_full) if p is not None]
                hold(rid, j, "full_forward", full[j], t,
                     min(both) if both else None, L - 1 + j)
        if not drops and len(out["logits_vs_full"]) < 2:
            window(rid, prompt, rows, full, rrec, rec)
    if not out["logits_vs_full"]:
        rid = min(prompts)
        prompt, toks = prompts[rid][:5], []
        for _ in range(3):
            rows, _ = _family_replay(model, cfg, prompt, toks, extras[rid])
            toks.append(int(rows[-1].argmax()))
        rows, rrec = _family_replay(model, cfg, prompt, toks[:3],
                                    extras[rid])
        full, rec = _family_full(model, cfg, list(prompt) + toks[:3],
                                 extras[rid])
        window(f"{rid}, first 5 tokens", prompt, rows, full[4:], rrec, rec)
    assert out["logits_vs_full"] or not strict, cfg.name
    return out


def _row_errors(rows, full):
    """Per row: max |rows - full| over the row's max |full|."""
    return ((rows - full).abs().amax(-1) / full.abs().amax(-1)).tolist()


def _slstm_share(model, cfg, prompt):
    """Seconds of one admission-sized prefill, and of its sLSTM layers (the
    card synchronized around each, so the share is of host-bound time)."""
    import torch
    from repro_torch.models import lm
    orig = lm._FULL["slstm"]
    spent = []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    x = torch.tensor([list(prompt)], device="cuda")
    lm._FULL["slstm"] = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(model, cfg, x, max_seq=len(prompt))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        lm._FULL["slstm"] = orig
    return {"prompt_tokens": len(prompt), "prefill_s": total,
            "slstm_s": sum(spent), "slstm_layers": len(spent),
            "slstm_share": sum(spent) / total}


def _family_model(name, n_layers, trace, seed, dtype="bfloat16",
                  strict=True, measure=True):
    """One family at its published widths, ``n_layers`` deep: built from
    random weights in ``dtype``, its parameters held against the
    reference's arithmetic, 8 requests served through ``LLMEngine`` with
    seeded frames or patches, launches held to the counts, tokens checked
    (``_family_check``, ``strict``); with ``measure``, one decode iteration
    profiled and the sLSTM layers' share of an admission."""
    import gc
    import torch
    from repro_torch import serve
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.serving import EngineConfig, LLMEngine
    full_cfg = get(name).config()
    cfg = dataclasses.replace(full_cfg, n_layers=n_layers, dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build_model(cfg, "cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    built = sum(p.numel() for p in model.parameters())
    counted = cfg.param_counts()["total"]
    assert built == counted + uncounted_params(cfg), (name, built, counted)
    ecfg = EngineConfig(**FAMILY_ENGINE)
    prompts = {rid: serve.tokenize(req, cfg.vocab)
               for rid, req in enumerate(trace.requests[:FAMILY_REQUESTS])}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    extras = {rid: ({key: torch.randn(
        (1, cfg.cross_kv_tokens, cfg.d_model), generator=gen,
        device="cuda").to(torch.bfloat16)} if key else {})
        for rid in prompts}
    n_self = lm.n_attn(cfg)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    n_moe = sum(f == "moe" for _, f in (cfg.block_at(i)
                                        for i in range(cfg.n_layers)))
    # warm-up: one short request (first calls of cuBLAS and allocations)
    warm = LLMEngine(cfg, model, ecfg, device="cuda")
    warm.submit(0, prompts[0][:8], max_new_tokens=2, extra=extras[0])
    warm.run_to_completion(chunk=FAMILY_CHUNK)
    del warm

    eng = LLMEngine(cfg, model, ecfg, device="cuda")
    zero_launches()
    (results, wall), routing = _moe_routing(_family_serve, eng, prompts,
                                            extras)
    launches = launch_counts(
        flash_attention=(n_self + n_enc) * eng.admissions,
        gqa_decode_attention=n_self * eng.decode_iterations)
    assert sorted(results) == sorted(prompts)
    for r in results.values():
        assert len(r["tokens"]) == FAMILY_BUDGET
        assert all(0 <= t < cfg.vocab for t in r["tokens"])
    tokens = sum(len(r["tokens"]) for r in results.values())
    peak = torch.cuda.max_memory_allocated() / 1e9
    served = _served_routing(routing, prompts, n_moe) if n_moe else None
    check = _family_check(model, cfg, prompts, results, extras, n_moe,
                          served, strict)
    if n_moe:   # decode at 8 rows keeps every assignment (C >= 8)
        served = sum(d for _, d in routing)
        assert served == sum(v["admission_prefill"]
                             for v in check["drops"].values()), served
        check["drops_served"] = served
    row = {"model": name, "family": cfg.family, "dtype": dtype,
           "layers_built": n_layers, "layers_published": full_cfg.n_layers,
           "reduced": ({"n_layers": [full_cfg.n_layers, n_layers]}
                       if n_layers != full_cfg.n_layers else {}),
           "params_built": built, "params_counted": counted,
           "params_uncounted": uncounted_params(cfg),
           "params_published": full_cfg.param_counts()["total"],
           "self_attention_layers": n_self, "encoder_layers": n_enc,
           "moe_layers": n_moe, "init_s": init_s,
           "requests": len(results), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "admissions": eng.admissions,
           "decode_iterations": eng.decode_iterations,
           "prefill_ms_mean": 1e3 * eng.prefill_seconds / eng.admissions,
           "decode_iteration_ms_mean":
               1e3 * eng.decode_seconds / eng.decode_iterations,
           "launches": launches, "check": check, "peak_memory_gb": peak}
    if measure:
        # one decode iteration with every slot busy, profiled
        prof_eng = LLMEngine(cfg, model, ecfg, device="cuda")
        for rid, p in prompts.items():
            prof_eng.submit(rid, p, max_new_tokens=64, extra=extras[rid])
        row["decode_iteration_profile"] = _profile_step(prof_eng)
        del prof_eng
        if any(cfg.block_at(i)[0] == "slstm" for i in range(cfg.n_layers)):
            row["slstm"] = _slstm_share(model, cfg, prompts[0])
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _family_serve(eng, prompts, extras):
    """Submit every request, drain in chunks; (results, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=FAMILY_BUDGET, extra=extras[rid])
    results = eng.run_to_completion(chunk=FAMILY_CHUNK)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def check_family_shapes():
    """The flash and decode kernels against their plain versions at the
    shapes the families bring: group sizes 5 (llama4's 40 / 8 heads) and
    6 (dbrx's 48 / 8) at head dim 128, and whisper's 6 heads of 64,
    non-causal over its encoder's 1,504 frames (tiles ragged at the end)
    and causal in its decoder; f32 and bf16, decode also with the cache
    past kv_len filled with NaN (output bit for bit unchanged)."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(16)
    errs = {"flash": {k: 0.0 for k in TOL}, "decode": {k: 0.0 for k in TOL}}
    n = 0
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D, S, causal in FAMILY_FLASH:
            q, k, v = (torch.randn((1, S, h, D), generator=gen).to(dt)
                       .cuda().transpose(1, 2) for h in (Hq, Hkv, Hkv))
            got = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            case = (dname, Hq, Hkv, D, S, causal)
            errs["flash"][dname] = max(errs["flash"][dname], _check_close(
                "flash", got, ref.mha_prefill(q, k, v, causal=causal),
                dname, case))
            n += 1
        for Hq, Hkv, D in FAMILY_DECODE_HEADS:
            Smax = FAMILY_ENGINE["max_seq"]
            lens = [1, 63, 64, 65, 0, Smax, Smax + 25, 141]
            q, k, v, kl = _dec_case(8, Hq, Hkv, D, Smax, lens, dt, gen, True)
            got = ops.gqa_decode_attention(q, k, v, kl)
            torch.cuda.synchronize()
            case = (dname, Hq, Hkv, D, Smax, lens)
            errs["decode"][dname] = max(errs["decode"][dname], _check_close(
                "decode", got, ref.gqa_decode(q, k, v, kl), dname, case))
            assert not got[4].any(), ("kv_len 0", case)
            k2, v2 = k.clone(), v.clone()
            for b, x in enumerate(lens):
                k2[b, :, x:] = float("nan")
                v2[b, :, x:] = float("nan")
            assert torch.equal(ops.gqa_decode_attention(q, k2, v2, kl), got)
            n += 2
    return n, errs


def family_kernel_shapes():
    """``check_family_shapes`` and the two kernels timed at those shapes
    beside their plain versions, SDPA and their bounds (run in a fresh
    process by ``phase_families``, whose profiler is then reliable)."""
    n, errs = check_family_shapes()
    lens = [64, 100, 131, 77, 90, 120, 55, 141]
    Smax = FAMILY_ENGINE["max_seq"]
    return {"cases": n, "max_abs_err": errs,
            "flash_g5_s128": flash_timing(128, True, 1, 40, 8, 128),
            "flash_g6_s128": flash_timing(128, True, 1, 48, 8, 128),
            "flash_hd64_s1504_noncausal": flash_timing(1504, False, 1, 6, 6,
                                                       64),
            "decode_g5": decode_timing(lens, Smax, 40, 8, 128),
            "decode_g6": decode_timing(lens, Smax, 48, 8, 128),
            "decode_hd64": decode_timing(lens, Smax, 6, 6, 64)}


def phase_families():
    """Phase 16: every non-dense family through ``LLMEngine`` at its
    published widths, then the attention kernels at the shapes they
    bring."""
    from repro_torch import serve
    trace = serve.build_trace(500, seed=0)
    models = []
    for i, (name, n_layers) in enumerate(FAMILIES):
        t0 = time.perf_counter()
        f32 = name in FAMILY_F32_CHECK
        row = _family_model(name, n_layers, trace, seed=i, strict=not f32)
        if f32:
            row["f32_check"] = _family_model(name, n_layers, trace, seed=i,
                                             dtype="float32", measure=False)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps({k: row[k] for k in (
            "model", "layers_built", "params_built", "tokens_per_s",
            "launches", "seconds")}), flush=True)
        models.append(row)
    row = {"phase": "families", "engine": FAMILY_ENGINE,
           "budget": FAMILY_BUDGET, "chunk": FAMILY_CHUNK,
           "models": models,
           "kernel_shapes": in_fresh_process(
               "chip_smoke.family_kernel_shapes()"),
           "launches": {k: sum(m["launches"][k] for m in models)
                        for k in ("flash_attention", "gqa_decode_attention")}}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 17: training
# ---------------------------------------------------------------------------

def _bwd_inputs(B, Hq, Hkv, D, S, dt, gen, pad=0, junk=0.0):
    """q, k, v and dO in the model's layout ((B, S, H, D) buffers viewed as
    (B, H, S, D)); with ``pad``, each the first S rows of a buffer of S +
    pad rows whose rows past S hold ``junk`` (sign alternating)."""
    import torch
    out = []
    for i, h in enumerate((Hq, Hkv, Hkv, Hq)):
        x = torch.randn((B, S, h, D), generator=gen).to(dt)
        buf = torch.full((B, S + pad, h, D), junk if i % 2 else -junk,
                         dtype=dt)
        buf[:, :S] = x
        out.append(buf.cuda()[:, :S].transpose(1, 2))
    return out


def _bwd_errors(got, want, dname, case):
    """Each gradient within BWD_TOL x max|g| of the plain version's (exactly
    0 where the plain gradient is 0); returns (max abs err, max err over
    max|g|)."""
    import torch
    worst_abs = worst_rel = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, case)
        assert torch.isfinite(g).all(), (name, case)
        err = _err(g, w)
        scale = float(w.float().abs().max())
        if scale == 0:
            assert err == 0, (name, case, err)
            continue
        assert err <= BWD_TOL[dname] * scale, (name, case, err, scale)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                         err / scale)
    return worst_abs, worst_rel


def check_flash_backward():
    """The backward kernels against autograd of the plain version
    (``ref.flash_attention_backward_ref``) over BWD_HEADS x BWD_S, causal
    and not, f32 and bf16, and whisper's non-causal S 1,504 at D 64; the
    forward's lse against the plain log-sum-exp and its output bits equal
    to the call without lse; inputs past S filled with +-999 and NaN leave
    every gradient bit for bit unchanged; two calls give the same bits;
    bf16 runs the tensor-core kernels and f32 the CUDA-core ones, by their
    profiled names; unaligned bf16 views raise."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(17)
    shapes = [(B, Hq, Hkv, D, S, c) for B, Hq, Hkv, D in BWD_HEADS
              for S in BWD_S for c in (True, False)]
    shapes.append((1, 6, 6, 64, 1504, False))
    n, errs, rel, lse_err = 0, {k: 0.0 for k in TOL}, {k: 0.0 for k in TOL}, 0.0
    for dname, dt in _dtypes().items():
        for B, Hq, Hkv, D, S, causal in shapes:
            case = (dname, B, Hq, Hkv, D, S, causal)
            q, k, v, do = _bwd_inputs(B, Hq, Hkv, D, S, dt, gen)
            out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
            got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                   causal)
            torch.cuda.synchronize()
            want = ref.flash_attention_backward_ref(q, k, v, out, do, causal)
            a, r = _bwd_errors(got, want, dname, case)
            errs[dname], rel[dname] = max(errs[dname], a), max(rel[dname], r)
            assert torch.equal(out, fa.flash_attention_cuda(q, k, v, causal))
            G = Hq // Hkv
            sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()
                              .repeat_interleave(G, 1)) * D ** -0.5
            if causal:
                sc = sc.masked_fill(~torch.ones(
                    S, S, dtype=torch.bool, device="cuda").tril(),
                    float("-inf"))
            lse_err = max(lse_err, _err(lse, torch.logsumexp(sc, -1)))
            n += 1
    assert lse_err < 1e-4, lse_err
    # junk past S, and the same bits twice
    for dname, dt in _dtypes().items():
        for S, causal in ((127, True), (129, False)):
            clean = _bwd_inputs(2, 8, 2, 128, S, dt,
                                torch.Generator().manual_seed(S))
            base = None
            for junk in (0.0, 999.0, float("nan")):
                q, k, v, do = _bwd_inputs(2, 8, 2, 128, S, dt,
                                          torch.Generator().manual_seed(S),
                                          pad=31, junk=junk)
                assert all(torch.equal(a, b) for a, b in zip(
                    (q, k, v, do), clean))
                out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
                g = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                     causal)
                g2 = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                      causal)
                assert all(torch.equal(a, b) for a, b in zip(g, g2)), \
                    ("two calls", dname, S)
                if base is None:
                    base = g
                assert all(torch.equal(a, b) for a, b in zip(g, base)), \
                    ("junk past S", junk, dname, S)
                n += 1
    # the route each type takes, by the kernels' profiled names
    routes = {}
    for dname, dt in _dtypes().items():
        q, k, v, do = _bwd_inputs(1, 4, 2, 128, 128, dt, gen)
        out, lse = fa.flash_attention_lse_cuda(q, k, v, True)
        every = device_kernel_names(fa.flash_attention_backward_cuda, q, k,
                                    v, out, lse, do, True)
        names = sorted({_kernel_name(n, r"flash_bwd_\w+") for n in every
                        if "flash_bwd_" in n})
        dq_name, dkdv_name = BWD_KERNEL_NAMES[fa.backward_route(dt)]
        if fa.backward_route(dt) == "wgmma":   # D 128
            dq_name, dkdv_name = dq_name + "<128>", dkdv_name + "<128>"
        assert names == sorted([dq_name, dkdv_name]), (dname, names)
        routes[dname] = {"route": fa.backward_route(dt), "kernels": names}
    # unaligned bf16 views: through the autograd path and the wrapper
    x = torch.randn((1, 2 * 16 * 64 + 1), device="cuda").to(torch.bfloat16)
    bad = x[:, 1:].view(1, 16, 2, 64).transpose(1, 2).requires_grad_(True)
    ok = torch.randn((1, 16, 2, 64), device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    for call in (lambda: ops.flash_attention(bad, ok, ok),
                 lambda: fa.flash_attention_backward_cuda(
                     bad, ok, ok, ok, torch.zeros((1, 2, 16), device="cuda"),
                     ok, True)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("an unaligned bf16 view was accepted")
    return {"cases": n, "max_abs_err": errs, "max_err_over_max_g": rel,
            "lse_max_abs_err": lse_err, "routes": routes}


def flash_backward_timings():
    """The backward timed at the training shape and at one longer sequence
    (B 1, S 1,024), where the products rather than the launches carry the
    time."""
    return {"training": flash_backward_timing(),
            "s1024": flash_backward_timing(B=1, S=1024)}


def flash_backward_timing(B=4, Hq=16, Hkv=8, D=128, S=128):
    """At a training shape (bf16, causal, the projections' layout; by
    default the training run's): the forward + backward through
    ``ops.flash_attention``'s autograd path and the backward alone, each as
    device time (profiler), wrapper time (CUDA events), the plain version's
    time, the bound and SDPA's forward + backward; the dq and dk/dv
    kernels' device times apart."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = _bwd_inputs(B, Hq, Hkv, D, S, torch.bfloat16, gen)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out, lse = fa.flash_attention_lse_cuda(q, k, v, True)

    def fwd_bwd():
        o = ops.flash_attention(*leaves, causal=True)
        return torch.autograd.grad(o, leaves, do)

    def bwd():
        return fa.flash_attention_backward_cuda(q, k, v, out, lse, do, True)

    def plain_fwd_bwd():
        o = ref.mha_prefill(*leaves, causal=True)
        return torch.autograd.grad(o, leaves, do)

    def plain_bwd():
        return ref.flash_attention_backward_ref(q, k, v, out, do, True)

    def library():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, leaves, do)

    pairs = S * (S + 1) // 2
    e = 2  # bytes of bf16
    qb, kb = B * Hq * S * D * e, B * Hkv * S * D * e
    lse_b = B * Hq * S * 4
    fwd_ops = 4 * B * Hq * pairs * D
    # the backward alone: q, k, v, o, dO, lse in; dq, dk, dv out
    bwd_bytes = 3 * qb + 2 * kb + lse_b + qb + 2 * kb
    bwd_ops = 10 * B * Hq * pairs * D
    # forward + backward: q, k, v, dO in; o, dq, dk, dv out
    fb_bytes = 2 * qb + 2 * kb + qb + qb + 2 * kb
    fb_ops = fwd_ops + bwd_ops

    def bound(nbytes, n_ops):
        tb, to = nbytes / HBM_BYTES_PER_S, n_ops / BF16_OPS_PER_S
        return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"

    # the autograd path (forward with lse, then the backward kernels)
    # against the plain version before anything is timed
    err, rel = _bwd_errors(fwd_bwd(), ref.flash_attention_backward_ref(
        q, k, v, out, do, True), "bfloat16", "training shape, autograd")
    out_row = {"shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S": S,
                         "causal": True, "dtype": "bfloat16"},
               "autograd_max_abs_err": err, "autograd_err_over_max_g": rel}
    for name, fn, plain, nbytes, n_ops in (
            ("backward", bwd, plain_bwd, bwd_bytes, bwd_ops),
            ("forward_backward", fwd_bwd, plain_fwd_bwd, fb_bytes, fb_ops)):
        b_ms, b_by = bound(nbytes, n_ops)
        out_row[name] = {"ms": time_ms(fn), "device_ms": device_total_ms(fn),
                         "plain_ms": time_ms(plain), "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "ops": n_ops}
    # each backward kernel's own device time, by its profiled name
    for kname in BWD_KERNEL_NAMES[fa.backward_route(q.dtype)]:
        out_row["backward"][f"{kname}_device_ms"] = device_kernel_ms(
            bwd, name=kname)
    got = fwd_bwd()
    try:
        want = library()
    except (TypeError, RuntimeError) as err:   # SDPA without enable_gqa
        out_row["library_ms"], out_row["library_error"] = None, repr(err)[:200]
        return out_row
    for a, b in zip(want, got):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)
    out_row["library_ms"] = time_ms(library)
    out_row["library_device_ms"] = device_total_ms(library)
    return out_row


class _TrainProbe:
    """``Trainer.run``'s callback (every step logged): the host time between
    steps, the kernel launches of each step, the metrics, and a profiler
    window over step ``profiled`` (started when step ``profiled - 1``
    reports, stopped when ``profiled`` does: the window holds that step)."""

    def __init__(self, profiled=None):
        self.t = time.perf_counter()
        self.walls, self.launches, self.metrics = [], [], []
        self.profiled, self.prof, self.prof_wall = profiled, None, None
        self._counts = self._now()

    @staticmethod
    def _now():
        from repro_torch.kernels import (decode_attention, dominance,
                                         flash_attention, paged_attention)
        return {"flash_attention": flash_attention.LAUNCHES,
                "flash_attention_backward": flash_attention.BWD_LAUNCHES,
                "gqa_decode_attention": decode_attention.LAUNCHES,
                "paged_gqa_decode_attention": paged_attention.LAUNCHES,
                "dominance_matrix": dominance.LAUNCHES,
                "dominance_counts": dominance.COUNTS_LAUNCHES}

    def __call__(self, step, m):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.walls.append(now - self.t)
        counts = self._now()
        self.launches.append({k: counts[k] - self._counts[k]
                              for k in counts})
        self._counts = counts
        self.metrics.append(m)
        if self.prof is not None and step == self.profiled:
            self.prof.stop()
            self.prof_wall = now - self.t
        if self.profiled is not None and step == self.profiled - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        self.t = time.perf_counter()

    def profile_row(self):
        if self.prof is None or self.prof_wall is None:
            return None
        by_name, n = Counter(), 0
        for ev in self.prof.events():
            if ev.device_type.name == "CUDA":
                by_name[ev.name[:60]] += ev.time_range.elapsed_us()
                n += 1
        busy = sum(by_name.values()) / 1e6 if n else None
        return {"step": self.profiled, "wall_s": self.prof_wall,
                "device_busy_s": busy,
                "idle_share": _idle(busy, self.prof_wall),
                "device_events": n, "top_device_us": by_name.most_common(8)}


def _train_cfg(n_layers=None, dtype=None):
    from repro_torch.configs import get
    cfg = get(TRAIN_MODEL).config()
    kw = {k: v for k, v in (("n_layers", n_layers), ("dtype", dtype))
          if v is not None}
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _free_cuda():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_main_path():
    """qwen3-1.7b at its published widths through ``run_train``: 4 steps of
    TRAIN_RUN, launches held exact for each step, step 2 profiled."""
    import torch
    from repro_torch.launch.train import run_train
    cfg = _train_cfg()
    from repro_torch.kernels import flash_attention as fa
    per_step = {"flash_attention": cfg.n_layers * TRAIN_RUN["microbatches"]
                * 2,
                "flash_attention_backward": cfg.n_layers
                * TRAIN_RUN["microbatches"] * fa.BWD_KERNELS}
    _free_cuda()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    probe = _TrainProbe(profiled=TRAIN_PROFILED_STEP)
    t0 = time.perf_counter()
    hist = run_train(TRAIN_MODEL, cfg=cfg, device="cuda", resume=False,
                     log_every=1, callback=probe, **TRAIN_RUN)
    wall = time.perf_counter() - t0
    launches = launch_counts(**{k: v * TRAIN_RUN["steps"]
                                for k, v in per_step.items()})
    for i, got in enumerate(probe.launches):
        want = {k: per_step.get(k, 0) for k in got}
        assert got == want, (i, got, want)
    for m in hist:
        for key in ("loss", "nll", "gnorm"):
            assert math.isfinite(m[key]), (m["step"], key, m[key])
    steady = [w for i, w in enumerate(probe.walls)
              if i not in (0, TRAIN_PROFILED_STEP)]
    step_s = statistics.median(steady)
    tokens = TRAIN_RUN["seq_len"] * TRAIN_RUN["global_batch"]
    return {"model": cfg.name, "layers": cfg.n_layers,
            "params": cfg.param_counts()["total"], "train": TRAIN_RUN,
            "optimizer": "adamw (optimizer_for_arch)", "remat": "full",
            "launches": launches, "launches_per_step": per_step,
            "losses": [m["loss"] for m in hist],
            "nll": [m["nll"] for m in hist],
            "gnorm": [m["gnorm"] for m in hist],
            "step_walls_s": probe.walls, "step_wall_s": step_s,
            "tokens_per_s": tokens / step_s, "wall_s": wall,
            "profiled_step": probe.profile_row(),
            "memory_before_gb": before_gb,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def train_card_vs_cpu():
    """One trainer step at the full width and 2 layers in f32 on a batch of
    2 x 64 tokens, on the card and on the CPU from the same parameters.
    Held: the loss within 1e-5 relative; the gradients, through each
    leaf's moments after the step (m = 0.1 g and v = 0.05 g^2 of the
    clipped f32 gradient g), within 1e-4 of the leaf's max; and each
    parameter the card wrote equal to adamw's step from the initial one
    with the card's own m and v, recomputed on the CPU, within 1e-4 x
    max|delta p| of its leaf plus the spacing of f32 at the parameter.
    Reported, not held: the card's parameters against the CPU run's, whose
    worst ratio to max|delta p| is large where |g| is near adamw's eps
    (its first step g / (|g| + eps) is sign-like, so a last-bit
    difference of g there moves the parameter by a good part of lr)."""
    import copy
    import torch
    from repro_torch.models import lm
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = _train_cfg(n_layers=2, dtype="float32")
    tcfg = TrainConfig(seq_len=64, global_batch=2, steps=1, log_every=1,
                       optimizer="adamw")
    opt = tcfg.opt
    cpu = lm.init(cfg, torch.Generator().manual_seed(3), "cpu")
    p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    card = copy.deepcopy(cpu).to("cuda")
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        zero_launches()
        _, state, hist = Trainer(cfg, tcfg, device=dev).run(model=model)
        out[dev] = (hist[0], state, time.perf_counter() - t0)
        if dev == "cuda":
            launch_counts(flash_attention=2 * cfg.n_layers,
                          flash_attention_backward=2 * cfg.n_layers)
    loss_c, loss_h = out["cuda"][0]["loss"], out["cpu"][0]["loss"]
    worst = {k: (0.0, None) for k in ("moments", "step", "vs_cpu")}

    def note(key, r, leaf):
        if r > worst[key][0]:
            worst[key] = (r, leaf)

    one = torch.ones((), dtype=torch.float32)
    b1c, b2c = 1 - opt.b1 ** one, 1 - opt.b2 ** one
    hp = dict(cpu.named_parameters())
    for k, p in card.named_parameters():
        pc = p.detach().cpu()
        for mom in ("m", "v"):
            got = out["cuda"][1][mom][k].cpu()
            want = out["cpu"][1][mom][k]
            note("moments", float((got - want).abs().max())
                 / max(float(want.abs().max()), 1e-30), k)
        m, v = out["cuda"][1]["m"][k].cpu(), out["cuda"][1]["v"][k].cpu()
        step = p0[k] - opt.lr * ((m / b1c) / (torch.sqrt(v / b2c) + opt.eps)
                                 + opt.weight_decay * p0[k])
        delta = max(float((pc - p0[k]).abs().max()), 1e-30)
        spacing = torch.nextafter(pc.abs(), torch.tensor(float("inf"))) \
            - pc.abs()
        excess = ((pc - step).abs() - spacing).clamp(min=0)
        note("step", float(excess.max()) / delta, k)
        note("vs_cpu", float((pc - hp[k].detach()).abs().max()) / delta, k)
    row = {"model": cfg.name, "layers": 2, "dtype": "float32",
           "batch": [tcfg.global_batch, tcfg.seq_len],
           "loss_card": loss_c, "loss_cpu": loss_h,
           "loss_rel_err": abs(loss_c - loss_h) / abs(loss_h),
           "gnorm_card": out["cuda"][0]["gnorm"],
           "gnorm_cpu": out["cpu"][0]["gnorm"],
           "worst_moment_err_over_max": worst["moments"],
           "worst_step_err_over_max_delta": worst["step"],
           "worst_param_vs_cpu_over_max_delta": worst["vs_cpu"],
           "card_s": out["cuda"][2], "cpu_s": out["cpu"][2]}
    del card, cpu
    _free_cuda()
    return row


def train_crash_resume():
    """Full width, 2 layers, bf16: 4 steps straight through; 2 steps with a
    checkpoint at step 2 (a temporary directory under build/, removed
    afterwards), its restore equal to the in-memory state bit for bit;
    then a fresh trainer resumes from it to step 4, its losses within 1e-3
    relative of the uninterrupted run's."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = _train_cfg(n_layers=2)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root, prefix="chip_smoke_ckpt_"))
    kw = dict(seq_len=128, global_batch=8, microbatches=2, log_every=1)
    try:
        _, _, full = Trainer(cfg, TrainConfig(steps=4, **kw),
                             device="cuda").run(resume=False)
        ck = dict(checkpoint_dir=str(tmp), checkpoint_every=100,
                  keep_checkpoints=1)
        probe = _TrainProbe()
        trainer = Trainer(cfg, TrainConfig(steps=2, **ck, **kw),
                          device="cuda")
        model, state, first = trainer.run(resume=False, callback=probe)
        save_s = time.perf_counter() - probe.t   # the final, blocking save
        step_dir = tmp / "step_00000002"
        nbytes = sum(f.stat().st_size for f in step_dir.rglob("*")
                     if f.is_file())
        params = dict(model.named_parameters())
        t0 = time.perf_counter()
        (saved_p, saved_s), manifest = trainer.ckpt.restore((params, state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert manifest["step"] == 2
        n_equal = 0
        for (_, a), (_, b) in zip(_flatten((saved_p, saved_s)),
                                  _flatten((params, state))):
            b = b.detach()
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dim():   # bits, not values
                a, b = a.view(torch.uint8), b.view(torch.uint8)
            assert torch.equal(a, b), "restore != saved"
            n_equal += 1
        del model, state, saved_p, saved_s, params
        _free_cuda()
        resumed = Trainer(cfg, TrainConfig(steps=4, **ck, **kw),
                          device="cuda")
        assert resumed.ckpt.latest_step() == 2
        _, _, rest = resumed.run(resume=True)
        assert [m["step"] for m in rest] == [2, 3]
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(rest, full[2:])]
        assert max(rel) <= 1e-3, rel
        rel_first = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(first, full)]
        assert max(rel_first) <= 1e-3, rel_first
        return {"model": cfg.name, "layers": 2, "dtype": "bfloat16",
                "losses_uninterrupted": [m["loss"] for m in full],
                "losses_resumed": [m["loss"] for m in rest],
                "resumed_rel_err": rel, "leaves_restored_bit_equal": n_equal,
                "bytes_written": nbytes, "save_s": save_s,
                "restore_s": restore_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_cuda()


def phase_train():
    """Phase 17: the backward kernels against their plain versions, the
    training main path at the published widths, the card against the CPU,
    crash and resume, and the backward timed at the training shape."""
    t0 = time.perf_counter()
    kernels = check_flash_backward()
    kernels["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_kernel_checks": kernels}), flush=True)
    main = train_main_path()
    print(json.dumps({k: main[k] for k in (
        "losses", "nll", "gnorm", "step_wall_s", "tokens_per_s",
        "peak_memory_gb", "launches")}), flush=True)
    vs_cpu = train_card_vs_cpu()
    print(json.dumps({"train_card_vs_cpu": vs_cpu}), flush=True)
    resume = train_crash_resume()
    print(json.dumps({"train_crash_resume": resume}), flush=True)
    timings = in_fresh_process("chip_smoke.flash_backward_timings()")
    timing = timings["training"]
    failures = []
    if vs_cpu["loss_rel_err"] > 1e-5:
        failures.append(("card vs CPU loss", vs_cpu["loss_rel_err"]))
    if vs_cpu["worst_moment_err_over_max"][0] > 1e-4:
        failures.append(("card vs CPU gradients (m, v)",
                         vs_cpu["worst_moment_err_over_max"]))
    if vs_cpu["worst_step_err_over_max_delta"][0] > 1e-4:
        failures.append(("card's adamw step",
                         vs_cpu["worst_step_err_over_max_delta"]))
    row = {"phase": "train", "main_path": main, "card_vs_cpu": vs_cpu,
           "crash_resume": resume, "backward_checks": kernels,
           "timing": timing, "timing_s1024": timings["s1024"]}
    emit(row)
    assert not failures, failures
    return row


def _mesh_step_launches(n_layers, train, steps=None):
    from repro_torch.kernels import flash_attention as fa
    per = n_layers * train["microbatches"]
    steps = train["steps"] if steps is None else steps
    return {"flash_attention": 2 * per * steps,
            "flash_attention_backward": fa.BWD_KERNELS * per * steps}


def _bits_equal(a, b):
    import torch
    a, b = a.detach(), b.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dim():
        a, b = a.contiguous().view(torch.uint8), b.contiguous().view(
            torch.uint8)
    return bool(torch.equal(a, b))


def _plain_then_mesh(cfg, train, mesh, ckpt=None):
    """Trainer() then Trainer(mesh=) on the same seed, one after the other
    from a clean card (the plain run's parameters and optimizer state held
    on the host meanwhile): metrics, every parameter and every
    optimizer-state leaf compared bit for bit, launches, walls and each
    run's peak memory. Returns (row, the mesh trainer, its state)."""
    import torch
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.training.trainer import TrainConfig, Trainer
    runs, host, t_all = {}, {}, time.perf_counter()
    for name in ("plain", "mesh"):
        _free_cuda()
        kw = ({"checkpoint_dir": str(ckpt), "checkpoint_every": 100}
              if name == "mesh" and ckpt else {})
        trainer = Trainer(cfg, TrainConfig(**train, **kw), device="cuda",
                          mesh=mesh if name == "mesh" else None)
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        probe = _TrainProbe()
        t0 = time.perf_counter()
        model, state, hist = trainer.run(resume=False, callback=probe)
        torch.cuda.synchronize()
        runs[name] = {"hist": hist, "wall": time.perf_counter() - t0,
                      "walls": probe.walls,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": launch_counts(**_mesh_step_launches(
                          cfg.n_layers, train))}
        if name == "plain":
            t0 = time.perf_counter()
            host = {"params": {k: p.detach().cpu()
                               for k, p in model.named_parameters()},
                    "state": {k: t.cpu() for k, t in _flatten(state)}}
            to_host_s = time.perf_counter() - t0
            del model, state, trainer
    t0 = time.perf_counter()
    params_equal = sum(_bits_equal(w.cuda(), trainer.params[k].full_tensor())
                       for k, w in host["params"].items())
    flat = dict(_flatten(state))
    state_equal = sum(k in flat and _bits_equal(w.cuda(),
                                                flat[k].full_tensor())
                      for k, w in host["state"].items())
    compare_s = time.perf_counter() - t0
    a, b = runs["plain"], runs["mesh"]
    metrics = [[(h["loss"], h["nll"], h["gnorm"]) for h in r["hist"]]
               for r in (a, b)]
    row = {"model": cfg.name, "layers": cfg.n_layers, "train": train,
           "losses": [h["loss"] for h in b["hist"]],
           "gnorm": [h["gnorm"] for h in b["hist"]],
           "metrics_bit_equal": metrics[0] == metrics[1],
           "params_bit_equal": [params_equal, len(host["params"])],
           "state_bit_equal": [state_equal, len(host["state"])],
           "state_leaves_mesh": len(flat),
           "launches_plain": a["launches"], "launches_mesh": b["launches"],
           "wall_s_plain": a["wall"], "wall_s_mesh": b["wall"],
           # host time between steps: the first holds the init (and on
           # the mesh the first sharding), the last run's wall the save
           "step_walls_s_plain": a["walls"], "step_walls_s_mesh": b["walls"],
           "peak_memory_gb_plain": a["peak_gb"],
           "peak_memory_gb_mesh": b["peak_gb"],
           # the trainer's own accounting: parameters filled at once,
           # what the update gathers whole (nothing), the f32 gradient
           # blocks
           "trainer_peak_gb": {k: v / 1e9
                               for k, v in trainer.peak_bytes.items()},
           "regions": sorted(trainer.split),
           "region_size": trainer.region and trainer.region.size,
           # the plain run's results to the host, and the comparison
           "to_host_s": to_host_s, "compare_s": compare_s,
           "seconds": time.perf_counter() - t_all}
    return row, trainer, state


def mesh_trainer_vs_plain(mesh, tmp):
    """Trainer(mesh=) against Trainer() on the same seed at MESH_LAYERS
    layers under each of MESH_OPTIMIZERS, and dbrx-132b at its published
    widths (MESH_MOE_LAYERS layers: experts and vocabulary in regions of
    one rank), one after the other: metrics, parameters, optimizer state
    and launches bit for bit / equal; the adamw and adafactor mesh runs'
    checkpoints (with specs) restored onto the mesh bit for bit. Then one
    adamw mesh step at full depth."""
    import torch
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = _train_cfg(n_layers=MESH_LAYERS)
    out = {}
    for opt in MESH_OPTIMIZERS:
        row, tr, state = _plain_then_mesh(
            cfg, {**MESH_TRAIN, "optimizer": opt}, mesh,
            ckpt=tmp / opt if opt in MESH_CHECKPOINTED else None)
        if opt in MESH_CHECKPOINTED:
            t0 = time.perf_counter()
            (rp, rs), manifest = tr.ckpt.restore(
                (tr.params, state), mesh=mesh, specs=(tr.pspecs, tr.sspecs))
            torch.cuda.synchronize()
            row["restore_s"] = time.perf_counter() - t0
            # a comprehension: no loop variable keeps a leaf on the card
            # into the next run's peak
            equal = [x.placements == y.placements
                     and _bits_equal(x.full_tensor(), y.full_tensor())
                     for (_, x), (_, y) in zip(_flatten((rp, rs)),
                                               _flatten((tr.params, state)))]
            row["checkpoint_specs_recorded"] = manifest["specs"] is not None
            row["restored_bit_equal"] = [sum(equal), len(equal)]
            del rp, rs
        out[opt] = row
        del tr, state
    moe_cfg = dataclasses.replace(get(MESH_MOE_MODEL).config(),
                                  n_layers=MESH_MOE_LAYERS)
    out["moe"], tr, state = _plain_then_mesh(moe_cfg, MESH_MOE_TRAIN, mesh)
    out["moe"]["params"] = moe_cfg.param_counts()["total"]
    del tr, state
    _free_cuda()
    # one step at full depth under the mesh (112 + 112 flash launches),
    # and its peak memory against the plain trainer's on the same step
    t_full = time.perf_counter()
    full = _train_cfg()
    peak = {}
    for name in ("plain", "mesh"):
        trainer = Trainer(full, TrainConfig(**{**MESH_TRAIN, "steps": 1}),
                          device="cuda",
                          mesh=mesh if name == "mesh" else None)
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        model, state, hist = trainer.run(resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        assert math.isfinite(hist[0]["loss"]), hist
        del model, state
        if name == "plain":
            del trainer
            _free_cuda()
    out["full_depth"] = {
        "layers": full.n_layers, "loss": hist[0]["loss"],
        "gnorm": hist[0]["gnorm"], "wall_s": wall,
        "launches": launch_counts(**_mesh_step_launches(full.n_layers,
                                                        MESH_TRAIN, 1)),
        "peak_memory_gb": peak["mesh"], "peak_memory_gb_plain": peak["plain"],
        "trainer_peak_gb": {k: v / 1e9
                            for k, v in trainer.peak_bytes.items()}}
    del trainer
    _free_cuda()
    out["full_depth"]["seconds"] = time.perf_counter() - t_full
    return out


def mesh_local_heads():
    """The flash forward and backward kernels at MESH_LOCAL_HEADS (bf16,
    causal, MESH_LOCAL_SHAPE), shapes that no other phase runs, against
    their plain versions: the output within TOL, each gradient within
    BWD_TOL x max|g|, the lse within 1e-4 of the plain log-sum-exp."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(25)
    B, S, D = MESH_LOCAL_SHAPE
    out = {}
    for Hq, Hkv in MESH_LOCAL_HEADS:
        case = ("bfloat16", B, Hq, Hkv, D, S)
        q, k, v, do = _bwd_inputs(B, Hq, Hkv, D, S, torch.bfloat16, gen)
        o, lse = fa.flash_attention_lse_cuda(q, k, v, True)
        grads = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        fwd = _check_close("flash at local heads", o,
                           ref.mha_prefill(q, k, v, causal=True),
                           "bfloat16", case)
        bwd, rel = _bwd_errors(grads, ref.flash_attention_backward_ref(
            q, k, v, o, do, True), "bfloat16", case)
        sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()
                          .repeat_interleave(Hq // Hkv, 1)) * D ** -0.5
        sc = sc.masked_fill(~torch.ones(S, S, dtype=torch.bool,
                                        device="cuda").tril(), float("-inf"))
        lse_err = _err(lse, torch.logsumexp(sc, -1))
        assert lse_err < 1e-4, (case, lse_err)
        out[f"{Hq}/{Hkv}"] = {"forward_max_abs_err": fwd,
                              "backward_max_abs_err": bwd,
                              "backward_err_over_max_g": rel,
                              "lse_max_abs_err": lse_err}
    return {"shape": {"B": B, "S": S, "D": D, "dtype": "bfloat16",
                      "causal": True}, "heads": out,
            "decode": mesh_local_decode()}


def _bound(nbytes, ops_n):
    """(bound_ms, bound_by) of bf16 work: bytes at HBM_BYTES_PER_S,
    operations at BF16_OPS_PER_S."""
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops_n / BF16_OPS_PER_S
    return (1e3 * max(nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S),
            "bytes" if by_bytes else "operations")


def mesh_partial_decode(q, k, v, lens, default, case):
    """The decode kernel's partial mode on the inputs of a default-mode
    call whose output is ``default``: o within TOL["bfloat16"] and lse
    within MESH_LSE_TOL of ``ref.gqa_decode_partial``; o rounded to q's
    dtype bit for bit the default output, which a second default call
    repeats bit for bit; its device time beside its bound (the cache rows
    read once, q, and the f32 o and lse written), wrapper, plain and SDPA
    (o alone: no library call returns the lse) times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, Hq, D = q.shape
    Hkv, Smax = k.shape[1], k.shape[2]
    o, lse = ops.gqa_decode_partial(q, k, v, lens)
    want_o, want_lse = ref.gqa_decode_partial(q, k, v, lens)
    o_err = _check_close("decode partial at local heads", o, want_o,
                         "bfloat16", case)
    live = lens > 0
    lse_err = _err(lse[live], want_lse[live])
    assert lse_err <= MESH_LSE_TOL, (case, lse_err)
    assert bool((lse[~live] == float("-inf")).all()), case
    again = ops.gqa_decode_attention(q, k, v, lens)
    bits = {"default_twice": _bits_equal(again, default),
            "partial_rounded_is_default": _bits_equal(o.to(q.dtype),
                                                      default)}
    assert all(bits.values()), (case, bits)
    n_read = int(lens.clamp(0, Smax).sum())
    nbytes = (2 * B * Hq * D + 2 * 2 * n_read * Hkv * D + 4 * B * Hq * D
              + 4 * B * Hq + 4 * B)
    bound_ms, bound_by = _bound(nbytes, 4 * n_read * Hq * D)
    mask = (torch.arange(Smax, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask,
                                              enable_gqa=True)

    device = device_kernel_ms(ops.gqa_decode_partial, q, k, v, lens,
                              name=DECODE_KERNEL)
    return {"o_max_abs_err": o_err, "lse_max_abs_err": lse_err, **bits,
            "device_us": device and 1e3 * device,
            "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
            "ms": time_ms(ops.gqa_decode_partial, q, k, v, lens),
            "plain_ms": time_ms(ref.gqa_decode_partial, q, k, v, lens),
            "library_ms": time_ms(library),
            "library_device_ms": device_total_ms(library)}


def mesh_split_merge():
    """The split-sequence decode on one card: a (B, Hkv, Smax, D) bf16
    cache of MESH_DECODE_SHAPE at qwen3-1.7b's 16 / 8 heads, cut into 2
    and 4 sequence blocks (``tensor_parallel.seq_range``), the partial
    mode over each block (kv_len clamped to it), merged by the port's
    ``tensor_parallel.merge``, against the default mode over the whole
    cache within TOL["bfloat16"]; MESH_SPLIT_LENS hold a row of kv_len 0,
    rows that end on a block's edge, rows in the first block only and a
    row past Smax."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import tensor_parallel as TP
    gen = torch.Generator().manual_seed(27)
    B, Smax, D = MESH_DECODE_SHAPE
    Hq, Hkv = 16, 8
    q = torch.randn((B, Hq, D), generator=gen).to(torch.bfloat16).cuda()
    k, v = (torch.randn((B, Smax, Hkv, D), generator=gen)
            .to(torch.bfloat16).cuda().permute(0, 2, 1, 3) for _ in range(2))
    lens = torch.tensor(MESH_SPLIT_LENS, dtype=torch.int32, device="cuda")
    whole = ops.gqa_decode_attention(q, k, v, lens)
    out = {"shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "Smax": Smax, "D": D,
                     "dtype": "bfloat16", "kv_len": list(MESH_SPLIT_LENS)}}
    for n in (2, 4):
        parts = []
        for r in range(n):
            lo, hi = TP.seq_range(Smax, TP.Region(None, n, r))
            parts.append(ops.gqa_decode_partial(
                q, k[:, :, lo:hi], v[:, :, lo:hi],
                (lens - lo).clamp(0, hi - lo)))
        merged = TP.merge(torch.stack([o for o, _ in parts]),
                          torch.stack([lse for _, lse in parts]))
        out[f"{n}_blocks_max_abs_err"] = _check_close(
            "split-and-merge decode", merged.to(q.dtype), whole, "bfloat16",
            ("bfloat16", n, B, Hq, Hkv, D, Smax))
    return out


def mesh_local_decode():
    """The decode kernel at MESH_LOCAL_HEADS over layer 1 of a stacked
    (2, B, Smax, H_r, hd) bf16 cache, viewed (B, H_r, Smax, hd) as a
    sharded decode reads a cache block, MESH_DECODE_LENS kv_len, against
    its plain version (within TOL); the kernel's device time (its profiled
    name) and wrapper time beside the plain version's and the bound (the
    cache rows read once, q and the output); its partial mode at the same
    inputs (``mesh_partial_decode``); and the split-and-merge check
    (``mesh_split_merge``)."""
    import torch
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(26)
    B, Smax, D = MESH_DECODE_SHAPE
    lens = torch.tensor(MESH_DECODE_LENS, dtype=torch.int32, device="cuda")
    out = {}
    for Hq, Hkv in MESH_LOCAL_HEADS:
        case = ("bfloat16", B, Hq, Hkv, D, Smax)
        q = torch.randn((B, Hq, D), generator=gen).to(torch.bfloat16).cuda()
        k, v = (torch.randn((2, B, Smax, Hkv, D), generator=gen)
                .to(torch.bfloat16).cuda()[1].permute(0, 2, 1, 3)
                for _ in range(2))
        got = ops.gqa_decode_attention(q, k, v, lens)
        want = ref.gqa_decode(q, k, v, lens)
        n_read = sum(MESH_DECODE_LENS)
        nbytes = 2 * (2 * B * Hq * D + 2 * n_read * Hkv * D) + 4 * B
        ops_n = 4 * n_read * Hq * D
        t1 = time.perf_counter()
        partial = mesh_partial_decode(q, k, v, lens, got, case)
        partial["seconds"] = time.perf_counter() - t1
        out[f"{Hq}/{Hkv}"] = {
            "partial": partial,
            "max_abs_err": _check_close("decode at local heads", got, want,
                                        "bfloat16", case),
            "ms": time_ms(ops.gqa_decode_attention, q, k, v, lens),
            "device_ms": device_kernel_ms(ops.gqa_decode_attention, q, k,
                                          v, lens, name=DECODE_KERNEL),
            "plain_ms": time_ms(ref.gqa_decode, q, k, v, lens),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops_n / BF16_OPS_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations")}
    t1 = time.perf_counter()
    split = mesh_split_merge()
    split["seconds"] = time.perf_counter() - t1
    return {"shape": {"B": B, "Smax": Smax, "D": D, "dtype": "bfloat16",
                      "kv_len": list(MESH_DECODE_LENS),
                      "cache": "layer 1 of (2, B, Smax, H_r, D)"},
            "heads": out, "split_merge": split,
            "seconds": time.perf_counter() - t0}


def _serve_greedy(prefill, decode, tokens):
    """``prefill(tokens)`` then MESH_SERVE["steps"] greedy decode steps:
    (stacked logits, tokens (B, steps + 1), the last cache, each step's
    wall in s, the card synchronized after it)."""
    import torch
    t0 = time.perf_counter()
    logits, cache = prefill(tokens)
    out, chosen = [logits], [logits.argmax(-1)]
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    for _ in range(MESH_SERVE["steps"]):
        t0 = time.perf_counter()
        logits, cache = decode(chosen[-1][:, None], cache)
        out.append(logits)
        chosen.append(logits.argmax(-1))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return torch.stack(out), torch.stack(chosen, 1), cache, walls


def _host_ops(fn, top=8):
    """One call of ``fn`` under torch.profiler's CPU activity: the host
    ops it ran, their self time in µs, and the ``top`` ops by self time
    (name, calls, µs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    worst = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:top]
    return {"ops": sum(e.count for e in ev),
            "self_us": sum(e.self_cpu_time_total for e in ev),
            "top": [(e.key, e.count, e.self_cpu_time_total) for e in worst]}


def _serve_vs_plain(cfg, mesh, per_period=False, profile=False):
    """``lm.prefill`` + ``lm.decode_step``, then a ``ShardedServer`` on
    ``mesh`` loaded with the same weights, over MESH_SERVE's prompt (and
    seeded bf16 frames or patches of ``cfg.cross_kv_tokens`` for the
    audio and vision families): logits, tokens and every cache leaf
    compared bit for bit, launches (the encoder's layers counted), the
    regions, xLSTM's state layout, the fills and walls. ``per_period``:
    ``BIG_MODEL_B`` at 0, so that the serve placements split over 'data'
    and every step fills the weights a period at a time. ``profile``: one
    more decode step each way under the host profiler."""
    import torch
    from repro_torch.launch.serve_mesh import ShardedServer
    from repro_torch.models import lm
    from repro_torch.models import sharding
    t_all = time.perf_counter()
    _free_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = lm.init(cfg, gen, "cuda")
    B, S, steps = MESH_SERVE["rows"], MESH_SERVE["prompt"], \
        MESH_SERVE["steps"]
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    cross = ({key: torch.randn((B, cfg.cross_kv_tokens, cfg.d_model),
                               generator=gen, device="cuda").to(
        torch.bfloat16)} if key else {})
    max_seq = S + steps
    n_attn = lm.n_attn(cfg)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    want_launches = {"flash_attention": n_attn + n_enc,
                     "gqa_decode_attention": n_attn * steps}
    runs = {}
    zero_launches()
    runs["plain"] = _serve_greedy(
        lambda t: lm.prefill(model, cfg, t, max_seq, **cross),
        lambda t, c: lm.decode_step(model, cfg, t, c), tokens)
    launches_plain = launch_counts(**want_launches)
    big = sharding.BIG_MODEL_B
    if per_period:
        sharding.BIG_MODEL_B = 0
    try:
        server = ShardedServer(cfg, mesh)
        fills, fill = [], server._fill

        def counting_fill(params, names, whole=False):
            fill(params, names, whole)
            fills.append(len(names))

        server._fill = counting_fill
        t0 = time.perf_counter()
        server.load(model)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        zero_launches()
        runs["mesh"] = _serve_greedy(
            lambda t: server.prefill(
                server.rows(t), max_seq,
                **{k: server.rows(x) for k, x in cross.items()}),
            server.decode_step, tokens)
        # every decode launch of the split-sequence path is a partial one
        launches_mesh = launch_counts(
            **want_launches,
            gqa_decode_partial=want_launches["gqa_decode_attention"])
    finally:
        sharding.BIG_MODEL_B = big
    (lp, tp, cp, wp), (lm_, tm, cm, wm) = runs["plain"], runs["mesh"]
    leaves = {"k": (cp.k, cm.k), "v": (cp.v, cm.v),
              "kv_len": (cp.kv_len, cm.kv_len),
              **{k: (t, cm.state[k]) for k, t in cp.state.items()}}
    cache_equal = {k: _bits_equal(a, b) for k, (a, b) in leaves.items()}
    if profile:
        # one more decode step each way, profiled on the host (the plain
        # model's weights are the server's resident blocks: whole on a
        # world of one); after the comparison, since it writes the caches
        t = tp[:, -1:]
        row_ops = {"plain": _host_ops(lambda: lm.decode_step(model, cfg, t,
                                                              cp)),
                   "mesh": _host_ops(lambda: server.decode_step(t, cm))}
    row = {"model": cfg.name, "layers": cfg.n_layers,
           "prompt": [B, S], "decode_steps": steps,
           "cross_tokens": cfg.cross_kv_tokens if key else None,
           "encoder_layers": n_enc, "tp_friendly": cfg.tp_friendly,
           "logits_bit_equal": _bits_equal(lp, lm_),
           "tokens_bit_equal": _bits_equal(tp, tm),
           "cache_bit_equal": cache_equal,
           "cache_leaves_mesh": 3 + len(cm.state),
           "launches_plain": launches_plain, "launches_mesh": launches_mesh,
           "regions": sorted(server.split),
           "region_size": server.region and server.region.size,
           # xLSTM: its states split over 'model' (a region of one here)
           "states_split": server.split_states,
           "state_region_size": (server.state_region
                                 and server.state_region.size),
           "cache_blocks": {k: list(b) for k, b in lm.cache_widths(
               cfg, server.cache_region(), cfg.cross_kv_tokens or None
           ).items()},
           "tp_cleared": all(getattr(m, "tp", None) is None
                             for m in model.modules()),
           "per_period_fills": per_period,
           "resident_params": len(server.resident),
           "filled_each_step_params": len(server.params),
           "fills_at_load": fills[:1], "fills_in_steps": len(fills) - 1,
           "fill_names_in_steps": sum(fills[1:]),
           "server_peak_filled_gb": server.peak_bytes["filled"] / 1e9,
           "load_s": load_s, "wall_s_plain": sum(wp),
           "wall_s_mesh": sum(wm),
           # the prefill's wall, then each decode step's
           "step_walls_s_plain": wp, "step_walls_s_mesh": wm}
    if profile:
        row["host_ops_one_decode_step"] = row_ops
    del server, model, runs, lp, tp, cp, lm_, tm, cm, leaves, cross
    _free_cuda()
    row["seconds"] = time.perf_counter() - t_all
    return row


def mesh_serve(mesh):
    """The sharded serve step against the plain one: qwen3-1.7b whole,
    dbrx-132b at MESH_MOE_LAYERS layers with its fills forced, then
    MESH_SERVE_STATE's models (cross K/V and xLSTM's states)."""
    from repro_torch.configs import get
    moe_cfg = dataclasses.replace(get(MESH_MOE_MODEL).config(),
                                  n_layers=MESH_MOE_LAYERS)
    out = {"dense": _serve_vs_plain(_train_cfg(), mesh, profile=True),
           "moe": _serve_vs_plain(moe_cfg, mesh, per_period=True)}
    for name, layers in MESH_SERVE_STATE:
        cfg = get(name).config()
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        out[name] = _serve_vs_plain(cfg, mesh)
    return out


def serve_runs(msh):
    """Phase 18's sharded serve rows (its ``serve`` without the phase's
    seconds)."""
    return {k: r for k, r in msh["serve"].items() if k != "seconds"}


def mesh_launches(train, kernel):
    """``kernel``'s launches in phase 18's mesh runs, by run."""
    return {**{opt: train[opt]["launches_mesh"][kernel]
               for opt in MESH_OPTIMIZERS},
            MESH_MOE_MODEL: train["moe"]["launches_mesh"][kernel],
            "full_depth_step": train["full_depth"]["launches"][kernel]}


def mesh_psum():
    """psum_compressed on the world of one for its three methods against
    the local formula (the reduction over one rank is the identity)."""
    import torch
    from repro_torch.training.grad_compress import (compress_int8,
                                                    compress_topk,
                                                    decompress_int8,
                                                    init_residual,
                                                    psum_compressed)
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = {"w": torch.randn(64, 1000, generator=gen, device="cuda"),
             "b": torch.randn(300, generator=gen, device="cuda")
             .to(torch.bfloat16)}
    res = init_residual(grads)
    q, s, _ = compress_int8(grads, res)
    want = {"int8": decompress_int8(q, s, grads),
            "topk": compress_topk(grads, res)[0],
            "none": {k: g.to(torch.float32) for k, g in grads.items()}}
    out = {}
    for method, w in want.items():
        mean, _ = psum_compressed(grads, res, None, method=method)
        out[method] = all(_bits_equal(mean[k], w[k]) for k in grads)
    return out


def mesh_fitness():
    """The quickstart evaluator's fitness on ``population_mesh()`` against
    the unsharded one on the same genomes (bit for bit), then a
    MESH_FITNESS NSGA-II run through the sharded fitness: its survival
    runs the dominance kernel (1 + generations launches)."""
    import torch
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import (EvalConfig, TraceEvaluator,
                                          population_mesh)
    from repro_torch.core.nsga2 import NSGA2, NSGA2Config
    from repro_torch.core.policies.threshold import BOUNDS_HI, BOUNDS_LO
    from repro_torch.workload.trace import build_trace
    ev = TraceEvaluator(build_trace(QUICKSTART["n_requests"], seed=0),
                        paper_testbed(), EvalConfig(concurrency=1),
                        device="cuda")
    mesh = population_mesh()
    gen = torch.Generator(device="cuda").manual_seed(11)
    lo = torch.as_tensor(BOUNDS_LO, device="cuda")
    hi = torch.as_tensor(BOUNDS_HI, device="cuda")
    g = lo + (hi - lo) * torch.rand((MESH_FITNESS["pop_size"] + 1, 6),
                                    generator=gen, device="cuda")
    zero_launches()
    F0, v0 = ev.make_fitness("threshold")(g)
    t0 = time.perf_counter()
    F1, v1 = ev.make_fitness("threshold", mesh=mesh)(g)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    cfg = NSGA2Config(lo=BOUNDS_LO, hi=BOUNDS_HI, **MESH_FITNESS)
    opt = NSGA2(ev.make_fitness("threshold", mesh=mesh), cfg, device="cuda")
    t0 = time.perf_counter()
    state = opt.evolve(torch.Generator(device="cuda").manual_seed(42))
    torch.cuda.synchronize()
    evolve_s = time.perf_counter() - t0
    launches = launch_counts(
        dominance_matrix=1 + MESH_FITNESS["n_generations"])
    F = state.F_raw
    assert F.shape == (MESH_FITNESS["pop_size"], 3)
    assert bool(torch.isfinite(F).all())
    return {"mesh_size": mesh.size(), "genomes": int(g.shape[0]),
            "F_bit_equal": _bits_equal(F0, F1),
            "violation_bit_equal": _bits_equal(v0, v1),
            "sharded_eval_s": eval_s, "nsga2": MESH_FITNESS,
            "evolve_s": evolve_s, "launches": launches}


def phase_mesh():
    """Phase 18: the flash kernels at the heads a rank holds when
    attention splits over 'model'; the mesh tail on a world of one (NCCL,
    a ``file://`` rendezvous under build/): the sharded trainer, its
    'model'-parallel regions of one rank (vocabulary, FFN, experts,
    attention) and its block updates, bit for bit against the plain one
    under each optimizer and for dbrx-132b's experts at full width, its
    checkpoint restored onto the mesh, psum_compressed, and the
    population-sharded fitness with NSGA-II on it."""
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root, prefix="chip_smoke_mesh_"))
    t0 = time.perf_counter()
    local = mesh_local_heads()
    local["seconds"] = time.perf_counter() - t0
    print(json.dumps({"mesh_local_heads": local}), flush=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp / 'rdv'}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_host_mesh(model=1)
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        train = mesh_trainer_vs_plain(mesh, tmp / "ckpt")
        print(json.dumps({"mesh_train": train}), flush=True)
        psum = mesh_psum()
        fitness = mesh_fitness()
        t_serve = time.perf_counter()
        serve = mesh_serve(mesh)
        serve["seconds"] = time.perf_counter() - t_serve
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        _free_cuda()
    row = {"phase": "mesh", "world": 1, "backend": "nccl",
           "mesh": {"data": 1, "model": 1}, "local_heads": local,
           "train": train,
           "psum_compressed_equal_local": psum, "fitness": fitness,
           "serve": serve, "seconds": time.perf_counter() - t0}
    emit(row)
    failures = []
    for run in (*MESH_OPTIMIZERS, "moe"):
        r = train[run]
        if not r["metrics_bit_equal"]:
            failures.append((run, "mesh trainer metrics != Trainer()'s"))
        for key in ("params_bit_equal", "state_bit_equal",
                    "restored_bit_equal"):
            if key in r and r[key][0] != r[key][1]:
                failures.append((run, key, r[key]))
        if r["state_leaves_mesh"] != r["state_bit_equal"][1]:
            failures.append((run, "state leaves", r["state_leaves_mesh"]))
        if r["launches_mesh"] != r["launches_plain"]:
            failures.append((run, "launches", r["launches_mesh"],
                             r["launches_plain"]))
        if r["region_size"] != 1 or "" not in r["regions"]:
            failures.append((run, "no region of one rank", r["regions"]))
        attention = {f"blocks.{i}.mixer" for i in range(r["layers"])}
        if not attention <= set(r["regions"]):
            failures.append((run, "attention outside the regions",
                             r["regions"]))
    for run, r in serve.items():
        if run == "seconds":
            continue
        for key in ("logits_bit_equal", "tokens_bit_equal", "tp_cleared"):
            if not r[key]:
                failures.append(("serve", run, key))
        if not all(r["cache_bit_equal"].values()) \
                or len(r["cache_bit_equal"]) != r["cache_leaves_mesh"]:
            failures.append(("serve", run, "cache", r["cache_bit_equal"]))
        # the mesh run's decode launches are all the partial mode's (the
        # counts themselves held by launch_counts: prefill and encoder
        # layers, self-attention layers x steps)
        partial = r["launches_mesh"]["gqa_decode_partial"]
        if {**r["launches_mesh"], "gqa_decode_partial": 0} \
                != r["launches_plain"] \
                or partial != r["launches_mesh"]["gqa_decode_attention"]:
            failures.append(("serve", run, "launches", r["launches_mesh"],
                             r["launches_plain"]))
        if r["tp_friendly"]:
            blocks = {f"blocks.{i}.{m}" for i in range(r["layers"])
                      for m in ("mixer", "ffn")}
            if r["region_size"] != 1 \
                    or not blocks | {""} <= set(r["regions"]):
                failures.append(("serve", run, "regions", r["regions"]))
        elif r["regions"] or not r["states_split"] \
                or r["state_region_size"] != 1:
            failures.append(("serve", run, "xLSTM states", r["regions"],
                             r["states_split"]))
        forced = r["per_period_fills"] or not r["tp_friendly"]
        if forced != (r["fills_in_steps"] > 0) or forced == (
                r["filled_each_step_params"] == 0):
            failures.append(("serve", run, "fills", r["fills_in_steps"]))
    if not all(psum.values()):
        failures.append(("psum_compressed", psum))
    if not (fitness["F_bit_equal"] and fitness["violation_bit_equal"]):
        failures.append("sharded fitness != unsharded")
    assert not failures, failures
    return row


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA device; it runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels.flash_attention import BWD_KERNELS

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    sorted_F = SortedObjectives()
    smi = timed("card", phase_card)
    kern = timed("kernels", phase_kernels)
    res, launches = timed("main_path", phase_main_path, sorted_F)
    timed("profile", phase_profile, res.state.genomes)
    timed("device_vs_cpu", phase_device_vs_cpu, res.genome)
    large = timed("large_population", phase_large_population, sorted_F)
    counts = timed("counts_kernel", phase_counts_kernel, sorted_F)
    onl = timed("online", phase_online)
    mat = timed("policy_matrix", phase_policy_matrix)
    attn = timed("attention_kernels", phase_attention_kernels)
    paged = timed("paged_kernel", phase_paged_kernel)
    run, model, served = timed("serve", phase_serve)
    timed("serve_check", phase_serve_check, run, model)
    sess_run, sess = timed("serve_sessions", phase_serve_sessions, model,
                           run.cfg)
    pools = timed("paged_on_pools", phase_paged_on_pools, sess_run, run.cfg)
    clu = timed("cluster", phase_cluster)
    fam = timed("families", phase_families)
    del run, model, sess_run   # the serving models: training needs the room
    trn = timed("train", phase_train)
    msh = timed("mesh", phase_mesh)
    emit({"phase": "times", "card": smi, "seconds": phase_s,
          "total_s": sum(phase_s.values())})

    t200 = kern["timing"]["200"]
    c200, c4096 = counts["timing"]["200"], counts["timing"]["4096"]
    dec, fa = attn["decode"], attn["flash"]
    ext = sess["flash_extend_at_median_admission"]
    sess_launches = sess["runs"]["prefix_cache"][0]["launches"]
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library_device_ms", "device_ms", "shape")
    emit({"kernels": [{
        "name": "dominance_matrix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dominance.cu",
        "replaces": "src/repro/kernels/dominance.py:47",
        "launches": launches, "launches_large_population": large,
        "launches_online": onl["launches"],
        "launches_online_refit_256": onl["refit_256"]["launches"],
        "launches_cluster": clu["launches"]["dominance_matrix"],
        "launches_mesh_fitness": msh["fitness"]["launches"][
            "dominance_matrix"],
        "launches_policy_matrix": mat["launches"],
        "launches_policy_matrix_refits": {
            m: r["launches"] for m, r in mat["refits"].items()},
        **onl["timing"],
        "cases": kern["cases"], "exact": kern["exact"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t200["ms"], "plain_ms": t200["plain_ms"],
        "bound_ms": t200["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": t200["device_ms"],
        "p4096": {**kern["timing"]["4096"], "bound_by": "bytes"},
        "p4104": {**kern["timing"]["4104"], "bound_by": "bytes"},
        "kernel_names": kern["kernel_names"],
        "previous": "PERF.md section 6, column Previous"}, {
        "name": "dominance_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dominance.cu",
        "replaces": "src/repro/kernels/dominance.py:90",
        # no path runs it: launch_counts held it at 0 in phases 3, 5, 7, 11
        "launches": sess_launches["dominance_counts"],
        "on_main_path": False,
        "held_on_main_path_matrices": counts["main_path_matrices"],
        "cases": counts["cases"], "exact": counts["exact"],
        "max_abs_err": counts["max_abs_err"],
        **{k: c200[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "share_of_bound",
                                "profiled_ops_per_call")},
        "state_calls": counts["state_calls"],
        "library": counts["library"], "p4096": c4096,
        "previous": "PERF.md section 6, column Previous"}, {
        "name": "gqa_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "kernel_body": "src/repro_torch/kernels/csrc/split_decode.cuh",
        "replaces": "src/repro/kernels/decode_attention.py:79",
        "launches": served["launches"]["gqa_decode_attention"],
        "launches_serve_sessions": sess_launches["gqa_decode_attention"],
        "launches_cluster": clu["launches"]["gqa_decode_attention"],
        "launches_families": fam["launches"]["gqa_decode_attention"],
        "launches_mesh_serve": {
            r["model"]: r["launches_mesh"]["gqa_decode_attention"]
            for r in serve_runs(msh).values()},
        # the split-sequence decode: every mesh serve launch is the
        # partial mode's (repro_gqa_decode_partial)
        "launches_mesh_serve_partial": {
            r["model"]: r["launches_mesh"]["gqa_decode_partial"]
            for r in serve_runs(msh).values()},
        "mesh_local_heads": msh["local_heads"]["decode"],
        "cases": dec["cases"] + fam["kernel_shapes"]["cases"],
        "max_abs_err": max(dec["max_abs_err"].values()),
        "max_abs_err_by_dtype": dec["max_abs_err"],
        **{k: dec["serving"].get(k) for k in timing_keys},
        "full_cache": dec["full_cache"],
        "session": sess["decode_at_profiled_iteration"],
        "cluster_cohort": clu["decode_at_cohort_rows"],
        "cluster_cloud": clu["decode_at_cloud_rows"],
        "families": {k: fam["kernel_shapes"][k] for k in (
            "decode_g5", "decode_g6", "decode_hd64")},
        "splits": attn["routes"]["decode_split"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": served["launches"]["flash_attention"],
        "launches_serve_sessions": sess_launches["flash_attention"],
        "launches_cluster": clu["launches"]["flash_attention"],
        "launches_families": fam["launches"]["flash_attention"],
        "launches_mesh": mesh_launches(msh["train"], "flash_attention"),
        "launches_mesh_serve": {
            r["model"]: r["launches_mesh"]["flash_attention"]
            for r in serve_runs(msh).values()},
        "mesh_local_heads": {k: v for k, v in msh["local_heads"].items()
                             if k != "decode"},
        "cases": fa["cases"] + attn["flash_extend"]["cases"],
        "max_abs_err": max(list(fa["max_abs_err"].values())
                           + list(attn["flash_extend"]["max_abs_err"]
                                  .values())),
        "max_abs_err_by_dtype": fa["max_abs_err"],
        **{k: fa["serving"].get(k) for k in timing_keys},
        "s64": fa["s64"], "s512": fa["s512"], "groups": fa["groups"],
        "families": {k: fam["kernel_shapes"][k] for k in (
            "flash_g5_s128", "flash_g6_s128",
            "flash_hd64_s1504_noncausal")},
        "kernels_by_dtype": attn["routes"]["flash_kernels"],
        "extend": {"cases": attn["flash_extend"]["cases"],
                   "max_abs_err_by_dtype":
                       attn["flash_extend"]["max_abs_err"],
                   **ext}}, {
        "name": "paged_gqa_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "kernel_body": "src/repro_torch/kernels/csrc/split_decode.cuh",
        "replaces": "src/repro/kernels/paged_attention.py:73",
        "launches": sess_launches["paged_gqa_decode_attention"],
        "on_main_path": False,
        "held_on_session_pools": {"calls": pools["calls"],
                                  "max_abs_err": pools["max_abs_err"]},
        "equal_to_decode_kernel": (paged["equal_to_decode_kernel"]
                                   + pools["equal_to_decode_kernel"]),
        "cases": paged["cases"],
        "max_abs_err": max(list(paged["max_abs_err"].values())
                           + [pools["max_abs_err"]]),
        "max_abs_err_by_dtype": paged["max_abs_err"],
        **{k: pools["timing"].get(k) for k in timing_keys},
        "decode_kernel_on_gathered_device_ms":
            pools["timing"]["decode_kernel_on_gathered_device_ms"],
        "splits": pools["timing"]["splits"],
        "previous": "PERF.md section 6, column Previous",
        "library": pools["library"]}, {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "reference_gradient": "src/repro/models/layers.py _xla_attention "
                              "(the TPU kernel has no backward)",
        "launches": trn["main_path"]["launches"]["flash_attention_backward"],
        "launches_per_step": trn["main_path"]["launches_per_step"],
        "launches_mesh": mesh_launches(msh["train"],
                                       "flash_attention_backward"),
        "mesh_local_heads": msh["local_heads"],
        "kernels_a_backward": BWD_KERNELS,
        "cases": trn["backward_checks"]["cases"],
        "max_abs_err": max(trn["backward_checks"]["max_abs_err"].values()),
        "max_abs_err_by_dtype": trn["backward_checks"]["max_abs_err"],
        "max_err_over_max_g": trn["backward_checks"]["max_err_over_max_g"],
        "lse_max_abs_err": trn["backward_checks"]["lse_max_abs_err"],
        **{k: trn["timing"]["backward"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "kernel_device_ms": {
            k: v for k, v in trn["timing"]["backward"].items()
            if k.startswith("flash_bwd_")},
        "routes": trn["backward_checks"]["routes"],
        "library_ms": trn["timing"]["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True) forward + backward",
        "library_device_ms": trn["timing"].get("library_device_ms"),
        "forward_backward": trn["timing"]["forward_backward"],
        "shape": trn["timing"]["shape"],
        "s1024": trn["timing_s1024"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
