#!/usr/bin/env python3
"""Drive repro_torch's paired-end and long-read mapping paths and its LM
serving path on one NVIDIA GPU and hold each hand-written CUDA kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card and build: the card's name and power limit, the kernel build;
  2. pair lane at chromosome scale: a 2^27-base random reference (about
     GRCh38 chr10), a 2^26-bucket SeedMap built on the card, one
     `Mapper.map` of 65,536 pairs (sub_rate 0.01) and a `map_stream` of 4
     batches of 65,536 pairs (the last one ragged), with every kernel's
     launches counted over exactly this lane;
  2b. long-read lane on the same session: one `Mapper.map_long` of 2,048
     reads of 10,000 bp (sub_rate 0.01; 65,536 pseudo-pairs) and a
     `map_long_stream` of 4 such batches (the last one 1,500 reads), the
     launches counted over exactly this lane;
  2c. the mesh plans on one card: a one-rank NCCL process group (a file
     store in the output directory) and a (1, 1) ("data", "model") mesh; a
     `shard_index=True` session built on the same reference (bucket-sharded
     CSR map, packed reference) maps phase 2's batch and stream, and so
     does a replicated-index data-parallel mesh session, each equal to
     phase 2's results field by field and in its stage totals, with the
     launches counted per plan; one steady sharded step is timed and
     profiled (the NCCL collectives' device time included);
  2d. the building blocks at the pair lane's shapes: `xxhash32` of the
     (2B*S, 4) packed seed words of phase 2's batch (masked, they must be
     the `seed_buckets` kernel's bucket ids), `seed_gather` of the padded
     rows at those ids (merged and filtered, they must give
     `pair_frontend`'s candidates), and `light_align` of both mates of
     every pair with a candidate against the window `candidate_align`
     aligned at the slot it picked (the same score, ok flag and CIGAR),
     with their launches counted over exactly these three calls;
  2e. LM serving of yi-6b at full width and depth (32 layers, d_model 4096,
     GQA 32 over 4 heads, float32 parameters from a seeded generator on
     the card, bf16 activations, the flash kernel on): `prefill_step` of
     8 prompts of 2,048 random tokens (max_len 2,080; 32 flash launches)
     and 32 greedy `decode_step`s, launches counted over exactly these;
     prefill and decode rates, peak memory, the device time of one
     profiled prefill and one profiled decode step; the last-position
     logits against a plain-backend prefill (relative L2 <= 1e-2, or 1.5x
     that of two plain prefills with another attention algorithm where
     larger) and the decode logits against a teacher-forced forward over
     the same 2,080 tokens (relative L2 <= 5e-2);
  3. each kernel against its plain version at the shapes the main paths
     give it: the same 65,536-pair batch `map` got (extra checks of
     seed_buckets: R 151 with codes 0-255 on 1,000 rows starting off a
     word; its device time also with the reads cold), the 16,384-row
     residual buffer that step 5 builds from it (extra checks at that
     size: the unpacked flavor, prescreen_top 4, a band >= W DP; the
     batch with every candidate slot valid, the residual buffer with every
     slot needing DP and pair_frontend's rows with every slot valid
     (h = M, merge_filter on the same rows gathered), each timed apart,
     and the number of alignments candidate_align ran against the bound's
     count), the
     long-read batch's diagonal rows and anchor windows (the mean and
     largest count h of valid slots a vote row holds; extra checks:
     synthetic vote rows 60 % valid, timed apart as `dense_ms`, the
     lane's rows 4 bytes off a 16-byte boundary, timed apart as
     `unaligned_device_ms`, rows of 257, 33, 4,096 and 12,288 slots,
     bands 16 and >= W, windows shorter than the read and rows wider than
     the warp kernel covers), the sharded plan's gathered (B, S, K)
     locations of the pair batch (extra check: 4,096 synthetic rows) and
     phase 2d's inputs of the building blocks (extra checks: xxhash32 of
     one row under seeds 0, 99 and 0xFFFFFFFF; light_align in paper mode,
     at E 0, 1 and 2, on int32 bases, on one row, at R 700 and 1,000
     (E 8) and R = E + 2, on tandem repeats, all-mismatch rows and codes
     0-255 in uint8 and int32; seed_gather of a float32 table, of
     30-wide rows and of ids outside the table; the vote rows of 257 to
     12,288 slots and light_align's synthetic rows run after the last
     timed reading); flash_attention at the prefill's shapes (BH 256,
     S 2,048, D 128, bf16, causal, K/V head h // 8; extra checks: float32,
     S 2,000 padded, causal=False, D 80, 64 and 112 in bf16, D 112 in
     float32); exact equality (flash:
     3e-2 in bf16, 1e-4 in float32), timed with CUDA events (`ms`) and
     torch.profiler (`device_ms`, inputs warm in L2, the mean over the
     launches its trace holds), and
     `torch.index_select` and `scaled_dot_product_attention` timed
     beside seed_gather and flash_attention;
  4. the same batches through the kernel Mapper and plain-backend
     Mappers on the card (the long-read one on the CSR index, which takes
     the staged path): equal results, field by field;
  2f. serving on phase 2's session, run after phase 4 so that phase 3
     reads the kernels in the same state as before this phase existed:
     `Mapper.save` of its store into the output directory and
     `Mapper.load` (the loaded map equals phase 2's); a `FrontDoor` on a
     2^22-base store whose `reload_index` of a second same-shape store must
     return "reused", the batches after it equal to a fresh session on the
     second reference; a pair-lane door over 16 x 65,536 bursty pairs and
     a two-lane door (B 2,048, 20 % long reads of 10 kbp), every request
     equal to a direct `map` / `map_long` of its rows, `dp_overflow` 0,
     launches counted over the three doors;
  2g. the full-DP baseline (`map_single_end`, 16 candidates) on both mates
     of phase 2's batch, the first 1,024 reads equal to the CPU's, and on
     65,536 reads at sub_rate 0.005, of whose mapped reads 0.95 must lie
     within 16 bp of the truth;
  2h. the rest of the mapper on phase 2's session: `map_long_reads` of
     phase 2b's batch equal to `Mapper.map_long`, `query_padded` of phase
     2's seeds equal to the rows the step's bucket ids select (merged,
     its candidates), `seedmap_stats` of the 2^26-bucket index;
     `tune_session` at phase 2's shape (65,536 pairs, 16,384 residual
     rows, vote rows of 10 kbp reads; reps 3) into the output directory,
     where every launch geometry of each family's grid is held against
     the plain version on the same inputs and no entry may be
     `plain_faster`, a `tune=` session equal to one that sets the winners
     explicitly (and to phase 2 where only geometry won);
     `multihost.map_stream` at world size 1 in turns with `map_stream`
     (equal totals, a one-host health ledger), a `PreemptionGuard` fired
     after the second batch (the stream drains; each accepted batch equal
     to the stream's), and ``serve --chaos sigterm@0:2 --health-out`` as
     a subprocess; launches counted over the phase ("tune + fleet");
     then phase 3's timed cases' device times read again;
  2i. the rest of the LM substrate at full width, after the mapping
     sessions are freed: llama4-scout (4 of 48 layers), kimi-k2 (1 of 61;
     384 experts, top-8, 112-wide heads), mamba2, zamba2, qwen2-vl (1,024
     patch embeddings + 1,024 text tokens) and musicgen (4 codebooks), each
     with parameters from a seeded generator on the card, bf16
     activations and the flash kernel on: `prefill_step` of 8 prompts of
     2,048 positions and 16 greedy `decode_step`s, with exactly one flash
     launch per attention layer of the prefill and no other kernel;
     prefill and decode rates and peak memory; the last-position logits
     against a plain-backend prefill (phase 2e's gate) and the decode
     logits against a teacher-forced forward (relative L2 <= 5e-2; moe at
     the no-drop capacity factor on shorter prompts, over the positions
     routed alike in every layer, at most 10 % rerouted; ssm and hybrid
     again with float32 activations, forced with SSD chunks of 16);
     finite logits of the right shape;
  2j. LM training after 2i's models are freed: stablelm-3b at its full
     width and depth (32 layers, d 2,560, ~2.67 B float32 parameters,
     bf16 activations, remat, blockwise attention, AdamW with float32
     moments) at 4,096 tokens a sequence and a global batch of 8 (cut
     from 256) in micro-batches of two, through the trainer's own
     `make_train_step`: one warm-up and 4 timed steps (ms a step,
     tokens/s, 6 N tokens / time / 989 TFLOP/s, peak memory, each step's
     loss and grad norm, all finite) and a device profile of a one-
     sequence micro-batch; one step of the 2-layer full-width
     model in float32 on the card and on the CPU from the same parameters
     and batch (loss, grad norm, each leaf's update within stated
     tolerances); `train()` at 2 layers end to end, uninterrupted, stopped
     with `stop_after` and resumed from its checkpoint (equal losses
     within rel 1e-6) and preempted by SIGTERM (~3.5 GB checkpoints in a
     directory under chiprun_out/ that the phase deletes); the flash
     wrapper raising under autograd; no kernel launched;
  2k. the trainer's mesh path (FSDP over "data", tensor parallelism over
     "model") on a one-rank NCCL group over a file store and a (1, 1)
     ("data", "model") mesh, after 2j frees its state: 2j's model, seed
     and batch through `make_train_step` with the mesh, one warm-up and 2
     timed steps (ms a step and tokens/s beside 2j's, peak memory, the
     bytes of parameters and moments the rank holds; the first step's
     loss and grad norm equal to 2j's first within rel 1e-6, bit for bit
     expected), and `train()` at 2 layers, one-device and on the mesh:
     the same checkpoint files byte for byte, and the one-device trainer
     resumes from the mesh's checkpoint to the same loss; no kernel
     launched;
  2l. LM serving through the mesh path (`prefill_step` / `decode_step`
     with a `ShardCtx`) on a one-rank NCCL group and a (1, 1) mesh,
     after 2k: yi-6b with 2e's parameters, prompts and the 32 tokens 2e
     decoded, every logit equal to 2e's bit for bit, prefill and decode
     rates beside 2e's, peak memory, the rank's parameter and cache
     bytes, one profiled mesh decode step; then llama4-scout, mamba2,
     zamba2 (2 groups), qwen2-vl and musicgen at published widths cut to
     2 layers, 8 x 1,024 positions and 4 greedy decode steps, each equal
     to its one-device steps bit for bit (logits and cache); flash
     launches counted over the mesh runs only (kimi-k2 is left out: one
     of its layers costs 2i's time);
  2m. tensor parallelism over "model" on the one card, after 2l: two
     processes (this script with `--serve-tp-rank`) form a gloo group
     over CUDA tensors (NCCL refuses two ranks on one device) and serve
     llama4-scout, mamba2, zamba2 (2 groups), qwen2-vl and musicgen at
     published widths cut to 2 layers, on a (1, 2) ("data", "model")
     mesh: each rank holds its half of the heads, experts, SSM heads and
     vocab, and of the decode cache; float32 activations, parameters and
     cache, 8 x 1,024 positions and 4 decode steps fed the tokens the
     one-device run (this process, freed before the ranks start) chose
     greedily; every logit and each rank's cache slice within 1e-5 of the
     largest |value| of the one-device run's, moe routing every token of
     every layer and step alike; flash launches counted over both ranks
     ("serve tp");
  2n. the dry run against the card (`repro_torch.launch.dryrun`, fakes on
     "cuda"): 2e's yi-6b prefill and a decode step, one micro-batch of
     2j's training (2 x 4,096 tokens, forward + backward) and 2c's
     sharded pair step, each counted on fake tensors (not a byte
     allocated on the card) and then run on the card: the predicted peak
     above the step's arguments within 5 % or 0.25 GiB of
     max_memory_allocated's, and the roofline time at most 1.05 x the
     step's measured device time; then, in a process of its own, the
     per-rank peaks of the GRCh38 genpair step at (1, 1) and (1, 4),
     yi-6b train_4k at (4, 1), llama4-scout prefill_32k and decode_32k and
     kimi-k2 decode_32k at (1, 4), printed against the card's memory;
  5. the card line, the `kernels` JSON line and the final `ok` line.

Exits 1 without a result when no CUDA device is available.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

REF_LEN = 1 << 27            # ~GRCh38 chr10 (133.8 Mbp)
TABLE_BITS = 26
BATCH = 65_536
STREAM_BATCHES = 4
RAGGED_TAIL = 40_000
LONG_BATCH = 2_048           # reads of LONG_LEN bp: 65,536 pseudo-pairs
LONG_LEN = 10_000
LONG_TAIL = 1_500
SEED = 0
SWAP_REF_LEN = 1 << 22       # phase 2f's two same-shape stores
SWAP_TABLE_BITS = 20
SWAP_BATCH = 4_096
DOOR_BATCHES = 16            # phase 2f's pair-lane door: 16 x BATCH pairs
TWO_LANE_BATCH = 2_048       # phase 2f's two-lane door
TWO_LANE_BATCHES = 8
LONG_FRAC = 0.2
BASELINE_CANDS = 16          # phase 2g: candidates DP-scored per read
BASELINE_CHECK = 1_024       # reads held against the CPU
LM_BATCH = 8                 # yi-6b requests: 2,048-token prompts, 32 tokens
LM_PROMPT = 2_048
LM_DECODE = 32
LM_MAX_LEN = LM_PROMPT + LM_DECODE
# Kernel against plain prefill, relative L2 of the last-position logits:
# 1e-2, or 1.5x the distance between two plain prefills that differ only
# in the attention algorithm (dense float32 softmax against the blockwise
# online softmax), where that is larger.  A 32-layer bf16 model with random
# weights carries an ulp of difference in a few attention outputs to ~2 %
# of its logits (1.70e-2 between the two plain prefills on an H100), so a
# fixed 1e-2 would fail every implementation that is not bit-identical to
# the plain one; a fault of the kernel (a wrong head, mask or scale) gives
# an error of order 1.
LM_PLAIN_TOL = 1e-2
LM_FLOOR_MARGIN = 1.5
# Decode against a teacher-forced forward in bf16: the two run other matrix
# shapes (M = 8 against M = 16,640), so cuBLAS sums in another order and
# ~7 bf16 roundings a layer (2^-9 each) can land an ulp apart over 32
# layers: sqrt(32 * 7) * 2^-9 ~ 3e-2 of random walk, with margin.
LM_DECODE_TOL = 5e-2

# Phase 2i: the rest of the LM substrate at full width (B 8, 2,048-position
# prompts, 16 greedy decode steps, bf16 activations, the flash kernel on).
# Each entry: the config, the layers kept (None: all; a cut only where one
# card forces it: llama4-scout's 48 float32 layers are 8.30 GB each,
# kimi-k2's 61 bf16 layers 34.3 GB each) and the flash launches one
# prefill makes (one per attention layer; decode attends without it).
LM_FAMILIES = (
    ("llama4-scout-17b-a16e", 4, 4),
    ("kimi-k2-1t-a32b", 1, 1),
    ("mamba2-2.7b", None, 0),
    ("zamba2-2.7b", None, 9),      # the shared block after every 6 layers
    ("qwen2-vl-7b", None, 28),
    ("musicgen-medium", None, 48),
)
LM_FAMILY_DECODE = 16
# The moe decode-vs-teacher-forcing check runs apart, at the no-drop
# capacity factor n_experts / top_k (C >= the tokens of a routing group),
# on prompts short enough for that capacity's (G, E * C + 1, d) buffer:
# at the default 1.25 a group of the 16,512-token forward drops tokens
# that a one-token decode (C 8) keeps, so the two differ by design.
MOE_NO_DROP_PROMPT = {"llama4-scout-17b-a16e": 512, "kimi-k2-1t-a32b": 128}
# Top-k routing is discontinuous: decode (M = 8 rows) and the forced
# forward (M = 4,224) sum in other orders in bf16, and a near-tie pick
# flips (repro's own tests run moe in float32 for that reason).  The gate
# compares the positions routed alike in every layer, and at most this
# share of positions may route apart (a fault of the routing or the cache
# moves most of them).
MOE_REROUTED_SHARE = 0.1
# ssm / hybrid: the teacher-forced forward over 2,064 positions runs SSD in
# chunks of 16 (ssd_chunked needs S a multiple of the chunk; 2,064 is not
# one of 64); the chunking changes the order of sums, not the function.
# Their decode-vs-forcing gate runs the prompt and the 16 steps again
# with float32 activations: 54-64 SSM layers with random weights carry
# bf16 rounding to 18-23 % of the logits between decode and forcing
# (mamba2, zamba2 on an H100; bf16 and float32 forcing of the same tokens
# differ by 34-43 %), so bf16 can tell no fault from rounding there; the
# bf16 distances are printed beside it.
SSM_FORCED_CHUNK = 16

# Phase 2j: LM training of stablelm-3b at its published width and depth
# (32 layers, d 2,560, vocab 50,304; float32 parameters, bf16 activations,
# remat, blockwise attention, AdamW with float32 moments: the JAX package's
# training setting) at its TRAIN_4K sequence length.  The global batch is
# cut from 256 to 8 sequences to fit one card, in micro-batches of two
# sequences: the ~43 GB of parameters, gradients and moments, the
# per-layer gradients a backward holds before it stacks them (~11 GB) and
# one layer's recomputed float32 attention (~4.3 GB a sequence) stay under
# the card's 80 GB beside what the earlier phases still hold (8.65 GiB).
# The step is host-bound on the blockwise attention's ~184,000 launches a
# sequence (59-61 % of a one-sequence micro-batch idle in this phase's
# device profile on an H100 80GB HBM3 at 700 W, PERF.md section 5), so
# two sequences a micro-batch halve the launches of a step.
# The step peaks at ~64 GiB beside the earlier phases' 8.65: within the
# card's 79.2 GiB, but a step that reuses the cache the step before left
# can find its free memory in pieces too small for a 2.1 GiB block (step
# 1 ran out of memory once on an H100 80GB HBM3 at 700 W with 60.5 GiB
# allocated and 15.7 GiB reserved but free).  Each timed step therefore
# starts from an empty cache, as the first does; its time includes the
# cache's cudaMalloc calls.
TRAIN_ARCH = "stablelm-3b"
TRAIN_SEQ = 4_096
TRAIN_BATCH = 8
TRAIN_ACCUM = 4
TRAIN_TIMED = 4                 # timed steps after one warm-up step
# The trainer's end-to-end gates run at 2 of the 32 layers and full width
# (checkpoints of ~3.5 GB: parameters and both moments), 4 micro-batches
# of 2 sequences: an uninterrupted run of 4 steps (checkpoints at 2 and
# 4), a run stopped after 2 and resumed from its checkpoint, and a run
# preempted by SIGTERM during step 1.  The resumed run's losses must equal
# the uninterrupted run's within repro's rel 1e-6.
TRAIN_CUT_LAYERS = 2
TRAIN_CUT_STEPS = 4
TRAIN_CUT_ACCUM = 4
TRAIN_RESTART_RTOL = 1e-6
# Card against CPU: one step of the 2-layer full-width model in float32
# activations (remat off: it changes no value) on 1 x 1,024 tokens (the
# blockwise route, 2 x 2 blocks), lr at its peak (warmup 0).  Float32
# sums in other orders (cuBLAS against the CPU's BLAS) keep the loss
# within ~1e-6 and the gradient norm within ~1e-5; AdamW's first update
# is ~lr * g / (|g| + eps), so only entries whose gradient is within a few
# eps (1e-8) of 0 can move, by up to lr: the update of each leaf must
# agree within 1e-3 of its L2 norm.
TRAIN_CPU_SEQ = 1_024
TRAIN_CPU_LOSS_RTOL = 1e-5
TRAIN_CPU_GNORM_RTOL = 1e-4
TRAIN_CPU_UPDATE_RTOL = 1e-3
# Phase 2k: the trainer's mesh path (FSDP over "data", tensor parallelism
# over "model") on a one-rank NCCL group and a (1, 1) mesh: 2j's model,
# seed and batch through make_train_step with the mesh, one warm-up and
# TRAIN_MESH_TIMED timed steps.  At world size 1 every collective is a
# copy or nothing and the mesh path reorders no sum, so the first step's
# loss and grad norm must equal 2j's within TRAIN_MESH_RTOL (and are
# expected bit for bit).  Then train() at 2 layers, TRAIN_MESH_E2E_BATCH
# x TRAIN_SEQ tokens a step, one-device and under the mesh: the same
# checkpoint files byte for byte, and the one-device trainer resumes from
# the mesh's checkpoint to the one-device run's next loss exactly.
TRAIN_MESH_TIMED = 2
TRAIN_MESH_RTOL = 1e-6
TRAIN_MESH_E2E_BATCH = 2
TRAIN_MESH_E2E_STEPS = 2
# Phase 2l: LM serving through the mesh path (prefill_step / decode_step
# with a ShardCtx) on a one-rank NCCL group and a (1, 1) mesh.  yi-6b as
# 2e serves it (its parameters, seed, 8 prompts of 2,048 tokens, max_len
# 2,080, flash on), decoding the 32 tokens 2e fed: every logit equal to
# 2e's bit for bit (at world size 1 every collective is a copy and no sum
# is reordered).  Then the other families at 2i's published widths, cut to
# 2 layer units (zamba2: 2 of its groups, 12 Mamba2 layers and the shared
# block twice): one prefill of 8 x SERVE_MESH_PROMPT positions (past
# attn_block_q's 512, so that flash runs) and SERVE_MESH_DECODE greedy
# steps on the mesh, each equal bit for bit to the one-device steps fed
# the same tokens.  kimi-k2 is left out: one of its layers alone costs
# 2i's time.  Each entry: the config, the layers kept, the flash launches
# of its mesh prefill.
SERVE_MESH_FAMILIES = (
    ("llama4-scout-17b-a16e", 2, 2),
    ("mamba2-2.7b", 2, 0),
    ("zamba2-2.7b", 12, 2),
    ("qwen2-vl-7b", 2, 2),
    ("musicgen-medium", 2, 2),
)
SERVE_MESH_PROMPT = 1_024
SERVE_MESH_DECODE = 4
# Phase 2m: 2l's configs and shapes (2 layer units, 8 x SERVE_MESH_PROMPT
# positions, SERVE_MESH_DECODE steps) served tensor parallel over a
# (1, 2) mesh of two processes on the one card, joined by gloo over CUDA
# tensors, in float32 (activations, parameters and cache) so that the
# split's other order of float32 sums is all that differs.  Logits and
# cache must lie within SERVE_TP_RTOL of the largest |value|, as the CPU
# tests hold the split (tests/test_torch_serve_mesh.py), or within
# SERVE_TP_FLOOR_FACTOR x the distance between two one-device runs whose
# float32 sums differ in order only (SSD in chunks of half the config's,
# attention blockwise in place of the flash kernel: 2i's and 2e's
# substitutions), where that is larger: random-weight SSM stacks carry a
# rounding difference up with depth, and zamba2's 12 Mamba2 layers at
# full width read 4.1e-5 against one device on an H100 (its reordered
# one-device run 4.1e-5 too), where mamba2's 2 layers read 3.2e-6.  Each
# entry: the config, the layers kept, the flash launches of one rank's
# prefill.
SERVE_TP_FAMILIES = SERVE_MESH_FAMILIES
SERVE_TP_MESH = (1, 2)
SERVE_TP_RTOL = 1e-5
SERVE_TP_FLOOR_FACTOR = 2.0
SERVE_TP_TIMEOUT = 600       # seconds for the two ranks' processes

# Phase 2n: the dry run against the card.  `repro_torch.launch.dryrun`
# runs a step on fake tensors on "cuda" (nothing allocated, nothing
# launched) and counts its peak live bytes and its work; the same call
# then runs on the card.  A prediction holds where its peak above the
# step's arguments lies within DRYRUN_MEM_RTOL of the measured one (the
# allocator's max_memory_allocated over the call, less what was allocated
# before it), or within DRYRUN_MEM_ATOL where that is larger (cuBLAS and
# library workspaces sit in the caching allocator but not in a fake run:
# on an H100 the card read +512 bytes, 0, +5,701,632 (0.024 %) and
# +1,048,576 (one op's workspace) over the four predictions below), and
# where its roofline time (the largest of its compute, memory and
# collective terms at the H100's peaks) is at most DRYRUN_ROOFLINE_SLACK
# x the step's measured device time (a roofline above the device time
# means a count is wrong).  The calls: 2e's yi-6b prefill and a decode
# step at the end of its cache, one micro-batch of 2j's stablelm-3b
# training (TRAIN_MICRO sequences, forward + backward, traced at 1 and 2
# layers and extrapolated to 32), and 2c's sharded pair step (the
# session's own index shapes).  Multi-rank meshes run in a process of
# their own (this one has held NCCL groups), whose per-rank peaks are
# printed against the card's memory.  Last, the host cost of the launch
# path: `kernels._cuda.pointers` (a launch's tensors to pointers, a fake
# tensor detected) against bare data_ptr() calls, over each kernel's
# arguments, LAUNCH_HOST_REPS times.
DRYRUN_MEM_RTOL = 0.01
DRYRUN_MEM_ATOL = 16 * 2**20
DRYRUN_ROOFLINE_SLACK = 1.05
DRYRUN_BUDGET_S = 120
TRAIN_MICRO = 2
LAUNCH_HOST_REPS = 10_000
DRYRUN_CELLS = (
    "genpair:serve_256k:1x1", "genpair:serve_256k:1x4",
    "yi-6b:train_4k:4x1", "llama4-scout-17b-a16e:prefill_32k:1x4",
    "llama4-scout-17b-a16e:decode_32k:1x4", "kimi-k2-1t-a32b:decode_32k:1x4")

REPLACES = {
    "seed_buckets": "src/repro/kernels/pair_frontend/kernel.py:118",
    "pair_frontend": "src/repro/kernels/pair_frontend/kernel.py:298",
    "candidate_align": "src/repro/kernels/candidate_align/kernel.py:310",
    "residual_dp": "src/repro/kernels/residual_dp/kernel.py:171",
    "location_vote": "src/repro/kernels/location_vote/kernel.py:148",
    "banded_sw": "src/repro/kernels/banded_sw/kernel.py:224",
    "merge_filter": "src/repro/kernels/pair_frontend/kernel.py:341",
    "light_align": "src/repro/kernels/light_align/kernel.py:169",
    "xxhash32": "src/repro/kernels/xxhash/kernel.py:73",
    "seed_gather": "src/repro/kernels/seed_gather/kernel.py:38",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:91",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["xxhash32"] = "src/repro_torch/csrc/xxhash.cu"
# the __global__ functions each wrapper launches (the profiler's names)
SYMBOLS = {name: (f"{name}_kernel",) for name in REPLACES}
SYMBOLS["banded_sw"] = ("banded_sw_warp_kernel", "banded_sw_thread_kernel")
SYMBOLS["flash_attention"] = ("flash_fma_kernel", "flash_wgmma_kernel")
PAIR_KERNELS = ("seed_buckets", "pair_frontend", "candidate_align",
                "residual_dp")
LONG_KERNELS = ("seed_buckets", "pair_frontend", "location_vote",
                "banded_sw")
SHARDED_KERNELS = ("seed_buckets", "merge_filter", "candidate_align",
                   "residual_dp")
BLOCK_KERNELS = ("light_align", "xxhash32", "seed_gather")
LM_KERNELS = ("flash_attention",)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(work) -> tuple[float, str]:
    """Least time in ms for a launch's `Work` (its kernel's cost function,
    `kernels/*/ops.py`) at the H100 peaks of `repro_torch.roofline`, and
    which of the two bounds it."""
    from repro_torch.roofline import bound_s
    t, by = bound_s(work.bytes, work.ops, work.unit)
    return t * 1e3, by


def _tensors(tree):
    """The tensors of a nested dict of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, name: str, iters: int = 10) -> float | None:
    """Device time of one launch of kernel ``name`` in ``fn()``:
    torch.profiler over ``iters`` calls after one warm-up call, the mean
    of the events of that kernel's own functions (SYMBOLS) that the trace
    holds.  The profiler can drop launches from its trace (on an H100, 1
    to 8 of 10, more late in a run), so a sum over ``iters`` under-reads;
    a line says how many the trace holds when that is fewer than the
    wrapper launched, and None stands where it holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _cuda
    fn()
    torch.cuda.synchronize()
    before = _cuda.launch_counts()[name]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    launched = _cuda.launch_counts()[name] - before
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and any(sym in e.key for sym in SYMBOLS[name])]
    seen = sum(e.count for e in events)
    if seen != launched:
        print(f"[profiler] {name}: the trace holds {seen} of {launched} "
              f"launches")
    if not seen:
        return None
    return sum(e.self_device_time_total for e in events) / 1e3 / seen


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_abs_err(got, want) -> float:
    """Largest |got - want| over every field of two result tuples."""
    worst = 0.0
    for a, b in zip(got, want):
        d = (a.to("cpu").double() - b.to("cpu").double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def profile_step(step, n_items: int, unit: str, key: str, tag: str,
                 record: dict, out_dir: Path) -> None:
    """Steady-state time of one ``step()`` on reads already on the card,
    and where its device time goes (torch.profiler), after the launch
    counts of the main path were read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_ms = time_ms(step, 10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): operator rows repeat the
    # device time of the kernels they launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    nccl_ms = sum(e.self_device_time_total for e in events
                  if "nccl" in e.key.lower()) / 1e3
    top = [{"name": e.key[:80], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3} for e in events[:12]]
    (out_dir / f"profile_{key}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    record[key] = {unit: n_items, "step_ms": step_ms,
                   f"{unit}_per_s": n_items / step_ms * 1e3,
                   "profiled_wall_ms": wall_ms,
                   "device_busy_ms": busy_ms,
                   "device_idle_share": 1 - busy_ms / wall_ms,
                   "nccl_device_ms": nccl_ms, "top": top}
    print(f"{tag} steady {key}: {n_items} {unit} in {step_ms:.3f} ms"
          f" ({n_items / step_ms * 1e3:.0f} {unit}/s); profiled "
          f"step {wall_ms:.3f} ms wall, {busy_ms:.3f} ms device-busy, "
          f"{nccl_ms:.3f} ms in NCCL kernels")
    for t in top:
        print(f"{tag}   {t['device_ms']:9.3f} ms  x{t['calls']:<3d} "
              f"{t['name']}")


def lm_family_run(name: str, n_layers: int | None, want_flash: int,
                  seed: int) -> tuple[dict, dict]:
    """Phase 2i for one config: returns its record and the launches of its
    prefill + decode steps.  Raises on any failed gate."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models import moe
    from repro_torch.models.model import (
        decode_step, model_init_params, prefill_step)
    from repro_torch.models.transformer import _logits, forward

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(name), use_flash_kernel=True)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B, steps = LM_BATCH, LM_FAMILY_DECODE
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = t0 = time.time()
    params = model_init_params(cfg, g, device=dev)
    torch.cuda.synchronize()
    rec = {"layers": cfg.n_layers, "of_layers": full_layers,
           "init_s": time.time() - t0,
           "params": sum(t.numel() for t in _tensors(params)),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in _tensors(params))}

    def batch_of(n_pos: int) -> dict:
        """Seeded prompts of ``n_pos`` positions: vlm's first
        cfg.vision_tokens are patch embeddings (normal x 0.02, bf16)."""
        if cfg.family == "audio":
            shape = (B, n_pos, cfg.n_codebooks)
        else:
            shape = (B, n_pos - (cfg.vision_tokens
                                 if cfg.family == "vlm" else 0))
        out = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                       generator=g, device=dev)}
        if cfg.family == "vlm":
            out["vision_embeds"] = (torch.randn(
                (B, cfg.vision_tokens, cfg.d_model), generator=g,
                device=dev) * 0.02).to(torch.bfloat16)
        return out

    def next_tokens(lg):
        """Greedy: (B, 1) or, for audio's (B, K, V) logits, (B, 1, K)."""
        return lg.argmax(-1)[:, None]

    def run(c, prompt, max_len, n_steps):
        """prefill + greedy decode steps: (prefill logits, decode logits
        (B, n_steps, ...), fed tokens, prefill ms, decode ms per step)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, prompt, c, max_len)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        tok, fed, dec, ms = next_tokens(logits), [], [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            lg, cache = decode_step(params, cache, tok, c)
            fed.append(tok)
            tok = next_tokens(lg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            dec.append(lg)
        if cache.length != max_len:
            raise RuntimeError(f"{name}: cache length {cache.length} after "
                               f"decoding, want {max_len}")
        del cache
        return logits, torch.stack(dec, 1), fed, pre_ms, ms

    def forced(c, prompt, fed, n_prompt):
        """Teacher-forced logits of the fed positions."""
        seq = dict(prompt, tokens=torch.cat([prompt["tokens"]] + fed, 1))
        hidden, _ = forward(params, c, seq, return_hidden=True)
        return _logits(params, c, hidden[:, n_prompt:])

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    # 1. the main path: prefill + decode, launches counted over exactly it
    prompt = batch_of(LM_PROMPT)
    max_len = LM_PROMPT + steps
    _cuda.reset_launches()
    logits, decoded, fed, first_ms, step_ms = run(cfg, prompt, max_len,
                                                  steps)
    launches = _cuda.launch_counts()
    if launches["flash_attention"] != want_flash or any(
            v for k, v in launches.items() if k not in LM_KERNELS):
        raise RuntimeError(f"{name}: launches are off (want {want_flash} "
                           f"flash launches and nothing else): {launches}")
    shape = (B, cfg.n_codebooks, cfg.vocab_size) if cfg.family == "audio" \
        else (B, cfg.vocab_size)
    if logits.shape != shape or decoded.shape != (B, steps) + shape[1:] \
            or not (logits.isfinite().all() and decoded.isfinite().all()):
        raise RuntimeError(f"{name}: logits are not finite or of the wrong "
                           f"shape: {tuple(logits.shape)}, "
                           f"{tuple(decoded.shape)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, spare = prefill_step(params, prompt, cfg, max_len)
    torch.cuda.synchronize()
    rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    del spare
    rec.update(
        first_prefill_ms=first_ms,
        prefill_tokens_per_s=B * LM_PROMPT / rec["prefill_ms"] * 1e3,
        repeat_prefill_max_abs=float((again - logits).abs().max()),
        first_decode_ms=step_ms[0],
        decode_ms_per_step=sum(step_ms[1:]) / (steps - 1))
    rec["decode_tokens_per_s"] = B / rec["decode_ms_per_step"] * 1e3
    rec["launches"] = launches
    del again

    # 2. kernel against plain prefill (phase 2e's gate)
    plain, spare = prefill_step(params, prompt, cfg, max_len,
                                backend="torch")
    del spare
    blockwise, spare = prefill_step(
        params, prompt, dataclasses.replace(cfg, use_flash_kernel=False),
        max_len)
    del spare
    rec["kernel_vs_plain_rel_l2"] = rel(logits, plain)
    rec["blockwise_vs_plain_rel_l2"] = rel(blockwise, plain)
    rec["kernel_vs_plain_limit"] = max(
        LM_PLAIN_TOL, LM_FLOOR_MARGIN * rec["blockwise_vs_plain_rel_l2"])
    del plain, blockwise

    # 3. decode against teacher forcing (moe: apart, at no-drop capacity)
    same = torch.ones((B, steps), dtype=torch.bool, device=dev)
    if cfg.family == "moe":
        nd = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        n_tf = MOE_NO_DROP_PROMPT[name]
        tf_prompt = batch_of(n_tf)
        picks, route = [], moe.route     # each layer's expert ids, in order
        moe.route = lambda lg, k: (lambda r: picks.append(r[1]) or r)(
            route(lg, k))
        try:
            _, tf_decoded, tf_fed, _, _ = run(nd, tf_prompt, n_tf + steps,
                                              steps)
            want = forced(nd, tf_prompt, tf_fed, n_tf)
        finally:
            moe.route = route
        # picks: the prefill's L calls, L per decode step, the forward's L
        L, k = cfg.n_layers, cfg.moe_top_k
        for layer in range(L):
            step_ids = torch.stack([picks[L + t * L + layer].reshape(B, k)
                                    for t in range(steps)], 1)
            forced_ids = picks[L + steps * L + layer].reshape(
                B, n_tf + steps, k)[:, n_tf:]
            same &= (step_ids.sort(-1).values
                     == forced_ids.sort(-1).values).all(-1)
        rec["forced_prompt"] = n_tf
        rec["forced_capacity_factor"] = nd.capacity_factor
    elif cfg.family in ("ssm", "hybrid"):
        # bf16, printed: the SSM stack with random weights carries an ulp
        # far (the distance of bf16 to float32 forcing below says how far)
        chunked = dataclasses.replace(cfg, ssm_chunk=SSM_FORCED_CHUNK)
        rec["decode_vs_forced_bf16_rel_l2"] = rel(
            decoded, forced(chunked, prompt, fed, LM_PROMPT))
        # the gate: the same steps with float32 activations
        f32 = dataclasses.replace(cfg, dtype="float32")
        _, tf_decoded, tf_fed, _, _ = run(f32, prompt, max_len, steps)
        want = forced(dataclasses.replace(f32, ssm_chunk=SSM_FORCED_CHUNK),
                      prompt, tf_fed, LM_PROMPT)
        rec["forced_bf16_vs_float32_rel_l2"] = rel(
            forced(chunked, prompt, tf_fed, LM_PROMPT), want)
        rec["forced_dtype"] = "float32"
    else:
        tf_decoded = decoded
        want = forced(cfg, prompt, fed, LM_PROMPT)
    rec["decode_vs_forced_all_rel_l2"] = rel(tf_decoded, want)
    rec["decode_vs_forced_rel_l2"] = rel(tf_decoded[same], want[same])
    rec["decode_positions_rerouted"] = int((~same).sum())
    agree = tf_decoded.argmax(-1) == want.argmax(-1)
    rec["decode_greedy_agree"] = int(agree.sum())
    rec["decode_greedy_picks"] = agree.numel()
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.time() - t_all
    del params, logits, decoded, tf_decoded, want
    torch.cuda.empty_cache()

    print(f"[2i] {name}: {rec['layers']} of {full_layers} layers, "
          f"{rec['params']} {cfg.param_dtype} parameters "
          f"({rec['param_bytes'] / 1e9:.2f} GB, drawn in "
          f"{rec['init_s']:.1f} s); prefill {B} x {LM_PROMPT}: "
          f"{rec['prefill_ms']:.1f} ms ({rec['prefill_tokens_per_s']:.0f} "
          f"tokens/s; first {first_ms:.1f} ms); decode "
          f"{rec['decode_ms_per_step']:.2f} ms a step "
          f"({rec['decode_tokens_per_s']:.0f} tokens/s); peak "
          f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB; flash launches "
          f"{launches['flash_attention']}")
    print(f"[2i] {name}: kernel vs plain prefill relative L2 "
          f"{rec['kernel_vs_plain_rel_l2']:.3e} (two plain "
          f"{rec['blockwise_vs_plain_rel_l2']:.3e}, limit "
          f"{rec['kernel_vs_plain_limit']:.3e}); decode vs teacher forcing "
          f"{rec['decode_vs_forced_rel_l2']:.3e} (limit {LM_DECODE_TOL}"
          + (f"; {rec['forced_prompt']}-token prompts, capacity factor "
             f"{rec['forced_capacity_factor']:g}; over the "
             f"{B * steps - rec['decode_positions_rerouted']} of "
             f"{B * steps} positions routed alike in every layer, all "
             f"{rec['decode_vs_forced_all_rel_l2']:.3e}"
             if cfg.family == "moe" else "")
          + (f"; float32 activations; in bf16 "
             f"{rec['decode_vs_forced_bf16_rel_l2']:.3e}, bf16 against "
             f"float32 forcing {rec['forced_bf16_vs_float32_rel_l2']:.3e}"
             if "forced_dtype" in rec else "")
          + f"), argmax agrees on {rec['decode_greedy_agree']} "
          f"of {rec['decode_greedy_picks']}; {rec['seconds']:.1f} s")
    if rec["kernel_vs_plain_rel_l2"] > rec["kernel_vs_plain_limit"]:
        raise RuntimeError(f"{name}: kernel prefill differs from the plain "
                           f"one: relative L2 "
                           f"{rec['kernel_vs_plain_rel_l2']}")
    if rec["decode_positions_rerouted"] > MOE_REROUTED_SHARE * B * steps:
        raise RuntimeError(f"{name}: decode and teacher forcing route "
                           f"{rec['decode_positions_rerouted']} of "
                           f"{B * steps} positions to other experts")
    if rec["decode_vs_forced_rel_l2"] > LM_DECODE_TOL:
        raise RuntimeError(f"{name}: decode differs from teacher forcing: "
                           f"relative L2 {rec['decode_vs_forced_rel_l2']}")
    return rec, launches



def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def profile_train_micro(params, cfg, batch: dict, out_dir: Path) -> dict:
    """Where one micro-batch's forward + backward (one sequence of the last
    step's batch, as the train step's ``micro_grads`` runs it) spends its
    time: torch.profiler's device time by kernel against the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import loss_fn
    from repro_torch.tree import tree_leaves

    mb = {k: v[:1] for k, v in batch.items()}
    torch.cuda.synchronize()
    # device activity only: the host side of ~184,000 launches would make
    # the trace, and its summary, minutes long
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = loss_fn(params, mb, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del grads
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    top = [{"name": e.key[:80], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3} for e in events[:12]]
    (out_dir / "profile_train_micro.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=40))
    print(f"[2j] profiled micro-batch (1 x {batch['tokens'].shape[1]} "
          f"tokens, forward + backward): {wall_ms:.1f} ms wall, "
          f"{busy_ms:.1f} ms device-busy (idle {1 - busy_ms / wall_ms:.3f}),"
          f" {launches} device launches")
    for t in top:
        print(f"[2j]   {t['device_ms']:10.3f} ms  x{t['calls']:<6d} "
              f"{t['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_launches": launches, "top": top}


def train_full_width(seed: int, out_dir: Path) -> dict:
    """Phase 2j, part 1: `make_train_step` of stablelm-3b at full width and
    depth; one warm-up step and TRAIN_TIMED timed ones, then a profile of
    one micro-batch."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import TrainRunConfig, make_train_step
    from repro_torch.models.model import model_init_params
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressConfig, init_state
    from repro_torch.roofline import PEAK_FLOPS

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    if not (cfg.remat and cfg.attn_impl == "blockwise"
            and not cfg.use_flash_kernel and cfg.dtype == "bfloat16"
            and cfg.param_dtype == "float32"):
        raise RuntimeError(f"{TRAIN_ARCH} is not in the training setting: "
                           f"{cfg}")
    run = TrainRunConfig(arch=TRAIN_ARCH, smoke=False, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, grad_accum=TRAIN_ACCUM,
                         seed=seed, device="cuda")
    opt_cfg = adamw.OptConfig(lr=run.peak_lr)
    ccfg = CompressConfig()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = model_init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    for p in _tensors(params):
        p.requires_grad_(True)
    opt_state = adamw.init(params, opt_cfg)
    comp = init_state(params, ccfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _tensors(params))
    rec = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "init_s": time.time() - t0,
           "state_bytes": torch.cuda.memory_allocated(),
           "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
           "grad_accum": TRAIN_ACCUM, "steps": []}
    step_fn = make_train_step(cfg, opt_cfg, run, ccfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for step in range(1 + TRAIN_TIMED):
        batch = batch_for_step(data, cfg, step, dev)
        torch.cuda.synchronize()
        # each step from the empty cache the first one had (the note
        # above TRAIN_ARCH)
        torch.cuda.empty_cache()
        t0 = time.time()
        params, opt_state, comp, m = step_fn(params, opt_state, comp, batch,
                                             step)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        rec["steps"].append({"step": step, "ms": ms, "loss": loss,
                             "gnorm": gnorm, "lr": float(m["lr"])})
        print(f"[2j] {TRAIN_ARCH} step {step}"
              f"{' (warm-up)' if step == 0 else ''}: {ms:.1f} ms, loss "
              f"{loss:.6f}, grad norm {gnorm:.6f}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"step {step}: loss {loss}, grad norm {gnorm}")
    timed = [s["ms"] for s in rec["steps"][1:]]
    rec["profile_micro"] = profile_train_micro(params, cfg, batch, out_dir)
    rec["ms_per_step"] = sum(timed) / len(timed)
    rec["tokens_per_s"] = tokens / (rec["ms_per_step"] / 1e3)
    rec["mfu_6n"] = 6 * n_params * tokens / (rec["ms_per_step"] / 1e3) \
        / PEAK_FLOPS
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[2j] {TRAIN_ARCH} full width and depth ({n_params:,} parameters, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {TRAIN_ACCUM} "
          f"micro-batches): {rec['ms_per_step']:.1f} ms a step (steps "
          f"{', '.join(f'{t:.1f}' for t in timed)}), "
          f"{rec['tokens_per_s']:.0f} tokens/s, 6*N*tokens / time / "
          f"989 TFLOP/s = {rec['mfu_6n']:.4f}, peak "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB, init {rec['init_s']:.1f} s")
    return rec


def train_card_vs_cpu(seed: int) -> dict:
    """Phase 2j, part 2: one step of the 2-layer full-width model in float32
    activations on the card and on the CPU from the same parameters and
    batch."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import TrainRunConfig, make_train_step
    from repro_torch.models.model import model_init_params
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressConfig, init_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS, dtype="float32",
                              remat=False)
    run = TrainRunConfig(arch=TRAIN_ARCH, smoke=False, seq_len=TRAIN_CPU_SEQ,
                         global_batch=1, warmup_steps=0, seed=seed,
                         device="cuda")
    opt_cfg = adamw.OptConfig(lr=run.peak_lr)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_CPU_SEQ,
                      global_batch=1, seed=seed)
    cpu_params = model_init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")
    start = tree_map(lambda t: t.clone(), cpu_params)
    out = {}
    for where in ("cuda", "cpu"):
        params = (cpu_params if where == "cpu"
                  else tree_map(lambda t: t.to(where), cpu_params))
        for p in _tensors(params):
            p.requires_grad_(True)
        opt_state = adamw.init(params, opt_cfg)
        comp = init_state(params, CompressConfig())
        step_fn = make_train_step(cfg, opt_cfg, run, CompressConfig())
        t0 = time.time()
        params, _, _, m = step_fn(params, opt_state, comp,
                                  batch_for_step(data, cfg, 0, where), 0)
        out[where] = ({k: float(v) for k, v in m.items()},
                      tree_map(lambda t: t.detach().cpu(), params),
                      time.time() - t0)
    (mg, pg, sg), (mc, pc, sc) = out["cuda"], out["cpu"]
    worst = 0.0
    for a, b, s0 in zip(_tensors(pg), _tensors(pc), _tensors(start)):
        want = b - s0
        worst = max(worst, ((a - s0) - want).norm().item()
                    / max(want.norm().item(), 1e-30))
    rec = {"loss_card": mg["loss"], "loss_cpu": mc["loss"],
           "gnorm_card": mg["gnorm"], "gnorm_cpu": mc["gnorm"],
           "loss_rel": _rel(mg["loss"], mc["loss"]),
           "gnorm_rel": _rel(mg["gnorm"], mc["gnorm"]),
           "update_rel_l2_worst_leaf": worst,
           "params_max_abs": max((a - b).abs().max().item()
                                 for a, b in zip(_tensors(pg),
                                                 _tensors(pc))),
           "lr": mg["lr"], "card_s": sg, "cpu_s": sc}
    print(f"[2j] card against CPU, {TRAIN_CUT_LAYERS} layers at full width, "
          f"float32, 1 x {TRAIN_CPU_SEQ} tokens: loss {mg['loss']:.7f} / "
          f"{mc['loss']:.7f} (rel {rec['loss_rel']:.2e}, limit "
          f"{TRAIN_CPU_LOSS_RTOL:g}), grad norm {mg['gnorm']:.6f} / "
          f"{mc['gnorm']:.6f} (rel {rec['gnorm_rel']:.2e}, limit "
          f"{TRAIN_CPU_GNORM_RTOL:g}), update rel L2 worst leaf "
          f"{worst:.2e} (limit {TRAIN_CPU_UPDATE_RTOL:g}), parameters max "
          f"abs {rec['params_max_abs']:.2e} at lr {mg['lr']:.1e}; CPU "
          f"{sc:.1f} s")
    if not (rec["loss_rel"] <= TRAIN_CPU_LOSS_RTOL
            and rec["gnorm_rel"] <= TRAIN_CPU_GNORM_RTOL
            and worst <= TRAIN_CPU_UPDATE_RTOL):
        raise RuntimeError(f"the card's train step differs from the CPU's: "
                           f"{rec}")
    return rec


def train_end_to_end(seed: int, out_dir: Path) -> dict:
    """Phase 2j, part 3: `train()` at 2 layers and full width: an
    uninterrupted run, a run stopped with ``stop_after`` and resumed from
    its checkpoint, a run preempted by SIGTERM; checkpoints in a directory
    under ``out_dir`` that this phase deletes."""
    import signal
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as train_mod

    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=out_dir))
    real_step = train_mod.make_train_step

    def run_cfg(name: str, **kw):
        return train_mod.TrainRunConfig(
            arch=TRAIN_ARCH, smoke=False, n_layers=TRAIN_CUT_LAYERS,
            steps=TRAIN_CUT_STEPS, global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, grad_accum=TRAIN_CUT_ACCUM, warmup_steps=1,
            ckpt_interval=2, log_interval=1, seed=seed,
            ckpt_dir=str(tmp / name), device="cuda", **kw)

    def metrics(name: str) -> list:
        with open(tmp / name / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    def sigterm_at(step_at: int):
        def make(*a, **kw):
            step_fn = real_step(*a, **kw)

            def wrapped(params, opt, comp, batch, step):
                if step == step_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step_fn(params, opt, comp, batch, step)
            return wrapped
        return make

    rec = {}
    try:
        t0 = time.time()
        full = train_mod.train(run_cfg("a"))
        rec["uninterrupted_s"] = time.time() - t0
        t0 = time.time()
        stopped = train_mod.train(run_cfg("b", stop_after=2))
        resumed = train_mod.train(run_cfg("b"))
        rec["stop_resume_s"] = time.time() - t0
        train_mod.make_train_step = sigterm_at(1)
        try:
            t0 = time.time()
            preempted = train_mod.train(run_cfg("c"))
            rec["preempted_s"] = time.time() - t0
        finally:
            train_mod.make_train_step = real_step
        ckpt_bytes = sum(f.stat().st_size
                         for f in (tmp / "a" / f"step_{4:010d}").iterdir())
        a, b = metrics("a"), metrics("b")
        rec.update(
            checkpoint_bytes=ckpt_bytes,
            losses=[m["loss"] for m in a], gnorms=[m["gnorm"] for m in a],
            resumed_losses=[m["loss"] for m in b],
            resumed_rel=max(_rel(mb["loss"], ma["loss"])
                            for ma, mb in zip(a, b)),
            stopped=stopped, preempted=preempted,
            preempted_latest=Checkpointer(str(tmp / "c")).latest_step(),
            resumed_latest=Checkpointer(str(tmp / "b")).latest_step())
        print(f"[2j] train() at {TRAIN_CUT_LAYERS} layers, full width, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: losses "
              f"{', '.join(f'{x:.6f}' for x in rec['losses'])}, grad norms "
              f"{', '.join(f'{x:.6f}' for x in rec['gnorms'])}; stopped at "
              f"{stopped.get('stopped_at')} and resumed: losses "
              f"{', '.join(f'{x:.6f}' for x in rec['resumed_losses'])} "
              f"(worst rel {rec['resumed_rel']:.2e}, limit "
              f"{TRAIN_RESTART_RTOL:g}); SIGTERM in step 1: stopped at "
              f"{preempted.get('stopped_at')}, latest committed "
              f"{rec['preempted_latest']}; checkpoint "
              f"{ckpt_bytes / 1e9:.2f} GB; {rec['uninterrupted_s']:.1f} / "
              f"{rec['stop_resume_s']:.1f} / {rec['preempted_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    values = rec["losses"] + rec["gnorms"] + rec["resumed_losses"]
    if not all(math.isfinite(x) for x in values):
        raise RuntimeError(f"non-finite loss or grad norm: {values}")
    if full.get("finished") != TRAIN_CUT_STEPS \
            or resumed.get("finished") != TRAIN_CUT_STEPS \
            or stopped.get("stopped_at") != 2:
        raise RuntimeError(f"train() runs ended wrongly: {full}, {stopped}, "
                           f"{resumed}")
    if len(rec["resumed_losses"]) != TRAIN_CUT_STEPS \
            or rec["resumed_rel"] > TRAIN_RESTART_RTOL:
        raise RuntimeError(f"the resumed run differs from the uninterrupted "
                           f"one: {rec['losses']} against "
                           f"{rec['resumed_losses']}")
    if preempted.get("stopped_at") != 2 or rec["preempted_latest"] != 2 \
            or rec["resumed_latest"] != TRAIN_CUT_STEPS:
        raise RuntimeError(f"preemption: {preempted}, latest committed "
                           f"{rec['preempted_latest']}")
    return rec


def flash_refuses_autograd() -> str:
    """Phase 2j, part 4: the flash kernel's wrapper raises under autograd
    on the card, before any launch."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = (torch.randn((4, 256, 128), device="cuda",
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    try:
        flash_attention(q, k, v)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        return str(e)
    raise RuntimeError("flash_attention under autograd on the card returned "
                       "an output with no gradient instead of raising")


def train_mesh_full_width(seed: int, mesh, first: dict) -> dict:
    """Phase 2k, part 1: 2j's model, seed and batch through
    `make_train_step` with a (1, 1) mesh on the one-rank NCCL group; the
    first step against 2j's first (``first``)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import TrainRunConfig, make_train_step
    from repro_torch.models.model import model_init_params, param_shardings
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressConfig, init_state

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    run = TrainRunConfig(arch=TRAIN_ARCH, smoke=False, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, grad_accum=TRAIN_ACCUM,
                         seed=seed, device="cuda")
    opt_cfg = adamw.OptConfig(lr=run.peak_lr)
    ccfg = CompressConfig()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    psh = param_shardings(cfg, mesh)
    params = model_init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, psh, mesh.get_coordinate())
    for p in _tensors(params):
        p.requires_grad_(True)
    opt_state = adamw.init(params, opt_cfg, psh)
    comp = init_state(params, ccfg)
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size()
               for t in list(_tensors(params)) + list(_tensors(opt_state.m))
               + list(_tensors(opt_state.v)))
    rec = {"mesh": list(mesh.shape), "init_s": time.time() - t0,
           "rank_state_bytes": held, "steps": []}
    step_fn = make_train_step(cfg, opt_cfg, run, ccfg, mesh)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for step in range(1 + TRAIN_MESH_TIMED):
        batch = batch_for_step(data, cfg, step, dev)
        torch.cuda.synchronize()
        # each step from the empty cache the first one had (the note
        # above TRAIN_ARCH)
        torch.cuda.empty_cache()
        t0 = time.time()
        params, opt_state, comp, m = step_fn(params, opt_state, comp, batch,
                                             step)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        rec["steps"].append({"step": step, "ms": ms, "loss": loss,
                             "gnorm": gnorm})
        print(f"[2k] {TRAIN_ARCH} on the (1, 1) mesh, step {step}"
              f"{' (warm-up)' if step == 0 else ''}: {ms:.1f} ms, loss "
              f"{loss:.6f}, grad norm {gnorm:.6f}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"step {step}: loss {loss}, grad norm {gnorm}")
    timed = [s["ms"] for s in rec["steps"][1:]]
    rec["ms_per_step"] = sum(timed) / len(timed)
    rec["tokens_per_s"] = tokens / (rec["ms_per_step"] / 1e3)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    s0 = rec["steps"][0]
    rec["loss_rel"] = _rel(s0["loss"], first["loss"])
    rec["gnorm_rel"] = _rel(s0["gnorm"], first["gnorm"])
    rec["bit_identical"] = (s0["loss"] == first["loss"]
                            and s0["gnorm"] == first["gnorm"])
    print(f"[2k] mesh path {rec['ms_per_step']:.1f} ms a step "
          f"({', '.join(f'{t:.1f}' for t in timed)}), "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB, "
          f"{held / 2**30:.2f} GiB of parameters and moments on the rank; "
          f"first step against 2j's: loss rel {rec['loss_rel']:.2e}, grad "
          f"norm rel {rec['gnorm_rel']:.2e} (limit {TRAIN_MESH_RTOL:g}; "
          f"bit for bit: {rec['bit_identical']})")
    if rec["loss_rel"] > TRAIN_MESH_RTOL or rec["gnorm_rel"] > \
            TRAIN_MESH_RTOL:
        raise RuntimeError(f"the mesh path's first step differs from 2j's: "
                           f"{s0} against {first}")
    return rec


def train_mesh_end_to_end(seed: int, out_dir: Path, store: Path) -> dict:
    """Phase 2k, part 2: train() at 2 layers and full width without a
    process group, then on the one-rank NCCL group's (1, 1) mesh: the
    same checkpoint files; the one-device trainer resumes from the mesh's
    checkpoint.  Checkpoints in a directory under ``out_dir`` that this
    phase deletes."""
    import filecmp
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import train as train_mod

    tmp = Path(tempfile.mkdtemp(prefix="train_mesh_", dir=out_dir))

    def run_cfg(name: str, steps: int):
        return train_mod.TrainRunConfig(
            arch=TRAIN_ARCH, smoke=False, n_layers=TRAIN_CUT_LAYERS,
            steps=steps, global_batch=TRAIN_MESH_E2E_BATCH,
            seq_len=TRAIN_SEQ, warmup_steps=1, ckpt_interval=steps,
            log_interval=100, seed=seed, ckpt_dir=str(tmp / name),
            device="cuda")

    def metrics(name: str) -> list:
        with open(tmp / name / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    rec = {}
    try:
        n = TRAIN_MESH_E2E_STEPS
        t0 = time.time()
        train_mod.train(run_cfg("one", n))
        rec["one_device_s"] = time.time() - t0
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=300))
        try:
            t0 = time.time()
            train_mod.train(run_cfg("mesh", n))
            rec["mesh_s"] = time.time() - t0
        finally:
            dist.destroy_process_group()
        step_dir = f"step_{n:010d}"
        files = sorted(os.listdir(tmp / "one" / step_dir))
        _, differ, missing = filecmp.cmpfiles(
            tmp / "one" / step_dir, tmp / "mesh" / step_dir, files,
            shallow=False)
        rec["checkpoint_files"] = len(files)
        rec["checkpoint_bytes"] = sum(
            (tmp / "one" / step_dir / f).stat().st_size for f in files)
        rec["files_differ"] = differ + missing
        extra = sorted(set(os.listdir(tmp / "mesh" / step_dir)) - set(files))
        # the one-device trainer, one step on from each checkpoint
        for name in ("one", "mesh"):
            train_mod.train(run_cfg(name, n + 1))
        a, b = metrics("one"), metrics("mesh")
        rec.update(losses=[m["loss"] for m in a],
                   mesh_losses=[m["loss"] for m in b])
        print(f"[2k] train() at {TRAIN_CUT_LAYERS} layers, full width, "
              f"{TRAIN_MESH_E2E_BATCH} x {TRAIN_SEQ} tokens a step: losses "
              f"one-device {', '.join(f'{x:.6f}' for x in rec['losses'])}, "
              f"mesh {', '.join(f'{x:.6f}' for x in rec['mesh_losses'])} "
              f"(the last of each resumed one-device from its checkpoint); "
              f"step {n} checkpoints: {len(files)} files, "
              f"{rec['checkpoint_bytes'] / 1e9:.2f} GB, "
              f"{len(rec['files_differ'])} differ; {rec['one_device_s']:.1f}"
              f" / {rec['mesh_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rec["files_differ"] or extra:
        raise RuntimeError(f"the mesh's checkpoint differs from the one "
                           f"device's in {rec['files_differ'] + extra}")
    if rec["losses"] != rec["mesh_losses"] or len(rec["losses"]) != n + 1:
        raise RuntimeError(f"train() under the mesh and resumed from it "
                           f"differs from one device: {rec['losses']} "
                           f"against {rec['mesh_losses']}")
    return rec


def _cache_tensors(cache) -> list:
    """The buffers of a DecodeCache (KV and SSM states)."""
    return [t for t in (cache.kv_k, cache.kv_v, *cache.ssm)
            if not isinstance(t, tuple)]


def serve_mesh_yi(mesh, ref: dict, out_dir: Path) -> tuple[dict, dict]:
    """Phase 2l, part 1: yi-6b through prefill_step / decode_step under a
    ShardCtx of ``mesh`` (2e's parameters, prompts and fed tokens, ``ref``
    on the host): its record and the launches of its mesh prefill and
    decode steps; one profiled mesh decode step into ``out_dir``.  Raises
    unless every logit equals 2e's bit for bit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.model import (
        decode_step, model_init_params, param_shardings, prefill_step)
    from repro_torch.sharding.partition import ShardCtx

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("yi-6b"), use_flash_kernel=True)
    ctx = ShardCtx(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = model_init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
        param_shardings(cfg, mesh), mesh.get_coordinate())
    torch.cuda.synchronize()
    rec = {"init_s": time.time() - t0, "param_bytes": sum(
        t.numel() * t.element_size() for t in _tensors(params))}
    batch = {"tokens": ref["tokens"].to(dev)}
    fed = ref["fed"].to(dev)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch, cfg, LM_MAX_LEN, ctx=ctx)
    torch.cuda.synchronize()
    rec["first_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    dec, step_ms = [], []
    for i in range(LM_DECODE):
        t0 = time.perf_counter()
        lg, cache = decode_step(params, cache, fed[:, i:i + 1], cfg, ctx=ctx)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        dec.append(lg)
    launches = _cuda.launch_counts()
    rec["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in _cache_tensors(cache))
    # where a mesh decode step's time goes (one step at the end of the
    # cache, as 2e profiles its own)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_step(params, cache._replace(length=LM_MAX_LEN - 1),
                    fed[:, -1:], cfg, ctx=ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    (out_dir / "profile_lm_decode_mesh.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=30))
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    rec["decode_profile"] = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "nccl_device_ms": sum(e.self_device_time_total for e in dev_events
                              if "nccl" in e.key.lower()) / 1e3,
        "copy_device_ms": sum(e.self_device_time_total for e in dev_events
                              if "memcpy" in e.key.lower()
                              or "copy" in e.key.lower()) / 1e3}
    rec["prefill_equal"] = bool(torch.equal(logits.cpu(), ref["logits"]))
    rec["decode_steps_equal"] = sum(
        bool(torch.equal(d.cpu(), ref["decoded"][:, i]))
        for i, d in enumerate(dec))
    rec["length"] = cache.length
    del cache, dec
    prefill_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, spare = prefill_step(params, batch, cfg, LM_MAX_LEN, ctx=ctx)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        del spare
    rec["prefill_ms"] = min(prefill_ms)
    rec["prefill_tokens_per_s"] = LM_BATCH * LM_PROMPT / rec["prefill_ms"] \
        * 1e3
    rec["decode_ms_per_step"] = sum(step_ms[1:]) / (LM_DECODE - 1)
    rec["decode_tokens_per_s"] = LM_BATCH / rec["decode_ms_per_step"] * 1e3
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    rec["launches"] = launches
    del params, logits
    torch.cuda.empty_cache()
    print(f"[2l] yi-6b on the (1, 1) mesh: prefill {LM_BATCH} x "
          f"{LM_PROMPT}: {rec['prefill_ms']:.1f} ms "
          f"({rec['prefill_tokens_per_s']:.0f} tokens/s; first "
          f"{rec['first_prefill_ms']:.1f} ms) against 2e's "
          f"{ref['prefill_ms']:.1f} ms; decode "
          f"{rec['decode_ms_per_step']:.2f} ms a step "
          f"({rec['decode_tokens_per_s']:.0f} tokens/s) against 2e's "
          f"{ref['decode_ms_per_step']:.2f} ms; peak "
          f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB; the rank holds "
          f"{rec['param_bytes'] / 1e9:.2f} GB of parameters and "
          f"{rec['cache_bytes'] / 1e9:.3f} GB of cache; logits equal to "
          f"2e's bit for bit: prefill {rec['prefill_equal']}, decode "
          f"{rec['decode_steps_equal']} of {LM_DECODE} steps; flash "
          f"launches {launches['flash_attention']}")
    p = rec["decode_profile"]
    print(f"[2l] profiled mesh decode step: {p['wall_ms']:.1f} ms wall, "
          f"{p['device_busy_ms']:.1f} ms device-busy, of which "
          f"{p['nccl_device_ms']:.1f} ms in NCCL kernels and "
          f"{p['copy_device_ms']:.1f} ms in copies (at a data extent of 1 "
          f"nothing is gathered: the weights' casts to bf16; "
          f"chiprun_out/profile_lm_decode_mesh.txt)")
    if not rec["prefill_equal"] or rec["decode_steps_equal"] != LM_DECODE \
            or rec["length"] != LM_MAX_LEN:
        raise RuntimeError(f"yi-6b through the mesh path differs from 2e: "
                           f"{rec}")
    return rec, launches


def serve_mesh_family(name: str, n_layers: int, want_flash: int, seed: int,
                      mesh) -> tuple[dict, dict]:
    """Phase 2l, part 2: one config at its published width, cut to
    ``n_layers``, through the mesh path and through the one-device steps
    fed the same tokens: its record and the launches of its mesh run.
    Raises unless the two are equal bit for bit."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.model import (
        decode_step, model_init_params, param_shardings, prefill_step)
    from repro_torch.sharding.partition import ShardCtx

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(name), use_flash_kernel=True,
                              n_layers=n_layers)
    B, S, steps = LM_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_DECODE
    max_len = S + steps
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.time()
    params = model_init_params(cfg, g, dev, param_shardings(cfg, mesh),
                               mesh.get_coordinate())
    if cfg.family == "audio":
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (B, S, cfg.n_codebooks),
                                         generator=g, device=dev)}
    else:
        sv = S // 4 if cfg.family == "vlm" else 0
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - sv),
                                         generator=g, device=dev)}
        if sv:
            batch["vision_embeds"] = (torch.randn(
                (B, sv, cfg.d_model), generator=g, device=dev)
                * 0.02).to(torch.bfloat16)

    def run(ctx, feed=None):
        """prefill + decode steps, greedy unless ``feed`` gives the
        tokens: (logits (steps + 1, ...), fed tokens, cache, ms)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill_step(params, batch, cfg, max_len, ctx=ctx)
        out, fed = [lg], []
        for i in range(steps):
            tok = lg.argmax(-1)[:, None] if feed is None else feed[i]
            fed.append(tok)
            lg, cache = decode_step(params, cache, tok, cfg, ctx=ctx)
            out.append(lg)
        torch.cuda.synchronize()
        return (torch.stack(out), fed, cache,
                (time.perf_counter() - t0) * 1e3)

    _cuda.reset_launches()
    got, fed, got_cache, mesh_ms = run(ShardCtx(mesh))
    launches = _cuda.launch_counts()
    want, _, want_cache, one_ms = run(None, fed)
    rec = {"layers": cfg.n_layers, "mesh_ms": mesh_ms, "one_device_ms":
           one_ms, "logits_equal": bool(torch.equal(got, want)),
           "cache_equal": all(torch.equal(a, b) for a, b in zip(
               _cache_tensors(got_cache), _cache_tensors(want_cache))),
           "finite": bool(got.isfinite().all()), "launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del params, got, want, got_cache, want_cache, batch
    torch.cuda.empty_cache()
    rec["seconds"] = time.time() - t_all
    print(f"[2l] {name}: {cfg.n_layers} layers at full width, {B} x {S} "
          f"positions + {steps} decode steps: mesh {mesh_ms:.1f} ms, one "
          f"device {one_ms:.1f} ms; logits equal {rec['logits_equal']}, "
          f"cache equal {rec['cache_equal']}; flash launches "
          f"{launches['flash_attention']}; peak "
          f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB; {rec['seconds']:.1f} s")
    if not (rec["logits_equal"] and rec["cache_equal"] and rec["finite"]):
        raise RuntimeError(f"{name}: the mesh path differs from one device: "
                           f"{rec}")
    if launches["flash_attention"] != want_flash or any(
            v for k, v in launches.items() if k not in LM_KERNELS):
        raise RuntimeError(f"{name}: mesh launches are off (want "
                           f"{want_flash} flash launches and nothing "
                           f"else): {launches}")
    return rec, launches


def _serve_tp_model(i: int, mesh=None):
    """Phase 2m's config ``i``: (cfg, parameters, prompt batch, max_len),
    the parameters whole or, on ``mesh``, this rank's slices of the same
    draw (the batch drawn after them from the same generator)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import model_init_params, param_shardings

    name, n_layers, _ = SERVE_TP_FAMILIES[i]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(name), use_flash_kernel=True,
                              n_layers=n_layers, dtype="float32",
                              param_dtype="float32")
    B, S = LM_BATCH, SERVE_MESH_PROMPT
    g = torch.Generator(device=dev).manual_seed(SEED + 110 + i)
    params = model_init_params(
        cfg, g, dev, None if mesh is None else param_shardings(cfg, mesh),
        None if mesh is None else mesh.get_coordinate())
    if cfg.family == "audio":
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (B, S, cfg.n_codebooks),
                                         generator=g, device=dev)}
    else:
        sv = S // 4 if cfg.family == "vlm" else 0
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - sv),
                                         generator=g, device=dev)}
        if sv:
            batch["vision_embeds"] = torch.randn(
                (B, sv, cfg.d_model), generator=g, device=dev) * 0.02
    return cfg, params, batch, S + SERVE_MESH_DECODE


class _Routes:
    """The expert ids of every MoE routing while it is entered
    (`moe.route`'s top k), in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.seen, self._moe, self._real = [], moe, moe.route

        def recording(logits, k):
            out = self._real(logits, k)
            self.seen.append(out[1].cpu())
            return out

        moe.route = recording
        return self.seen

    def __exit__(self, *exc):
        self._moe.route = self._real


def _max_rel(a, b) -> float:
    """max |a - b| over max |b| (tensors)."""
    return float((a - b).abs().max() / b.abs().max())


def serve_tp_reference(i: int, work: Path) -> dict:
    """Phase 2m, one device: config ``i``'s prefill and greedy decode
    steps, whose logits, fed tokens, final cache and routings go to
    ``work`` for the ranks; then the same tokens through the config with
    its float32 sums in another order (SERVE_TP_FLOOR_FACTOR's note).
    Its record, with that run's distance ("floor")."""
    import torch

    from repro_torch.models.model import decode_step, prefill_step

    cfg, params, batch, max_len = _serve_tp_model(i)

    def run(cfg, feed=None):
        lg, cache = prefill_step(params, batch, cfg, max_len, torch.float32)
        out, fed = [lg], []
        for j in range(SERVE_MESH_DECODE):
            tok = lg.argmax(-1)[:, None] if feed is None else feed[j]
            fed.append(tok)
            lg, cache = decode_step(params, cache, tok, cfg)
            out.append(lg)
        return torch.stack(out), fed, cache

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Routes() as routes:
        logits, fed, cache = run(cfg)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    other, _, other_cache = run(dataclasses.replace(
        cfg, use_flash_kernel=False, ssm_chunk=cfg.ssm_chunk // 2), fed)
    floor = max([_max_rel(other, logits)] + [
        _max_rel(a, b) for a, b in zip(_cache_tensors(other_cache),
                                   _cache_tensors(cache))])
    torch.save({"logits": logits.cpu(), "fed": [t.cpu() for t in fed],
                "cache": [t.cpu() for t in _cache_tensors(cache)],
                "routes": routes}, work / f"ref_{i}.pt")
    rec = {"one_device_ms": ms, "floor": floor, "param_bytes": sum(
        t.numel() * t.element_size() for t in _tensors(params))}
    del params, cache, other_cache, logits, other
    torch.cuda.empty_cache()
    return rec


def serve_tp_rank(rank: int, work: Path) -> int:
    """Phase 2m, one of the two ranks (``python3 chip_smoke.py
    --serve-tp-rank RANK WORK``): a gloo group over ``work``'s file store,
    the (1, 2) mesh on the one card, and every config served through it
    against the one-device run's files; its records into ``work``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.models.model import decode_step, init_cache, prefill_step
    from repro_torch.sharding.partition import ShardCtx, Sharding, cache_specs

    torch.cuda.set_device(0)
    world = SERVE_TP_MESH[0] * SERVE_TP_MESH[1]
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SERVE_TP_TIMEOUT))
    recs = {}
    try:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(SERVE_TP_MESH),
                          mesh_dim_names=("data", "model"))
        coord = mesh.get_coordinate()
        ctx = ShardCtx(mesh)
        for i, (name, _, _) in enumerate(SERVE_TP_FAMILIES):
            ref = torch.load(work / f"ref_{i}.pt")
            torch.cuda.reset_peak_memory_stats()
            cfg, params, batch, max_len = _serve_tp_model(i, mesh)
            _cuda.reset_launches()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _Routes() as routes:
                lg, cache = prefill_step(params, batch, cfg, max_len,
                                         torch.float32, ctx=ctx)
                out = [lg]
                for tok in ref["fed"]:
                    lg, cache = decode_step(params, cache, tok.cuda(), cfg,
                                            ctx=ctx)
                    out.append(lg)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _cuda.launch_counts()
            got, want = torch.stack(out).cpu(), ref["logits"]
            whole = init_cache(cfg, LM_BATCH, max_len, torch.float32,
                               "meta")
            specs = cache_specs(whole, mesh)
            cache_rel = []
            for t, w, spec in zip(_cache_tensors(cache), ref["cache"],
                                  [sp for sp in (specs.kv_k, specs.kv_v,
                                                 *specs.ssm) if len(sp)]):
                w = w[Sharding(mesh, spec).local_index(tuple(w.shape),
                                                       coord)]
                cache_rel.append(_max_rel(t.cpu(), w))
            recs[name] = {
                "mesh_ms": ms,
                "logits_rel": _max_rel(got, want),
                "cache_rel": max(cache_rel),
                "routes_equal": len(routes) == len(ref["routes"]) and all(
                    torch.equal(a, b) for a, b in zip(routes,
                                                      ref["routes"])),
                "routings": len(routes),
                "finite": bool(got.isfinite().all()),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in _tensors(params)),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches": launches}
            del params, cache, out, lg, got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    (work / f"rank_{rank}.json").write_text(json.dumps(recs))
    return 0


def serve_tp(out_dir: Path) -> tuple[dict, dict]:
    """Phase 2m: the one-device runs in this process, freed, then the two
    ranks' processes; their records and the launches of both ranks'
    mesh runs.  Raises unless every config agrees within SERVE_TP_RTOL,
    routes alike and launches its flash kernels and nothing else."""
    import tempfile

    import torch

    work = Path(tempfile.mkdtemp(prefix="serve_tp_", dir=out_dir)).resolve()
    try:
        refs = {}
        for i, (name, _, _) in enumerate(SERVE_TP_FAMILIES):
            refs[name] = serve_tp_reference(i, work)
        torch.cuda.empty_cache()
        t0 = time.time()
        env = {"GLOO_SOCKET_IFNAME": "lo", **os.environ}
        procs = [subprocess.Popen([sys.executable, str(Path(__file__)
                                                       .resolve()),
                                   "--serve-tp-rank", str(r), str(work)],
                                  env=env)
                 for r in range(SERVE_TP_MESH[0] * SERVE_TP_MESH[1])]
        try:
            rcs = [p.wait(timeout=SERVE_TP_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.time() - t0
        if any(rcs):
            raise RuntimeError(f"phase 2m's ranks exited {rcs}")
        ranks = [json.loads((work / f"rank_{r}.json").read_text())
                 for r in range(len(procs))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {k: 0 for k in REPLACES}
    recs = {"ranks_s": ranks_s}
    for name, _, n_flash in SERVE_TP_FAMILIES:
        per = [r[name] for r in ranks]
        for p in per:
            for k, v in p["launches"].items():
                launches[k] += v
        rec = {**refs[name], "ranks": per}
        recs[name] = rec
        worst = max(max(p["logits_rel"], p["cache_rel"]) for p in per)
        limit = max(SERVE_TP_RTOL, SERVE_TP_FLOOR_FACTOR * rec["floor"])
        rec.update(worst=worst, limit=limit)
        print(f"[2m] {name}: (1, 2) mesh of two gloo ranks on one card, "
              f"{LM_BATCH} x {SERVE_MESH_PROMPT} positions + "
              f"{SERVE_MESH_DECODE} decode steps in float32: rank 0 "
              f"{per[0]['mesh_ms']:.1f} ms, one device "
              f"{rec['one_device_ms']:.1f} ms; worst logits / cache "
              f"against one device {worst:.2e} (limit {limit:.2e}: "
              f"{SERVE_TP_RTOL}, or {SERVE_TP_FLOOR_FACTOR} x the "
              f"reordered one-device run's {rec['floor']:.2e}); "
              f"routings alike {all(p['routes_equal'] for p in per)} "
              f"({per[0]['routings']}); a rank holds "
              f"{per[0]['param_bytes'] / 1e9:.2f} of "
              f"{rec['param_bytes'] / 1e9:.2f} GB of parameters, peak "
              f"{max(p['peak_mem_bytes'] for p in per) / 2**30:.2f} GiB; "
              f"flash launches {[p['launches']['flash_attention'] for p in per]}")
        if worst > limit or not all(
                p["routes_equal"] and p["finite"] for p in per):
            raise RuntimeError(f"{name}: the (1, 2) mesh differs from one "
                               f"device: {rec}")
        if any(p["launches"]["flash_attention"] != n_flash or any(
                v for k, v in p["launches"].items() if k not in LM_KERNELS)
               for p in per):
            raise RuntimeError(f"{name}: a rank's launches are off (want "
                               f"{n_flash} flash launches and nothing "
                               f"else): {per}")
    return recs, launches


def _peak_above(fn):
    """``fn()``'s result and the caching allocator's peak over the call less
    what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _hold_dry(name: str, dry: dict, above: int, device_ms: float) -> dict:
    """Phase 2n's gates for one step: the dry run's peak above the step's
    arguments against the card's, its roofline time against the step's
    measured device time."""
    from repro_torch.roofline import roofline
    mem, c = dry["memory"], dry["costs"]
    pred = mem["peak_bytes"] - mem["argument_size_in_bytes"]
    tol = max(DRYRUN_MEM_RTOL * above, DRYRUN_MEM_ATOL)
    rf = roofline(c["flops_by_dtype"], c["int_ops"], c["bytes"], c["coll"],
                  c["coll_s"], 1, 0.0)
    rl_ms = rf.time_s * 1e3
    rec = {"predicted_above_bytes": pred, "measured_above_bytes": above,
           "tolerance_bytes": tol, "argument_bytes": mem["argument_bytes"],
           "memory": mem, "roofline": rf.as_dict(), "roofline_ms": rl_ms,
           "device_ms": device_ms, "roofline_share": rl_ms / device_ms,
           "kernels": c["kernels"], "traced": dry.get("traced")}
    print(f"[2n] {name}: peak above its arguments predicted "
          f"{pred / 2**30:.3f} GiB, measured {above / 2**30:.3f} GiB "
          f"(tolerance {tol / 2**30:.3f}); roofline {rl_ms:.3f} ms "
          f"({rf.bottleneck}: compute {rf.compute_s * 1e3:.3f}, memory "
          f"{rf.memory_s * 1e3:.3f}) = {rl_ms / device_ms:.3f} of the "
          f"measured {device_ms:.3f} ms of device time")
    if abs(pred - above) > tol:
        raise RuntimeError(f"{name}: the dry run's peak {pred} bytes is off "
                           f"the card's {above} by more than {tol:.0f}")
    if rl_ms > DRYRUN_ROOFLINE_SLACK * device_ms:
        raise RuntimeError(f"{name}: a roofline of {rl_ms:.3f} ms over "
                           f"{device_ms:.3f} ms of device time: a count is "
                           f"wrong")
    return rec


def _launch_host_us(dev) -> dict:
    """Each kernel's launch arguments (a CUDA tensor for each pointer, 1
    for each value; the stream left out) through `_cuda.pointers`, and
    through bare data_ptr() calls, the path before it: host µs a launch."""
    import torch

    from repro_torch.kernels import _cuda
    t = torch.zeros(1, device=dev)
    out = {}
    for name, k in sorted(_cuda.KERNELS.items()):
        args = [t if a is _cuda.PTR else 1 for a in k.argtypes[:-1]]

        def bare(args=args):
            return [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args]

        us = {}
        for key, fn in (("pointers", _cuda.pointers), ("data_ptr", bare)):
            t0 = time.perf_counter()
            for _ in range(LAUNCH_HOST_REPS):
                fn(args)
            us[key] = (time.perf_counter() - t0) / LAUNCH_HOST_REPS * 1e6
        out[name] = {"args": len(args), "pointers_us": us["pointers"],
                     "data_ptr_us": us["data_ptr"]}
        print(f"[2n] launch path of {name} ({len(args)} arguments): "
              f"pointers {us['pointers']:.3f} µs, bare data_ptr "
              f"{us['data_ptr']:.3f} µs a launch (host)")
    return out


def _micro_grads(params, batch, cfg):
    """One training micro-batch as `make_train_step` runs it: the loss and
    every parameter's gradient."""
    import torch

    from repro_torch.models.model import loss_fn
    from repro_torch.tree import tree_leaves
    loss, _ = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def dryrun_against_card(record: dict, pair: dict, out_dir: Path) -> dict:
    """Phase 2n (see DRYRUN_MEM_RTOL): the dry runs of 2e's prefill and
    decode, 2j's micro-batch and 2c's pair step held against the card,
    and the multi-rank cells' per-rank peaks from a process of their
    own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.genpairx_step import GenPairScale
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import dryrun
    from repro_torch.models.model import (
        decode_step, make_smoke_batch, model_init_params, prefill_step)
    from repro_torch.models.transformer import init_cache

    t0 = time.time()
    cells_dir = out_dir / "dryrun_torch"
    shutil.rmtree(cells_dir, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(
        Path(__file__).resolve().parent / "src")}
    cells = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cuda", "--no-exact", "--out", str(cells_dir),
         *itertools.chain.from_iterable(("--cell", c) for c in
                                        DRYRUN_CELLS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    dev = torch.device("cuda")
    yi = dataclasses.replace(get_config("yi-6b"), use_flash_kernel=True)
    st = get_config(TRAIN_ARCH)

    def yi_build(decode: bool):
        def build():
            params = dryrun.fake_params(yi, None, None, dev, False)
            if not decode:
                tokens = torch.empty((LM_BATCH, LM_PROMPT), dtype=torch.int64,
                                     device=dev)
                return (lambda: prefill_step(params, {"tokens": tokens}, yi,
                                             LM_MAX_LEN),
                        {"params": params, "batch": tokens})
            tok = torch.empty((LM_BATCH, 1), dtype=torch.int64, device=dev)
            cache = init_cache(yi, LM_BATCH, LM_MAX_LEN, torch.bfloat16,
                               dev)._replace(length=LM_MAX_LEN - 1)
            return (lambda: decode_step(params, cache, tok, yi),
                    {"params": params, "cache": cache, "batch": tok})
        return build

    def micro_build(cfg):
        def build():
            params = dryrun.fake_params(cfg, None, None, dev, True)
            tok = torch.empty((TRAIN_MICRO, TRAIN_SEQ), dtype=torch.int32,
                              device=dev)
            batch = {"tokens": tok, "labels": tok}
            return (lambda: _micro_grads(params, batch, cfg),
                    {"params": params, "batch": batch})
        return build

    # the dry runs: fakes on "cuda", and not a byte allocated on the card
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t_dry = time.time()
    dry = {"prefill": dryrun.trace(yi_build(False), "cuda"),
           "decode": dryrun.trace(yi_build(True), "cuda"),
           "train_micro": dryrun.trace_depth(micro_build, st, "cuda")}
    scale = GenPairScale(genome_len=pair["genome_len"],
                         table_bits=pair["table_bits"],
                         n_locations=pair["n_locations"],
                         global_batch=pair["batch"], read_len=pair["read_len"])
    with dryrun.fake_world(1):
        dry["pair_step"] = dryrun.trace(dryrun.genpair_step(
            scale, pair["pipe"], pair["sm_cfg"], (1, 1), "cuda"), "cuda")
    torch.cuda.synchronize()
    dry_s = time.time() - t_dry
    if torch.cuda.memory_allocated() != held:
        raise RuntimeError(f"the dry runs allocated "
                           f"{torch.cuda.memory_allocated() - held} bytes on "
                           f"the card")
    print(f"[2n] dry runs of four steps on fake tensors in {dry_s:.1f} s; "
          f"{held} bytes allocated before and after them")

    # the same calls on the card
    rec = {"dry_s": dry_s, "allocated_unchanged": True}
    lm = record["lm"]
    params = model_init_params(
        yi, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    tokens = make_smoke_batch(yi, LM_BATCH, LM_PROMPT, seed=SEED + 30,
                              device=dev)["tokens"]
    (logits, cache), above = _peak_above(
        lambda: prefill_step(params, {"tokens": tokens}, yi, LM_MAX_LEN))
    rec["prefill"] = _hold_dry("yi-6b prefill 8 x 2,048", dry["prefill"],
                               above, lm["profile"]["device_busy_ms"])
    cache = cache._replace(length=LM_MAX_LEN - 1)
    tok = logits.argmax(-1)[:, None]
    del logits
    _, above = _peak_above(lambda: decode_step(params, cache, tok, yi))
    rec["decode"] = _hold_dry("yi-6b decode step at position 2,079",
                              dry["decode"], above,
                              lm["decode_profile"]["device_busy_ms"])
    del params, tokens, cache, tok, _
    torch.cuda.empty_cache()

    params = model_init_params(
        st, torch.Generator(device=dev).manual_seed(SEED + 90), device=dev)
    for p in _tensors(params):
        p.requires_grad_(True)
    data = DataConfig(vocab_size=st.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED + 90)
    batch = {k: v[:TRAIN_MICRO] for k, v in
             batch_for_step(data, st, 0, dev).items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (loss, grads), above = _peak_above(
            lambda: _micro_grads(params, batch, st))
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    if not math.isfinite(float(loss)):
        raise RuntimeError(f"the micro-batch's loss is {float(loss)}")
    rec["train_micro"] = _hold_dry(
        f"{TRAIN_ARCH} micro-batch {TRAIN_MICRO} x {TRAIN_SEQ} (forward + "
        f"backward)", dry["train_micro"], above, busy_ms)
    del params, batch, loss, grads, prof
    torch.cuda.empty_cache()

    rec["pair_step"] = _hold_dry(
        f"2c's sharded pair step ({pair['batch']} pairs)", dry["pair_step"],
        pair["peak_above_bytes"], pair["device_busy_ms"])

    # the multi-rank cells, from their own process
    out, _ = cells.communicate(timeout=DRYRUN_BUDGET_S)
    (out_dir / "dryrun_cells.log").write_text(out)
    if cells.returncode != 0:
        raise RuntimeError(f"the dry run's cells exited {cells.returncode}:"
                           f"\n{out[-3000:]}")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    rec["cells"] = {}
    for c in DRYRUN_CELLS:
        arch, shape, mesh = c.split(":")
        art = json.loads((cells_dir / f"{arch}__{shape}__mesh_{mesh}.json")
                         .read_text())
        peak = art["memory"]["total_nonalias_bytes"]
        rl = art["roofline"]
        rec["cells"][c] = {"per_rank_peak_bytes": peak,
                           "argument_bytes": art["memory"]["argument_bytes"],
                           "fits": peak <= card_bytes, "roofline": rl}
        print(f"[2n] {arch} {shape} on a ({mesh.replace('x', ', ')}) mesh: "
              f"a rank peaks at {peak / 2**30:.2f} GiB against the card's "
              f"{card_bytes / 2**30:.2f} ("
              f"{'fits' if peak <= card_bytes else 'does not fit'}); "
              f"roofline {rl['bottleneck']}, compute {rl['compute_s']:.4g} "
              f"s, memory {rl['memory_s']:.4g} s, collective "
              f"{rl['collective_s']:.4g} s (counts from shapes)")
    rec["launch_host_us"] = _launch_host_us(dev)
    rec["seconds"] = time.time() - t0
    print(f"[2n] {rec['seconds']:.1f} s (budget {DRYRUN_BUDGET_S})")
    return rec


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.distributed import make_sharded_locs
    from repro_torch.core.encoding import pack_2bit, revcomp
    from repro_torch.core.light_align import cigar_ops
    from repro_torch.core.long_read import (
        _anchor_windows, candidate_diagonals, segment_views)
    from repro_torch.core.pipeline import (
        M_LIGHT, PipelineConfig, residual_buffer)
    from repro_torch.core.seeding import (
        SEED_WORDS, extract_seeds, seed_offsets_tuple)
    from repro_torch.core.seedmap import (
        INVALID_LOC, SeedMap, SeedMapConfig, build_seedmap)
    from repro_torch.core.simulate import (
        ReadSimConfig, random_reference, simulate_long_reads, simulate_pairs)
    from repro_torch.engine import ExecutionConfig, Mapper
    from repro_torch.kernels import _cuda
    from repro_torch.kernels._util import kernel_reference, lane_slots
    from repro_torch.kernels.banded_sw.ops import banded_sw, banded_sw_cost
    from repro_torch.kernels.candidate_align.ops import (
        candidate_align_cost, candidate_pair_align)
    from repro_torch.kernels.candidate_align.ref import gather_windows
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_cost)
    from repro_torch.kernels.light_align.ops import (
        light_align, light_align_cost)
    from repro_torch.kernels.location_vote.ops import (
        location_vote, location_vote_cost)
    from repro_torch.kernels.pair_frontend.ops import (
        frontend_from_buckets, frontend_merge_filter, merge_filter_cost,
        pair_frontend_cost, seed_buckets, seed_buckets_cost,
        segment_pair_frontend)
    from repro_torch.kernels.pair_frontend.ref import (
        frontend_from_buckets_ref, merge_filter_ref, seed_buckets_ref)
    from repro_torch.kernels.residual_dp.ops import (
        residual_dp_cost, residual_pair_dp)
    from repro_torch.kernels.seed_gather.ops import (
        seed_gather, seed_gather_cost)
    from repro_torch.kernels.xxhash.ops import xxhash32, xxhash32_cost
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import (
        decode_step, make_smoke_batch, model_init_params, prefill_step)
    from repro_torch.models.transformer import _logits, forward

    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    record = {}

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    print(f"[1] card: {card}; {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _cuda.library()
    record["build_s"] = time.time() - t0
    (out_dir / "build.log").write_text(_cuda.build_log())
    print(f"[1] kernels built in {record['build_s']:.1f} s "
          f"(nvcc output: chiprun_out/build.log)")

    # ---- 2. main path at chromosome scale ---------------------------------
    pipe = PipelineConfig(packed_ref=True)
    sm_cfg = SeedMapConfig(table_bits=TABLE_BITS)
    rng = np.random.default_rng(SEED)
    ref = random_reference(REF_LEN, rng)
    noisy = simulate_pairs(ref, BATCH, ReadSimConfig(sub_rate=0.01),
                           seed=SEED + 1)

    # simulated up front, so the stream's clock covers mapping only
    stream_batches = []
    for k in range(STREAM_BATCHES):
        n = RAGGED_TAIL if k == STREAM_BATCHES - 1 else BATCH
        s = simulate_pairs(ref, n, ReadSimConfig(), seed=SEED + 2 + k)
        stream_batches.append((s.reads1, s.reads2, s.true_start1))

    def count_correct(state, res, true1):
        hit = (res.pos1 != INVALID_LOC) & res.n_valid \
            & ((res.pos1.long() - true1.long()).abs() <= 5)
        return state + hit.sum()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    # the CSR map is kept: phase 2g's baseline queries it
    csr = build_seedmap(torch.as_tensor(ref, device=dev), sm_cfg)
    mapper = Mapper.from_index(csr, ref, pipe, ExecutionConfig(device="cuda"))
    torch.cuda.synchronize()
    record["index_build_s"] = time.time() - t0
    print(f"[2] index: {REF_LEN} bases, {sm_cfg.table_size} buckets, "
          f"{mapper.pipe_cfg.max_locs_per_seed}-wide rows, built on the card in "
          f"{record['index_build_s']:.1f} s")

    _cuda.reset_launches()
    t0 = time.time()
    res = mapper.map(noisy.reads1, noisy.reads2)
    torch.cuda.synchronize()
    record["map_s"] = time.time() - t0
    sr = mapper.map_stream(stream_batches, reduce_fn=count_correct,
                           reduce_init=torch.zeros((), dtype=torch.int64,
                                                   device=dev))
    launches = _cuda.launch_counts()
    record["launches"] = launches
    print(f"[2] launches on the pair lane: {launches}")
    if not all(launches[k] > 0 for k in PAIR_KERNELS):
        raise RuntimeError(f"a kernel never launched on the pair lane: "
                           f"{launches}")

    pos1 = res.pos1.cpu().numpy()
    mapped = pos1 != INVALID_LOC
    within = mapped & (np.abs(pos1.astype(np.int64) - noisy.true_start1) <= 5)
    methods = np.bincount(res.method.cpu().numpy(), minlength=5).tolist()
    record["map"] = {"pairs": BATCH, "sub_rate": 0.01,
                     "mapped": float(mapped.mean()),
                     "within_5": float(within.mean()),
                     "methods_0to4": methods}
    stream_within = int(sr.reduced) / sr.n_pairs
    record["stream"] = {"pairs": sr.n_pairs, "batches": sr.n_batches,
                        "seconds": sr.seconds,
                        "pairs_per_s": sr.pairs_per_s,
                        "totals": sr.totals, "within_5": stream_within}
    record["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[2] map: {BATCH} pairs in {record['map_s']:.3f} s, methods "
          f"{methods}, mapped {mapped.mean():.4f}, within 5 bp of truth "
          f"{within.mean():.4f}")
    print(f"[2] map_stream: {sr.n_pairs} pairs in {sr.n_batches} batches, "
          f"{sr.seconds:.3f} s ({sr.pairs_per_s:.0f} pairs/s), within 5 bp "
          f"{stream_within:.4f}")
    print(f"[2] stage totals: {sr.totals}")
    print(f"[2] peak device memory: {record['peak_mem_bytes'] / 2**30:.2f} "
          f"GiB")
    if sr.totals["n_pairs"] != (STREAM_BATCHES - 1) * BATCH + RAGGED_TAIL:
        raise RuntimeError("stream totals miss pairs or count padding")
    if within.mean() < 0.7 or stream_within < 0.95:
        raise RuntimeError("mapping accuracy below the expected floor")
    r1_dev = torch.as_tensor(noisy.reads1, device=dev)
    r2_dev = torch.as_tensor(noisy.reads2, device=dev)

    # ---- 2b. long-read lane on the same session ----------------------------
    lr = mapper.lr_cfg
    long_reads, long_true = simulate_long_reads(ref, LONG_BATCH, LONG_LEN,
                                                seed=SEED + 10)
    long_batches = [
        simulate_long_reads(ref, LONG_TAIL if k == STREAM_BATCHES - 1
                            else LONG_BATCH, LONG_LEN, seed=SEED + 20 + k)
        for k in range(STREAM_BATCHES)]

    def count_near(state, res, true):
        hit = res.mapped & res.n_valid & (
            (res.position.long() - true.long()).abs() <= lr.vote_bin)
        return state + hit.sum()

    _cuda.reset_launches()
    t0 = time.time()
    lres = mapper.map_long(long_reads)
    torch.cuda.synchronize()
    record["map_long_s"] = time.time() - t0
    lsr = mapper.map_long_stream(
        long_batches, reduce_fn=count_near,
        reduce_init=torch.zeros((), dtype=torch.int64, device=dev))
    long_launches = _cuda.launch_counts()
    record["long_launches"] = long_launches
    print(f"[2b] launches on the long-read lane: {long_launches}")
    if not all(long_launches[k] > 0 for k in LONG_KERNELS):
        raise RuntimeError(f"a kernel never launched on the long-read lane: "
                           f"{long_launches}")
    if long_launches["candidate_align"] or long_launches["residual_dp"]:
        raise RuntimeError(f"a pair-lane-only kernel launched on the "
                           f"long-read lane: {long_launches}")

    lpos = lres.position.cpu().numpy().astype(np.int64)
    lmapped = lres.mapped.cpu().numpy()
    lnear = lmapped & (np.abs(lpos - long_true) <= lr.vote_bin)
    n_long = (STREAM_BATCHES - 1) * LONG_BATCH + LONG_TAIL
    long_stream_near = int(lsr.reduced) / lsr.n_pairs
    record["map_long"] = {
        "reads": LONG_BATCH, "read_len": LONG_LEN, "sub_rate": 0.01,
        "segments": lr.n_segments(LONG_LEN), "band": lr.band(),
        "mapped": float(lmapped.mean()), "within_vote_bin": float(lnear.mean()),
        "mean_votes": float(lres.votes.float().mean()),
        "mean_candidates": float(lres.n_candidates.float().mean())}
    record["long_stream"] = {
        "reads": lsr.n_pairs, "batches": lsr.n_batches,
        "seconds": lsr.seconds, "reads_per_s": lsr.pairs_per_s,
        "mbp_per_s": lsr.mbp_per_s(LONG_LEN), "totals": lsr.totals,
        "within_vote_bin": long_stream_near}
    print(f"[2b] map_long: {LONG_BATCH} reads of {LONG_LEN} bp "
          f"({lr.n_segments(LONG_LEN)} segments, band {lr.band()}) in "
          f"{record['map_long_s']:.3f} s, mapped {lmapped.mean():.4f}, "
          f"within {lr.vote_bin} bp of truth {lnear.mean():.4f}")
    print(f"[2b] map_long_stream: {lsr.n_pairs} reads in {lsr.n_batches} "
          f"batches, {lsr.seconds:.3f} s ({lsr.pairs_per_s:.0f} reads/s, "
          f"{lsr.mbp_per_s(LONG_LEN):.1f} Mbp/s), within {lr.vote_bin} bp "
          f"{long_stream_near:.4f}")
    print(f"[2b] stage totals: {lsr.totals}")
    if lsr.totals["n_reads"] != n_long or lsr.n_pairs != n_long:
        raise RuntimeError("long-read stream totals miss reads or count "
                           "padding")
    if lnear.mean() < 0.99 or long_stream_near < 0.99:
        raise RuntimeError("long-read accuracy below 0.99 within vote_bin")
    lr_dev = torch.as_tensor(long_reads, device=dev)
    profile_step(lambda: mapper.map_long(lr_dev), LONG_BATCH, "reads",
                 "long_step", "[2b]", record, out_dir)
    long_step_ms = record["long_step"]["step_ms"]
    record["long_step"]["mbp_per_s"] = LONG_BATCH * LONG_LEN / long_step_ms \
        / 1e3
    print(f"[2b] steady map_long: {record['long_step']['mbp_per_s']:.1f} "
          f"Mbp/s")

    # ---- 2c. the mesh plans on one card ------------------------------------
    store = (out_dir / "nccl_store").resolve()
    store.unlink(missing_ok=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host, one rank
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timedelta(seconds=300))
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    print(f"[2c] mesh: {mesh}")

    def same_result(got, name):
        for f in got._fields:
            if not torch.equal(getattr(got, f), getattr(res, f)):
                raise RuntimeError(f"the {name} session differs from the "
                                   f"replicated kernel session in {f}")

    t0 = time.time()
    smapper = Mapper.build(ref, sm_cfg, pipe, ExecutionConfig(
        device="cuda", mesh=mesh, shard_index=True))
    torch.cuda.synchronize()
    record["sharded_build_s"] = time.time() - t0
    print(f"[2c] shard_index session: shard {smapper.index.shard_id} of "
          f"{smapper.index.offsets.shape[0] - 1} buckets and "
          f"{smapper.index.locations.shape[0]} locations, built in "
          f"{record['sharded_build_s']:.1f} s")
    mesh_launches = {}
    mesh_records = {}
    dmapper = Mapper.from_index(mapper.index, mapper.ref, pipe,
                                ExecutionConfig(device="cuda", mesh=mesh))
    for plan, m in (("sharded", smapper), ("data_parallel", dmapper)):
        _cuda.reset_launches()
        got = m.map(noisy.reads1, noisy.reads2)
        msr = m.map_stream(stream_batches, reduce_fn=count_correct,
                           reduce_init=torch.zeros((), dtype=torch.int64,
                                                   device=dev))
        mesh_launches[plan] = _cuda.launch_counts()
        torch.cuda.synchronize()
        same_result(got, plan)
        m_within = int(msr.reduced) / msr.n_pairs
        mesh_records[plan] = {"stream_seconds": msr.seconds,
                              "stream_pairs_per_s": msr.pairs_per_s,
                              "within_5": m_within}
        print(f"[2c] {plan}: launches {mesh_launches[plan]}")
        print(f"[2c] {plan}: map equals phase 2 on all {len(got._fields)} "
              f"fields; map_stream {msr.n_pairs} pairs in {msr.seconds:.3f} "
              f"s ({msr.pairs_per_s:.0f} pairs/s), within 5 bp "
              f"{m_within:.4f}")
        if msr.totals != sr.totals:
            raise RuntimeError(f"{plan} stream totals {msr.totals} differ "
                               f"from phase 2's {sr.totals}")
        if m_within < 0.95:
            raise RuntimeError(f"{plan} stream accuracy below 0.95")
    sl, dl = mesh_launches["sharded"], mesh_launches["data_parallel"]
    if not all(sl[k] > 0 for k in SHARDED_KERNELS) or sl["pair_frontend"]:
        raise RuntimeError(f"the sharded plan's launches are off: {sl}")
    if not all(dl[k] > 0 for k in PAIR_KERNELS) or dl["merge_filter"]:
        raise RuntimeError(f"the data-parallel plan's launches are off: {dl}")
    if any(c[k] for c in (launches, long_launches, sl, dl)
           for k in BLOCK_KERNELS + LM_KERNELS):
        raise RuntimeError("a building block or the LM kernel launched on a "
                           "mapping path")
    record["mesh"] = {"launches": mesh_launches, **mesh_records}
    profile_step(lambda: smapper.map(r1_dev, r2_dev), BATCH, "pairs",
                 "sharded_step", "[2c]", record, out_dir)
    # the step's peak above what it is handed, and the shapes phase 2n's
    # dry run of the same step takes
    _, pair_above = _peak_above(lambda: smapper.map(r1_dev, r2_dev))
    record["sharded_step"]["peak_above_bytes"] = pair_above
    pair_dry = {"genome_len": REF_LEN, "table_bits": TABLE_BITS,
                "n_locations": smapper.index.locations.shape[0],
                "batch": BATCH, "read_len": pipe.read_len,
                "pipe": smapper.pipe_cfg, "sm_cfg": smapper.index.config,
                "peak_above_bytes": pair_above,
                "device_busy_ms": record["sharded_step"]["device_busy_ms"]}
    print(f"[2c] sharded step's peak above its inputs: "
          f"{pair_above / 2**30:.3f} GiB")
    # the merge_filter inputs of that step (phase 3), through the real
    # lookup and all_reduce; and the all_reduce alone, timed
    r2_fwd_dev = revcomp(r2_dev).contiguous()
    mf_buckets = seed_buckets(r1_dev, r2_fwd_dev, pipe.seed_len,
                              pipe.seeds_per_read, sm_cfg.hash_seed,
                              sm_cfg.table_size)
    locs_fn = make_sharded_locs(mesh)
    mf_locs = locs_fn(smapper.index, mf_buckets, pipe.max_locs_per_seed)
    model_group = mesh.get_group("model")
    red = mf_locs.clone()
    allreduce_ms = time_ms(lambda: dist.all_reduce(
        red, op=dist.ReduceOp.MIN, group=model_group), 20)
    record["sharded_step"]["all_reduce_ms"] = allreduce_ms
    record["sharded_step"]["all_reduce_bytes"] = red.numel() * 4
    print(f"[2c] all_reduce(MIN) of the step's {tuple(red.shape)} int32 "
          f"locations: {allreduce_ms:.4f} ms by CUDA events, "
          f"{record['sharded_step']['nccl_device_ms']:.4f} ms of NCCL "
          f"kernels in the profiled step")
    del red, dmapper
    dist.destroy_process_group()
    store.unlink(missing_ok=True)

    # ---- 2d. the building blocks at the pair lane's shapes -----------------
    # Phase 2's batch, and the main-path kernels' results on it that each
    # building block is checked against.
    B, C, E, R = BATCH, pipe.max_candidates, pipe.max_gap, pipe.read_len
    S, K = pipe.seeds_per_read, mapper.pipe_cfg.max_locs_per_seed
    M = S * K
    T = sm_cfg.table_size
    hs = sm_cfg.hash_seed
    words, kref = mapper.ref, mapper.kref
    r1 = torch.as_tensor(noisy.reads1, device=dev)
    r2 = revcomp(torch.as_tensor(noisy.reads2, device=dev)).contiguous()
    rows = mapper.index.rows
    offs = seed_offsets_tuple(R, pipe.seed_len, S)
    offs_t = torch.tensor(offs, device=dev)
    light = dict(scoring=pipe.scoring, threshold=pipe.threshold(),
                 mode=pipe.light_mode)
    buckets = seed_buckets(r1, r2, pipe.seed_len, S, hs, T)
    fe = frontend_from_buckets(rows, buckets, offs, pipe.delta, C)
    pair = candidate_pair_align(words, r1, r2, fe.pos1, fe.pos2, E,
                                packed_ref=True, backend="cuda", kref=kref,
                                **light)
    # the seeds of both mates packed as core/seeding.py packs them
    seed_words = pack_2bit(extract_seeds(torch.cat([r1, r2]), pipe.seed_len,
                                         S), n_words=SEED_WORDS
                           ).reshape(-1, 4).contiguous()
    ids = buckets.reshape(-1)
    # both mates of every pair with a candidate, against the packed window
    # candidate_align aligned at the slot it picked (mate 2 in reference
    # orientation)
    has = fe.n > 0
    la_reads = torch.cat([r1[has], r2[has]])
    la_wins = torch.cat([gather_windows(words, p[has], has[has], R, E, True)
                         for p in (pair.pos1, pair.pos2)])
    torch.cuda.synchronize()

    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hashes = xxhash32(seed_words, hs)
        gathered = seed_gather(rows, ids)
        la = light_align(la_reads, la_wins, E, **light)
        torch.cuda.synchronize()
    bl = _cuda.launch_counts()
    record["block_launches"] = bl
    print(f"[2d] launches of the building blocks: {bl}")
    (out_dir / "profile_blocks.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=20))
    block_device_ms = {}
    for name in BLOCK_KERNELS:
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and any(sym in e.key for sym in SYMBOLS[name])]
        # None where the trace dropped the launch (see device_ms)
        block_device_ms[name] = (
            sum(e.self_device_time_total for e in events) / 1e3
            if events else None)
    print(f"[2d] device time of each kernel's one launch (torch.profiler), "
          f"ms: {block_device_ms}")
    if not all(bl[k] > 0 for k in BLOCK_KERNELS) or any(
            v for k, v in bl.items() if k not in BLOCK_KERNELS):
        raise RuntimeError(f"the building blocks' launches are off: {bl}")
    if not torch.equal((hashes & (T - 1)).to(torch.int32),
                       buckets.reshape(-1)):
        raise RuntimeError("xxhash32 & (T-1) differs from seed_buckets' ids")
    locs = gathered.reshape(2 * B, S, K)
    mf = frontend_merge_filter(locs[:B], locs[B:], offs, pipe.delta, C)
    for f in fe._fields:
        if not torch.equal(getattr(mf, f), getattr(fe, f)):
            raise RuntimeError(f"the rows seed_gather gathered, merged, "
                               f"differ from pair_frontend's in {f}")
    n_has = int(has.sum())
    want_score = torch.cat([pair.score1[has], pair.score2[has]])
    want_ok = torch.cat([pair.ok1[has], pair.ok2[has]])
    want_cigar = torch.cat([pair.cigar1[has], pair.cigar2[has]])
    if not (torch.equal(la.score, want_score) and torch.equal(la.ok, want_ok)
            and torch.equal(cigar_ops(la.edit_type, la.edit_len,
                                      la.edit_pos, R), want_cigar)):
        raise RuntimeError("light_align differs from candidate_align's "
                           "per-mate score, ok flag or CIGAR")
    record["blocks"] = {"hashes": ids.numel(), "gathered_rows": ids.numel(),
                        "aligned_mates": 2 * n_has,
                        "device_ms": block_device_ms}
    print(f"[2d] xxhash32 of {ids.numel()} seeds & (T-1) equals seed_buckets;"
          f" seed_gather of {ids.numel()} {K}-wide rows, merged, equals "
          f"pair_frontend; light_align of {2 * n_has} mates ({n_has} pairs "
          f"with a candidate) equals candidate_align's scores, ok flags and "
          f"CIGARs")

    # ---- 2e. LM serving: yi-6b at full width and depth ---------------------
    lm_cfg = dataclasses.replace(get_config("yi-6b"), use_flash_kernel=True)
    B_lm, S_lm = LM_BATCH, LM_PROMPT
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = model_init_params(
        lm_cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    lm = {"init_s": time.time() - t0,
          "params": sum(t.numel() for t in _tensors(params)),
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in _tensors(params))}
    tokens = make_smoke_batch(lm_cfg, B_lm, S_lm, seed=SEED + 30,
                              device=dev)["tokens"]
    print(f"[2e] {lm_cfg.name}: {lm['params']} float32 parameters "
          f"({lm['param_bytes'] / 1e9:.2f} GB) drawn on the card in "
          f"{lm['init_s']:.1f} s; {B_lm} prompts of {S_lm} tokens, "
          f"max_len {LM_MAX_LEN}")

    _cuda.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": tokens}, lm_cfg,
                                 LM_MAX_LEN)
    torch.cuda.synchronize()
    lm["first_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(-1)[:, None]
    fed, dec_logits = [], []
    step_ms = []
    for _ in range(LM_DECODE):
        t0 = time.perf_counter()
        lg, cache = decode_step(params, cache, tok, lm_cfg)
        fed.append(tok)
        tok = lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        dec_logits.append(lg)
    lm_launches = _cuda.launch_counts()
    record["lm_launches"] = lm_launches
    print(f"[2e] launches over one prefill and {LM_DECODE} decode steps: "
          f"{lm_launches}")
    if lm_launches["flash_attention"] != lm_cfg.n_layers or any(
            v for k, v in lm_launches.items() if k not in LM_KERNELS):
        raise RuntimeError(f"LM serving launches are off (want "
                           f"{lm_cfg.n_layers} flash launches and nothing "
                           f"else): {lm_launches}")
    if cache.length != LM_MAX_LEN:
        raise RuntimeError(f"cache length {cache.length} after decoding")

    # steady rates: two more prefills on the same tokens; the decode steps
    # after the first
    prefill_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        again, spare = prefill_step(params, {"tokens": tokens}, lm_cfg,
                                    LM_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        del spare
    lm["repeat_prefill_max_abs"] = float((again - logits).abs().max())
    lm["prefill_ms"] = min(prefill_ms)
    lm["prefill_tokens_per_s"] = B_lm * S_lm / lm["prefill_ms"] * 1e3
    lm["decode_ms_per_step"] = sum(step_ms[1:]) / (LM_DECODE - 1)
    lm["first_decode_ms"] = step_ms[0]
    lm["decode_tokens_per_s"] = B_lm / lm["decode_ms_per_step"] * 1e3
    lm["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    lm["resident_before_bytes"] = resident
    print(f"[2e] prefill {B_lm} x {S_lm}: {lm['prefill_ms']:.1f} ms "
          f"({lm['prefill_tokens_per_s']:.0f} tokens/s; first call "
          f"{lm['first_prefill_ms']:.1f} ms); decode "
          f"{lm['decode_ms_per_step']:.2f} ms per step "
          f"({lm['decode_tokens_per_s']:.0f} tokens/s; first step "
          f"{lm['first_decode_ms']:.1f} ms)")
    print(f"[2e] peak device memory {lm['peak_mem_bytes'] / 2**30:.2f} GiB "
          f"({resident / 2**30:.2f} GiB held by the mapping phases)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, spare = prefill_step(params, {"tokens": tokens}, lm_cfg,
                                LM_MAX_LEN)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del spare
    (out_dir / "profile_lm_prefill.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=40))
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    flash_ms = sum(e.self_device_time_total for e in events
                   if "flash_" in e.key) / 1e3
    lm["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": 1 - busy_ms / wall_ms,
                     "flash_device_ms": flash_ms,
                     "top": [{"name": e.key[:80], "calls": e.count,
                              "device_ms": e.self_device_time_total / 1e3}
                             for e in events[:12]]}
    print(f"[2e] profiled prefill: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms "
          f"device-busy, {flash_ms:.2f} ms in the flash kernel")
    for t in lm["profile"]["top"]:
        print(f"[2e]   {t['device_ms']:9.3f} ms  x{t['calls']:<4d} "
              f"{t['name']}")

    # kernel against plain version: the same weights and tokens
    plain_logits, spare = prefill_step(params, {"tokens": tokens}, lm_cfg,
                                       LM_MAX_LEN, backend="torch")
    del spare
    blockwise_logits, spare = prefill_step(
        params, {"tokens": tokens},
        dataclasses.replace(lm_cfg, use_flash_kernel=False), LM_MAX_LEN)
    del spare
    rel = float((logits - plain_logits).norm() / plain_logits.norm())
    floor = float((blockwise_logits - plain_logits).norm()
                  / plain_logits.norm())
    plain_tol = max(LM_PLAIN_TOL, LM_FLOOR_MARGIN * floor)
    agree = int((logits.argmax(-1) == plain_logits.argmax(-1)).sum())
    lm.update(kernel_vs_plain_rel_l2=rel, blockwise_vs_plain_rel_l2=floor,
              kernel_vs_plain_limit=plain_tol,
              kernel_vs_plain_greedy_agree=agree)
    print(f"[2e] last-position logits, kernel vs plain prefill: relative L2 "
          f"{rel:.3e}; two plain prefills (blockwise vs dense attention) "
          f"{floor:.3e}; limit {plain_tol:.3e}; greedy tokens agree on "
          f"{agree} of {B_lm}")
    # decode against teacher forcing over the same 2,080 tokens
    seq = torch.cat([tokens] + fed, dim=1)
    hidden, _ = forward(params, lm_cfg, {"tokens": seq}, return_hidden=True)
    forced = _logits(params, lm_cfg, hidden[:, S_lm:])
    decoded = torch.stack(dec_logits, dim=1)
    drel = float((decoded - forced).norm() / forced.norm())
    step_rel = ((decoded - forced).norm(dim=(0, 2))
                / forced.norm(dim=(0, 2))).tolist()
    lm["decode_vs_forced_rel_l2"] = drel
    lm["decode_vs_forced_max_abs"] = float((decoded - forced).abs().max())
    lm["decode_vs_forced_worst_step_rel_l2"] = max(step_rel)
    lm["decode_greedy_agree"] = int((decoded.argmax(-1)
                                     == forced.argmax(-1)).sum())
    print(f"[2e] {LM_DECODE} decode steps vs a teacher-forced forward: "
          f"relative L2 {drel:.3e} (limit {LM_DECODE_TOL}), worst step "
          f"{max(step_rel):.3e}, max |diff| "
          f"{lm['decode_vs_forced_max_abs']:.3e}, argmax agrees on "
          f"{lm['decode_greedy_agree']} of {B_lm * LM_DECODE}")
    # where a decode step's time goes (one step at the end of the cache)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_step(params, cache._replace(length=LM_MAX_LEN - 1), tok,
                    lm_cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    (out_dir / "profile_lm_decode.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=30))
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    launches_per_step = sum(e.count for e in prof.key_averages()
                            if e.key in ("cudaLaunchKernel",
                                         "cuLaunchKernelEx"))
    lm["decode_profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                            "device_idle_share": 1 - busy_ms / wall_ms,
                            "kernel_launches": launches_per_step}
    print(f"[2e] profiled decode step: {wall_ms:.1f} ms wall, "
          f"{busy_ms:.1f} ms device-busy, {launches_per_step} kernel "
          f"launches from the host")
    finite = bool(logits.isfinite().all() and decoded.isfinite().all())
    record["lm"] = lm
    if not finite or logits.shape != (B_lm, lm_cfg.vocab_size):
        raise RuntimeError("LM logits are not finite or of the wrong shape")
    if rel > plain_tol:
        raise RuntimeError(f"kernel prefill differs from the plain one: "
                           f"relative L2 {rel}")
    if drel > LM_DECODE_TOL:
        raise RuntimeError(f"decode differs from teacher forcing: relative "
                           f"L2 {drel}")
    # what phase 2l's mesh path must reproduce bit for bit
    serve_ref = {"tokens": tokens.cpu(), "fed": torch.cat(fed, 1).cpu(),
                 "logits": logits.cpu(), "decoded": decoded.cpu(),
                 "prefill_ms": lm["prefill_ms"],
                 "decode_ms_per_step": lm["decode_ms_per_step"]}
    del params, cache, logits, plain_logits, blockwise_logits, again
    del hidden, forced, decoded
    del dec_logits, lg
    torch.cuda.empty_cache()

    # ---- 3. each kernel against its plain version --------------------------
    # The main path's shapes: the batch `map` got above, and the residual
    # buffer its step 5 builds.
    bases = torch.as_tensor(ref, device=dev)
    bases_kref = kernel_reference(bases, kref.pad, False)
    kernels = {}
    timed_runs = {}     # each kernel's timed case, read again after 2g

    def compare(name, run_kernel, run_plain, work=None, timed=True,
                iters=20, library=None, tol=0, case=None):
        """``work``: the timed case's `Work` (its kernel's cost function
        on this launch's shapes and data) for the bound."""
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        del got, want
        entry = kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name] + long_launches[name]
            + sl[name] + dl[name] + bl[name] + lm_launches[name],
            "launches_pairs": launches[name],
            "launches_long": long_launches[name],
            "launches_sharded": sl[name],
            "launches_data_parallel": dl[name],
            "launches_blocks": bl[name],
            "launches_lm": lm_launches[name],
            "max_abs_err": 0, "tolerance": tol, "match": True,
            "library_ms": None, "checks": 0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["match"] = entry["match"] and err <= tol
        entry["checks"] += 1
        if case is not None:
            entry.setdefault("cases", []).append(
                {"case": case, "max_abs_err": err, "tolerance": tol})
        if timed:
            entry["ms"] = time_ms(run_kernel, iters)
            entry["device_ms"] = device_ms(run_kernel, name)
            timed_runs[name] = run_kernel
            entry["plain_ms"] = time_ms(run_plain, 3, warmup=1)
            entry["bound_ms"], entry["bound_by"] = bound(work)
            entry["bound_bytes"], entry["bound_ops"] = work.bytes, work.ops
            if library is not None:
                entry["library_ms"] = time_ms(library, iters)
        print(f"[3] {name}{f' ({case})' if case else ''}: max |kernel - "
              f"plain| = {err:g} (tolerance {tol:g})")

    # kernel 1: seed_buckets over both mates
    compare("seed_buckets",
            lambda: (seed_buckets(r1, r2, pipe.seed_len, S, hs, T),),
            lambda: (seed_buckets_ref(torch.cat([r1, r2]), pipe.seed_len, S,
                                      hs, T),),
            work=seed_buckets_cost(B, R, S, pipe.seed_len))
    # odd R (tiles start off a word), codes 0-255 (a code > 3 carries into
    # the next base), 1,000 rows (not a multiple of the 64-row tile),
    # mate 1 starting 5 bytes past an aligned address
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    odd = torch.randint(0, 256, (2, 1000 * 151 + 16), generator=g,
                        device=dev, dtype=torch.uint8)
    o1, o2 = odd[0, 5:5 + 1000 * 151].view(1000, 151), \
        odd[1, :1000 * 151].view(1000, 151)
    compare("seed_buckets",
            lambda: (seed_buckets(o1, o2, pipe.seed_len, S, hs, T),),
            lambda: (seed_buckets_ref(torch.cat([o1, o2]), pipe.seed_len, S,
                                      hs, T),),
            timed=False, case="R 151, codes 0-255, B 1,000")
    del odd, o1, o2
    # the wrapper's device time with the reads cold: the calls rotate over
    # 4 copies of the batch (79 MB, past the 50 MB L2)
    copies = [(r1.clone(), r2.clone()) for _ in range(4)]
    turn = itertools.cycle(copies)
    kernels["seed_buckets"]["cold_device_ms"] = device_ms(
        lambda: seed_buckets(*next(turn), pipe.seed_len, S, hs, T),
        "seed_buckets", iters=12)
    print(f"[3] seed_buckets: "
          f"{fmt_ms(kernels['seed_buckets']['cold_device_ms'])} of device "
          f"time (reads cold)")
    del copies, turn

    # kernel 2: row gather + stable sort + Δ filter + compaction, its work
    # counted over each pair's valid hits (pair_frontend_cost)
    compare("pair_frontend",
            lambda: frontend_from_buckets(rows, buckets, offs, pipe.delta, C),
            lambda: frontend_from_buckets_ref(rows, buckets[:B], buckets[B:],
                                              offs_t, pipe.delta, C),
            work=pair_frontend_cost(B, S, K, C, fe.n_hits1, fe.n_hits2))
    record["frontend_hits_per_mate"] = float(
        (fe.n_hits1 + fe.n_hits2).double().mean() / 2)
    # every row slot valid (h = M: the sort and the probe at their
    # largest), from a 2^24-row table of locations in [0, 2^16), so many
    # starts lie within Δ of a partner; checked, and timed apart
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    dense_rows = torch.randint(0, 1 << 16, (1 << 24, K), generator=g,
                               device=dev, dtype=torch.int32)
    dense_ids = buckets & ((1 << 24) - 1)
    compare("pair_frontend",
            lambda: frontend_from_buckets(dense_rows, dense_ids, offs,
                                          pipe.delta, C),
            lambda: frontend_from_buckets_ref(dense_rows, dense_ids[:B],
                                              dense_ids[B:], offs_t,
                                              pipe.delta, C),
            timed=False, case="every slot valid")
    kernels["pair_frontend"]["dense_ms"] = time_ms(
        lambda: frontend_from_buckets(dense_rows, dense_ids, offs,
                                      pipe.delta, C), 20)
    print(f"[3] pair_frontend, every slot valid (h = {M} per mate): "
          f"{kernels['pair_frontend']['dense_ms']:.4f} ms")

    # kernel 3: candidate alignment, both flavors, prescreen 0 and 4.  The
    # function aligns each valid candidate of both mates (one window at 0
    # for a pair without any) and, with a prescreen, takes the zero-shift
    # Hamming distance of every valid candidate first
    # (candidate_align_cost).
    n_cand = fe.n.long()
    for packed in (True, False):
        for prescreen in (0, 4):
            aligned = n_cand.clamp(min=1)
            if prescreen:
                aligned = aligned.clamp(max=prescreen)
            n_align = 2 * int(aligned.sum())
            ref_in, kref_in = (words, kref) if packed else (bases, bases_kref)
            compare(
                "candidate_align",
                lambda p=packed, q=prescreen, x=ref_in, k=kref_in:
                candidate_pair_align(
                    x, r1, r2, fe.pos1, fe.pos2, E, prescreen_top=q,
                    packed_ref=p, backend="cuda", kref=k, **light),
                lambda p=packed, q=prescreen, x=ref_in: candidate_pair_align(
                    x, r1, r2, fe.pos1, fe.pos2, E, prescreen_top=q,
                    packed_ref=p, backend="torch", **light),
                work=candidate_align_cost(B, R, C, E, packed, prescreen,
                                          n_cand),
                timed=packed and prescreen == 0)
            ran = torch.zeros(1, dtype=torch.int32, device=dev)
            candidate_pair_align(ref_in, r1, r2, fe.pos1, fe.pos2, E,
                                 prescreen_top=prescreen, packed_ref=packed,
                                 backend="cuda", kref=kref_in, count=ran,
                                 **light)
            record.setdefault("candidate_align_alignments", []).append(
                {"packed": packed, "prescreen": prescreen,
                 "kernel": int(ran), "bound": n_align,
                 "valid": int(n_cand.sum())})
            print(f"[3] candidate_align (packed {packed}, prescreen "
                  f"{prescreen}): the kernel ran {int(ran)} alignments; the "
                  f"bound counts {n_align} ({int(n_cand.sum())} valid "
                  f"candidates over {B} pairs)")
    # every slot of every pair valid (the invalid ones of the batch moved
    # to random starts): nothing to compact, the staging alone; checked,
    # and timed apart from the main path's case
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    dense1, dense2 = (torch.where(
        p == INVALID_LOC, torch.randint(0, REF_LEN, p.shape, generator=g,
                                        device=dev, dtype=torch.int32), p)
        for p in (fe.pos1, fe.pos2))
    dense_args = (words, r1, r2, dense1, dense2, E)
    compare("candidate_align",
            lambda: candidate_pair_align(*dense_args, packed_ref=True,
                                         backend="cuda", kref=kref, **light),
            lambda: candidate_pair_align(*dense_args, packed_ref=True,
                                         backend="torch", **light),
            timed=False, case="every slot valid")
    kernels["candidate_align"]["dense_ms"] = time_ms(
        lambda: candidate_pair_align(*dense_args, packed_ref=True,
                                     backend="cuda", kref=kref, **light), 10)
    print(f"[3] candidate_align, every slot valid ({2 * B * C} alignments): "
          f"{kernels['candidate_align']['dense_ms']:.4f} ms")
    del dense1, dense2, dense_args

    # kernel 4: residual DP of the failed mates in step 5's buffer (the
    # main path's band, and the full DP)
    passed = fe.n > 0
    light_ok = passed & pair.ok1 & pair.ok2
    cap = pipe.residual_cap(B)
    buf = residual_buffer(pair, passed & ~light_ok, cap)
    idx = buf.idx
    dp_in = (r1[idx], r2[idx], pair.pos1[idx], pair.pos2[idx], buf.need1,
             buf.need2, pipe.dp_pad)
    n_items = int(buf.need1.sum() + buf.need2.sum())
    Wd = R + 2 * pipe.dp_pad
    for packed, band in ((True, pipe.band()), (False, pipe.band()),
                         (True, Wd)):
        ref_in, kref_in = (words, kref) if packed else (bases, bases_kref)
        compare(
            "residual_dp",
            lambda p=packed, bd=band, x=ref_in, k=kref_in: residual_pair_dp(
                x, *dp_in, band=bd, scoring=pipe.scoring, packed_ref=p,
                backend="cuda", kref=k),
            lambda p=packed, bd=band, x=ref_in: residual_pair_dp(
                x, *dp_in, band=bd, scoring=pipe.scoring, packed_ref=p,
                backend="torch"),
            work=residual_dp_cost(cap, R, Wd, band, packed, n_items),
            timed=packed and band == pipe.band(), iters=10)
    record["residual_buffer"] = {"rows": cap, "items": n_items}
    print(f"[3] residual buffer: {cap} rows, {n_items} live items")
    # every slot of the buffer needs DP (2 cap items, nothing to skip):
    # checked, and timed apart from the main path's case
    all_need = torch.ones_like(buf.need1)
    dense_dp = dp_in[:4] + (all_need, all_need, pipe.dp_pad)
    compare("residual_dp",
            lambda: residual_pair_dp(words, *dense_dp, band=pipe.band(),
                                     scoring=pipe.scoring, packed_ref=True,
                                     backend="cuda", kref=kref),
            lambda: residual_pair_dp(words, *dense_dp, band=pipe.band(),
                                     scoring=pipe.scoring, packed_ref=True,
                                     backend="torch"),
            timed=False, case="every slot needed")
    kernels["residual_dp"]["dense_ms"] = time_ms(
        lambda: residual_pair_dp(words, *dense_dp, band=pipe.band(),
                                 scoring=pipe.scoring, packed_ref=True,
                                 backend="cuda", kref=kref), 10)
    print(f"[3] residual_dp, every slot needed ({2 * cap} items): "
          f"{kernels['residual_dp']['dense_ms']:.4f} ms")
    del dense_dp, all_need

    # kernel 5: location vote over the long-read batch's diagonal rows (the
    # function's own work: a sort of each row, ~2 M log2 M), then
    # synthetic rows: negative and far-negative diagonals, ties, all
    # invalid
    lp = lr.pipe
    n_pp = lr.n_segments(LONG_LEN) - 1
    fe_l = segment_pair_frontend(
        rows, lr_dev, lr.segment_len, lr.segment_stride, lp.seed_len,
        lp.seeds_per_read, sm_cfg.hash_seed, lr.pair_delta(),
        lp.max_candidates)
    diag = candidate_diagonals(fe_l.pos1, n_pp, lr.segment_stride)
    Bl, Ml = diag.shape
    compare("location_vote",
            lambda: location_vote(diag, lr.vote_bin, backend="cuda"),
            lambda: location_vote(diag, lr.vote_bin, backend="torch"),
            work=location_vote_cost(Bl, Ml))
    g = torch.Generator(device=dev).manual_seed(SEED)
    synth = torch.randint(-400, 4000, (4096, Ml), generator=g, device=dev,
                          dtype=torch.int32)
    synth[torch.rand(synth.shape, generator=g, device=dev) < 0.4] = \
        INVALID_LOC
    synth[0] = INVALID_LOC
    synth[1, 4:] = INVALID_LOC
    synth[1, :4] = torch.tensor([300, 300, 100, 100], device=dev)
    synth[2, 4:] = INVALID_LOC
    synth[2, :4] = torch.tensor([-1, -1, -1, 50], device=dev)
    synth[3] = torch.randint(-(2**31), -(2**31) + 4096, (Ml,), generator=g,
                             device=dev, dtype=torch.int32)
    compare("location_vote",
            lambda: location_vote(synth, lr.vote_bin, backend="cuda"),
            lambda: location_vote(synth, lr.vote_bin, backend="torch"),
            timed=False, case="4,096 synthetic rows, 60 % valid")
    kernels["location_vote"]["dense_ms"] = time_ms(
        lambda: location_vote(synth, lr.vote_bin, backend="cuda"), 20)
    kernels["location_vote"]["dense_device_ms"] = device_ms(
        lambda: location_vote(synth, lr.vote_bin, backend="cuda"),
        "location_vote")
    h_lane = (diag != INVALID_LOC).sum(1).float()
    record["location_vote_h"] = {"mean": float(h_lane.mean()),
                                 "max": int(h_lane.max())}
    print(f"[3] location_vote: the lane's {Bl} rows of {Ml} slots hold "
          f"h = {float(h_lane.mean()):.2f} valid slots on average, "
          f"{int(h_lane.max())} at most; {synth.shape[0]} synthetic rows "
          f"60 % valid: {kernels['location_vote']['dense_ms']:.4f} ms, "
          f"{fmt_ms(kernels['location_vote']['dense_device_ms'])} of device "
          f"time")
    # the lane's rows 4 bytes off a 16-byte boundary
    off = torch.empty(Bl * Ml + 1, dtype=torch.int32, device=dev)[1:]
    off = off.view(Bl, Ml)
    off.copy_(diag)
    compare("location_vote",
            lambda: location_vote(off, lr.vote_bin, backend="cuda"),
            lambda: location_vote(off, lr.vote_bin, backend="torch"),
            timed=False, case="lane rows 4 bytes off")
    kernels["location_vote"]["unaligned_device_ms"] = device_ms(
        lambda: location_vote(off, lr.vote_bin, backend="cuda"),
        "location_vote")
    print(f"[3] location_vote: the lane's rows 4 bytes off: "
          f"{fmt_ms(kernels['location_vote']['unaligned_device_ms'])} of "
          f"device time")
    del off

    def location_vote_edges():
        # rows not a multiple of 4 slots, and wide rows (a block holds
        # fewer reads: one at 12,288 slots)
        g = torch.Generator(device=dev).manual_seed(SEED + 8)
        for m_s, n_s in ((257, 2048), (33, 2048), (4096, 512),
                         (12_288, 256)):
            rows_s = torch.randint(-400, 4000, (n_s, m_s), generator=g,
                                   device=dev, dtype=torch.int32)
            rows_s[torch.rand(rows_s.shape, generator=g,
                              device=dev) < 0.4] = INVALID_LOC
            compare("location_vote",
                    lambda x=rows_s: location_vote(x, lr.vote_bin,
                                                   backend="cuda"),
                    lambda x=rows_s: location_vote(x, lr.vote_bin,
                                                   backend="torch"),
                    timed=False, case=f"M {m_s}, {n_s} rows, 60 % valid")
    vote = location_vote(diag, lr.vote_bin, backend="cuda")
    syn = location_vote(synth, lr.vote_bin, backend="cuda")
    if syn.win_bin[1:3].tolist() != [1, -1] or int(syn.votes[0]) != 0:
        raise RuntimeError(f"location_vote edge rows: {syn.win_bin[:4]}, "
                           f"{syn.votes[:4]}")

    # kernel 6: banded anchor DP over the same batch's anchor windows, at
    # the lane's band, band 16 and band >= W
    lmapped_t = vote.votes > 0
    win = _anchor_windows(mapper.ref, vote.win_bin * lr.vote_bin, lmapped_t,
                          lr)
    anchor = segment_views(lr_dev, lr.segment_len,
                           lr.segment_stride)[:, 0].contiguous()
    Ra, Wa = anchor.shape[1], win.shape[1]
    for band in (lr.band(), 16, Wa):
        compare(
            "banded_sw",
            lambda bd=band: banded_sw(anchor, win, lp.scoring, bd,
                                      backend="cuda"),
            lambda bd=band: banded_sw(anchor, win, lp.scoring, bd,
                                      backend="torch"),
            work=banded_sw_cost(Bl, Ra, Wa, band),
            timed=band == lr.band(), iters=10)
    # the frame slots per lane the wrapper took for the lane's band
    kernels["banded_sw"]["cpl"] = lane_slots(2 * lr.band() + 1)
    # windows shorter than the read (the band centre at floor((W - R) / 2),
    # the first and last rows' slice start moved as repro moves it), on
    # synthetic reads holding their window on and off the centre; then rows
    # wider than the warp kernel covers (the one-thread kernel)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    for r_s, w_s, band_s in ((150, 149, 16), (150, 147, 8), (40, 35, 10),
                             (150, 1100, None), (150, 1100, 600)):
        n_s = Bl if w_s < r_s else 256
        w_syn = torch.randint(0, 4, (n_s, w_s), generator=g, device=dev,
                              dtype=torch.uint8)
        r_syn = torch.randint(0, 4, (n_s, r_s), generator=g, device=dev,
                              dtype=torch.uint8)
        lo, hi = sorted((r_s, w_s))
        at = torch.randint(0, hi - lo + 1, (n_s,), generator=g, device=dev)
        cols_at = at[:, None] + torch.arange(lo, device=dev)
        if w_s < r_s:        # the window inside the read
            r_syn.scatter_(1, cols_at, w_syn)
        else:                # the read inside the window
            w_syn.scatter_(1, cols_at, r_syn)
        compare("banded_sw",
                lambda a=r_syn, b=w_syn, bd=band_s: banded_sw(
                    a, b, lp.scoring, bd, backend="cuda"),
                lambda a=r_syn, b=w_syn, bd=band_s: banded_sw(
                    a, b, lp.scoring, bd, backend="torch"),
                timed=False,
                case=f"R {r_s}, W {w_s}, band {band_s}, {n_s} reads")
    del w_syn, r_syn, at, cols_at
    record["long_kernel_shapes"] = {"reads": Bl, "diag_slots": Ml,
                                    "anchor_len": Ra, "window": Wa}
    print(f"[3] long-read batch: {Bl} diagonal rows of {Ml} slots, "
          f"{Ra}-base anchors against {Wa}-base windows")

    # kernel 7: merge + Δ filter of the sharded plan's gathered (B, S, K)
    # locations of the same batch, its work counted over each pair's
    # valid hits (merge_filter_cost: the pair front end's without the row
    # scan).  Then 4,096 synthetic rows:
    # all-invalid rows and mates, duplicate-heavy rows, starts near 0 and
    # locations near -2^31 (their starts wrap).
    mf_args = (mf_locs[:B], mf_locs[B:], offs, pipe.delta, C)
    mf = frontend_merge_filter(*mf_args)
    compare("merge_filter",
            lambda: frontend_merge_filter(*mf_args),
            lambda: merge_filter_ref(mf_locs[:B], mf_locs[B:], offs_t,
                                     pipe.delta, C),
            work=merge_filter_cost(B, S, K, C, mf.n_hits1, mf.n_hits2))
    if not (torch.equal(mf.pos1, fe.pos1) and torch.equal(mf.n, fe.n)):
        raise RuntimeError("merge_filter on the sharded lookup differs from "
                           "pair_frontend on the padded rows")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    syn = torch.randint(-40, 200, (2, 4096, S, K), generator=g, device=dev,
                        dtype=torch.int32)
    syn[torch.rand(syn.shape, generator=g, device=dev) < 0.3] = INVALID_LOC
    syn[:, :16] = INVALID_LOC                       # no hits at all
    syn[1, 16:32] = INVALID_LOC                     # mate 2 without hits
    syn[:, 32:48] = 60                              # one start per seed
    syn[:, 48:64, :, :K // 2] = 5                   # half the slots equal
    syn[:, 64:128] = torch.randint(0, 120, (2, 64, S, K), generator=g,
                                   device=dev, dtype=torch.int32)
    syn[:, 128:192] = torch.randint(-(2**31), -(2**31) + 4096,
                                    (2, 64, S, K), generator=g, device=dev,
                                    dtype=torch.int32)
    compare("merge_filter",
            lambda: frontend_merge_filter(syn[0], syn[1], offs, pipe.delta,
                                          C),
            lambda: merge_filter_ref(syn[0], syn[1], offs_t, pipe.delta, C),
            timed=False)
    dense_locs = dense_rows[dense_ids.long()]
    compare("merge_filter",
            lambda: frontend_merge_filter(dense_locs[:B], dense_locs[B:],
                                          offs, pipe.delta, C),
            lambda: merge_filter_ref(dense_locs[:B], dense_locs[B:], offs_t,
                                     pipe.delta, C),
            timed=False, case="every slot valid")
    del dense_rows, dense_locs

    # kernel 8: light_align of phase 2d's mates, then paper mode, E 0, 1
    # and 2 (the centre of each window), int32 bases and one row.  The
    # function's own work is counted at four bases a 32-bit word
    # (light_align_cost): a mismatch mask's four flags take a funnel
    # shift, xor, and, add, or, and, mul, shr, shl and or (10 operations),
    # a gap walk's nibble of four positions ~7.  A byte compare a base is
    # not the work's floor once four share an instruction; the bytes
    # bound (each row and window read once) takes over wherever it is the
    # larger.
    Nla = la_reads.shape[0]
    m = pipe.light_mode
    cases = ((E, m, torch.uint8, Nla), (E, "paper", torch.uint8, Nla),
             (0, m, torch.uint8, Nla), (1, m, torch.uint8, Nla),
             (2, m, torch.uint8, Nla), (E, m, torch.int32, Nla),
             (E, m, torch.uint8, 1))
    for i, (e, mode, dtype, n) in enumerate(cases):
        args = (la_reads[:n].to(dtype),
                la_wins[:n, E - e:E + R + e].contiguous().to(dtype), e)
        kw = dict(light, mode=mode)
        compare("light_align",
                lambda a=args, k=kw: light_align(*a, backend="cuda", **k),
                lambda a=args, k=kw: light_align(*a, backend="torch", **k),
                work=light_align_cost(Nla, R, E), timed=i == 0,
                case=f"E {e}, {mode}, {dtype}, {n} rows")

    def light_align_edges():
        # synthetic rows (half of them exact copies of their window's
        # centre): R 700 and 1,000 at E 8 (32 lanes a row), R = E + 2,
        # tandem repeats (ACAC... against the repeat shifted by 0 or 1:
        # the arg-min ties on many splits), all-mismatch rows, codes 0-255
        # in uint8 and int32
        g = torch.Generator(device=dev).manual_seed(SEED + 7)

        def la_rows(n, r, e, codes=4):
            rd = torch.randint(0, codes, (n, r), generator=g, device=dev,
                               dtype=torch.uint8)
            wn = torch.randint(0, codes, (n, r + 2 * e), generator=g,
                               device=dev, dtype=torch.uint8)
            wn[:n // 2, e:e + r] = rd[:n // 2]
            return rd, wn

        tandem_w = (torch.arange(R + 2 * E, device=dev) + torch.randint(
            0, 2, (Nla, 1), generator=g, device=dev)) % 2
        codes = la_rows(Nla, R, E, 256)
        for case, (rd, wn, e) in (
                ("R 700, E 8", (*la_rows(8192, 700, 8), 8)),
                ("R 1000, E 8", (*la_rows(8192, 1000, 8), 8)),
                ("R 10 = E + 2", (*la_rows(Nla, 10, 8), 8)),
                ("tandem repeats", (
                    (torch.arange(R, device=dev) % 2).expand(Nla, R).to(
                        torch.uint8), tandem_w.to(torch.uint8), E)),
                ("all mismatch", (torch.ones_like(la_reads),
                                  torch.full_like(la_wins, 3), E)),
                ("codes 0-255, uint8", (*codes, E)),
                ("codes 0-255, int32", (codes[0].int(), codes[1].int(), E))):
            for mode in (m, "paper"):
                compare("light_align",
                        lambda a=(rd, wn, e), md=mode: light_align(
                            *a, mode=md, backend="cuda"),
                        lambda a=(rd, wn, e), md=mode: light_align(
                            *a, mode=md, backend="torch"),
                        timed=False, case=f"{case}, {mode}")

    # kernel 9: xxhash32 of phase 2d's seed words (xxhash32_cost), then one
    # row under seeds 0, 99 and 0xFFFFFFFF
    n_h = seed_words.shape[0]
    compare("xxhash32",
            lambda: (xxhash32(seed_words, hs, backend="cuda"),),
            lambda: (xxhash32(seed_words, hs, backend="torch"),),
            work=xxhash32_cost(n_h))
    for seed in (0, 99, 0xFFFFFFFF):
        compare("xxhash32",
                lambda x=seed: (xxhash32(seed_words[:1], x, backend="cuda"),),
                lambda x=seed: (xxhash32(seed_words[:1], x,
                                         backend="torch"),),
                timed=False)

    # kernel 10: seed_gather of the padded rows at phase 2d's bucket ids
    # (seed_gather_cost), with
    # torch.index_select timed beside it; then a float32 table, 30-wide
    # rows (the 4-byte copy) and ids outside the table
    if not torch.equal(torch.index_select(rows, 0, ids), gathered):
        raise RuntimeError("index_select and seed_gather differ")
    compare("seed_gather",
            lambda: (seed_gather(rows, ids, backend="cuda"),),
            lambda: (seed_gather(rows, ids, backend="torch"),),
            work=seed_gather_cost(ids.numel(), K),
            library=lambda: torch.index_select(rows, 0, ids))
    Ts = 1 << 20
    edge_ids = torch.tensor([-1, -Ts, -Ts - 1, -100, Ts - 1, Ts, 2**31 - 1,
                             -2**31], dtype=torch.int32, device=dev)
    small_ids = torch.cat([ids & (Ts - 1), edge_ids])
    for table in (rows[:Ts].float(), rows[:Ts, :30].contiguous(),
                  rows[:Ts]):
        compare("seed_gather",
                lambda t=table: (seed_gather(t, small_ids, backend="cuda"),),
                lambda t=table: (seed_gather(t, small_ids, backend="torch"),),
                timed=False)
    big_edges = torch.tensor([-1, -T, -T - 1, T - 1, T, 2**31 - 1, -2**31],
                             dtype=torch.int32, device=dev)
    compare("seed_gather",
            lambda: (seed_gather(rows, big_edges, backend="cuda"),),
            lambda: (seed_gather(rows, big_edges, backend="torch"),),
            timed=False)

    # kernel 11: flash attention at yi-6b's prefill shapes (BH = 8 x 32
    # query heads over 8 x 4 K/V heads, S 2,048, D 128, bf16, causal;
    # flash_attention_cost); SDPA timed beside it.  Then float32,
    # S 2,000 (padded), causal=False, D 80 and 64, and D 112 (kimi-k2's
    # head, zero-padded to 128) in bf16 and float32.
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    n_q, n_kv = LM_BATCH * 32, LM_BATCH * 4

    def qkv(s, d, dtype):
        return [torch.randn((n, s, d), generator=g, device=dev).to(dtype)
                for n in (n_q, n_kv, n_kv)]

    for case, s, d, dtype, causal, timed in (
            ("bf16 causal S 2048 D 128", 2048, 128, torch.bfloat16, True,
             True),
            ("float32", 2048, 128, torch.float32, True, False),
            ("bf16 S 2000 padded", 2000, 128, torch.bfloat16, True, False),
            ("float32 S 2000 padded", 2000, 128, torch.float32, True, False),
            ("bf16 causal=False", 2048, 128, torch.bfloat16, False, False),
            ("bf16 D 80", 2048, 80, torch.bfloat16, True, False),
            ("bf16 D 64", 2048, 64, torch.bfloat16, True, False),
            ("bf16 D 112", 2048, 112, torch.bfloat16, True, False),
            ("float32 D 112", 2048, 112, torch.float32, True, False)):
        fq, fk, fv = qkv(s, d, dtype)
        size = 2 if dtype == torch.bfloat16 else 4
        sdpa = None
        if timed:
            q4 = fq.view(LM_BATCH, 32, s, d)
            k4, v4 = (t.view(LM_BATCH, 4, s, d) for t in (fk, fv))
            sdpa = (lambda q4=q4, k4=k4, v4=v4:
                    torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True, enable_gqa=True))
        compare("flash_attention",
                lambda a=(fq, fk, fv), c=causal: (flash_attention(
                    *a, c, backend="cuda"),),
                lambda a=(fq, fk, fv), c=causal: (flash_attention(
                    *a, c, backend="torch"),),
                work=flash_attention_cost(n_q, n_q // n_kv, s, d, causal,
                                          size),
                timed=timed, library=sdpa,
                tol=1e-4 if dtype == torch.float32 else 3e-2, case=case)
        del fq, fk, fv
    torch.cuda.empty_cache()

    # the edge cases of location_vote and light_align, untimed, after the
    # last timed reading so their large rows never run between two
    location_vote_edges()
    light_align_edges()
    torch.cuda.empty_cache()

    # ---- 4. whole step against the plain-backend Mapper --------------------
    plain = Mapper.from_index(mapper.index, mapper.ref, pipe,
                              ExecutionConfig(device="cuda", backend="torch"))
    got = mapper.map(noisy.reads1, noisy.reads2)
    want = plain.map(noisy.reads1, noisy.reads2)
    torch.cuda.synchronize()
    for f in got._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"kernel and plain Mappers differ in {f}")
    share = float((got.method == M_LIGHT).float().mean())
    print(f"[4] {B}-pair batch: kernel and plain Mappers agree on all "
          f"{len(got._fields)} MapResult fields (light-mapped {share:.4f})")
    del plain
    plain_long = Mapper.from_index(csr, ref, pipe, ExecutionConfig(
        device="cuda", backend="torch"))
    if not isinstance(plain_long.index, SeedMap):
        raise RuntimeError("the plain long-read Mapper is not on the CSR map")
    got = mapper.map_long(long_reads)
    want = plain_long.map_long(long_reads)
    torch.cuda.synchronize()
    for f in got._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"kernel and plain long-read Mappers differ "
                               f"in {f}")
    print(f"[4] {LONG_BATCH}-read long batch: kernel and plain (staged CSR) "
          f"Mappers agree on all {len(got._fields)} LongReadResult fields")

    del plain_long, got, want
    torch.cuda.empty_cache()

    # ---- 2f. serving on phase 2's session ----------------------------------
    from repro_torch.core.baseline import exact_match_rate, map_single_end
    from repro_torch.engine import FrontDoor, FrontDoorConfig
    from repro_torch.engine.index_store import store_size_bytes
    from repro_torch.engine.stats import _percentiles
    from repro_torch.launch.serve import bursty_arrivals

    serve = {}

    def rows_of(results, lo, hi):
        """Rows [lo, hi) of a list of same-typed batch results."""
        return type(results[0])(*(torch.cat(f)[lo:hi]
                                  for f in zip(*results)))

    def check_requests(requests, direct, tag):
        """Each request's rows against the same rows of the direct maps
        of its lane's pool (requests come in pool order per lane)."""
        offs = {}
        for req in requests:
            if req.status != "done":
                raise RuntimeError(f"{tag}: request {req.id} ended "
                                   f"{req.status}")
            lo = offs.get(req.lane, 0)
            want = direct[req.lane]
            for f in want._fields:
                if not torch.equal(getattr(req.result, f),
                                   getattr(want, f)[lo:lo + req.n]):
                    raise RuntimeError(
                        f"{tag}: request {req.id} ({req.lane}, rows "
                        f"{lo}..{lo + req.n}) differs from the direct map "
                        f"in {f}")
            offs[req.lane] = lo + req.n
        return offs

    def lane_latency(requests, lane):
        done = [r for r in requests if r.lane == lane]
        return {"queue_wait_s": _percentiles([r.t_dispatch - r.t_enqueue
                                              for r in done]),
                "service_s": _percentiles([r.t_result - r.t_dispatch
                                           for r in done]),
                "total_s": _percentiles([r.t_result - r.t_enqueue
                                         for r in done])}

    def fmt_lat(lat):
        return ", ".join(f"{k[:-2]} p50 {v['p50'] * 1e3:.2f} / p99 "
                         f"{v['p99'] * 1e3:.2f} ms" for k, v in lat.items())

    # 1. the store of phase 2's session, loaded into a new session
    store_dir = out_dir / "index_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    free = shutil.disk_usage(out_dir).free
    torch.cuda.synchronize()
    t0 = time.time()
    mapper.save(store_dir)
    save_s = time.time() - t0
    store_bytes = store_size_bytes(store_dir)
    t0 = time.time()
    loaded = Mapper.load(store_dir, ExecutionConfig(device="cuda"))
    torch.cuda.synchronize()
    load_s = time.time() - t0
    same_result(loaded.map(noisy.reads1, noisy.reads2), "loaded")
    if loaded.pipe_cfg != mapper.pipe_cfg or loaded.lr_cfg != mapper.lr_cfg:
        raise RuntimeError("the loaded session resolved other configs")
    shutil.rmtree(store_dir)
    del loaded
    torch.cuda.empty_cache()
    serve["store"] = {"bytes": store_bytes, "save_s": save_s,
                      "load_s": load_s,
                      "index_build_s": record["index_build_s"],
                      "disk_free_bytes": free}
    print(f"[2f] store of phase 2's session: {store_bytes / 1e9:.3f} GB "
          f"saved in {save_s:.1f} s, loaded into a new session in "
          f"{load_s:.1f} s (index built in {record['index_build_s']:.1f} "
          f"s); the loaded map equals phase 2's on all {len(res._fields)} "
          f"fields")

    # 2. a same-shape swap under a serving door (the kernels' padded
    # reference must follow the index)
    sw_exec = ExecutionConfig(device="cuda", stream_batch=SWAP_BATCH)
    sw_cfg = SeedMapConfig(table_bits=SWAP_TABLE_BITS)
    sw_refs = [random_reference(SWAP_REF_LEN, np.random.default_rng(s))
               for s in (1, 2)]
    sw_sessions = [Mapper.build(r, sw_cfg, pipe, sw_exec) for r in sw_refs]
    sw_stores = [out_dir / f"swap_store_{k}" for k in (1, 2)]
    # not `m`: light_align_edges closes over it, so a session bound to it
    # would outlive `del sw_sessions`
    for sess, path in zip(sw_sessions, sw_stores):
        shutil.rmtree(path, ignore_errors=True)
        sess.save(path)
    sw_sims = [simulate_pairs(sw_refs[1], SWAP_BATCH, ReadSimConfig(),
                              seed=SEED + 40 + k) for k in range(4)]
    door_m = Mapper.load(sw_stores[0], sw_exec)
    with FrontDoor(door_m) as fd:
        fd.warmup()
        _cuda.reset_launches()
        pre = [fd.submit("pairs", (s.reads1, s.reads2)) for s in sw_sims[:2]]
        fd.dispatch_ready()
        outcome = fd.reload_index(sw_stores[1])
        post = [fd.submit("pairs", (s.reads1, s.reads2))
                for s in sw_sims[2:]]
        fd.drain()
        swap_launches = _cuda.launch_counts()
    if outcome != "reused":
        raise RuntimeError(f"reload_index of a same-shape store gave "
                           f"{outcome!r}")
    n_differ = 0
    for req, sim, k in zip(pre + post, sw_sims, (0, 0, 1, 1)):
        want = sw_sessions[k].map(sim.reads1, sim.reads2)
        for f in want._fields:
            if not torch.equal(getattr(req.result, f), getattr(want, f)):
                raise RuntimeError(
                    f"a batch dispatched {('before', 'after')[k]} the swap "
                    f"differs from a fresh session on reference {k + 1} "
                    f"in {f}")
        if k == 1:
            old = sw_sessions[0].map(sim.reads1, sim.reads2)
            n_differ += int((old.pos1 != want.pos1).sum())
    if n_differ == 0:
        raise RuntimeError("reference 1's session maps the post-swap reads "
                           "as reference 2's does: the check cannot see a "
                           "stale index")
    for path in sw_stores:
        shutil.rmtree(path)
    del sw_sessions, door_m
    serve["swap"] = {"outcome": outcome, "rows_differing": n_differ,
                     "launches": swap_launches}
    print(f"[2f] reload_index of reference 2's store under a serving door: "
          f"{outcome}; both batches after it equal a fresh session on "
          f"reference 2 ({n_differ} rows map elsewhere on reference 1), "
          f"both before it reference 1's; launches {swap_launches}")
    if not all(swap_launches[k] > 0 for k in PAIR_KERNELS):
        raise RuntimeError(f"a kernel never launched through the swapped "
                           f"door: {swap_launches}")

    # 3. the pair-lane door at phase 2's batch shape, on phase 2's index
    pm = Mapper.from_index(mapper.index, mapper.ref, pipe, ExecutionConfig(
        device="cuda", stream_batch=BATCH))
    if pm.index[0].data_ptr() != mapper.index[0].data_ptr():
        raise RuntimeError("the door's session copied the index")
    pool = [simulate_pairs(ref, BATCH, ReadSimConfig(), seed=SEED + 50 + k)
            for k in range(DOOR_BATCHES)]
    p1 = np.concatenate([s.reads1 for s in pool])
    p2 = np.concatenate([s.reads2 for s in pool])
    trace = list(bursty_arrivals(np.random.default_rng(SEED + 60), BATCH,
                                 p1, p2))
    fd = FrontDoor(pm, FrontDoorConfig())
    fd.warmup()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    report = fd.serve(iter(trace))
    door_s = time.perf_counter() - t0
    door_launches = _cuda.launch_counts()
    fd.close()
    totals = report["stage_totals"]["pairs"]
    direct = [pm.map(s.reads1, s.reads2) for s in pool]
    if totals["dp_overflow"] or any(bool((d.method == 4).any())
                                    for d in direct):
        raise RuntimeError(f"the residual DP buffer overflowed: {totals}")
    if totals["n_pairs"] != DOOR_BATCHES * BATCH:
        raise RuntimeError(f"the door served {totals['n_pairs']} pairs")
    check_requests(fd.requests, {"pairs": rows_of(direct, 0, len(p1))},
                   "pair-lane door")
    n_door = DOOR_BATCHES * BATCH
    led = report["serve"]
    serve["pair_door"] = {
        "pairs": n_door, "requests": len(fd.requests), "seconds": door_s,
        "pairs_per_s": n_door / door_s,
        "mbp_per_s": n_door * 2 * pipe.read_len / door_s / 1e6,
        "map_stream_pairs_per_s": sr.pairs_per_s,
        "batches": led["batches"], "batch_fill": led["batch_fill"],
        "latency": led["latency"], "watchdog": report["watchdog"],
        "stage_totals": totals, "launches": door_launches}
    print(f"[2f] pair-lane door: {len(fd.requests)} requests, {n_door} pairs"
          f" in {led['batches']['pairs']} batches (fill "
          f"{led['batch_fill']['pairs']:.4f}), {door_s:.3f} s: "
          f"{n_door / door_s:.0f} pairs/s, "
          f"{n_door * 2 * pipe.read_len / door_s / 1e6:.1f} Mbp/s (phase "
          f"2's map_stream {sr.pairs_per_s:.0f} pairs/s); every request "
          f"equals its rows of a direct map")
    print(f"[2f] pair-lane door latency: {fmt_lat(led['latency'])}; "
          f"watchdog {report['watchdog']}; launches {door_launches}")
    if not all(door_launches[k] > 0 for k in PAIR_KERNELS):
        raise RuntimeError(f"a kernel never launched through the pair-lane "
                           f"door: {door_launches}")
    del direct, fd, trace, pool, p1, p2

    # 4. both lanes through one door (phase 2b's long-read shape)
    tm = Mapper.from_index(mapper.index, mapper.ref, pipe, ExecutionConfig(
        device="cuda", stream_batch=TWO_LANE_BATCH))
    n_pairs2 = TWO_LANE_BATCH * TWO_LANE_BATCHES
    n_long2 = int(round(n_pairs2 * LONG_FRAC))
    psim = simulate_pairs(ref, n_pairs2, ReadSimConfig(), seed=SEED + 70)
    lpool, ltrue = simulate_long_reads(ref, n_long2, LONG_LEN, 0.01,
                                       seed=SEED + 71)
    trace = list(bursty_arrivals(np.random.default_rng(SEED + 72),
                                 TWO_LANE_BATCH, psim.reads1, psim.reads2,
                                 lpool, LONG_FRAC))
    fd = FrontDoor(tm, FrontDoorConfig())
    fd.warmup(long_reads=lpool[:1])
    _cuda.reset_launches()
    t0 = time.perf_counter()
    report = fd.serve(iter(trace))
    two_s = time.perf_counter() - t0
    two_launches = _cuda.launch_counts()
    fd.close()
    totals = report["stage_totals"]
    chunks = range(0, n_pairs2, TWO_LANE_BATCH)
    direct_p = [tm.map(psim.reads1[i:i + TWO_LANE_BATCH],
                       psim.reads2[i:i + TWO_LANE_BATCH]) for i in chunks]
    direct_l = [tm.map_long(lpool[i:i + TWO_LANE_BATCH])
                for i in range(0, n_long2, TWO_LANE_BATCH)]
    if totals["pairs"]["dp_overflow"] or any(bool((d.method == 4).any())
                                             for d in direct_p):
        raise RuntimeError(f"the residual DP buffer overflowed: {totals}")
    if totals["pairs"]["n_pairs"] != n_pairs2 \
            or totals["long"]["n_reads"] != n_long2:
        raise RuntimeError(f"the two-lane door served {totals}")
    check_requests(fd.requests, {"pairs": rows_of(direct_p, 0, n_pairs2),
                                 "long": rows_of(direct_l, 0, n_long2)},
                   "two-lane door")
    last_pair = max(r.t_dispatch for r in fd.requests if r.lane == "pairs")
    first_long = min(r.t_dispatch for r in fd.requests if r.lane == "long")
    if first_long >= last_pair:
        raise RuntimeError("the long lane waited for the pair traffic to "
                           "end (starved)")
    led = report["serve"]
    lres = rows_of(direct_l, 0, n_long2)
    lnear2 = float(((lres.position.cpu().long()
                     - torch.from_numpy(ltrue).long()).abs()
                    <= mapper.lr_cfg.vote_bin).float().mean())
    per_lane = {}
    for lane, n_rows, bp in (("pairs", n_pairs2, 2 * pipe.read_len),
                             ("long", n_long2, LONG_LEN)):
        per_lane[lane] = {
            "rows": n_rows, "rows_per_s": n_rows / two_s,
            "mbp_per_s": n_rows * bp / two_s / 1e6,
            "requests": sum(r.lane == lane for r in fd.requests),
            "batches": led["batches"][lane],
            "batch_fill": led["batch_fill"][lane],
            "latency": lane_latency(fd.requests, lane)}
    serve["two_lane_door"] = {"seconds": two_s, "lanes": per_lane,
                              "watchdog": report["watchdog"],
                              "stage_totals": totals,
                              "long_within_vote_bin": lnear2,
                              "launches": two_launches}
    for lane, q in per_lane.items():
        print(f"[2f] two-lane door, {lane}: {q['requests']} requests, "
              f"{q['rows']} rows in {q['batches']} batches (fill "
              f"{q['batch_fill']:.4f}), {q['rows_per_s']:.0f} rows/s, "
              f"{q['mbp_per_s']:.1f} Mbp/s; {fmt_lat(q['latency'])}")
    print(f"[2f] two-lane door: {two_s:.3f} s, watchdog "
          f"{report['watchdog']}, long reads within the vote bin "
          f"{lnear2:.4f}; every request equals its rows of a direct map / "
          f"map_long; launches {two_launches}")
    if not all(two_launches[k] > 0 for k in PAIR_KERNELS + LONG_KERNELS):
        raise RuntimeError(f"a kernel never launched through the two-lane "
                           f"door: {two_launches}")
    sv = {k: swap_launches[k] + door_launches[k] + two_launches[k]
          for k in REPLACES}
    if any(sv[k] for k in BLOCK_KERNELS + LM_KERNELS + ("merge_filter",)):
        raise RuntimeError(f"a kernel off the serving path launched: {sv}")
    record["serve"] = serve
    del direct_p, direct_l, lres, fd, tm, pm, trace
    torch.cuda.empty_cache()

    # ---- 2g. the full-DP baseline on phase 2's batch -----------------------
    se_reads = torch.cat([r1_dev, revcomp(r2_dev)])
    se_true = np.concatenate([noisy.true_start1, noisy.true_start2])

    def baseline():
        """Both mates, one 65,536-read chunk at a time (reads are
        independent; a chunk's DP rows take ~8 GiB)."""
        parts = [map_single_end(csr, bases, se_reads[i:i + BATCH], pipe,
                                BASELINE_CANDS)
                 for i in range(0, 2 * BATCH, BATCH)]
        return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))

    base_runs_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):      # the first call also loads its kernels
        t0 = time.perf_counter()
        base = baseline()
        torch.cuda.synchronize()
        base_runs_ms.append((time.perf_counter() - t0) * 1e3)
    base_ms = base_runs_ms[1]
    base_peak = torch.cuda.max_memory_allocated()
    csr_cpu = SeedMap(csr.offsets.cpu(), csr.locations.cpu(), csr.config)
    on_cpu = map_single_end(csr_cpu, torch.from_numpy(ref),
                            se_reads[:BASELINE_CHECK].cpu(), pipe,
                            BASELINE_CANDS)
    for f in on_cpu._fields:
        if not torch.equal(getattr(base, f)[:BASELINE_CHECK].cpu(),
                           getattr(on_cpu, f)):
            raise RuntimeError(f"the baseline on the card differs from the "
                               f"CPU's in {f}")
    bpos = base.pos.cpu().numpy().astype(np.int64)
    bmapped = base.mapped.cpu().numpy()
    near_all = np.abs(bpos - se_true) <= 16
    near = near_all[bmapped]
    # reads with a seed equal to the reference at its true place: their
    # true start is a candidate.  A read whose three seeds all carry an
    # error (~9 % at sub_rate 0.01) has only candidates from hash
    # collisions, and the baseline maps it to the best of those, so the
    # accuracy rule is held on a batch at sub_rate 0.005 below.
    span = np.arange(pipe.read_len)
    truth_win = ref[se_true[:, None] + span]
    se_np = se_reads.cpu().numpy()
    clean_seed = np.zeros(2 * BATCH, bool)
    for o in offs:
        clean_seed |= (se_np[:, o:o + pipe.seed_len]
                       == truth_win[:, o:o + pipe.seed_len]).all(1)
    near_clean = near_all[bmapped & clean_seed]
    gx = np.concatenate([res.pos1.cpu().numpy(), res.pos2.cpu().numpy()])
    both = bmapped & (gx != INVALID_LOC)
    agree = float((bpos[both] == gx[both]).mean())
    ex1 = exact_match_rate(r1_dev, bases, torch.as_tensor(
        noisy.true_start1, device=dev))
    ex2 = exact_match_rate(se_reads[BATCH:], bases, torch.as_tensor(
        noisy.true_start2, device=dev))
    # paired-end: both mates of a pair exact
    exact = (se_np == truth_win).all(1)
    w1, w2 = exact[:BATCH], exact[BATCH:]
    record["baseline"] = {
        "reads": 2 * BATCH, "max_cands": BASELINE_CANDS, "ms": base_ms,
        "first_ms": base_runs_ms[0],
        "reads_per_s": 2 * BATCH / base_ms * 1e3,
        "peak_mem_bytes": base_peak, "mapped": float(bmapped.mean()),
        "within_16_of_mapped": float(near.mean()),
        "clean_seed": float(clean_seed.mean()),
        "within_16_of_mapped_clean_seed": float(near_clean.mean()),
        "agree_with_genpairx": agree, "both_mapped": int(both.sum()),
        "exact_single_end": (float(ex1) + float(ex2)) / 2,
        "exact_paired_end": float((w1 & w2).mean())}
    b = record["baseline"]
    print(f"[2g] map_single_end of {2 * BATCH} reads ({BASELINE_CANDS} "
          f"candidates each, full Gotoh): {base_ms:.1f} ms "
          f"({b['reads_per_s']:.0f} reads/s; first call "
          f"{base_runs_ms[0]:.1f} ms), peak device memory "
          f"{base_peak / 2**30:.2f} GiB; the first {BASELINE_CHECK} reads "
          f"equal the CPU's")
    print(f"[2g] phase 2's batch: mapped {b['mapped']:.4f}, within 16 bp "
          f"of truth {b['within_16_of_mapped']:.4f} of mapped, "
          f"{b['within_16_of_mapped_clean_seed']:.4f} of the mapped reads "
          f"with an error-free seed ({b['clean_seed']:.4f} of reads); "
          f"equal to GenPairX's "
          f"pos1/pos2 on {agree:.4f} of {b['both_mapped']} reads both map; "
          f"exact-match rate single-end {b['exact_single_end']:.4f}, "
          f"paired-end (both mates) {b['exact_paired_end']:.4f}")
    del base, on_cpu, csr_cpu, se_reads
    torch.cuda.empty_cache()
    # the accuracy rule of repro's baseline test (0.95 of the mapped reads
    # within 16 bp of the truth) on mate 1 of a batch at its sub_rate
    acc = simulate_pairs(ref, BATCH, ReadSimConfig(sub_rate=0.005),
                         seed=SEED + 80)
    acc_res = map_single_end(csr, bases, torch.as_tensor(acc.reads1,
                                                         device=dev),
                             pipe, BASELINE_CANDS)
    acc_mapped = acc_res.mapped.cpu().numpy()
    acc_near = (np.abs(acc_res.pos.cpu().numpy().astype(np.int64)
                       - acc.true_start1) <= 16)[acc_mapped]
    b["sub_rate_0005"] = {"reads": BATCH, "mapped": float(acc_mapped.mean()),
                          "within_16_of_mapped": float(acc_near.mean())}
    print(f"[2g] {BATCH} reads at sub_rate 0.005: mapped "
          f"{acc_mapped.mean():.4f}, within 16 bp of truth "
          f"{acc_near.mean():.4f} of mapped (rule: 0.95)")
    if acc_near.mean() < 0.95:
        raise RuntimeError("baseline accuracy below 0.95 within 16 bp of "
                           "the mapped reads at sub_rate 0.005")
    del acc, acc_res
    torch.cuda.empty_cache()

    # ---- 2h. the rest of the mapper: core API, tuner, fleet stream -------
    from repro_torch.core import map_long_reads, seedmap_stats
    from repro_torch.core.query import query_padded
    from repro_torch.core.seeding import seed_read_batch
    from repro_torch.engine import multihost
    from repro_torch.engine.stats import ServeStats
    from repro_torch.runtime import PreemptionGuard
    from repro_torch.tune import BLOCK_GRID, FAMILIES, tune_session

    rest = {}
    t_rest = time.time()
    _cuda.reset_launches()
    # 1. the core API on the card, against the session's own step
    got = map_long_reads(mapper.index, mapper.ref, long_reads, mapper.lr_cfg)
    want = mapper.map_long(long_reads)
    torch.cuda.synchronize()
    for f in want._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"map_long_reads differs from Mapper.map_long "
                               f"in {f}")
    r2_fwd = revcomp(r2_dev).contiguous()
    step_ids = seed_buckets(r1_dev, r2_fwd, pipe.seed_len, S, hs, T)
    seeds = torch.cat([seed_read_batch(x, pipe.seed_len, S, hs).hashes
                       for x in (r1_dev, r2_fwd)])
    q_rows, q_counts = query_padded(mapper.index, seeds)
    if not torch.equal(q_rows, mapper.index.rows[step_ids.long()]):
        raise RuntimeError("query_padded differs from the rows the step's "
                           "seed_buckets ids select")
    q_fe = frontend_merge_filter(q_rows[:B], q_rows[B:], offs, pipe.delta, C)
    step_fe = frontend_from_buckets(rows, step_ids, offs, pipe.delta, C)
    for f in step_fe._fields:
        if not torch.equal(getattr(q_fe, f), getattr(step_fe, f)):
            raise RuntimeError(f"query_padded's rows, merged, differ from "
                               f"the step's front end in {f}")
    stats = seedmap_stats(csr)
    if stats["n_locations"] != int(csr.offsets[-1]) or \
            stats["table_size"] != sm_cfg.table_size:
        raise RuntimeError(f"seedmap_stats {stats} disagree with the index")
    rest["seedmap_stats"] = stats
    print(f"[2h] map_long_reads of {LONG_BATCH} x {LONG_LEN} bp equals "
          f"Mapper.map_long on all {len(want._fields)} fields; query_padded "
          f"of the batch's {seeds.numel()} seeds equals the step's rows and, "
          f"merged, its candidates; seedmap_stats: {stats}")
    del got, want, q_rows, q_counts, q_fe, step_fe, seeds

    # 2. the tuner at phase 2's shape: every grid value of every family is
    # held against the plain version on the same inputs inside the sweep
    cache = out_dir / "tune_cache.json"
    cache.unlink(missing_ok=True)
    t0 = time.time()
    entries = tune_session(ref, mapper.index, pipe, ExecutionConfig(
        device="cuda"), batch=BATCH, lr_cfg=lr, reps=3,
        long_read_len=LONG_LEN, path=cache)
    rest["tune_s"] = time.time() - t0
    rest["tune"] = entries
    winners = {}
    for key, e in sorted(entries.items()):
        family = key.split("/")[1]
        winners[family] = e["params"]
        grid = {k for k in e["meta"]["candidates_us"]
                if not k.startswith("staged")}
        print(f"[2h] {key}: {e['params']} us {e['us']} staged_us "
              f"{e['staged_us']} plain_faster {e['plain_faster']} "
              f"({e['meta']['tune_s']:.2f} s); candidates us "
              f"{e['meta']['candidates_us']}")
        if not key.startswith("cuda/") or e["plain_faster"]:
            raise RuntimeError(f"{key}: the plain version beat every kernel "
                               f"configuration, or the entry is not the "
                               f"kernel's")
        if not all(any(k.startswith(f"block{b}") for k in grid)
                   for b in BLOCK_GRID[family]):
            raise RuntimeError(f"{key}: the sweep left out a grid value: "
                               f"{sorted(grid)}")
    if sorted(winners) != sorted(FAMILIES):
        raise RuntimeError(f"the tuner wrote {sorted(entries)}")
    print(f"[2h] tune_session: {len(entries)} entries in "
          f"{rest['tune_s']:.1f} s; every launch geometry of each grid "
          f"equals the plain version on the same inputs")
    pa, rd = winners["candidate_align"], winners["residual_dp"]
    explicit_cfg = dataclasses.replace(
        pipe, frontend_block=winners["pair_frontend"].get("block"),
        light_block=pa.get("block"), residual_block=rd.get("block"),
        prescreen_top=pa["prescreen_top"], dp_band=rd.get("dp_band"))
    tuned = Mapper.from_index(mapper.index, mapper.ref, pipe,
                              ExecutionConfig(device="cuda", tune=str(cache)))
    explicit = Mapper.from_index(mapper.index, mapper.ref, explicit_cfg,
                                 ExecutionConfig(device="cuda"))
    if tuned.pipe_cfg != explicit.pipe_cfg or \
            tuned.lr_cfg.vote_block != winners["location_vote"].get("block"):
        raise RuntimeError(f"the tuned session resolved {tuned.pipe_cfg}, "
                           f"not the winners {explicit.pipe_cfg}")
    got = tuned.map(noisy.reads1, noisy.reads2)
    want = explicit.map(noisy.reads1, noisy.reads2)
    torch.cuda.synchronize()
    for f in want._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise RuntimeError(f"the tuned session differs from the "
                               f"explicit one in {f}")
    semantic = (pa["prescreen_top"] != 0 or rd.get("dp_band") is not None)
    if not semantic:
        for f in res._fields:
            if not torch.equal(getattr(got, f), getattr(res, f)):
                raise RuntimeError(f"the tuned session (launch geometry "
                                   f"only) differs from phase 2 in {f}")
    rest["tuned_cfg"] = {k: getattr(tuned.pipe_cfg, k) for k in (
        "frontend_block", "light_block", "residual_block", "prescreen_top",
        "dp_band", "packed_ref")}
    print(f"[2h] tune=cache session: {rest['tuned_cfg']}, vote_block "
          f"{tuned.lr_cfg.vote_block}; maps phase 2's batch equal to the "
          f"session that sets the winners explicitly"
          + ("" if semantic else ", and to phase 2's own result"))
    del tuned, explicit, got, want

    # 3. the fleet stream at world size 1 (no process group): the
    # single-host loop, with a one-host health ledger
    if multihost.process_count() != 1:
        raise RuntimeError("a process group is still initialised")
    # in turns with the session's own map_stream (plain, fleet, fleet,
    # plain): phase 2's stream ran first in its process, on a cold card
    rates = {"map_stream": [], "fleet": []}
    for kind in ("map_stream", "fleet", "fleet", "map_stream"):
        kw = dict(reduce_fn=count_correct, reduce_init=torch.zeros(
            (), dtype=torch.int64, device=dev))
        fsr = (mapper.map_stream(stream_batches, **kw) if kind ==
               "map_stream" else multihost.map_stream(
                   mapper, stream_batches, serve_stats=ServeStats(), **kw))
        rates[kind].append(fsr.pairs_per_s)
        if fsr.totals != sr.totals or int(fsr.reduced) != int(sr.reduced):
            raise RuntimeError(f"the {kind} stream's totals {fsr.totals} "
                               f"differ from phase 2's {sr.totals}")
        if kind == "fleet":
            h = fsr.health
            if (h["n_hosts"], h["keepalive_rounds"], h["rounds"]) != (
                    1, 0, STREAM_BATCHES):
                raise RuntimeError(f"the one-host health ledger is off: {h}")
    rest["fleet_stream"] = {"pairs": fsr.n_pairs, "pairs_per_s": rates,
                            "phase2_pairs_per_s": sr.pairs_per_s,
                            "health": h}
    print(f"[2h] multihost.map_stream at world size 1: {fsr.n_pairs} pairs, "
          f"totals equal phase 2's; pairs/s in turns map_stream "
          f"{rates['map_stream'][0]:.0f}, fleet {rates['fleet'][0]:.0f}, "
          f"fleet {rates['fleet'][1]:.0f}, map_stream "
          f"{rates['map_stream'][1]:.0f} (phase 2's map_stream "
          f"{sr.pairs_per_s:.0f}); health n_hosts {h['n_hosts']}, "
          f"keepalive_rounds {h['keepalive_rounds']}")
    direct = []
    mapper.map_stream(stream_batches, on_result=lambda i, r, n:
                      direct.append(r))
    guard = PreemptionGuard()

    def fired_after_two():
        for k, item in enumerate(stream_batches):
            yield item
            if k == 1:
                guard.request()

    accepted = []
    try:
        dsr = multihost.map_stream(mapper, fired_after_two(), guard=guard,
                                   on_result=lambda i, r, n:
                                   accepted.append(r))
    finally:
        guard.uninstall()
    if dsr.health["drain_reason"] != "preemption" or \
            not 2 <= dsr.n_batches < STREAM_BATCHES:
        raise RuntimeError(f"the guarded stream did not drain: "
                           f"{dsr.health}")
    for k, got in enumerate(accepted):
        for f in got._fields:
            if not torch.equal(getattr(got, f), getattr(direct[k], f)):
                raise RuntimeError(f"accepted batch {k} of the drained "
                                   f"stream differs from the stream's in {f}")
    rest["drained_stream"] = {"batches": dsr.n_batches,
                              "pairs": dsr.n_pairs, "health": dsr.health}
    print(f"[2h] guard fired after batch 2: drained after "
          f"{dsr.n_batches} batches ({dsr.n_pairs} pairs, the one being "
          f"pulled lands); each accepted batch equals map_stream's")
    del direct, accepted
    torch.cuda.synchronize()
    rest_launches = _cuda.launch_counts()

    # 4. serve --chaos as its own process on the card
    health_path = out_dir / "health.json"
    health_path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(
        Path(__file__).resolve().parent / "src")}
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--loop", "stream",
         "--chaos", "sigterm@0:2", "--health-out", str(health_path)],
        env=env, capture_output=True, text=True, timeout=600)
    rest["serve_chaos_s"] = time.time() - t0
    if run.returncode != 0:
        raise RuntimeError(f"serve --chaos exited {run.returncode}:\n"
                           f"{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    served = json.loads(run.stdout)
    sh = json.loads(health_path.read_text())
    if sh != served["health"] or (sh["n_hosts"], sh["drain_reason"],
                                  sh["rounds"]) != (1, "preemption", 3):
        raise RuntimeError(f"serve --chaos's health ledger is off: {sh}")
    rest["serve_chaos"] = {k: served[k] for k in (
        "pairs", "pairs_per_s", "chaos", "mapped_frac", "correct_of_mapped")}
    rest["launches"] = rest_launches
    rest["seconds"] = time.time() - t_rest
    record["rest"] = rest
    print(f"[2h] serve --chaos sigterm@0:2 (its own process, "
          f"{rest['serve_chaos_s']:.1f} s): {served['pairs']} pairs, drained "
          f"by preemption after {sh['rounds']} batches; health.json read "
          f"back; mapped {served['mapped_frac']:.4f}")
    print(f"[2h] launches over this phase: {rest_launches}; "
          f"{rest['seconds']:.1f} s")
    if not all(rest_launches[k] > 0 for k in PAIR_KERNELS + LONG_KERNELS):
        raise RuntimeError(f"a kernel of the mapper never launched in 2h: "
                           f"{rest_launches}")
    torch.cuda.empty_cache()

    # phase 3's device times read again after the serving phases, which
    # hold the store, the doors and the baseline's ~18 GiB of DP rows
    after = {n: device_ms(fn, n) for n, fn in timed_runs.items()}
    record["device_ms_after_serving"] = after
    print("[3] device ms of each timed case, phase 3 / after 2f and 2g: "
          + "; ".join(f"{n} {fmt_ms(kernels[n]['device_ms'])} / "
                      f"{fmt_ms(ms)}" for n, ms in after.items()))
    del timed_runs

    # ---- 2i. the rest of the LM substrate at full width --------------------
    # The mapping sessions' device memory goes first (the 2^26-bucket
    # index alone is 8.6 GB); the LM configs need up to ~65 GB.
    import gc
    del mapper, smapper, csr, rows, words, kref, bases, bases_kref
    del mf_locs, mf_buckets, synth
    del table        # phase 3's last seed_gather table, a view of `rows`
    gc.collect()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the LM gates assume off")
    held = torch.cuda.memory_allocated()
    print(f"[2i] {held / 2**30:.2f} GiB still held from the mapping phases")
    t_fam = time.time()
    fam_launches = {k: 0 for k in REPLACES}
    record["lm_families"] = {"held_before_bytes": held}
    for i, (name, n_layers, want_flash) in enumerate(LM_FAMILIES):
        rec, fl = lm_family_run(name, n_layers, want_flash, SEED + 80 + i)
        record["lm_families"][name] = rec
        for k, v in fl.items():
            fam_launches[k] += v
    record["lm_families"]["seconds"] = time.time() - t_fam
    print(f"[2i] launches over the six prefills and decodes: "
          f"{fam_launches}; {record['lm_families']['seconds']:.1f} s")

    # ---- 2j. LM training: stablelm-3b at full width -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[2j] {held / 2**30:.2f} GiB still held before training")
    t_train = time.time()
    _cuda.reset_launches()
    record["train"] = {"held_before_bytes": held,
                       "full": train_full_width(SEED + 90, out_dir)}
    gc.collect()
    torch.cuda.empty_cache()
    record["train"]["card_vs_cpu"] = train_card_vs_cpu(SEED + 91)
    record["train"]["end_to_end"] = train_end_to_end(SEED + 92, out_dir)
    refusal = flash_refuses_autograd()
    train_launches = _cuda.launch_counts()
    if any(train_launches.values()):
        raise RuntimeError(f"the training path launched kernels: "
                           f"{train_launches}")
    record["train"]["seconds"] = time.time() - t_train
    print(f"[2j] no kernel launched over training (blockwise attention); "
          f"flash_attention under autograd on the card raises: "
          f"\"{refusal}\"; {record['train']['seconds']:.1f} s")

    # ---- 2k. the trainer's mesh path on a one-rank NCCL group ---------------
    from repro_torch.launch.mesh import make_host_mesh
    gc.collect()
    torch.cuda.empty_cache()
    t_mesh = time.time()
    _cuda.reset_launches()
    train_store = (out_dir / "nccl_store_train").resolve()
    train_store.unlink(missing_ok=True)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the save's group
    dist.init_process_group("nccl", init_method=f"file://{train_store}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    try:
        tmesh = make_host_mesh(1, 1, "cuda")
        print(f"[2k] mesh: {tmesh}")
        full_rec = record["train"]["full"]
        mesh_rec = train_mesh_full_width(SEED + 90, tmesh,
                                         full_rec["steps"][0])
    finally:
        dist.destroy_process_group()
    train_store.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_rec["end_to_end"] = train_mesh_end_to_end(SEED + 93, out_dir,
                                                   train_store)
    train_store.unlink(missing_ok=True)
    train_mesh_launches = _cuda.launch_counts()
    if any(train_mesh_launches.values()):
        raise RuntimeError(f"the mesh training path launched kernels: "
                           f"{train_mesh_launches}")
    mesh_rec["seconds"] = time.time() - t_mesh
    record["train"]["mesh"] = mesh_rec
    print(f"[2k] {card}: mesh path {mesh_rec['ms_per_step']:.1f} ms a "
          f"step, {mesh_rec['tokens_per_s']:.0f} tokens/s against 2j's "
          f"{full_rec['ms_per_step']:.1f} ms, "
          f"{full_rec['tokens_per_s']:.0f} tokens/s (overhead at world "
          f"size 1: {mesh_rec['ms_per_step'] / full_rec['ms_per_step'] - 1:+.4f}"
          f"); peak {mesh_rec['peak_bytes'] / 2**30:.2f} GiB against "
          f"{full_rec['peak_bytes'] / 2**30:.2f}; no kernel launched; "
          f"{mesh_rec['seconds']:.1f} s")

    # ---- 2l. LM serving through the mesh path ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_serve = time.time()
    serve_store = (out_dir / "nccl_store_serve").resolve()
    serve_store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{serve_store}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    serve_mesh_launches = {k: 0 for k in REPLACES}
    try:
        smesh = make_host_mesh(1, 1, "cuda")
        yi_rec, fl = serve_mesh_yi(smesh, serve_ref, out_dir)
        record["serve_mesh"] = {"yi-6b": yi_rec}
        for k, v in fl.items():
            serve_mesh_launches[k] += v
        for i, (name, n_layers, n_flash) in enumerate(SERVE_MESH_FAMILIES):
            gc.collect()
            torch.cuda.empty_cache()
            rec, fl = serve_mesh_family(name, n_layers, n_flash,
                                        SEED + 100 + i, smesh)
            record["serve_mesh"][name] = rec
            for k, v in fl.items():
                serve_mesh_launches[k] += v
    finally:
        dist.destroy_process_group()
    serve_store.unlink(missing_ok=True)
    del serve_ref
    serve_flash = get_config("yi-6b").n_layers + sum(
        f for _, _, f in SERVE_MESH_FAMILIES)
    record["serve_mesh"]["seconds"] = time.time() - t_serve
    print(f"[2l] launches over the mesh path's prefills and decodes: "
          f"{serve_mesh_launches} (kimi-k2 left out: one of its layers "
          f"costs 2i's time); {record['serve_mesh']['seconds']:.1f} s")
    if serve_mesh_launches["flash_attention"] != serve_flash or any(
            v for k, v in serve_mesh_launches.items()
            if k not in LM_KERNELS):
        raise RuntimeError(f"the mesh serving path's launches are off (want "
                           f"{serve_flash} flash launches and nothing "
                           f"else): {serve_mesh_launches}")

    # ---- 2m. tensor parallelism over model: two gloo ranks on one card ----
    gc.collect()
    torch.cuda.empty_cache()
    t_tp = time.time()
    record["serve_tp"], serve_tp_launches = serve_tp(out_dir)
    record["serve_tp"]["seconds"] = time.time() - t_tp
    print(f"[2m] launches over both ranks' prefills and decodes: "
          f"{serve_tp_launches}; ranks {record['serve_tp']['ranks_s']:.1f} "
          f"s; {record['serve_tp']['seconds']:.1f} s")

    # ---- 2n. the dry run against the card ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    record["dryrun"] = dryrun_against_card(record, pair_dry, out_dir)

    # ---- 5. results -----------------------------------------------------
    for name, entry in kernels.items():
        entry["launches_serve"] = sv[name]
        entry["launches_tune_fleet"] = rest_launches[name]
        entry["launches_lm_families"] = fam_launches[name]
        entry["launches_train"] = train_launches[name]
        entry["launches_train_mesh"] = train_mesh_launches[name]
        entry["launches_serve_mesh"] = serve_mesh_launches[name]
        entry["launches_serve_tp"] = serve_tp_launches[name]
        entry["launches"] += sv[name] + rest_launches[name] \
            + fam_launches[name] + train_launches[name] \
            + train_mesh_launches[name] + serve_mesh_launches[name] \
            + serve_tp_launches[name]
    bad = [k["name"] for k in kernels.values() if not k["match"]]
    if bad:
        raise RuntimeError(f"kernels differ from their plain versions: {bad}")
    line = {"kernels": [kernels[n] for n in REPLACES]}
    record.update(card=card, kernels=line["kernels"])
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-tp-rank"]:
        sys.exit(serve_tp_rank(int(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
