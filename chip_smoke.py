#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX or of the JAX package. It

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel from ``csrc/`` (one ``nvcc``
   per source, all together);
2. holds each kernel against its plain PyTorch version on the card and
   times kernel, plain version and library call, with the achieved
   TFLOP/s and the ratio to the library call: ``moe_gmm`` forward at
   the serving and training shapes and at the wgmma route's tile edges,
   its backward at the training shapes and a grouped ragged one (two
   runs must give the same bits; a backward under torch.profiler must
   launch its two kernels and no copy; f32 against the plain arithmetic
   in float64), ``flash_attention``
   forward and backward at the training shape (and at D 128, at the
   dense paths' GQA 16/2 at head dim 128 and MHA 32/32 at 64, and at
   hubert's bidirectional MHA 16/16 at head dim 80) plus
   ragged, windowed, bidirectional, decode and odd-width cases, with a
   check that two backward runs give the same bits, ``rmsnorm`` at
   every width the ten architectures normalise (8192 rows of D 1024 to
   8192, 327680 rows of 128, a decode step) and at two cases of its
   "plain" route, with the share of the bound; in bf16 and f32 (each
   call's route asserted, the library calls with TF32 off, SDPA's
   backend named, f32 bounds at the FMA and 3xTF32 rates). The bf16
   edge routes of ``moe_gmm`` ("wgmma_edge", forward and backward) and
   ``ssd_scan`` ("tc_edge"), on no path, are held and timed at the
   training shapes with their widths made odd and with every tensor one
   element off alignment, and held at small widths whose rows are only
   2-byte aligned;
3. serves full-width granite-moe-1b-a400m in bf16 (random weights from a
   seed) at batch 4, prompt 64, gen 32 with ``moe_impl="kernel"``, counts
   the kernel launches of that run, then checks the result: the same
   prefill with ``moe_impl="einsum"`` (routing, each MoE block, last
   logits) and the reduced float32 config on the card against the host,
   and profiles a decode step;
4. trains full-width granite-moe-1b-a400m (24 layers, bf16, remat full)
   for 10 steps at global batch 2 x seq 4096 through the flash-attention
   and moe_gmm kernels, counts each kernel's launches, profiles one
   step, runs the same 10 steps from the same weights through the plain
   routes (the losses must be finite and track them), and holds layer
   0's attention and MoE blocks (outputs and gradients) against the
   plain routes in situ and 5 steps of the reduced f32 model on the card
   against the host;
5. trains it again from fresh weights for 100 steps of the launcher's
   own schedule (lr 3e-4, warm-up 20) through the kernels: the loss on a
   batch never trained on must fall;
6. holds the ``ssd_scan`` kernels (forward and backward) against the
   plain version's autograd on the card (the training shape in bf16 and
   f32, partial chunks, S 127, 128 and 129 at the training widths, two
   groups, widths that do not tile, chunk == S, large decays), with a
   check that two backward runs give the same bits, and prints the bytes
   of the saved chunk states beside the bound, then trains full-width,
   full-depth mamba2-1.3b (48 layers, bf16, remat full) for 10 steps at
   batch 2 x 4096 through the ``ssd_scan`` kernels with the launch
   counts asserted, profiles one step, runs the same 10 steps through
   the plain route, holds layer 0's mixer (output and gradients) against
   the plain route in situ and 5 steps of the reduced f32 model on the
   card against the host, and serves it at full width (prefill and
   decode logits against a full-sequence forward);
7. trains the dense family at full width and depth, bf16, remat full,
   the granite train phase's batch and schedule, through the flash
   kernels with the launch counts asserted (qwen2.5-3b: 36 layers, GQA
   16/2 at head dim 128, qkv bias, tied 151936-row head, 72 + 108 flash
   launches a step; stablelm-1.6b: 24 layers, MHA 32/32 at 64, untied,
   48 + 72), profiles a step of each, runs the same 10 steps through the
   plain route, and holds layer 0's attention in situ and 5 steps of the
   reduced f32 model on the card against the host;
8. serves full-width qwen3-14b (40 layers, d 5120, 40/8 heads of 128,
   qk-norm, 14.8 B parameters in bf16) at batch 4, prompt 64, gen 32 (no
   kernel launch: serving attends with its cache), prefill and decode
   logits against a full-sequence forward;
9. checkpoints and resumes qwen2.5-3b at full width, its depth cut to 4
   layers: two uninterrupted 10-step runs, then 5 steps, an async save
   in the JAX package's on-disk layout, a restore into a fresh model and
   state (bit for bit) and the last 5 steps, whose losses must match the
   uninterrupted run's (bit for bit where its two runs agree so);
10. trains hubert-xlarge at full width and depth (48 layers, d 1280, MHA
    16/16 at head dim 80, bidirectional, 1.259 B parameters) on the
    pipeline's frame embeddings, as step 7 trains the dense family: 96 +
    144 flash launches a step asserted, a profiled step, the plain route,
    layer 0 in situ and the reduced f32 model on the card against the
    host;
11. runs reduced f32 jamba-1.5-large (two 8-slot periods: attention,
    seven Mamba2 mixers, MoE on the odd slots) with flash, ``ssd_scan``
    and ``moe_gmm`` in one stack under nested remat: 5 training steps on
    the card against the host with the launch counts asserted, and
    prefill and decode against a full forward;
12. serves llama-3.2-vision-90b at full width with its depth cut to one
    period (4 self-attention layers, 1 gated cross layer; 6.38 B
    parameters) on media from the launcher's generator, its gates set
    nonzero from the seed: logits against a full forward, other media
    must move them and, with the gates at zero, must not;
13. serves command-r-35b at full width and depth (40 layers, d 8192, GQA
    64/8 at 128, tied 256000-row head; 30.28 B parameters, 60.6 GB in
    bf16) as step 8 serves qwen3-14b, and holds ``kv_repeat=2`` to
    ``kv_repeat=1`` on its reduced config;
14. [dryrun], on the host before the card phases: ``launch/dryrun.py``'s
    ``run_cell`` (placeholder rank, meta tensors) at mesh (1, 1) with the
    exact settings of each full-width train phase (granite, mamba2,
    qwen2.5-3b, stablelm-1.6b, hubert-xlarge: batch 2 x 4096, remat full,
    AdamW, bf16, the kernel routes) predicts its per-device peak memory
    and FLOPs a step; after each train phase the step's arguments must
    equal the card's byte for byte, the step's own part of the card's
    peak (in the bytes the tensors asked for) lie within 0.1 % of the
    accounting's, and ``max_memory_allocated`` within 10 % of the
    prediction plus the bytes resident outside the step (named and
    printed);
15. [mesh], after the learning run: a one-rank NCCL world and the
    production mesh's counterpart at (1, 1); full-width granite placed
    by the role rules (every leaf Replicate) trains 3 steps of the dry
    run's train step through flash and moe_gmm as DTensors with the
    mesh's steal table (launch counts asserted per step), against the
    same steps on plain tensors: losses and weights equal bit for bit;
    then the DTensor run's weights are saved through ``convert.to_jax``'s
    DTensor path and ``save`` ("full" entries: each leaf's mesh has one
    device), restored into plain tensors and held bit for bit against
    the plain run's weights;
16. [elastic], after [resume]: full-width, full-depth granite through
    flash and moe_gmm (the train phase's batch, schedule and steal
    table) driven by the port's ``Supervisor`` over a modelled fleet
    (ELASTIC: 4 hosts, ``multi_pod(2, 4, 4)`` behind mesh (4, 8), a
    checkpoint every 4 steps, chips 5 and 6 lost before step 6, host 3
    3x slower from step 5); its callbacks save and restore real
    checkpoints (~13.4 GB, the JAX layout, under TMPDIR). The events
    must equal the stub run's, every executed step's loss (the replays
    included) and the final weights the uninterrupted run's (bit for
    bit where two uninterrupted runs agree, else within their spread),
    the restored weights and state what was saved, bit for bit, and
    each step's launch counts the train phase's;
17. [examples]: the port's four examples as shipped
    (``repro_torch.examples``) on the card, what each prints or returns
    checked;
18. [cp], after the flash kernels: qwen3-14b's attention at full width
    (40 q heads over 8 kv heads of 128, bf16, causal, batch 1 x 4096 and
    1 x 32768) split along its keys as the model splits it where the
    stored KV heads do not divide a 16-way model axis: K/V cut into 16
    blocks, each through the flash forward kernel at its own (negative)
    ``kv_offset``, merged by the model's ``merge_blocks``, then each
    block's backward with the merged out and lse; each block's out, lse,
    dQ share, dK and dV held against the block computed plainly in f32 at
    the block's own scale (planted faults in the last block must be
    refused), and the merged out and lse, the summed dQ and each block's
    dK/dV against one flash call over all keys (16 forward and 48
    backward launches asserted), each block's time
    beside the one call's (the causal imbalance); and one decode query at
    position 32767 over 16 cache blocks through the plain route against
    the whole-cache plain attention;
19. [roofline], last: ``launch/roofline.py``'s floors (compute from the
    dry run's FLOPs, memory and collectives from closed forms, at the
    H100's spec-sheet rates) of each full-width train phase's [dryrun]
    record beside its measured ms/step (no floor may exceed it), and of
    qwen3-14b's and llama4-scout's ``prefill_32k`` at mesh (16, 16),
    whose records one dry-run process makes on the host;
20. [sim], after the kernel phases: the NANOS simulator's kernel
    (``csrc/sim.cu``, one thread a cell): its replicas of numpy's
    MT19937 and shuffle and of CPython's set against the originals,
    ``tests/data/sim_golden.json``'s 25 keys exactly (again in forced
    waves and at the other number of cells a warp), then the paper's
    figure grid on sunfire_x4600 at full width as one batch (fft and
    sort at 2^15 with cutoff 4, strassen medium; bf/cilk/wf in the
    baseline and NUMA contexts and dfwspt/dfwsrpt/dfwshier in NUMA at
    2-16 threads, 32 seeds; a straggler and a preempt grid of all six at
    16 threads, 4 seeds; 5328 cells, launches counted), 8 of its cells
    bit for bit against the plain version on the host, the grid's kernel
    time, cells/s, events/s, waves and peak memory, the paper's claims
    on its means, and the grid again at 1, 4, 8 and 32 cells a warp;
21. [sim_durable], after [sim]: the simulator's traced and durable
    path. The traced sweep behind the analysis layer (fft/sort/strassen
    at [sim]'s scale under wf/dfwspt/dfwsrpt/dfwshier at 2-16 threads,
    the allocation study's bf/cilk/wf cells, nqueens/floorplan/sparselu
    medium; seeds 0 and 1; 162 cells) through the traced instantiation of
    ``csrc/sim.cu``, journaled with ``resume=`` under ``TMPDIR``: every
    result equal to the untraced grid's, the events' counts and
    histograms equal to the metrics, 4 cells' traces equal to the plain
    version's event for event; a rerun that launches nothing and gives
    the same results and sidecar traces, and a journal torn mid-line
    that reruns one cell. Then the paper-scale FFT (1 769 471 tasks) from
    the port's compile cache (cold and warm opens timed) at 16 threads
    untraced and traced, one cell held against the plain version, and a
    timeout that stops it while the medium cells it runs beside finish;
22. prints the ``kernels`` JSON line (the [mesh] and [elastic] runs'
    launches included) and, last, the device JSON line.

Any failure raises and exits non-zero before the last line is printed.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense bf16 tensor cores
              torch.float32: 67e12}        # f32 FMAs outside the tensor cores
# the f32 routes' rate: 3xTF32 takes three TF32 tensor-core products
# (494.7 TFLOP/s dense) for each f32 product
TF32X3_FLOPS = 494.7e12 / 3
# tests/test_kernels.py's tolerances (atol = rtol): moe_gmm, flash
# attention forward, rmsnorm; attention gradients (f32 looser: the
# backward sums over a whole sequence in another order)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
FLASH_TOL = {torch.float32: 3e-4, torch.bfloat16: 3e-2}
FLASH_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
L2_BYTES = 50e6

# (label, Z = groups x experts, C, D, F, expert period[, offset]): the
# offset, where given, puts every tensor that many elements into its
# storage
GMM_CASES = [
    ("prefill gate/up", 32, 80, 1024, 512, 32),
    ("prefill down", 32, 80, 512, 1024, 32),
    ("decode gate/up", 32, 8, 1024, 512, 32),
    ("decode down", 32, 8, 512, 1024, 32),
    ("ragged", 2, 100, 48, 72, 2),
    ("ragged odd widths", 3, 33, 50, 70, 3),
    ("grouped G=2", 64, 80, 1024, 512, 32),
    # training at batch 2 x seq 4096: 2 groups x 32 experts, capacity 1280
    ("train gate/up", 64, 1280, 1024, 512, 32),
    ("train down", 64, 1280, 512, 1024, 32),
    # the bf16 wgmma route's 128-row tiles: C at and around one
    # consumer's 64 rows and a whole tile, F 136 a ragged column tile
    ("tile edge C 64", 4, 64, 256, 136, 2),
    ("tile edge C 65", 4, 65, 256, 136, 2),
    ("tile edge C 127", 4, 127, 256, 136, 2),
    ("tile edge C 129", 4, 129, 256, 136, 2),
    # the training shapes with D and F off a multiple of 8, and with every
    # tensor one element off 16-byte alignment: bf16 takes the edge route
    # ("wgmma_edge": rows loaded as 16-byte granules and shifted into place
    # by the producer's threads), timed here although no path launches
    # it; rows only 2-byte aligned at a small shape
    ("train gate/up odd", 64, 1280, 1020, 510, 32),
    ("train down odd", 64, 1280, 510, 1020, 32),
    ("train gate/up offset", 64, 1280, 1024, 512, 32, 1),
    ("2-byte rows", 4, 100, 51, 77, 2),
]
REPORT_CASE = ("train gate/up", torch.bfloat16)    # 2 of 3 calls a layer
# the training shapes, dw's group walk crossing a ragged C (100 rows: the
# rows past C must read 0, not the next expert's), and 2-byte rows
GMM_BWD_CASES = [c for c in GMM_CASES if c[0].startswith("train")] + [
    ("grouped ragged", 6, 100, 264, 200, 3),
    ("2-byte rows", 4, 100, 51, 77, 2)]
# the backwards held under torch.profiler (two kernels, no copy): the
# training shape in both dtypes, and bf16's edge route
GMM_NO_COPY = (("train gate/up", torch.bfloat16),
               ("train gate/up", torch.float32),
               ("train gate/up odd", torch.bfloat16))

# (label, B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset)
FLASH_CASES = [
    ("train causal", 2, 4096, 4096, 16, 8, 64, True, None, 0),
    ("train causal D128", 2, 4096, 4096, 32, 8, 128, True, None, 0),
    # the dense training paths: GQA 8:1 at head dim 128, MHA at 64
    ("qwen2.5-3b train", 2, 4096, 4096, 16, 2, 128, True, None, 0),
    ("stablelm-1.6b train", 2, 4096, 4096, 32, 32, 64, True, None, 0),
    # hubert-xlarge: bidirectional MHA 16/16 at head dim 80 (the D 128
    # tiles, 48 of their columns padding)
    ("hubert-xlarge train", 2, 4096, 4096, 16, 16, 80, False, None, 0),
    ("ragged", 2, 100, 100, 4, 2, 64, True, None, 0),
    ("window 64", 1, 512, 512, 4, 2, 64, True, 64, 0),
    ("bidirectional", 1, 256, 256, 4, 2, 64, False, None, 0),
    ("decode", 2, 1, 24, 4, 2, 64, True, None, 9),
    ("head dim 48", 1, 130, 130, 6, 3, 48, True, None, 0),
]
FLASH_REPORT = ("train causal", torch.bfloat16)
# rmsnorm: (rows, D, x's offset in elements) at the widths the ten
# architectures normalise, in the rows of a training batch (2 x 4096) and
# of a decode step (batch 4); then the "plain" route's cases
RMS_CASES = [
    (8192, 1024, 0),            # granite-moe (the report case)
    (8192, 1280, 0),            # hubert-xlarge
    (8192, 2048, 0),            # qwen2.5-3b, stablelm-1.6b, mamba2-1.3b
    (8192, 4096, 0),            # mamba2's gated out_norm over d_inner
    (8192, 5120, 0),            # qwen3-14b, llama4-scout
    (8192, 8192, 0),            # command-r-35b, llama-3.2-vision, jamba
    (327680, 128, 0),           # qwen3-14b's q-norm: 8192 tokens x 40 heads
    (4, 5120, 0),               # a qwen3-14b decode step: launch-bound
    (31, 96, 0),                # ragged
    (33, 50, 0),                # rows not whole 16-byte vectors: "plain"
    (8192, 1024, 1),            # x one element off 16-byte alignment: "plain"
]
RMS_REPORT = ((8192, 1024, 0), torch.bfloat16)
# ssd_scan: tests/test_kernels.py's SSD tolerance for f32 (rtol 2e-3, atol
# 2e-4; for gradients atol 2e-4 of the gradient's largest element, since
# da and db sum over whole chunks and over the group's 64 heads), 3e-2
# for bf16 as for flash attention
SSD_TOL = {torch.float32: (2e-3, 2e-4), torch.bfloat16: (3e-2, 3e-2)}
# (label, B, S, H, P, G, N, chunk, |a| scale[, offset]): the training
# path's shape first (mamba2-1.3b at batch 2 x 4096), in both dtypes; the
# others small; the offset, where given, puts every tensor that many
# elements into its storage
SSD_CASES = [
    ("train", 2, 4096, 64, 64, 1, 128, 128, 1.0),
    ("S 100 one partial chunk", 2, 100, 4, 64, 1, 128, 128, 1.0),
    ("S 300 partial last", 2, 300, 4, 64, 1, 128, 128, 1.0),
    ("H 4 G 2", 2, 256, 4, 64, 2, 128, 128, 1.0),
    ("P 48 N 16", 2, 256, 4, 48, 1, 16, 128, 1.0),
    ("chunk == S", 2, 128, 4, 64, 1, 128, 128, 1.0),
    ("large |a|", 2, 512, 4, 64, 1, 128, 128, 40.0),
    # the 128-row tile's edges at the training widths, and a head sum over
    # more than one head per group
    ("S 127", 2, 127, 4, 64, 1, 128, 128, 1.0),
    ("S 128", 2, 128, 4, 64, 1, 128, 128, 1.0),
    ("S 129", 2, 129, 4, 64, 1, 128, 128, 1.0),
    ("H 8 G 2", 2, 512, 8, 64, 2, 128, 128, 1.0),
    # the training shape with P and N off a multiple of 16 (TMA's bounds
    # pad them) and with every tensor one element off 16-byte alignment
    # (2-byte pieces): bf16 takes "tc_edge", timed here although no path
    # launches it; rows in 4- and 8-byte pieces, and rows only 2-byte
    # aligned, at a small shape
    ("train P 56 N 120", 2, 4096, 64, 56, 1, 120, 128, 1.0),
    ("train offset", 2, 4096, 64, 64, 1, 128, 128, 1.0, 1),
    ("P 50 N 100", 2, 300, 4, 50, 1, 100, 128, 1.0),
    ("2-byte rows P 49 N 77", 2, 300, 4, 49, 2, 77, 128, 1.0),
]
SSD_REPORT = ("train", torch.bfloat16)
SSD_TIMED = ("train", "train P 56 N 120", "train offset")
MAMBA = "mamba2-1.3b"
CHECK_GEN = 8        # serve checks: batch 4, prompt 64, then 7 decodes
# Prefill/decode logits (sequential scans with carried state) against a
# full-sequence forward (the ssd_scan kernel), bf16 at full width, as the
# relative L2 norm of the difference. The two sum each scan in another
# order and round y to bf16 apart in a few elements; through 48 layers
# that grows beyond an element-wise 3e-2 on logits of a few units. The
# phase prints the same comparison between two plain routes that differ
# only in their chunk length, the spread bf16 alone gives. A wrong scan
# gives a relative L2 near 1. The bound is the granite serve's
# (LOGIT_REL_L2_TOL).
MAMBA_LOGIT_REL_L2_TOL = 0.15
# the dense family: trained as granite is (full width and depth, the same
# batch, sequence and schedule), and qwen3-14b served at full width
DENSE_TRAIN = ("qwen2.5-3b", "stablelm-1.6b")
DENSE_SERVE = "qwen3-14b"
# the other four architectures: hubert-xlarge trained at full width
# and depth (bidirectional flash at head dim 80), command-r-35b served at
# full width and depth, llama-3.2-vision-90b served at full width with its
# depth cut to one period (4 self-attention layers, 1 gated cross), and
# reduced jamba-1.5-large (an 8-slot period) through all three kernels.
# Other media must move the vision logits by at least MEDIA_MOVE_MIN
# (relative L2).
HUBERT, COMMAND_R, VISION, JAMBA = ("hubert-xlarge", "command-r-35b",
                                    "llama-3.2-vision-90b",
                                    "jamba-1.5-large-398b")
VISION_LAYERS = 5
MEDIA_MOVE_MIN = 1e-3
JAMBA_STEPS, JAMBA_SEQ = 5, 64
# reduced jamba's gradients, card (kernels) vs host (plain), f32: the
# gradient tolerance of tests/test_torch_archs.py against JAX (rtol, and
# a tenth of it times the leaf's largest element as atol); gradient norms
# within the same relative bound
JAMBA_GRAD_RTOL = 2e-3
# checkpoint resume: qwen2.5-3b at full width, its depth cut to 4 layers,
# at the train phase's batch; saved after RESUME_AT of TRAIN_STEPS steps.
# Where two uninterrupted runs differ (an order of additions that varies
# between runs), the resumed losses must lie within their spread: their
# largest relative difference of the uninterrupted run's
RESUME_ARCH, RESUME_LAYERS, RESUME_AT = "qwen2.5-3b", 4, 5

# [dryrun]: launch/dryrun.py's run_cell at mesh (1, 1) with each full-width
# train phase's exact settings predicts its per-device peak; the card's
# torch.cuda.max_memory_allocated() over the phase's steps must lie within
# DRYRUN_MEM_TOL of it (the accounting plus the bytes resident outside the
# step, by name), and the step's own part (the peak less what was live
# when the steps began, in the bytes the tensors asked for) within
# DRYRUN_STEP_TOL of the accounting's. DRYRUN_FLOOR_TFLOP: PERF.md §2's
# floors table, beside the predicted FLOPs a step.
DRYRUN_MEM_TOL = 0.10
DRYRUN_STEP_TOL = 0.001
DRYRUN_FLOOR_TFLOP = {"granite-moe-1b-a400m": 136.0, "mamba2-1.3b": 88.0,
                      "qwen2.5-3b": 225.0, "stablelm-1.6b": 100.0,
                      "hubert-xlarge": 120.0}
# [cp]: qwen3-14b's attention (q heads, kv heads, head dim) at full width,
# split along its keys into as many blocks as the production mesh's model
# axis has ranks, at these sequence lengths (train_4k's, prefill_32k's)
CP_HEADS = (40, 8, 128)
CP_RANKS = 16
CP_SEQS = (4096, 32768)
# [roofline]: the dry-run cells at the production mesh (16, 16) whose
# K/V the model splits along the sequence (40 q and 8 kv heads do not
# divide the 16-way model axis), made on the host by one dry-run process.
# Their prefill: torch 2.11's DTensor cannot propagate placements for the
# training step's embedding gradient (an index_put) on a (16, 16) mesh,
# which torch 2.13 does; train_4k's records come from a newer torch
ROOFLINE_CELLS = (("qwen3-14b", "prefill_32k", "single"),
                  ("llama4-scout-17b-a16e", "prefill_32k", "single"))
# [mesh]: granite trained at full width through DTensors on a one-rank
# NCCL mesh (1, 1) for this many steps, against the same steps on plain
# tensors
MESH_STEPS = 3

ARCH = "granite-moe-1b-a400m"
BATCH, PROMPT, GEN, SEED = 4, 64, 32, 0
# training: train_4k's sequence (repro/configs/base.py:32), its global
# batch of 256 cut to 2 to fit one card and the run's time
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4096, 10, 3e-4
# bf16 in situ, kernel vs plain route: outputs and input gradients
# elementwise (abs + rel); weight gradients, each a sum over the batch's
# 8192 tokens whose bf16 terms round differently on the two routes,
# relative to the gradient's largest element
TRAIN_CHECK_TOL = 3e-2
# training losses, kernel vs plain routes from the same weights and
# batches: bf16 rounding differs between the routes at every step and
# the updates let it grow over 10 steps
TRAIN_TRACK_RTOL = 1e-2
REDUCED_LOSS_RTOL = 1e-4
# the learning run: the training launcher's own schedule (lr 3e-4, warm-up
# 20, cosine to the last step; the defaults of repro_torch/launch/train.py
# and of the JAX launcher) for this many steps at the train phase's batch
LEARN_STEPS, LEARN_LR, LEARN_WARMUP = 100, 3e-4, 20
# Last-token logits, kernel vs einsum route, bf16 at full width, as the
# relative L2 norm of the difference. Where the two routes sum an expert
# product in another order (cuBLAS picks its own), they round 1 ulp apart
# in a few elements (each MoE block is held below at the bf16 kernel
# tolerance); a 1-ulp change flips near-tied top-k choices and capacity
# slots in later layers, and those flips grow through 24 layers. A wrong
# kernel gives a relative L2 near 1 or above.
LOGIT_REL_L2_TOL = 0.15

# [elastic]: the train phase's granite run (full width and depth, the
# same batch, steps and schedule) driven by the port's Supervisor over a
# modelled fleet: 4 hosts, the 32 chips of multi_pod(2, 4, 4) behind the
# (4, 8) mesh, model axis 8; a checkpoint every 4 steps; chips 5 and 6
# fail before step 6; host 3 runs 3x slower than the others from step 5.
# Host 0's step time is the one measured, the others' are modelled from
# it as in the JAX example (equal, the straggler's 3x).
ELASTIC = dict(num_hosts=4, checkpoint_every=4, topology=(2, 4, 4),
               mesh_shape=(4, 8), model_axis_size=8, failure={6: [5, 6]},
               straggler=3, straggler_from=5, slowdown=3.0)


# [sim]: the NANOS simulator's figure grid on sunfire_x4600, as
# benchmarks/bots_repro.py runs it: fft(2^15, cutoff 4), sort(2^15,
# cutoff 4) and strassen medium, SIM_SEEDS Monte-Carlo seeds a cell, the
# thread axis, baseline Nanos ("base": linear binding, spill:K@0, runtime
# data on node 0, migration 0.15) vs the paper's NUMA model ("numa":
# priority binding, spill:K); bf/cilk/wf in both contexts, the study's
# dfwspt/dfwsrpt/dfwshier (with wf) in "numa"; and one straggler and one
# preempt grid of all six schedulers at 16 threads, SIM_FAULT_SEEDS
# seeds. All of it one batch: one launch of the kernel (or a few waves).
SIM_WORKLOADS = ("fft", "sort", "strassen")
SIM_SPILL = {"fft": 2, "sort": 3, "strassen": 2}   # bots_repro.SPILL
SIM_MIGRATION = 0.15
SIM_THREADS = (2, 4, 6, 8, 12, 16)
SIM_SEEDS, SIM_FAULT_SEEDS = 32, 4
SIM_ALLOC = ("bf", "cilk", "wf")
SIM_STUDY = ("dfwspt", "dfwsrpt", "dfwshier")
SIM_FAULTS = ("straggler:0.5", "preempt:2")
# the grid's cells held bit for bit against the plain version on the
# host: every scheduler, both contexts, both fault kinds
# (workload, scheduler, context, threads, seed, faults)
SIM_HELD = (("fft", "bf", "base", 16, 0, "none"),
            ("sort", "cilk", "numa", 8, 1, "none"),
            ("strassen", "wf", "base", 12, 2, "none"),
            ("fft", "dfwspt", "numa", 16, 3, "none"),
            ("sort", "dfwsrpt", "numa", 6, 4, "none"),
            ("strassen", "dfwshier", "numa", 16, 5, "none"),
            ("fft", "wf", "numa", 16, 1, "straggler:0.5"),
            ("strassen", "cilk", "numa", 16, 2, "preempt:2"))
# double operations an event costs at most (the penalty, cost and time
# updates), at the H100's FP64 rate outside the tensor cores (data sheet)
SIM_OPS_PER_STEP = 24
FP64_FLOPS = 34e12
# the launch shape the golden keys run once more at (cells a warp; every
# lane a cell), against kernels/sim.py's CELLS_PER_WARP: the same bits
SIM_GOLDEN_CELLS_A_WARP = 32
# the [sim] grid's kernel ms before sim.cu had its traced and timed
# instantiations (NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6), printed
# beside this run's
SIM_GRID_MS_BEFORE_TRACE = 547.3
# bytes a cell must write once besides the batch's distinct inputs (read
# once, whatever number of cells share them): its per-task state
# (pending and exec_node int32, phase uint8) and its 13 outputs
SIM_STATE_BYTES, SIM_OUT_BYTES = 9, 8 * 13

# [sim_durable]: benchmarks/bots_repro.py's forensics_plan (the traced
# sweep the analysis layer reads), as the port runs it: the scheduler
# study on fft/sort/strassen at [sim]'s scale, the allocation study's
# bf/cilk (both contexts) and wf/base cells at the top thread count, and
# nqueens/floorplan/sparselu medium under bf/cilk/wf in both contexts
DURABLE_STUDY = ("wf", "dfwspt", "dfwsrpt", "dfwshier")
DURABLE_THREADS = (2, 4, 8, 16)
DURABLE_SEEDS = (0, 1)
DURABLE_SMALL = ("nqueens", "floorplan", "sparselu")
DURABLE_SPILL = {"fft": 2, "sort": 3, "strassen": 2, "nqueens": 1,
                 "floorplan": 1, "sparselu": 2}      # bots_repro.SPILL
# the cells whose traces are held against the plain version's, event for
# event: (workload, scheduler, context, threads, seed)
DURABLE_HELD = (("fft", "dfwsrpt", "numa", 8, 1),
                ("strassen", "wf", "base", 16, 0),
                ("nqueens", "cilk", "numa", 16, 1),
                ("sparselu", "bf", "base", 16, 0))
# the paper-scale FFT (bots.make("fft", "paper")) at 16 threads, seed 0,
# and its cell held against the plain version
PAPER_SCHEDS = ("wf", "dfwspt")
PAPER_HELD = ("fft-paper", "wf", "numa", 16, 0)
# the timeout stops the paper-scale cell at this share of its untimed
# kernel time; the medium cells beside it must finish well inside it
PAPER_TIMEOUT_SHARE = 0.1


def elastic_times(step: int, t: float, sched: dict = ELASTIC) -> list[float]:
    """The hosts' step times at ``step`` under ``sched``, host 0's being
    ``t``: the others' equal, the straggler's ``slowdown`` times it from
    ``straggler_from`` on."""
    return [t * (sched["slowdown"] if h == sched["straggler"]
                 and step >= sched["straggler_from"] else 1.0)
            for h in range(sched["num_hosts"])]


def elastic_supervisor(supervisor_cls, topology, run_step, save, restore,
                       remesh, sched: dict = ELASTIC):
    """The Supervisor of ``sched`` (the class and the topology module
    given, so that the host tests build JAX's the same way)."""
    return supervisor_cls(
        num_hosts=sched["num_hosts"],
        checkpoint_every=sched["checkpoint_every"], run_step=run_step,
        save=save, restore=restore, remesh=remesh,
        topo=topology.multi_pod(*sched["topology"]),
        mesh_shape=sched["mesh_shape"],
        model_axis_size=sched["model_axis_size"])


def elastic_stub_run(supervisor_cls, topology, sched: dict = ELASTIC,
                     steps: int = TRAIN_STEPS,
                     times: list[float] | None = None) -> dict:
    """``sched`` over ``steps`` steps with stub callbacks, host 0's step
    time being ``times[k]`` at the k-th executed step (a unit time where
    ``times`` is None or runs out): the events, the executed and the
    saved steps, and each remesh plan's fields."""
    out = dict(executed=[], saved=[], plans=[])

    def run_step(s):
        k = len(out["executed"])
        out["executed"].append(s)
        return elastic_times(
            s, times[k] if times is not None and k < len(times) else 1.0,
            sched)

    def save(s):
        out["saved"].append(s)

    def restore():
        return out["saved"][-1] if out["saved"] else 0

    def remesh(plan):
        out["plans"].append((plan.surviving, plan.mesh_shape, plan.dropped,
                             plan.data_parallel_scale))
    sup = elastic_supervisor(supervisor_cls, topology, run_step, save,
                             restore, remesh, sched)
    out["final"] = sup.run(0, steps, inject_failure=sched["failure"])
    out["events"] = sup.events
    return out


def example_schedule() -> dict:
    """``repro_torch.examples.elastic_failover``'s schedule as an
    ELASTIC-style dict."""
    from repro_torch.examples import elastic_failover as ef
    return dict(num_hosts=ef.NUM_HOSTS, checkpoint_every=ef.CHECKPOINT_EVERY,
                topology=ef.TOPOLOGY, mesh_shape=ef.MESH_SHAPE,
                model_axis_size=ef.MODEL_AXIS, failure=ef.FAILURE,
                straggler=ef.STRAGGLER, straggler_from=ef.STRAGGLER_FROM,
                slowdown=ef.SLOWDOWN)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def graph_ms(fn, arg_sets, reps: int = 3) -> float:
    """Device time of one call: ``fn`` over every argument set, captured
    once in a CUDA graph (no host gaps), replayed; the least of ``reps``
    timed replays over the number of calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for a in arg_sets:                  # warm-up outside the capture
            fn(*a)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for a in arg_sets:
            fn(*a)
    g.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / len(arg_sets))
    return best


def event_ms(fn, reps: int = 5) -> float:
    """Device time of one call by CUDA events around ``reps`` calls after
    a warm-up (for calls that go through autograd, which a graph cannot
    capture here); launch gaps count, so small shapes read high."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def n_sets(set_bytes: float, cap: int = 16) -> int:
    """Argument sets that together exceed the L2 twice (2 at least)."""
    return max(2, min(cap, math.ceil(2 * L2_BYTES / set_bytes)))


def tf32_bound(nbytes: float, ops: float, dtype) -> str:
    """For f32, the bound at the 3xTF32 rate beside the FMA rate's."""
    if dtype != torch.float32:
        return ""
    ms, by = roof(nbytes, ops, TF32X3_FLOPS)
    return f", at the 3xTF32 rate {ms:.4f} ({by}-bound)"


def roof(nbytes: float, ops: float, peak: float):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def close_or_raise(what: str, got, want, tol: float,
                   atol: float | None = None) -> float:
    """max |got - want|, raising unless |got - want| <= atol + tol*|want|
    everywhere (both finite); atol defaults to tol."""
    got, want = got.float(), want.float()
    atol = tol if atol is None else atol
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: bad output {tuple(got.shape)}")
    diff = (got - want).abs()
    if (diff - atol - tol * want.abs()).max().item() > 0:
        raise AssertionError(f"{what}: max |err| {diff.max().item():.3e} "
                             f"beyond tolerance rtol {tol} atol {atol:.3e}")
    return diff.max().item()


def tol_share(got, want, tol: float) -> float:
    """The largest |got - want| / (tol + tol |want|): the share of the
    tolerance the worst element takes (at most 1 where it holds)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def scaled_close_or_raise(what: str, got, want, tol: float) -> float:
    """max |got - want| / max |want|, raising unless it is <= tol."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: bad output {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= tol:
        raise AssertionError(f"{what}: max |err| / max |ref| {rel:.3e} "
                             f"beyond tolerance {tol}")
    return rel


@contextlib.contextmanager
def library_precision():
    """Full f32 in the library calls the [kernels] phases time: TF32 off
    for cuBLAS and for cuDNN (whose default is on), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[kernels] library calls: torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}"
        f" (set; were {saved[0]}, {saved[1]}), float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def route_of(counter: dict, before: dict) -> str:
    """The one route a kernel call launched, from its module's
    ``route_launches`` before and after the call."""
    kinds = [k for k, v in counter.items() if v != before[k]]
    if len(kinds) != 1:
        raise AssertionError(f"a call launched on routes {kinds}")
    return kinds[0]


def expect_route(what: str, got: str, want: str) -> None:
    """A call's route against the wrapper's ``route`` of its shape (f32:
    the 3xTF32 kernels)."""
    if got != want:
        raise AssertionError(f"{what}: launched route {got}, expected "
                             f"{want}")


def at_offset(t, off: int):
    """t's values in a contiguous tensor whose data starts ``off`` elements
    into its storage (off 0: t itself), so that a kernel sees a pointer
    off 16-byte alignment."""
    if not off:
        return t
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


def gmm_exact(x, w, P):
    """moe_gmm's plain arithmetic in float64 on the card: the reference of
    the f32 checks. An f32 sum of the training dw's 2560 unit products
    drifts from the exact one by more than 1e-4 wherever the result is
    small, in the plain version's order too
    (tests/test_torch_tf32_split.py), so f32 holds its 1e-4 against the
    exact result."""
    Z, C, D = x.shape
    return torch.matmul(x.double().view(Z // P, P, C, D),
                        w.double()).view(Z, C, -1)


def kernel_phase(gmm) -> dict:
    log("[kernels] moe_gmm vs its plain version on the card "
        "(tolerance: |k - p| <= tol + tol*|p|, tol f32 1e-4, bf16 3e-2; f32 "
        "against the plain arithmetic in float64, the f32 plain version's "
        "own error beside it)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, Z, C, D, F, P, *off in GMM_CASES:
            off = off[0] if off else 0
            size = torch.tensor([], dtype=dtype).element_size()
            sets = [(at_offset(torch.randn((Z, C, D), generator=g,
                                           device="cuda").to(dtype), off),
                     at_offset((torch.randn((P, D, F), generator=g,
                                            device="cuda")
                                / math.sqrt(D)).to(dtype), off))
                    for _ in range(n_sets((Z * C * D + P * D * F) * size))]
            x, w = sets[0]
            r0 = dict(gmm.route_launches)
            got = gmm.moe_gmm(x, w, P)
            kind = route_of(gmm.route_launches, r0)
            expect_route(f"moe_gmm {label} {dtype}", kind,
                         gmm.route(dtype, C, D, F, off == 0))
            want = gmm.moe_gmm_plain(x, w, P)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            plain_err = ""
            if dtype == torch.float32:
                exact = gmm_exact(x, w, P)
                plain_err = (f" (plain f32 vs float64 "
                             f"{(want - exact).abs().max().item():.3e})")
                want = exact
            err = close_or_raise(f"moe_gmm {label} {dtype}", got, want, tol)
            kern_ms = graph_ms(lambda a, b: gmm.moe_gmm(a, b, P), sets)
            plain_ms = graph_ms(lambda a, b: gmm.moe_gmm_plain(a, b, P), sets)
            if P == Z:
                lib = torch.bmm
            else:
                def lib(a, b, G=Z // P):
                    return torch.matmul(a.view(G, P, C, D), b)
            lib_ms = graph_ms(lib, sets)
            ops = 2.0 * Z * C * D * F
            nbytes = (Z * C * D + P * D * F + Z * C * F) * size
            bound_ms, bound_by = roof(nbytes, ops, PEAK_FLOPS[dtype])
            dt = str(dtype).removeprefix("torch.")
            log(f"[kernels] {label:17s} {dt:8s} x({Z},{C},{D}) "
                f"w({P},{D},{F}): route {kind} max|err| {err:.3e} (tol "
                f"{tol}){plain_err} kernel_ms {kern_ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{bound_ms:.4f} ({bound_by}-bound)"
                f"{tf32_bound(nbytes, ops, dtype)} "
                f"{ops / kern_ms / 1e9:.1f} TFLOP/s, "
                f"kernel/library {kern_ms / lib_ms:.2f}")
            results[(label, dtype)] = dict(
                shape=f"x({Z},{C},{D}) w({P},{D},{F}) {dt}",
                max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
            del sets, x, w, got, want
    return results


def gmm_backward_phase(gmm) -> dict:
    """moe_gmm's backward (dx, dw: two kernel launches that read x, w and
    g as stored) against the plain version's autograd, at the training
    shapes and a grouped ragged one; two runs must give the same bits, and
    a backward in either dtype must launch the two kernels and nothing
    else."""
    log("[kernels] moe_gmm backward (dx, dw) vs the plain version's "
        "autograd (tolerance: tol f32 1e-4, bf16 3e-2, abs + rel; f32 "
        "against the plain arithmetic's autograd in float64, the f32 plain "
        "version's own error beside it); two runs must give the same bits")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, Z, C, D, F, P, *off in GMM_BWD_CASES:
            off = off[0] if off else 0
            x = torch.randn((Z, C, D), generator=g, device="cuda").to(dtype)
            w = (torch.randn((P, D, F), generator=g, device="cuda")
                 / math.sqrt(D)).to(dtype)
            gy = torch.randn((Z, C, F), generator=g, device="cuda").to(dtype)
            x, w, gy = (at_offset(t, off) for t in (x, w, gy))
            r0 = dict(gmm.route_launches)
            dx, dw = gmm.moe_gmm_bwd(x, w, gy, P)
            kind = route_of(gmm.route_launches, r0)
            expect_route(f"moe_gmm bwd {label} {dtype}", kind,
                         gmm.route(dtype, C, D, F, off == 0, backward=True))
            if not all(torch.equal(a, b) for a, b in
                       zip(gmm.moe_gmm_bwd(x, w, gy, P), (dx, dw))):
                raise AssertionError(f"moe_gmm bwd {label} {dtype}: two "
                                     "runs on the same inputs differ")
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            yr = gmm.moe_gmm_plain(xr, wr, P)
            dxr, dwr = torch.autograd.grad(yr, (xr, wr), gy,
                                           retain_graph=True)
            plain_err = ""
            if dtype == torch.float32:
                xe, we = (t.double().requires_grad_() for t in (x, w))
                exact = torch.autograd.grad(gmm_exact(xe, we, P), (xe, we),
                                            gy.double())
                plain_err = (" (plain f32 vs float64 " + ", ".join(
                    f"{n} {(a - b).abs().max().item():.3e}" for n, a, b in
                    zip(("dx", "dw"), (dxr, dwr), exact)) + ")")
                dxr, dwr = exact
                del xe, we
            torch.cuda.synchronize()
            tol = TOL[dtype]
            err = max(close_or_raise(f"moe_gmm dx {label} {dtype}", dx, dxr,
                                     tol),
                      close_or_raise(f"moe_gmm dw {label} {dtype}", dw, dwr,
                                     tol))
            G = Z // P
            kern_ms = event_ms(lambda: gmm.moe_gmm_bwd(x, w, gy, P))
            plain_ms = event_ms(lambda: torch.autograd.grad(
                yr, (xr, wr), gy, retain_graph=True))
            lib_ms = event_ms(lambda: (
                torch.matmul(gy.view(G, P, C, F), w.transpose(1, 2)),
                torch.matmul(x.view(G, P, C, D).transpose(2, 3),
                             gy.view(G, P, C, F)).sum(0)))
            size = x.element_size()
            nbytes = (2 * Z * C * D + 2 * P * D * F + Z * C * F) * size
            ops = 4.0 * Z * C * D * F
            bound_ms, bound_by = roof(nbytes, ops, PEAK_FLOPS[dtype])
            dt = str(dtype).removeprefix("torch.")
            log(f"[kernels] moe_gmm bwd {label:14s} {dt:8s} x({Z},{C},{D}) "
                f"w({P},{D},{F}): route {kind} max|err| {err:.3e} (tol "
                f"{tol}){plain_err} kernel_ms {kern_ms:.4f} plain_ms "
                f"{plain_ms:.4f} "
                f"library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} "
                f"({bound_by}-bound){tf32_bound(nbytes, ops, dtype)} "
                f"{ops / kern_ms / 1e9:.1f} TFLOP/s, kernel/library "
                f"{kern_ms / lib_ms:.2f}")
            results[(label, dtype)] = dict(
                shape=f"dx, dw of x({Z},{C},{D}) w({P},{D},{F}) {dt}",
                max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
            del x, w, gy, dx, dw, xr, wr, yr, dxr, dwr
    for label, dtype in GMM_NO_COPY:
        gmm_backward_copies(gmm, dtype, label)
    return results


def gmm_backward_copies(gmm, dtype, label: str) -> None:
    """One backward at GMM_CASES' shape ``label`` under torch.profiler:
    the two moe_gmm kernels and no other kernel (no transposed copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, Z, C, D, F, P, *_ = next(c for c in GMM_CASES if c[0] == label)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x, gy = (torch.randn(s, generator=g, device="cuda").to(dtype)
             for s in ((Z, C, D), (Z, C, F)))
    w = (torch.randn((P, D, F), generator=g, device="cuda")
         / math.sqrt(D)).to(dtype)
    gmm.moe_gmm_bwd(x, w, gy, P)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gmm.moe_gmm_bwd(x, w, gy, P)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    dt = str(dtype).removeprefix("torch.")
    log(f"[kernels] moe_gmm bwd {label} {dt} x({Z},{C},{D}) w({P},{D},{F}) "
        f"under torch.profiler: "
        f"{len(names)} device operations: {[n[:60] for n in names]}")
    if len(names) != 2 or not all("moe_gmm" in n for n in names):
        raise AssertionError(f"the {dt} moe_gmm backward launched other "
                             f"device work than its two kernels: {names}")


def _mask(Sq, Skv, causal, window, off):
    qpos = torch.arange(Sq, device="cuda")[:, None] + off
    kpos = torch.arange(Skv, device="cuda")[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def sdpa_backend(sdpa, args) -> str:
    """The backend F.scaled_dot_product_attention ran for these inputs,
    from the names of the kernels one call launches under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(*args)
        torch.cuda.synchronize()
    names = " ".join(e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA).lower()
    for key, backend in (("cudnn", "cuDNN"), ("fmha_cutlass", "efficient"),
                         ("flash", "flash")):
        if key in names:
            return backend
    return "math"


def flash_phase(fa) -> dict:
    """flash_attention forward and backward kernels against the plain
    version (attention_ref and its autograd) on the same inputs; times of
    the kernels, the plain version and F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    log("[kernels] flash_attention vs the plain version (tolerance abs + "
        "rel: forward f32 3e-4, bf16 3e-2; dq/dk/dv f32 1e-3, bf16 3e-2); "
        "two backward runs must give the same bits (no atomics)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, Sq, Skv, Hq, Hkv, D, causal, window, off in \
                FLASH_CASES:
            scale = D ** -0.5
            size = torch.tensor([], dtype=dtype).element_size()
            set_bytes = (B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * size
            sets = [tuple(torch.randn(s, generator=g, device="cuda")
                          .to(dtype) for s in ((B, Sq, Hq, D),
                                               (B, Skv, Hkv, D),
                                               (B, Skv, Hkv, D)))
                    for _ in range(n_sets(set_bytes, cap=4))]
            q, k, v = sets[0]
            do = torch.randn((B, Sq, Hq, D), generator=g,
                             device="cuda").to(dtype)
            args = (causal, scale, window, off)
            r0 = dict(fa.route_launches)
            out, lse = fa.flash_attention_fwd(q, k, v, *args)
            dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
            kind = route_of(fa.route_launches, r0)
            expect_route(f"flash {label} {dtype}", kind,
                         fa.route(dtype))
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
            if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
                raise AssertionError(f"flash {label} {dtype}: two backward "
                                     "runs on the same inputs differ")
            del again
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            ref = fa.flash_attention_plain(qr, kr, vr, causal=causal,
                                           window=window, kv_offset=off)
            grads = torch.autograd.grad(ref, (qr, kr, vr), do,
                                        retain_graph=True)
            torch.cuda.synchronize()
            name = f"flash {label} {dtype}"
            f_err = close_or_raise(name, out, ref, FLASH_TOL[dtype])
            b_err = max(close_or_raise(f"{name} d{n}", a, b,
                                       FLASH_GRAD_TOL[dtype])
                        for n, a, b in zip("qkv", (dq, dk, dv), grads))
            shares = (tol_share(out, ref, FLASH_TOL[dtype]),
                      max(tol_share(a, b, FLASH_GRAD_TOL[dtype])
                          for a, b in zip((dq, dk, dv), grads)))
            # library: SDPA in (B, H, S, D), GQA without repeats
            mask = None if (causal and window is None and off == 0
                            and Sq == Skv) or not causal and window is None \
                else _mask(Sq, Skv, causal, window, off)
            is_causal = mask is None and causal

            def sdpa(a, b, c):
                return F.scaled_dot_product_attention(
                    a, b, c, attn_mask=mask, is_causal=is_causal,
                    scale=scale, enable_gqa=True)
            lsets = [tuple(t.transpose(1, 2).contiguous() for t in st)
                     for st in sets]
            backend = sdpa_backend(sdpa, lsets[0])
            fwd_ms = graph_ms(lambda a, b, c: fa.flash_attention_fwd(
                a, b, c, *args), sets)
            fwd_plain = graph_ms(lambda a, b, c: fa.flash_attention_plain(
                a, b, c, causal=causal, window=window, kv_offset=off),
                sets[:2])
            fwd_lib = graph_ms(sdpa, lsets)
            bwd_ms = event_ms(lambda: fa.flash_attention_bwd(
                q, k, v, out, lse, do, *args))
            bwd_plain = event_ms(lambda: torch.autograd.grad(
                ref, (qr, kr, vr), do, retain_graph=True))
            ql, kl, vl = (t.clone().requires_grad_() for t in lsets[0])
            lout = sdpa(ql, kl, vl)
            dol = do.transpose(1, 2).contiguous()
            bwd_lib = event_ms(lambda: torch.autograd.grad(
                lout, (ql, kl, vl), dol, retain_graph=True))
            pairs = int(_mask(Sq, Skv, causal, window, off).sum()) \
                * B * Hq
            io = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * size
            f_ops, b_ops = 4.0 * pairs * D, 10.0 * pairs * D
            f_bytes = io + 4 * B * Hq * Sq
            b_bytes = 2 * io + B * Sq * Hq * D * size + 4 * B * Hq * Sq
            f_bound = roof(f_bytes, f_ops, PEAK_FLOPS[dtype])
            b_bound = roof(b_bytes, b_ops, PEAK_FLOPS[dtype])
            dt = str(dtype).removeprefix("torch.")
            shape = (f"q({B},{Sq},{Hq},{D}) kv({B},{Skv},{Hkv},{D}) {dt} "
                     f"causal={causal} window={window} kv_offset={off}")
            # achieved rate: the operations the bound counts (the visible
            # pairs' products) over the kernel's time
            log(f"[kernels] flash fwd {label:17s} {shape}: route {kind} "
                f"max|err| {f_err:.3e} ({shares[0]:.3f} of the tolerance) "
                f"kernel_ms {fwd_ms:.4f} plain_ms "
                f"{fwd_plain:.4f} library_ms {fwd_lib:.4f} (SDPA "
                f"{backend}) bound_ms {f_bound[0]:.4f} ({f_bound[1]}-bound)"
                f"{tf32_bound(f_bytes, f_ops, dtype)} "
                f"{f_ops / fwd_ms / 1e9:.1f} TFLOP/s, kernel/library "
                f"{fwd_ms / fwd_lib:.2f}")
            log(f"[kernels] flash bwd {label:17s} {shape}: route {kind} "
                f"max|err| {b_err:.3e} ({shares[1]:.3f} of the tolerance) "
                f"kernel_ms {bwd_ms:.4f} plain_ms "
                f"{bwd_plain:.4f} library_ms {bwd_lib:.4f} (library fwd+bwd "
                f"{fwd_lib + bwd_lib:.4f}) bound_ms {b_bound[0]:.4f} "
                f"({b_bound[1]}-bound){tf32_bound(b_bytes, b_ops, dtype)} "
                f"{b_ops / bwd_ms / 1e9:.1f} TFLOP/s, "
                f"kernel/library {bwd_ms / bwd_lib:.2f}")
            results[("fwd", label, dtype)] = dict(
                shape=shape, max_abs_err=f_err, ms=fwd_ms, plain_ms=fwd_plain,
                library_ms=fwd_lib, bound_ms=f_bound[0],
                bound_by=f_bound[1])
            results[("bwd", label, dtype)] = dict(
                shape="dq, dk, dv of " + shape, max_abs_err=b_err, ms=bwd_ms,
                plain_ms=bwd_plain, library_ms=bwd_lib, bound_ms=b_bound[0],
                bound_by=b_bound[1])
            del sets, lsets, q, k, v, do, out, lse, dq, dk, dv, ref, grads
            del qr, kr, vr, ql, kl, vl, lout
            torch.cuda.empty_cache()
    return results


def block_close_or_raise(what: str, got, want, tol: float) -> float:
    """Hold a result at its own scale: |got - want| <= atol + tol |want|
    elementwise with atol = tol * min(1, max |want|) (close_or_raise's
    where the values reach 1, smaller where they do not), and the error's
    RMS within tol of want's RMS, so that a result whose values are small
    everywhere cannot pass by a tolerance larger than they are. Returns
    the RMS ratio."""
    got, want = got.float(), want.float()
    close_or_raise(what, got, want, tol,
                   atol=tol * min(1.0, want.abs().max().item()))
    rel = ((got - want).norm() / want.norm()).item()
    if not rel <= tol:
        raise AssertionError(f"{what}: RMS of the error {rel:.3e} of the "
                             f"reference's, beyond {tol}")
    return rel


def lse_close_or_raise(what: str, got, want, tol: float) -> float:
    """A log-sum-exp: -inf (no key seen) at the same rows as want, and
    within tol absolute elsewhere (an absolute error in lse is the
    relative error of the sum of exponentials). Returns the max error."""
    got, want = got.float(), want.float()
    seen = torch.isfinite(want)
    if not (torch.equal(seen, torch.isfinite(got))
            and bool((got[~seen] == -math.inf).all())):
        raise AssertionError(f"{what}: rows with no key differ from the "
                             "reference's (lse -inf)")
    return close_or_raise(what, got[seen], want[seen], 0.0, atol=tol)


def cp_block_plain(q, kb, vb, off, out, lse, do):
    """One key block of a causal attention split along its keys, plainly
    in f32 with the kernel's scale, one kv head at a time: the block's
    (out_r, lse_r) and its gradients given the merged out and lse, where
    dq_r is the block's share of dq. With P = exp(s - lse) over the
    block's keys and dS = P (dO v^T - rowsum(dO · out)): dq_r = scale
    dS k, dk_r = scale dS^T q, dv_r = P^T dO. Rows before the block's
    first visible key give out 0, lse -inf and dq 0."""
    B, S, Hq, D = q.shape
    L, Hkv = kb.shape[1], kb.shape[2]
    g, scale = Hq // Hkv, D ** -0.5
    first = min(S, max(0, -off))            # the first row that sees a key
    f32 = dict(dtype=torch.float32, device=q.device)
    o_r, dq_r = torch.zeros(q.shape, **f32), torch.zeros(q.shape, **f32)
    lse_r = torch.full((B, Hq, S), -math.inf, **f32)
    dk_r, dv_r = torch.empty(kb.shape, **f32), torch.empty(vb.shape, **f32)
    qpos = torch.arange(first, S, device=q.device)[:, None] + off
    hidden = torch.arange(L, device=q.device)[None, :] > qpos
    for h in range(Hkv):
        hs = slice(h * g, (h + 1) * g)
        qh, doh = q[:, first:, hs].float(), do[:, first:, hs].float()
        kh, vh = kb[:, :, h].float(), vb[:, :, h].float()
        s = torch.einsum("bsgd,bld->bgsl", qh, kh).mul_(scale)
        s.masked_fill_(hidden, -math.inf)
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        seen = den > 0
        o_r[:, first:, hs] = torch.einsum(
            "bgsl,bld->bsgd", p / torch.where(seen, den, 1.0), vh)
        lse_r[:, hs, first:] = torch.where(seen, m + torch.log(den),
                                           -math.inf)[..., 0]
        del p
        p = torch.exp(s - lse[:, hs, first:, None].float())
        del s
        delta = (doh * out[:, first:, hs].float()).sum(-1)     # (B, S', g)
        ds = p * (torch.einsum("bsgd,bld->bgsl", doh, vh)
                  - delta.transpose(1, 2)[..., None])
        dq_r[:, first:, hs] = torch.einsum("bgsl,bld->bsgd", ds, kh) * scale
        dk_r[:, :, h] = torch.einsum("bgsl,bsgd->bld", ds, qh) * scale
        dv_r[:, :, h] = torch.einsum("bgsl,bsgd->bld", p, doh)
        del p, ds
    return o_r, lse_r, dq_r, dk_r, dv_r


CP_PARTS = ("out", "lse", "dq", "dk", "dv")


def cp_block_check(name: str, got, want, dt) -> dict:
    """A block's (out_r, lse_r, dq_r, dk_r, dv_r) from the kernels against
    ``cp_block_plain``'s, each at the block's own scale; part -> error
    (the RMS ratio, for lse the max absolute error)."""
    return {part: (lse_close_or_raise if part == "lse" else
                   block_close_or_raise)(
                f"{name} {part}", a, b,
                FLASH_TOL[dt] if part in ("out", "lse") else
                FLASH_GRAD_TOL[dt])
            for part, a, b in zip(CP_PARTS, got, want)}


def refuses(what: str, check, *args) -> None:
    """Raise unless ``check(*args)`` raises: a planted fault it missed."""
    try:
        check(*args)
    except AssertionError:
        return
    raise AssertionError(f"{what}: the check passed a planted fault")


def cp_phase(fa) -> dict:
    """[cp]: qwen3-14b's attention split along its keys into CP_RANKS
    blocks on one card, as each rank of a 16-way model axis runs its
    block: the flash kernels at each block's kv_offset (negative past the
    first), merged by the model's ``merge_blocks``. Each block's (out_r,
    lse_r) and its backward (with the merged out and lse) are held
    against the block computed plainly in f32 (``cp_block_plain``) at the
    block's own scale, and the check must refuse planted faults in the
    last block (its output zeroed, its lse -inf, its dK/dV zeroed);
    the merged out and lse, the summed dQ and each block's dK/dV are
    held against one flash call over all keys. Then one decode query
    over the blocks of a 32768-position cache through the plain route,
    against the whole-cache plain attention. Returns the per-block
    times."""
    from repro_torch.kernels import ref as kref
    from repro_torch.models.distributed import merge_blocks
    Hq, Hkv, D = CP_HEADS
    n, dt = CP_RANKS, torch.bfloat16
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    log(f"[cp] qwen3-14b attention ({Hq}/{Hkv} heads of {D}, bf16, causal) "
        f"split along its keys into {n} blocks (one a rank of a {n}-way "
        f"model axis), each through the flash kernels at its kv_offset, "
        f"merged by merge_blocks; each block held against itself computed "
        f"plainly in f32, and the merged results against one flash call "
        f"over all keys, at the reference's own scale (|err| <= tol (max "
        f"|ref| + |ref|) and RMS(err) <= tol RMS(ref), tol: forward "
        f"{FLASH_TOL[dt]}, gradients {FLASH_GRAD_TOL[dt]}; lse within "
        f"{FLASH_TOL[dt]} absolute, -inf at the same rows); {card_line()}")
    results = {}
    for S in CP_SEQS:
        L = S // n
        q, do = (torch.randn((1, S, Hq, D), generator=g, device="cuda")
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((1, S, Hkv, D), generator=g, device="cuda")
                .to(dt) for _ in range(2))
        args = (True, scale, None)
        one, one_lse = fa.flash_attention_fwd(q, k, v, *args, 0)
        one_grads = fa.flash_attention_bwd(q, k, v, one, one_lse, do, *args,
                                           0)
        blocks = [(k[:, r * L:(r + 1) * L].contiguous(),
                   v[:, r * L:(r + 1) * L].contiguous(), -r * L)
                  for r in range(n)]
        name = f"[cp] S {S}"
        f0, b0 = fa.fwd_launches, fa.bwd_launches
        parts = [fa.flash_attention_fwd(q, kb, vb, *args, off)
                 for kb, vb, off in blocks]
        outs = torch.stack([o for o, _ in parts])
        lses = torch.stack([l for _, l in parts])
        del parts
        out, lse = merge_blocks(outs, lses)
        dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        dk, dv = [], []
        block_err = dict.fromkeys(CP_PARTS, 0.0)
        for r, (kb, vb, off) in enumerate(blocks):
            grads = fa.flash_attention_bwd(q, kb, vb, out, lse, do, *args,
                                           off)
            got = (outs[r], lses[r], *grads)
            want = cp_block_plain(q, kb, vb, off, out, lse, do)
            at = f"{name} block {r} (kv_offset {off})"
            for part, e in cp_block_check(at, got, want, dt).items():
                block_err[part] = max(block_err[part], e)
            if r == n - 1:
                zero = torch.zeros_like
                refuses(f"{at}, output zeroed", cp_block_check, at,
                        (zero(got[0]), *got[1:]), want, dt)
                refuses(f"{at}, lse -inf (no key seen)", cp_block_check,
                        at, (got[0], torch.full_like(got[1], -math.inf),
                             *got[2:]), want, dt)
                refuses(f"{at}, dK and dV zeroed", cp_block_check, at,
                        (*got[:3], zero(got[3]), zero(got[4])), want, dt)
            del want
            dq += grads[0].float()
            dk.append(grads[1])
            dv.append(grads[2])
        del outs, lses, got, grads
        torch.cuda.synchronize()
        launches = (fa.fwd_launches - f0, fa.bwd_launches - b0)
        if launches != (n, 3 * n):
            raise AssertionError(f"{name}: launches {launches}, "
                                 f"expected ({n}, {3 * n})")
        err = dict(
            out=block_close_or_raise(f"{name} out", out, one, FLASH_TOL[dt]),
            lse=lse_close_or_raise(f"{name} lse", lse, one_lse,
                                   FLASH_TOL[dt]),
            dq=block_close_or_raise(f"{name} dq", dq, one_grads[0],
                                    FLASH_GRAD_TOL[dt]),
            dk=cp_slices_close(f"{name} dk", dk, one_grads[1], dt),
            dv=cp_slices_close(f"{name} dv", dv, one_grads[2], dt))
        del dq, dk, dv
        if S == CP_SEQS[0]:
            err["autograd"] = cp_autograd_check(fa, q, do, blocks, one,
                                                one_grads)
        del one_grads
        fwd = [event_ms(lambda: fa.flash_attention_fwd(q, kb, vb, *args,
                                                       off))
               for kb, vb, off in blocks]
        bwd = [event_ms(lambda: fa.flash_attention_bwd(
            q, kb, vb, out, lse, do, *args, off)) for kb, vb, off in blocks]
        one_fwd = event_ms(lambda: fa.flash_attention_fwd(q, k, v, *args, 0))
        one_bwd = event_ms(lambda: fa.flash_attention_bwd(
            q, k, v, one, one_lse, do, *args, 0))
        log(f"{name}: each block vs itself in f32, worst over the {n} "
            f"blocks: RMS(err)/RMS(ref) out {block_err['out']:.3e} dq "
            f"{block_err['dq']:.3e} dk {block_err['dk']:.3e} dv "
            f"{block_err['dv']:.3e}, max|err| lse {block_err['lse']:.3e}; "
            f"the last block's planted faults (output zeroed, lse -inf, "
            f"dK/dV zeroed) refused")
        log(f"{name}: merged vs one call: RMS(err)/RMS(ref) out "
            f"{err['out']:.3e} dq {err['dq']:.3e} dk {err['dk']:.3e} dv "
            f"{err['dv']:.3e}, max|err| lse {err['lse']:.3e}; launches "
            f"{launches[0]} forward, {launches[1]} backward")
        log(f"{name}: forward ms per block (rank 0 first) "
            f"{[round(t, 4) for t in fwd]}, sum {sum(fwd):.4f}, max "
            f"{max(fwd):.4f}, one call {one_fwd:.4f}; backward ms per block "
            f"{[round(t, 4) for t in bwd]}, sum {sum(bwd):.4f}, max "
            f"{max(bwd):.4f}, one call {one_bwd:.4f} (causal: rank 0's "
            f"block is seen by every row, the last by 1/{n} of them)")
        results[S] = dict(err=err, block_err=block_err, fwd=fwd, bwd=bwd,
                          one_fwd=one_fwd, one_bwd=one_bwd)
        del q, k, v, do, one, one_lse, out, lse, blocks
        torch.cuda.empty_cache()

    # decode (flash-decoding): one query at the cache's last position
    S = CP_SEQS[-1]
    L, pos = S // n, CP_SEQS[-1] - 1
    q = torch.randn((1, 1, Hq, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((1, S, Hkv, D), generator=g, device="cuda").to(dt)
            for _ in range(2))
    parts = [kref.attention_lse_ref(q, k[:, r * L:(r + 1) * L],
                                    v[:, r * L:(r + 1) * L], causal=True,
                                    kv_offset=pos - r * L)
             for r in range(n)]
    out, lse = merge_blocks(torch.stack([o for o, _ in parts]),
                            torch.stack([l for _, l in parts]))
    want, want_lse = kref.attention_lse_ref(q, k, v, causal=True,
                                            kv_offset=pos)
    whole = kref.attention_ref(q, k, v, causal=True, kv_offset=pos)
    torch.cuda.synchronize()
    err = max(block_close_or_raise("[cp] decode out", out, whole,
                                   FLASH_TOL[dt]),
              block_close_or_raise("[cp] decode out (lse route)", out, want,
                                   FLASH_TOL[dt]))
    lse_err = lse_close_or_raise("[cp] decode lse", lse, want_lse,
                                 FLASH_TOL[dt])
    refuses("[cp] decode, the last block zeroed", block_close_or_raise,
            "[cp] decode out", merge_blocks(
                torch.stack([o for o, _ in parts[:-1]]
                            + [torch.zeros_like(parts[-1][0])]),
                torch.stack([l for _, l in parts]))[0], whole, FLASH_TOL[dt])
    log(f"[cp] decode: one query at position {pos} over {n} cache blocks "
        f"of {L} through the plain route, merged, vs the whole-cache plain "
        f"attention: RMS(err)/RMS(ref) out {err:.3e}, max|err| lse "
        f"{lse_err:.3e}; the last block zeroed refused")
    del q, k, v, parts, out, lse, want, want_lse, whole
    torch.cuda.empty_cache()
    return results


def cp_slices_close(what: str, got: list, want, dt) -> float:
    """dK or dV of each key block against its slice of the one call's,
    each at the slice's own scale; the worst RMS ratio."""
    L = got[0].shape[1]
    return max(block_close_or_raise(f"{what} block {r}", g,
                                    want[:, r * L:(r + 1) * L],
                                    FLASH_GRAD_TOL[dt])
               for r, g in enumerate(got))


def cp_autograd_check(fa, q, do, blocks, one, one_grads):
    """The model's kernel route for a key block, ``flash_attention_split``
    (one autograd function: forward kernel, merge, backward kernels with
    the merged out and lse), on each block in turn under autograd, its
    merge taking the other blocks' (out, lse) from the forward kernels'
    results as the other ranks' all-reduces would: every block's output
    against the one call's, dQ summed and each block's dK/dV against its
    gradients at their own scale; launches 1 forward and 3 backward a
    block."""
    from repro_torch.models.distributed import merge_blocks
    parts = [fa.flash_attention_fwd(q, kb, vb, True, q.shape[-1] ** -0.5,
                                    None, off) for kb, vb, off in blocks]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    del parts
    dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    dk, dv, err = [], [], 0.0
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    for r, (kb, vb, off) in enumerate(blocks):
        def merge(o, l, r=r):
            return merge_blocks(
                torch.cat([outs[:r], o[None], outs[r + 1:]]),
                torch.cat([lses[:r], l[None], lses[r + 1:]]))
        ts = [t.clone().requires_grad_() for t in (q, kb, vb)]
        o = fa.flash_attention_split(*ts, merge, causal=True, kv_offset=off)
        a, b, c = torch.autograd.grad(o, ts, do)
        err = max(err, block_close_or_raise(f"[cp] split block {r} out", o,
                                            one, FLASH_TOL[q.dtype]))
        dq += a.float()
        dk.append(b)
        dv.append(c)
    torch.cuda.synchronize()
    n = len(blocks)
    launches = (fa.fwd_launches - f0, fa.bwd_launches - b0)
    if launches != (n, 3 * n):
        raise AssertionError(f"[cp] flash_attention_split: launches "
                             f"{launches}, expected ({n}, {3 * n})")
    err = max(err, block_close_or_raise("[cp] split dq", dq, one_grads[0],
                                        FLASH_GRAD_TOL[q.dtype]),
              cp_slices_close("[cp] split dk", dk, one_grads[1], q.dtype),
              cp_slices_close("[cp] split dv", dv, one_grads[2], q.dtype))
    log(f"[cp] S {q.shape[1]}: flash_attention_split under autograd, block "
        f"by block: worst RMS(err)/RMS(ref) {err:.3e} over outputs and "
        f"gradients; launches {launches[0]} forward, {launches[1]} "
        f"backward")
    return err


def roofline_phase(preds: dict, measured: dict) -> list:
    """[roofline]: each full-width train phase's floor from its [dryrun]
    record (mesh (1, 1)) at the H100's spec-sheet rates beside its
    measured ms/step: a floor above the measured step means the
    accounting is wrong. Then the floors of ROOFLINE_CELLS at (16, 16),
    whose records one dry-run process (``python -m
    repro_torch.launch.dryrun``, placeholder ranks) writes into a
    temporary directory."""
    import tempfile

    from repro_torch.launch import roofline
    lines = []
    log(f"[roofline] floors at spec-sheet rates (989 TFLOP/s bf16, 67 f32, "
        f"3.35 TB/s, NVLink 450 GB/s, network 50 GB/s; accounting, not "
        f"measurement) beside the measured step; {card_line()}")
    for arch, rec in preds.items():
        r = roofline.cell_roofline(rec)
        ms = measured[arch]
        floor = r["floor_s"] * 1e3
        lines.append(
            f"[roofline] {arch} (1,1): compute {r['compute_s']*1e3:.2f} ms "
            f"({rec['cost']['flops_per_device']/1e12:.1f} TFLOP), memory "
            f"{r['memory_s']*1e3:.2f} ms, floor {floor:.2f} ms "
            f"({r['dominant'].removesuffix('_s')}) vs measured "
            f"{ms:.3f} ms/step: floor/measured {floor / ms:.3f}")
        log(lines[-1])
        if floor > ms:
            raise AssertionError(f"[roofline] {arch}: the floor {floor:.2f} "
                                 f"ms exceeds the measured step {ms:.3f} "
                                 "ms: the accounting is wrong")
    (shape, mesh), = {c[1:] for c in ROOFLINE_CELLS}
    art = tempfile.mkdtemp(prefix="roofline-")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent / "src"),
         os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         *(c[0] for c in ROOFLINE_CELLS), "--shape", shape, "--mesh", mesh,
         "--out", art], env=env, capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise AssertionError(f"[roofline] the (16,16) dry run failed: "
                             f"{(done.stdout + done.stderr)[-3000:]}")
    log(f"[roofline] the (16,16) dry-run records in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    rows = roofline.analyze(art=art, out=None, cells=set(ROOFLINE_CELLS))
    shutil.rmtree(art)
    if len(rows) != len(ROOFLINE_CELLS):
        raise AssertionError(f"[roofline] {len(rows)} records of "
                             f"{ROOFLINE_CELLS}")
    for r in rows:
        lines.append(
            f"[roofline] {r['cell']} (16,16): "
            f"{r['flops_per_device']/1e12:.1f} TFLOP/device, compute "
            f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
            f"collectives {r['collective_s']:.4f} s "
            f"({r['cross_host_bytes']/1e9:.1f} of "
            f"{r['collective_bytes']/1e9:.1f} GB across hosts), floor "
            f"{r['floor_s']:.4f} s ({r['dominant'].removesuffix('_s')}), "
            f"peak {r['peak_gib']:.2f} GiB (accounting)")
        log(lines[-1])
    return lines


def rmsnorm_phase(rms) -> dict:
    """The rmsnorm kernel against its plain version at every RMS_CASES
    width, both dtypes, each call's route asserted ("bulk" at the
    architectures' model widths, "vector" at rows of at most 512 bytes:
    the q-norm's D 128 and D 96, "plain" at the odd and the unaligned
    case); library call torch.nn.functional.rms_norm."""
    import torch.nn.functional as F
    log("[kernels] rmsnorm vs its plain version (tolerance abs + rel: "
        "f32 1e-5, bf16 2e-2); share = bound / kernel")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for N, D, off in RMS_CASES:
            size = torch.tensor([], dtype=dtype).element_size()
            sets = [(torch.randn((N * D + off,), generator=g, device="cuda")
                     .to(dtype)[off:].view(N, D),
                     torch.randn((D,), generator=g, device="cuda").to(dtype))
                    for _ in range(n_sets(N * D * size))]
            x, w = sets[0]
            dt = str(dtype).removeprefix("torch.")
            what = f"rmsnorm ({N},{D}) offset {off} {dt}"
            r0 = dict(rms.route_launches)
            got = rms.rmsnorm(x, w, 1e-5)
            kind = route_of(rms.route_launches, r0)
            expect_route(what, kind, "plain" if off or D * size % 16
                         else "vector" if D * size <= 512 else "bulk")
            expect_route(what, kind, rms.route(x, w))
            err = close_or_raise(what, got, rms.rmsnorm_plain(x, w, 1e-5),
                                 RMS_TOL[dtype])
            kern_ms = graph_ms(lambda a, b: rms.rmsnorm(a, b, 1e-5), sets)
            plain_ms = graph_ms(lambda a, b: rms.rmsnorm_plain(a, b, 1e-5),
                                sets)
            lib_ms = graph_ms(lambda a, b: F.rms_norm(a, (D,), b, 1e-5),
                              sets)
            bound_ms, bound_by = roof((2 * N * D + D) * size, 4.0 * N * D,
                                      PEAK_FLOPS[torch.float32])
            log(f"[kernels] rmsnorm ({N},{D}) offset {off} {dt:8s}: route "
                f"{kind} max|err| {err:.3e} kernel_ms {kern_ms:.4f} "
                f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{bound_ms:.4f} ({bound_by}-bound), share "
                f"{bound_ms / kern_ms:.1%}, kernel/library "
                f"{kern_ms / lib_ms:.2f}")
            results[((N, D, off), dtype)] = dict(
                shape=f"x({N},{D}) offset {off} {dt}", max_abs_err=err,
                ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            del sets, x, w, got
    return results


def ssd_work(B, S, H, P, G, N, L, size):
    """(bytes, operations) of one ssd_scan forward and backward: each
    input read once and each output written once; the operations of the
    dual form at the kernel's chunk L, causal triangle only (C B^T and its
    products once per head, the state terms once per chunk)."""
    nc, tri = -(-S // L), L * (L + 1) // 2
    io_in = (B * S * H * P + 2 * B * S * G * N) * size + 4 * B * S * H
    fwd_bytes = io_in + B * S * H * P * size + 4 * B * H * N * P
    bwd_bytes = (2 * io_in + B * S * H * P * size + 4 * B * H * N * P)
    per = B * H * nc
    fwd_ops = per * (2 * tri * (N + P) + 4 * L * N * P)
    bwd_ops = per * (2 * tri * (2 * P + 2 * N) + 8 * L * N * P)
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def ssd_phase(ssd) -> dict:
    """ssd_scan's forward and backward kernels against the plain version
    (ssd_chunked_ref and its autograd, in f32) on the same inputs, and two
    backward runs against each other (the same bits); at the training
    shape also the times of kernels and plain version. No single PyTorch
    call computes the scan: library_ms is null."""
    import torch.nn.functional as F
    log("[kernels] ssd_scan vs the plain version's autograd in f32 "
        "(tolerance |k - p| <= atol + rtol*|p|: f32 rtol 2e-3, atol 2e-4, "
        "bf16 3e-2, 3e-2; gradients atol x max|p|); two backward runs "
        "must give the same bits")
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    results = {}
    for label, B, S, H, P, G, N, chunk, a_scale, *off in SSD_CASES:
        off = off[0] if off else 0
        for dtype in (torch.bfloat16, torch.float32):
            size = torch.tensor([], dtype=dtype).element_size()
            decay = torch.exp(torch.linspace(0.0, math.log(16.0), H,
                                             device="cuda"))

            def draw():
                x = (torch.randn((B, S, H, P), generator=g, device="cuda")
                     * 0.5).to(dtype)
                a = -F.softplus(torch.randn((B, S, H), generator=g,
                                            device="cuda")) * decay * a_scale
                b, c = ((torch.randn((B, S, G, N), generator=g,
                                     device="cuda") * 0.5).to(dtype)
                        for _ in range(2))
                return tuple(at_offset(t, off) for t in (x, a, b, c))
            timed = label in SSD_TIMED
            sets = [draw() for _ in range(2 if timed else 1)]
            x, a, b, c = sets[0]
            kind = ssd.route(x, b, c)
            L = ssd.kernel_rows(chunk, kind)
            gy = at_offset(torch.randn((B, S, H, P), generator=g,
                                       device="cuda").to(dtype), off)
            gh = torch.randn((B, H, N, P), generator=g, device="cuda")
            r0 = dict(ssd.route_launches)
            y, hT, saved = ssd.ssd_scan_fwd(x, a, b, c, chunk, True)
            grads = ssd.ssd_scan_bwd(x, a, b, c, saved, gy, gh, chunk)
            expect_route(f"ssd_scan {label} {dtype}",
                         route_of(ssd.route_launches, r0), kind)
            again = ssd.ssd_scan_bwd(x, a, b, c, saved, gy, gh, chunk)
            rs = [t.float().requires_grad_() for t in (x, a, b, c)]
            ry, rh = ssd.ssd_scan_plain(*rs, chunk=chunk)
            want = torch.autograd.grad((ry, rh), rs, (gy.float(), gh),
                                       retain_graph=True)
            torch.cuda.synchronize()
            rtol, atol = SSD_TOL[dtype]
            dt = str(dtype).removeprefix("torch.")
            shape = (f"x({B},{S},{H},{P}) b,c({B},{S},{G},{N}) {dt} chunk "
                     f"{chunk}{f' offset {off}' if off else ''} ({kind} "
                     f"route, kernel rows {L})")
            name = f"ssd_scan {label} {dt}"
            f_err = max(close_or_raise(f"{name} y", y, ry, rtol, atol),
                        close_or_raise(f"{name} state", hT, rh, rtol, atol))
            b_err = max(close_or_raise(f"{name} d{n}", u, v, rtol,
                                       atol * v.abs().max().item())
                        for n, u, v in zip("xabc", grads, want))
            for n, u, v in zip("xabc", grads, again):
                if not torch.equal(u, v):
                    raise AssertionError(f"{name} d{n}: two backward runs "
                                         f"give different bits")
            fb, fo, bb, bo = ssd_work(B, S, H, P, G, N, L, size)
            f_bound = roof(fb, fo, PEAK_FLOPS[dtype])
            b_bound = roof(bb, bo, PEAK_FLOPS[dtype])
            res = dict(fwd=dict(shape=shape, max_abs_err=f_err,
                                bound_ms=f_bound[0], bound_by=f_bound[1],
                                library_ms=None),
                       bwd=dict(shape="dx, da, db, dc of " + shape,
                                max_abs_err=b_err, bound_ms=b_bound[0],
                                bound_by=b_bound[1], library_ms=None))
            line = (f"[kernels] ssd_scan {label:23s} {shape}: max|err| fwd "
                    f"{f_err:.3e} bwd {b_err:.3e}; bits repeat")
            if timed:
                res["fwd"]["ms"] = graph_ms(
                    lambda *t: ssd.ssd_scan_fwd(*t, chunk, True), sets)
                res["fwd"]["plain_ms"] = graph_ms(
                    lambda *t: ssd.ssd_scan_plain(*t, chunk=chunk), sets)
                res["bwd"]["ms"] = event_ms(lambda: ssd.ssd_scan_bwd(
                    x, a, b, c, saved, gy, gh, chunk))
                res["bwd"]["plain_ms"] = event_ms(
                    lambda: torch.autograd.grad(
                        (ry, rh), rs, (gy.float(), gh), retain_graph=True))
                # the f32 states the forward saves (at every chunk's
                # start: outside the bound, which counts the function's own
                # inputs and outputs); dstates in the backward is as large
                saved_mb = saved[0].numel() * 4 / 1e6
                line += "".join(
                    f"; {k} kernel_ms {r['ms']:.4f} plain_ms "
                    f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
                    f"({r['bound_by']}-bound){tf32_bound(nb, ops, dtype)}, "
                    f"{ops / (r['ms'] * 1e-3) / 1e12:.1f} TFLOP/s"
                    for (k, r), nb, ops in zip(res.items(), (fb, bb),
                                               (fo, bo)))
                line += (f"; outside the bound: states {saved_mb:.1f} MB "
                         f"written by the forward, dstates {saved_mb:.1f} "
                         f"MB written and read by the backward "
                         f"({saved_mb / HBM_BYTES_PER_S * 1e9:.4f} ms each "
                         f"way at the memory rate)")
            log(line)
            results[(label, dtype)] = res
            del sets, x, a, b, c, gy, gh, y, hT, saved, grads, again, rs
            del ry, rh, want
            torch.cuda.empty_cache()
    return results


def decode_breakdown(model_lib, params, cfg, prompts, steps: int = 3,
                     media=None):
    """Where a decode step's time goes: torch.profiler over ``steps``
    steps after the prefill and two warm steps; device kernels by name,
    the device's busy share of the wall time (which the profiler itself
    lengthens), and kernel launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    logits, caches = model_lib.prefill(params, cfg, prompts, media=media,
                                       max_len=PROMPT + steps + 2)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    for _ in range(2):
        logits, caches = model_lib.decode_step(params, cfg, caches, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, caches = model_lib.decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        log("[profile] the profiler saw no device kernels: device busy share "
            "not measured")
        return
    busy, end = 0.0, -math.inf
    for s, t in sorted(spans):              # union of kernel intervals
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    busy_ms = busy / 1e3 / steps
    gmm_ms = sum(v for k, v in by_name.items() if "moe_gmm" in k) / 1e3 \
        / steps
    log(f"[profile] decode step under torch.profiler: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({100*busy_ms/wall_ms:.1f}%), "
        f"{len(spans)/steps:.0f} kernels/step, moe_gmm {gmm_ms:.3f} ms/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        log(f"[profile]   {us/1e3/steps:8.3f} ms/step  {name[:90]}")


def serve_phase(gmm) -> int:
    from repro_torch import configs
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(ARCH), moe_impl="kernel")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k}, "
        f"{nparams/1e9:.3f} B params in {cfg.dtype}, "
        f"init {time.perf_counter()-t0:.1f} s")
    prompts = make_prompts(cfg, BATCH, PROMPT, SEED)
    generate(cfg, params, prompts[:, :8], 2, dev)      # warm-up (cuBLAS)

    gmm.launches = 0
    routed = dict(gmm.route_launches)
    torch.cuda.reset_peak_memory_stats()
    tokens, st = generate(cfg, params, prompts, GEN, dev)
    launches = gmm.launches
    by_route = {k: v - routed[k] for k, v in gmm.route_launches.items()
                if v != routed[k]}
    expected = cfg.num_layers * 3 * GEN
    per_tok = st["decode_s"] / (GEN - 1)
    log(f"[serve] batch={BATCH} prompt={PROMPT} gen={GEN} "
        f"moe_impl=kernel: moe_gmm launches {launches} (expected "
        f"{cfg.num_layers} layers x 3 x {GEN} forwards = {expected}), by "
        f"route {by_route}")
    if not by_route.get("wgmma_decode"):
        raise AssertionError(f"serving's decode steps did not take the "
                             f"wgmma_decode route: {by_route}")
    log(f"[serve] prefill {st['prefill_s']*1e3:.3f} ms "
        f"({BATCH*PROMPT/st['prefill_s']:.1f} tok/s)")
    log(f"[serve] decode {per_tok*1e3:.3f} ms/token "
        f"({BATCH/per_tok:.1f} tok/s)")
    log(f"[serve] peak memory {torch.cuda.max_memory_allocated()/2**30:.3f} "
        "GiB")
    if launches != expected:
        raise AssertionError(f"moe_gmm launched {launches} times, expected "
                             f"{expected}")
    if tokens.shape != (BATCH, GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    if st["length"] != PROMPT + GEN - 1:
        raise AssertionError(f"cache length {st['length']}")
    log(f"[serve] row 0 tokens: {tokens[0].tolist()}")
    decode_breakdown(model_lib, params, cfg, prompts.to(dev))

    # the same prefill through the einsum route: routing and logits; each
    # MoE block's input is captured so its routing can be recomputed
    captured, logits = {}, {}
    for impl in ("kernel", "einsum"):
        cfg_i = dataclasses.replace(cfg, moe_impl=impl)
        handles = [blk.ffn.register_forward_pre_hook(
            lambda mod, args, key=(impl, i): captured.__setitem__(
                key, args[0])) for i, blk in enumerate(params.blocks)]
        try:
            logits[impl], _ = model_lib.prefill(
                params, cfg_i, prompts.to(dev), max_len=PROMPT + GEN)
        finally:
            for h in handles:
                h.remove()
    same_layers, layer_err = 0, 0.0
    cfg_e = dataclasses.replace(cfg, moe_impl="einsum")
    with torch.no_grad():
        for i, blk in enumerate(params.blocks):
            hk, he = captured[("kernel", i)], captured[("einsum", i)]
            rk = blk.ffn.route_groups(hk.reshape(1, -1, cfg.d_model), cfg)
            re_ = blk.ffn.route_groups(he.reshape(1, -1, cfg.d_model), cfg)
            same = torch.equal(rk[0], re_[0]) and torch.equal(rk[1], re_[1])
            if i == 0 and not same:
                raise AssertionError("layer 0 routing differs between the "
                                     "kernel and einsum routes")
            same_layers += int(same)
            # in situ: this layer's MoE input from the kernel run through
            # both routes (same routing), elementwise within bf16 tolerance
            yk, _ = blk.ffn(hk, cfg)
            ye, _ = blk.ffn(hk, cfg_e)
            d = (yk.float() - ye.float()).abs()
            tol = TOL[torch.bfloat16]
            if (d - tol - tol * ye.float().abs()).max().item() > 0:
                raise AssertionError(f"layer {i}: MoE output of the kernel "
                                     "route disagrees with the einsum route")
            layer_err = max(layer_err, d.max().item())
    lk, le = logits["kernel"][:, 0], logits["einsum"][:, 0]
    if not (torch.isfinite(lk).all() and torch.isfinite(le).all()):
        raise AssertionError("non-finite logits")
    err = (lk - le).abs().max().item()
    rel = err / le.abs().max().item()
    rel_l2 = ((lk - le).norm() / le.norm()).item()
    agree = (lk.argmax(-1) == le.argmax(-1)).float().mean().item()
    log(f"[serve] MoE blocks on the same input, kernel vs einsum route: "
        f"max|diff| {layer_err:.4e} over {cfg.num_layers} layers (tol "
        f"{TOL[torch.bfloat16]} abs + rel)")
    log(f"[serve] prefill kernel vs einsum route end to end: layer-0 "
        f"routing identical; identical routing (expert and slot) in "
        f"{same_layers}/{cfg.num_layers} layers; last-token logits "
        f"max|diff| {err:.4e} (max|diff| / max|logit| {rel:.4e}, "
        f"max|logit| {le.abs().max().item():.4e}); relative "
        f"L2 {rel_l2:.4e} (tol {LOGIT_REL_L2_TOL}); argmax agreement "
        f"{agree:.2f}")
    if rel_l2 > LOGIT_REL_L2_TOL:
        raise AssertionError("kernel and einsum logits disagree")
    return launches


@contextlib.contextmanager
def f32_routes(tag: str):
    """Around a float32 phase (``tag`` heads its log line): its flash,
    moe_gmm and ssd_scan launches, logged by route, must all have taken
    the 3xTF32 kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssd_scan as ssd

    def snap():
        return {f"{name} {k}": v for name, mod in (("flash", fa),
                                                   ("moe_gmm", gmm),
                                                   ("ssd_scan", ssd))
                for k, v in mod.route_launches.items()}
    before = snap()
    yield
    got = {k: v - before[k] for k, v in snap().items() if v != before[k]}
    log(f"{tag}: flash, moe_gmm and ssd_scan launches by route: {got}")
    if not got or any(not k.endswith(" tf32x3") for k in got):
        raise AssertionError(f"{tag}: f32 launches off the 3xTF32 route: "
                             f"{got}")


def reduced_phase() -> None:
    """Reduced float32 granite-moe: kernel route on the card against the
    plain route on the host, same weights, same prompts."""
    from repro_torch import configs
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import model as model_lib

    cfg = configs.get(ARCH).reduced()
    host = model_lib.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
    card = copy.deepcopy(host).to("cuda")
    prompts = make_prompts(cfg, 2, 16, SEED)
    cfg_k = dataclasses.replace(cfg, moe_impl="kernel")
    with f32_routes("[reduced]"):
        lk, _ = model_lib.prefill(card, cfg_k, prompts.cuda(), max_len=24)
        tk, _ = generate(cfg_k, card, prompts, 8, "cuda")
    lh, _ = model_lib.prefill(host, cfg, prompts, max_len=24)
    err = (lk.cpu() - lh).abs().max().item()
    th, _ = generate(cfg, host, prompts, 8, "cpu")
    log(f"[reduced] {cfg.name} f32: card kernel route vs host einsum "
        f"route: prefill logits max|diff| {err:.3e} (tol 1e-3); greedy "
        f"tokens identical: {torch.equal(tk, th)}")
    if err > 1e-3 or not torch.equal(tk, th):
        raise AssertionError("reduced model: card and host disagree")


def _counts(gmm, fa, rms) -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    return dict(moe_gmm=gmm.launches, moe_gmm_bwd=gmm.bwd_launches,
                flash_fwd=fa.fwd_launches, flash_bwd=fa.bwd_launches,
                rmsnorm=rms.launches, ssd_fwd=ssd.fwd_launches,
                ssd_bwd=ssd.bwd_launches)


def _reset(gmm, fa, rms) -> None:
    from repro_torch.kernels import ssd_scan as ssd
    gmm.launches = gmm.bwd_launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    rms.launches = 0
    ssd.fwd_launches = ssd.bwd_launches = 0


def train_step_breakdown(step_fn, params, opt_state, batch):
    """One training step under torch.profiler: device busy share, device
    time by kernel family and by the aten op that launched it, kernels
    per step. Returns the new (params, opt_state)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        t0 = time.perf_counter()
        params, opt_state, _, loss, _ = step_fn(params, opt_state, None,
                                                batch)
        float(loss)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        log("[profile] the profiler saw no device kernels: device busy share "
            "not measured")
        return params, opt_state
    busy, end = 0.0, -math.inf
    for s0, t in sorted(spans):
        busy += max(0.0, t - max(s0, end))
        end = max(end, t)
    busy_ms = busy / 1e3
    families = {"moe_gmm kernel": 0.0, "flash kernels": 0.0,
                "SSD kernels": 0.0, "cuBLAS GEMMs": 0.0, "elementwise and other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if "moe_gmm" in low:
            families["moe_gmm kernel"] += us
        elif "flash_" in low:
            families["flash kernels"] += us
        elif "ssd_" in low:
            families["SSD kernels"] += us
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma",
                                    "sm90_")):
            families["cuBLAS GEMMs"] += us
        else:
            families["elementwise and other"] += us
    log(f"[profile] train step under torch.profiler: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({100*busy_ms/wall_ms:.1f}%), "
        f"{len(spans)} kernels/step")
    log("[profile]   by family: " + ", ".join(
        f"{k} {v/1e3:.3f} ms" for k, v in families.items()))
    ops = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            ops.append((dev_us, evt.key, evt.count))
    for us, key, count in sorted(ops, reverse=True)[:8]:
        log(f"[profile]   op {us/1e3:9.3f} ms  {count:6d} calls  {key[:60]}")
    for evt in prof.key_averages():
        if evt.key == "aten::cumsum":       # the routing's capacity fill
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            log(f"[profile]   aten::cumsum: {evt.count} calls, "
                f"{dev_us/1e3:.3f} ms device")
        if evt.key == "aten::bmm":          # the one-hot dispatch einsums
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            flops = getattr(evt, "flops", 0) or 0
            rate = (f"{flops / (dev_us * 1e-6) / 1e12:.1f} TFLOP/s"
                    if dev_us and flops else "rate not measured")
            log(f"[profile]   aten::bmm: {evt.count} calls, {flops/1e12:.3f} "
                f"TFLOP by the profiler's shape count, {dev_us/1e3:.3f} ms "
                f"device, {rate}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   kernel {us/1e3:9.3f} ms  {name[:90]}")
    return params, opt_state


def train_phase(gmm, fa, rms, arch: str = ARCH, tag: str = "train") -> dict:
    """Full-width training through the kernels: 10 steps of
    ``repro_torch.launch.train``'s step function, launch counts per step
    asserted, losses, times, peak memory, one profiled step; then the same
    10 steps from the same weights through the plain routes. granite-moe
    runs flash and moe_gmm; a dense model (an "mlp" slot) flash alone; an
    encoder (hubert) takes the pipeline's frame embeddings (cast to bf16)
    and attends bidirectionally."""
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import pipeline_for_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.models.layers import moe_capacity
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(arch), attn_impl="kernel",
                              moe_impl="kernel", remat="full")
    moe = bool(cfg.moe_num_experts)
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mix = (f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k}" if moe else
           f"FF {cfg.d_ff}")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, {mix}, "
        f"vocab {cfg.vocab_size}{' tied' if cfg.tie_embeddings else ''}"
        f"{', qkv bias' if cfg.qkv_bias else ''}"
        f"{', encoder on frame embeddings' if cfg.embeds_input else ''}; "
        f"{nparams/1e9:.3f} B params "
        f"in {cfg.dtype} (init {time.perf_counter() - t0:.1f} s), "
        f"attn_impl=kernel{', moe_impl=kernel' if moe else ''}, remat=full")
    group = min(cfg.moe_group, tokens)
    log(f"[{tag}] global batch {TRAIN_BATCH} x seq {TRAIN_SEQ} (train_4k's "
        f"seq; its global batch 256 cut to {TRAIN_BATCH} for one card and "
        f"the run's time): {tokens} tokens/step"
        + (f", {tokens // group} MoE groups, capacity "
           f"{moe_capacity(cfg, group)}" if moe else "")
        + f"; lr {TRAIN_LR}, warmup 2, {TRAIN_STEPS} steps")
    steal = train_mod.steal_table_for(cfg, dev)
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    opt_state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
    pipe = pipeline_for_arch(
        cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=SEED)
    batches = [train_mod.to_device(pipe.batch_at(s), dev)
               for s in range(TRAIN_STEPS + 1)]
    held = train_mod.to_device(pipe.batch_at(1000), dev)   # never trained on

    def held_loss():
        with torch.no_grad():
            return float(model_lib.train_loss(params, cfg, held, steal)[0])
    step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, steal)
    L = cfg.num_layers
    per_step = dict(moe_gmm=2 * 3 * L if moe else 0,
                    moe_gmm_bwd=6 * L if moe else 0, flash_fwd=2 * L,
                    flash_bwd=3 * L, rmsnorm=0, ssd_fwd=0, ssd_bwd=0)
    log(f"[{tag}] launches per step the code implies: "
        + (f"moe_gmm 3 x {L} forward + 3 x {L} recompute = "
           f"{per_step['moe_gmm']}, moe_gmm backward 6 x {L} = "
           f"{per_step['moe_gmm_bwd']}; " if moe else "moe_gmm 0 (no MoE "
           "block); ")
        + f"flash forward {L} + {L} recompute = {per_step['flash_fwd']}; "
        f"flash backward 3 x {L} (delta pre-pass, dK/dV, dQ) = "
        f"{per_step['flash_bwd']}; rmsnorm 0 (no layer calls it); ssd_scan "
        "0 (no Mamba2 layer)")

    # on the host, so that the peak below is the step's own
    init_state = {k: v.to("cpu", copy=True)
                  for k, v in params.state_dict().items()}
    held_before = held_loss()
    torch.cuda.synchronize()
    resident = resident_outside_step(params, opt_state, batches[0])
    torch.cuda.reset_peak_memory_stats()
    _reset(gmm, fa, rms)
    losses, times = [], []
    for s in range(TRAIN_STEPS):
        before = _counts(gmm, fa, rms)
        t0 = time.perf_counter()
        params, opt_state, _, loss, gnorm = step_fn(params, opt_state, None,
                                                    batches[s])
        losses.append(float(loss))                  # waits for the device
        times.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in _counts(gmm, fa, rms).items()}
        log(f"[{tag}] step {s + 1:2d} loss {losses[-1]:.4f} gnorm "
            f"{float(gnorm):.3f} {times[-1]*1e3:9.1f} ms  launches {got}")
        if got != per_step:
            raise AssertionError(f"step {s + 1}: launches {got}, expected "
                                 f"{per_step}")
    counts = _counts(gmm, fa, rms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    peaks = step_peaks()
    log(f"[{tag}] loss on a batch never trained on (pipeline step 1000): "
        f"{held_before:.4f} before, {held_loss():.4f} after the "
        f"{TRAIN_STEPS} steps")
    steady = times[2:]
    ms = 1e3 * sum(steady) / len(steady)
    log(f"[{tag}] steps 3-{TRAIN_STEPS}: {ms:.3f} ms/step, "
        f"{tokens / (ms / 1e3):.1f} tokens/s; peak memory {peak:.3f} GiB; "
        f"launches over the run {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    params, opt_state = train_step_breakdown(step_fn, params, opt_state,
                                             batches[TRAIN_STEPS])

    # the same 10 steps from the same weights through the plain routes
    del opt_state
    params.load_state_dict(init_state)
    del init_state
    cfg_plain = dataclasses.replace(cfg, attn_impl="ref", moe_impl="einsum")
    opt_state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
    step_plain = train_mod.build_train_step(cfg_plain, opt_cfg, 1, steal)
    plain = []
    t0 = time.perf_counter()
    for s in range(TRAIN_STEPS):
        params, opt_state, _, loss, _ = step_plain(params, opt_state, None,
                                                   batches[s])
        plain.append(float(loss))
    plain_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    routes = "attn ref, moe einsum" if moe else "attn ref"
    log(f"[{tag}] plain routes ({routes}), same weights and "
        f"batches: {plain_ms:.1f} ms/step; losses "
        f"{['%.4f' % x for x in plain]}; kernel route "
        f"{['%.4f' % x for x in losses]}; relative diff per step "
        f"{['%.1e' % x for x in rel]} (tol {TRAIN_TRACK_RTOL}); step 10 "
        f"{'below' if losses[-1] < losses[0] else 'not below'} step 1 on "
        f"the kernel route, {'below' if plain[-1] < plain[0] else 'not below'}"
        " on the plain route")
    if not all(math.isfinite(x) for x in plain) \
            or max(rel) > TRAIN_TRACK_RTOL:
        raise AssertionError("training through the kernels departs from "
                             "the plain routes")
    del opt_state
    return dict(counts=counts, cfg=cfg, params=params, batch=batches[0],
                losses=losses, plain=plain, ms=ms, peak=peak,
                peaks=peaks, resident=resident)


def _compare(block, names, got, want) -> str:
    """Outputs and input gradients elementwise, weight gradients relative
    to their largest element (see TRAIN_CHECK_TOL); raises on a miss."""
    parts = []
    for i, (n, a, b) in enumerate(zip(names, got, want)):
        what = f"layer 0 {block} {n}"
        if i < 2:
            err = close_or_raise(what, a, b, TRAIN_CHECK_TOL)
            parts.append(f"{n} max|err| {err:.3e} (abs + rel)")
        else:
            rel = scaled_close_or_raise(what, a, b, TRAIN_CHECK_TOL)
            parts.append(f"{n} grad {rel:.3e} of max ({worst_element(a, b)})")
    return ", ".join(parts)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def worst_element(got, want, tol: float = TRAIN_CHECK_TOL) -> str:
    """The element farthest outside |got - want| <= tol + tol*|want|: its
    reference value and its error in bf16 ulps at that value; then the
    largest error in bf16 ulps at the leaf's largest reference value."""
    got, want = got.float().flatten(), want.float().flatten()
    diff = (got - want).abs()
    i = int((diff - tol - tol * want.abs()).argmax())
    w, d = want[i].item(), diff[i].item()
    top, worst = want.abs().max().item(), diff.max().item()
    return (f"worst element: ref {w:.4e}, |err| {d:.4e} = "
            f"{d / bf16_ulp(w):.1f} bf16 ulp, "
            f"{'within' if d <= tol + tol * abs(w) else 'beyond'} abs + rel; "
            f"max|ref| {top:.4e}, max|err| {worst:.4e} = "
            f"{worst / bf16_ulp(top):.2f} bf16 ulp at max|ref|")


def train_check_in_situ(cfg, params, batch) -> None:
    """Layer 0 on the same input, bf16: the attention block through the
    flash kernels against the plain route (bidirectional for an encoder),
    then (granite) the MoE block through moe_gmm against the einsum
    route; outputs and gradients."""
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    blk = params.blocks[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    with torch.no_grad():
        x = model_lib._embed(params, cfg, batch.get("tokens"),
                             batch.get("embeds"))
        hin = layers.rmsnorm(x, blk.ln1, cfg.norm_eps)
    B, S, _ = x.shape
    pos = model_lib._positions(B, S, 0, x.device)
    gy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)

    def run(inputs, weights, fn):
        xi = inputs.detach().clone().requires_grad_()
        y = fn(xi)
        grads = torch.autograd.grad(y, [xi] + weights, gy)
        return [y.detach()] + list(grads)

    names = ["output", "input grad"]
    attn_names = [n for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
                  if hasattr(blk.mix, n)]
    attn_w = [getattr(blk.mix, n) for n in attn_names]
    res = {}
    for impl in ("kernel", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        res[impl] = run(hin, attn_w, lambda xi: blk.mix(
            xi, c, positions=pos, cache=None,
            causal=not cfg.is_encoder)[0])
    log(f"[check] {cfg.name} layer 0 attention ({cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"{'bidirectional' if cfg.is_encoder else 'causal'}), flash kernels vs "
        f"plain route (bf16, tol {TRAIN_CHECK_TOL}): "
        + _compare("attention", names + attn_names, res["kernel"],
                   res["ref"]))
    if blk.ffn_kind != "moe":          # the MLP has no kernel route
        return

    with torch.no_grad():
        h = x + res["kernel"][0]
        hin2 = layers.rmsnorm(h, blk.ln2, cfg.norm_eps)
    moe_w = [blk.ffn.wg, blk.ffn.wu, blk.ffn.wd, blk.ffn.router]
    for impl in ("kernel", "einsum"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        res[impl] = run(hin2, moe_w, lambda xi: blk.ffn(xi, c)[0])
    log("[check] layer 0 MoE, moe_gmm vs einsum route (bf16, tol "
        f"{TRAIN_CHECK_TOL}): "
        + _compare("MoE", names + ["wg", "wu", "wd", "router"],
                   res["kernel"], res["einsum"]))


def train_check_reduced(arch: str = ARCH) -> None:
    """The reduced float32 config of ``arch``: 5 training steps on the
    card (kernel routes) against 5 on the host (plain versions), same
    weights and batches; losses within REDUCED_LOSS_RTOL."""
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import pipeline_for_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(configs.get(arch).reduced(),
                              attn_impl="kernel", moe_impl="kernel")
    host = model_lib.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
    card = copy.deepcopy(host).to("cuda")
    opt_cfg = AdamWConfig(lr_peak=2e-3, warmup_steps=2, total_steps=5)
    pipe = pipeline_for_arch(cfg, ShapeSpec("reduced", 64, 4, "train"),
                             seed=SEED)
    losses = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        step_fn = train_mod.build_train_step(
            cfg, opt_cfg, 1, train_mod.steal_table_for(cfg, dev))
        state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
        out = []
        with (f32_routes(f"[check] reduced {cfg.name}") if dev == "cuda"
              else contextlib.nullcontext()):
            for s in range(5):
                params, state, _, loss, _ = step_fn(
                    params, state, None,
                    train_mod.to_device(pipe.batch_at(s), dev))
                out.append(float(loss))
        losses[dev] = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"[check] reduced {cfg.name} f32, 5 steps: card (kernels) "
        f"{['%.6f' % x for x in losses['cuda']]} vs host (plain) "
        f"{['%.6f' % x for x in losses['cpu']]}: max relative diff "
        f"{rel:.3e} (tol {REDUCED_LOSS_RTOL})")
    if rel > REDUCED_LOSS_RTOL:
        raise AssertionError("reduced training: card and host disagree")


def train_learning_phase() -> None:
    """Full-width granite-moe trained from fresh seed-0 weights through the
    kernels for LEARN_STEPS steps of the launcher's schedule; the loss on
    a batch never trained on must fall. A witness beside the plain-route
    tracking, which a fault shared by both routes would pass."""
    from repro_torch import configs
    from repro_torch.data import PipelineConfig, Prefetcher, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(ARCH), attn_impl="kernel",
                              moe_impl="kernel", remat="full")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    steal = train_mod.steal_table_for(cfg, dev)
    opt_cfg = AdamWConfig(lr_peak=LEARN_LR, warmup_steps=LEARN_WARMUP,
                          total_steps=LEARN_STEPS)
    opt_state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=SEED))
    held = train_mod.to_device(pipe.batch_at(1000), dev)   # never trained on

    def held_loss():
        with torch.no_grad():
            return float(model_lib.train_loss(params, cfg, held, steal)[0])
    step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, steal)
    log(f"[learn] {cfg.name} full width and depth, bf16, kernels, remat "
        f"full; batch {TRAIN_BATCH} x {TRAIN_SEQ}; {LEARN_STEPS} steps at "
        f"lr {LEARN_LR}, warm-up {LEARN_WARMUP}, cosine to step "
        f"{LEARN_STEPS} (the launcher's defaults)")
    before = held_loss()
    losses = []
    it = Prefetcher(pipe.iter_from(0))
    t0 = time.perf_counter()
    try:
        for s in range(LEARN_STEPS):
            params, opt_state, _, loss, gnorm = step_fn(
                params, opt_state, None, train_mod.to_device(next(it), dev))
            losses.append(float(loss))
            if s % 10 == 0 or s == LEARN_STEPS - 1:
                log(f"[learn] step {s + 1:3d} loss {losses[-1]:.4f} gnorm "
                    f"{float(gnorm):.3f}")
    finally:
        it.close()
    ms = 1e3 * (time.perf_counter() - t0) / LEARN_STEPS
    after = held_loss()
    first, last = (sum(losses[:10]) / 10, sum(losses[-10:]) / 10)
    log(f"[learn] loss on a batch never trained on (pipeline step 1000): "
        f"{before:.4f} before, {after:.4f} after; mean batch loss of steps "
        f"1-10 {first:.4f}, of steps {LEARN_STEPS - 9}-{LEARN_STEPS} "
        f"{last:.4f}; {ms:.1f} ms/step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not after < before:
        raise AssertionError("the held-out loss did not fall over "
                             f"{LEARN_STEPS} steps")


def mamba_train_phase(gmm, fa, rms) -> dict:
    """Full-width, full-depth mamba2 training through the ssd_scan
    kernels: 10 steps of ``repro_torch.launch.train``'s step function at
    the granite train phase's batch and schedule, launch counts per step,
    times, peak memory, one profiled step; then the same 10 steps through
    the plain route from the same weights and batches."""
    from repro_torch import configs
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(MAMBA), ssm_impl="kernel",
                              remat="full")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    nparams = sum(p.numel() for p in params.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[mamba] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSM heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, groups "
        f"{cfg.ssm_groups}, vocab {cfg.vocab_size}, {nparams/1e9:.3f} B "
        f"params in {cfg.dtype}, ssm_impl=kernel (chunk {cfg.ssm_chunk}), "
        f"remat=full; batch {TRAIN_BATCH} x {TRAIN_SEQ}, lr {TRAIN_LR}, "
        f"warmup 2, {TRAIN_STEPS} steps")
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    opt_state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=SEED))
    batches = [train_mod.to_device(pipe.batch_at(s), dev)
               for s in range(TRAIN_STEPS + 1)]
    step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, None)
    L = cfg.num_layers
    from repro_torch.kernels import ssd_scan as ssd
    nf, nb = ssd.LAUNCHES["tc"]
    per_step = dict(moe_gmm=0, moe_gmm_bwd=0, flash_fwd=0, flash_bwd=0,
                    rmsnorm=0, ssd_fwd=2 * L * nf, ssd_bwd=L * nb)
    log(f"[mamba] launches per step the code implies: ssd_scan forward "
        f"({L} calls + {L} recomputed) x {nf} launches (C B^T, the walk) = "
        f"{2 * L * nf}; backward {L} calls x {nb} launches (carried state "
        f"gradient, dx and da, dB and dC) = {L * nb}; nothing else")

    # on the host, so that the peak below is the step's own
    init_state = {k: v.to("cpu", copy=True)
                  for k, v in params.state_dict().items()}
    torch.cuda.synchronize()
    resident = resident_outside_step(params, opt_state, batches[0])
    torch.cuda.reset_peak_memory_stats()
    _reset(gmm, fa, rms)
    losses, times = [], []
    for s in range(TRAIN_STEPS):
        before = _counts(gmm, fa, rms)
        t0 = time.perf_counter()
        params, opt_state, _, loss, gnorm = step_fn(params, opt_state, None,
                                                    batches[s])
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in _counts(gmm, fa, rms).items()}
        log(f"[mamba] step {s + 1:2d} loss {losses[-1]:.4f} gnorm "
            f"{float(gnorm):.3f} {times[-1]*1e3:9.1f} ms  launches "
            f"ssd_fwd {got['ssd_fwd']} ssd_bwd {got['ssd_bwd']}")
        if got != per_step:
            raise AssertionError(f"step {s + 1}: launches {got}, expected "
                                 f"{per_step}")
    counts = _counts(gmm, fa, rms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    peaks = step_peaks()
    steady = times[2:]
    ms = 1e3 * sum(steady) / len(steady)
    log(f"[mamba] steps 3-{TRAIN_STEPS}: {ms:.3f} ms/step, "
        f"{tokens / (ms / 1e3):.1f} tokens/s; peak memory {peak:.3f} GiB; "
        f"launches over the run ssd_fwd {counts['ssd_fwd']} ssd_bwd "
        f"{counts['ssd_bwd']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    params, opt_state = train_step_breakdown(step_fn, params, opt_state,
                                             batches[TRAIN_STEPS])

    del opt_state
    params.load_state_dict(init_state)
    del init_state
    cfg_plain = dataclasses.replace(cfg, ssm_impl="ref")
    opt_state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
    step_plain = train_mod.build_train_step(cfg_plain, opt_cfg, 1, None)
    plain = []
    t0 = time.perf_counter()
    for s in range(TRAIN_STEPS):
        params, opt_state, _, loss, _ = step_plain(params, opt_state, None,
                                                   batches[s])
        plain.append(float(loss))
    plain_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    log(f"[mamba] plain route (ssm_impl=ref), same weights and batches: "
        f"{plain_ms:.1f} ms/step; losses {['%.4f' % x for x in plain]}; "
        f"kernel route {['%.4f' % x for x in losses]}; relative diff per "
        f"step {['%.1e' % x for x in rel]} (tol {TRAIN_TRACK_RTOL})")
    if not all(math.isfinite(x) for x in plain) \
            or max(rel) > TRAIN_TRACK_RTOL:
        raise AssertionError("training through ssd_scan departs from the "
                             "plain route")
    del opt_state
    return dict(counts=counts, cfg=cfg, params=params, batch=batches[0],
                peak=peak, peaks=peaks, resident=resident, ms=ms)


def mamba_check_in_situ(cfg, params, batch) -> None:
    """Layer 0's Mamba2 mixer on the same input, bf16: the ssd_scan route
    against the plain route; outputs and gradients."""
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    blk = params.blocks[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    with torch.no_grad():
        x = model_lib._embed(params, cfg, batch["tokens"])
        hin = layers.rmsnorm(x, blk.ln1, cfg.norm_eps)
    gy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    names = ["in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D_skip",
             "out_norm", "out_proj"]
    weights = [getattr(blk.mix, n) for n in names]
    res = {}
    for impl in ("kernel", "ref"):
        c = dataclasses.replace(cfg, ssm_impl=impl)
        xi = hin.detach().clone().requires_grad_()
        y, _ = blk.mix(xi, c)
        res[impl] = [y.detach()] + list(torch.autograd.grad(
            y, [xi] + weights, gy))
    log("[check] layer 0 Mamba2 mixer, ssd_scan vs plain route (bf16, tol "
        f"{TRAIN_CHECK_TOL}): "
        + _compare("mamba", ["output", "input grad"] + names, res["kernel"],
                   res["ref"]))


def mamba_check_reduced() -> None:
    """Reduced float32 mamba2: 5 training steps on the card (ssd_scan
    kernels) against 5 on the host (plain version), same weights and
    batches; losses within REDUCED_LOSS_RTOL."""
    from repro_torch import configs
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(configs.get(MAMBA).reduced(),
                              ssm_impl="kernel")
    host = model_lib.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
    card = copy.deepcopy(host).to("cuda")
    opt_cfg = AdamWConfig(lr_peak=2e-3, warmup_steps=2, total_steps=5)
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=72, global_batch=4,
                                        seed=SEED))
    losses = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, None)
        state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(cfg.pattern))
        out = []
        with (f32_routes(f"[check] reduced {cfg.name}") if dev == "cuda"
              else contextlib.nullcontext()):
            for s in range(5):
                params, state, _, loss, _ = step_fn(
                    params, state, None,
                    train_mod.to_device(pipe.batch_at(s), dev))
                out.append(float(loss))
        losses[dev] = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"[check] reduced {cfg.name} f32 (chunk {cfg.ssm_chunk}, seq 72: a "
        f"partial last chunk), 5 steps: card (ssd_scan) "
        f"{['%.6f' % x for x in losses['cuda']]} vs host (plain) "
        f"{['%.6f' % x for x in losses['cpu']]}: max relative diff "
        f"{rel:.3e} (tol {REDUCED_LOSS_RTOL})")
    if rel > REDUCED_LOSS_RTOL:
        raise AssertionError("reduced mamba2 training: card and host "
                             "disagree")


def mamba_serve_phase() -> None:
    """Full-width mamba2 served on the card (batch 4, prompt 64, gen 8;
    prefill and decode take the plain scans with carried state, as in the
    JAX package): the last prompt logits and each decode step's logits
    against a full-sequence forward (ssd_scan kernel) of the same tokens."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(MAMBA), ssm_impl="kernel")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = make_prompts(cfg, BATCH, PROMPT, SEED).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model_lib.prefill(params, cfg, prompts,
                                       max_len=PROMPT + CHECK_GEN)
    step_logits = [logits[:, -1]]
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(CHECK_GEN - 1):
        logits, caches = model_lib.decode_step(params, cfg, caches, tok)
        step_logits.append(logits[:, -1])
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        toks.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / (CHECK_GEN - 1)
    seq = torch.cat([prompts] + toks[:-1], dim=1)
    with torch.no_grad():
        full, _ = model_lib.forward(params, cfg, seq)
    errs, rels = [], []
    for i, lg in enumerate(step_logits):
        want = full[:, PROMPT - 1 + i]
        if lg.shape != want.shape or not torch.isfinite(lg).all():
            raise AssertionError(f"mamba serve step {i}: bad logits")
        errs.append((lg - want).abs().max().item())
        rels.append(((lg - want).norm() / want.norm()).item())
    agree = (torch.stack(step_logits, 1).argmax(-1)
             == full[:, PROMPT - 1:].argmax(-1)).float().mean().item()
    with torch.no_grad():                  # bf16's own spread: two plain
        spread = [model_lib.forward(params, dataclasses.replace(
            cfg, ssm_impl="ref", ssm_chunk=ch), prompts)[0][:, -1]
            for ch in (16, 64)]
    spread_rel = ((spread[0] - spread[1]).norm() / spread[1].norm()).item()
    spread_max = (spread[0] - spread[1]).abs().max().item()
    log(f"[mamba-serve] {cfg.name} bf16 batch {BATCH} prompt {PROMPT} gen "
        f"{CHECK_GEN}: prefill {t_prefill*1e3:.3f} ms, decode "
        f"{t_decode*1e3:.3f} ms/token; cache length {caches['length']}; "
        f"prefill and decode logits vs a full-sequence forward (ssd_scan): "
        f"relative L2 per position {['%.2e' % e for e in rels]} (tol "
        f"{MAMBA_LOGIT_REL_L2_TOL}), max|diff| {['%.2e' % e for e in errs]} "
        f"(max|logit| {full.abs().max().item():.3f}), argmax agreement "
        f"{agree:.2f}; tokens row 0 {torch.cat(toks, 1)[0].tolist()}")
    log(f"[mamba-serve] bf16's own spread: the prompt's last logits through "
        f"the plain route at chunk 16 vs chunk 64: relative L2 "
        f"{spread_rel:.2e}, max|diff| {spread_max:.2e}")
    if caches["length"] != PROMPT + CHECK_GEN - 1:
        raise AssertionError(f"cache length {caches['length']}")
    if max(rels) > MAMBA_LOGIT_REL_L2_TOL:
        raise AssertionError("mamba2 prefill/decode logits depart from the "
                             "full-sequence forward")


def _describe(cfg, params) -> str:
    nparams = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    kinds = "".join("x" if k == "cross" else "m" if k == "mamba" else "a"
                    for k, _ in cfg.pattern)
    return (f"{cfg.name}: {cfg.num_layers} layers (period {kinds}), d "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}, qk_norm={cfg.qk_norm}, FF {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, tied={cfg.tie_embeddings}"
            + (f", {cfg.num_media_tokens} media tokens"
               if cfg.num_media_tokens else "")
            + f"; {nparams/1e9:.3f} B params, {nbytes/1e9:.2f} GB in "
            f"{cfg.dtype}")


def serve_check_phase(gmm, fa, rms, arch: str, tag: str,
                      layers: int | None = None) -> None:
    """A full-width model in bf16 (depth cut to ``layers`` if given):
    ``generate`` at batch 4, prompt 64, gen 32 with the launch counters
    read around it (serving attends with its cache: no kernel launches),
    a profiled decode step, then prefill and CHECK_GEN decode steps whose
    logits are held against a full-sequence forward of the same tokens.
    A VLM gets media from the launcher's generator and nonzero gates from
    the seed (a zero gate would hide a broken cross layer); other media
    must change its logits, and with zero gates must not."""
    from repro_torch import configs
    from repro_torch.launch.serve import generate, make_media, make_prompts
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()        # the init's own peak
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gates = [b.mix.gate for b in params.blocks if b.kind == "cross"]
    if gates:
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        with torch.no_grad():
            for gate in gates:
                gate.copy_(torch.rand(gate.shape, generator=g, device=dev)
                           + 0.5)
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[{tag}] {_describe(cfg, params)} (init {t_init:.1f} s"
        f", peak {torch.cuda.max_memory_allocated()/2**30:.3f} GiB, "
        f"{held:.3f} GiB of it held before the init)"
        + (f"; cross gates set from the seed: tanh(gate) "
           f"{[round(math.tanh(float(x.detach())), 4) for x in gates]}"
           if gates else ""))
    prompts = make_prompts(cfg, BATCH, PROMPT, SEED)
    media = make_media(cfg, BATCH, SEED)
    media = None if media is None else media.to(dev)
    generate(cfg, params, prompts[:, :8], 2, dev, media=media)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset(gmm, fa, rms)
    tokens, st = generate(cfg, params, prompts, GEN, dev, media=media)
    counts = _counts(gmm, fa, rms)
    per_tok = st["decode_s"] / (GEN - 1)
    log(f"[{tag}] batch={BATCH} prompt={PROMPT} gen={GEN}: prefill "
        f"{st['prefill_s']*1e3:.3f} ms ({BATCH*PROMPT/st['prefill_s']:.1f} "
        f"tok/s), decode {per_tok*1e3:.3f} ms/token ({BATCH/per_tok:.1f} "
        f"tok/s; the weights' read at the memory rate "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB; launches "
        f"{counts}; row 0 tokens {tokens[0].tolist()}")
    if any(counts.values()):               # serving attends with its cache
        raise AssertionError(f"serving launched {counts}")
    if tokens.shape != (BATCH, GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size \
            or st["length"] != PROMPT + GEN - 1:
        raise AssertionError(f"bad generation {tokens.shape} "
                             f"length {st['length']}")
    decode_breakdown(model_lib, params, cfg, prompts.to(dev), media=media)

    prompts = prompts.to(dev)
    logits, caches = model_lib.prefill(params, cfg, prompts, media=media,
                                       max_len=PROMPT + CHECK_GEN)
    step_logits = [logits[:, -1]]
    toks = [logits[:, -1].argmax(dim=-1, keepdim=True)]
    for _ in range(CHECK_GEN - 1):
        logits, caches = model_lib.decode_step(params, cfg, caches, toks[-1])
        step_logits.append(logits[:, -1])
        toks.append(logits[:, -1].argmax(dim=-1, keepdim=True))
    seq = torch.cat([prompts] + toks[:-1], dim=1)
    with torch.no_grad():
        full, _ = model_lib.forward(params, cfg, seq, media=media)
    rels, errs = [], []
    for i, lg in enumerate(step_logits):
        want = full[:, PROMPT - 1 + i]
        if lg.shape != want.shape or not torch.isfinite(lg).all():
            raise AssertionError(f"{cfg.name} serve step {i}: bad logits")
        errs.append((lg - want).abs().max().item())
        rels.append(((lg - want).norm() / want.norm()).item())
    agree = (torch.stack(step_logits, 1).argmax(-1)
             == full[:, PROMPT - 1:].argmax(-1)).float().mean().item()
    log(f"[{tag}] prefill and {CHECK_GEN - 1} decode steps' logits vs "
        f"a full-sequence forward of the same tokens: relative L2 per "
        f"position {['%.2e' % e for e in rels]} (tol {LOGIT_REL_L2_TOL}), "
        f"max|diff| {['%.2e' % e for e in errs]} (max|logit| "
        f"{full.abs().max().item():.3f}), argmax agreement {agree:.2f}")
    if max(rels) > LOGIT_REL_L2_TOL:
        raise AssertionError(f"{cfg.name} prefill/decode logits depart from "
                             "the full-sequence forward")
    del full, caches
    if not gates:
        return
    other = make_media(cfg, BATCH, SEED + 1).to(dev)
    last = {}
    with torch.no_grad():
        for key, m in (("media", media), ("other", other)):
            last[key] = model_lib.prefill(params, cfg, prompts, media=m)[0]
        for gate in gates:
            gate.zero_()
        for key, m in (("media 0", media), ("other 0", other)):
            last[key] = model_lib.prefill(params, cfg, prompts, media=m)[0]
    moved = ((last["media"] - last["other"]).norm()
             / last["media"].norm()).item()
    still = torch.equal(last["media 0"], last["other 0"])
    log(f"[{tag}] other media (seed {SEED + 1}) move the prompt's last "
        f"logits by relative L2 {moved:.3e} (must exceed "
        f"{MEDIA_MOVE_MIN}); with the gates at zero the two media give the "
        f"same logits bit for bit: {still}")
    if not moved > MEDIA_MOVE_MIN or not still:
        raise AssertionError(f"{cfg.name}: the cross layers do not read the "
                             "media through their gates")


def kv_repeat_check(arch: str) -> None:
    """The reduced f32 config on the card: ``kv_repeat=2`` gives the
    logits of ``kv_repeat=1`` (tests/test_models.py:137-146), prefill and
    a decode step included."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_media, make_prompts
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    cfg = configs.get(arch).reduced()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = make_prompts(cfg, 2, 9, SEED).to(dev)
    media = make_media(cfg, 2, SEED)
    media = None if media is None else media.to(dev)
    out = {}
    for rep in (1, 2):
        c = dataclasses.replace(cfg, kv_repeat=rep)
        with torch.no_grad():
            full, _ = model_lib.forward(params, c, prompts, media=media)
        last, caches = model_lib.prefill(params, c, prompts[:, :8],
                                         media=media, max_len=9)
        dec, _ = model_lib.decode_step(params, c, caches, prompts[:, 8:])
        out[rep] = (full, last, dec)
    errs = [(a - b).abs().max().item() for a, b in zip(out[1], out[2])]
    log(f"[check] reduced {cfg.name} f32 on the card, kv_repeat 2 vs 1: "
        f"max|diff| forward {errs[0]:.3e}, prefill {errs[1]:.3e}, decode "
        f"{errs[2]:.3e} (tol 1e-4)")
    for a, b in zip(out[1], out[2]):
        close_or_raise(f"{cfg.name} kv_repeat", a, b, 1e-4)


def jamba_phase(gmm, fa, rms) -> dict:
    """:func:`_jamba_phase`, whose flash and moe_gmm launches must all take
    the 3xTF32 kernels."""
    with f32_routes("[jamba]"):
        return _jamba_phase(gmm, fa, rms)


def _jamba_phase(gmm, fa, rms) -> dict:
    """Reduced jamba-1.5-large (f32; 2 periods of 8 slots: attention, then
    seven Mamba2 mixers, MoE on the odd slots) with attn_impl, ssm_impl
    and moe_impl "kernel" under nested remat: flash, ssd_scan and moe_gmm
    launch in one stack. The card's forward and every gradient on one
    batch against the host's (plain routes); JAMBA_STEPS training steps on
    the card against the same steps on the host, losses and gradient norms
    compared, launch counts per step asserted; prefill and decode
    on the card against a full forward (ample MoE capacity, so that the
    routing does not depend on how tokens are grouped)."""
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import pipeline_for_arch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    plain = dataclasses.replace(configs.get(JAMBA).reduced(), remat="full")
    cfg = dataclasses.replace(plain, attn_impl="kernel", ssm_impl="kernel",
                              moe_impl="kernel")
    host = model_lib.init_params(plain, torch.Generator().manual_seed(SEED),
                                 "cpu")
    card = copy.deepcopy(host).to("cuda")
    # Each slot's layer runs once forward, once in its period's recompute
    # and once in its own; the period's recompute stops at the last slot's
    # input (torch.utils.checkpoint's early stop), so that slot runs twice.
    P, R = len(cfg.pattern), cfg.repeats
    runs = [3] * (P - 1) + [2]

    def calls(pred):
        return R * sum(n for n, slot in zip(runs, cfg.pattern) if pred(slot))

    def layers_of(pred):
        return R * sum(1 for slot in cfg.pattern if pred(slot))
    nf, nb = ssd.LAUNCHES["tf32x3"]         # f32 takes the 3xTF32 kernels
    per_step = dict(
        moe_gmm=3 * calls(lambda s: s[1] == "moe"),
        moe_gmm_bwd=6 * layers_of(lambda s: s[1] == "moe"),
        flash_fwd=calls(lambda s: s[0] == "attn"),
        flash_bwd=3 * layers_of(lambda s: s[0] == "attn"), rmsnorm=0,
        ssd_fwd=nf * calls(lambda s: s[0] == "mamba"),
        ssd_bwd=nb * layers_of(lambda s: s[0] == "mamba"))
    log(f"[jamba] {_describe(cfg, card)}, remat=full (nested: a "
        f"checkpoint per period, one per slot inside it), attn/ssm/moe_impl "
        f"kernel; launches per step the code implies: {per_step} (slot "
        f"runs per step {runs})")

    pipe = pipeline_for_arch(cfg, ShapeSpec("jamba", JAMBA_SEQ, 4, "train"),
                             seed=SEED)
    batches = [pipe.batch_at(s) for s in range(JAMBA_STEPS)]
    with torch.no_grad():
        toks = torch.from_numpy(batches[0]["tokens"])
        lh, _ = model_lib.forward(host, plain, toks)
        lk, _ = model_lib.forward(card, cfg, toks.cuda())
    fwd_err = close_or_raise("jamba forward, card vs host", lk.cpu(), lh,
                             1e-3)
    grad_err = jamba_grad_check(cfg, card, plain, host, batches[0])
    opt_cfg = AdamWConfig(lr_peak=2e-3, warmup_steps=2,
                          total_steps=JAMBA_STEPS)
    losses, gnorms = {}, {}
    _reset(gmm, fa, rms)
    for dev, params, c in (("cuda", card, cfg), ("cpu", host, plain)):
        step_fn = train_mod.build_train_step(
            c, opt_cfg, 1, train_mod.steal_table_for(c, dev))
        state = adamw_init(dict(params.named_parameters()), opt_cfg,
                           period=len(c.pattern))
        out, norms = [], []
        for s in range(JAMBA_STEPS):
            before = _counts(gmm, fa, rms)
            params, state, _, loss, gnorm = step_fn(
                params, state, None, train_mod.to_device(batches[s], dev))
            out.append(float(loss))
            norms.append(float(gnorm))
            got = {k: v - before[k] for k, v in _counts(gmm, fa, rms).items()}
            want = per_step if dev == "cuda" else {k: 0 for k in per_step}
            if got != want:
                raise AssertionError(f"jamba {dev} step {s + 1}: launches "
                                     f"{got}, expected {want}")
        losses[dev], gnorms[dev] = out, norms
    counts = _counts(gmm, fa, rms)

    def worst(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))
    rel = worst(losses["cuda"], losses["cpu"])
    grel = worst(gnorms["cuda"], gnorms["cpu"])
    log(f"[jamba] forward logits card (kernels) vs host (plain) max|diff| "
        f"{fwd_err:.3e} (tol 1e-3); every gradient on the first batch "
        f"{grad_err}; {JAMBA_STEPS} steps at batch 4 x {JAMBA_SEQ}: losses "
        f"card {['%.6f' % x for x in losses['cuda']]} vs host "
        f"{['%.6f' % x for x in losses['cpu']]}: max relative diff "
        f"{rel:.3e} (tol {REDUCED_LOSS_RTOL}); gradient norms card "
        f"{['%.6f' % x for x in gnorms['cuda']]} vs host "
        f"{['%.6f' % x for x in gnorms['cpu']]}: max relative diff "
        f"{grel:.3e} (tol {JAMBA_GRAD_RTOL}); launches over the run "
        f"{counts}")
    if rel > REDUCED_LOSS_RTOL:
        raise AssertionError("reduced jamba training: card and host disagree")
    if grel > JAMBA_GRAD_RTOL:
        raise AssertionError("reduced jamba training: card and host gradient "
                             "norms disagree")

    # prefill and decode on the card against a full forward
    roomy = dataclasses.replace(cfg, capacity_factor=float(
        cfg.moe_num_experts))
    prompts = make_prompts(cfg, 2, 16 + CHECK_GEN, SEED).cuda()
    with torch.no_grad():
        full, _ = model_lib.forward(card, roomy, prompts)
    logits, caches = model_lib.prefill(card, roomy, prompts[:, :16],
                                       max_len=16 + CHECK_GEN)
    errs = [close_or_raise("jamba prefill", logits[:, -1], full[:, 15],
                           3e-3)]
    for i in range(CHECK_GEN - 1):
        logits, caches = model_lib.decode_step(card, roomy, caches,
                                               prompts[:, 16 + i:17 + i])
        errs.append(close_or_raise(f"jamba decode {i}", logits[:, -1],
                                   full[:, 16 + i], 3e-3))
    log(f"[jamba] prefill (16 tokens) and {CHECK_GEN - 1} decode steps on "
        f"the card vs a full forward (kernels): max|diff| "
        f"{['%.2e' % e for e in errs]} (tol 3e-3); cache length "
        f"{caches['length']}")
    return counts


def jamba_grad_check(cfg, card, plain, host, batch) -> str:
    """Loss and every parameter's gradient of the reduced jamba on one
    batch, card (flash, ssd_scan and moe_gmm forward and backward at
    jamba's own shapes, under nested remat) against host (plain routes),
    leaf by leaf: |diff| <= JAMBA_GRAD_RTOL * |ref| + JAMBA_GRAD_RTOL / 10
    * max|ref| (tests/test_torch_archs.py's gradient tolerance against
    JAX). A backward kernel off by a constant factor fails here, where
    AdamW's normalised update would hide it from the losses."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib

    out = {}
    for dev, params, c in (("cuda", card, cfg), ("cpu", host, plain)):
        named = dict(params.named_parameters())
        loss, _ = model_lib.train_loss(
            params, c, train_mod.to_device(batch, dev),
            train_mod.steal_table_for(c, dev))
        grads = torch.autograd.grad(loss, list(named.values()))
        out[dev] = (float(loss.detach()), dict(zip(named, grads)))
    (lk, gk), (lh, gh) = out["cuda"], out["cpu"]
    rel_loss = abs(lk - lh) / abs(lh)
    if rel_loss > REDUCED_LOSS_RTOL:
        raise AssertionError(f"jamba loss card {lk} vs host {lh}")
    worst, worst_name = 0.0, ""
    for name, want in gh.items():
        got = gk[name].cpu()
        scale = want.abs().max().item()
        close_or_raise(f"jamba gradient {name}", got, want, JAMBA_GRAD_RTOL,
                       atol=JAMBA_GRAD_RTOL / 10 * scale)
        rel = ((got - want).abs().max() / scale).item() if scale else 0.0
        if rel >= worst:
            worst, worst_name = rel, name
    return (f"({len(gh)} leaves, loss relative diff {rel_loss:.3e}): largest "
            f"max|diff| / max|ref| {worst:.3e} at {worst_name} (rtol "
            f"{JAMBA_GRAD_RTOL}, atol {JAMBA_GRAD_RTOL / 10} of max|ref|)")


def _flat_bits(tree) -> dict:
    """{path: tensor} of a checkpoint tree, bf16 viewed as int16."""
    from repro_torch.checkpoint.checkpoint import _flatten
    return {k: v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            for k, v in _flatten(tree).items()}


def resume_phase() -> None:
    """Checkpoint and resume at full width (qwen2.5-3b, depth cut to
    RESUME_LAYERS): two uninterrupted TRAIN_STEPS-step runs; then a run
    saved by ``CheckpointManager.save_async`` after RESUME_AT steps, a
    fresh model and state restored by ``restore_latest`` (the JAX
    package's on-disk layout), and the steps after RESUME_AT from there.
    The restored weights and state must equal what was saved bit for
    bit, and the resumed losses the uninterrupted ones (bit for bit where
    two uninterrupted runs agree bit for bit)."""
    import tempfile
    from repro_torch import configs, convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(RESUME_ARCH), attn_impl="kernel",
                              remat="full", num_layers=RESUME_LAYERS)
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=SEED))
    batches = [train_mod.to_device(pipe.batch_at(s), dev)
               for s in range(TRAIN_STEPS)]
    step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, None)

    def fresh():
        p = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        return p, adamw_init(dict(p.named_parameters()), opt_cfg,
                             period=len(cfg.pattern))

    def run(params, state, start, stop):
        out = []
        for s in range(start, stop):
            params, state, _, loss, _ = step_fn(params, state, None,
                                                batches[s])
            out.append(float(loss))
        return params, state, out

    runs = []
    for _ in range(2):
        p, st, losses = run(*fresh(), 0, TRAIN_STEPS)
        runs.append((losses, {k: v.clone() for k, v in p.state_dict().items()}))
        del p, st
    (la, wa), (lb, wb) = runs
    same = la == lb and all(torch.equal(wa[k], wb[k]) for k in wa)
    spread = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    del runs, wb
    nparams = sum(v.numel() for v in wa.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        mgr = CheckpointManager(d)
        p, st, lc = run(*fresh(), 0, RESUME_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = {"params": convert.to_jax(p, cfg, numpy=False),
                "opt": convert.opt_to_jax(st, cfg, numpy=False)}
        mgr.save_async(RESUME_AT, snap)
        t_snap = time.perf_counter() - t0
        mgr.wait()
        t_save = time.perf_counter() - t0
        del p, st
        torch.cuda.empty_cache()
        path = os.path.join(d, f"step_{RESUME_AT:09d}")
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        step, tree = mgr.restore_latest()
        p = convert.from_jax(tree["params"], cfg, dev)
        st = convert.opt_from_jax(tree["opt"], cfg, dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    if step != RESUME_AT:
        raise AssertionError(f"restored step {step}, saved {RESUME_AT}")
    want = _flat_bits(snap)
    for what, got in (("read back", _flat_bits(tree)), (
            "in the model and state", _flat_bits(
                {"params": convert.to_jax(p, cfg, numpy=False),
                 "opt": convert.opt_to_jax(st, cfg, numpy=False)}))):
        if got.keys() != want.keys() or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"the checkpoint {what} differs from what "
                                 "was saved")
    del snap, tree, want
    p, st, rest = run(p, st, RESUME_AT, TRAIN_STEPS)
    lc += rest
    rel = max(abs(c - a) / abs(a) for a, c in zip(la, lc))
    log(f"[resume] {cfg.name} at full width, {cfg.num_layers} layers "
        f"({nparams/1e9:.3f} B params), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps, saved after {RESUME_AT}: checkpoint "
        f"{nbytes/1e9:.3f} GB on disk (params bf16, m and v f32), save "
        f"{t_save:.2f} s ({t_snap:.2f} s on the caller's thread), restore "
        f"into a fresh model and state {t_restore:.2f} s; weights and state "
        f"restored bit for bit")
    log(f"[resume] uninterrupted {['%.6f' % x for x in la]} and "
        f"{['%.6f' % x for x in lb]}: bit for bit {same} (largest relative "
        f"difference {spread:.3e}); resumed {['%.6f' % x for x in lc]}: "
        f"largest relative difference from the first {rel:.3e}")
    if same:
        if lc != la or not all(torch.equal(v, wa[k]) for k, v in
                               p.state_dict().items()):
            raise AssertionError("the resumed run departs from the "
                                 "uninterrupted runs, which agree bit for "
                                 "bit")
    elif not rel <= spread:
        raise AssertionError(f"the resumed run departs from the "
                             f"uninterrupted one by {rel:.3e}, beyond "
                             f"their spread {spread:.3e}")


def _same_bits(what: str, got: dict, want: dict) -> None:
    """Two checkpoint trees' leaves (``_flat_bits``) equal bit for bit."""
    differ = [k for k in want if k not in got
              or not torch.equal(got[k], want[k])]
    if got.keys() != want.keys() or differ:
        raise AssertionError(f"{what}: differs from what was saved in "
                             f"{differ[:8]}")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def elastic_phase(gmm, fa, rms) -> dict:
    """Full-width, full-depth granite through the kernels, driven by the
    port's Supervisor over the modelled fleet of ELASTIC: two
    uninterrupted TRAIN_STEPS-step runs, then the supervised run, whose
    callbacks train a step (host 0's time measured, the others' modelled
    from it), save through ``CheckpointManager.save_sync`` (the JAX
    layout, under TMPDIR), restore through ``restore_latest`` +
    ``from_jax`` / ``opt_from_jax``, and record the remesh plans. Checks:
    (a) the events and executed steps equal those of the stub run fed
    this run's measured step times (the heartbeat monitor's EWMA reads
    them, so a slow step can move the straggler's flagging by a step),
    and the event kinds and executed steps those of the unit-time stub
    run (the failure, its remesh, the restore, the checkpoints, the
    straggler's eviction); (b) every
    executed step's loss, the replays included, the uninterrupted run's
    at that step and (c) the final weights the uninterrupted run's, bit
    for bit where the two uninterrupted runs agree bit for bit, otherwise
    within their spread; (d) the restored tree, weights and state equal
    what was saved, bit for bit; (e) each executed step's launch counts
    those train_phase asserts. Returns the launch counts of the
    supervised run."""
    import tempfile
    from repro_torch import configs, convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import topology
    from repro_torch.data import pipeline_for_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Supervisor

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(ARCH), attn_impl="kernel",
                              moe_impl="kernel", remat="full")
    steal = train_mod.steal_table_for(cfg, dev)
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    pipe = pipeline_for_arch(
        cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=SEED)
    batches = [train_mod.to_device(pipe.batch_at(s), dev)
               for s in range(TRAIN_STEPS)]
    step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, steal)
    L = cfg.num_layers
    per_step = dict(moe_gmm=6 * L, moe_gmm_bwd=6 * L, flash_fwd=2 * L,
                    flash_bwd=3 * L, rmsnorm=0, ssd_fwd=0, ssd_bwd=0)

    def fresh():
        p = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        return p, adamw_init(dict(p.named_parameters()), opt_cfg,
                             period=len(cfg.pattern))

    runs = []
    for _ in range(2):
        p, st = fresh()
        losses = []
        for s in range(TRAIN_STEPS):
            p, st, _, loss, _ = step_fn(p, st, None, batches[s])
            losses.append(float(loss))
        runs.append((losses, {k: v.detach().to("cpu", copy=True)
                              for k, v in p.state_dict().items()}))
        del p, st
    (la, wa), (lb, wb) = runs
    same = la == lb and all(torch.equal(wa[k], wb[k]) for k in wa)
    spread = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    w_spread = {k: float((wa[k].float() - wb[k].float()).abs().max())
                for k in wa}
    del runs, wb
    log(f"[elastic] {cfg.name} at full width and depth ({L} layers), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, lr {TRAIN_LR}, warm-up 2, "
        f"{TRAIN_STEPS} steps; two uninterrupted runs "
        f"{['%.6f' % x for x in la]} and {['%.6f' % x for x in lb]}: bit "
        f"for bit {same} (largest relative difference {spread:.3e})")

    def held(what: str, got: float, want: float) -> float:
        rel = abs(got - want) / abs(want)
        if (got != want) if same else not rel <= spread:
            raise AssertionError(f"[elastic] {what}: {got!r} against the "
                                 f"uninterrupted run's {want!r} (relative "
                                 f"{rel:.3e}, their spread {spread:.3e}, "
                                 f"bit for bit {same})")
        return rel

    state = dict(zip(("params", "opt"), fresh()))
    executed, saves, restores, plans, kept = [], [], [], [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as d:
        mgr = CheckpointManager(d, keep_last=1)

        def run_step(s):
            before = _counts(gmm, fa, rms)
            t0 = time.perf_counter()
            state["params"], state["opt"], _, loss, _ = step_fn(
                state["params"], state["opt"], None, batches[s])
            loss = float(loss)                  # waits for the device
            t = time.perf_counter() - t0
            got = {k: v - before[k] for k, v in _counts(gmm, fa, rms).items()}
            executed.append((s, loss, t))
            log(f"[elastic] step {s} loss {loss:.6f} {t * 1e3:.1f} ms  "
                f"launches {got}")
            if got != per_step:
                raise AssertionError(f"[elastic] step {s}: launches {got}, "
                                     f"expected {per_step}")
            return elastic_times(s, t)

        def save(s):
            kept.clear()                        # only the latest is read
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = {"params": convert.to_jax(state["params"], cfg,
                                             numpy=False),
                    "opt": convert.opt_to_jax(state["opt"], cfg,
                                              numpy=False)}
            t_snap = time.perf_counter() - t0
            mgr.save_sync(s, snap)
            t_all = time.perf_counter() - t0
            nbytes = _dir_bytes(os.path.join(d, f"step_{s:09d}"))
            kept[s] = _flat_bits(snap)
            saves.append((s, nbytes, t_snap, t_all))
            log(f"[elastic] checkpoint at step {s}: {nbytes / 1e9:.3f} GB in "
                f"{t_all:.2f} s ({t_snap:.2f} s to the host, "
                f"{nbytes / 1e9 / (t_all - t_snap):.2f} GB/s written)")

        def restore():
            del state["params"], state["opt"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, tree = mgr.restore_latest()
            t_read = time.perf_counter() - t0
            _same_bits("[elastic] the checkpoint read back", _flat_bits(tree),
                       kept[step])
            t1 = time.perf_counter()
            state["params"] = convert.from_jax(tree["params"], cfg, dev)
            state["opt"] = convert.opt_from_jax(tree["opt"], cfg, dev)
            torch.cuda.synchronize()
            t_all = t_read + time.perf_counter() - t1
            del tree
            _same_bits("[elastic] the restored weights and state",
                       _flat_bits({"params": convert.to_jax(
                           state["params"], cfg, numpy=False),
                           "opt": convert.opt_to_jax(state["opt"], cfg,
                                                     numpy=False)}),
                       kept[step])
            restores.append((step, t_read, t_all))
            log(f"[elastic] restored step {step} in {t_all:.2f} s ("
                f"{t_read:.2f} s reading the checkpoint); weights and state "
                "equal what was saved bit for bit")
            return step

        def remesh(plan):
            plans.append(plan)
            log(f"[elastic] remesh plan: mesh {plan.mesh_shape}, surviving "
                f"{list(plan.surviving)}, dropped {len(plan.dropped)}, data "
                f"parallel scale {plan.data_parallel_scale}")

        sup = elastic_supervisor(Supervisor, topology, run_step, save,
                                 restore, remesh)
        _reset(gmm, fa, rms)
        t0 = time.perf_counter()
        final = sup.run(0, TRAIN_STEPS, inject_failure=ELASTIC["failure"])
        t_run = time.perf_counter() - t0
        counts = _counts(gmm, fa, rms)
        weights = {k: v.detach().to("cpu", copy=True)
                   for k, v in state["params"].state_dict().items()}
        del state
    steps = [s for s, _, _ in executed]
    stub = elastic_stub_run(Supervisor, topology,
                            times=[t for _, _, t in executed])
    unit = elastic_stub_run(Supervisor, topology)
    log(f"[elastic] events {sup.events}")
    if sup.events != stub["events"] or final != stub["final"] \
            or steps != stub["executed"]:
        raise AssertionError(f"[elastic] events {sup.events}, executed "
                             f"{steps}, against the stub run's on the same "
                             f"step times {stub['events']}, "
                             f"{stub['executed']}")
    if sorted(e for _, e in sup.events) != sorted(
            e for _, e in unit["events"]) or steps != unit["executed"]:
        raise AssertionError(f"[elastic] events {sup.events}, executed "
                             f"{steps}: not the event kinds and steps of "
                             f"the unit-time stub run {unit['events']}, "
                             f"{unit['executed']}")
    if [(p.surviving, p.mesh_shape, p.dropped, p.data_parallel_scale)
            for p in plans] != stub["plans"]:
        raise AssertionError("[elastic] the remesh plans differ from the "
                             "stub run's")
    rels = [held(f"step {s}'s loss", loss, la[s]) for s, loss, _ in executed]
    differ = [k for k in wa if not torch.equal(weights[k], wa[k])]
    beyond = [k for k in differ if same or float(
        (weights[k].float() - wa[k].float()).abs().max()) > w_spread[k]]
    if beyond:
        raise AssertionError(f"[elastic] final weights differ from the "
                             f"uninterrupted run's in {beyond[:8]} (bit "
                             f"for bit {same}; beyond the two runs' "
                             "largest difference)")
    seen, replayed = set(), []
    for s, _, t in executed:
        if s in seen:
            replayed.append((s, t))
        seen.add(s)
    t_replay = sum(t for _, t in replayed)
    log(f"[elastic] stub run's events equal; executed steps "
        f"{steps}, replayed {[s for s, _ in replayed]} "
        f"({len(replayed)} steps, {t_replay:.2f} s of step time); every "
        f"executed loss equals the uninterrupted run's "
        f"({'bit for bit' if same else 'within their spread'}; largest "
        f"relative difference {max(rels):.3e}); final weights "
        f"{'equal bit for bit' if not differ else f'{len(differ)} leaves differ (allowed: the uninterrupted runs differ)'}; "
        f"supervised run {t_run:.1f} s; launches {counts}")
    return dict(counts=counts, saves=saves, restores=restores,
                replayed=replayed, t_run=t_run)


class _Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def examples_phase() -> dict:
    """Each of the port's four examples as shipped, on the card (their
    own default device), with what it prints or returns checked:
    elastic_failover's events equal the stub run of its schedule;
    train_lm's phase 2 resumes from phase 1's checkpoint (under TMPDIR)
    and ends on a finite loss; serve_batch prints three architectures'
    prefill and decode; quickstart's NUMA-aware context beats the
    baseline in its simulator steps and its stealing lowers the drop
    fraction.
    Returns each example's seconds."""
    import contextlib
    import tempfile
    from repro_torch.core import topology
    from repro_torch.examples import (elastic_failover, quickstart,
                                      serve_batch, train_lm)
    from repro_torch.runtime import Supervisor

    times = {}

    def run(name, fn, *args):
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            out = fn(*args)
        times[name] = time.perf_counter() - t0
        return out, tee.text()

    (events, losses), _ = run("elastic_failover", elastic_failover.main, [])
    sched = example_schedule()
    stub = elastic_stub_run(Supervisor, topology, sched,
                            elastic_failover.STEPS)
    if events != stub["events"] or len(losses) != len(stub["executed"]) \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[examples] elastic_failover: events {events} "
                             f"against the stub run's {stub['events']}; "
                             f"{len(losses)} losses")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as d:
        loss, text = run("train_lm", train_lm.main, ["--checkpoint-dir", d])
    if "[train] resumed from step 20" not in text \
            or not math.isfinite(loss):
        raise AssertionError(f"[examples] train_lm: phase 2 did not resume "
                             f"from phase 1's step 20, or its loss {loss} "
                             "is not finite")
    tokens, text = run("serve_batch", serve_batch.main, [])
    if list(tokens) != list(serve_batch.ARCHS) \
            or text.count("[serve] prefill") != 3 \
            or text.count("[serve] decode") != 3:
        raise AssertionError("[examples] serve_batch did not serve its "
                             "three architectures")
    got, _ = run("quickstart", quickstart.main, [])
    if not got["drop_stealing"] < got["drop_vanilla"] \
            or not math.isfinite(got["loss"]) \
            or not got["sim"]["numa"] > got["sim"]["baseline"]:
        raise AssertionError(f"[examples] quickstart: {got}")
    log(f"[examples] elastic_failover events equal the stub run's "
        f"({len(events)} events, {len(losses)} executed steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}); train_lm resumed at step "
        f"20, final loss {loss:.4f}; serve_batch served "
        f"{', '.join(serve_batch.ARCHS)}; quickstart FFT@16 speedup "
        f"{got['sim']['baseline']:.2f}x -> {got['sim']['numa']:.2f}x "
        f"NUMA-aware (simulator kernel), drop "
        f"{got['drop_vanilla']:.4f} -> {got['drop_stealing']:.4f} with "
        f"stealing, loss {got['loss']:.4f}; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return times


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def resident_outside_step(params, opt_state, batch) -> dict:
    """What is allocated on the card when a train phase's steps start,
    split into the step's own arguments (the weights, the AdamW state and
    the step's batch, which the dry run accounts) and the rest: the
    phase's other batches and what earlier phases still hold (cuBLAS
    workspaces among them). ``requested`` is the bytes the live tensors
    asked for; ``total`` counts the allocator's blocks, which may be
    larger (a cached block is handed out whole when what is left of it
    would be small)."""
    args = (sum(p.numel() * p.element_size() for p in params.parameters())
            + _tree_bytes(opt_state["m"]) + _tree_bytes(opt_state["v"])
            + _tree_bytes(batch))
    total = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    return dict(total=total, args=args, other=total - args,
                requested=requested)


def step_peaks() -> dict:
    """The card's peaks since the last reset: allocator blocks
    (``max_memory_allocated``) and the bytes the tensors asked for."""
    return dict(allocated=torch.cuda.max_memory_allocated(),
                requested=torch.cuda.memory_stats()[
                    "requested_bytes.all.peak"])


def dryrun_phase() -> dict:
    """launch/dryrun.py's run_cell on the host (placeholder rank, meta
    tensors) for each full-width train phase at mesh (1, 1) with its exact
    settings: batch 2 x 4096 with the dtypes of the pipeline's batches
    (f32 frame embeddings for hubert), one microbatch, remat full, AdamW
    (f32 moments), bf16, the kernel routes. Returns arch -> record."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import pipeline_for_arch
    from repro_torch.launch import dryrun

    out = tempfile.mkdtemp(prefix="dryrun-")
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    preds = {}
    for arch in (ARCH, MAMBA, *DENSE_TRAIN, HUBERT):
        t0 = time.perf_counter()
        over = dict(ssm_impl="kernel") if arch == MAMBA else \
            dict(attn_impl="kernel", moe_impl="kernel")
        pipe = pipeline_for_arch(configs.get(arch), ShapeSpec(
            "train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=SEED)
        dtypes = {k: torch.from_numpy(v[:1]).dtype
                  for k, v in pipe.batch_at(0).items()}
        rec = dryrun.run_cell(arch, "train_4k", "single", skip_existing=False,
                              verbose=False, out_dir=out, shape_spec=shape,
                              mesh_shape=(1, 1), micro_override=1,
                              cfg_overrides=over, batch_dtypes=dtypes,
                              variant="card")
        mem = rec["memory"]
        preds[arch] = rec
        log(f"[dryrun] {arch}: predicted per-device peak "
            f"{mem['peak_bytes']/2**30:.3f} GiB = arguments "
            f"{mem['argument_bytes']/2**30:.3f} (weights, AdamW state, "
            f"batch) + step {mem['temp_bytes']/2**30:.3f}; FLOPs a step "
            f"{rec['cost']['flops_per_device']/1e12:.1f} T (PERF.md floors "
            f"table: ~{DRYRUN_FLOOR_TFLOP[arch]:.0f} T); accounting on the "
            f"host in {time.perf_counter() - t0:.1f} s, not a measurement")
    dist.destroy_process_group()
    return preds


def dryrun_check(arch: str, rec: dict, peaks: dict, resident: dict) -> str:
    """Hold a train phase's measured memory against the dry run's
    accounting: the step's arguments byte for byte; the step's own part
    (the peak less what was live when the steps began) in the bytes the
    tensors asked for within DRYRUN_STEP_TOL; the whole peak, the bytes
    resident outside the step added, within DRYRUN_MEM_TOL. The step's
    part in allocator blocks is printed beside it: the difference is the
    caching allocator's block rounding, which the accounting (512-byte
    blocks) does not model."""
    mem = rec["memory"]
    meas = peaks["allocated"]
    pred = mem["peak_bytes"] + resident["other"]
    rel = (meas - pred) / pred
    step = peaks["requested"] - resident["requested"]
    step_rel = (step - mem["temp_bytes"]) / mem["temp_bytes"]
    blocks = meas - resident["total"]
    line = (f"[dryrun] {arch}: max_memory_allocated {meas/2**30:.3f} GiB vs "
            f"predicted {pred/2**30:.3f} GiB = dry run "
            f"{mem['peak_bytes']/2**30:.3f} + resident outside the "
            f"step {resident['other']/2**30:.3f} (the phase's other batches "
            "and earlier phases' tensors), off by "
            f"{100*rel:+.2f}% (tol {100*DRYRUN_MEM_TOL:.0f}%); arguments "
            f"{mem['argument_bytes']} B in the dry run, {resident['args']} B "
            f"on the card; the step's own part {step} B requested vs "
            f"{mem['temp_bytes']} B predicted, off by {100*step_rel:+.4f}% "
            f"(tol {100*DRYRUN_STEP_TOL:.1f}%); in allocator blocks "
            f"{blocks} B ({blocks - step:+d} B of block rounding)")
    log(line)
    if mem["argument_bytes"] != resident["args"]:
        raise AssertionError(f"{arch}: the dry run's arguments are "
                             f"{mem['argument_bytes']} B, the card's "
                             f"{resident['args']} B")
    if abs(step_rel) > DRYRUN_STEP_TOL:
        raise AssertionError(f"{arch}: the dry run's step part is off by "
                             f"{100*step_rel:+.4f}%")
    if abs(rel) > DRYRUN_MEM_TOL:
        raise AssertionError(f"{arch}: the dry run's peak is off by "
                             f"{100*rel:+.2f}%")
    return line


def mesh_save(params, cfg) -> dict:
    """The DTensor model's weights through ``convert.to_jax``'s DTensor
    path and ``save`` under TMPDIR, then ``restore`` into plain CPU
    tensors: the restored tree, its entries (every one must be "full"),
    bytes and times."""
    import json
    import tempfile
    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager, restore

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(d).save_sync(MESH_STEPS, {
            "params": convert.to_jax(params, cfg, numpy=False)})
        save_s = time.perf_counter() - t0
        path = os.path.join(d, f"step_{MESH_STEPS:09d}")
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)["arrays"]
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        tree = restore(d, MESH_STEPS)
        restore_s = time.perf_counter() - t0
    if not all("full" in m for m in index.values()):
        raise AssertionError("[mesh] a one-device mesh's leaf was saved by "
                             "blocks")
    return dict(tree=tree, entries=len(index), bytes=nbytes, save_s=save_s,
                restore_s=restore_s)


def mesh_phase(gmm, fa, rms) -> dict:
    """Full-width granite through DTensors: a one-rank NCCL world, the
    production mesh's counterpart at (1, 1), every leaf placed by the role
    rules (all Replicate: fit_spec drops size-1 axes), MESH_STEPS steps of
    the dry run's train step through flash and moe_gmm with the mesh's
    steal table, launch counts asserted per step; then the same steps on
    plain tensors from the same weights: losses and weights must be equal
    bit for bit."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs, convert
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import pipeline_for_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_production_mesh, \
        mesh_steal_table
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_production_mesh(shape=(1, 1), device_type="cuda")
        shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        cfg = dataclasses.replace(
            dryrun.adapt_config(configs.get(ARCH), shape, mesh, micro=1),
            attn_impl="kernel", moe_impl="kernel")
        steal = torch.as_tensor(mesh_steal_table(
            mesh, cfg.moe_num_experts, cfg.moe_steal_policy), device=dev)
        opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2,
                              total_steps=TRAIN_STEPS)
        pipe = pipeline_for_arch(cfg, shape, seed=SEED)
        batches = [train_mod.to_device(pipe.batch_at(s), dev)
                   for s in range(MESH_STEPS)]
        L = cfg.num_layers
        per_step = dict(moe_gmm=6 * L, moe_gmm_bwd=6 * L, flash_fwd=2 * L,
                        flash_bwd=3 * L, rmsnorm=0, ssd_fwd=0, ssd_bwd=0)

        def run(placed: bool):
            params = model_lib.init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            specs = shd.param_specs(mesh, params, cfg.sharding_profile)
            if placed:
                shd.distribute_model(params, mesh, specs)
            state = adamw_init(dict(params.named_parameters()), opt_cfg,
                               period=len(cfg.pattern))
            step = dryrun.make_train_step(cfg, opt_cfg, 1, steal,
                                          mesh if placed else None)
            losses, times, counts = [], [], []
            for b in batches:
                if placed:
                    b = shd.distribute_tree(b, mesh, shd.batch_specs(mesh, b))
                before = _counts(gmm, fa, rms)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, loss, _ = step(params, state, b)
                loss = loss.full_tensor() if isinstance(loss, DTensor) \
                    else loss
                losses.append(float(loss))
                times.append(time.perf_counter() - t0)
                counts.append({k: v - before[k] for k, v in
                               _counts(gmm, fa, rms).items()})
            weights = {n: (p.to_local() if isinstance(p, DTensor) else p)
                       .detach().to("cpu", copy=True)
                       for n, p in params.named_parameters()}
            if placed:
                saved.update(mesh_save(params, cfg))
            kinds = sorted({type(p).__name__ for p in params.parameters()})
            placements = sorted({str(tuple(p.placements))
                                 for p in params.parameters()
                                 if isinstance(p, DTensor)})
            del params, state
            torch.cuda.empty_cache()
            return losses, times, counts, weights, kinds, placements

        saved = {}
        d_loss, d_ms, d_counts, d_w, kinds, placements = run(True)
        log(f"[mesh] {cfg.name} on mesh {tuple(mesh.mesh.shape)} "
            f"{mesh.mesh_dim_names} (NCCL, one rank): parameters {kinds} "
            f"placed {placements}; steal table from the mesh; "
            f"{MESH_STEPS} steps, losses {['%.6f' % x for x in d_loss]}, "
            f"{['%.1f' % (1e3 * t) for t in d_ms]} ms; launches per step "
            f"{d_counts[0]}")
        for i, c in enumerate(d_counts):
            if c != per_step:
                raise AssertionError(f"[mesh] step {i + 1}: launches {c}, "
                                     f"expected {per_step}")
        p_loss, p_ms, p_counts, p_w, _, _ = run(False)
        log(f"[mesh] the same steps on plain tensors: losses "
            f"{['%.6f' % x for x in p_loss]}, "
            f"{['%.1f' % (1e3 * t) for t in p_ms]} ms; launches per step "
            f"{p_counts[0]}")
        differ = [n for n in p_w if not torch.equal(p_w[n], d_w[n])]
        if d_loss != p_loss or differ:
            raise AssertionError(f"[mesh] DTensor and plain steps differ: "
                                 f"losses {d_loss} vs {p_loss}; weights "
                                 f"{differ[:8]}")
        want = _flat_bits({"params": convert.to_jax(p_w, cfg, numpy=False)})
        _same_bits("[mesh] the DTensor run's checkpoint, restored",
                   _flat_bits(saved["tree"]), want)
        log(f"[mesh] the DTensor run's weights saved through convert.to_jax "
            f"and save ({saved['entries']} entries, all 'full': each leaf's "
            f"mesh has one device): {saved['bytes'] / 1e9:.3f} GB in "
            f"{saved['save_s']:.2f} s, restored in {saved['restore_s']:.2f} "
            f"s into plain tensors, equal to the plain run's weights bit "
            "for bit")
        log(f"[mesh] losses and all {len(p_w)} weights equal bit for bit; "
            f"step time (steps 2-{MESH_STEPS}) DTensor "
            f"{1e3 * sum(d_ms[1:]) / (MESH_STEPS - 1):.1f} ms, plain "
            f"{1e3 * sum(p_ms[1:]) / (MESH_STEPS - 1):.1f} ms")
        total = {k: sum(c[k] for c in d_counts) for k in per_step}
        return total
    finally:
        dist.destroy_process_group()


def sim_workloads() -> dict:
    from repro_torch.core.sim import bots
    return {"fft": bots.fft(n=1 << 15, cutoff=4),
            "sort": bots.sort(n=1 << 15, cutoff=4),
            "strassen": bots.make("strassen", "medium")}


def sim_variants(k: int) -> dict:
    """bots_repro.variants_k: baseline Nanos vs the paper's NUMA model."""
    return {"base": dict(binding="linear", placement=f"spill:{k}@0",
                         runtime_data=0, migration_rate=SIM_MIGRATION),
            "numa": dict(binding="paper", placement=f"spill:{k}")}


def sim_grid(machine, wls: dict):
    """The [sim] figure grid (SIM_* above) as one Grid: each workload's
    three Machine.grid calls (its spill differs) fused by Grid.concat."""
    from repro_torch.core.sim import Grid
    grids = []
    for name in SIM_WORKLOADS:
        wl, k = {name: wls[name]}, SIM_SPILL[name]
        v = sim_variants(k)
        serial = {name: machine.serial_time(wls[name],
                                            placement=f"spill:{k}@0")}
        grids.append(machine.grid(
            workloads=wl, schedulers=SIM_ALLOC, threads=SIM_THREADS,
            contexts=v, seeds=SIM_SEEDS, serial_reference=serial))
        grids.append(machine.grid(
            workloads=wl, schedulers=SIM_STUDY, threads=SIM_THREADS,
            contexts={"numa": v["numa"]}, seeds=SIM_SEEDS,
            serial_reference=serial))
        grids.append(machine.grid(
            workloads=wl, schedulers=SIM_ALLOC + SIM_STUDY, threads=16,
            contexts={"numa": v["numa"]}, seeds=SIM_FAULT_SEEDS,
            faults=SIM_FAULTS, serial_reference=serial))
    return Grid.concat(grids)


def sim_bound(input_bytes: int, ctx_cells, trace_bytes: int = 0) -> tuple:
    """(bound ms, what bounds it) of a batch whose distinct inputs (the
    packed tables, plans and parameters: ``kernels.sim.last_run``'s
    ``input_bytes``) are read once, and whose cells, given as (tasks,
    steps), each write their task state and outputs once (bytes) and do
    at most SIM_OPS_PER_STEP double operations an event; a traced batch
    also writes its ``trace_bytes`` of events once (56 / 40 / 32 B an
    exec / steal / migration event)."""
    nbytes = input_bytes + trace_bytes + sum(
        SIM_STATE_BYTES * n + SIM_OUT_BYTES for n, _ in ctx_cells)
    ops = sum(SIM_OPS_PER_STEP * steps for _, steps in ctx_cells)
    return roof(nbytes, ops, FP64_FLOPS)


def sim_same(what: str, got, want) -> None:
    """Raise unless two SimResults agree in every metric and aggregate."""
    fields = ("makespan", "serial_time", "speedup", "tasks", "steals",
              "failed_probes", "remote_work_fraction", "queue_wait",
              "reclaimed", "reexec", "fault_lost", "steal_hops",
              "node_tasks", "node_remote")
    bad = [f for f in fields if getattr(got, f) != getattr(want, f)]
    if bad:
        raise AssertionError(f"[sim] {what}: {bad} differ: "
                             + "; ".join(f"{f} {getattr(got, f)!r} vs "
                                         f"{getattr(want, f)!r}"
                                         for f in bad))


def sim_selftests(sim) -> None:
    """The kernel's replicas on the card against numpy's RandomState
    (raw draws and shuffles) and CPython's set (add/pop sequences)."""
    import random

    import numpy as np
    for seed in (0, 7, 12345):
        got = sim.mt_selftest(seed, 3000, "cuda")
        want = np.random.RandomState(seed).randint(0, 2 ** 32, size=3000,
                                                   dtype=np.uint32)
        if not np.array_equal(got, want):
            raise AssertionError(f"[sim] MT19937 seed {seed} differs")
    for n in (2, 5, 15):
        got = sim.shuffle_selftest(3, n, 300, "cuda")
        rng = np.random.RandomState(3)
        for r in range(300):
            g = list(range(n))
            rng.shuffle(g)
            if list(got[r]) != g:
                raise AssertionError(f"[sim] shuffle n {n} rep {r} differs")
    rnd = random.Random(123)
    for case in range(150):
        T = rnd.choice([2, 3, 8, 16, 64, 300])
        ops, want, live = [], [], set()
        for _ in range(rnd.randrange(5, 300)):
            if live and rnd.random() < 0.45:
                ops.append(-1)
                want.append(live.pop())
            else:
                v = rnd.randrange(T)
                ops.append(v)
                live.add(v)
        if sim.set_selftest(ops, T, "cuda") != want:
            raise AssertionError(f"[sim] set case {case} (T {T}) differs")
    log("[sim] self-tests on the card: MT19937 (3 seeds x 3000 draws) "
        "equal to numpy's RandomState, shuffles (n 2, 5, 15 x 300) equal "
        "to RandomState.shuffle, 150 add/pop sequences equal to CPython's "
        "set")


def sim_golden(sim) -> None:
    """tests/data/sim_golden.json's 25 keys through the kernel: every
    recorded metric exactly; once more in waves of a few cells each, and
    with one cell a warp, the same bits."""
    from repro_torch.core import placement, topology
    from repro_torch.core.sim import SweepPlan, bots
    gold = json.loads((Path(__file__).resolve().parent / "tests" / "data"
                       / "sim_golden.json").read_text())
    topos = {"sunfire": topology.sunfire_x4600(),
             "tpu2x4": topology.tpu_pod_2d(2, 4)}
    wls = {"fft_small": bots.fft(n=1 << 10, cutoff=8),
           "sparselu_small": bots.sparselu(n=8)}
    plan, keys = SweepPlan(), []
    for tn, topo in topos.items():
        for wn, wl in wls.items():
            for sched in ("bf", "cilk", "wf", "dfwspt", "dfwsrpt",
                          "dfwshier"):
                plan.add(topo, list(range(8)), wl, sched, seed=7)
                keys.append(f"{tn}/{wn}/{sched}")
    sf = topos["sunfire"]
    plan.add(sf, list(range(16)), wls["fft_small"], "wf", seed=3,
             root_data_nodes=placement.first_touch_spill(sf, 0, 2),
             runtime_data_node=0, migration_rate=0.15)
    keys.append("sunfire/fft_small/wf+baseline-numa")
    if sorted(keys) != sorted(gold):
        raise AssertionError("[sim] golden keys differ from the fixture's")
    res = plan.run(device="cuda")
    for r, key in zip(res, keys):
        for m, want in gold[key].items():
            if getattr(r, m) != want:
                raise AssertionError(f"[sim] golden {key} {m}: "
                                     f"{getattr(r, m)!r} vs {want!r}")
    waves, cpw = sim.MAX_WAVE_BYTES, sim.CELLS_PER_WARP
    try:
        sim.MAX_WAVE_BYTES = 3 * sim.workspace_bytes(511, 16)
        again = plan.run(device="cuda")
        n_waves = sim.last_run["waves"]
        sim.MAX_WAVE_BYTES = waves
        sim.CELLS_PER_WARP = SIM_GOLDEN_CELLS_A_WARP
        third = plan.run(device="cuda")
    finally:
        sim.MAX_WAVE_BYTES, sim.CELLS_PER_WARP = waves, cpw
    for a, b, c, key in zip(res, again, third, keys):
        sim_same(f"golden {key} in waves", b, a)
        sim_same(f"golden {key} at {SIM_GOLDEN_CELLS_A_WARP} cells a "
                 "warp", c, a)
    log(f"[sim] golden: all {len(keys)} keys of tests/data/sim_golden.json "
        f"equal on the card ({sum(len(v) for v in gold.values())} metrics); "
        f"the same bits in {n_waves} waves and at "
        f"{SIM_GOLDEN_CELLS_A_WARP} cells a warp")


def sim_phase(sim) -> dict:
    """[sim]: the self-tests, the golden keys, then the figure grid on
    the card in one batch (the main path, launches counted), 8 of its
    cells held bit for bit against the plain version on the host, and
    the kernel timed on those 8 cells beside the plain version."""
    from repro_torch.core import topology
    from repro_torch.core.sim import GridKey, Machine, run_sweep
    t_phase = time.perf_counter()
    log(f"[sim] {card_line()}")
    sim_selftests(sim)
    t_self = time.perf_counter() - t_phase
    sim_golden(sim)
    t_golden = time.perf_counter() - t_phase - t_self

    wls = sim_workloads()
    machine = Machine(topology.sunfire_x4600(), device="cuda")
    t0 = time.perf_counter()
    grid = sim_grid(machine, wls)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim.launches = 0                         # the main path starts here
    t0 = time.perf_counter()
    res = grid.run()
    wall_s = time.perf_counter() - t0
    launches = sim.launches                  # ... and ends here
    run = dict(sim.last_run)
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or len(res) != len(grid):
        raise AssertionError(f"[sim] the grid launched {launches} times "
                             f"for {len(res)} of {len(grid)} cells")
    tasks = {name: wl.root.count() for name, wl in wls.items()}
    for k, r in res.items():
        if not (r.engine == "cuda" and r.tasks == tasks[k.workload]
                and math.isfinite(r.makespan) and r.makespan > 0
                and 0 < r.speedup <= k.threads + 0.5):
            raise AssertionError(f"[sim] grid cell {k}: {r}")
    # the paper's claims the grid must show (as tests/test_sim.py holds
    # the JAX package): at 16 threads NUMA-aware wf beats baseline wf on
    # the data-intensive benchmarks, and bf stops scaling on fft
    means = {}
    for k, r in res.items():
        key = (k.workload, k.scheduler, k.context, k.threads, k.faults)
        means.setdefault(key, []).append(r.speedup)
    means = {k: sum(v) / len(v) for k, v in means.items()}
    for name in SIM_WORKLOADS:
        b, n = means[(name, "wf", "base", 16, "none")], \
            means[(name, "wf", "numa", 16, "none")]
        if not n > b:
            raise AssertionError(f"[sim] {name}: numa wf {n:.3f}x not above "
                                 f"base wf {b:.3f}x at 16 threads")
    if not means[("fft", "bf", "base", 16, "none")] < \
            1.35 * means[("fft", "bf", "base", 6, "none")]:
        raise AssertionError("[sim] fft: bf keeps scaling from 6 to 16")

    # 8 cells bit for bit against the plain version on the host
    index = {k: i for i, k in enumerate(grid.keys)}
    held = [index[GridKey(*h)] for h in SIM_HELD]
    cfgs = [grid.plan.configs[i] for i in held]
    t0 = time.perf_counter()
    plain = run_sweep(cfgs, device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for i, p in zip(held, plain):
        got = res[grid.keys[i]]
        sim_same(f"grid cell {grid.keys[i]} vs the plain version", got, p)
        err = max([err] + [abs(getattr(got, f) - getattr(p, f)) for f in (
            "makespan", "speedup", "remote_work_fraction", "queue_wait",
            "fault_lost")] + [abs(a - b) for a, b in zip(got.node_remote,
                                                         p.node_remote)])
    # the kernel on the same 8 cells (not counted: a comparison)
    ms = math.inf
    for _ in range(3):
        again = run_sweep(cfgs, device="cuda")
        ms = min(ms, sim.last_run["kernel_ms"])
    for i, a in zip(held, again):
        sim_same(f"grid cell {grid.keys[i]} run again", a,
                 res[grid.keys[i]])
    steps8, inputs8 = sim.last_run["steps"], sim.last_run["input_bytes"]
    bound_ms, bound_by = sim_bound(
        inputs8, [(res[grid.keys[i]].tasks, steps8 / len(held))
                  for i in held])
    grid_bound, grid_by = sim_bound(
        run["input_bytes"],
        [(r.tasks, run["steps"] / len(res)) for r in res.values()])
    grid_ms = run["kernel_ms"]
    log(f"[sim] grid: {len(res)} cells ({', '.join(SIM_WORKLOADS)}; "
        f"{len(SIM_THREADS)} thread counts; {SIM_SEEDS} seeds, "
        f"{SIM_FAULT_SEEDS} for the fault grids) in {launches} launch(es) "
        f"= {run['waves']} wave(s), {run['cells_per_warp']} cells a warp; "
        f"kernel {grid_ms:.1f} ms (CUDA events), {len(res) / grid_ms * 1e3:.0f} "
        f"cells/s, {run['steps']} events = "
        f"{run['steps'] / grid_ms * 1e3:.3e} events/s; wall {wall_s:.2f} s: "
        f"packing {run['pack_s']:.2f} s, on the device (copies, the launch "
        f"and the wait) {run['device_s']:.2f} s, unpacking "
        f"{run['unpack_s']:.2f} s, the rest (contexts, serial references, "
        f"results) {wall_s - run['pack_s'] - run['device_s'] - run['unpack_s']:.2f} "
        f"s; grid built in {build_s:.2f} s; workspaces {run['workspace_bytes'] / 2**30:.2f} "
        f"GiB, inputs {run['input_bytes'] / 2**20:.1f} MiB, peak device "
        f"memory {peak / 2**30:.2f} GiB; bound {grid_bound:.4f} ms "
        f"({grid_by}-bound, as accounting: the inputs read once, "
        f"{SIM_STATE_BYTES} B a task and {SIM_OUT_BYTES} B a cell written "
        f"once), the kernel {grid_ms / grid_bound:.0f}x it: each cell is "
        f"one serial event chain, which the bytes do not see")
    regs = sim_registers().get("untraced/untimed", ("?", "?", "?"))
    log(f"[sim] the grid's kernel {grid_ms:.1f} ms beside "
        f"{SIM_GRID_MS_BEFORE_TRACE} ms before sim.cu had its traced and "
        f"timed instantiations; this untraced one: {regs[0]} registers, "
        f"spill stores {regs[1]} B, loads {regs[2]} B")
    log(f"[sim] 8 cells ({'; '.join('/'.join(map(str, h)) for h in SIM_HELD)}) "
        f"equal to the plain version on the host bit for bit: kernel "
        f"{ms:.1f} ms, plain version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}-bound; inputs "
        f"{inputs8 / 2**20:.2f} MiB)")
    for name in SIM_WORKLOADS:
        row = ", ".join(
            f"{sch}/{ctx} {means[(name, sch, ctx, 16, 'none')]:.2f}x"
            for sch, ctx in (("bf", "base"), ("bf", "numa"),
                             ("wf", "base"), ("wf", "numa"),
                             ("dfwspt", "numa"), ("dfwsrpt", "numa"),
                             ("dfwshier", "numa")))
        log(f"[sim] {name} mean speedup at 16 threads over "
            f"{SIM_SEEDS} seeds: {row}")
    log(f"[sim] seconds: self-tests {t_self:.1f}, golden {t_golden:.1f}, "
        f"the whole phase {time.perf_counter() - t_phase:.1f}")
    log(f"[sim] {card_line()}")
    return dict(launches=launches, rep=dict(
        shape=f"8 grid cells, {sum(res[grid.keys[i]].tasks for i in held)} "
              "tasks", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        grid_ms=grid_ms, grid_cells=len(res), grid_waves=run["waves"],
        grid_bound_ms=grid_bound))


def sim_registers() -> dict:
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} of ``csrc/sim.cu`` from its ``-Xptxas -v`` log, which the
    build keeps beside the library (so a checkout that built it in an
    earlier run reads the same); an instantiation is named by its
    template flags, "untraced"/"traced" and "untimed"/"timed"."""
    import re
    from repro_torch.kernels import _build
    _build.build(["sim"])
    out, name = {}, None
    for line in _build.build_logs["sim"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            flags = re.search(r"sim_batch_kernelILb([01])ELb([01])E", m[1])
            name = None if flags is None else (
                ("traced" if flags[1] == "1" else "untraced") + "/"
                + ("timed" if flags[2] == "1" else "untimed"))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m[1]), int(m[2])]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, [0, 0, 0])[0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


def durable_grid(machine, wls: dict, serial: dict):
    """[sim_durable]'s forensics grid (DURABLE_* above) on ``machine``."""
    from repro_torch.core.sim import Grid
    grids, top = [], DURABLE_THREADS[-1]
    for name in SIM_WORKLOADS:
        v = sim_variants(DURABLE_SPILL[name])
        kw = dict(workloads={name: wls[name]}, seeds=DURABLE_SEEDS,
                  serial_reference=serial[name])
        grids.append(machine.grid(schedulers=DURABLE_STUDY,
                                  threads=DURABLE_THREADS,
                                  contexts={"numa": v["numa"]}, **kw))
        grids.append(machine.grid(schedulers=("bf", "cilk"), threads=top,
                                  contexts=v, **kw))
        grids.append(machine.grid(schedulers=("wf",), threads=top,
                                  contexts={"base": v["base"]}, **kw))
    for name in DURABLE_SMALL:
        grids.append(machine.grid(
            workloads={name: wls[name]}, schedulers=SIM_ALLOC, threads=top,
            contexts=sim_variants(DURABLE_SPILL[name]), seeds=DURABLE_SEEDS,
            serial_reference=serial[name]))
    return Grid.concat(grids)


def trace_agrees(what: str, r) -> None:
    """Raise unless a traced result's events agree with its metrics:
    one exec event a task, one steal event a steal, the steal events'
    hop histogram and the exec events' node counts equal to the
    aggregates, every interval inside the makespan."""
    import numpy as np
    tr = r.trace
    hops = np.bincount(tr.st_dist, minlength=len(r.steal_hops))
    nodes = np.bincount(tr.ex_node, minlength=len(r.node_tasks))
    bad = [name for name, ok in (
        ("exec events", tr.n_exec == r.tasks),
        ("steal events", tr.n_steal == r.steals),
        ("steal_hops", tuple(int(x) for x in hops) == r.steal_hops),
        ("node_tasks", tuple(int(x) for x in nodes) == r.node_tasks),
        ("tasks once", np.array_equal(np.sort(tr.ex_task),
                                      np.arange(r.tasks))),
        ("intervals", bool((tr.ex_end <= r.makespan).all()
                           and (tr.ex_start <= tr.ex_end).all())))
        if not ok]
    if bad:
        raise AssertionError(f"[sim_durable] {what}: the trace disagrees "
                             f"with the metrics in {bad} ({tr!r}, {r})")


def sim_durable_phase(sim) -> dict:
    """[sim_durable]: the traced and durable path on the card (see the
    module docstring, item 21)."""
    import warnings

    import numpy as np
    from repro_torch.core import topology
    from repro_torch.core.sim import (CellError, CellTimeout, GridKey,
                                      Machine, ResultStore, SimParams,
                                      bots, cell_key, compile_cache, policy,
                                      run_sweep)
    t_phase = time.perf_counter()
    log(f"[sim_durable] {card_line()}")
    regs = sim_registers()
    log("[sim_durable] ptxas (csrc/sim.cu, --fmad=false): " + "; ".join(
        f"{k} {r} registers, spill stores {st} B, loads {ld} B"
        for k, (r, st, ld) in sorted(regs.items())))
    if regs.get("untraced/untimed", (0, 1, 1))[1:] != (0, 0):
        raise AssertionError("[sim_durable] the untraced instantiation "
                             f"spills or is missing: {regs}")
    topo = topology.sunfire_x4600()
    plain_m = Machine(topo, device="cpu")
    card = Machine(topo, device="cuda")
    traced = Machine(topo, SimParams(trace=True), device="cuda")
    wls = sim_workloads()
    for name in DURABLE_SMALL:
        wls[name] = bots.make(name, "medium")
    serial = {name: plain_m.serial_time(
        wl, placement=f"spill:{DURABLE_SPILL[name]}@0")
        for name, wl in wls.items()}
    grid = durable_grid(card, wls, serial)
    tgrid = durable_grid(traced, wls, serial)
    want = grid.run()
    untraced_run = dict(sim.last_run)
    tmp = tempfile.mkdtemp(prefix="sim_durable_")
    journal = os.path.join(tmp, "forensics.jsonl")

    # the main path: the traced grid journaled, its launches counted
    sim.launches = 0
    for k in sim.route_launches:
        sim.route_launches[k] = 0
    t0 = time.perf_counter()
    got = tgrid.run(resume=journal)
    wall_s = time.perf_counter() - t0
    launches = dict(sim.route_launches)
    run = dict(sim.last_run)
    if launches["traced"] == 0 or launches["untraced"] != 0 \
            or len(got) != len(tgrid):
        raise AssertionError(f"[sim_durable] the traced grid launched "
                             f"{launches} for {len(got)} cells")
    events = 0
    for k, r in got.items():
        sim_same(f"traced cell {k} vs untraced", r, want[k])
        if r.engine != "cuda":
            raise AssertionError(f"[sim_durable] {k} ran on {r.engine}")
        trace_agrees(str(k), r)
        events += r.trace.n_exec + r.trace.n_steal + r.trace.n_mig

    # 4 cells' traces against the plain version's, event for event
    index = {k: i for i, k in enumerate(tgrid.keys)}
    held = [index[GridKey(*h, "none")] for h in DURABLE_HELD]
    cfgs = [tgrid.plan.configs[i] for i in held]
    t0 = time.perf_counter()
    plain = run_sweep(cfgs, device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    for i, p in zip(held, plain):
        r = got[tgrid.keys[i]]
        sim_same(f"traced cell {tgrid.keys[i]} vs the plain version", r, p)
        if not r.trace == p.trace:
            raise AssertionError(f"[sim_durable] {tgrid.keys[i]}: the "
                                 "trace differs from the plain version's")
    ms = math.inf
    for _ in range(3):               # the kernel on the held cells alone
        again = run_sweep(cfgs, device="cuda")
        ms = min(ms, sim.last_run["kernel_ms"])
    held_bytes = sum(r.trace.nbytes() for r in again)
    bound_ms, bound_by = sim_bound(
        sim.last_run["input_bytes"],
        [(r.tasks, sim.last_run["steps"] / len(again)) for r in again],
        held_bytes)
    grid_bytes = sum(r.trace.nbytes() for r in got.values())
    grid_bound, _ = sim_bound(
        run["input_bytes"],
        [(r.tasks, run["steps"] / len(got)) for r in got.values()],
        grid_bytes)

    # the journal: a rerun launches nothing, a torn line reruns one cell
    keys = {k: cell_key(c.to_context(), c.workload,
                        policy.get_spec(c.scheduler), c.seed,
                        c.serial_reference)
            for k, c in zip(tgrid.keys, tgrid.plan.configs)}
    before = sim.launches
    t0 = time.perf_counter()
    replay = tgrid.run(resume=journal)
    replay_s = time.perf_counter() - t0
    if sim.launches != before:
        raise AssertionError("[sim_durable] the warm journal launched "
                             f"{sim.launches - before} times")
    store = ResultStore(journal)
    t0 = time.perf_counter()
    for k, r in replay.items():
        sim_same(f"replayed cell {k}", r, got[k])
        if not store.get_trace(keys[k]) == got[k].trace:
            raise AssertionError(f"[sim_durable] {k}: the sidecar trace "
                                 "differs")
    sidecar_s = time.perf_counter() - t0
    store.close()
    raw = Path(journal).read_bytes()
    Path(journal).write_bytes(raw[:-40])          # tear the last line
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torn = tgrid.run(resume=journal)
    if sim.last_run.get("cells") != 1 or sim.launches != before + 1 \
            or not any("torn" in str(w.message) for w in caught):
        raise AssertionError(f"[sim_durable] the torn journal reran "
                             f"{sim.last_run.get('cells')} cells in "
                             f"{sim.launches - before} launches")
    for k, r in torn.items():
        sim_same(f"cell {k} after the torn journal", r, got[k])
    journal_mb = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                     if f.is_file()) / 2**20
    log(f"[sim_durable] forensics grid: {len(got)} cells, traced in "
        f"{launches['traced']} launch(es) ({run['waves']} wave(s)); kernel "
        f"{run['kernel_ms']:.1f} ms traced vs {untraced_run['kernel_ms']:.1f} "
        f"ms untraced ({run['kernel_ms'] / untraced_run['kernel_ms']:.2f}x; "
        f"CUDA events); {events} events = {grid_bytes / 2**20:.1f} MiB of "
        f"trace (columns sized {run['trace_cap_bytes'] / 2**20:.1f} MiB), "
        f"{events / run['kernel_ms'] * 1e3:.3e} events/s in the kernel; "
        f"bound {grid_bound:.4f} ms (the untraced bytes plus the trace "
        f"written once); wall {wall_s:.2f} s: packing {run['pack_s']:.2f} "
        f"s, on the device {run['device_s']:.2f} s (the events' gather "
        f"and copy-off after the launch {run['trace_copy_s']:.2f} s of "
        f"it), unpacking "
        f"{run['unpack_s']:.2f} s, the rest (contexts, results, the journal "
        f"and its sidecars, {journal_mb:.1f} MiB on disk) "
        f"{wall_s - run['pack_s'] - run['device_s'] - run['unpack_s']:.2f} "
        f"s; every result equal to the "
        f"untraced grid's, every trace's counts and histograms equal to "
        f"the metrics")
    held_names = "; ".join("/".join(map(str, h)) for h in DURABLE_HELD)
    log(f"[sim_durable] {len(held)} cells ({held_names}) traced equal to "
        f"the plain version event for event: kernel {ms:.1f} ms, plain "
        f"version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms ({held_bytes / 2**20:.2f} MiB of events)")
    log(f"[sim_durable] journal: the rerun launched nothing ({replay_s:.2f} "
        f"s) and gave the same {len(replay)} results; sidecar traces equal "
        f"({sidecar_s:.2f} s to read); a journal torn mid-line reran 1 "
        "cell, the same bits")

    # the paper-scale FFT from the compile cache
    root = os.path.join(tmp, "compile-cache")
    old_root = os.environ.get(compile_cache.ENV_VAR)
    os.environ[compile_cache.ENV_VAR] = root
    compile_cache.reset_cache()
    try:
        t0 = time.perf_counter()
        bots.make("fft", "paper")
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wl = bots.make("fft", "paper")
        warm_s = time.perf_counter() - t0
        hits = compile_cache.get_cache().hit_count("tables")
        if wl.root is not None or hits != 1 or \
                not isinstance(wl.table.work_pre, np.memmap):
            raise AssertionError("[sim_durable] the paper table did not come "
                                 "from the compile cache")
        pserial = plain_m.serial_time(wl, placement="spill:2@0")
        name = PAPER_HELD[0]
        v = sim_variants(2)
        pgrid = card.grid(workloads={name: wl}, schedulers=PAPER_SCHEDS,
                          threads=16, contexts=v, seeds=(0,),
                          serial_reference={name: pserial})
        tpgrid = traced.grid(workloads={name: wl}, schedulers=PAPER_SCHEDS,
                             threads=16, contexts=v, seeds=(0,),
                             serial_reference={name: pserial})
        pwant = pgrid.run()
        paper_ms = sim.last_run["kernel_ms"]
        pgot = tpgrid.run()
        paper_traced_ms = sim.last_run["kernel_ms"]
        paper_bytes = sum(r.trace.nbytes() for r in pgot.values())
        for k, r in pgot.items():
            sim_same(f"paper cell {k} traced vs untraced", r, pwant[k])
            trace_agrees(f"paper cell {k}", r)
        i = pgrid.keys.index(GridKey(*PAPER_HELD, "none"))
        t0 = time.perf_counter()
        (pplain,) = run_sweep([tpgrid.plan.configs[i]], device="cpu")
        pplain_s = time.perf_counter() - t0
        r = pgot[pgrid.keys[i]]
        sim_same(f"paper cell {pgrid.keys[i]} vs the plain version", r,
                 pplain)
        if not r.trace == pplain.trace:
            raise AssertionError("[sim_durable] the paper cell's trace "
                                 "differs from the plain version's")
        log(f"[sim_durable] paper-scale fft ({r.tasks} tasks): table from "
            f"the compile cache, cold {cold_s:.2f} s (build and store), "
            f"warm {warm_s * 1e3:.1f} ms (memory-mapped); {len(pgot)} cells "
            f"({', '.join(PAPER_SCHEDS)} x base/numa, 16 threads): kernel "
            f"{paper_ms:.1f} ms untraced, {paper_traced_ms:.1f} ms traced "
            f"({paper_traced_ms / paper_ms:.2f}x), "
            f"{paper_bytes / 2**20:.1f} MiB of events; "
            f"{'/'.join(map(str, PAPER_HELD))} equal to the plain version "
            f"bit for bit and event for event ({pplain_s:.1f} s on the "
            f"host, traced)")

        # the timeout: long for the medium cells, short for the paper one
        mix = list(pgrid.plan.configs[i:i + 1])
        small = [c for c, k in zip(grid.plan.configs, grid.keys)
                 if k.workload in DURABLE_SMALL and k.seed == 0]
        mix += small
        run_sweep(small, device="cuda")
        small_ms = sim.last_run["kernel_ms"]
        timeout = PAPER_TIMEOUT_SHARE * paper_ms / 1e3
        if not small_ms / 1e3 < timeout / 10:
            raise AssertionError(f"[sim_durable] the medium cells take "
                                 f"{small_ms:.1f} ms, not far below the "
                                 f"{timeout:.3f} s timeout")
        t0 = time.perf_counter()
        timed = run_sweep(mix, strict=False, timeout=timeout, device="cuda")
        timed_s = time.perf_counter() - t0
        err = timed[0]
        if not (isinstance(err, CellError)
                and isinstance(err.error, CellTimeout)
                and err.engine == "cuda"):
            raise AssertionError(f"[sim_durable] the paper cell under a "
                                 f"{timeout:.3f} s timeout gave {err!r}")
        for c, r in zip(small, timed[1:]):
            k = grid.keys[grid.plan.configs.index(c)]
            sim_same(f"timed cell {k}", r, want[k])
        log(f"[sim_durable] timeout {timeout:.3f} s ({PAPER_TIMEOUT_SHARE} "
            f"of the paper cell's {paper_ms:.0f} ms): the paper cell became "
            f"{err!r}; the {len(small)} medium cells beside it "
            f"({small_ms:.1f} ms untimed) equal their untimed results; "
            f"{timed_s:.2f} s")
    finally:
        if old_root is None:
            os.environ.pop(compile_cache.ENV_VAR, None)
        else:
            os.environ[compile_cache.ENV_VAR] = old_root
        compile_cache.reset_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sim_durable] the whole phase {time.perf_counter() - t_phase:.1f} "
        "s")
    log(f"[sim_durable] {card_line()}")
    return dict(launches=launches["traced"], rep=dict(
        shape=f"{len(held)} forensics cells traced, "
              f"{sum(r.tasks for r in again)} tasks", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
        bound_by=bound_by, grid_ms=run["kernel_ms"],
        grid_untraced_ms=untraced_run["kernel_ms"], grid_cells=len(got),
        grid_bound_ms=grid_bound, trace_bytes=grid_bytes,
        paper_ms=paper_ms, paper_traced_ms=paper_traced_ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import sim as simk
    from repro_torch.kernels import ssd_scan as ssd

    t_all = time.perf_counter()
    # the simulator's compile cache lives under TMPDIR for this run only
    # (the default root is in the user's home)
    from repro_torch.core.sim import compile_cache
    cache_dir = tempfile.mkdtemp(prefix="sim_compile_cache_")
    os.environ.setdefault(compile_cache.ENV_VAR, cache_dir)
    compile_cache.reset_cache()
    log(card_line())
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {', '.join(_build.SOURCES)} for sm_90a in "
        f"{time.perf_counter()-t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")
    preds = dryrun_phase()
    log(f"[time] dry run (host) done at {time.perf_counter()-t_all:.1f} s")

    with library_precision():
        gmm_res = kernel_phase(gmm)
        gmm_bwd_res = gmm_backward_phase(gmm)
        flash_res = flash_phase(fa)
        cp_phase(fa)
        log(f"[time] cp phase done at {time.perf_counter()-t_all:.1f} s")
        rms_res = rmsnorm_phase(rms)
        ssd_res = ssd_phase(ssd)
    log(f"[time] kernel phase done at {time.perf_counter()-t_all:.1f} s")
    sim_res = sim_phase(simk)
    torch.cuda.empty_cache()
    log(f"[time] sim phase done at {time.perf_counter()-t_all:.1f} s")
    durable_res = sim_durable_phase(simk)
    torch.cuda.empty_cache()
    log(f"[time] sim_durable phase done at {time.perf_counter()-t_all:.1f} s")

    _reset(gmm, fa, rms)
    serve_launches = serve_phase(gmm)      # counts its own run's moe_gmm
    others = {k: v for k, v in _counts(gmm, fa, rms).items()
              if k != "moe_gmm"}
    if any(others.values()):               # serving attends with its cache
        raise AssertionError(f"serving launched {others}")
    reduced_phase()
    torch.cuda.empty_cache()
    log(f"[time] serve phase done at {time.perf_counter()-t_all:.1f} s")

    train = train_phase(gmm, fa, rms)
    counts = train["counts"]
    measured = {ARCH: train["ms"]}              # arch -> ms/step
    dry = [dryrun_check(ARCH, preds[ARCH], train["peaks"],
                       train["resident"])]
    train_check_in_situ(train["cfg"], train["params"], train["batch"])
    del train
    torch.cuda.empty_cache()
    train_check_reduced()
    log(f"[time] train phase and checks done at "
        f"{time.perf_counter()-t_all:.1f} s")
    train_learning_phase()
    torch.cuda.empty_cache()
    log(f"[time] learning run done at {time.perf_counter()-t_all:.1f} s")
    mesh_counts = mesh_phase(gmm, fa, rms)
    torch.cuda.empty_cache()
    log(f"[time] mesh phase done at {time.perf_counter()-t_all:.1f} s")

    mamba = mamba_train_phase(gmm, fa, rms)
    mamba_counts = mamba["counts"]
    measured[MAMBA] = mamba["ms"]
    dry.append(dryrun_check(MAMBA, preds[MAMBA], mamba["peaks"],
                            mamba["resident"]))
    mamba_check_in_situ(mamba["cfg"], mamba["params"], mamba["batch"])
    del mamba
    torch.cuda.empty_cache()
    mamba_check_reduced()
    mamba_serve_phase()
    torch.cuda.empty_cache()
    log(f"[time] mamba2 phases done at {time.perf_counter()-t_all:.1f} s")

    dense = {}                              # arch -> launch counts
    for arch in DENSE_TRAIN:
        run = train_phase(gmm, fa, rms, arch, tag=arch)
        dense[arch] = run["counts"]
        measured[arch] = run["ms"]
        dry.append(dryrun_check(arch, preds[arch], run["peaks"],
                                run["resident"]))
        train_check_in_situ(run["cfg"], run["params"], run["batch"])
        del run
        torch.cuda.empty_cache()
        train_check_reduced(arch)
        log(f"[time] {arch} train phase and checks done at "
            f"{time.perf_counter()-t_all:.1f} s")
    serve_check_phase(gmm, fa, rms, DENSE_SERVE, "dense-serve")
    torch.cuda.empty_cache()
    log(f"[time] {DENSE_SERVE} serve phase done at "
        f"{time.perf_counter()-t_all:.1f} s")
    resume_phase()
    torch.cuda.empty_cache()
    log(f"[time] resume phase done at {time.perf_counter()-t_all:.1f} s")
    elastic = elastic_phase(gmm, fa, rms)
    torch.cuda.empty_cache()
    log(f"[time] elastic phase done at {time.perf_counter()-t_all:.1f} s")

    run = train_phase(gmm, fa, rms, HUBERT, tag=HUBERT)
    dense[HUBERT] = run["counts"]
    measured[HUBERT] = run["ms"]
    dry.append(dryrun_check(HUBERT, preds[HUBERT], run["peaks"],
                            run["resident"]))
    train_check_in_situ(run["cfg"], run["params"], run["batch"])
    del run
    torch.cuda.empty_cache()
    train_check_reduced(HUBERT)
    log(f"[time] {HUBERT} train phase and checks done at "
        f"{time.perf_counter()-t_all:.1f} s")
    jamba_counts = jamba_phase(gmm, fa, rms)
    torch.cuda.empty_cache()
    log(f"[time] {JAMBA} phase done at {time.perf_counter()-t_all:.1f} s")
    serve_check_phase(gmm, fa, rms, VISION, "vision-serve",
                      layers=VISION_LAYERS)
    torch.cuda.empty_cache()
    log(f"[time] {VISION} serve phase done at "
        f"{time.perf_counter()-t_all:.1f} s")
    serve_check_phase(gmm, fa, rms, COMMAND_R, "command-r-serve")
    torch.cuda.empty_cache()
    kv_repeat_check(COMMAND_R)
    log(f"[time] {COMMAND_R} serve phase done at "
        f"{time.perf_counter()-t_all:.1f} s")
    examples_phase()
    torch.cuda.empty_cache()
    log(f"[time] examples phase done at {time.perf_counter()-t_all:.1f} s")
    roof = roofline_phase(preds, measured)
    log(f"[time] roofline phase done at {time.perf_counter()-t_all:.1f} s")
    el = elastic["counts"]

    def entry(name, source, replaces, launches, rep):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=launches, **rep)
    kernels = [
        entry("moe_gmm", "moe_gmm.cu", "src/repro/kernels/moe_gmm.py:43",
              serve_launches + counts["moe_gmm"] + jamba_counts["moe_gmm"]
              + mesh_counts["moe_gmm"] + el["moe_gmm"],
              gmm_res[REPORT_CASE]),
        entry("moe_gmm_bwd", "moe_gmm.cu", "src/repro/kernels/moe_gmm.py:43",
              counts["moe_gmm_bwd"] + jamba_counts["moe_gmm_bwd"]
              + mesh_counts["moe_gmm_bwd"] + el["moe_gmm_bwd"],
              gmm_bwd_res[REPORT_CASE]),
        entry("flash_attention_fwd", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:90",
              counts["flash_fwd"] + jamba_counts["flash_fwd"]
              + mesh_counts["flash_fwd"] + el["flash_fwd"]
              + sum(c["flash_fwd"] for c in dense.values()),
              flash_res[("fwd",) + FLASH_REPORT]),
        entry("flash_attention_bwd", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:90",
              counts["flash_bwd"] + jamba_counts["flash_bwd"]
              + mesh_counts["flash_bwd"] + el["flash_bwd"]
              + sum(c["flash_bwd"] for c in dense.values()),
              flash_res[("bwd",) + FLASH_REPORT]),
        entry("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:27",
              counts["rmsnorm"], rms_res[RMS_REPORT]),
        entry("ssd_scan_fwd", "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:75",
              mamba_counts["ssd_fwd"] + jamba_counts["ssd_fwd"],
              ssd_res[SSD_REPORT]["fwd"]),
        entry("ssd_scan_bwd", "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:75",
              mamba_counts["ssd_bwd"] + jamba_counts["ssd_bwd"],
              ssd_res[SSD_REPORT]["bwd"]),
        entry("sim_run_batch", "sim.cu", "src/repro/core/sim/_csim.c:743",
              sim_res["launches"], sim_res["rep"]),
        entry("sim_run_batch_traced", "sim.cu",
              "src/repro/core/sim/_csim.c:617",
              durable_res["launches"], durable_res["rep"]),
    ]
    log(f"[done] moe_gmm launches: serve {serve_launches} + train "
        f"{counts['moe_gmm']} + jamba {jamba_counts['moe_gmm']} forward, "
        f"{counts['moe_gmm_bwd']} + {jamba_counts['moe_gmm_bwd']} backward; "
        f"jamba flash {jamba_counts['flash_fwd']} forward, "
        f"{jamba_counts['flash_bwd']} backward, ssd_scan "
        f"{jamba_counts['ssd_fwd']} forward, {jamba_counts['ssd_bwd']} "
        "backward; "
        f"flash launches: granite train {counts['flash_fwd']} forward, "
        f"{counts['flash_bwd']} backward, "
        + ", ".join(f"{a} train {c['flash_fwd']} forward, {c['flash_bwd']} "
                    "backward" for a, c in dense.items())
        + f" (the kernels line sums them); "
        f"rmsnorm is on no path (no layer calls it), held above on its "
        f"own; ssd_scan {mamba_counts['ssd_fwd']} forward, "
        f"{mamba_counts['ssd_bwd']} backward launches in the mamba2 train "
        f"run; sim_run_batch {sim_res['launches']} launch(es) for the "
        f"[sim] figure grid's {sim_res['rep']['grid_cells']} cells (its "
        f"ms, plain_ms and bound_ms are of the 8 cells held against the "
        f"plain version; grid_ms is the grid's); sim_run_batch_traced "
        f"{durable_res['launches']} launch(es) for [sim_durable]'s traced "
        f"forensics grid of {durable_res['rep']['grid_cells']} cells (ms, "
        f"plain_ms and bound_ms of its 4 cells held against the plain "
        f"version); total "
        f"{time.perf_counter()-t_all:.1f} s")
    for line in dry:                        # the dry run's five checks
        log(line)
    log(f"[done] [mesh] launches (DTensor run): {mesh_counts}")
    log(f"[done] [elastic] launches (the supervised run, replays "
        f"included): {el}")
    for line in roof:                       # the floors beside the steps
        log(line)
    log(card_line())                        # again, beside the results
    log(json.dumps({"kernels": kernels}))
    shutil.rmtree(cache_dir, ignore_errors=True)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
