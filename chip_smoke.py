"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (``pointunet_tpu_torch``): serving, the
``segment`` CLI (reference-exact sliding-window path and ``--fast``),
point-net training and saliency-net training (``train_attention``),
training and serving on a mesh of ranks, at the full BraTS width, and
the accuracy path (both nets trained, the fused path scored), and
fails (non-zero exit, no result line) on any fault. Phases:

1. build: compile the four CUDA kernels from the sources in this checkout
   (one ``nvcc`` each, in parallel), print each one's build seconds and
   ptxas report and the card's name and power limit;
2. kernel: on a 365,000-point cloud drawn by the port's sampler from a
   240x240x155 volume (35% random brain plus an all-voxel tumor ball),
   capture the six cell-window searches of the pyramid (self k=16 and up
   k=1 at levels 0-2) and run each through the KNN kernel (twice) and
   through its plain version: indices must be equal on every row and the
   two launches bit-equal. Each prints its tile plan (tiles, rows staged
   in shared memory, the longest tile's windows in ring chunks) and
   candidates a second beside the bound's. Tie-aware recall of
   the level-0 self search against exact brute force must be >= 0.99
   overall and >= 0.995 on tumor queries. Times come from CUDA events;
3. scatter: on that cloud's pyramid, the sorted scatter kernel at the
   reference's three bars (L0 self C=8, L1 self C=16, L0 pool C=32 with
   unsorted queries, read through their permutation). Each result must
   be within max relative error 1e-5 of the exact f64 ``index_add_``,
   within 1e-6 x max |exact| of its plain version (f32 summation order),
   and bit-equal across two launches; kernel, plain and ``index_add_``
   are timed;
4. window: the same cloud in its own row order with its level-0 self
   neighbours, C=8 (the reference's bar): the windowed scatter kernel
   within 1e-5 max relative error of the exact f64 ``index_add_``, within
   1e-6 x max |exact| of its plain version, bit-equal across two
   launches and under a power-of-two scaling of the cotangents (its
   fixed-point scale follows max |ct|); timed; then one
   ``windowed_gather`` backward with ``POINTUNET_WINDOWED_SCATTER=1``:
   exactly 1 launch, the same bar;
5. serve: write 3 synthetic BraTS cases (4x240x240x155 f32, ellipsoid
   brain) to a temporary inbox and serve them with
   ``pointunet_tpu_torch.cli.serve`` (ROI 192x208x155, 365,000 points,
   bf16). Each must yield a (240, 240, 155) uint8 label volume with
   values in {0, 1, 2, 4}, at most 365,000 labelled voxels, and exactly 6
   KNN kernel launches; then time each stage by the tracer's device
   spans, and again with ``POINTUNET_FASTCONV=pallas``: one request must
   launch the conv kernel exactly 19 times, and its attention mask must
   agree with the cuDNN route's on >= 0.999 of the ROI's voxels;
6. conv: the inputs of the 19 eligible convs of one saliency forward, in
   bf16 at the serve ROI (1,4,160,208,192) and in f32 on one
   (1,4,64,160,160) window, through the conv kernel and its plain
   version, each on the path ``conv_path`` gives it, held to the rule
   restated in ``_want_path`` (printed: bf16 with Cin % 16 == 0 on the
   tensor cores, the head (Cout <= 2) on the narrow-Cout design, the
   coarse levels (W <= 64, not a multiple of 32) on the deep one; f32
   the head on the narrow design's CUDA cores, the rest with Cin % 8 ==
   0 on the tensor cores with 3xTF32 products; the init conv on the CUDA
   cores):
   in bf16 at most one bf16 ulp apart on every element (or within the
   f32 bar where the products cancel below it), in f32 within 1e-5 x
   max |plain| and, with TF32 off, within 2e-5 x max(1, max |F.conv3d|)
   of ``F.conv3d``; bit-equal across two launches; the fused bias
   bit-equal to the conv plus bias. Kernel (20 calls), plain (3) and
   ``F.conv3d`` (20) are timed; f32 shapes print both bounds (3xTF32 on
   the tensor cores, which they are held to, and the CUDA cores');
7. segment: ``cli.segment`` on one synthetic case with
   ``POINTUNET_FASTCONV=pallas``: the f32 sliding-window path (12
   windows) must launch the conv kernel 19 x 12 times and the KNN kernel
   6 times; then the same path on cuDNN, and ``--fast --roi 192 208
   155`` (19 and 6). Each writes a (240, 240, 155) uint8 volume with
   values in {0, 1, 2, 4}; seconds per volume are printed;
8. train: write 4 synthetic BraTS point clouds (~600k labelled points:
   an all-voxel tumor ball plus background) in the prepared-tree layout,
   run ``cli.run_brats`` ``--mode train --n_epoch 1`` on 3 of them
   (validating on the 4th) and ``--mode test`` (a (155, 240, 240, 4)
   probability volume), then 10 steps on one cloud at lr 1e-3: finite
   losses whose last three average below the first, the step split by
   CUDA events (pyramid, forward, backward, optimizer), peak memory, and
   exactly 8 scatter and 6 KNN kernel launches a step. The 8 scatter
   inputs of the first step (bf16 ct) are captured and held to the
   checks of phase 3, with ct widened to f32 and as captured;
9. saliency: stage-1 training at ``brats_saliency_config`` (f32, gate
   stride 1, patch (64,160,160), batch 2, remat, base_filter 16, depth 5)
   on 3 synthetic 4x240x240x155 cases with a labelled tumour ball, loaded
   by ``load_brats_case`` (crop on): 10 steps on one batch at lr 0.01,
   with remat, without it, in bf16 with remat, and with remat and TF32
   convs (PyTorch's default; TF32 is off elsewhere) (the step split by
   CUDA events: forward+loss and backward per micro-batch, optimizer;
   peak memory; one more step under the profiler: busy share, top ops),
   finite losses whose last three average below the first and no kernel
   launch; one step with ``POINTUNET_FASTCONV=pallas`` must
   raise kernel 3's guard; ``fit`` of 5 steps with its evaluation on the
   third case (a dice in [0, 1], a best checkpoint);
   ``cli.train_attention --evaluate`` and ``--predict`` on it, on cuDNN
   and on kernel 3 (exactly 19 launches a sliding window), maps of
   (240, 240, 155, 2) f32 summing to 1 inside the crop box, argmax
   agreement >= 0.999; ``cli.segment --saliency_checkpoint`` (6 KNN
   launches);
10. pancreas: the reference bench's Pancreas contract (1 CT channel, 2
   classes, 180,000 points, no ROI): two synthetic CTs in HU
   (256x256x160 and 256x256x144, a body oval with an organ ellipsoid
   labelled 1) through ``cli.data_prepare_pancreas`` (8 loops a CT),
   ``cli.run_pancreas --mode train --n_epoch 1 --fold 1`` (8 steps and
   8 validation loops, at 4 KNN launches a pyramid and 5 sorted scatters
   a step, as ``knn_searches`` and ``sorted_scatters`` derive them from
   the config) and ``--mode test`` (a (160, 256, 256, 2) volume whose
   180,000 filled voxels sum to 1 within 1e-3), ``cli.gen_segmentation``
   and ``cli.evaluation`` for Pancreas (a Dice in [0, 1]);
   ``cli.serve --dataset pancreas`` on both CTs (two pipes, labels in
   {0, 1}), one request's warm latency, stage split, busy share and peak
   memory, and with ``POINTUNET_FASTCONV=pallas`` (19 conv launches; each
   of the 19 convs, the 1 -> 16 init conv among them, held to phase 6's
   bf16 bars); then, on one training loop, the 4 searches held to phase
   2's bars (recall >= 0.99), the pyramid and its brute-force level-2
   searches timed, the 5 scatter inputs of one train step to
   phase 3's, and 10 timed steps (split, peak memory, finite descending
   losses) and one more under the profiler (busy share);
11. bridge: checkpoints of the JAX package. Seeded full-width weights of
   both nets written as exported train states of the JAX package (the
   layout ``export_jax_checkpoint.py`` writes, at step 7 with non-zero
   moments) are restored by ``cli.serve --once --saliency_checkpoint
   --pointseg_checkpoint`` on one case, on cuDNN and with
   ``POINTUNET_FASTCONV=pallas``: labels bit-equal to the same weights
   loaded directly, 6 KNN launches (and 19 conv launches); ``cli.run_brats
   --mode train`` resumes an exported point-net state (its Adam moments
   restored exactly) for 2 steps and 1 validation cloud and must end at
   step 9 with 8 scatter launches a step; the committed checkpoints that
   JAX wrote (``tests/fixtures/jax_export``) are restored in f32 and held
   to their recorded JAX logits (point net within 1e-4 x max(1, max
   |logit|), batch-norm UNet3D within atol 3e-4 + rtol 1e-4); the native
   host library (``native.py``) is built, its grid subsampling of a
   180,000-voxel cloud held equal to the numpy path, its ``knn_batch``
   to brute force (tie-aware recall 1.0), both timed on the host;
12. mesh: the multi-device layer (``pointunet_tpu_torch/parallel``) with
   several ranks sharing this one card over gloo (NCCL takes one rank a
   card; the backend is printed; ranks sharing a card measure no
   scaling). (a) 4 ranks, ``MeshConfig(data=2, point=2)``: the Train
   config on a batch of 2 synthetic clouds, 3 steps, the point net's
   activations sharded along the point axis (each point rank runs its
   slab of every level's rows, forward and backward); each rank's first
   pyramid (``build_pyramid_sharded``: kernel 1 on query slabs of levels
   0 and 1, level 2 whole) bit-equal to the one-card ``build_pyramid`` of
   its cloud, exactly 6 KNN and 5 scatter launches a step on every rank
   (``sorted_scatters`` of the rank's slabs: the level-2 gathers and the
   level-1 pool fall under kernel 2's gate), the first loss within 5e-3
   relative of the one-card step of the same batch (bf16), the
   parameters bit-equal across ranks after every step; every rank holds
   its slab searches to kernel 1's plain version, rank 0 its step's
   scatters (of query slabs) to kernel 2's (phases 2 and 3's bars). (d)
   the same 4 ranks, ``MeshConfig(data=1, point=4)``: the first cloud
   alone (batch 1), 2 steps: the first loss within 5e-3 relative of the
   one-card batch-1 step, parameters bit-equal across ranks, 6 KNN and 5
   scatter launches a step a rank, every rank's searches and step
   scatters held to the plain versions, each rank's peak memory at most
   half the one-card batch-1 step's (measured in this run), each rank's
   forward and backward ms. (b) 2 ranks,
   ``MeshConfig(data=2)``: ``segment_batch_device`` of 2 seeded volumes
   at the Serve config, on cuDNN and with ``POINTUNET_FASTCONV=pallas``:
   labels on every rank bit-equal to the one-card loop, 6 KNN (and 19
   conv) launches a rank. (c) the same 4 ranks, ``MeshConfig(point=4)``:
   ``knn_point_sharded`` of phase 2's cloud in 4 x-slabs (one KNN launch
   a rank, equal to the plain version): tie-aware recall >= 0.99 against
   exact search, some neighbours in another slab. A failing rank fails
   the phase;
13. routes: the conv routes of ``models/fastconv.py`` and the KNN
   entries. (a) the Serve contract under each route of ``ROUTES``
   (``POINTUNET_FASTCONV`` unset, ``fold1``, ``k9``, ``all``, ``pallas``,
   and ``pallas`` with ``POINTUNET_FUSED_UPSAMPLE=1``): the attention
   stage (mean of 3 after a warm-up), one request's launches (19 of
   kernel 3 under ``pallas``, 15 with the fused upsample, 0 otherwise),
   the max |logit| gap and the label voxels differing from the unset
   route's, labels in {0, 1, 2, 4}; (b) every conv of one forward that a
   mode folds (the 6 gate convs and the 1x1x1s) on ``F.conv3d`` and on
   the fold, at the bf16 ROI and on one f32 window (gate at stride 1),
   and the 19 3x3x3 convs of the bf16 ROI under ``all``: ms, bound and
   the gap (bf16 with one slice: one bf16 ulp or 1e-5 x max|F.conv3d|;
   bf16 3x3x3: 2^-6 x max|F.conv3d|; f32: 2e-5 x max(1, max|F.conv3d|));
   (c) ``segment`` with ``pallas`` (kernel 3 and the fold) and ``fold1``,
   its seconds and its labels' agreement with phase 7's runs; (d) the
   Pancreas attention stage under unset, ``fold1`` and ``pallas``; (e)
   the f32 saliency train step (remat, batch 2 of (64,160,160)) unset
   and under ``fold1``: step ms, peak memory, first losses within rtol
   1e-3; (f) the 4 UpsampleConvs of the bf16 ROI forward fused and as
   repeat plus ``F.conv3d`` (bar: 2^-6 x max|F.conv3d|); (g) the
   standalone ``knn_pallas`` on phase 2's cloud with support and queries
   shuffled apart: one kernel-1 launch, rows equal to the plain
   version's, phase 2's recall bars, each query's nearest its own point.
   Each line ends with the card's name and power limit;
14. remaining: what the last slice of the port added. (a) the Block64
   configuration (``block64_pointseg_config(use_bfloat16=True)``: 180,000
   points, the BraTS net, its class counts) on a cloud that
   ``cli/data_prepare_blocks.py:block_to_points`` makes from the 64^3
   block of phase 8's tumour volumes (``_brats_vols``) at
   ``BLOCK64_ORIGIN``: its 4 cell-window searches held to kernel 1's
   plain version (phase 2's bars), one warm-up step whose 5 scatter
   inputs are held to kernel 2's (phase 3's), then 5 timed steps with
   ``PointSegTrainer`` (split, peak memory, finite losses whose last
   three average below the first), exactly ``knn_searches`` (4) KNN and
   ``sorted_scatters`` (5) scatter launches a step; (b) ``ops.knn``'s
   ``knn_with_distances`` (16,384 support points and queries, k=16) and
   ``knn_batch`` (2 such clouds) on the card against the same functions
   on the CPU: tie-aware recall 1.0, d^2 within 1e-6 x max d^2 + 1e-7,
   both timed; (c) ``core.debug.profile_trace`` around one warm Serve
   request: its Chrome trace holds the request's CUDA kernels, kernel
   1's among them once a launch (6), and the 5 kernels that took the
   most device time are printed;
15. accuracy: ``cli/accuracy.py`` (the reference bench's accuracy
   presets) on each dataset's reduced task, (96, 96, 64) seeded synthetic
   volumes at 65,536 points, with the reference's 400 saliency and 800
   point steps (the saliency net trained in f32, run in bf16 in the
   fused path): every step's loss finite and the mean of the last 50
   below the first; kernels 1 and 2 launched by every point step (as
   ``knn_searches`` and ``sorted_scatters`` derive them), kernel 1 by
   each request's pyramid and nothing else anywhere (kernel 3 not once);
   the QDA control equal to the value the CPU test computes with
   bench.py's own functions (``ACC_QDA``), the raw mean Dice at least
   that + 0.3, labels in {0, 1, 2, 4} or {0, 1}; kernels 1 and 2 at
   these shapes against their plain versions (the searches of the first
   training cloud's pyramid, the scatters of one f32 point step on it,
   at phases 2 and 3's bars); the evaluation again under
   ``POINTUNET_FASTCONV=pallas`` (19 kernel-3 launches a request), its
   labels' agreement with the default route's and the Dice difference
   printed, the 19 convs of one request each held to kernel 3's plain
   version at phase 6's bars and to ``F.conv3d`` (one bf16 ulp or 1e-5 x
   max|F.conv3d|), and each held-out volume's attention masks under the
   two routes and their labels where both clouds hold a point printed;
   the trained f32 point net once more in bf16 on the held-out volumes'
   clouds, the argmax agreement printed; then each dataset's first
   ``ACC_REPEAT_STEPS`` (5) saliency steps, in the stage's settings
   (TF32 convs, ``cudnn.deterministic``), and its first 5 point steps,
   each run twice from one state: the parameters must be bit-equal and
   kernel 2 launch ``sorted_scatters`` (3) times a step; last, a BraTS
   point step (365,000 points, bf16) profiled in turns (old, new, new,
   old) with its gathers below kernel 2's gate summed by ``index_add_``
   (as before ``gather.row_sum``) and by ``row_sum``: the device busy ms
   of each, 8 kernel-2 launches a step under both.

Each phase prints its seconds (``[time]`` lines, and all of them on one
line after phase 15).

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after. Before the last line it prints the card
(``nvidia-smi``) and one JSON object describing the four kernels (phase
13's results under kernel 3's ``routes`` and kernel 1's ``knn_pallas``,
phase 14's under kernel 1's ``block64``, ``knn_plain`` and
``profile_trace`` and kernel 2's ``block64``, phase 15's under kernel 1's
``accuracy``, its step's scatters under kernel 2's and its convs under
kernel 3's); the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import glob
import gzip
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_POINTS = 365_000
K = 16
RATIOS = (4, 4, 4, 4, 2)
VOLUME = (240, 240, 155)
ROI = (192, 208, 155)
N_CASES = 3
LAUNCHES_PER_VOLUME = 6        # self + up search at levels 0, 1, 2
SCATTERS_PER_STEP = 8          # L0 self x2, L0 pool, L1 self x2, L1 pool,
                               # L2 self x2 (the L2 pool is under MIN_ROWS)
CONVS_PER_FORWARD = 19         # eligible 3x3x3 convs of a saliency forward
SEGMENT_WINDOWS = 12           # (64,160,160) windows of a 155x240x240 volume
WINDOW = (64, 160, 160)        # the f32 path's saliency window (Z, Y, X)
WINDOW_C = 8                   # channels of the windowed-scatter bar
RECALL_QUERIES = 65_536
TRAIN_STEPS = 10
SALIENCY_STEPS = 10            # saliency train steps a variant
SALIENCY_TOP_OPS = 8           # ops printed from a profiled saliency step
N_CLOUDS = 4                   # run_brats: 3 to train on, 1 to validate
CLOUD_POINTS = 600_000         # labelled points of a prepared cloud
# the Pancreas contract (bench.py:bench_e2e_pancreas): CTs (X, Y, Z) of
# two slice counts, 180,000 points; fold 1 validates on 0001 (1 % 4)
PANCREAS_CTS = {"0001": (256, 256, 160), "0002": (256, 256, 144)}
PANCREAS_POINTS = 180_000
PANCREAS_FOLD = 1
PANCREAS_VAL_ID = "0001"
# phase 11: the committed checkpoints JAX wrote, the exported train
# states' step and the steps resumed from it, the native library's cloud
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "jax_export")
RESUME_STEP = 7
RESUME_STEPS = 2
NATIVE_POINTS = PANCREAS_POINTS
NATIVE_QUERIES = 4096          # knn_batch queries held to brute force
MESH_STEPS = 3                 # phase 12: train steps on the dp2 x sp2 mesh
MESH_SEEDS = (5, 6)            # its batch: 2 synthetic clouds
MESH_LOSS_BAR = 5e-3           # its first loss against the one-card step's
MESH_SP4_STEPS = 2             # phase 12 (d): steps on the sp4 mesh, batch 1
MESH_SP4_PEAK = 0.5            # (d): a rank's peak over the one-card step's
MESH_RANK_TIMEOUT_S = 300      # a phase-12 launch whose ranks take longer fails
# phase 13: the conv routes, (name, POINTUNET_FASTCONV, POINTUNET_FUSED_UPSAMPLE)
# (None: unset)
ROUTES = (("unset", None, None), ("fold1", "fold1", None), ("k9", "k9", None),
          ("all", "all", None), ("pallas", "pallas", None),
          ("pallas+fused_upsample", "pallas", "1"))
ROUTE_REPEATS = 3              # attention stages timed a route (after a warm-up)
ROUTE_STEPS = 3                # timed saliency train steps a route
CONV_REPEATS = 5               # timed calls of a conv a route
PANCREAS_SHAPE = (256, 256, 160)
UPSAMPLE_CONVS = 4             # the saliency net's UpsampleConvs (3x3x3)
# phase 14: the (x, y, z) corner of the 64^3 block of _brats_vols that
# holds the tumour ball (radius 24 about (140, 100, 80)); timed Block64
# steps after a warm-up; the clouds of (b); the kernels printed from (c)
BLOCK64_ORIGIN = (108, 68, 48)
BLOCK64_STEPS = 5
KNN_POINTS = 16_384            # support points and queries of a cloud
KNN_GRID = 32                  # (b)'s clouds: voxel centres of a 32^3 grid
KNN_BATCH = 2
TRACE_TOP_OPS = 5
# phase 15: the accuracy path's reduced task at the reference's default
# steps; its QDA controls, which tests/test_torch_accuracy.py computes
# with bench.py's own functions on the same seeds (4 decimals, as the
# line prints them); the raw mean Dice must clear them by ACC_MARGIN; the
# mean loss of the last ACC_LOSS_TAIL steps must be below the first
ACC_SALIENCY_STEPS = 400
ACC_POINTSEG_STEPS = 800
ACC_QDA = {"brats": ("gmm_baseline_dice_mean", 0.4981),
           "pancreas": ("gmm_baseline_dice", 0.0)}
ACC_MARGIN = 0.3
ACC_LOSS_TAIL = 50
ACC_REQUESTS = 3               # an evaluation: a warm-up and 2 volumes
ACC_REPEAT_STEPS = 5           # steps of each net run twice from one state
BUSY_ROUNDS = 1                # rounds of (old, new, new, old) profiled steps
# the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s,
# f32 operations/s outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_OPS_S = 989e12
TF32_OPS_S = 495e12
# f32-accurate products on the tensor cores take three TF32 products
# (3xTF32): the least time for f32 conv work is 3 x ops / 495 TFLOP/s
F32_TC_OPS_S = TF32_OPS_S / 3


def _full_f32() -> None:
    """f32 comparisons hold full f32: cuDNN would run f32 convs in TF32
    (F.conv3d is the f32 bar of phase 6) and matmuls could. Phase 12's
    ranks, fresh processes, set it again."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, repeats: int) -> float:
    """Mean ms per call over ``repeats`` calls after one warm-up, by CUDA
    events on the current stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase_build() -> tuple:
    from pointunet_tpu_torch.ops import (
        conv_cuda,
        cuda_build,
        knn_cuda,
        scatter_sorted,
        scatter_window,
    )

    modules = (knn_cuda, scatter_sorted, conv_cuda, scatter_window)
    t0 = time.perf_counter()
    seconds = {}
    sos = cuda_build.build_all([m.SOURCE for m in modules], seconds)
    for m in modules:
        m.load_library()
    log(f"[build] {', '.join(so.name for so in sos)} built/loaded in "
        f"{time.perf_counter() - t0:.1f} s; nvcc seconds "
        + ", ".join(f"{name} {sec:.1f}" for name, sec in seconds.items()))
    for so in sos:
        report = so.with_suffix(".log")
        if report.exists():              # present when this run compiled
            text = report.read_text()
            regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
            smem = [int(w) for w in re.findall(r"(\d+) bytes smem", text)]
            log(f"[build] ptxas {so.stem}: {len(regs)} kernel instances, at "
                f"most {max(regs, default=0)} registers a thread, "
                f"{max(smem, default=0)} bytes of static smem, {spills} "
                f"bytes of spills")
            if so.stem.startswith("knn_cell_window"):
                for entry in text.split("Compiling entry function")[1:]:
                    name = re.search(r"kernelILi(\d+)E", entry)
                    used = re.search(r"Used (\d+) registers", entry)
                    spill = re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", entry)
                    if name and used and spill:
                        log(f"[build] ptxas knn_cell_window k={name[1]}: "
                            f"{used[1]} registers a thread, spill stores "
                            f"{spill[1]} B, spill loads {spill[2]} B (its "
                            f"shared memory is dynamic: phase 2 prints it)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[build] card: {card}")
    return card, seconds


def bound_ms(nbytes: float, ops: float, rate: float = F32_OPS_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their type's rate, in ms."""
    return max(nbytes / HBM_BYTES_S, ops / rate) * 1e3


def bound_by(nbytes: float, ops: float, rate: float = F32_OPS_S) -> str:
    return "bytes" if nbytes / HBM_BYTES_S >= ops / rate else "operations"


@contextlib.contextmanager
def _env(name: str, value):
    """``os.environ[name] = value`` within (None: unset), restored after."""
    old = os.environ.get(name)

    def put(v):
        if v is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = v

    put(value)
    try:
        yield
    finally:
        put(old)


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from pointunet_tpu_torch.ops import launches

    launches.reset_launches()


def read_launches() -> dict:
    """{kernel name: launches since the last reset}."""
    from pointunet_tpu_torch.ops import launches

    return launches.read_launches()


def _kernel_cloud(dev, seed=0):
    """The cloud of tests/test_tpu_kernels.py, drawn by the port's sampler:
    (xyz (N, 3), tumor flag per point (N,))."""
    from pointunet_tpu_torch.ops.sampling import sample_cloud_device

    rng = np.random.default_rng(seed)
    mods = rng.standard_normal((1,) + VOLUME).astype(np.float32)
    brain = rng.uniform(size=VOLUME) < 0.35
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME), indexing="ij")
    d2 = (xx - 120) ** 2 + (yy - 110) ** 2 + ((zz - 70) * 1.5) ** 2
    tumor = d2 < 30 ** 2                       # ~75k voxels, all kept
    brain |= tumor
    mods *= brain[None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    tumor_d = torch.from_numpy(tumor).to(dev)
    cloud = sample_cloud_device(
        torch.from_numpy(mods).to(dev), tumor_d.to(torch.uint8), gen, N_POINTS
    )
    o = cloud.xyz_origin.long()
    return cloud.xyz, tumor_d[o[:, 0], o[:, 1], o[:, 2]]


def _tie_aware_recall(sp, qp, got, k, chunk=512):
    """Per-query fraction of returned neighbours whose d^2 is within the
    exact k-th d^2 (+1e-9), by brute force over all of ``sp``."""
    hits = []
    for q0 in range(0, qp.shape[0], chunk):
        q = qp[q0:q0 + chunk]
        diff = q[:, None, :] - sp[None, :, :]
        d2 = (diff * diff).sum(-1)                               # (Q, Ns)
        kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
        dg = d2.gather(1, got[q0:q0 + chunk].long())
        hits.append((dg <= kth + 1e-9).float().mean(1))
    return torch.cat(hits)


def knn_searches(cfg) -> int:
    """Kernel-1 launches of one pyramid: a self search (k) and a 1-NN up
    search at every level of more than ``GRID_THRESHOLD`` points."""
    from pointunet_tpu_torch.ops.pyramid import GRID_THRESHOLD

    sizes = cfg.level_sizes
    return 2 * sum(sizes[i] > GRID_THRESHOLD
                   for i in range(len(cfg.sub_sampling_ratio)))


def sorted_scatters(cfg, parts: int = 1, part: int = 0) -> int:
    """Kernel-2 launches of one train step of a cloud on rank ``part`` of
    a point group of ``parts``: the backward of each sorted gather that
    passes the gate (``MIN_ROWS`` flat rows and a support of more than
    ``GRID_THRESHOLD`` points): two self gathers (m_i x k rows) and one
    pool gather (m_(i+1) x k rows) at each level i, where m_i is the
    rank's slab of level i's n_i rows (all of them on one card)."""
    from pointunet_tpu_torch.ops.pyramid import GRID_THRESHOLD
    from pointunet_tpu_torch.ops.pyramid_sharded import slab_sizes
    from pointunet_tpu_torch.ops.scatter_sorted import MIN_ROWS

    sizes, k = cfg.level_sizes, cfg.k_n
    m = [slab_sizes(n, parts)[part] for n in sizes]
    return sum(
        2 * (m[i] * k >= MIN_ROWS) + (m[i + 1] * k >= MIN_ROWS)
        for i in range(len(cfg.sub_sampling_ratio))
        if sizes[i] > GRID_THRESHOLD
    )


def _search_cases(xyz, n_searches: int, tag: str):
    """Builds the pyramid of ``xyz`` with its cell-window searches
    captured, and runs each through the KNN kernel (twice) and its plain
    version: rows must be equal and the launches bit-equal. (one dict a
    search, the pyramid)."""
    from pointunet_tpu_torch.ops import knn_cuda, pyramid

    calls = []
    search = pyramid._search_sorted

    def record(*args):
        calls.append(args)
        return search(*args)

    pyramid._search_sorted = record
    try:
        pyr = pyramid.build_pyramid(xyz, K, RATIOS)
    finally:
        pyramid._search_sorted = search
    torch.cuda.synchronize()
    if len(calls) != n_searches:
        raise AssertionError(
            f"expected {n_searches} cell-window searches, got {len(calls)}")

    lib = knn_cuda.load_library()
    lib.knn_cell_window_smem_bytes.argtypes = [ctypes.c_int]
    shapes = []
    for n, (sp, s_ids, qp, qc3, k, r) in enumerate(calls):
        level, kind = n // 2, ("self", "up")[n % 2]
        cs = knn_cuda.cell_prefix_sums(s_ids, r)
        qc = qc3.to(torch.int32).contiguous()
        sp, qp = sp.contiguous(), qp.contiguous()
        got = knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r)
        again = knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r)
        want = knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r)
        torch.cuda.synchronize()
        bad = int((got != want).any(1).sum())
        bitwise = torch.equal(got, again)
        err = int((got.long() - want.long()).abs().max())
        rel = err / max(1, int(want.abs().max()))
        ms = cuda_ms(lambda: knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r), 20)
        plain_ms = cuda_ms(
            lambda: knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r), 3
        )
        # bound: inputs read once (sp, cell_start, qp, qc), output written
        # once; operations: d^2 (3 sub, 3 mul, 2 add) of every candidate
        # in this run's 27-cell spans
        ns, nq = sp.shape[0], qp.shape[0]
        nbytes = 4 * (3 * ns + cs.numel() + 6 * nq + nq * k)
        cand = int(knn_cuda._spans(qc, cs, r)[1].sum())
        b_ms = bound_ms(nbytes, 8 * cand)
        by = bound_by(nbytes, 8 * cand)
        # the kernel's tile plan: tiles, rows staged in shared memory, the
        # longest tile's windows in ring chunks
        win = knn_cuda.tile_windows_plain(qc, cs, r)
        staged = (win[..., 1] - win[..., 0]).sum(1)
        chunks = int(-(-staged.max() // knn_cuda.CHUNK[k]))
        log(f"[{tag}] L{level} {kind} k={k} Ns={ns} Nq={nq} r={r}: rows "
            f"differing {bad}, bit-equal relaunch {bitwise}, kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by} "
            f"({nbytes} B, {cand} candidates); {win.shape[0]} tiles, "
            f"{int(staged.sum())} rows staged ({12 * int(staged.sum())} B), "
            f"longest tile {chunks} chunks of {knn_cuda.CHUNK[k]} rows, "
            f"{lib.knn_cell_window_smem_bytes(k)} B of shared memory a "
            f"block; {cand / ms * 1e3:.4e} candidates/s against "
            f"{cand / b_ms * 1e3:.4e} at the bound")
        if bad or not bitwise:
            raise AssertionError(
                f"kernel disagrees with its plain version on {bad} rows "
                f"or across launches ({bitwise}) (L{level} {kind})"
            )
        shapes.append({
            "search": f"L{level} {kind} k={k} Ns={ns} Nq={nq}",
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "max_rel_err": rel, "bound_ms": b_ms, "bound_by": by,
            "candidates": cand, "tiles": win.shape[0],
            "staged_rows": int(staged.sum()), "longest_tile_chunks": chunks,
        })
    log(f"[{tag}] the {n_searches} searches: kernel "
        f"{sum(s['ms'] for s in shapes):.4f} ms, bound "
        f"{sum(s['bound_ms'] for s in shapes):.4f} ms, plain "
        f"{sum(s['plain_ms'] for s in shapes):.4f} ms")
    return shapes, pyr


def _recall(pyr, flags, dev, tag: str, flagged_name: str):
    """Tie-aware recall of the level-0 self search against exact brute
    force on a random subset of queries: (overall, over the queries whose
    ``flags`` (in the cloud's own row order) are set)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    pts = pyr.xyz[0]
    sel = torch.randperm(pts.shape[0], generator=gen, device=dev)[:RECALL_QUERIES]
    hit = _tie_aware_recall(pts, pts[sel], pyr.neigh_idx[0][sel], K)
    fmask = flags[pyr.order.long()][sel].float()
    overall = float(hit.mean())
    flagged = float((hit * fmask).sum() / fmask.sum().clamp(min=1))
    log(f"[{tag}] tie-aware recall vs exact ({sel.numel()} queries): "
        f"overall {overall:.6f}, {flagged_name} {flagged:.6f}")
    return overall, flagged


def phase_kernel(dev):
    xyz, tumor = _kernel_cloud(dev)
    log(f"[kernel] cloud {tuple(xyz.shape)}, tumor points "
        f"{int(tumor.sum())}")

    # the pyramid's six cell-window searches at their real shapes
    shapes, pyr = _search_cases(xyz, LAUNCHES_PER_VOLUME, "kernel")
    overall, tum = _recall(pyr, tumor, dev, "kernel", "tumor")
    if overall < 0.99 or tum < 0.995:
        raise AssertionError(f"recall below the bar: {overall}, {tum}")
    return {
        "name": "knn_cell_window",
        "route": "cuda",
        "source": "pointunet_tpu_torch/csrc/knn_cell_window.cu",
        "replaces": "pointunet_tpu/ops/knn_pallas.py:208",
        "shape": shapes[0]["search"],
        "ms": shapes[0]["ms"],
        "plain_ms": shapes[0]["plain_ms"],
        "bound_ms": shapes[0]["bound_ms"],
        "bound_by": shapes[0]["bound_by"],
        "library_ms": None,             # no one PyTorch call does this
        "ms_6_searches": sum(s["ms"] for s in shapes),
        "bound_ms_6_searches": sum(s["bound_ms"] for s in shapes),
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_rel_err": max(s["max_rel_err"] for s in shapes),
        "recall_overall": overall,
        "recall_tumor": tum,
        "shapes": shapes,
    }, pyr


def _scatter_case(name: str, args) -> dict:
    """One sorted-scatter input through the kernel (twice), its plain
    version and the exact f64 ``index_add_``; times and bound. ``args``
    are ``scatter_sorted``'s: (ct, idx, s_ids, qcs, k, r[, q_perm])."""
    from pointunet_tpu_torch.ops import scatter_sorted as ss

    ct, idx, s_ids, qcs, k, r = args[:6]
    q_perm = args[6] if len(args) > 6 else None
    ns, (nqk, c) = s_ids.shape[0], ct.shape
    # idx in ct's own row order, for the yardsticks (the same function)
    idx_ct = idx
    if q_perm is not None:
        idx_ct = torch.empty_like(idx).view(-1, k)
        idx_ct[q_perm.long()] = idx.view(-1, k)
        idx_ct = idx_ct.reshape(-1)
    got = ss.scatter_sorted(*args)
    again = ss.scatter_sorted(*args)
    plain = ss.scatter_sorted_plain(*args)
    exact = torch.zeros((ns, c), dtype=torch.float64, device=ct.device)
    exact.index_add_(0, idx_ct.long(), ct.double())
    torch.cuda.synchronize()
    scale = float(exact.abs().max().clamp(min=1e-6))
    rel = float((got.double() - exact).abs().max()) / scale
    plain_err = float((got - plain).abs().max())
    bitwise = torch.equal(got, again)
    del exact, plain, again
    ms = cuda_ms(lambda: ss.scatter_sorted(*args), 20)
    plain_ms = cuda_ms(lambda: ss.scatter_sorted_plain(*args), 3)
    # index_add_ sums in its operand's type: bf16 ct is widened first,
    # outside the timed call
    ct32 = ct.float()
    library_ms = cuda_ms(
        lambda: torch.zeros((ns, c), device=ct.device).index_add_(
            0, idx_ct, ct32),
        20,
    )
    del ct32
    # bound: ct (in its type), idx, the permutation, the support cells and
    # the query prefix sums read once, grad written once; one f32 add per
    # ct element
    nbytes = (ct.element_size() * nqk * c
              + 4 * (nqk + ns + qcs.numel() + ns * c)
              + (0 if q_perm is None else 4 * q_perm.numel()))
    b_ms, by = bound_ms(nbytes, nqk * c), bound_by(nbytes, nqk * c)
    log(f"[scatter] {name}: Ns={ns} rows={nqk} C={c} r={r} ct "
        f"{str(ct.dtype)[6:]}{' via q_perm' if q_perm is not None else ''}: "
        f"max rel err {rel:.3e} vs exact, max |kernel - plain| "
        f"{plain_err:.3e}, bit-equal relaunch {bitwise}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {by}")
    # the plain version sums the same rows in f32 in another order
    if not rel < 1e-5 or not plain_err <= 1e-6 * scale or not bitwise:
        raise AssertionError(
            f"sorted scatter {name}: max rel err {rel:.3e}, max |kernel - "
            f"plain| {plain_err:.3e} (bound {1e-6 * scale:.3e}), bit-equal "
            f"relaunch {bitwise}"
        )
    return {"case": name, "ns": ns, "rows": nqk, "c": c,
            "dtype": str(ct.dtype)[6:], "q_perm": q_perm is not None,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": by, "max_rel_err": rel,
            "max_abs_err_plain": plain_err}


@contextlib.contextmanager
def _capture():
    """Records the arguments of every ``scatter_sorted`` call made within
    (and still makes the call)."""
    from pointunet_tpu_torch.ops import scatter_sorted as ss

    calls, wrapper = [], ss.scatter_sorted

    def record(*args):
        calls.append(args)
        return wrapper(*args)

    ss.scatter_sorted = record
    try:
        yield calls
    finally:
        ss.scatter_sorted = wrapper


def phase_scatter(dev, pyr) -> list:
    from pointunet_tpu_torch.models.randlanet import search_grid
    from pointunet_tpu_torch.ops import scatter_sorted as ss

    lo, span, r0 = search_grid(pyr.xyz[0][None])
    lo, span = lo[0], span[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    # the reference's bars (tests/test_tpu_kernels.py:165-169)
    for name, level, sup, q, idx, c, q_sorted in (
        ("bar L0 self", 0, pyr.xyz[0], pyr.xyz[0], pyr.neigh_idx[0], 8, True),
        ("bar L1 self", 1, pyr.xyz[1], pyr.xyz[1], pyr.neigh_idx[1], 16, True),
        ("bar L0 pool", 0, pyr.xyz[0], pyr.xyz[1], pyr.sub_idx[0], 32, False),
    ):
        ct = torch.randn(idx.shape + (c,), generator=gen, device=dev)
        with _capture() as calls:
            ss.scatter_add_sorted(ct, idx, sup, q, lo, span, r0, level,
                                  q_sorted)
        cases.append(_scatter_case(name, calls[0]))
    return cases


def phase_window(dev, pyr) -> dict:
    """Kernel 4 at the reference's bar: the cloud in its own row order,
    its level-0 self neighbours as support ids, C = 8."""
    from pointunet_tpu_torch.ops import scatter_window as sw
    from pointunet_tpu_torch.ops.knn_window import _grid_resolution

    order = pyr.order.long()
    n = order.numel()
    xyz = torch.empty_like(pyr.xyz[0])
    xyz[order] = pyr.xyz[0]
    idx = torch.empty((n, K), dtype=torch.int32, device=dev)
    idx[order] = order[pyr.neigh_idx[0].long()].to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(3)
    ct = torch.randn((n, K, WINDOW_C), generator=gen, device=dev)
    exact = torch.zeros((n, WINDOW_C), dtype=torch.float64, device=dev)
    exact.index_add_(0, idx.reshape(-1).long(),
                     ct.reshape(-1, WINDOW_C).double())
    scale = float(exact.abs().max().clamp(min=1e-6))

    r = _grid_resolution(n, 1.8)
    plan = sw._plan(ct, idx, xyz, xyz, r, sw._reverse_window_rows(n, n, K, r))
    inv = plan.inv.long()
    got = sw.windowed_scatter(plan, n)
    again = sw.windowed_scatter(plan, n)
    plain = sw.windowed_scatter_plain(plan, n)
    torch.cuda.synchronize()
    rel = float((got[inv].double() - exact).abs().max()) / scale
    plain_err = float((got - plain).abs().max())
    bitwise = torch.equal(got, again)
    # the fixed-point scale follows max |ct|: a power-of-two scaling of
    # the cotangents scales the result exactly
    scaled = all(
        torch.equal(sw.windowed_scatter(
            sw.Plan(plan.ct * 2.0 ** e, *plan[1:]), n), got * 2.0 ** e)
        for e in (40, -40))
    del again, plain
    ms = cuda_ms(lambda: sw.windowed_scatter(plan, n), 20)
    plain_ms = cuda_ms(lambda: sw.windowed_scatter_plain(plan, n), 3)
    flat_idx, flat_ct = idx.reshape(-1), ct.reshape(-1, WINDOW_C)
    library_ms = cuda_ms(
        lambda: torch.zeros((n, WINDOW_C), device=dev).index_add_(
            0, flat_idx, flat_ct),
        20,
    )
    add_ms = cuda_ms(
        lambda: sw.windowed_scatter_add(ct, idx, xyz, xyz, n), 5
    )
    # bound: the plan's inputs (ct, idx, inv, starts, thresholds) read
    # once, the sorted gradient written once; one f32 add per ct element
    nqk, nt = n * K, plan.qw0.shape[0]
    nbytes = 4 * (nqk * WINDOW_C + nqk + n + 2 * nt * 9 + n * WINDOW_C)
    ops = nqk * WINDOW_C
    b_ms, by = bound_ms(nbytes, ops), bound_by(nbytes, ops)
    log(f"[window] Ns={n} rows={nqk} C={WINDOW_C} r={r} wqk={plan.wqk}: max "
        f"rel err {rel:.3e} vs exact, max |kernel - plain| "
        f"{plain_err:.3e}, bit-equal relaunch {bitwise}, exact under "
        f"scaling by 2^+-40 {scaled}; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms by {by}; windowed_scatter_add with its plan "
        f"{add_ms:.4f} ms")
    if (not rel < 1e-5 or not plain_err <= 1e-6 * scale or not bitwise
            or not scaled):
        raise AssertionError(
            f"windowed scatter: max rel err {rel:.3e}, max |kernel - plain| "
            f"{plain_err:.3e} (bound {1e-6 * scale:.3e}), bit-equal "
            f"relaunch {bitwise}, exact under scaling {scaled}"
        )

    # its entry point: one gather backward with the kernel switched on
    table = torch.zeros((n, WINDOW_C), device=dev, requires_grad=True)
    with _env("POINTUNET_WINDOWED_SCATTER", "1"):
        reset_launches()
        sw.windowed_gather(table, idx, xyz, xyz).backward(ct)
        torch.cuda.synchronize()
        counts = read_launches()
    launches = counts["windowed_scatter"]
    grad_rel = float((table.grad.double() - exact).abs().max()) / scale
    log(f"[window] windowed_gather backward: {launches} kernel launch, max "
        f"rel err {grad_rel:.3e} vs exact")
    if launches != 1 or not grad_rel < 1e-5:
        raise AssertionError(
            f"windowed_gather backward: {launches} launches, max rel err "
            f"{grad_rel:.3e}"
        )
    return {
        "name": "windowed_scatter",
        "route": "cuda",
        "source": "pointunet_tpu_torch/csrc/scatter_window.cu",
        "replaces": "pointunet_tpu/ops/scatter_window.py:123",
        "launches": launches,
        "shape": f"L0 self Ns={n} rows={nqk} C={WINDOW_C}",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
        "max_abs_err": plain_err,
        "max_rel_err": max(rel, grad_rel),
        "windowed_scatter_add_ms": add_ms,
    }, counts


def _step_cases(captured, r0, expected=SCATTERS_PER_STEP) -> list:
    """The checks of phase 3 on the scatter inputs of one train step: each
    with ct widened to f32 and with ct as the step gave it (bf16). A pool
    gather's queries come through their permutation (``q_perm``)."""
    if len(captured) != expected:
        raise AssertionError(
            f"expected {expected} sorted scatters in a train step, "
            f"got {len(captured)}"
        )
    grids = [((r0 - 1) >> lvl) + 1 for lvl in range(3)]
    cases = []
    for args in captured:
        ct, r = args[0], args[5]
        q_perm = args[6] if len(args) > 6 else None
        kind = "self" if q_perm is None else "pool"
        name = f"step L{grids.index(r)} {kind}"
        cases.append(_scatter_case(name, (ct.float(),) + tuple(args[1:])))
        if ct.dtype != torch.float32:
            cases.append(_scatter_case(f"{name} {str(ct.dtype)[6:]}", args))
    for dtype in sorted({c["dtype"] for c in cases}):
        some = [c for c in cases if c["dtype"] == dtype]
        log(f"[scatter] train step, ct {dtype}: {len(some)} scatters, kernel "
            f"{sum(c['ms'] for c in some):.4f} ms, bound "
            f"{sum(c['bound_ms'] for c in some):.4f} ms, index_add_ "
            f"{sum(c['library_ms'] for c in some):.4f} ms")
    return cases


def _scatter_summary(bars, steps, launches, by_path) -> dict:
    """Kernel 2's entry of the ``kernels`` line: the numbers of the
    largest shape of a train step, every shape under ``shapes``."""
    f32 = [c for c in steps if c["dtype"] == "float32"]
    low = [c for c in steps if c["dtype"] != "float32"]
    top = max(f32, key=lambda c: c["rows"] * c["c"])
    cases = bars + steps
    return {
        "name": "scatter_sorted",
        "route": "cuda",
        "source": "pointunet_tpu_torch/csrc/scatter_sorted.cu",
        "replaces": "pointunet_tpu/ops/scatter_sorted.py:213",
        "launches": launches,
        "launches_by_path": by_path,
        "shape": top["case"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "max_abs_err": max(c["max_abs_err_plain"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "step_ms": sum(c["ms"] for c in f32),
        "step_library_ms": sum(c["library_ms"] for c in f32),
        "step_ms_bf16": sum(c["ms"] for c in low),
        "step_library_ms_bf16": sum(c["library_ms"] for c in low),
        "shapes": cases,
    }


def _save_gz(vol: np.ndarray, path: str) -> None:
    """``vol`` as NIfTI at ``path`` (``.nii.gz``), gzipped at level 1
    (level 9 takes minutes at these sizes)."""
    from pointunet_tpu_torch.data import nifti

    raw = path[:-len(".gz")]
    nifti.save(vol, raw)
    with open(raw, "rb") as f, gzip.open(path, "wb", compresslevel=1) as g:
        shutil.copyfileobj(f, g)
    os.remove(raw)


def _brats_vols(tumour: bool = False) -> dict:
    """The volumes of ``_write_cases`` ({modality or "seg": (240, 240,
    155)}), seeded: the bench's ellipsoid brain with normal noise."""
    from pointunet_tpu_torch.data.loader import BRATS_MODALITIES

    rng = np.random.default_rng(1)
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME), indexing="ij")
    brain = (
        ((xx - 120.0) / 75.0) ** 2
        + ((yy - 122.0) / 88.0) ** 2
        + ((zz - 76.0) / 70.0) ** 2
    ) < 1.0
    vols = {}
    d = np.sqrt((xx - 140.0) ** 2 + (yy - 100.0) ** 2 + (zz - 80.0) ** 2)
    if tumour:
        vols["seg"] = np.select([d < 10, d < 16, d < 24], [4, 1, 2], 0).astype(
            np.uint8)
    for mod in BRATS_MODALITIES:
        vol = rng.standard_normal(VOLUME).astype(np.float32)
        if tumour:
            vol += 3.0 * (d < 24)
        vols[mod] = vol * brain
    return vols


def _write_cases(inbox: str, n_cases: int = N_CASES,
                 tumour: bool = False) -> None:
    """``n_cases`` BraTS-layout cases: the bench's ellipsoid brain with
    normal noise, gzipped at level 1 once and copied (level 9 takes
    minutes). ``tumour`` adds a ball (radius 24) whose voxels are raised
    by 3 in every modality and a ``_seg`` volume labelling it (4 inside
    radius 10, 1 inside 16, 2 to the rim)."""
    vols = _brats_vols(tumour)
    first = "BraTS_smoke_000"
    os.makedirs(os.path.join(inbox, first))
    for name, vol in vols.items():
        _save_gz(vol, os.path.join(inbox, first, f"{first}_{name}.nii.gz"))
    for i in range(1, n_cases):
        case = f"BraTS_smoke_{i:03d}"
        os.makedirs(os.path.join(inbox, case))
        for name in vols:
            shutil.copyfile(
                os.path.join(inbox, first, f"{first}_{name}.nii.gz"),
                os.path.join(inbox, case, f"{case}_{name}.nii.gz"),
            )


def phase_serve(dev):
    from pointunet_tpu_torch.cli import serve
    from pointunet_tpu_torch.data import nifti
    from pointunet_tpu_torch.data.loader import (
        find_brats_cases,
        load_brats_volume,
    )

    with tempfile.TemporaryDirectory() as tmp:
        inbox = os.path.join(tmp, "inbox")
        outbox = os.path.join(tmp, "outbox")
        t0 = time.perf_counter()
        _write_cases(inbox)
        log(f"[serve] wrote {N_CASES} cases in "
            f"{time.perf_counter() - t0:.1f} s")

        reset_launches()
        server = serve.main([
            "--inbox", inbox, "--outbox", outbox, "--once",
            "--roi", *map(str, ROI), "--n_point", str(N_POINTS),
            "--device", "cuda",
        ])
        counts = read_launches()
        launches = counts["knn_cell_window"]
        log(f"[serve] served {server.served} cases, kernel launches "
            f"{counts}")
        if (server.served != N_CASES
                or launches != LAUNCHES_PER_VOLUME * N_CASES
                or counts["scatter_sorted"] or counts["windowed_scatter"]
                or counts["conv3d_3x3"]):
            raise AssertionError(
                f"expected {N_CASES} cases with {LAUNCHES_PER_VOLUME} KNN "
                f"launches each and no other kernel, got {server.served} "
                f"cases and {counts}"
            )
        latencies = []
        for case_dir in find_brats_cases(inbox):
            case = os.path.basename(case_dir)
            with open(os.path.join(outbox, case + ".json")) as f:
                rec = json.load(f)
            lab = nifti.load(os.path.join(outbox, case + ".nii.gz")).data
            vals = set(np.unique(lab).tolist())
            n_lab = int((lab > 0).sum())
            log(f"[serve] {case}: latency {rec['latency_s']} s, labels "
                f"{lab.shape} {lab.dtype} values {sorted(vals)}, "
                f"labelled voxels {n_lab}")
            if (lab.shape != VOLUME or lab.dtype != np.uint8
                    or not vals <= {0, 1, 2, 4} or n_lab > N_POINTS
                    or rec["voxels"] != n_lab):
                raise AssertionError(f"bad labels for {case}")
            latencies.append(rec["latency_s"])

        # stage split of one request on the pipeline that served them,
        # each stage's device span in the tracer's record
        mods = torch.from_numpy(np.ascontiguousarray(
            load_brats_volume(find_brats_cases(inbox)[0])
        )).to(dev)
    pipe = server.pipes[VOLUME]
    stages = _stage_split(pipe, mods)
    log("[serve] stage split (ms, mean of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # the same request with the saliency net's convs on kernel 3
    mask_cudnn = pipe._attention_mask(mods)
    with _env("POINTUNET_FASTCONV", "pallas"):
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_launches()
        with torch.inference_mode():
            pipe.segment_device(mods, gen)
        torch.cuda.synchronize()
        pallas_counts = read_launches()
        mask_kernel = pipe._attention_mask(mods)
        stages_pallas = _stage_split(pipe, mods)
    roi = _roi_slices(pipe, mods)
    agree = float((mask_kernel[roi] == mask_cudnn[roi]).float().mean())
    log(f"[serve] with POINTUNET_FASTCONV=pallas: one request's kernel "
        f"launches {pallas_counts}; attention mask agrees with the cuDNN "
        f"route's on {agree:.6f} of the ROI's voxels; stage split (ms, "
        f"mean of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages_pallas.items())
        + f"; attention {stages_pallas['attention']:.3f} ms with kernel 3 "
        f"vs {stages['attention']:.3f} ms on cuDNN")
    if (pallas_counts["conv3d_3x3"] != CONVS_PER_FORWARD
            or pallas_counts["knn_cell_window"] != LAUNCHES_PER_VOLUME
            or not agree >= 0.999):
        raise AssertionError(
            f"serve with kernel 3: launches {pallas_counts}, mask "
            f"agreement {agree}"
        )
    return {"launches": counts, "latency_s": latencies, "stages_ms": stages,
            "pallas_launches": pallas_counts, "mask_agreement": agree,
            "stages_pallas_ms": stages_pallas}, pipe, mods


def _roi_slices(pipe, mods):
    """The (X, Y, Z) slices of the attention stage's ROI window, as
    ``FusedPointUnet._attention_mask`` places it."""
    from pointunet_tpu_torch.pipeline.fused import _roi_start

    brain = (mods != 0).any(dim=0)
    x, y, z = pipe.volume_shape
    rx, ry, rz = pipe._roi
    sx = _roi_start(brain.any(dim=2).any(dim=1), x, rx)
    sy = _roi_start(brain.any(dim=2).any(dim=0), y, ry)
    sz = _roi_start(brain.any(dim=1).any(dim=0), z, rz)
    return slice(sx, sx + rx), slice(sy, sy + ry), slice(sz, sz + rz)


def _stage_split(pipe, mods) -> dict:
    """Device ms of the four stages of ``segment_device``, mean of 3 warm
    requests, read from the tracer's ``serve`` record of each."""
    from pointunet_tpu_torch.core import trace

    gen = torch.Generator(device=mods.device)
    spans = {"attention": "serve.attention", "sampling": "serve.sampling",
             "pyramid": "serve.pyramid", "pointseg_scatter": "serve.pointseg"}
    totals = dict.fromkeys(spans, 0.0)
    repeats = 3
    with torch.inference_mode():
        for rep in range(repeats + 1):
            gen.manual_seed(0)
            pipe.segment_device(mods, gen)
            torch.cuda.synchronize()
            if rep:                                 # rep 0 warms up
                rec = trace.records()[-1]
                for name, span in spans.items():
                    totals[name] += trace.span_ms(rec, span, "device") / repeats
    return totals


def _capture_convs(model, x) -> list:
    """(x, w, bias) of every kernel-3 call of one forward of ``model`` with
    ``POINTUNET_FASTCONV=pallas`` (the calls still run)."""
    from pointunet_tpu_torch.models import fastconv

    calls, real = [], fastconv.conv3d_3x3

    def record(*args):
        calls.append(args)
        return real(*args)

    fastconv.conv3d_3x3 = record
    try:
        with _env("POINTUNET_FASTCONV", "pallas"), torch.inference_mode():
            model(x)
    finally:
        fastconv.conv3d_3x3 = real
    torch.cuda.synchronize()
    return calls


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |a| (8 significant bits)."""
    e = torch.floor(torch.log2(a.abs().clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def _want_path(bf16: bool, cin: int, cout: int, wd: int) -> str:
    """The kernel-3 design a conv of this shape takes: with an even W,
    bf16 with Cin % 16 == 0 the narrow-Cout one for the head (Cout <= 2,
    Cin <= 256, W % 8 == 0), the deep one for the coarse levels (Cout >
    8, W <= 64 and not a multiple of the wide design's 32-column tile),
    else the wide tensor-core one; f32 the narrow-Cout one for the head (Cin % 4
    == 0, its resident weight of Cin x 27 x Cout padded to 2, 4 or 8
    floats and its 3 x 4 x 42 x 40-float ring within the 232,448 bytes of
    shared memory a block may take), else 3xTF32 with Cin % 8 == 0; the
    rest the CUDA cores."""
    if wd % 2 == 0 and bf16 and cin % 16 == 0:
        if cout <= 2 and cin <= 256 and wd % 8 == 0:
            return "narrow_tensor_cores"
        return ("deep_tensor_cores" if cout > 8 and wd <= 64 and wd % 32
                else "tensor_cores")
    if wd % 2 == 0 and not bf16:
        co = 2 if cout <= 2 else 4 if cout <= 4 else 8
        if (cout <= 8 and cin % 4 == 0
                and 4 * (cin * 27 * co + 3 * 4 * 42 * 40) <= 232_448):
            return "narrow_cuda_cores"
        if cin % 8 == 0:
            return "tensor_cores_3xtf32"
    return "cuda_cores"


def _conv_case(name: str, x, w, b, library_bar: bool = False) -> dict:
    """One captured conv input through the kernel, its plain version and
    (f32) ``F.conv3d``; the bars of phase 6, times and bound. With
    ``library_bar``, bf16 too is held to ``F.conv3d``: one bf16 ulp or
    1e-5 x max|F.conv3d| (both sum in f32 and round once)."""
    import torch.nn.functional as F

    from pointunet_tpu_torch.ops import conv_cuda

    bf16 = x.dtype == torch.bfloat16
    bsz, cin, d, h, wd = x.shape
    cout = w.shape[0]
    path = conv_cuda.conv_path(x.dtype, cin, cout, wd)
    got = conv_cuda.conv3d_3x3(x, w)
    plain = conv_cuda.conv3d_3x3_plain(x, w)
    torch.cuda.synchronize()
    gap = (got.float() - plain.float()).abs()
    max_err = float(gap.max())
    scale = float(plain.float().abs().max())
    checks = {"path": path == _want_path(bf16, cin, cout, wd)}
    if bf16:
        # one bf16 ulp, but never below the f32 bar: where the 27 x Cin
        # products cancel, the two f32 sums (in different orders) differ
        # by more than the ulp of the small result
        ulp = _bf16_ulp(torch.maximum(got.float().abs(), plain.float().abs()))
        over = gap > ulp
        n_over = int(over.sum())
        over_max = float(plain.float().abs()[over].max()) if n_over else 0.0
        checks["within one bf16 ulp or 1e-5 x max|plain|"] = bool(
            (gap <= ulp.clamp(min=1e-5 * scale)).all())
        log(f"[conv] {name}: {n_over} of {gap.numel()} elements more than "
            f"one bf16 ulp apart (|plain| at most {over_max:.3e} there)")
        del ulp, over
        if library_bar:
            lib = F.conv3d(x, w, padding=1).float()
            lib_gap = (got.float() - lib).abs()
            lib_ulp = _bf16_ulp(torch.maximum(got.float().abs(), lib.abs()))
            lib_scale = float(lib.abs().max())
            checks["within one bf16 ulp or 1e-5 x max|F.conv3d|"] = bool(
                (lib_gap <= lib_ulp.clamp(min=1e-5 * lib_scale)).all())
            log(f"[conv] {name}: max |kernel - F.conv3d| "
                f"{float(lib_gap.max()):.3e}, {int((lib_gap > lib_ulp).sum())}"
                f" elements more than one bf16 ulp apart (max|F.conv3d| "
                f"{lib_scale:.3e})")
            del lib, lib_gap, lib_ulp
    else:
        checks["within 1e-5 x max|plain|"] = max_err <= 1e-5 * scale
        lib = F.conv3d(x, w, padding=1)
        lib_err = float((got - lib).abs().max())
        lib_scale = max(1.0, float(lib.abs().max()))
        checks["within 2e-5 x max(1, max|F.conv3d|)"] = (
            lib_err <= 2e-5 * lib_scale)
        log(f"[conv] {name}: max |kernel - F.conv3d| {lib_err:.3e} "
            f"(max(1, max|F.conv3d|) {lib_scale:.3e})")
        del lib
    checks["bit-equal relaunch"] = torch.equal(got, conv_cuda.conv3d_3x3(x, w))
    del gap, plain
    if b is not None:
        fused = conv_cuda.conv3d_3x3(x, w, b)
        checks["fused bias bit-equal"] = torch.equal(
            fused, got + b.view(1, -1, 1, 1, 1))
        del fused
    del got
    ms = cuda_ms(lambda: conv_cuda.conv3d_3x3(x, w, b), 20)
    plain_ms = cuda_ms(lambda: conv_cuda.conv3d_3x3_plain(x, w, b), 3)
    library_ms = cuda_ms(lambda: F.conv3d(x, w, b, padding=1), 20)
    es = x.element_size()
    nbytes = es * (x.numel() + w.numel() + bsz * cout * d * h * wd
                   + (0 if b is None else b.numel()))
    ops = 2 * 27 * cin * cout * bsz * d * h * wd
    # f32 is held to 3xTF32 on the tensor cores, the least time for
    # f32-accurate products; its bound on the CUDA cores is printed beside
    rate = BF16_OPS_S if bf16 else F32_TC_OPS_S
    b_ms, by = bound_ms(nbytes, ops, rate), bound_by(nbytes, ops, rate)
    cc_ms = None if bf16 else bound_ms(nbytes, ops, F32_OPS_S)
    log(f"[conv] {name} {str(x.dtype)[6:]} {cin}->{cout} at {(d, h, wd)} "
        f"on {path}: "
        f"max |kernel - plain| {max_err:.3e} (max |plain| {scale:.3e}), "
        + ", ".join(f"{k} {v}" for k, v in checks.items())
        + f"; kernel {ms:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, F.conv3d {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {by}"
        + ("" if bf16 else f" (3xTF32; CUDA cores {cc_ms:.4f} ms)"))
    if not all(checks.values()):
        raise AssertionError(f"conv kernel {name}: {checks}")
    return {"case": name, "dtype": str(x.dtype)[6:], "path": path,
            "cin": cin, "cout": cout, "volume": [d, h, wd], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": by, "bound_ms_cuda_cores": cc_ms,
            "max_abs_err": max_err, "ops": ops, "bytes": nbytes}


def _roi_input(pipe, mods) -> torch.Tensor:
    """The saliency net's input of a served request: the ROI window
    (1, 4, Z, Y, X) padded to the net's depth-5 stride, as the attention
    stage feeds it."""
    roi = _roi_slices(pipe, mods)
    vol = mods[:, roi[0], roi[1], roi[2]].permute(0, 3, 2, 1)[None]
    zp, yp, xp = (-(-n // 16) * 16 for n in vol.shape[2:])
    return torch.nn.functional.pad(
        vol, (0, xp - vol.shape[4], 0, yp - vol.shape[3], 0,
              zp - vol.shape[2]))


def _window_input(mods) -> torch.Tensor:
    """One f32 sliding window of ``segment`` (1, 4, 64, 160, 160), at the
    middle of the (Z, Y, X) volume."""
    zc, yc, xc = ((n - w) // 2 for n, w in zip(VOLUME[::-1], WINDOW))
    return mods.permute(0, 3, 2, 1)[None, :, zc:zc + WINDOW[0],
                                    yc:yc + WINDOW[1],
                                    xc:xc + WINDOW[2]].contiguous()


def _segment_saliency_model(dev):
    """``segment``'s saliency net: f32, gate stride 1, weights from seed 0."""
    from pointunet_tpu_torch.cli import segment

    return segment.build_pipeline(argparse.Namespace(
        dataset="brats", fast=False, sa_stride=None, n_point=N_POINTS,
        saliency_checkpoint=None, pointseg_checkpoint=None,
    )).saliency_model.to(dev).eval()


def phase_conv(dev, serve_pipe, mods) -> dict:
    """Kernel 3 on the inputs of the 19 eligible convs of one saliency
    forward: bf16 at the serve ROI, f32 on one sliding window."""
    vol = _roi_input(serve_pipe, mods)
    f32 = _segment_saliency_model(dev)
    out = {}
    for tag, model, x in (("bf16 ROI", serve_pipe.saliency_model, vol),
                          ("f32 window", f32, _window_input(mods))):
        calls = _capture_convs(model, x)
        log(f"[conv] {tag}: input {tuple(x.shape)}, {len(calls)} eligible "
            f"convs")
        if len(calls) != CONVS_PER_FORWARD:
            raise AssertionError(f"{tag}: {len(calls)} eligible convs")
        cases = []
        while calls:
            xc, wc, bc = calls.pop(0)
            with torch.inference_mode():
                cases.append(_conv_case(f"{tag} #{len(cases)}", xc, wc, bc))
            del xc, wc, bc
            torch.cuda.empty_cache()
        bf16 = tag.startswith("bf16")
        sums = {k: sum(c[k] for c in cases)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms", "ops",
                          "bytes")}
        rate = BF16_OPS_S if bf16 else F32_TC_OPS_S
        sums["bound_by"] = bound_by(sums["bytes"], sums["ops"], rate)
        if not bf16:
            sums["bound_ms_cuda_cores"] = sum(
                c["bound_ms_cuda_cores"] for c in cases)
        log(f"[conv] {tag}, the 19 convs of one forward: kernel "
            f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
            f"F.conv3d {sums['library_ms']:.4f} ms, bound "
            f"{sums['bound_ms']:.4f} ms by {sums['bound_by']} "
            f"({sums['ops'] / 1e12:.3f} TFLOP)"
            + ("" if bf16 else f"; 3xTF32 bound, CUDA-core bound "
               f"{sums['bound_ms_cuda_cores']:.4f} ms"))
        out[tag] = {"sum": sums, "shapes": cases}
    del f32
    torch.cuda.empty_cache()
    return out


def _check_labels(path: str) -> np.ndarray:
    from pointunet_tpu_torch.data import nifti

    lab = nifti.load(path).data
    vals = set(np.unique(lab).tolist())
    if lab.shape != VOLUME or lab.dtype != np.uint8 or not vals <= {0, 1, 2, 4}:
        raise AssertionError(
            f"bad labels {path}: {lab.shape} {lab.dtype} {sorted(vals)}")
    return lab


def _segment_run(inbox: str, out: str, tag: str, route: str, flags: list,
                 convs: int) -> tuple:
    """``cli.segment`` on the one case of ``inbox`` with
    ``POINTUNET_FASTCONV=route``: (seconds a volume, launches, labelled
    voxels; the labels). It must launch the conv kernel ``convs`` times
    and the KNN kernel 6 times."""
    from pointunet_tpu_torch.cli import segment

    with _env("POINTUNET_FASTCONV", route):
        reset_launches()
        seconds = segment.main([
            "--data_3D_path", inbox, "--outSegment_path", out,
            "--n_point", str(N_POINTS), "--device", "cuda", *flags,
        ])
        torch.cuda.synchronize()
        counts = read_launches()
    (case, secs), = seconds.items()
    lab = _check_labels(os.path.join(out, f"{case}.nii.gz"))
    n_lab = int((lab > 0).sum())
    log(f"[segment] {tag} (POINTUNET_FASTCONV={route or 'unset'}"
        f"{' ' + ' '.join(flags) if flags else ''}): {secs:.3f} s a "
        f"volume, labels {lab.shape} {lab.dtype} values "
        f"{sorted(set(np.unique(lab).tolist()))}, labelled voxels "
        f"{n_lab}, kernel launches {counts}")
    if (counts["conv3d_3x3"] != convs
            or counts["knn_cell_window"] != LAUNCHES_PER_VOLUME
            or counts["scatter_sorted"] or counts["windowed_scatter"]
            or not 0 < n_lab <= N_POINTS):
        raise AssertionError(f"{tag}: launches {counts}, {n_lab} "
                             f"labelled voxels")
    return {"seconds": secs, "launches": counts,
            "labelled_voxels": n_lab}, lab


def phase_segment(dev) -> tuple:
    """``cli.segment`` on one synthetic case: the f32 sliding-window path
    with kernel 3, the same on cuDNN, and ``--fast`` with kernel 3. (runs,
    {run: labels})."""
    runs, labels = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        inbox = os.path.join(tmp, "inbox")
        _write_cases(inbox, 1)
        for tag, route, flags, convs in (
            ("segment", "pallas", [], CONVS_PER_FORWARD * SEGMENT_WINDOWS),
            ("segment_cudnn", "", [], 0),
            ("segment_fast", "pallas", ["--fast", "--roi", *map(str, ROI)],
             CONVS_PER_FORWARD),
        ):
            runs[tag], labels[tag] = _segment_run(
                inbox, os.path.join(tmp, tag), tag, route, flags, convs)
    torch.cuda.empty_cache()
    return runs, labels


def _write_clouds(root: str, dev, n_clouds: int = N_CLOUDS) -> list:
    """``n_clouds`` prepared BraTS point clouds (``original_ply/<ID>.ply``
    with x, y, z, 4 modalities and class; ``input0.01/<ID>_xyz_origin.npy``):
    an all-voxel tumour ball plus random background, CLOUD_POINTS each."""
    from pointunet_tpu_torch.cli.profile_train import synthetic_cloud
    from pointunet_tpu_torch.data.ply import write_ply

    os.makedirs(os.path.join(root, "original_ply"))
    os.makedirs(os.path.join(root, "input0.01"))
    names = []
    for i in range(n_clouds):
        xyz, feats, labels = synthetic_cloud(dev, CLOUD_POINTS, seed=10 + i)
        xyz, feats = xyz[0].cpu().numpy(), feats[0].cpu().numpy()
        labels = labels[0].cpu().numpy().astype(np.uint8)
        origin = np.rint(xyz * np.asarray(VOLUME, np.float32)).astype(np.int32)
        name = f"BraTS_cloud_{i:03d}"
        write_ply(
            os.path.join(root, "original_ply", f"{name}.ply"),
            (xyz, feats[:, 3:], labels),
            ["x", "y", "z", "t1ce", "t1", "flair", "t2", "class"],
        )
        np.save(os.path.join(root, "input0.01", f"{name}_xyz_origin.npy"),
                origin)
        names.append(name)
    return names


def phase_train(dev) -> dict:
    from pointunet_tpu_torch.cli import run_brats
    from pointunet_tpu_torch.cli.profile_train import (
        synthetic_cloud,
        timed_step,
    )
    from pointunet_tpu_torch.core.config import brats_pointseg_config
    from pointunet_tpu_torch.models.randlanet import search_grid
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "pc")
        t0 = time.perf_counter()
        names = _write_clouds(root, dev)
        log(f"[train] wrote {len(names)} clouds of {CLOUD_POINTS} points in "
            f"{time.perf_counter() - t0:.1f} s")
        for split, ids in (("train", names[:-1]), ("val", names[-1:])):
            with open(os.path.join(tmp, f"{split}.txt"), "w") as f:
                f.write("\n".join(ids) + "\n")
        common = [
            "--data_PC_path", root,
            "--train_ids", os.path.join(tmp, "train.txt"),
            "--val_ids", os.path.join(tmp, "val.txt"),
            "--logdir", os.path.join(tmp, "logs"),
            "--n_point", str(N_POINTS), "--device", "cuda",
        ]
        reset_launches()
        t0 = time.perf_counter()
        state = run_brats.main(["--mode", "train", "--n_epoch", "1"] + common)
        torch.cuda.synchronize()
        counts = read_launches()
        steps = len(names) - 1
        log(f"[train] run_brats --mode train: {state.step} steps + 1 "
            f"validation cloud in {time.perf_counter() - t0:.1f} s; kernel "
            f"launches {counts}")
        if (state.step != steps
                or counts["knn_cell_window"] != LAUNCHES_PER_VOLUME * (steps + 1)
                or counts["scatter_sorted"] != SCATTERS_PER_STEP * steps
                or counts["conv3d_3x3"] or counts["windowed_scatter"]):
            raise AssertionError(
                f"run_brats train: {state.step} steps, launches {counts}"
            )
        del state
        results = os.path.join(tmp, "npy")
        run_brats.main(["--mode", "test", "--results_path", results] + common)
        vol = np.load(os.path.join(results, f"{names[-1]}.npy"))
        filled = vol.sum(-1)
        n_filled = int((filled > 0).sum())
        log(f"[train] run_brats --mode test: {vol.shape} {vol.dtype}, "
            f"{n_filled} voxels with probabilities")
        if (vol.shape != (VOLUME[2], VOLUME[1], VOLUME[0], 4)
                or not np.isfinite(vol).all() or n_filled < N_POINTS // 2
                or np.abs(filled[filled > 0] - 1).max() > 1e-3):
            raise AssertionError(f"bad probability volume {vol.shape}")
        del vol, filled
    torch.cuda.empty_cache()

    # TRAIN_STEPS steps on one cloud at lr 1e-3, split by CUDA events;
    # the scatter inputs of step 0 (a warm-up, out of the mean) are
    # captured and checked after it
    trainer = PointSegTrainer(brats_pointseg_config(learning_rate=1e-3),
                              device="cuda")
    state = trainer.init_state()
    xyz, feats, labels = synthetic_cloud(dev, N_POINTS, seed=5)
    losses, splits = [], []
    for i in range(TRAIN_STEPS):
        reset_launches()
        with _capture() if i == 0 else contextlib.nullcontext() as captured:
            m, split = timed_step(trainer, state, xyz, feats, labels)
        step_counts = read_launches()
        per_step = (step_counts["knn_cell_window"],
                    step_counts["scatter_sorted"])
        losses.append(float(m["loss"]))
        splits.append(split)
        log(f"[train] step {i}: loss {losses[-1]:.6f}, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f"; KNN launches {per_step[0]}, scatter launches {per_step[1]}")
        if per_step != (LAUNCHES_PER_VOLUME, SCATTERS_PER_STEP):
            raise AssertionError(f"launches per step {per_step}")
        if i == 0:
            step_cases = _step_cases(captured, search_grid(xyz)[2])
            del captured
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = splits[1:]
    mean = {k: sum(s[k] for s in warm) / len(warm) for k in warm[0]}
    log("[train] step split (ms, mean of steps 1-9): "
        + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
        + f"; step {sum(mean.values()):.3f} ms; peak memory (steps 1-9) "
        f"{peak:.3f} GB")
    if (not all(np.isfinite(losses))
            or not np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"losses do not descend: {losses}")
    return {"launches": counts, "losses": losses, "split_ms": mean,
            "peak_gb": peak, "step_cases": step_cases}


def _self_device_ms(entry) -> float:
    """Self device time (ms) of a profiler key-average entry."""
    total = getattr(entry, "self_device_time_total", None)
    if total is None:
        total = entry.self_cuda_time_total
    return total / 1e3


def _timed_saliency_step(trainer, state, batch):
    """One ``train_step``: (loss, {part: ms}): "forward_loss" and
    "backward" (summed over the micro-batches) and "optimizer" from the
    device spans of its tracer record, "prepare" and "step" (from before
    ``prepare`` to the end of the optimizer) from CUDA events recorded at
    its marks."""
    from pointunet_tpu_torch.core import trace

    events = {}

    def mark(name):
        if name in ("prepare", "optimizer"):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    _, m = trainer.train_step(state, *batch, mark=mark)
    torch.cuda.synchronize()
    rec = trace.records()[-1]
    split = {"prepare": start.elapsed_time(events["prepare"])}
    for part, name in (("forward_loss", "train.forward_loss"),
                       ("backward", "train.backward"),
                       ("optimizer", "train.update")):
        split[part] = trace.span_ms(rec, name, "device")
    split["step"] = start.elapsed_time(events["optimizer"])
    return m["loss"], split


def _saliency_steps(cfg, batch) -> dict:
    """SALIENCY_STEPS updates of a fresh ``SaliencyTrainer`` on one batch,
    each ``train_step`` split as ``_timed_saliency_step`` does (step 0 is a
    warm-up), and one more ``train_step`` under ``torch.profiler``.
    Losses, the mean split of steps 1-9, their peak memory, and the
    profiled step's wall, device busy time and top ops by self device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from pointunet_tpu_torch.cli.profile_request import _busy_ms
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    trainer = SaliencyTrainer(cfg, device="cuda")
    state = trainer.init_state()
    loss, _ = _timed_saliency_step(trainer, state, batch)
    losses, splits = [loss], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1, SALIENCY_STEPS):
        loss, split = _timed_saliency_step(trainer, state, batch)
        losses.append(loss)
        splits.append(split)
    peak = torch.cuda.max_memory_allocated() / 1e9
    mean = {k: sum(sp[k] for sp in splits) / len(splits) for k in splits[0]}
    # one more train_step under the profiler: wall, device busy share and
    # the kernels that hold the most device time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = trainer.train_step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    losses.append(m["loss"])
    busy = _busy_ms(prof)
    kernels = sorted(
        ((_self_device_ms(e), e.key) for e in prof.key_averages()),
        reverse=True,
    )[:SALIENCY_TOP_OPS]
    del trainer, state, prof
    torch.cuda.empty_cache()
    return {"losses": losses, "split_ms": mean, "peak_gb": peak,
            "profiled_wall_ms": wall, "busy_ms": busy,
            "top_self_device_ms": [[k, v] for v, k in kernels]}


def _check_maps(out: str, metas) -> dict:
    """The ``--predict`` maps: (240, 240, 155, 2) f32, probabilities
    summing to 1 within 1e-5 inside each case's crop box, zeros outside;
    {case: (argmax inside the box)}."""
    argmax = {}
    for meta in metas:
        arr = np.load(os.path.join(out, f"{meta['case_id']}.npy"))
        (zlo, zhi), (ylo, yhi), (xlo, xhi) = meta["bbox"]
        inside = arr[xlo:xhi, ylo:yhi, zlo:zhi]
        outside = arr.copy()
        outside[xlo:xhi, ylo:yhi, zlo:zhi] = 0
        err = float(np.abs(inside.sum(-1) - 1).max())
        if (arr.shape != VOLUME + (2,) or arr.dtype != np.float32
                or not err <= 1e-5 or outside.any()):
            raise AssertionError(
                f"bad map {meta['case_id']}: {arr.shape} {arr.dtype}, max "
                f"|sum - 1| {err:.3e}, nonzero outside the box "
                f"{bool(outside.any())}")
        argmax[meta["case_id"]] = inside.argmax(-1)
    return argmax


def phase_saliency(dev) -> dict:
    """Stage-1 training at the reference's full configuration
    (``brats_saliency_config``: f32, gate stride 1, patch (64,160,160),
    batch 2, remat, base_filter 16, depth 5) on 3 synthetic BraTS cases
    with a labelled tumour ball, loaded with the brain crop: train steps
    in three variants, the kernel-3 guard, ``fit``, ``train_attention
    --evaluate`` and ``--predict`` on cuDNN and on kernel 3, and
    ``segment --saliency_checkpoint``."""
    import dataclasses

    from pointunet_tpu_torch.cli import segment, train_attention
    from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
    from pointunet_tpu_torch.core.config import brats_saliency_config
    from pointunet_tpu_torch.data.loader import (
        find_brats_cases,
        load_brats_case,
    )
    from pointunet_tpu_torch.data.sampler import patch_batches
    from pointunet_tpu_torch.ops.window import window_positions
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    out = {}
    cfg = brats_saliency_config()
    with tempfile.TemporaryDirectory() as tmp:
        basedir = os.path.join(tmp, "brats")
        t0 = time.perf_counter()
        _write_cases(basedir, N_CASES, tumour=True)
        loaded = [load_brats_case(c) for c in find_brats_cases(basedir)]
        records, metas = [r for r, _ in loaded], [m for _, m in loaded]
        windows = sum(
            int(np.prod([len(window_positions(n, p, st)) for n, p, st in zip(
                r.label.shape, cfg.inference_patch_size,
                (cfg.xstep, cfg.ystep, cfg.zstep))]))
            for r in records)
        log(f"[saliency] wrote and loaded {len(records)} cases in "
            f"{time.perf_counter() - t0:.1f} s: cropped (Z, Y, X) "
            f"{records[0].label.shape}, tumour voxels "
            f"{int(records[0].label.sum())}; {windows} sliding windows of "
            f"{cfg.inference_patch_size} over the {len(records)}")

        # 1. train steps on one fixed batch, three variants
        batch = next(patch_batches(records[:2], cfg.patch_size,
                                   cfg.batch_size, np.random.default_rng(0),
                                   cfg.data_sampling))
        variants = {}
        # the reference's config, remat off, the reference bench's bf16
        # config, and (TF32 on for cuDNN's convs, PyTorch's default) the
        # reference's config as a user's f32 run takes it
        for tag, vcfg, tf32 in (
            ("remat", cfg, False),
            ("no_remat", dataclasses.replace(cfg, remat=False), False),
            ("bf16_remat", dataclasses.replace(cfg, use_bfloat16=True), False),
            ("remat_tf32_convs", cfg, True),
        ):
            reset_launches()
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                res = _saliency_steps(vcfg, batch)
            finally:
                torch.backends.cudnn.allow_tf32 = False
            res["launches"] = read_launches()
            variants[tag] = res
            split = res["split_ms"]
            kind = ("bf16 convs" if vcfg.use_bfloat16 else
                    "f32, TF32 convs" if tf32 else "true f32: TF32 off")
            log(f"[saliency] train {tag} (lr {cfg.base_lr}, batch "
                f"{cfg.batch_size} of {cfg.patch_size}, {kind}): losses "
                + ", ".join(f"{v:.6f}" for v in res["losses"])
                + "; split ms (mean of steps 1-9, summed over the 2 "
                "micro-batches) " + ", ".join(
                    f"{k} {v:.3f}" for k, v in split.items())
                + f"; peak memory {res['peak_gb']:.3f} GB; kernel launches "
                f"{res['launches']}")
            log(f"[saliency] train {tag}, one profiled train_step: wall "
                f"{res['profiled_wall_ms']:.3f} ms, device busy "
                f"{res['busy_ms']:.3f} ms (share "
                f"{res['busy_ms'] / res['profiled_wall_ms']:.4f}); top self "
                "device ms: " + "; ".join(
                    f"{k[:70]} {v:.3f}" for k, v in res["top_self_device_ms"]))
            losses = res["losses"]
            if (not all(np.isfinite(losses))
                    or not np.mean(losses[-3:]) < losses[0]
                    or any(res["launches"].values())):
                raise AssertionError(
                    f"saliency train {tag}: losses {losses}, launches "
                    f"{res['launches']}")
        out["train"] = variants

        # 2. the guard: no silent training through kernel 3
        trainer = SaliencyTrainer(cfg, device="cuda")
        state = trainer.init_state()
        with _env("POINTUNET_FASTCONV", "pallas"):
            reset_launches()
            try:
                trainer.train_step(state, *batch)
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
                message = str(e)
            else:
                raise AssertionError(
                    "a train step with POINTUNET_FASTCONV=pallas did not "
                    "raise")
            guard_counts = read_launches()
        log(f"[saliency] train step with POINTUNET_FASTCONV=pallas raised: "
            f"{message!r}; kernel launches {guard_counts}")
        if any(guard_counts.values()):
            raise AssertionError(f"guard: launches {guard_counts}")
        del trainer, state
        torch.cuda.empty_cache()

        # 3. fit: 5 steps, the epoch-end evaluation on the held-out case, a
        # best checkpoint
        fcfg = dataclasses.replace(cfg, steps_per_epoch=5, eval_epoch=1)
        trainer = SaliencyTrainer(fcfg, device="cuda")
        state = trainer.init_state()
        ckpt = os.path.join(tmp, "ckpt")
        logged = []

        def fit_log(msg):
            logged.append(msg)
            log(f"[saliency] fit: {msg}")

        reset_launches()
        t0 = time.perf_counter()
        trainer.fit(state, patch_batches(records[:2], cfg.patch_size,
                                         cfg.batch_size,
                                         np.random.default_rng(1),
                                         cfg.data_sampling),
                    records[2:], BestMetricCheckpointer(ckpt), fit_log,
                    max_steps=5)
        fit_counts = read_launches()
        dice = [float(m.split(": ")[1].split()[0]) for m in logged
                if m.startswith("eval mean dice")]
        log(f"[saliency] fit: {state.step} steps and an evaluation in "
            f"{time.perf_counter() - t0:.1f} s, dice {dice}, kernel "
            f"launches {fit_counts}")
        if (state.step != 5 or len(dice) != 1 or not 0.0 <= dice[0] <= 1.0
                or BestMetricCheckpointer(ckpt).best_step() != 5
                or any(fit_counts.values())):
            raise AssertionError(f"fit: step {state.step}, dice {dice}, "
                                 f"launches {fit_counts}")
        out["fit"] = {"dice": dice[0], "launches": fit_counts}
        del trainer, state
        torch.cuda.empty_cache()

        # 4. the CLI on that checkpoint, on cuDNN and on kernel 3
        common = ["--basedir", basedir, "--logdir", os.path.join(tmp, "logs"),
                  "--checkpoint_path", ckpt, "--device", "cuda"]
        cli, maps = {}, {}
        for route in ("", "pallas"):
            for mode in ("--evaluate", "--predict"):
                maps_dir = os.path.join(tmp, f"maps_{route or 'cudnn'}")
                extra = ["--outPros_path", maps_dir] if mode == "--predict" \
                    else []
                with _env("POINTUNET_FASTCONV", route):
                    reset_launches()
                    t0 = time.perf_counter()
                    train_attention.main(common + [mode] + extra)
                    torch.cuda.synchronize()
                    counts = read_launches()
                secs = time.perf_counter() - t0
                want = CONVS_PER_FORWARD * windows if route else 0
                tag = f"{mode[2:]}_{route or 'cudnn'}"
                log(f"[saliency] train_attention {mode} (POINTUNET_FASTCONV="
                    f"{route or 'unset'}): {secs:.2f} s for {len(records)} "
                    f"cases, {windows} windows; kernel launches {counts} "
                    f"(expected {want} = {CONVS_PER_FORWARD} x {windows} "
                    f"conv launches)")
                if (counts["conv3d_3x3"] != want or counts["knn_cell_window"]
                        or counts["scatter_sorted"]
                        or counts["windowed_scatter"]):
                    raise AssertionError(f"train_attention {mode}: {counts}")
                cli[tag] = {"seconds": secs, "launches": counts}
                if mode == "--predict":
                    maps[route] = _check_maps(maps_dir, metas)
        agree = float(np.mean([(maps[""][c] == maps["pallas"][c]).mean()
                               for c in maps[""]]))
        log(f"[saliency] --predict maps {VOLUME + (2,)} f32, sums 1 "
            f"within 1e-5 inside the crop box, zeros outside; argmax with "
            f"kernel 3 agrees with cuDNN's on {agree:.6f} of the boxes' "
            f"voxels")
        if not agree >= 0.999:
            raise AssertionError(f"kernel 3 / cuDNN argmax agreement {agree}")
        out["cli"], out["windows"], out["argmax_agreement"] = cli, windows, agree

        # 5. segment with the trained saliency checkpoint
        one = os.path.join(tmp, "one")
        case = os.path.basename(find_brats_cases(basedir)[0])
        shutil.copytree(os.path.join(basedir, case), os.path.join(one, case))
        seg_out = os.path.join(tmp, "seg")
        reset_launches()
        seconds = segment.main([
            "--data_3D_path", one, "--outSegment_path", seg_out,
            "--n_point", str(N_POINTS), "--device", "cuda",
            "--saliency_checkpoint", ckpt,
        ])
        torch.cuda.synchronize()
        counts = read_launches()
        lab = _check_labels(os.path.join(seg_out, f"{case}.nii.gz"))
        log(f"[saliency] segment --saliency_checkpoint: {seconds[case]:.3f} "
            f"s, labels {lab.shape} {lab.dtype} values "
            f"{sorted(set(np.unique(lab).tolist()))}, kernel launches "
            f"{counts}")
        if (counts["knn_cell_window"] != LAUNCHES_PER_VOLUME
                or counts["conv3d_3x3"] or counts["scatter_sorted"]
                or counts["windowed_scatter"]):
            raise AssertionError(f"segment with the checkpoint: {counts}")
        out["segment"] = {"seconds": seconds[case], "launches": counts}
    torch.cuda.empty_cache()
    return out


def _write_pancreas_cts(ct_dir: str, label_dir: str) -> None:
    """``PANCREAS_<ID>.nii.gz`` CTs in HU and their ``label<ID>.nii.gz``:
    the body oval of the reference bench's Pancreas contract (an elliptic
    cylinder through the volume, ``bench.py:bench_e2e_pancreas``) of soft
    tissue at 40 HU with seeded noise (sd 20 HU), air at -1000 HU outside,
    and an organ ellipsoid (radii 20, 14, 12 voxels) raised by 100 HU and
    labelled 1."""
    rng = np.random.default_rng(4)
    os.makedirs(ct_dir)
    os.makedirs(label_dir)
    for cid, shape in PANCREAS_CTS.items():
        x, y, z = shape
        xx, yy, zz = np.meshgrid(*(np.arange(n, dtype=np.float32)
                                   for n in shape), indexing="ij", sparse=True)
        body = (((xx - x / 2) / (0.46 * x)) ** 2
                + ((yy - y / 2) / (0.4 * y)) ** 2) < 1.0
        organ = (((xx - 0.55 * x) / 20) ** 2 + ((yy - 0.45 * y) / 14) ** 2
                 + ((zz - z / 2) / 12) ** 2) < 1.0
        ct = 40.0 + 20.0 * rng.standard_normal(shape, dtype=np.float32)
        ct = np.where(body, ct, np.float32(-1000.0)) + np.float32(100.0) * organ
        _save_gz(ct.astype(np.float32),
                 os.path.join(ct_dir, f"PANCREAS_{cid}.nii.gz"))
        _save_gz(organ.astype(np.uint8),
                 os.path.join(label_dir, f"label{cid}.nii.gz"))


def _pancreas_pipeline(tmp: str, searches: int, scatters: int) -> dict:
    """``data_prepare_pancreas`` -> ``run_pancreas`` train and test ->
    ``gen_segmentation`` -> ``evaluation`` on the CTs under ``tmp``."""
    from pointunet_tpu_torch.cli import (
        data_prepare_pancreas,
        evaluation,
        gen_segmentation,
        run_pancreas,
    )
    from pointunet_tpu_torch.data import nifti

    ct_dir, label_dir = os.path.join(tmp, "ct"), os.path.join(tmp, "label")
    pc, res = os.path.join(tmp, "pc"), os.path.join(tmp, "npy")
    loops = data_prepare_pancreas.N_LOOPS
    t0 = time.perf_counter()
    data_prepare_pancreas.main([
        "--data_3D_path", ct_dir, "--label_path", label_dir,
        "--outPC_path", pc, "--n_point", str(PANCREAS_POINTS),
    ])
    log(f"[pancreas] data_prepare_pancreas: {loops} loops of "
        f"{PANCREAS_POINTS} points a CT in {time.perf_counter() - t0:.1f} s")

    # one epoch over the training CT's loops, validated on the other's
    logs = os.path.join(tmp, "logs")
    common = ["--data_PC_path", pc, "--logdir", logs,
              "--fold", str(PANCREAS_FOLD), "--n_point", str(PANCREAS_POINTS),
              "--device", "cuda"]
    reset_launches()
    t0 = time.perf_counter()
    state = run_pancreas.main(["--mode", "train", "--n_epoch", "1"] + common)
    torch.cuda.synchronize()
    counts = read_launches()
    with open(os.path.join(logs, "train_summary.txt")) as f:
        miou = [float(line.split(":")[1]) for line in f
                if line.startswith("Best m_IoU")]
    log(f"[pancreas] run_pancreas --mode train --fold {PANCREAS_FOLD}: "
        f"{state.step} steps + {loops} validation loops in "
        f"{time.perf_counter() - t0:.1f} s, best mIoU {miou}; kernel "
        f"launches {counts} ({searches} KNN a pyramid, {scatters} sorted "
        f"scatters a step)")
    if (state.step != loops or len(miou) != 1 or not np.isfinite(miou[0])
            or counts["knn_cell_window"] != searches * 2 * loops
            or counts["scatter_sorted"] != scatters * loops
            or counts["conv3d_3x3"] or counts["windowed_scatter"]):
        raise AssertionError(
            f"run_pancreas train: {state.step} steps, mIoU {miou}, launches "
            f"{counts}")
    del state
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.perf_counter()
    run_pancreas.main(["--mode", "test", "--results_path", res,
                       "--data_3D_path", ct_dir] + common)
    torch.cuda.synchronize()
    test_counts = read_launches()
    test_s = time.perf_counter() - t0
    x, y, z = PANCREAS_CTS[PANCREAS_VAL_ID]
    vol = np.load(os.path.join(res, f"{PANCREAS_VAL_ID}_loop_0.npy"))
    filled = vol.sum(-1)
    n_filled = int((filled > 0).sum())
    err = float(np.abs(filled[filled > 0] - 1).max())
    log(f"[pancreas] run_pancreas --mode test: {len(os.listdir(res))} "
        f"volumes in {test_s:.1f} s, {vol.shape} {vol.dtype}, {n_filled} "
        f"voxels with probabilities, max |sum - 1| {err:.3e}; kernel "
        f"launches {test_counts}")
    if (vol.shape != (z, y, x, 2) or not np.isfinite(vol).all()
            or n_filled != PANCREAS_POINTS or not err <= 1e-3
            or len(os.listdir(res)) != loops
            or test_counts["knn_cell_window"] != searches * loops
            or test_counts["scatter_sorted"] or test_counts["conv3d_3x3"]
            or test_counts["windowed_scatter"]):
        raise AssertionError(f"run_pancreas test: {vol.shape}, {n_filled} "
                             f"voxels, err {err}, launches {test_counts}")
    del vol, filled

    seg = os.path.join(tmp, "seg")
    gen_segmentation.main_pancreas(["--inPros_path", res,
                                    "--outSegment_path", seg])
    dice = evaluation.main([
        "--dataset", "pancreas", "--path_truth", label_dir,
        "--path_pred", seg, "--path_report", os.path.join(tmp, "report.csv"),
    ])
    lab = nifti.load(os.path.join(seg, f"{PANCREAS_VAL_ID}.nii.gz")).data
    vals = sorted(set(np.unique(lab).tolist()))
    log(f"[pancreas] gen_segmentation --pancreas: {os.listdir(seg)}, labels "
        f"{lab.shape} {lab.dtype} values {vals}; evaluation --dataset "
        f"pancreas: Dice {dice:.5f}")
    if (lab.shape != (x, y, z) or lab.dtype != np.uint8
            or not set(vals) <= {0, 1} or not 0.0 <= dice <= 1.0):
        raise AssertionError(f"gen_segmentation/evaluation: {lab.shape} "
                             f"{vals} dice {dice}")
    shutil.rmtree(res)
    return {"train_launches": counts, "test_launches": test_counts,
            "best_miou": miou[0], "test_s": test_s, "dice": dice}


def _pancreas_serve(tmp: str, dev, searches: int) -> dict:
    """``serve --dataset pancreas --once`` on both CTs, then one CT's
    request timed warm, split by stage, profiled (busy share) and with
    peak memory, and again with the saliency net's convs on kernel 3:
    each of the 19 at its Pancreas shape held to kernel 3's bars."""
    from torch.profiler import ProfilerActivity, profile

    from pointunet_tpu_torch.cli import serve
    from pointunet_tpu_torch.cli.profile_request import _busy_ms
    from pointunet_tpu_torch.data import nifti
    from pointunet_tpu_torch.data.loader import load_pancreas_case

    ct_dir, outbox = os.path.join(tmp, "ct"), os.path.join(tmp, "out")
    reset_launches()
    server = serve.main([
        "--inbox", ct_dir, "--outbox", outbox, "--once",
        "--dataset", "pancreas", "--n_point", str(PANCREAS_POINTS),
        "--device", "cuda",
    ])
    torch.cuda.synchronize()
    counts = read_launches()
    log(f"[pancreas] serve --dataset pancreas: served {server.served} CTs, "
        f"pipes for {sorted(server.pipes)}, kernel launches {counts}")
    if (server.served != len(PANCREAS_CTS)
            or sorted(server.pipes) != sorted(PANCREAS_CTS.values())
            or counts["knn_cell_window"] != searches * len(PANCREAS_CTS)
            or counts["scatter_sorted"] or counts["conv3d_3x3"]
            or counts["windowed_scatter"]):
        raise AssertionError(f"serve pancreas: {server.served} served, "
                             f"pipes {sorted(server.pipes)}, {counts}")
    latencies = {}
    for cid, shape in PANCREAS_CTS.items():
        case = f"PANCREAS_{cid}"
        with open(os.path.join(outbox, case + ".json")) as f:
            rec = json.load(f)
        lab = nifti.load(os.path.join(outbox, case + ".nii.gz")).data
        vals = set(np.unique(lab).tolist())
        n_lab = int((lab > 0).sum())
        log(f"[pancreas] {case}: latency {rec['latency_s']} s (first of its "
            f"shape), labels {lab.shape} {lab.dtype} values {sorted(vals)}, "
            f"labelled voxels {n_lab}")
        if (lab.shape != shape or lab.dtype != np.uint8 or not vals <= {0, 1}
                or n_lab > PANCREAS_POINTS or rec["voxels"] != n_lab):
            raise AssertionError(f"bad labels for {case}")
        latencies[case] = rec["latency_s"]

    shape = PANCREAS_CTS[PANCREAS_VAL_ID]
    pipe = server.pipes[shape]
    mods = np.ascontiguousarray(np.transpose(load_pancreas_case(
        os.path.join(ct_dir, f"PANCREAS_{PANCREAS_VAL_ID}.nii.gz")).image,
        (0, 3, 2, 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.segment_volume(mods, brats_labels=False)
    warm_s = time.perf_counter() - t0
    mods = torch.from_numpy(mods).to(dev)
    stages = _stage_split(pipe, mods)
    gen = torch.Generator(device=dev)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            pipe.segment_device(mods, gen.manual_seed(0))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = _busy_ms(prof)
    del prof
    log(f"[pancreas] warm request {shape}: segment_volume {warm_s:.3f} s; "
        "stage split (ms, mean of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; profiled segment_device wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms (share {busy / wall:.4f}), peak memory {peak:.3f} GB")

    with _env("POINTUNET_FASTCONV", "pallas"):
        reset_launches()
        with torch.inference_mode():
            pipe.segment_device(mods, gen.manual_seed(0))
        torch.cuda.synchronize()
        pallas_counts = read_launches()
        stages_pallas = _stage_split(pipe, mods)
    log(f"[pancreas] with POINTUNET_FASTCONV=pallas: one request's kernel "
        f"launches {pallas_counts}; stage split (ms, mean of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages_pallas.items()))
    if (pallas_counts["conv3d_3x3"] != CONVS_PER_FORWARD
            or pallas_counts["knn_cell_window"] != searches
            or pallas_counts["scatter_sorted"]
            or pallas_counts["windowed_scatter"]):
        raise AssertionError(f"serve pancreas with kernel 3: {pallas_counts}")

    # the 19 eligible convs of this request's saliency forward: the whole
    # CT, padded to the net's depth-5 stride, as the attention stage
    # feeds it
    vol = mods.permute(0, 3, 2, 1)[None]
    zp, yp, xp = (-(-n // 16) * 16 for n in vol.shape[2:])
    vol = torch.nn.functional.pad(
        vol, (0, xp - vol.shape[4], 0, yp - vol.shape[3], 0,
              zp - vol.shape[2])).contiguous()
    calls = _capture_convs(pipe.saliency_model, vol)
    del vol
    if len(calls) != CONVS_PER_FORWARD:
        raise AssertionError(f"pancreas: {len(calls)} eligible convs")
    cases = []
    while calls:
        xc, wc, bc = calls.pop(0)
        with torch.inference_mode():
            cases.append(_conv_case(f"pancreas bf16 #{len(cases)}", xc, wc, bc))
        del xc, wc, bc
        torch.cuda.empty_cache()
    sums = {k: sum(c[k] for c in cases)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "ops",
                      "bytes")}
    sums["bound_by"] = bound_by(sums["bytes"], sums["ops"], BF16_OPS_S)
    log(f"[pancreas] the 19 bf16 convs of one request at {tuple(mods.shape)}:"
        f" kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
        f"F.conv3d {sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} "
        f"ms by {sums['bound_by']} ({sums['ops'] / 1e12:.3f} TFLOP)")
    del server, pipe, mods
    torch.cuda.empty_cache()
    return {"serve_launches": counts, "pallas_launches": pallas_counts,
            "latency_s": latencies, "warm_s": warm_s, "stages_ms": stages,
            "stages_pallas_ms": stages_pallas, "profiled_wall_ms": wall,
            "busy_ms": busy, "peak_gb": peak,
            "conv": {"sum": sums, "shapes": cases}}


def phase_pancreas(dev) -> dict:
    """The Pancreas contract of the reference bench
    (``bench.py:bench_e2e_pancreas``): two synthetic CTs,
    ``data_prepare_pancreas`` -> ``run_pancreas`` -> ``gen_segmentation``
    -> ``evaluation``, ``serve --dataset pancreas`` (with kernel 3 and its
    19 convs at the Pancreas shapes), then on one training loop kernel 1
    at the pyramid's searches with its recall, kernel 2 on the scatter
    inputs of one train step, and TRAIN_STEPS timed steps."""
    from torch.profiler import ProfilerActivity, profile

    from pointunet_tpu_torch.cli.profile_request import _busy_ms
    from pointunet_tpu_torch.cli.profile_train import timed_step
    from pointunet_tpu_torch.core.config import pancreas_pointseg_config
    from pointunet_tpu_torch.data.datasets import PancreasPointDataset
    from pointunet_tpu_torch.models.randlanet import search_grid
    from pointunet_tpu_torch.ops import pyramid
    from pointunet_tpu_torch.ops.knn import knn
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    cfg = pancreas_pointseg_config(num_points=PANCREAS_POINTS)
    searches, scatters = knn_searches(cfg), sorted_scatters(cfg)
    log(f"[pancreas] level sizes {cfg.level_sizes}: {searches} KNN kernel "
        f"launches a pyramid, {scatters} sorted scatters a train step")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_pancreas_cts(os.path.join(tmp, "ct"), os.path.join(tmp, "label"))
        log(f"[pancreas] wrote CTs {PANCREAS_CTS} in "
            f"{time.perf_counter() - t0:.1f} s")
        out = _pancreas_pipeline(tmp, searches, scatters)
        out.update(_pancreas_serve(tmp, dev, searches))
        xyz, feats, labels = next(PancreasPointDataset(
            os.path.join(tmp, "pc"), PANCREAS_FOLD, cfg).train_iter())
    xyz = torch.from_numpy(xyz).to(dev)
    feats = torch.from_numpy(feats).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()

    shapes, pyr = _search_cases(xyz[0], searches, "pancreas")
    overall, organ = _recall(pyr, labels[0] > 0, dev, "pancreas",
                              "organ")
    if overall < 0.99:
        raise AssertionError(f"pancreas recall below the bar: {overall}")
    # the pyramid whole, and its brute-force searches at the first level
    # at or below GRID_THRESHOLD (plain torch, ops/knn.py)
    brute = knn_searches(cfg) // 2
    pyr_ms = cuda_ms(lambda: pyramid.build_pyramid(xyz[0], K, RATIOS), 5)
    self_ms = cuda_ms(lambda: knn(pyr.xyz[brute], pyr.xyz[brute], K), 5)
    up_ms = cuda_ms(lambda: knn(pyr.xyz[brute + 1], pyr.xyz[brute], 1), 5)
    log(f"[pancreas] pyramid of {tuple(xyz[0].shape)}: {pyr_ms:.3f} ms; "
        f"of it the brute-force L{brute} searches ({pyr.xyz[brute].shape[0]} "
        f"points): self k={K} {self_ms:.3f} ms, up k=1 {up_ms:.3f} ms")
    del pyr
    torch.cuda.empty_cache()

    trainer = PointSegTrainer(cfg, device="cuda")
    state = trainer.init_state()
    losses, splits = [], []
    for i in range(TRAIN_STEPS):
        reset_launches()
        with _capture() if i == 0 else contextlib.nullcontext() as captured:
            m, split = timed_step(trainer, state, xyz, feats, labels)
        step_counts = read_launches()
        per_step = (step_counts["knn_cell_window"],
                    step_counts["scatter_sorted"])
        losses.append(float(m["loss"]))
        splits.append(split)
        log(f"[pancreas] step {i}: loss {losses[-1]:.6f}, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f"; KNN launches {per_step[0]}, scatter launches {per_step[1]}")
        if per_step != (searches, scatters):
            raise AssertionError(f"pancreas launches per step {per_step}")
        if i == 0:
            step_cases = _step_cases(captured, search_grid(xyz)[2], scatters)
            del captured
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = splits[1:]
    mean = {k: sum(sp[k] for sp in warm) / len(warm) for k in warm[0]}
    log("[pancreas] train step split (ms, mean of steps 1-9): "
        + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
        + f"; step {sum(mean.values()):.3f} ms; peak memory (steps 1-9) "
        f"{peak:.3f} GB")
    if (not all(np.isfinite(losses))
            or not np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"pancreas losses do not descend: {losses}")
    # one more train_step under the profiler: how much of the step's wall
    # the card is busy
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, xyz, feats, labels)
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t0) * 1e3
    step_busy = _busy_ms(prof)
    log(f"[pancreas] one profiled train_step: wall {step_wall:.3f} ms, "
        f"device busy {step_busy:.3f} ms (share "
        f"{step_busy / step_wall:.4f})")
    del trainer, state, prof
    torch.cuda.empty_cache()
    out.update({
        "pyramid_ms": pyr_ms, "brute_self_ms": self_ms,
        "brute_up_ms": up_ms,
        "knn": {"shapes": shapes, "recall_overall": overall,
                "recall_organ": organ,
                "ms_searches": sum(sh["ms"] for sh in shapes),
                "bound_ms_searches": sum(sh["bound_ms"] for sh in shapes)},
        "step_cases": step_cases, "losses": losses, "split_ms": mean,
        "train_peak_gb": peak, "train_profiled_wall_ms": step_wall,
        "train_busy_ms": step_busy, "searches": searches,
        "scatters_per_step": scatters,
    })
    return out


def _flax_flat(named: dict) -> dict:
    """Port tensors by state_dict name -> flat flax keys and layouts, as
    the JAX package's variables flatten (the inverse of ``convert.py``'s
    leaf rules)."""
    leaves = {"weight": "kernel", "bias": "bias",
              "running_mean": "mean", "running_var": "var"}
    flat = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        coll = "batch_stats" if leaf.startswith("running_") else "params"
        leaf = leaves[leaf]
        if leaf == "kernel" and arr.ndim == 1:
            leaf = "scale"                       # norm affine
        elif arr.ndim == 2:
            arr = arr.T                          # (out, in) -> (in, out)
        elif arr.ndim == 5:
            arr = arr.transpose(2, 3, 4, 1, 0)   # OIDHW -> DHWIO
        flat["/".join([coll] + path + [leaf])] = np.ascontiguousarray(arr)
    return flat


def _export_state(model, moments, directory: str, seed: int) -> dict:
    """Write ``model``'s weights as a train state of the JAX package at
    step RESUME_STEP, in the layout ``export_jax_checkpoint.py`` writes
    (``<step>.npz``, ``best/<step>.npz``, ``best.json``), with seeded
    non-zero ``moments`` (Adam's ``mu``/``nu`` or SGD's ``trace``); the
    flat dict."""
    rng = np.random.default_rng(seed)
    flat = _flax_flat(model.state_dict())
    params = _flax_flat(dict(model.named_parameters()))
    for which in moments:
        for key, value in params.items():
            draw = rng.standard_normal(value.shape).astype(np.float32) * 1e-3
            flat[f"{which}/{key[len('params/'):]}"] = (
                draw * draw if which == "nu" else draw)
    flat["count"] = flat["step"] = np.asarray(RESUME_STEP, np.int32)
    flat["rng"] = np.zeros(2, np.uint32)        # a jax.random key
    os.makedirs(os.path.join(directory, "best"))
    for path in (f"{RESUME_STEP}.npz", f"best/{RESUME_STEP}.npz"):
        np.savez(os.path.join(directory, path), **flat)
    with open(os.path.join(directory, "best.json"), "w") as f:
        json.dump({"step": RESUME_STEP, "metric": 0.5}, f)
    return flat


def _bridge_serve(tmp: str, dev) -> dict:
    """``serve --once`` restoring both nets from exported directories of
    seeded full-width weights, on cuDNN and on kernel 3: labels bit-equal
    to the same weights loaded directly, 6 KNN (and 19 conv) launches."""
    from pointunet_tpu_torch.cli import serve
    from pointunet_tpu_torch.core.config import (
        brats_pointseg_config,
        brats_saliency_config,
    )
    from pointunet_tpu_torch.data import nifti
    from pointunet_tpu_torch.data.loader import (
        find_brats_cases,
        load_brats_volume,
    )
    from pointunet_tpu_torch.models.randlanet import init_randlanet
    from pointunet_tpu_torch.models.saliency_unet import init_saliency_unet
    from pointunet_tpu_torch.pipeline.fused import FusedPointUnet

    gen = torch.Generator().manual_seed(11)
    scfg = brats_saliency_config(use_bfloat16=True, sa_gate_stride=2)
    pcfg = brats_pointseg_config(num_points=N_POINTS)
    saliency = init_saliency_unet(scfg, gen)
    pointseg = init_randlanet(pcfg, gen)
    sdir, pdir = os.path.join(tmp, "saliency"), os.path.join(tmp, "pointseg")
    _export_state(saliency, ("trace",), sdir, seed=12)
    _export_state(pointseg, ("mu", "nu"), pdir, seed=13)
    inbox = os.path.join(tmp, "inbox")
    _write_cases(inbox, n_cases=1)
    case_dir = find_brats_cases(inbox)[0]
    mods = load_brats_volume(case_dir)
    case = os.path.basename(case_dir)
    direct = FusedPointUnet(
        saliency, pointseg, scfg, pcfg, threshold=0.9,
        volume_shape=mods.shape[1:], roi_shape=ROI, device="cuda",
    )
    out = {}
    for route, env in (("serve_restored", "xla"),
                       ("serve_restored_pallas", "pallas")):
        outbox = os.path.join(tmp, f"out_{env}")
        with _env("POINTUNET_FASTCONV", env):
            reset_launches()
            server = serve.main([
                "--inbox", inbox, "--outbox", outbox, "--once",
                "--roi", *map(str, ROI), "--n_point", str(N_POINTS),
                "--device", "cuda", "--saliency_checkpoint", sdir,
                "--pointseg_checkpoint", pdir,
            ])
            torch.cuda.synchronize()
            counts = read_launches()
            want = direct.segment_volume(mods, brats_labels=True)
        got = nifti.load(os.path.join(outbox, case + ".nii.gz")).data
        restored = {**server.pipeline.saliency_model.state_dict(),
                    **server.pipeline.pointseg_model.state_dict()}
        weights_equal = all(
            torch.equal(t.to(dev), restored[n].to(dev)) for n, t in
            {**saliency.state_dict(), **pointseg.state_dict()}.items())
        equal = bool(np.array_equal(got, want))
        convs = CONVS_PER_FORWARD if env == "pallas" else 0
        log(f"[bridge] {route}: served {server.served} case from the "
            f"exported directories, weights equal to the seeded ones "
            f"{weights_equal}, labels bit-equal to the directly loaded "
            f"weights' {equal} ({int((want > 0).sum())} labelled voxels), "
            f"kernel launches {counts}")
        if (server.served != 1 or not weights_equal or not equal
                or counts["knn_cell_window"] != LAUNCHES_PER_VOLUME
                or counts["conv3d_3x3"] != convs
                or counts["scatter_sorted"] or counts["windowed_scatter"]):
            raise AssertionError(f"{route}: served {server.served}, weights "
                                 f"{weights_equal}, labels {equal}, {counts}")
        out[route] = counts
    del direct, saliency, pointseg
    return out


def _bridge_resume(tmp: str, dev) -> dict:
    """``run_brats --mode train`` resumed from an exported point-net train
    state at step RESUME_STEP (non-zero Adam moments): the moments load
    exactly, RESUME_STEPS steps end at step RESUME_STEP + RESUME_STEPS, 8
    scatter launches a step."""
    from pointunet_tpu_torch.cli import run_brats
    from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
    from pointunet_tpu_torch.core.config import brats_pointseg_config
    from pointunet_tpu_torch.models.randlanet import init_randlanet
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    cfg = brats_pointseg_config(num_points=N_POINTS)
    ckpt = os.path.join(tmp, "resume")
    flat = _export_state(init_randlanet(cfg, torch.Generator().manual_seed(14)),
                         ("mu", "nu"), ckpt, seed=15)
    state = PointSegTrainer(cfg, device="cuda").init_state()
    BestMetricCheckpointer(ckpt).restore_latest(state)
    opt = state.optimizer
    moments = {}
    for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = _flax_flat({n: opt.state[p][key]
                          for n, p in state.model.named_parameters()})
        moments[which] = max(
            float(np.abs(v - flat[f"{which}/{k[len('params/'):]}"]).max())
            for k, v in got.items())
    if state.step != RESUME_STEP or any(moments.values()):
        raise AssertionError(f"restored step {state.step}, moments off by "
                             f"{moments}")
    del state, opt
    root = os.path.join(tmp, "pc")
    names = _write_clouds(root, dev, n_clouds=RESUME_STEPS + 1)
    for split, ids in (("train", names[:-1]), ("val", names[-1:])):
        with open(os.path.join(tmp, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    reset_launches()
    t0 = time.perf_counter()
    state = run_brats.main([
        "--mode", "train", "--n_epoch", "1", "--data_PC_path", root,
        "--train_ids", os.path.join(tmp, "train.txt"),
        "--val_ids", os.path.join(tmp, "val.txt"),
        "--logdir", os.path.join(tmp, "logs"), "--n_point", str(N_POINTS),
        "--device", "cuda", "--checkpoint_path", ckpt,
    ])
    torch.cuda.synchronize()
    counts = read_launches()
    log(f"[bridge] train_resumed: run_brats resumed at step {RESUME_STEP} "
        f"(Adam moments restored exactly), {RESUME_STEPS} steps + 1 "
        f"validation cloud in {time.perf_counter() - t0:.1f} s, now at step "
        f"{state.step}; kernel launches {counts}")
    if (state.step != RESUME_STEP + RESUME_STEPS
            or counts["scatter_sorted"] != SCATTERS_PER_STEP * RESUME_STEPS
            or counts["knn_cell_window"]
            != LAUNCHES_PER_VOLUME * (RESUME_STEPS + 1)
            or counts["conv3d_3x3"] or counts["windowed_scatter"]):
        raise AssertionError(f"resumed run_brats: step {state.step}, "
                             f"launches {counts}")
    return {"train_resumed": counts}


def _bridge_fixture(dev) -> dict:
    """The committed checkpoints that JAX wrote (through the exporter) on
    the card in f32, TF32 off: the point net's logits within 1e-4 x max(1,
    max |logit|) and the batch-norm UNet3D's within atol 3e-4, rtol 1e-4
    of the recorded JAX logits (the CPU test's bars,
    tests/test_torch_checkpoint_bridge.py)."""
    from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
    from pointunet_tpu_torch.core.config import (
        brats_pointseg_config,
        brats_saliency_config,
    )
    from pointunet_tpu_torch.ops.pyramid import take_level0
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    with open(os.path.join(FIXTURE, "meta.json")) as f:
        meta = json.load(f)

    def cfg(fn, overrides):
        return fn(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in overrides.items()})

    pcfg = cfg(brats_pointseg_config, meta["pointseg"])
    scfg = cfg(brats_saliency_config, meta["saliency"])
    with np.load(os.path.join(FIXTURE, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    trainer = PointSegTrainer(pcfg, device="cuda")
    state = trainer.init_state()
    BestMetricCheckpointer(os.path.join(FIXTURE, "pointseg")).restore_latest(
        state)
    feats = torch.from_numpy(inputs["point_feats"]).to(dev)
    with torch.no_grad():
        pyr = trainer.pyramid_fn(feats[..., :3].contiguous())
        logits = state.model.eval()(take_level0(pyr, feats), pyr)
    inv = torch.argsort(pyr.order.long(), dim=-1)
    got = logits.gather(1, inv[..., None].expand_as(logits)).cpu().numpy()
    want = inputs["point_logits"]
    point_err = float(np.abs(got - want).max())
    point_bar = 1e-4 * max(1.0, float(np.abs(want).max()))
    sal = SaliencyTrainer(scfg, device="cuda",
                          attention=meta["saliency_net"] == "attention")
    sstate = sal.init_state()
    BestMetricCheckpointer(os.path.join(FIXTURE, "saliency")).restore_best(
        sstate)
    x = torch.from_numpy(inputs["saliency_x"]).to(dev).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        sgot = sstate.model.eval()(x.contiguous()).permute(0, 2, 3, 4, 1)
    swant = inputs["saliency_logits"]
    sgot = sgot.cpu().numpy()
    sal_excess = float((np.abs(sgot - swant)
                        - (3e-4 + 1e-4 * np.abs(swant))).max())
    log(f"[bridge] JAX-written fixture on the card (f32, TF32 off): point "
        f"net {pcfg.d_out} at {want.shape[1]} points, step {state.step}, "
        f"max |logit diff| {point_err:.3e} (bar {point_bar:.3e}); "
        f"{meta['saliency_net']} (batch norm), step {sstate.step}, max "
        f"|logit diff| {float(np.abs(sgot - swant).max()):.3e} (bar atol "
        f"3e-4 + rtol 1e-4, excess {sal_excess:.3e})")
    if (not point_err <= point_bar or not sal_excess <= 0
            or state.step != meta["steps"] or sstate.step != meta["steps"]):
        raise AssertionError("the JAX fixture's logits are off the bar")
    return {"point_max_abs_err": point_err, "point_bar": point_bar,
            "saliency_max_abs_err": float(np.abs(sgot - swant).max())}


def _bridge_native(dev) -> dict:
    """The native host library built from this checkout: grid
    subsampling of a 180,000-point voxel cloud against the numpy path
    (the same cells and labels, points bit-equal: voxel sums are exact
    in f32; features within 1e-4 relative) and knn_batch against brute
    force on the card (tie-aware recall 1.0); host times."""
    from pointunet_tpu_torch import native
    from pointunet_tpu_torch.ops import cuda_build
    from pointunet_tpu_torch.ops.subsample import grid_subsample

    t0 = time.perf_counter()
    so = cuda_build.build_host(native.SOURCE)
    build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native library is not available")
    rng = np.random.default_rng(21)
    shape = np.asarray((256, 256, 160))
    flat = rng.choice(int(shape.prod()), NATIVE_POINTS, replace=False)
    vox = np.stack(np.unravel_index(flat, tuple(shape)), -1).astype(np.float32)
    feats = rng.standard_normal((NATIVE_POINTS, 1)).astype(np.float32)
    labels = rng.integers(0, 2, NATIVE_POINTS).astype(np.int32)

    def host_ms(fn, repeats=3):
        fn()
        t = time.perf_counter()
        for _ in range(repeats):
            out = fn()
        return (time.perf_counter() - t) * 1e3 / repeats, out

    nat_ms, got = host_ms(lambda: native.grid_subsample(vox, feats, labels, 4.0))
    np_ms, want = host_ms(lambda: grid_subsample(vox, feats, labels, 4.0))
    go, wo = np.lexsort(got[0].T), np.lexsort(want[0].T)
    same = (got[0].shape == want[0].shape
            and np.array_equal(got[0][go], want[0][wo])
            and np.array_equal(got[2][go], want[2][wo])
            and np.allclose(got[1][go], want[1][wo], rtol=1e-4, atol=1e-5))
    xyz = vox / shape.astype(np.float32)
    q = xyz[:NATIVE_QUERIES]
    knn_ms, idx = host_ms(lambda: native.knn_batch(xyz[None], xyz[None], 16))
    recall = float(_tie_aware_recall(
        torch.from_numpy(xyz).to(dev), torch.from_numpy(q).to(dev),
        torch.from_numpy(idx[0, :NATIVE_QUERIES]).to(dev), 16).min())
    log(f"[bridge] native: {so.name} built in {build_s:.2f} s "
        f"({cuda_build.cxx()}, {native.num_threads()} OpenMP threads, "
        f"{os.cpu_count()} CPUs); grid_subsample of {NATIVE_POINTS} voxels "
        f"(grid 4) -> {got[0].shape[0]} cells, equal to numpy's {same}, "
        f"{nat_ms:.1f} ms native vs {np_ms:.1f} ms numpy (host, mean of "
        f"3); knn_batch k=16 of {NATIVE_POINTS} x {NATIVE_POINTS} "
        f"{knn_ms:.1f} ms, tie-aware recall of {NATIVE_QUERIES} queries "
        f"{recall:.6f}")
    if not same or recall < 1.0:
        raise AssertionError(f"native: equal {same}, recall {recall}")
    return {"build_s": build_s, "threads": native.num_threads(),
            "grid_subsample_ms": nat_ms,
            "numpy_ms": np_ms, "knn_batch_ms": knn_ms, "recall": recall}


def phase_bridge(dev) -> dict:
    """Checkpoints of the JAX package on the card: serve restoring
    exported full-width weights (cuDNN and kernel 3), run_brats resumed
    from an exported train state, the committed JAX-written fixture held
    to its recorded logits, and the native host library."""
    with tempfile.TemporaryDirectory() as tmp:
        out = _bridge_serve(tmp, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_bridge_resume(tmp, dev))
    torch.cuda.empty_cache()
    out["fixture"] = _bridge_fixture(dev)
    out["native"] = _bridge_native(dev)
    return out


def _digest(model) -> str:
    """sha256 of every parameter's bytes, in order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _pyramid_equal(a, b) -> bool:
    """Every field of two pyramids equal, bit for bit."""
    return all(
        all(torch.equal(x, y) for x, y in zip(f, g))
        if isinstance(f, tuple) else torch.equal(f, g)
        for f, g in zip(a, b)
    )


def _to_cpu(pyr):
    return type(pyr)(*(
        tuple(t.cpu() for t in f) if isinstance(f, tuple) else f.cpu()
        for f in pyr
    ))


def _slab_cases(calls, tag: str) -> list:
    """Each recorded cell-window search (``_search_sorted``'s arguments)
    through the KNN kernel and its plain version: rows must be equal."""
    from pointunet_tpu_torch.ops import knn_cuda

    shapes = []
    for sp, s_ids, qp, qc3, k, r in calls:
        cs = knn_cuda.cell_prefix_sums(s_ids, r)
        qc = qc3.to(torch.int32).contiguous()
        sp, qp = sp.contiguous(), qp.contiguous()
        got = knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r)
        want = knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r)
        torch.cuda.synchronize()
        bad = int((got != want).any(1).sum())
        ms = cuda_ms(lambda: knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r), 20)
        shapes.append({"search": f"k={k} Ns={sp.shape[0]} Nq={qp.shape[0]}",
                       "rows_differing": bad, "ms": ms})
        if bad:
            raise AssertionError(
                f"{tag}: kernel disagrees with its plain version on {bad} "
                f"rows (k={k}, Ns={sp.shape[0]}, Nq={qp.shape[0]})")
    return shapes


def _mesh_train(rank: int, mesh, data: dict, rows: slice, steps: int,
                check_scatters: bool, tag: str) -> dict:
    """``steps`` train steps of the Train config on ``mesh``, from its
    clouds ``rows`` of the batch in ``data``: losses, step split, peak
    memory (a rank's, over the steps), launches, parameter digests,
    whether the first pyramid equals the one-card ``build_pyramid`` of
    this rank's cloud, its cell-window searches held to kernel 1's plain
    version and, with ``check_scatters``, its first step's scatters to
    kernel 2's (phase 3's checks). Every collective runs on every rank of
    its group."""
    from pointunet_tpu_torch.cli.profile_train import timed_step
    from pointunet_tpu_torch.core.config import brats_pointseg_config
    from pointunet_tpu_torch.models.randlanet import search_grid
    from pointunet_tpu_torch.ops import pyramid
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    trainer = PointSegTrainer(brats_pointseg_config(), mesh=mesh)
    state = trainer.init_state()
    xyz, feats, labels = trainer.shard_batch(
        data["xyz"][rows], data["feats"][rows], data["labels"][rows])
    built, pyramid_fn = [], trainer.pyramid_fn
    # the first step's cell-window searches, recorded as they run: 4 on
    # query slabs of levels 0 and 1, 2 on the whole of level 2
    searches, search = [], pyramid._search_sorted

    def first_pyramid(x):
        pyramid._search_sorted = lambda *a: searches.append(a) or search(*a)
        try:
            pyr = pyramid_fn(x)
        finally:
            pyramid._search_sorted = search
        if not built:
            built.append(_to_cpu(pyr))
            trainer.pyramid_fn = pyramid_fn
        return pyr

    trainer.pyramid_fn = first_pyramid
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, splits, digests, peaks = [], [], [], []
    reset_launches()
    for i in range(steps):
        with (_capture() if check_scatters and i == 0
              else contextlib.nullcontext()) as captured:
            m, split = timed_step(trainer, state, xyz, feats, labels)
        losses.append(float(m["loss"]))
        splits.append(split)
        peaks.append(m["peak_gb"])
        digests.append(_digest(state.model))
        if captured is not None:
            step_calls = captured
        log(f"[mesh] {tag} rank {rank}: step {i} loss {losses[-1]:.6f}, "
            f"{sum(split.values()):.3f} ms, peak {peaks[-1]:.3f} GB")
    out = {
        "losses": losses, "split_ms": splits, "digests": digests,
        "launches": read_launches(), "peak_gb": max(peaks),
        "pyramid_equal": _pyramid_equal(
            built[0], data["pyramids"][rows.start + mesh.coords["data"]]),
        "searches": _slab_cases(searches, f"mesh {tag} rank {rank}"),
    }
    if check_scatters:
        out["step_cases"] = _step_cases(
            step_calls, search_grid(xyz)[2],
            sorted_scatters(trainer.cfg, mesh.shape["point"],
                            mesh.coords["point"]))
        del step_calls
    del trainer, state, built, searches
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank: int, world: int, path: str) -> dict:
    """A rank of phase 12 (a), (d) and (c), one of 4 processes sharing the
    card over gloo. (a): the Train config on the dp2 x sp2 mesh, this
    rank's cloud of the batch, ``MESH_STEPS`` steps (``_mesh_train``;
    rank 0 checks its scatters). (d): the first cloud alone on the sp4
    mesh, ``MESH_SP4_STEPS`` steps, every rank checking its scatters.
    (c): ``knn_point_sharded`` of this rank's x-slab of the 365,000-point
    cloud on the sp4 mesh."""
    import torch.distributed as dist

    from pointunet_tpu_torch.core.config import MeshConfig
    from pointunet_tpu_torch.ops import knn_cuda, knn_sharded
    from pointunet_tpu_torch.ops.pyramid_sharded import slab_sizes
    from pointunet_tpu_torch.parallel.mesh import make_mesh

    _full_f32()
    data = torch.load(path, weights_only=False)
    out = {"backend": dist.get_backend()}
    mesh = make_mesh(MeshConfig(data=2, point=2))
    out["train"] = _mesh_train(rank, mesh, data, slice(0, 2), MESH_STEPS,
                               rank == 0, "(a)")
    log(f"[mesh] rank {rank}: (a) done")
    mesh = make_mesh(MeshConfig(data=1, point=4))
    out["sp4"] = _mesh_train(rank, mesh, data, slice(0, 1), MESH_SP4_STEPS,
                             True, "(d)")
    log(f"[mesh] rank {rank}: (d) done")

    # (c) knn_point_sharded over 4 x-slabs, on the sp4 mesh of (d)
    pts, _ = knn_sharded.sort_by_x(data["cloud"].to(mesh.device))
    sizes = slab_sizes(pts.shape[0], world)
    lo = sum(sizes[:rank])
    slab = pts[lo:lo + sizes[rank]].contiguous()
    calls, search = [], knn_sharded.knn_cell_window
    knn_sharded.knn_cell_window = lambda *a: calls.append(a) or search(*a)
    try:
        reset_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        idx = knn_sharded.knn_point_sharded(slab, K, mesh)
        end.record()
        torch.cuda.synchronize()
        counts = read_launches()
    finally:
        knn_sharded.knn_cell_window = search
    sp, cs, qp, qc, k, r = calls[0]
    want = knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r)
    plain = knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r)
    out["knn"] = {
        "rows": (lo, lo + sizes[rank]), "idx": idx.cpu(),
        "launches": counts, "ms": start.elapsed_time(end),
        "kernel_ms": cuda_ms(
            lambda: knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r), 20),
        "support": sp.shape[0], "grid": r,
        "rows_differing": int((want != plain).any(1).sum()),
    }
    return out


def _serve_pipe(dev):
    """The Serve configuration's fused pipeline (``serve``'s models: the
    BraTS ``--fast`` nets with weights from seed 0), ROI 192x208x155."""
    from pointunet_tpu_torch.cli.segment import build_pipeline
    from pointunet_tpu_torch.pipeline.fused import FusedPointUnet

    p = build_pipeline(N_POINTS)
    return FusedPointUnet(p.saliency_model, p.pointseg_model, p.scfg, p.pcfg,
                          threshold=0.9, volume_shape=VOLUME, roi_shape=ROI,
                          device=dev)


def _serve_rank(rank: int, world: int, path: str) -> dict:
    """A rank of phase 12 (b), one of 2 processes sharing the card over
    gloo: ``segment_batch_device`` of the 2 volumes on the data=2 mesh, on
    cuDNN and with ``POINTUNET_FASTCONV=pallas`` (labels, launches, ms)."""
    import torch.distributed as dist

    from pointunet_tpu_torch.core.config import MeshConfig
    from pointunet_tpu_torch.parallel.mesh import make_mesh

    _full_f32()
    mesh = make_mesh(MeshConfig(data=2, point=1))
    pipe = _serve_pipe(mesh.device)
    data = np.load(path)
    mods = torch.from_numpy(data["mods"]).to(mesh.device)
    seeds = data["seeds"].tolist()
    out = {"backend": dist.get_backend()}
    for route, env in (("cudnn", "off"), ("pallas", "pallas")):
        with _env("POINTUNET_FASTCONV", env), torch.inference_mode():
            pipe.segment_batch_device(mods, seeds, mesh=mesh)    # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            labels = pipe.segment_batch_device(mods, seeds, mesh=mesh)
            torch.cuda.synchronize()
            out[route] = {"labels": labels.cpu(), "launches": read_launches(),
                          "ms": (time.perf_counter() - t0) * 1e3}
    return out


def _check_mesh_train(tag: str, train: list, steps: int, parts: int,
                      one_card: float) -> float:
    """Phase 12's bars on the ranks' ``_mesh_train`` results: per rank 6
    KNN launches and ``sorted_scatters`` scatter launches a step, the
    first pyramid bit-equal to ``build_pyramid``, 6 searches; across
    ranks equal losses and parameter digests after every step; the first
    loss within ``MESH_LOSS_BAR`` relative of ``one_card``. Returns that
    relative difference."""
    from pointunet_tpu_torch.core.config import brats_pointseg_config

    cfg = brats_pointseg_config()
    for i, t in enumerate(train):
        warm = t["split_ms"][1:]
        log(f"[mesh] {tag} rank {i}: losses {t['losses']}, step ms "
            + ", ".join(f"{sum(s.values()):.3f}" for s in t["split_ms"])
            + f" (split of steps 1-{steps - 1}: " + ", ".join(
                f"{k} {sum(s[k] for s in warm) / len(warm):.3f}"
                for k in warm[0])
            + f"), peak {t['peak_gb']:.3f} GB, launches {t['launches']}, "
            f"pyramid bit-equal to build_pyramid {t['pyramid_equal']}")
        want = (LAUNCHES_PER_VOLUME * steps,
                sorted_scatters(cfg, parts, i % parts) * steps)
        got = (t["launches"]["knn_cell_window"],
               t["launches"]["scatter_sorted"])
        if (got != want or t["launches"]["conv3d_3x3"]
                or t["launches"]["windowed_scatter"]
                or not t["pyramid_equal"]):
            raise AssertionError(
                f"mesh {tag} rank {i}: launches {t['launches']} (want KNN, "
                f"scatter {want}), pyramid equal {t['pyramid_equal']}")
        log(f"[mesh] {tag} rank {i}'s searches of its first step, rows "
            f"differing from the plain version and kernel ms: " + "; ".join(
                f"{s['search']} {s['rows_differing']} {s['ms']:.4f}"
                for s in t["searches"]))
        if len(t["searches"]) != LAUNCHES_PER_VOLUME:
            raise AssertionError(f"mesh {tag} rank {i}: "
                                 f"{len(t['searches'])} searches a pyramid")
    rel = abs(train[0]["losses"][0] - one_card) / abs(one_card)
    same_params = all(t["digests"] == train[0]["digests"] for t in train)
    same_loss = all(t["losses"] == train[0]["losses"] for t in train)
    log(f"[mesh] {tag} first-step loss {train[0]['losses'][0]:.6f} against "
        f"the one-card step's {one_card:.6f}: relative {rel:.3e} (bar "
        f"{MESH_LOSS_BAR}, bf16); parameters bit-equal across ranks after "
        f"every step {same_params}; losses equal across ranks {same_loss}")
    if not (rel <= MESH_LOSS_BAR and same_params and same_loss
            and np.all(np.isfinite(train[0]["losses"]))):
        raise AssertionError(f"mesh training {tag}: loss {rel}, params "
                             f"{same_params}, losses equal {same_loss}")
    return rel


def phase_mesh(dev) -> dict:
    """Phase 12: the multi-device layer with several ranks sharing this
    one card over gloo (NCCL takes one rank a card); not a scaling
    measurement. (a) activation-sharded training on the dp2 x sp2 mesh
    against the one-card step of the same batch, (d) on the sp4 mesh
    against the one-card batch-1 step (loss and peak memory), (b) the
    data-parallel fused batch against the one-card loop, (c)
    ``knn_point_sharded`` against exact search."""
    from pointunet_tpu_torch.cli.profile_train import synthetic_cloud
    from pointunet_tpu_torch.core.config import brats_pointseg_config
    from pointunet_tpu_torch.ops.knn_sharded import sort_by_x
    from pointunet_tpu_torch.ops.pyramid import build_pyramid_batch
    from pointunet_tpu_torch.parallel.collectives import spawn
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) and (c): the batch, its one-card step and pyramids; the
        # phase-2 cloud
        clouds = [synthetic_cloud(dev, N_POINTS, seed=s) for s in MESH_SEEDS]
        xyz, feats, labels = (torch.cat(a) for a in zip(*clouds))
        del clouds
        trainer = PointSegTrainer(brats_pointseg_config(), device="cuda")
        state = trainer.init_state()
        reset_launches()
        _, m = trainer.train_step(state, xyz, feats, labels)
        one_card = float(m["loss"])
        one_counts = read_launches()
        del trainer, state, m
        torch.cuda.empty_cache()
        # (d)'s yardstick: the one-card step of the first cloud alone; its
        # peak counts what the trainer and the step allocate
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = PointSegTrainer(brats_pointseg_config(), device="cuda")
        state = trainer.init_state()
        _, m = trainer.train_step(state, xyz[:1], feats[:1], labels[:1])
        one_card_b1 = float(m["loss"])
        torch.cuda.synchronize()
        one_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        with torch.no_grad():
            pyramids = [_to_cpu(build_pyramid_batch(xyz[b:b + 1], K, RATIOS))
                        for b in range(len(MESH_SEEDS))]
        cloud, _ = _kernel_cloud(dev)
        path = os.path.join(tmp, "mesh.pt")
        torch.save({"xyz": xyz.cpu(), "feats": feats.cpu(),
                    "labels": labels.cpu(), "pyramids": pyramids,
                    "cloud": cloud.cpu()}, path)
        del trainer, state, m, pyramids, xyz, feats, labels
        torch.cuda.empty_cache()
        log(f"[mesh] one-card step of the batch of {len(MESH_SEEDS)}: loss "
            f"{one_card:.6f}, launches {one_counts}; of the first cloud: "
            f"loss {one_card_b1:.6f}, peak {one_peak:.3f} GB above the "
            f"{base / 1e9:.3f} GB held before it")
        t0 = time.perf_counter()
        ranks = spawn(_mesh_rank, 4, path, timeout=MESH_RANK_TIMEOUT_S)
        log(f"[mesh] 4 ranks ran (a), (d) and (c) in "
            f"{time.perf_counter() - t0:.1f} s")

        # (b): 2 seeded volumes, the one-card loop on both routes
        rng = np.random.default_rng(7)
        xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME),
                                 indexing="ij")
        brain = (((xx - 120.0) / 75.0) ** 2 + ((yy - 122.0) / 88.0) ** 2
                 + ((zz - 76.0) / 70.0) ** 2) < 1.0
        mods = (rng.standard_normal((2, 4) + VOLUME, dtype=np.float32)
                * brain).astype(np.float32)
        seeds = np.array([11, 12])
        vpath = os.path.join(tmp, "volumes.npz")
        np.savez(vpath, mods=mods, seeds=seeds)
        pipe = _serve_pipe(dev)
        mods_d = torch.from_numpy(mods).to(dev)
        loop = {}
        for route, env in (("cudnn", "off"), ("pallas", "pallas")):
            with _env("POINTUNET_FASTCONV", env), torch.inference_mode():
                loop[route] = pipe.segment_batch_device(
                    mods_d, seeds.tolist()).cpu()
        del pipe, mods_d
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        servers = spawn(_serve_rank, 2, vpath, timeout=MESH_RANK_TIMEOUT_S)
        log(f"[mesh] 2 ranks ran (b) in {time.perf_counter() - t0:.1f} s")

    backends = {r["backend"] for r in ranks + servers}
    log(f"[mesh] backend {sorted(backends)}: ranks share one card, so this "
        f"is no scaling measurement")
    # (a)
    train = [r["train"] for r in ranks]
    rel = _check_mesh_train("(a)", train, MESH_STEPS, 2, one_card)
    # (d)
    sp4 = [r["sp4"] for r in ranks]
    sp4_rel = _check_mesh_train("(d)", sp4, MESH_SP4_STEPS, 4, one_card_b1)
    for i, t in enumerate(sp4):
        split = t["split_ms"][-1]
        log(f"[mesh] (d) rank {i}: peak {t['peak_gb']:.3f} GB against the "
            f"one-card batch-1 step's {one_peak:.3f} GB: "
            f"{t['peak_gb'] / one_peak:.4f} (bar {MESH_SP4_PEAK}); last step "
            f"forward {split['forward']:.3f} ms, backward "
            f"{split['backward']:.3f} ms")
        if not t["peak_gb"] <= MESH_SP4_PEAK * one_peak:
            raise AssertionError(f"mesh (d) rank {i}: peak {t['peak_gb']} GB, "
                                 f"one card {one_peak} GB")

    # (b)
    serve = {}
    for route in ("cudnn", "pallas"):
        equal = all(torch.equal(r[route]["labels"], loop[route])
                    for r in servers)
        counts = [r[route]["launches"] for r in servers]
        want_conv = CONVS_PER_FORWARD if route == "pallas" else 0
        log(f"[mesh] (b) segment_batch_device on data=2, {route}: labels "
            f"bit-equal to the one-card loop on every rank {equal}; rank ms "
            + ", ".join(f"{r[route]['ms']:.1f}" for r in servers)
            + f"; launches {counts}")
        if not equal or any(
                c["knn_cell_window"] != LAUNCHES_PER_VOLUME
                or c["conv3d_3x3"] != want_conv or c["scatter_sorted"]
                or c["windowed_scatter"] for c in counts):
            raise AssertionError(f"mesh serving ({route}): equal {equal}, "
                                 f"launches {counts}")
        serve[route] = {"launches": counts[0],
                        "ms": [r[route]["ms"] for r in servers]}

    # (c)
    pts, _ = sort_by_x(cloud)
    got = torch.cat([r["knn"]["idx"] for r in ranks]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    sel = torch.randperm(pts.shape[0], generator=gen, device=dev)[:RECALL_QUERIES]
    recall = float(_tie_aware_recall(pts, pts[sel], got[sel], K).mean())
    bounds = torch.tensor([r["knn"]["rows"][1] for r in ranks], device=dev)
    slab_of = torch.bucketize(torch.arange(pts.shape[0], device=dev), bounds,
                              right=True)
    cross = float((slab_of[got.long()] != slab_of[:, None]).float().mean())
    knn = [r["knn"] for r in ranks]
    log(f"[mesh] (c) knn_point_sharded of the {pts.shape[0]}-point cloud on "
        f"4 x-slabs: tie-aware recall {recall:.6f} ({sel.numel()} queries), "
        f"share of neighbours in another slab {cross:.6f}; per rank: "
        + "; ".join(f"support {k['support']} rows, grid {k['grid']}^3, "
                    f"{k['ms']:.3f} ms with its all_gathers (the search "
                    f"alone {k['kernel_ms']:.4f} ms), launches "
                    f"{k['launches']}, rows differing from the plain "
                    f"version {k['rows_differing']}" for k in knn))
    if (recall < 0.99 or cross <= 0.0
            or any(k["rows_differing"] or k["launches"]["knn_cell_window"] != 1
                   for k in knn)):
        raise AssertionError(f"knn_point_sharded: recall {recall}, cross "
                             f"{cross}, {[k['launches'] for k in knn]}")
    log(f"[mesh] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {
        "backend": sorted(backends)[0], "loss_rel": rel,
        "one_card_loss": one_card, "losses": train[0]["losses"],
        "step_ms": [[sum(s.values()) for s in t["split_ms"]] for t in train],
        "peak_gb": [t["peak_gb"] for t in train],
        "train_launches": train[0]["launches"],
        "searches": train[0]["searches"],
        "step_cases": train[0]["step_cases"],
        "serve": serve, "recall": recall, "cross_slab": cross,
        "knn_launches": knn[0]["launches"],
        "knn_ms": [k["ms"] for k in knn],
        "knn_kernel_ms": [k["kernel_ms"] for k in knn],
        "sp4_launches": sp4[0]["launches"],
        "sp4": {
            "loss_rel": sp4_rel, "one_card_loss": one_card_b1,
            "one_card_peak_gb": one_peak, "losses": sp4[0]["losses"],
            "peak_gb": [t["peak_gb"] for t in sp4],
            "split_ms": [t["split_ms"] for t in sp4],
            "launches": [t["launches"] for t in sp4],
            "searches": [t["searches"] for t in sp4],
            "step_cases": [t["step_cases"] for t in sp4],
        },
    }


def _route_env(fastconv, fused):
    """``POINTUNET_FASTCONV`` and ``POINTUNET_FUSED_UPSAMPLE`` as given
    (None: unset) within."""
    stack = contextlib.ExitStack()
    stack.enter_context(_env("POINTUNET_FASTCONV", fastconv))
    stack.enter_context(_env("POINTUNET_FUSED_UPSAMPLE", fused))
    return stack


def _serve_mods(dev) -> torch.Tensor:
    """The (4, 240, 240, 155) volume of ``_write_cases``, on the card."""
    from pointunet_tpu_torch.data.loader import BRATS_MODALITIES

    vols = _brats_vols()
    return torch.from_numpy(np.stack([vols[m] for m in BRATS_MODALITIES])).to(
        dev)


def _routes_serve(dev, card) -> tuple:
    """(a) The Serve contract under each route: the attention stage
    (CUDA events, mean of ROUTE_REPEATS after a warm-up), one request's
    launches, logits and labels against the unset route's."""
    pipe = _serve_pipe(dev)
    mods = _serve_mods(dev)
    out, base = {}, None
    for name, fc, fused in ROUTES:
        with _route_env(fc, fused):
            ms = cuda_ms(lambda: pipe._attention_mask(mods), ROUTE_REPEATS)
            logits = []
            hook = pipe.saliency_model.register_forward_hook(
                lambda m, i, o: logits.append(o.float()))
            try:
                reset_launches()
                with torch.inference_mode():
                    labels = pipe.segment_device(
                        mods, torch.Generator(device=dev).manual_seed(0))
                torch.cuda.synchronize()
                counts = read_launches()
            finally:
                hook.remove()
        vals = sorted(set(labels.unique().tolist()))
        if base is None:
            base = (logits[0], labels)
        dlogit = float((logits[0] - base[0]).abs().max())
        n_diff = int((labels != base[1]).sum())
        # the fused route takes the UpsampleConvs before kernel 3 can
        convs = (0 if fc != "pallas" else CONVS_PER_FORWARD
                 - UPSAMPLE_CONVS * (fused == "1"))
        log(f"[routes] (a) serve, route {name}: attention stage {ms:.3f} ms "
            f"(mean of {ROUTE_REPEATS}); one request's launches {counts}; max "
            f"|logit - unset's| {dlogit:.4e}; label voxels differing from "
            f"unset's {n_diff} of {labels.numel()}; labels "
            f"{[4 if v == 3 else v for v in vals]} | {card}")
        if (not set(vals) <= {0, 1, 2, 3}
                or counts["conv3d_3x3"] != convs
                or counts["knn_cell_window"] != LAUNCHES_PER_VOLUME
                or counts["scatter_sorted"] or counts["windowed_scatter"]):
            raise AssertionError(f"serve route {name}: labels {vals}, "
                                 f"launches {counts}")
        out[name] = {"attention_ms": ms, "launches": counts,
                     "max_abs_dlogit": dlogit, "label_voxels_differing": n_diff}
        del logits, labels
    vol = _roi_input(pipe, mods)
    del mods
    torch.cuda.empty_cache()
    return out, pipe.saliency_model, vol


def _conv_inputs(model, x, keep) -> list:
    """(name, Conv module, its input) of every ``Conv`` of one forward of
    ``model`` on ``x`` for which ``keep(module)`` holds."""
    from pointunet_tpu_torch.models.fastconv import Conv

    calls = []
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, args, _n=n: calls.append((_n, mod, args[0])))
        for n, m in model.named_modules()
        if isinstance(m, Conv) and keep(m)
    ]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return calls


def _route_conv_case(name, mod, x, card) -> dict:
    """(b) One conv of a forward on ``F.conv3d`` and on the fold, in its
    compute type: times, bound and the gap between the two, held to the
    bar of its type (bf16 with one folded slice: one bf16 ulp or 1e-5 x
    max|F.conv3d|; bf16 3x3x3 under ``all``: 2^-6 x max|F.conv3d|, the
    reference's three partial sums in bf16; f32: 2e-5 x max(1,
    max|F.conv3d|))."""
    import torch.nn.functional as F

    from pointunet_tpu_torch.models import fastconv as fc

    dt = mod.dtype or torch.promote_types(x.dtype, mod.weight.dtype)
    x = x.to(dt)
    if mod.upsample > 1:
        x = fc._nearest_upsample(x, mod.upsample)
    w = mod.weight.to(dt)
    b = None if mod.bias is None else mod.bias.to(dt)
    k = mod.kernel_size
    fold = fc._decomposable(k)
    pads = tuple(n // 2 for n in k)

    def lib():
        return F.conv3d(x, w, b, padding=pads)

    def folded():
        return fc._add_bias(fc.fast_conv3d(x, w, fold), b)

    want, got = lib(), folded()
    torch.cuda.synchronize()
    gap = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    bf16 = dt == torch.bfloat16
    ulp = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    n_ulp = int((gap > ulp).sum()) if bf16 else 0
    if not bf16:
        bar = 2e-5 * max(1.0, scale)
        ok = float(gap.max()) <= bar
    elif k[fold] == 1:
        ok = bool((gap <= ulp.clamp(min=1e-5 * scale)).all())
    else:
        ok = float(gap.max()) <= 2.0 ** -6 * scale
    max_gap = float(gap.max())
    del gap, ulp, want, got
    ms_lib = cuda_ms(lib, CONV_REPEATS)
    ms_fold = cuda_ms(folded, CONV_REPEATS)
    bsz, cin = x.shape[:2]
    cout = w.shape[0]
    voxels = bsz * x.shape[2] * x.shape[3] * x.shape[4]
    ops = 2 * k[0] * k[1] * k[2] * cin * cout * voxels
    nbytes = x.element_size() * (x.numel() + w.numel() + cout * voxels)
    rate = BF16_OPS_S if bf16 else F32_OPS_S
    b_ms, by = bound_ms(nbytes, ops, rate), bound_by(nbytes, ops, rate)
    log(f"[routes] (b) {name} {tuple(k)} {str(dt)[6:]} {cin}->{cout} at "
        f"{tuple(x.shape[2:])}, fold axis {fold} ({k[fold]} slice(s)): "
        f"F.conv3d {ms_lib:.4f} ms, fold {ms_fold:.4f} ms, bound {b_ms:.4f} "
        f"ms by {by}; max |fold - F.conv3d| {max_gap:.3e} (max|F.conv3d| "
        f"{scale:.3e}{f', {n_ulp} elements beyond one bf16 ulp' if bf16 else ''}"
        f"): {'ok' if ok else 'FAILS its bar'} | {card}")
    if not ok:
        raise AssertionError(f"fold route of {name}: gap {max_gap}")
    return {"conv": name, "kernel": list(k), "dtype": str(dt)[6:],
            "cin": cin, "cout": cout, "volume": list(x.shape[2:]),
            "ms_conv3d": ms_lib, "ms_fold": ms_fold, "bound_ms": b_ms,
            "bound_by": by, "max_abs_gap": max_gap, "max_abs_conv3d": scale,
            "beyond_one_ulp": n_ulp}


def _routes_convs(tag, model, x, card, keep) -> list:
    cases = []
    calls = _conv_inputs(model, x, keep)
    while calls:
        name, mod, xc = calls.pop(0)
        with torch.inference_mode():
            cases.append(_route_conv_case(f"{tag} {name}", mod, xc, card))
        del xc
        torch.cuda.empty_cache()
    log(f"[routes] (b) {tag}, the {len(cases)} convs: F.conv3d "
        f"{sum(c['ms_conv3d'] for c in cases):.4f} ms, fold "
        f"{sum(c['ms_fold'] for c in cases):.4f} ms, bound "
        f"{sum(c['bound_ms'] for c in cases):.4f} ms | {card}")
    return cases


def _routes_fused_upsample(model, vol, card) -> list:
    """(f) The 4 UpsampleConvs of a bf16 ROI forward: fused at the coarse
    resolution and as repeat plus ``F.conv3d``; the gap held to (b)'s bar
    of a bf16 3x3x3 conv (the fused weights sum up to 27 taps, rounded
    once to bf16)."""
    import torch.nn.functional as F

    from pointunet_tpu_torch.models import fastconv as fc

    cases = []
    for name, mod, x in _conv_inputs(model, vol, lambda m: m.upsample > 1):
        dt = mod.dtype
        x, w = x.to(dt), mod.weight.to(dt)
        b, s = mod.bias.to(dt), mod.upsample

        def plain():
            return F.conv3d(fc._nearest_upsample(x, s), w, b, padding=1)

        def fused():
            return fc._add_bias(fc.fused_upsample_conv3d(x, w, s), b)

        with torch.inference_mode():
            want, got = plain(), fused()
            gap = (got.float() - want.float()).abs()
            scale = float(want.float().abs().max())
            ulp = _bf16_ulp(torch.maximum(got.float().abs(),
                                          want.float().abs()))
            n_ulp = int((gap > ulp).sum())
            max_gap = float(gap.max())
            del want, got, gap, ulp
            ms_plain = cuda_ms(plain, CONV_REPEATS)
            ms_fused = cuda_ms(fused, CONV_REPEATS)
        ok = max_gap <= 2.0 ** -6 * scale
        log(f"[routes] (f) {name} x{s} {tuple(x.shape[1:])} -> "
            f"{w.shape[0]} ch: repeat + F.conv3d {ms_plain:.4f} ms, fused "
            f"{ms_fused:.4f} ms; max gap {max_gap:.3e} (max|F.conv3d| "
            f"{scale:.3e}, {n_ulp} elements beyond one bf16 ulp): "
            f"{'ok' if ok else 'FAILS its bar'} | {card}")
        if not ok:
            raise AssertionError(f"fused upsample {name}: gap {max_gap}")
        cases.append({"conv": name, "scale": s, "ms_repeat_conv3d": ms_plain,
                      "ms_fused": ms_fused, "max_abs_gap": max_gap,
                      "max_abs_conv3d": scale, "beyond_one_ulp": n_ulp})
    if len(cases) != UPSAMPLE_CONVS:
        raise AssertionError(f"{len(cases)} UpsampleConvs, expected "
                             f"{UPSAMPLE_CONVS}")
    return cases


def _routes_segment(labels: dict, card) -> dict:
    """(c) ``segment`` (f32 windows) with ``POINTUNET_FASTCONV=pallas``
    (kernel 3 and the fold) and ``=fold1``, its labels against phase 7's
    runs of this call."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        inbox = os.path.join(tmp, "inbox")
        _write_cases(inbox, 1)
        for tag, route, convs in (
                ("segment_pallas_fold", "pallas",
                 CONVS_PER_FORWARD * SEGMENT_WINDOWS),
                ("segment_fold1", "fold1", 0)):
            run, lab = _segment_run(inbox, os.path.join(tmp, tag), tag,
                                    route, [], convs)
            run["agreement"] = {other: float((lab == ref).mean())
                                for other, ref in labels.items()
                                if other in ("segment", "segment_cudnn")}
            log(f"[routes] (c) {tag}: {run['seconds']:.3f} s a volume; label "
                f"agreement with phase 7's runs {run['agreement']} | {card}")
            runs[tag] = run
    torch.cuda.empty_cache()
    return runs


def _routes_pancreas(dev, card) -> dict:
    """(d) The Pancreas contract's attention stage (bf16, gate stride 2,
    the whole 256x256x160 CT) under unset, ``fold1`` and ``pallas``."""
    from pointunet_tpu_torch.cli.segment import build_pipeline
    from pointunet_tpu_torch.pipeline.fused import FusedPointUnet

    p = build_pipeline(argparse.Namespace(
        dataset="pancreas", fast=True, sa_stride=None,
        n_point=PANCREAS_POINTS, saliency_checkpoint=None,
        pointseg_checkpoint=None))
    pipe = FusedPointUnet(p.saliency_model, p.pointseg_model, p.scfg, p.pcfg,
                          threshold=0.9, volume_shape=PANCREAS_SHAPE,
                          device=dev)
    rng = np.random.default_rng(4)
    mods = torch.from_numpy(rng.standard_normal(
        (1,) + PANCREAS_SHAPE, dtype=np.float32)).to(dev)
    out = {}
    for name, fc, fused in ROUTES:
        if name not in ("unset", "fold1", "pallas"):
            continue
        with _route_env(fc, fused):
            ms = cuda_ms(lambda: pipe._attention_mask(mods), ROUTE_REPEATS)
            reset_launches()
            pipe._attention_mask(mods)
            torch.cuda.synchronize()
            counts = read_launches()
        log(f"[routes] (d) pancreas, route {name}: attention stage {ms:.3f} "
            f"ms (mean of {ROUTE_REPEATS}); one stage's launches {counts} | "
            f"{card}")
        if counts["conv3d_3x3"] != (CONVS_PER_FORWARD if fc == "pallas" else 0):
            raise AssertionError(f"pancreas route {name}: {counts}")
        out[name] = {"attention_ms": ms, "launches": counts}
    del pipe, mods
    torch.cuda.empty_cache()
    return out


def _routes_train(dev, card) -> dict:
    """(e) The f32 saliency train step (remat, batch 2 of (64,160,160), a
    seeded batch with a labelled ball), unset and under ``fold1``: one
    warm step, ROUTE_STEPS timed; the first losses within rtol 1e-3."""
    from pointunet_tpu_torch.core.config import brats_saliency_config
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    cfg = brats_saliency_config()
    rng = np.random.default_rng(7)
    shape = (cfg.batch_size,) + tuple(cfg.patch_size)
    zz, yy, xx = np.meshgrid(*(np.arange(n) for n in cfg.patch_size),
                             indexing="ij", sparse=True)
    ball = ((zz - 32) ** 2 + (yy - 80) ** 2 + (xx - 80) ** 2) < 20 ** 2
    images = rng.standard_normal(shape + (4,), dtype=np.float32)
    images += 3.0 * ball[None, ..., None]
    batch = (images, np.ones(shape, np.float32),
             np.broadcast_to(ball, shape).astype(np.int32))
    out = {}
    for name in ("unset", "fold1"):
        with _env("POINTUNET_FASTCONV", None if name == "unset" else name):
            trainer = SaliencyTrainer(cfg, device=str(dev))
            state = trainer.init_state()
            reset_launches()
            first, _ = _timed_saliency_step(trainer, state, batch)
            torch.cuda.reset_peak_memory_stats()
            steps = [_timed_saliency_step(trainer, state, batch)[1]["step"]
                     for _ in range(ROUTE_STEPS)]
            peak = torch.cuda.max_memory_allocated() / 1e9
            counts = read_launches()
        del trainer, state
        torch.cuda.empty_cache()
        mean = sum(steps) / len(steps)
        log(f"[routes] (e) saliency train step f32 remat, route {name}: first "
            f"loss {first:.6f}, step ms {', '.join(f'{v:.3f}' for v in steps)} "
            f"(mean {mean:.3f}), peak {peak:.3f} GB, launches {counts} | "
            f"{card}")
        if any(counts.values()):
            raise AssertionError(f"train route {name}: launches {counts}")
        out[name] = {"first_loss": first, "step_ms": steps, "mean_ms": mean,
                     "peak_gb": peak, "launches": counts}
    rel = abs(out["fold1"]["first_loss"] - out["unset"]["first_loss"]) / abs(
        out["unset"]["first_loss"])
    out["first_loss_rel_gap"] = rel
    if not rel <= 1e-3:
        raise AssertionError(f"fold1 train step: first loss {rel} apart")
    return out


def _routes_knn(dev, card) -> dict:
    """(g) The standalone ``knn_pallas`` on phase 2's cloud, its support
    and queries shuffled apart: one kernel-1 launch, rows equal to its
    plain version, phase 2's recall bars, rows in the caller's order (a
    query's nearest is itself)."""
    from pointunet_tpu_torch.ops import knn_cuda

    xyz, tumor = _kernel_cloud(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ps = torch.randperm(xyz.shape[0], generator=gen, device=dev)
    pq = torch.randperm(xyz.shape[0], generator=gen, device=dev)
    sup, qry = xyz[ps], xyz[pq]
    reset_launches()
    got = knn_cuda.knn_pallas(sup, qry, K)
    torch.cuda.synchronize()
    counts = read_launches()
    real = knn_cuda.knn_cell_window
    knn_cuda.knn_cell_window = knn_cuda.knn_cell_window_plain
    try:
        want = knn_cuda.knn_pallas(sup, qry, K)
    finally:
        knn_cuda.knn_cell_window = real
    bad = int((got != want).any(1).sum())
    own = int((sup[got[:, 0].long()] == qry).all(1).sum())
    sel = torch.randperm(qry.shape[0], generator=gen, device=dev)[
        :RECALL_QUERIES]
    hit = _tie_aware_recall(sup, qry[sel], got[sel], K)
    flags = tumor[pq][sel].float()
    overall = float(hit.mean())
    tum = float((hit * flags).sum() / flags.sum().clamp(min=1))
    ms = cuda_ms(lambda: knn_cuda.knn_pallas(sup, qry, K), 5)
    log(f"[routes] (g) knn_pallas, {tuple(sup.shape)} shuffled support and "
        f"queries, k={K}: launches {counts}, rows differing from the plain "
        f"version {bad}, queries whose nearest is their own point {own} of "
        f"{qry.shape[0]}, "
        f"tie-aware recall overall {overall:.6f}, tumor {tum:.6f}; "
        f"{ms:.4f} ms a call (sorts, kernel, unsort) | {card}")
    if (counts["knn_cell_window"] != 1 or bad or own != qry.shape[0]
            or overall < 0.99 or tum < 0.995):
        raise AssertionError(f"knn_pallas: {counts}, {bad} rows, own {own}, "
                             f"recall {overall} / {tum}")
    return {"launches": counts, "rows_differing": bad, "own_first": own,
            "recall_overall": overall, "recall_tumor": tum, "ms": ms}


def _foldable(k333: bool):
    """Selects the stride-1, dilation-1 convs that are 3x3x3 (``k333``) or
    are not: the gate's and the 1x1x1 convs."""
    return lambda m: (m.strides == (1, 1, 1) and m.dilation == (1, 1, 1)
                      and (m.kernel_size == (3, 3, 3)) == k333)


def phase_routes(dev, card, segment_labels) -> dict:
    """Phase 13: the conv routes of ``models/fastconv.py`` and the KNN
    entries (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    out["serve"], roi_model, vol = _routes_serve(dev, card)
    out["convs_bf16_roi"] = _routes_convs("bf16 ROI", roi_model, vol, card,
                                          _foldable(False))
    out["all_3x3x3_bf16_roi"] = _routes_convs(
        "bf16 ROI, all", roi_model, vol, card, _foldable(True))
    out["fused_upsample"] = _routes_fused_upsample(roi_model, vol, card)
    del roi_model, vol
    mods = _serve_mods(dev)
    window = _window_input(mods)
    del mods
    f32 = _segment_saliency_model(dev)
    out["convs_f32_window"] = _routes_convs("f32 window", f32, window, card,
                                            _foldable(False))
    del f32, window
    torch.cuda.empty_cache()
    out["segment"] = _routes_segment(segment_labels, card)
    out["pancreas"] = _routes_pancreas(dev, card)
    out["train"] = _routes_train(dev, card)
    out["knn_pallas"] = _routes_knn(dev, card)
    out["seconds"] = time.perf_counter() - t0
    log(f"[routes] phase 13 took {out['seconds']:.1f} s | {card}")
    return out


def _block64_cloud(dev, n_points: int):
    """The Block64 cloud: the 64^3 block at ``BLOCK64_ORIGIN`` of the
    tumour volumes of ``_brats_vols`` through ``block_to_points`` (its
    brain voxels, a seeded subset of ``n_points``), BraTS label 4 as 3
    (as ``data_prepare_brats`` maps it), xyz in voxels over the volume's
    dims (as phase 8's cloud): (1, N, 3) xyz, (1, N, 7) cat(xyz, the 4
    modalities), (1, N) labels, on ``dev``."""
    from pointunet_tpu_torch.cli.data_prepare_blocks import (
        BLOCK,
        block_to_points,
    )
    from pointunet_tpu_torch.data.loader import BRATS_MODALITIES

    vols = _brats_vols(tumour=True)
    box = tuple(slice(o, o + BLOCK) for o in BLOCK64_ORIGIN)
    volume = np.stack([vols[m][box] for m in BRATS_MODALITIES])
    label = vols["seg"][box].astype(np.int32)
    label[label == 4] = 3
    xyz, feats, labels = block_to_points(
        volume, label, (volume != 0).any(0), n_points, BLOCK64_ORIGIN)
    xyz = torch.from_numpy(xyz / np.asarray(VOLUME, np.float32)).to(dev)
    feats = torch.cat([xyz, torch.from_numpy(feats).to(dev)], 1)
    labels = torch.from_numpy(labels.astype(np.int64)).to(dev)
    return xyz[None], feats[None], labels[None]


def _block64_train(dev, card) -> dict:
    """(a) The Block64 train step: searches against kernel 1's plain
    version, a warm-up step's scatters against kernel 2's, then
    ``BLOCK64_STEPS`` timed steps (see the module docstring)."""
    from pointunet_tpu_torch.cli.profile_train import timed_step
    from pointunet_tpu_torch.core import block64_pointseg_config
    from pointunet_tpu_torch.models.randlanet import search_grid
    from pointunet_tpu_torch.train import PointSegTrainer

    cfg = block64_pointseg_config(use_bfloat16=True)
    searches, scatters = knn_searches(cfg), sorted_scatters(cfg)
    xyz, feats, labels = _block64_cloud(dev, cfg.num_points)
    log(f"[block64] {cfg.name}: level sizes {cfg.level_sizes}, class "
        f"counts {cfg.class_counts}; block at {BLOCK64_ORIGIN}: "
        f"{tuple(xyz.shape)} points, labels "
        f"{torch.bincount(labels[0], minlength=4).tolist()}; {searches} KNN "
        f"kernel launches a pyramid, {scatters} sorted scatters a step")
    shapes, pyr = _search_cases(xyz[0], searches, "block64")
    del pyr
    torch.cuda.empty_cache()

    trainer = PointSegTrainer(cfg, device="cuda")
    state = trainer.init_state()
    losses, splits, launches = [], [], collections.Counter()
    for i in range(1 + BLOCK64_STEPS):
        reset_launches()
        with _capture() if i == 0 else contextlib.nullcontext() as captured:
            m, split = timed_step(trainer, state, xyz, feats, labels)
        counts = read_launches()
        launches.update(counts)
        per_step = (counts["knn_cell_window"], counts["scatter_sorted"])
        losses.append(float(m["loss"]))
        splits.append(split)
        log(f"[block64] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{losses[-1]:.6f}, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f"; KNN launches {per_step[0]}, scatter launches "
            f"{per_step[1]} | {card}")
        if (per_step != (searches, scatters) or counts["conv3d_3x3"]
                or counts["windowed_scatter"]):
            raise AssertionError(f"block64 launches a step {counts}")
        if i == 0:
            step_cases = _step_cases(captured, search_grid(xyz)[2], scatters)
            del captured
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = splits[1:]
    mean = {k: sum(sp[k] for sp in timed) / len(timed) for k in timed[0]}
    log(f"[block64] train step split (ms, mean of steps 1-{BLOCK64_STEPS}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
        + f"; step {sum(mean.values()):.3f} ms; peak memory (steps "
        f"1-{BLOCK64_STEPS}) {peak:.3f} GB; losses {losses} | {card}")
    if (not all(np.isfinite(losses))
            or not np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"block64 losses do not descend: {losses}")
    del trainer, state
    torch.cuda.empty_cache()
    return {"launches": dict(launches), "searches": searches,
            "scatters_per_step": scatters,
            "knn": {"shapes": shapes,
                    "ms_searches": sum(sh["ms"] for sh in shapes),
                    "bound_ms_searches": sum(sh["bound_ms"] for sh in shapes)},
            "step_cases": step_cases, "losses": losses, "split_ms": mean,
            "step_ms": sum(mean.values()), "peak_gb": peak}


def _knn_plain(dev, card) -> dict:
    """(b) ``knn_with_distances`` and ``knn_batch`` on the card against
    the same functions on the CPU, on clouds of voxel centres (full of
    distance ties): tie-aware recall and d^2."""
    from pointunet_tpu_torch.ops import knn_batch, knn_with_distances

    gen = torch.Generator().manual_seed(14)
    grid = torch.stack(torch.meshgrid(
        *(torch.arange(KNN_GRID),) * 3, indexing="ij"), -1).reshape(-1, 3)
    clouds = torch.stack([
        grid[torch.randperm(grid.shape[0], generator=gen)[:KNN_POINTS]]
        for _ in range(2 * KNN_BATCH)]).float() / KNN_GRID
    support, query = clouds[:KNN_BATCH], clouds[KNN_BATCH:]
    t0 = time.perf_counter()
    ref = [knn_with_distances(support[b], query[b], K)
           for b in range(KNN_BATCH)]
    cpu_s = (time.perf_counter() - t0) / KNN_BATCH
    sd, qd = support.to(dev), query.to(dev)
    idx, d2 = knn_with_distances(sd[0], qd[0], K)
    batch = knn_batch(sd, qd, K)
    torch.cuda.synchronize()

    def compare(b, got_idx, got_d2=None):
        ref_idx, ref_d2 = ref[b]
        tol = 1e-6 * float(ref_d2.max()) + 1e-7
        got_idx = got_idx.cpu().long()
        exact = ((query[b][:, None, :] - support[b][got_idx]) ** 2).sum(-1)
        recall = float((exact <= ref_d2[:, -1:] + tol).float().mean())
        err = (0.0 if got_d2 is None
               else float((got_d2.cpu() - ref_d2).abs().max()))
        ok = (got_idx.shape == ref_idx.shape and recall == 1.0
              and err <= tol)
        return recall, err, tol, ok

    rec, err, tol, ok = compare(0, idx, d2)
    ok = (ok and idx.dtype == batch.dtype == torch.int32
          and d2.dtype == torch.float32)
    batch_checks = [compare(b, batch[b]) for b in range(KNN_BATCH)]
    ms = cuda_ms(lambda: knn_with_distances(sd[0], qd[0], K), 5)
    batch_ms = cuda_ms(lambda: knn_batch(sd, qd, K), 3)
    log(f"[remaining] (b) knn_with_distances Ns=Nq={KNN_POINTS} k={K} on "
        f"the card vs the CPU: tie-aware recall {rec}, max |d^2 - CPU's| "
        f"{err:.3e} (bar {tol:.3e}); {ms:.3f} ms (CPU {cpu_s * 1e3:.1f} ms); "
        f"knn_batch B={KNN_BATCH}: recall "
        f"{[c[0] for c in batch_checks]}, {batch_ms:.3f} ms | {card}")
    if not ok or not all(c[3] for c in batch_checks):
        raise AssertionError(
            f"knn_with_distances / knn_batch on the card: recall {rec}, "
            f"d^2 err {err} (bar {tol}), dtypes {idx.dtype} {d2.dtype}, "
            f"batch {batch_checks}")
    return {"ns": KNN_POINTS, "nq": KNN_POINTS, "k": K, "recall": rec,
            "max_abs_err_d2": err, "ms": ms, "cpu_ms": cpu_s * 1e3,
            "batch": KNN_BATCH, "batch_recall": [c[0] for c in batch_checks],
            "batch_ms": batch_ms}


def _profiled_request(dev, card) -> dict:
    """(c) ``profile_trace`` around one warm Serve request: the trace's
    CUDA kernels, kernel 1's among them, the top ``TRACE_TOP_OPS``."""
    from pointunet_tpu_torch.core import profile_trace

    pipe = _serve_pipe(dev)
    mods = _serve_mods(dev)
    with torch.inference_mode():
        pipe.segment_device(mods, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        reset_launches()
        with profile_trace(logdir):
            with torch.inference_mode():
                labels = pipe.segment_device(
                    mods, torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
        counts = read_launches()
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        nbytes = sum(os.path.getsize(f) for f in files)
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e["name"]] += e.get("dur", 0.0) / 1e3          # us -> ms
    knn_events = sum("knn_cell_window_kernel" in e["name"] for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TRACE_TOP_OPS]
    busy = sum(by_name.values())
    vals = set(labels.unique().tolist())
    log(f"[remaining] (c) profile_trace of one warm Serve request: "
        f"{len(files)} trace file ({nbytes} B), {len(kernels)} CUDA kernel "
        f"events ({busy:.3f} ms of device time), kernel 1's "
        f"{knn_events} (launches {counts['knn_cell_window']}); labels "
        f"{sorted(vals)} | {card}")
    for name, ms in top:
        log(f"[remaining] (c)   {ms:.3f} ms  {name[:120]}")
    if (len(files) != 1 or not kernels
            or knn_events != counts["knn_cell_window"]
            or counts["knn_cell_window"] != LAUNCHES_PER_VOLUME
            or counts["scatter_sorted"] or counts["conv3d_3x3"]
            or counts["windowed_scatter"] or not vals <= {0, 1, 2, 3}):
        raise AssertionError(
            f"profile_trace: {len(files)} files, {len(kernels)} kernel "
            f"events, {knn_events} of kernel 1, launches {counts}, labels "
            f"{vals}")
    del pipe, mods
    torch.cuda.empty_cache()
    return {"launches": counts, "trace_bytes": nbytes,
            "kernel_events": len(kernels), "knn_events": knn_events,
            "device_ms": busy,
            "top_ops": [{"name": n, "ms": ms} for n, ms in top]}


def phase_remaining(dev, card) -> dict:
    """Phase 14: what the last slice of the port added (see the module
    docstring)."""
    t0 = time.perf_counter()
    out = {"block64": _block64_train(dev, card),
           "knn_plain": _knn_plain(dev, card),
           "profile_trace": _profiled_request(dev, card)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[remaining] phase 14 took {out['seconds']:.1f} s | {card}")
    return out


def _accuracy_check_launches(tag, run, steps) -> dict:
    """Each stage's launches against what its work must launch: kernels
    1 and 2 on every point step, kernel 1 in each request's pyramid,
    nothing else anywhere."""
    searches, scatters = knn_searches(run.pcfg), sorted_scatters(run.pcfg)
    zero = {name: 0 for name in read_launches()}
    want = {stage: dict(zero) for stage in run.launches}
    want["pointseg_train"].update(knn_cell_window=steps * searches,
                                  scatter_sorted=steps * scatters)
    want["evaluate"]["knn_cell_window"] = ACC_REQUESTS * searches
    if run.launches != want:
        raise AssertionError(f"{tag} launches {run.launches}, want {want}")
    return {"searches_per_pyramid": searches, "scatters_per_step": scatters}


def _accuracy_kernels(tag, run) -> dict:
    """Kernels 1 and 2 at the accuracy path's shapes: the searches of the
    first training cloud's pyramid against kernel 1's plain version, and
    the scatters of one point step on that cloud (a fresh trainer of the
    run's config) against kernel 2's."""
    from pointunet_tpu_torch.cli import accuracy
    from pointunet_tpu_torch.models.randlanet import search_grid
    from pointunet_tpu_torch.train import PointSegTrainer

    cfg = run.pcfg
    if (cfg.k_n, tuple(cfg.sub_sampling_ratio)) != (K, RATIOS):
        raise AssertionError(f"{tag}: k {cfg.k_n}, ratios "
                             f"{cfg.sub_sampling_ratio}")
    cloud, = accuracy.sample_clouds(run.train_vols[:1], run.task.n_points,
                                    run.device)
    shapes, pyr = _search_cases(cloud.xyz, knn_searches(cfg), tag)
    del pyr
    trainer = PointSegTrainer(cfg, device=run.device)
    state = trainer.init_state()
    feats = torch.cat([cloud.xyz, cloud.features], -1)[None]
    with _capture() as captured:
        trainer.train_step(state, cloud.xyz[None], feats, cloud.labels[None])
    torch.cuda.synchronize()
    steps = _step_cases(captured, search_grid(cloud.xyz[None])[2],
                        sorted_scatters(cfg))
    del captured, trainer, state
    torch.cuda.empty_cache()
    return {"searches": shapes, "step_cases": steps}


def _sampled(cloud, shape) -> torch.Tensor:
    """(Z, Y, X) bool: the voxels ``cloud`` holds a point of."""
    o = cloud.xyz_origin.long()
    out = torch.zeros(shape, dtype=torch.bool, device=o.device)
    out[o[:, 2], o[:, 1], o[:, 0]] = True
    return out


def _accuracy_pallas(tag, run, card) -> dict:
    """The evaluation again under ``POINTUNET_FASTCONV=pallas``: kernel 3
    on the 19 3x3x3 convs of every request, the labels against the
    default route's; then each of the 19 convs of the first held-out
    volume's request against kernel 3's plain version and ``F.conv3d``,
    and, a held-out volume, the two routes' attention masks and their
    labels where both clouds hold a point."""
    default = run.evaluation
    reset_launches()
    with _env("POINTUNET_FASTCONV", "pallas"):
        ev = run.evaluate()
    counts = read_launches()
    searches = knn_searches(run.pcfg)
    want = {"knn_cell_window": ACC_REQUESTS * searches, "scatter_sorted": 0,
            "conv3d_3x3": ACC_REQUESTS * CONVS_PER_FORWARD,
            "windowed_scatter": 0}
    if counts != want:
        raise AssertionError(f"{tag} pallas evaluation launches {counts}, "
                             f"want {want}")
    pipe, dev = run.pipe(), run.device

    def request(i, **opts):
        mods = torch.as_tensor(run.test_vols[i][0], device=dev)
        return pipe.segment_device(
            mods, torch.Generator(device=dev).manual_seed(100 + i), **opts)

    calls = _capture_convs(lambda _: request(0), None)
    if len(calls) != CONVS_PER_FORWARD:
        raise AssertionError(f"{tag}: {len(calls)} kernel-3 calls in a "
                             f"request, want {CONVS_PER_FORWARD}")
    convs = []
    with torch.inference_mode():
        for n, args in enumerate(calls):
            convs.append(_conv_case(f"{tag} #{n}", *args, library_bar=True))
    del calls
    torch.cuda.empty_cache()
    routes = []
    for i in range(len(run.test_vols)):
        with torch.inference_mode():
            lab_a, mask_a, cloud_a = request(i, return_stages=True)
            with _env("POINTUNET_FASTCONV", "pallas"):
                lab_b, mask_b, cloud_b = request(i, return_stages=True)
        both = _sampled(cloud_a, lab_a.shape) & _sampled(cloud_b, lab_a.shape)
        union = int((mask_a | mask_b).sum())
        routes.append({
            "mask_voxels": [int(mask_a.sum()), int(mask_b.sum())],
            "mask_voxels_differing": int((mask_a != mask_b).sum()),
            "mask_iou": int((mask_a & mask_b).sum()) / max(union, 1),
            "points_in_both_clouds": int(both.sum()),
            "label_agreement_in_both": float(
                (lab_a == lab_b)[both].float().mean()),
        })
        log(f"[accuracy] {tag} volume {i}, default vs pallas: attention "
            f"masks {routes[-1]['mask_voxels']} voxels, "
            f"{routes[-1]['mask_voxels_differing']} differing (IoU "
            f"{routes[-1]['mask_iou']:.6f}); {routes[-1]['points_in_both_clouds']}"
            f" voxels in both clouds, labels agreeing on "
            f"{routes[-1]['label_agreement_in_both']:.6f} of them | {card}")
    same = sum(int((a == b).sum()) for a, b in zip(ev.preds, default.preds))
    total = sum(a.size for a in ev.preds)
    either = [(a > 0) | (b > 0) for a, b in zip(ev.preds, default.preds)]
    same_fg = sum(int(((a == b) & e).sum())
                  for a, b, e in zip(ev.preds, default.preds, either))
    fg = sum(int(e.sum()) for e in either)
    dice = _mean_dice(run, ev)
    base = _mean_dice(run, default)
    out = {"launches": counts, "voxel_agreement": same / total,
           "labelled_voxel_agreement": same_fg / max(fg, 1),
           "labelled_voxels": fg, "dice": dice, "dice_default": base,
           "dice_difference": dice - base,
           "latency_ms": ev.latency_ms, "convs": convs, "routes": routes}
    log(f"[accuracy] {tag} under pallas: {counts['conv3d_3x3']} kernel-3 "
        f"launches; labels agree with the default route's on "
        f"{out['voxel_agreement']:.6f} of voxels, "
        f"{out['labelled_voxel_agreement']:.6f} of the {fg} labelled by "
        f"either; mean Dice {dice:.6f} against {base:.6f} (difference "
        f"{dice - base:+.6f}); latency ms {ev.latency_ms} | {card}")
    return out


def _mean_dice(run, ev) -> float:
    s = run.score(ev)
    if run.dataset == "brats":
        return float(np.mean([s["dice_wt"], s["dice_tc"], s["dice_et"]]))
    return s["dice"]


@torch.inference_mode()
def _accuracy_bf16(tag, run, card) -> dict:
    """The trained f32 point net once more in bf16 on the clouds of the
    held-out volumes (their requests' seeds and attention masks): the
    points' argmax agreement, overall and where the f32 net labels
    tumour."""
    import copy
    import dataclasses

    pipe32 = run.pipe()
    model16 = copy.deepcopy(pipe32.pointseg_model)
    model16.config = dataclasses.replace(model16.config, use_bfloat16=True)
    pipe16 = run.pipe()
    pipe16.pointseg_model = model16
    if (pipe32.pointseg_model.compute_dtype(run.device) != torch.float32
            or model16.compute_dtype(run.device) != torch.bfloat16):
        raise AssertionError(f"{tag}: the point nets' dtypes")
    same = total = same_fg = fg = 0
    for i, (mods, _) in enumerate(run.test_vols):
        mods = torch.as_tensor(mods, device=run.device)

        def gen():
            return torch.Generator(device=run.device).manual_seed(100 + i)

        l32, mask, cloud = pipe32.segment_device(mods, gen(),
                                                 return_stages=True)
        l16, _, cloud16 = pipe16.segment_device(mods, gen(), mask=mask,
                                                return_stages=True)
        if not torch.equal(cloud.xyz_origin, cloud16.xyz_origin):
            raise AssertionError(f"{tag}: the two requests' clouds differ")
        o = cloud.xyz_origin.long()
        p32, p16 = (v[o[:, 2], o[:, 1], o[:, 0]] for v in (l32, l16))
        agree = p32 == p16
        same += int(agree.sum())
        total += agree.numel()
        same_fg += int((agree & (p32 > 0)).sum())
        fg += int((p32 > 0).sum())
    out = {"agreement": same / total, "tumour_agreement": same_fg / max(fg, 1),
           "points": total, "tumour_points": fg}
    log(f"[accuracy] {tag} point net bf16 vs f32 (trained): argmax agrees on "
        f"{out['agreement']:.6f} of {total} points, {out['tumour_agreement']:.6f}"
        f" of the {fg} the f32 net labels tumour | {card}")
    return out


@contextlib.contextmanager
def _index_add_sums():
    """The gather gradients below kernel 2's gate summed as they were
    before ``gather.row_sum``: ``index_add_`` into zeros of ct's type
    (float atomics on CUDA). The "before" of the busy-time reading."""
    from pointunet_tpu_torch.ops import gather, scatter_sorted

    def index_add(rows, idx, n):
        c = rows.shape[-1]
        return torch.zeros((n, c), dtype=rows.dtype,
                           device=rows.device).index_add_(
            0, idx.reshape(-1).long(), rows.reshape(-1, c))

    modules = (gather, scatter_sorted)
    kept = [m.row_sum for m in modules]
    for m in modules:
        m.row_sum = index_add
    try:
        yield
    finally:
        for m, fn in zip(modules, kept):
            m.row_sum = fn


def _params_equal(a, b) -> tuple:
    """(tensors, tensors not bit-equal) of two models' parameters."""
    pa, pb = list(a.parameters()), list(b.parameters())
    return len(pa), sum(not torch.equal(x, y) for x, y in zip(pa, pb))


def _accuracy_repeat(tag, run, card) -> dict:
    """The first ``ACC_REPEAT_STEPS`` saliency steps (in the stage's
    settings) and point steps, each run twice from one state: the
    parameters must be bit-equal; the point steps launch kernel 2
    ``sorted_scatters`` times a step."""
    from pointunet_tpu_torch.cli import accuracy
    from pointunet_tpu_torch.train import PointSegTrainer

    quiet = lambda *a: None  # noqa: E731
    records = accuracy.saliency_records(run.train_vols, run.dataset)

    def saliency():
        state = run.strainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with accuracy.tf32_convs(), accuracy.deterministic_convs():
            state, _ = accuracy.train_saliency(
                run.strainer, state, records, ACC_REPEAT_STEPS, quiet)
            torch.cuda.synchronize()
        return state.model, time.perf_counter() - t0

    (s1, t1), (s2, t2) = saliency(), saliency()
    clouds = accuracy.sample_clouds(run.train_vols, run.task.n_points,
                                    run.device)
    models, launches = [], []
    for _ in range(2):
        trainer = PointSegTrainer(run.pcfg, device=run.device)
        state = trainer.init_state()
        reset_launches()
        state, _ = accuracy.train_pointseg(trainer, state, clouds,
                                           ACC_REPEAT_STEPS, quiet)
        torch.cuda.synchronize()
        launches.append(read_launches()["scatter_sorted"])
        models.append(state.model)
    del clouds
    out = {"saliency": _params_equal(s1, s2), "point": _params_equal(*models),
           "saliency_seconds": [t1, t2],
           "point_scatter_launches": launches}
    log(f"[accuracy] {tag} {ACC_REPEAT_STEPS} steps twice from one state: "
        f"saliency {out['saliency'][1]} of {out['saliency'][0]} parameters "
        f"differ, point {out['point'][1]} of {out['point'][0]}; saliency "
        f"steps {t1:.3f} / {t2:.3f} s (the stage's {ACC_SALIENCY_STEPS} "
        f"took {run.seconds['saliency_train']:.3f} s); kernel-2 launches "
        f"{launches} | {card}")
    want = ACC_REPEAT_STEPS * sorted_scatters(run.pcfg)
    if out["saliency"][1] or out["point"][1]:
        raise AssertionError(f"{tag}: training is not bit-reproducible: "
                             f"{out}")
    if launches != [want, want]:
        raise AssertionError(f"{tag}: kernel-2 launches {launches}, want "
                             f"{want} each")
    return out


def _row_sum_busy(dev, card) -> dict:
    """Device busy ms of a BraTS point step (365,000 points, bf16), its
    gathers below kernel 2's gate summed by ``index_add_`` (old) and by
    ``gather.row_sum`` (new), profiled in turns (old, new, new, old) x
    ``BUSY_ROUNDS`` after a warm-up of each; kernel 2 launches
    ``SCATTERS_PER_STEP`` times a step under both."""
    from torch.profiler import ProfilerActivity, profile

    from pointunet_tpu_torch.cli.profile_request import _busy_ms
    from pointunet_tpu_torch.cli.profile_train import synthetic_cloud
    from pointunet_tpu_torch.core.config import brats_pointseg_config
    from pointunet_tpu_torch.train import PointSegTrainer

    trainer = PointSegTrainer(brats_pointseg_config(num_points=N_POINTS),
                              device=dev)
    state = trainer.init_state()
    xyz, feats, labels = synthetic_cloud(dev, N_POINTS, seed=5)

    def step(old: bool):
        with _index_add_sums() if old else contextlib.nullcontext():
            reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trainer.train_step(state, xyz, feats, labels)
                torch.cuda.synchronize()
            launches = read_launches()["scatter_sorted"]
        if launches != SCATTERS_PER_STEP:
            raise AssertionError(f"busy step: {launches} kernel-2 launches")
        return _busy_ms(prof)

    step(True), step(False)
    busy = {"old": [], "new": []}
    for _ in range(BUSY_ROUNDS):
        for old in (True, False, False, True):
            busy["old" if old else "new"].append(step(old))
    mean = {k: float(np.mean(v)) for k, v in busy.items()}
    out = {"busy_ms": busy, "mean_ms": mean,
           "added_ms": mean["new"] - mean["old"]}
    log(f"[accuracy] BraTS point step (365,000 points, bf16) device busy "
        f"ms, gathers below the gate on index_add_ {busy['old']} (mean "
        f"{mean['old']:.3f}), on row_sum {busy['new']} (mean "
        f"{mean['new']:.3f}): {out['added_ms']:+.3f} ms | {card}")
    del trainer, state
    torch.cuda.empty_cache()
    return out


def _accuracy_dataset(dev, card, dataset: str) -> dict:
    """One dataset of phase 15 (see the module docstring)."""
    from pointunet_tpu_torch.cli import accuracy

    tag = f"accuracy_{dataset}"
    args = accuracy.parse_args([
        "--dataset", dataset, "--device", str(dev),
        "--saliency_steps", str(ACC_SALIENCY_STEPS),
        "--pointseg_steps", str(ACC_POINTSEG_STEPS)])
    run_fn = (accuracy.accuracy_brats if dataset == "brats"
              else accuracy.accuracy_pancreas)
    reset_launches()
    t0 = time.perf_counter()
    line, run = run_fn(args, log=log)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    log(f"[accuracy] {tag} line: {json.dumps(line)}")
    totals = {name: sum(st[name] for st in run.launches.values())
              for name in counts}
    if totals != counts:
        raise AssertionError(f"{tag}: launches outside the stages "
                             f"{counts} vs {totals}")
    plan = _accuracy_check_launches(tag, run, ACC_POINTSEG_STEPS)
    losses = {"saliency": run.saliency_losses,
              "pointseg": run.pointseg_losses}
    steps = {"saliency": ACC_SALIENCY_STEPS, "pointseg": ACC_POINTSEG_STEPS}
    for name, ls in losses.items():
        tail = float(np.mean(ls[-ACC_LOSS_TAIL:]))
        log(f"[accuracy] {tag} {name} losses: first {ls[0]:.6f}, mean of "
            f"the last {ACC_LOSS_TAIL} {tail:.6f}, last {ls[-1]:.6f}")
        if (len(ls) != steps[name] or not np.isfinite(ls).all()
                or not tail < ls[0]):
            raise AssertionError(f"{tag} {name} losses do not descend")
    key, pinned = ACC_QDA[dataset]
    if line[key] != pinned:
        raise AssertionError(f"{tag}: QDA control {line[key]} is not the "
                             f"reference's {pinned}")
    if not line["value"] >= pinned + ACC_MARGIN:
        raise AssertionError(f"{tag}: raw mean Dice {line['value']} below "
                             f"the QDA control {pinned} + {ACC_MARGIN}")
    labels = set()
    for pred in run.evaluation.preds:
        labels |= set(np.unique(pred).tolist())
    allowed = {0, 1, 2, 4} if dataset == "brats" else {0, 1}
    if not labels <= allowed:
        raise AssertionError(f"{tag}: labels {labels}")
    log(f"[accuracy] {tag}: raw mean Dice {line['value']} (bar "
        f"{pinned + ACC_MARGIN:.4f}), postprocessed {line['postprocessed']}, "
        f"QDA {line[key]}, latency {line['latency_ms_median']} ms; stage s "
        + ", ".join(f"{k} {v:.3f}" for k, v in run.seconds.items())
        + "; peak GB "
        + ", ".join(f"{k} {v:.3f}" for k, v in run.peak_gb.items())
        + f"; {seconds:.1f} s | {card}")
    out = {"line": line, "seconds": seconds, "stage_seconds": run.seconds,
           "peak_gb": run.peak_gb, "launches": run.launches, **plan,
           "losses": {k: {"first": float(v[0]), "last": float(v[-1]),
                          "tail_mean": float(np.mean(v[-ACC_LOSS_TAIL:]))}
                      for k, v in losses.items()}}
    checks = {}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        got = fn(*args)
        checks[name] = round(time.perf_counter() - t1, 1)
        return got

    out.update(timed("kernels", _accuracy_kernels, tag, run))
    for name, fn in (("repeat", _accuracy_repeat),
                     ("pallas", _accuracy_pallas), ("bf16", _accuracy_bf16)):
        out[name] = timed(name, fn, tag, run, card)
    log(f"[time] {tag}: the run {seconds:.1f} s, then (s) "
        f"{json.dumps(checks)}")
    del run
    torch.cuda.empty_cache()
    return out


def phase_accuracy(dev, card) -> dict:
    """Phase 15: the accuracy path (see the module docstring)."""
    t0 = time.perf_counter()
    out = {d: _accuracy_dataset(dev, card, d) for d in ("brats", "pancreas")}
    t1 = time.perf_counter()
    out["row_sum_busy"] = _row_sum_busy(dev, card)
    log(f"[time] row_sum_busy took {time.perf_counter() - t1:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    log(f"[accuracy] phase 15 took {out['seconds']:.1f} s | {card}")
    return out


def _conv_summary(conv, launches, by_path) -> dict:
    """Kernel 3's entry of the ``kernels`` line: the sums over the 19
    convs of one bf16 ROI forward (the serve path's), the f32 window's
    sums and every shape beside them."""
    roi, win = conv["bf16 ROI"], conv["f32 window"]
    shapes = roi["shapes"] + win["shapes"]
    return {
        "name": "conv3d_3x3",
        "route": "cuda",
        "source": "pointunet_tpu_torch/csrc/conv3x3.cu",
        "replaces": "pointunet_tpu/ops/conv_pallas.py:90",
        "launches": launches,
        "launches_by_path": by_path,
        "shape": "sum of the 19 convs of one bf16 ROI forward "
                 "(1,4,160,208,192)",
        "ms": roi["sum"]["ms"],
        "plain_ms": roi["sum"]["plain_ms"],
        "bound_ms": roi["sum"]["bound_ms"],
        "bound_by": roi["sum"]["bound_by"],
        "library_ms": roi["sum"]["library_ms"],
        "max_abs_err": max(c["max_abs_err"] for c in shapes),
        "f32_window": win["sum"],
        "shapes": shapes,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    _full_f32()
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_smoke = time.perf_counter()
    seconds = {}

    def phase(n: int, name: str, fn, *args):
        """Run phase ``n`` and print its seconds."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[f"{n} {name}"] = round(time.perf_counter() - t0, 1)
        log(f"[time] phase {n} ({name}) took {seconds[f'{n} {name}']} s")
        return out

    card, build_s = phase(1, "build", phase_build)
    kernel, pyr = phase(2, "kernel", phase_kernel, dev)
    bars = phase(3, "scatter", phase_scatter, dev, pyr)
    window, gather_counts = phase(4, "window", phase_window, dev, pyr)
    del pyr
    torch.cuda.empty_cache()
    serve, pipe, mods = phase(5, "serve", phase_serve, dev)
    conv = phase(6, "conv", phase_conv, dev, pipe, mods)
    del pipe, mods
    torch.cuda.empty_cache()
    segment, segment_labels = phase(7, "segment", phase_segment, dev)
    train = phase(8, "train", phase_train, dev)
    saliency = phase(9, "saliency", phase_saliency, dev)
    pancreas = phase(10, "pancreas", phase_pancreas, dev)
    torch.cuda.empty_cache()
    bridge = phase(11, "bridge", phase_bridge, dev)
    torch.cuda.empty_cache()
    mesh = phase(12, "mesh", phase_mesh, dev)
    torch.cuda.empty_cache()
    routes = phase(13, "routes", phase_routes, dev, card, segment_labels)
    torch.cuda.empty_cache()
    remaining = phase(14, "remaining", phase_remaining, dev, card)
    torch.cuda.empty_cache()
    accuracy = phase(15, "accuracy", phase_accuracy, dev, card)
    log(f"[time] phases (s): {json.dumps(seconds)}; all "
        f"{time.perf_counter() - t_smoke:.1f} s | {card}")

    # each path's launches, counted from 0 over its run; "launches" is
    # the count on the path that carries the kernel in this run: the
    # segment CLI's sliding-window path for kernels 1 and 3, training for
    # kernel 2, windowed_gather's backward for kernel 4
    paths = {
        "serve": serve["launches"],
        "serve_pallas_request": serve["pallas_launches"],
        "segment": segment["segment"]["launches"],
        "segment_cudnn": segment["segment_cudnn"]["launches"],
        "segment_fast": segment["segment_fast"]["launches"],
        "train": train.pop("launches"),
        "windowed_gather": gather_counts,
        "train_saliency": saliency["train"]["remat"]["launches"],
        "predict_attention": saliency["cli"]["predict_pallas"]["launches"],
        "evaluate_attention": saliency["cli"]["evaluate_pallas"]["launches"],
        "segment_saliency_checkpoint": saliency["segment"]["launches"],
        "serve_pancreas": pancreas.pop("serve_launches"),
        "serve_pancreas_pallas_request": pancreas.pop("pallas_launches"),
        "train_pancreas": pancreas.pop("train_launches"),
        "serve_restored": bridge.pop("serve_restored"),
        "serve_restored_pallas": bridge.pop("serve_restored_pallas"),
        "train_resumed": bridge.pop("train_resumed"),
        # phase 12, launches of one rank (all ranks launch alike)
        "mesh_train_per_rank": mesh.pop("train_launches"),
        "mesh_sp4_train_per_rank": mesh.pop("sp4_launches"),
        "mesh_serve_per_rank": mesh["serve"]["cudnn"]["launches"],
        "mesh_serve_pallas_per_rank": mesh["serve"]["pallas"]["launches"],
        "mesh_knn_point_sharded_per_rank": mesh.pop("knn_launches"),
        # phase 13
        **{f"serve_route_{name}": r["launches"]
           for name, r in routes["serve"].items()},
        **{name: r["launches"] for name, r in routes["segment"].items()},
        **{f"pancreas_attention_route_{name}": r["launches"]
           for name, r in routes["pancreas"].items()},
        **{f"train_saliency_route_{name}": routes["train"][name]["launches"]
           for name in ("unset", "fold1")},
        "knn_pallas_standalone": routes["knn_pallas"]["launches"],
        # phase 14: the warm-up and timed Block64 steps, the profiled request
        "train_block64": remaining["block64"].pop("launches"),
        "serve_profiled": remaining["profile_trace"]["launches"],
        # phase 15: each dataset's point training, its evaluation (a
        # warm-up and 2 volumes) and the evaluation under pallas
        **{f"accuracy_{d}_{stage}": accuracy[d]["launches"][stage]
           for d in ("brats", "pancreas")
           for stage in ("saliency_train", "pointseg_train", "evaluate")},
        **{f"accuracy_{d}_evaluate_pallas": accuracy[d]["pallas"]["launches"]
           for d in ("brats", "pancreas")},
    }

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    kernel["launches"] = paths["segment"]["knn_cell_window"]
    kernel["launches_by_path"] = by_path("knn_cell_window")
    kernel["serve"] = serve
    kernel["segment"] = segment
    scatter = _scatter_summary(
        bars, train.pop("step_cases"), paths["train"]["scatter_sorted"],
        by_path("scatter_sorted"),
    )
    scatter["train"] = train
    conv_entry = _conv_summary(conv, paths["segment"]["conv3d_3x3"],
                               by_path("conv3d_3x3"))
    conv_entry["saliency"] = saliency
    conv_entry["pancreas"] = pancreas.pop("conv")
    scatter["pancreas"] = pancreas.pop("step_cases")
    kernel["pancreas"] = pancreas
    kernel["bridge"] = bridge
    kernel["mesh"] = {k: mesh.pop(k) for k in (
        "searches", "recall", "cross_slab", "knn_ms", "knn_kernel_ms")}
    scatter["mesh"] = {"step_cases": mesh.pop("step_cases"), **mesh}
    window["launches_by_path"] = by_path("windowed_scatter")
    kernel["knn_pallas"] = routes.pop("knn_pallas")
    conv_entry["routes"] = routes
    scatter["block64"] = remaining["block64"].pop("step_cases")
    kernel["block64"] = remaining["block64"]
    kernel["knn_plain"] = remaining["knn_plain"]
    kernel["profile_trace"] = remaining["profile_trace"]
    scatter["accuracy"] = {d: accuracy[d].pop("step_cases")
                           for d in ("brats", "pancreas")}
    conv_entry["accuracy"] = {d: accuracy[d]["pallas"].pop("convs")
                              for d in ("brats", "pancreas")}
    kernel["accuracy"] = accuracy
    entries = [kernel, scatter, conv_entry, window]
    for entry in entries:                  # nvcc seconds of its source
        entry["build_s"] = build_s.get(os.path.basename(entry["source"]))
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
