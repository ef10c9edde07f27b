"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (``pointunet_tpu_torch``) at the full BraTS
width and fails (non-zero exit, no result line) on any fault. Phases:

1. build: compile and load the cell-window KNN kernel from the sources in
   this checkout; print the card's name and power limit;
2. kernel: on a 365,000-point cloud drawn by the port's sampler from a
   240x240x155 volume (35% random brain plus an all-voxel tumor ball),
   capture the six cell-window searches of the pyramid (self k=16 and up
   k=1 at levels 0-2) and run each through the kernel and through its
   plain version: indices must be equal on every row. Tie-aware recall of
   the level-0 self search against exact brute force must be >= 0.99
   overall and >= 0.995 on tumor queries. Times come from CUDA events;
3. serve: write 3 synthetic BraTS cases (4x240x240x155 f32, ellipsoid
   brain) to a temporary inbox and serve them with
   ``pointunet_tpu_torch.cli.serve`` (ROI 192x208x155, 365,000 points,
   bf16). Each must yield a (240, 240, 155) uint8 label volume with
   values in {0, 1, 2, 4}, at most 365,000 labelled voxels, and exactly 6
   KNN kernel launches; then time each stage with CUDA events.

Before the last line it prints the card (``nvidia-smi``) and one JSON
object describing the kernel; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import gzip
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
RECALL_QUERIES = 65_536


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


def phase_build() -> str:
    from pointunet_tpu_torch.ops import knn_cuda

    t0 = time.perf_counter()
    knn_cuda.load_library()
    so = knn_cuda.library_path()
    log(f"[build] {so.name} built/loaded in "
        f"{time.perf_counter() - t0:.1f} s from {knn_cuda.SOURCE.name}")
    report = so.with_suffix(".log")
    if report.exists():                  # present when this run compiled
        text = report.read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
        log(f"[build] ptxas: {len(regs)} kernel instances, at most "
            f"{max(regs, default=0)} registers a thread, {spills} bytes "
            f"of spills")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[build] card: {card}")
    return card


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


def phase_kernel(dev) -> dict:
    from pointunet_tpu_torch.ops import knn_cuda, pyramid

    xyz, tumor = _kernel_cloud(dev)
    log(f"[kernel] cloud {tuple(xyz.shape)}, tumor points "
        f"{int(tumor.sum())}")

    # capture the pyramid's six cell-window searches at their real shapes
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
    if len(calls) != LAUNCHES_PER_VOLUME:
        raise AssertionError(f"expected 6 cell-window searches, got {len(calls)}")

    shapes = []
    for n, (sp, s_ids, qp, qc3, k, r) in enumerate(calls):
        level, kind = n // 2, ("self", "up")[n % 2]
        cs = knn_cuda.cell_prefix_sums(s_ids, r)
        qc = qc3.to(torch.int32).contiguous()
        sp, qp = sp.contiguous(), qp.contiguous()
        got = knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r)
        want = knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r)
        torch.cuda.synchronize()
        bad = int((got != want).any(1).sum())
        err = int((got.long() - want.long()).abs().max())
        ms = cuda_ms(lambda: knn_cuda.knn_cell_window(sp, cs, qp, qc, k, r), 20)
        plain_ms = cuda_ms(
            lambda: knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r), 3
        )
        log(f"[kernel] L{level} {kind} k={k} Ns={sp.shape[0]} "
            f"Nq={qp.shape[0]} r={r}: rows differing {bad}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if bad:
            raise AssertionError(
                f"kernel disagrees with its plain version on {bad} rows "
                f"(L{level} {kind})"
            )
        shapes.append({
            "search": f"L{level} {kind} k={k} Ns={sp.shape[0]} Nq={qp.shape[0]}",
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        })

    # recall of the level-0 self search against exact brute force, on a
    # random query subset (rows are cell-sorted; tumor flags follow order)
    gen = torch.Generator(device=dev).manual_seed(1)
    pts = pyr.xyz[0]
    sel = torch.randperm(pts.shape[0], generator=gen, device=dev)[:RECALL_QUERIES]
    hit = _tie_aware_recall(pts, pts[sel], pyr.neigh_idx[0][sel], K)
    tmask = tumor[pyr.order.long()][sel].float()
    overall = float(hit.mean())
    tum = float((hit * tmask).sum() / tmask.sum().clamp(min=1))
    log(f"[kernel] tie-aware recall vs exact ({sel.numel()} queries): "
        f"overall {overall:.6f}, tumor {tum:.6f}")
    if overall < 0.99 or tum < 0.995:
        raise AssertionError(f"recall below the bar: {overall}, {tum}")
    return {
        "name": "knn_cell_window",
        "route": "cuda",
        "source": "pointunet_tpu_torch/csrc/knn_cell_window.cu",
        "replaces": "pointunet_tpu/ops/knn_pallas.py:208",
        "ms": shapes[0]["ms"],
        "plain_ms": shapes[0]["plain_ms"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "recall_overall": overall,
        "recall_tumor": tum,
        "shapes": shapes,
    }


def _write_cases(inbox: str) -> None:
    """N_CASES BraTS-layout cases: the bench's ellipsoid brain with normal
    noise, gzipped at level 1 once and copied (level 9 takes minutes)."""
    from pointunet_tpu_torch.data import nifti
    from pointunet_tpu_torch.data.loader import BRATS_MODALITIES

    rng = np.random.default_rng(1)
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME), indexing="ij")
    brain = (
        ((xx - 120.0) / 75.0) ** 2
        + ((yy - 122.0) / 88.0) ** 2
        + ((zz - 76.0) / 70.0) ** 2
    ) < 1.0
    first = "BraTS_smoke_000"
    os.makedirs(os.path.join(inbox, first))
    for mod in BRATS_MODALITIES:
        vol = rng.standard_normal(VOLUME).astype(np.float32) * brain
        path = os.path.join(inbox, first, f"{first}_{mod}.nii")
        nifti.save(vol, path)
        with open(path, "rb") as f, gzip.open(
            path + ".gz", "wb", compresslevel=1
        ) as g:
            shutil.copyfileobj(f, g)
        os.remove(path)
    for i in range(1, N_CASES):
        case = f"BraTS_smoke_{i:03d}"
        os.makedirs(os.path.join(inbox, case))
        for mod in BRATS_MODALITIES:
            shutil.copyfile(
                os.path.join(inbox, first, f"{first}_{mod}.nii.gz"),
                os.path.join(inbox, case, f"{case}_{mod}.nii.gz"),
            )


def phase_serve(dev) -> dict:
    from pointunet_tpu_torch.cli import serve
    from pointunet_tpu_torch.data import nifti
    from pointunet_tpu_torch.data.loader import (
        find_brats_cases,
        load_brats_volume,
    )
    from pointunet_tpu_torch.ops import knn_cuda

    with tempfile.TemporaryDirectory() as tmp:
        inbox = os.path.join(tmp, "inbox")
        outbox = os.path.join(tmp, "outbox")
        t0 = time.perf_counter()
        _write_cases(inbox)
        log(f"[serve] wrote {N_CASES} cases in "
            f"{time.perf_counter() - t0:.1f} s")

        knn_cuda.LAUNCHES = 0
        server = serve.main([
            "--inbox", inbox, "--outbox", outbox, "--once",
            "--roi", *map(str, ROI), "--n_point", str(N_POINTS),
            "--device", "cuda",
        ])
        launches = knn_cuda.LAUNCHES
        log(f"[serve] served {server.served} cases, KNN kernel launches "
            f"{launches}")
        if (server.served != N_CASES
                or launches != LAUNCHES_PER_VOLUME * N_CASES):
            raise AssertionError(
                f"expected {N_CASES} cases with {LAUNCHES_PER_VOLUME} "
                f"launches each, got {server.served} cases and {launches} "
                f"launches"
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
        # each stage timed by CUDA events
        mods = torch.from_numpy(np.ascontiguousarray(
            load_brats_volume(find_brats_cases(inbox)[0])
        )).to(dev)
    stages = _stage_split(server.pipes[VOLUME], mods)
    log("[serve] stage split (ms, mean of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return {"launches": launches, "latency_s": latencies, "stages_ms": stages}


def _stage_split(pipe, mods) -> dict:
    gen = torch.Generator(device=mods.device)
    totals = dict.fromkeys(
        ("attention", "sampling", "pyramid", "pointseg_scatter"), 0.0
    )
    repeats = 3
    with torch.inference_mode():
        for rep in range(repeats + 1):
            gen.manual_seed(0)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            mask = pipe._attention_mask(mods)
            ev[1].record()
            cloud = pipe._sample(mods, mask, gen)
            ev[2].record()
            pyr = pipe._pyramid_fn(cloud.xyz)
            ev[3].record()
            pipe._pointseg_scatter(
                pyr, cloud.xyz, cloud.features, cloud.xyz_origin
            )
            ev[4].record()
            torch.cuda.synchronize()
            if rep:                                 # rep 0 warms up
                for i, name in enumerate(totals):
                    totals[name] += ev[i].elapsed_time(ev[i + 1]) / repeats
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    # the f32 comparisons below run no matmul or convolution; TF32 is off
    # all the same so that nothing in them can round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = phase_build()
    kernel = phase_kernel(dev)
    serve = phase_serve(dev)
    kernel["launches"] = serve.pop("launches")
    kernel["serve"] = serve
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
