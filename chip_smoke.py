"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths (``pointunet_tpu_torch``), serving and
training, at the full BraTS width and fails (non-zero exit, no result
line) on any fault. Phases:

1. build: compile both CUDA kernels from the sources in this checkout
   (one ``nvcc`` each, in parallel), print each ptxas report and the
   card's name and power limit;
2. kernel: on a 365,000-point cloud drawn by the port's sampler from a
   240x240x155 volume (35% random brain plus an all-voxel tumor ball),
   capture the six cell-window searches of the pyramid (self k=16 and up
   k=1 at levels 0-2) and run each through the KNN kernel and through its
   plain version: indices must be equal on every row. Tie-aware recall of
   the level-0 self search against exact brute force must be >= 0.99
   overall and >= 0.995 on tumor queries. Times come from CUDA events;
3. scatter: on that cloud's pyramid, the sorted scatter kernel at the
   reference's three bars (L0 self C=8, L1 self C=16, L0 pool C=32 with
   unsorted queries). Each result must be within max relative error 1e-5
   of the exact f64 ``index_add_``, within 1e-6 x max |exact| of its
   plain version (f32 summation order), and bit-equal across two
   launches; kernel, plain and ``index_add_`` are timed;
4. serve: write 3 synthetic BraTS cases (4x240x240x155 f32, ellipsoid
   brain) to a temporary inbox and serve them with
   ``pointunet_tpu_torch.cli.serve`` (ROI 192x208x155, 365,000 points,
   bf16). Each must yield a (240, 240, 155) uint8 label volume with
   values in {0, 1, 2, 4}, at most 365,000 labelled voxels, and exactly 6
   KNN kernel launches; then time each stage with CUDA events;
5. train: write 4 synthetic BraTS point clouds (~600k labelled points:
   an all-voxel tumor ball plus background) in the prepared-tree layout,
   run ``cli.run_brats`` ``--mode train --n_epoch 1`` on 3 of them
   (validating on the 4th) and ``--mode test`` (a (155, 240, 240, 4)
   probability volume), then 10 steps on one cloud at lr 1e-3: finite
   losses whose last three average below the first, the step split by
   CUDA events (pyramid, forward, backward, optimizer), peak memory, and
   exactly 8 scatter and 6 KNN kernel launches a step. The 8 scatter
   inputs of the first step are captured and held to the checks of
   phase 3.

Before the last line it prints the card (``nvidia-smi``) and one JSON
object describing the kernels; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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
SCATTERS_PER_STEP = 8          # L0 self x2, L0 pool, L1 self x2, L1 pool,
                               # L2 self x2 (the L2 pool is under MIN_ROWS)
RECALL_QUERIES = 65_536
TRAIN_STEPS = 10
N_CLOUDS = 4                   # run_brats: 3 to train on, 1 to validate
CLOUD_POINTS = 600_000         # labelled points of a prepared cloud
# the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s and
# f32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


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
    from pointunet_tpu_torch.ops import cuda_build, knn_cuda, scatter_sorted

    sources = [knn_cuda.SOURCE, scatter_sorted.SOURCE]
    t0 = time.perf_counter()
    sos = cuda_build.build_all(sources)
    knn_cuda.load_library()
    scatter_sorted.load_library()
    log(f"[build] {', '.join(so.name for so in sos)} built/loaded in "
        f"{time.perf_counter() - t0:.1f} s")
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[build] card: {card}")
    return card


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 rate, in ms."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3


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


def phase_kernel(dev):
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
        by = "bytes" if nbytes / HBM_BYTES_S >= 8 * cand / F32_OPS_S else "operations"
        log(f"[kernel] L{level} {kind} k={k} Ns={ns} Nq={nq} r={r}: rows "
            f"differing {bad}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {by} ({nbytes} B, {cand} candidates)")
        if bad:
            raise AssertionError(
                f"kernel disagrees with its plain version on {bad} rows "
                f"(L{level} {kind})"
            )
        shapes.append({
            "search": f"L{level} {kind} k={k} Ns={ns} Nq={nq}",
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "max_rel_err": rel, "bound_ms": b_ms, "bound_by": by,
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
        "bound_ms": shapes[0]["bound_ms"],
        "bound_by": shapes[0]["bound_by"],
        "library_ms": None,             # no one PyTorch call does this
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_rel_err": max(s["max_rel_err"] for s in shapes),
        "recall_overall": overall,
        "recall_tumor": tum,
        "shapes": shapes,
    }, pyr


def _scatter_case(name: str, args) -> dict:
    """One sorted-scatter input through the kernel (twice), its plain
    version and the exact f64 ``index_add_``; times and bound."""
    from pointunet_tpu_torch.ops import scatter_sorted as ss

    ct, idx, s_ids, qcs, k, r = args
    ns, (nqk, c) = s_ids.shape[0], ct.shape
    got = ss.scatter_sorted(*args)
    again = ss.scatter_sorted(*args)
    plain = ss.scatter_sorted_plain(*args)
    exact = torch.zeros((ns, c), dtype=torch.float64, device=ct.device)
    exact.index_add_(0, idx.long(), ct.double())
    torch.cuda.synchronize()
    scale = float(exact.abs().max().clamp(min=1e-6))
    rel = float((got.double() - exact).abs().max()) / scale
    plain_err = float((got - plain).abs().max())
    bitwise = torch.equal(got, again)
    del exact, plain, again
    ms = cuda_ms(lambda: ss.scatter_sorted(*args), 20)
    plain_ms = cuda_ms(lambda: ss.scatter_sorted_plain(*args), 3)
    library_ms = cuda_ms(
        lambda: torch.zeros((ns, c), device=ct.device).index_add_(0, idx, ct),
        20,
    )
    # bound: ct, idx, the support cells and the query prefix sums read
    # once, grad written once; one f32 add per ct element
    nbytes = 4 * (nqk * c + nqk + ns + qcs.numel() + ns * c)
    b_ms = bound_ms(nbytes, nqk * c)
    by = "bytes" if nbytes / HBM_BYTES_S >= nqk * c / F32_OPS_S else "operations"
    log(f"[scatter] {name}: Ns={ns} rows={nqk} C={c} r={r}: max rel err "
        f"{rel:.3e} vs exact, max |kernel - plain| {plain_err:.3e}, "
        f"bit-equal relaunch {bitwise}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {by}")
    # the plain version sums the same rows in f32 in another order
    if not rel < 1e-5 or not plain_err <= 1e-6 * scale or not bitwise:
        raise AssertionError(
            f"sorted scatter {name}: max rel err {rel:.3e}, max |kernel - "
            f"plain| {plain_err:.3e} (bound {1e-6 * scale:.3e}), bit-equal "
            f"relaunch {bitwise}"
        )
    return {"case": name, "ns": ns, "rows": nqk, "c": c, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": by, "max_rel_err": rel, "max_abs_err_plain": plain_err}


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


def _step_cases(captured, r0) -> list:
    """The checks of phase 3 on the scatter inputs of one train step."""
    if len(captured) != SCATTERS_PER_STEP:
        raise AssertionError(
            f"expected {SCATTERS_PER_STEP} sorted scatters in a train step, "
            f"got {len(captured)}"
        )
    grids = [((r0 - 1) >> lvl) + 1 for lvl in range(3)]
    cases = []
    for args in captured:
        ct, idx, s_ids, qcs, k, r = args
        kind = "self" if ct.shape[0] == s_ids.shape[0] * k else "pool"
        cases.append(_scatter_case(f"step L{grids.index(r)} {kind}", args))
    log(f"[scatter] train step: {len(cases)} scatters, kernel "
        f"{sum(c['ms'] for c in cases):.4f} ms, bound "
        f"{sum(c['bound_ms'] for c in cases):.4f} ms, index_add_ "
        f"{sum(c['library_ms'] for c in cases):.4f} ms")
    return cases


def _scatter_summary(bars, steps, launches, serve_launches) -> dict:
    """Kernel 2's entry of the ``kernels`` line: the numbers of the
    largest shape of a train step, every shape under ``shapes``."""
    top = max(steps, key=lambda c: c["rows"] * c["c"])
    cases = bars + steps
    return {
        "name": "scatter_sorted",
        "route": "cuda",
        "source": "pointunet_tpu_torch/csrc/scatter_sorted.cu",
        "replaces": "pointunet_tpu/ops/scatter_sorted.py:213",
        "launches": launches,
        "launches_by_path": {"serve": serve_launches, "train": launches},
        "shape": top["case"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "max_abs_err": max(c["max_abs_err_plain"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "step_ms": sum(c["ms"] for c in steps),
        "shapes": cases,
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
    from pointunet_tpu_torch.ops import knn_cuda, scatter_sorted

    with tempfile.TemporaryDirectory() as tmp:
        inbox = os.path.join(tmp, "inbox")
        outbox = os.path.join(tmp, "outbox")
        t0 = time.perf_counter()
        _write_cases(inbox)
        log(f"[serve] wrote {N_CASES} cases in "
            f"{time.perf_counter() - t0:.1f} s")

        knn_cuda.LAUNCHES = 0
        scatter_sorted.LAUNCHES = 0
        server = serve.main([
            "--inbox", inbox, "--outbox", outbox, "--once",
            "--roi", *map(str, ROI), "--n_point", str(N_POINTS),
            "--device", "cuda",
        ])
        launches = knn_cuda.LAUNCHES
        scatters = scatter_sorted.LAUNCHES
        log(f"[serve] served {server.served} cases, KNN kernel launches "
            f"{launches}, scatter kernel launches {scatters}")
        if (server.served != N_CASES or scatters
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
    return {"launches": launches, "scatters": scatters,
            "latency_s": latencies, "stages_ms": stages}


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


def _write_clouds(root: str, dev) -> list:
    """N_CLOUDS prepared BraTS point clouds (``original_ply/<ID>.ply`` with
    x, y, z, 4 modalities and class; ``input0.01/<ID>_xyz_origin.npy``):
    an all-voxel tumour ball plus random background, CLOUD_POINTS each."""
    from pointunet_tpu_torch.cli.profile_train import synthetic_cloud
    from pointunet_tpu_torch.data.ply import write_ply

    os.makedirs(os.path.join(root, "original_ply"))
    os.makedirs(os.path.join(root, "input0.01"))
    names = []
    for i in range(N_CLOUDS):
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
    from pointunet_tpu_torch.ops import knn_cuda, scatter_sorted
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
        knn_cuda.LAUNCHES = 0
        scatter_sorted.LAUNCHES = 0
        t0 = time.perf_counter()
        state = run_brats.main(["--mode", "train", "--n_epoch", "1"] + common)
        torch.cuda.synchronize()
        knn, scatters = knn_cuda.LAUNCHES, scatter_sorted.LAUNCHES
        steps = len(names) - 1
        log(f"[train] run_brats --mode train: {state.step} steps + 1 "
            f"validation cloud in {time.perf_counter() - t0:.1f} s; KNN "
            f"kernel launches {knn}, scatter kernel launches {scatters}")
        if (state.step != steps
                or knn != LAUNCHES_PER_VOLUME * (steps + 1)
                or scatters != SCATTERS_PER_STEP * steps):
            raise AssertionError(
                f"run_brats train: {state.step} steps, {knn} KNN and "
                f"{scatters} scatter launches"
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
        knn_cuda.LAUNCHES = 0
        scatter_sorted.LAUNCHES = 0
        with _capture() if i == 0 else contextlib.nullcontext() as captured:
            m, split = timed_step(trainer, state, xyz, feats, labels)
        per_step = (knn_cuda.LAUNCHES, scatter_sorted.LAUNCHES)
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
    return {"knn_launches": knn, "scatter_launches": scatters,
            "losses": losses, "split_ms": mean, "peak_gb": peak,
            "step_cases": step_cases}


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
    kernel, pyr = phase_kernel(dev)
    bars = phase_scatter(dev, pyr)
    del pyr
    torch.cuda.empty_cache()
    serve = phase_serve(dev)
    torch.cuda.empty_cache()
    train = phase_train(dev)
    # launches: the train path's run (this slice's path); each path's
    # count beside it
    kernel["launches"] = train["knn_launches"]
    kernel["launches_by_path"] = {"serve": serve.pop("launches"),
                                  "train": train["knn_launches"]}
    scatter = _scatter_summary(bars, train.pop("step_cases"),
                               train["scatter_launches"],
                               serve.pop("scatters"))
    kernel["serve"] = serve
    scatter["train"] = train
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel, scatter]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
