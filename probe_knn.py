"""Probe of the cell-window KNN kernel (kernel 1) on one CUDA card.

    python3 probe_knn.py [--variants 64,16,2048 128,16,1024 ...]

On the cloud and the six pyramid searches of ``chip_smoke.py``'s phase 2
it times:

1. the first design of kernel 1 (one thread a query, a 16-slot insertion
   list in registers), embedded below, in three builds: as it shipped,
   with the insertion removed (d^2 of every candidate summed instead) and
   with only the candidate loads (coordinates summed): what sets its time;
2. ``pointunet_tpu_torch/csrc/knn_cell_window.cu`` built with each
   variant of ``--variants``: leading numbers set ``MACROS`` in order
   (``-DKNN_TILE=...``), each held
   equal to the plain version on every row of every search (exit 1 if
   one differs; a small CHUNK drives the ring of shared-memory slots); a
   last, non-numeric field names a part taken out (``CUTS``), timed and
   not checked.

Times are CUDA events, mean of 20 launches. It prints one line a build and
search and, last, a JSON object of all times (ms). It builds with ``nvcc``
into ``pointunet_tpu_torch/_build/probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke

FIRST_DESIGN = r"""
#include <cuda_runtime.h>
#include <math_constants.h>
namespace {
template <int K>
__global__ void first_design(const float* __restrict__ sp,
                             const int* __restrict__ cell_start,
                             const float* __restrict__ qp,
                             const int* __restrict__ qc, int* __restrict__ out,
                             int nq, int r) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const float qx = qp[3 * q], qy = qp[3 * q + 1], qz = qp[3 * q + 2];
  const int cx = qc[3 * q], cy = qc[3 * q + 1], cz = qc[3 * q + 2];
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, r - 1);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) { bd[t] = CUDART_INF_F; bi[t] = -1; }
  float acc = 0.f;
  for (int dx = -1; dx <= 1; ++dx) {
    const int x = cx + dx;
    if (x < 0 || x >= r) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = cy + dy;
      if (y < 0 || y >= r || z0 > z1) continue;
      const int base = (x * r + y) * r;
      const int start = cell_start[base + z0], end = cell_start[base + z1 + 1];
      for (int row = start; row < end; ++row) {
        const float sx = sp[3 * row], sy = sp[3 * row + 1], sz = sp[3 * row + 2];
#if MODE == 2
        acc += sx + sy + sz;
#else
        const float ex = __fsub_rn(qx, sx), ey = __fsub_rn(qy, sy),
                    ez = __fsub_rn(qz, sz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                  __fmul_rn(ez, ez));
#if MODE == 1
        acc += d;
#else
        if (d < bd[K - 1]) {
#pragma unroll
          for (int t = K - 1; t > 0; --t) {
            if (bd[t - 1] > d) { bd[t] = bd[t - 1]; bi[t] = bi[t - 1]; }
            else if (bd[t] > d) { bd[t] = d; bi[t] = row; }
          }
          if (bd[0] > d) { bd[0] = d; bi[0] = row; }
        }
#endif
#endif
      }
    }
  }
#if MODE == 0
  const int first = bi[0] >= 0 ? bi[0] : 0;
#pragma unroll
  for (int t = 0; t < K; ++t) out[q * K + t] = bi[t] >= 0 ? bi[t] : first;
#else
  out[q * K] = __float_as_int(acc);
#endif
}
}  // namespace
extern "C" int knn_cell_window_launch(const void* sp, const void* cs,
                                      const void* qp, const void* qc, void* out,
                                      int ns, int nq, int k, int r, void* st) {
  const int blocks = (nq + 127) / 128;
  auto s = static_cast<cudaStream_t>(st);
  auto a = static_cast<const float*>(sp);
  auto b = static_cast<const int*>(cs);
  auto c = static_cast<const float*>(qp);
  auto d = static_cast<const int*>(qc);
  auto o = static_cast<int*>(out);
  if (k == 1) first_design<1><<<blocks, 128, 0, s>>>(a, b, c, d, o, nq, r);
  else first_design<16><<<blocks, 128, 0, s>>>(a, b, c, d, o, nq, r);
  return static_cast<int>(cudaGetLastError());
}
"""
FIRST_MODES = {"first design": 0, "first, no insertion": 1,
               "first, loads only": 2}
# the block-shape macros a variant sets, in order (the source's defaults
# for those it leaves out)
MACROS = ["KNN_TILE", "KNN_WARPS", "KNN_CHUNK", "KNN_UP_LANES",
          "KNN_UP_WARPS", "KNN_UP_CHUNK"]
# parts of the new kernel taken out to see what sets its time (the last
# field of a variant): its text replaced in a copy of the source
CUTS = {
    "staging only": ("for (int j0 = warp * kQW; j0 < nt;",
                     "for (int j0 = nt; j0 < nt;"),
    "no selection": ("const bool pass = key < th;",
                     "const bool pass = false; best = umin64(best, key);"),
    "no pruning": ("if (pa < pb && near)", "if (pa < pb)"),
}


def build(builds: dict) -> dict:
    """{name: (source path, [-D flags])} -> {name: launch function}; one
    nvcc a build, all started together."""
    from pointunet_tpu_torch.ops import cuda_build, knn_cuda

    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, defines)) in enumerate(builds.items()):
        so = out_dir / f"probe_{i}.so"
        cmd = [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *defines, "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        regs = " ".join(line.strip() for line in report.splitlines()
                        if "registers" in line or "spill" in line)
        print(f"[probe build] {name}: {regs}", flush=True)
        fn = ctypes.CDLL(str(so)).knn_cell_window_launch
        fn.argtypes = knn_cuda._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variants", nargs="*",
                        default=["64", "64,staging only", "64,no pruning",
                                 "64,no selection", "64,16,64,8,8,64"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_knn: no CUDA device", file=sys.stderr)
        return 1
    from pointunet_tpu_torch.ops import cuda_build, knn_cuda, pyramid

    dev = torch.device("cuda", 0)
    first_src = cuda_build.BUILD_DIR / "probe" / "first_design.cu"
    first_src.parent.mkdir(parents=True, exist_ok=True)
    first_src.write_text(FIRST_DESIGN)
    builds = {name: (first_src, [f"-DMODE={m}"])
              for name, m in FIRST_MODES.items()}
    for v in args.variants:
        fields = v.split(",")
        nums = [f for f in fields if f.isdigit()]
        cut = fields[len(nums):]
        name = " ".join(f"{m[4:].lower()} {x}" for m, x in zip(MACROS, nums))
        src = knn_cuda.SOURCE
        if cut:
            name += f", {cut[0]}"
            old, new = CUTS[cut[0]]
            text = src.read_text()
            if old not in text:
                raise ValueError(f"{cut[0]}: no {old!r} in {src.name}")
            src = first_src.with_name(f"cut_{len(builds)}.cu")
            src.write_text(text.replace(old, new))
        builds[name] = (src, [f"-D{m}={x}" for m, x in zip(MACROS, nums)])
    fns = build(builds)

    # the six searches' inputs; the pyramid's bookkeeping does not read
    # the neighbour rows' values, so the capture returns zeros
    xyz, _ = chip_smoke._kernel_cloud(dev)
    calls, search = [], pyramid._search_sorted

    def record(sp, s_ids, qp, qc3, k, r):
        calls.append((sp, s_ids, qp, qc3, k, r))
        return torch.zeros((qp.shape[0], k), dtype=torch.int32, device=dev)

    pyramid._search_sorted = record
    try:
        pyramid.build_pyramid(xyz, chip_smoke.K, chip_smoke.RATIOS)
    finally:
        pyramid._search_sorted = search
    shapes = []
    for sp, s_ids, qp, qc3, k, r in calls:
        cs = knn_cuda.cell_prefix_sums(s_ids, r)
        shapes.append((sp.contiguous(), cs, qp.contiguous(),
                       qc3.to(torch.int32).contiguous(), k, r))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[probe] card: {card}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times, failed = {}, False
    for name, fn in fns.items():
        checked = FIRST_MODES.get(name, 0) == 0 and "," not in name
        times[name] = []
        for n, (sp, cs, qp, qc, k, r) in enumerate(shapes):
            out = torch.empty((qp.shape[0], k), dtype=torch.int32, device=dev)

            def run():
                rc = fn(sp.data_ptr(), cs.data_ptr(), qp.data_ptr(),
                        qc.data_ptr(), out.data_ptr(), sp.shape[0],
                        qp.shape[0], k, r, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            ms = chip_smoke.cuda_ms(run, 20)
            bad = ""
            if checked:
                want = knn_cuda.knn_cell_window_plain(sp, cs, qp, qc, k, r)
                rows = int((out != want).any(1).sum())
                bad = f", rows differing from plain {rows}"
                failed |= rows > 0
            times[name].append(ms)
            print(f"[probe] {name}: L{n // 2} {('self', 'up')[n % 2]} k={k} "
                  f"Nq={qp.shape[0]}: {ms:.4f} ms{bad}", flush=True)
        print(f"[probe] {name}: 6 searches {sum(times[name]):.4f} ms",
              flush=True)
    print(json.dumps({"card": card, "ms": times}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
