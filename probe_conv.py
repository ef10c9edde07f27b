"""Kernel 3 (the 3x3x3 conv) at the 19 shapes of the saliency net's
forward for each of the three contracts, for one or more trees of the
repo in turn on one CUDA card.

    python3 probe_conv.py [--trees DIR ...] [--repeats 20] [--out FILE]

Each tree (a directory that holds ``pointunet_tpu_torch``; by default
this checkout) runs in a process of its own with that directory first on
``sys.path``, so two commits compare on one card in one call (``--trees
old new new old``). In each process, for the bf16 serve ROI (1, 4, 160,
208, 192), one f32 ``segment`` window (1, 4, 64, 160, 160) and the bf16
Pancreas CT (1, 1, 160, 256, 256): the tree's saliency net with weights
from seed 0 (``cli.segment.build_pipeline``) runs one forward under
``POINTUNET_FASTCONV=pallas`` on a seeded normal input, its 19 kernel-3
calls captured (their outputs from the plain version, so that a faulty
kernel shows in the checks below, one shape at a time); then each
captured call goes through ``conv_cuda.conv3d_3x3`` and is held to
``chip_smoke.py``'s bars (bf16 within one ulp or 1e-5 x max |plain| of
the plain version; f32 within 1e-5 x max |plain| and, with TF32 off,
2e-5 x max(1, max |F.conv3d|) of ``F.conv3d``; a relaunch bit-equal; the
fused bias bit-equal) and timed by CUDA events (``--repeats`` calls after
a warm-up, and as replays of a CUDA graph of one call: the device's time
without the host's), beside ``F.conv3d`` and the bound (max of the bytes over
3.35 TB/s and the operations over 989 TFLOP/s bf16 or 495 / 3 f32). It
prints the card's name and power limit, a line per shape, a table of
every tree's ms per shape (the mean of a tree's runs), and, last, a JSON
object of them all; exit 1 if a bar failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CONTRACTS = (("bf16 ROI", "brats", True, (1, 4, 160, 208, 192)),
             ("f32 window", "brats", False, (1, 4, 64, 160, 160)),
             ("bf16 Pancreas", "pancreas", True, (1, 1, 160, 256, 256)))
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_TC_OPS_S = 495e12 / 3


def _ms(fn, repeats: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _graph_ms(fn, repeats: int) -> float:
    """Mean ms per replay of ``fn`` captured once in a CUDA graph: the
    device's time for the call without the host's launch overhead; nan
    where the call cannot be captured."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return _ms(graph.replay, repeats)
    except RuntimeError:
        return float("nan")


def _capture(model, x) -> list:
    """(x, w, bias) of the forward's kernel-3 calls, each answered by the
    plain version."""
    import torch

    from pointunet_tpu_torch.models import fastconv
    from pointunet_tpu_torch.ops import conv_cuda

    calls, real = [], fastconv.conv3d_3x3

    def record(*args):
        calls.append(args)
        return conv_cuda.conv3d_3x3_plain(*args)

    fastconv.conv3d_3x3 = record
    os.environ["POINTUNET_FASTCONV"] = "pallas"
    try:
        with torch.inference_mode():
            model(x)
    finally:
        fastconv.conv3d_3x3 = real
        del os.environ["POINTUNET_FASTCONV"]
    return calls


def _case(x, w, b, repeats: int) -> dict:
    import torch
    import torch.nn.functional as F

    from pointunet_tpu_torch.ops import conv_cuda

    bf16 = x.dtype == torch.bfloat16
    bsz, cin, d, h, wd = x.shape
    cout = w.shape[0]
    got = conv_cuda.conv3d_3x3(x, w)
    torch.cuda.synchronize()
    plain = conv_cuda.conv3d_3x3_plain(x, w)
    gap = (got.float() - plain.float()).abs()
    scale = float(plain.float().abs().max())
    checks = {}
    if bf16:
        e = torch.floor(torch.log2(torch.maximum(
            got.float().abs(), plain.float().abs()).clamp(
                min=torch.finfo(torch.float32).tiny)))
        ulp = torch.exp2(e - 7)
        checks["one ulp or 1e-5 x max|plain|"] = bool(
            (gap <= ulp.clamp(min=1e-5 * scale)).all())
        del e, ulp
    else:
        checks["1e-5 x max|plain|"] = float(gap.max()) <= 1e-5 * scale
        lib = F.conv3d(x, w, padding=1)
        checks["2e-5 x max(1, max|F.conv3d|)"] = float(
            (got - lib).abs().max()) <= 2e-5 * max(1.0, float(lib.abs().max()))
        del lib
    max_err = float(gap.max())
    del gap, plain
    checks["bit-equal relaunch"] = torch.equal(got, conv_cuda.conv3d_3x3(x, w))
    if b is not None:
        checks["fused bias bit-equal"] = torch.equal(
            conv_cuda.conv3d_3x3(x, w, b), got + b.view(1, -1, 1, 1, 1))
    del got
    torch.cuda.synchronize()
    ms = _ms(lambda: conv_cuda.conv3d_3x3(x, w, b), repeats)
    lib_ms = _ms(lambda: F.conv3d(x, w, b, padding=1), repeats)
    graph_ms = _graph_ms(lambda: conv_cuda.conv3d_3x3(x, w, b), repeats)
    lib_graph_ms = _graph_ms(lambda: F.conv3d(x, w, b, padding=1), repeats)
    nbytes = x.element_size() * (x.numel() + w.numel()
                                 + bsz * cout * d * h * wd
                                 + (0 if b is None else b.numel()))
    ops = 2 * 27 * cin * cout * bsz * d * h * wd
    rate = BF16_OPS_S if bf16 else F32_TC_OPS_S
    by_bytes = nbytes / HBM_BYTES_S >= ops / rate
    return {"cin": cin, "cout": cout, "volume": [d, h, wd],
            "path": conv_cuda.conv_path(x.dtype, cin, cout, wd),
            "ms": ms, "library_ms": lib_ms, "graph_ms": graph_ms,
            "library_graph_ms": lib_graph_ms,
            "bound_ms": max(nbytes / HBM_BYTES_S, ops / rate) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "max_abs_err": max_err, "max_plain": scale, "checks": checks}


def child(tree: str, repeats: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import pointunet_tpu_torch
    import torch

    from pointunet_tpu_torch.cli.segment import build_pipeline

    if not pointunet_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {pointunet_tpu_torch.__file__}, "
                         f"not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {}
    for tag, dataset, fast, shape in CONTRACTS:
        model = build_pipeline(argparse.Namespace(
            dataset=dataset, fast=fast, sa_stride=None, n_point=180_000,
            saliency_checkpoint=None, pointseg_checkpoint=None,
        )).saliency_model.to(dev).eval()
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(shape, generator=gen, device=dev)
        calls = _capture(model, x)
        del model, x
        cases = []
        while calls:
            xc, wc, bc = calls.pop(0)
            try:
                with torch.inference_mode():
                    case = _case(xc, wc, bc, repeats)
            except RuntimeError as e:           # a launch the kernel refused
                case = {"cin": xc.shape[1], "cout": wc.shape[0],
                        "volume": list(xc.shape[2:]), "path": "-",
                        "ms": float("nan"), "library_ms": float("nan"),
                        "bound_ms": float("nan"), "bound_by": "-",
                        "max_abs_err": float("nan"),
                        "max_plain": float("nan"),
                        "checks": {str(e): False}}
            del xc, wc, bc
            torch.cuda.empty_cache()
            ok = all(case["checks"].values())
            print(f"[probe] {tree} {tag} #{len(cases)} {case['cin']}->"
                  f"{case['cout']} at {tuple(case['volume'])} on "
                  f"{case['path']}: kernel {case['ms']:.4f} ms (graph "
                  f"{case.get('graph_ms', float('nan')):.4f}), F.conv3d "
                  f"{case['library_ms']:.4f} ms (graph "
                  f"{case.get('library_graph_ms', float('nan')):.4f}), bound "
                  f"{case['bound_ms']:.4f} ms by {case['bound_by']}; max "
                  f"|kernel - plain| {case['max_abs_err']:.3e} (max "
                  f"{case['max_plain']:.3e}); "
                  + ("bars held" if ok else f"FAILED {case['checks']}"),
                  flush=True)
            cases.append(case)
        out[tag] = cases
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--trees", nargs="+", default=["."])
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.repeats)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_conv: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[probe] card: {card}", flush=True)
    runs = []
    failed = False
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree), "--repeats", str(args.repeats)],
            capture_output=True, text=True,
        )
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"probe_conv: tree {tree} failed "
                             f"({proc.returncode})")
        result = json.loads(lines[-1])
        failed |= any(not all(c["checks"].values())
                      for cases in result.values() for c in cases)
        runs.append((tree, result))
    trees = list(dict.fromkeys(t for t, _ in runs))
    mean = {}
    for tree in trees:
        mine = [r for t, r in runs if t == tree]
        mean[tree] = {tag: [sum(r[tag][i]["ms"] for r in mine) / len(mine)
                            for i in range(len(mine[0][tag]))]
                      for tag in mine[0]}
    first = runs[-1][1]
    for tag, cases in first.items():
        print(f"[probe] {tag}: # Cin->Cout volume path | "
              + " | ".join(f"{t} ms" for t in trees)
              + " | F.conv3d ms | bound ms (by) | " + card)
        for i, c in enumerate(cases):
            print(f"[probe] {tag} #{i} {c['cin']}->{c['cout']} "
                  f"{tuple(c['volume'])} {c['path']} | "
                  + " | ".join(f"{mean[t][tag][i]:.4f}" for t in trees)
                  + f" | {c['library_ms']:.4f} | {c['bound_ms']:.4f} "
                  f"({c['bound_by']})")
        print(f"[probe] {tag} sum | "
              + " | ".join(f"{sum(mean[t][tag]):.4f}" for t in trees)
              + f" | {sum(c['library_ms'] for c in cases):.4f} | "
              f"{sum(c['bound_ms'] for c in cases):.4f}")
    report = {"card": card, "trees": trees, "mean_ms": mean,
              "runs": [{"tree": t, "result": r} for t, r in runs]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
    print(json.dumps({"card": card, "trees": trees, "mean_ms": mean,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
