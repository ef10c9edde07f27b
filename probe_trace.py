"""The port's tracer on a CUDA card: what it records beside the
benchmark's own spans, where the attention stage's kernels run, and what
recording costs.

    python3 probe_trace.py run --workload brats.serve --seed 7 [--seconds 40]
    python3 probe_trace.py place --config brats [--requests 4]
    python3 probe_trace.py ab --workload brats.train_point [--blocks 8]
    python3 probe_trace.py self --workload brats.train_point [--calls 100]

``run`` runs one cell of the benchmark traced (as ``perfbench/run.py
--trace 1``), prints its result line, then a line ``probe {...}`` read in
the same process: the program's four stage spans (device ms) beside the
harness's over the same window of requests, the host split
(``copy_in_ms`` + ``copy_out_ms`` + ``relabel_ms``) as a share of
``service_ms``, and each idle label's share of the listed idle seconds.

``place`` builds the configuration's serving pipeline from the seed, as
the benchmark does, and prints one JSON line: whether the GPU-side
shadows of the tracer's ranges are user annotations, and the device ms a
request of each kernel under each ``saliency.<module>`` range (the
innermost range around the CPU op that launched it). (The host syncs
against CUDA's sync debug mode are a card test: ``tests/test_torch_trace.py
-m card``.)

``self`` gives the host time a cell's calls spend inside the tracer, and
``ab`` a cell's calls with the tracer recording and with it stubbed out,
in turns in one process (see each). Each mode also writes what it
printed, the whole placement included, to ``chiprun_out/trace_*.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

STAGES = ("attention", "sampling", "pyramid", "pointseg")
OUT = ROOT / "chiprun_out"


def _save(name: str, obj: dict) -> None:
    OUT.mkdir(exist_ok=True)
    (OUT / f"trace_{name}.json").write_text(json.dumps(obj, indent=1))


def _env():
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def run_cell(args) -> dict:
    import torch

    from perfbench import device as device_mod, run
    from pointunet_tpu_torch.core import trace

    print(device_mod.card_line(), flush=True)
    result = run.execute(args.workload, args.seed, args.seconds, True,
                         torch.device("cuda", 0), run.T0)
    for key in ("errors", "readings", "phases"):
        result.pop(key)
    print(json.dumps(result), flush=True)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    gaps = result["breakdown"]["idle_gaps"]
    idle = sum(s for _, s in gaps) or 1.0
    probe = {"idle_label_share": {k: s / idle for k, s in gaps},
             "counters": trace.totals()}
    if args.workload.endswith(".serve"):
        for s in STAGES:
            prog = trace.window_mean(
                "serve", result["attempted"],
                lambda r, s=s: trace.span_ms(r, f"serve.{s}", "device"))
            probe[f"{s}_ms"] = {"program": prog,
                                "harness": metrics.get(f"{s}_ms.serve")}
        host = sum(metrics.get(f"{k}_ms.serve") or 0.0
                   for k in ("copy_in", "copy_out", "relabel"))
        probe["host_split_over_service"] = host / metrics["service_ms.serve"]
    print("probe " + json.dumps(probe), flush=True)
    _save(f"run_{args.workload}_{args.seed}", {"result": result, "probe": probe})
    return probe


def _placement(events, prefix: str = "saliency.") -> dict:
    """{range: {kernel: device ms}}: each kernel under the innermost
    ``prefix`` range around the CPU op that launched it."""
    table = defaultdict(lambda: defaultdict(float))
    for e in events:
        if not e.kernels:
            continue
        p = e
        while p is not None and not p.name.startswith(prefix):
            p = p.cpu_parent
        if p is None:
            continue
        for k in e.kernels:
            table[p.name][k.name] += k.duration / 1e3
    return table


def place(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import device as device_mod, manifest, weights
    from perfbench.generators import serve_volumes

    dev = torch.device("cuda", 0)
    cfg = manifest.read_json("configs", args.config)
    traffic = manifest.read_json("traffic", "serve")
    pipe, _ = serve_volumes.build(cfg, args.seed, dev)
    volume = serve_volumes.pool(cfg, traffic, args.seed, dev)[0]
    brats = cfg["serve"]["brats_labels"]

    def request():
        return pipe.segment_volume(volume, seed=weights.sub_seed(args.seed, 5),
                                   brats_labels=brats)

    for _ in range(2):
        request()
    torch.cuda.synchronize()
    out = {"card": device_mod.card_line(), "config": args.config}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.requests):
            request()
        torch.cuda.synchronize()
    events = list(prof.events())
    mine = ("serve.", "saliency.")
    shadows = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith(mine)]
    out["gpu_shadows"] = {"count": len(shadows),
                          "user_annotation": sum(
                              bool(getattr(e, "is_user_annotation", False))
                              for e in shadows)}
    table = _placement(events)
    out["placement_ms_a_request"] = {
        mod: {k: v / args.requests for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])}
        for mod, kernels in sorted(table.items())}
    for label, key in (("generic_bf16", "implicit_convolveNd_sgemm"),
                       ("f32_indexed", "sm80_xmma_fprop_implicit_gemm_indexed_f32f32")):
        out[label] = {mod: round(sum(v for k, v in kernels.items() if key in k)
                                 / args.requests, 4)
                      for mod, kernels in table.items()
                      if any(key in k for k in kernels)}

    _save(f"place_{args.config}", out)
    out.pop("placement_ms_a_request")
    print(json.dumps(out), flush=True)
    return out


def _cell_call(workload: str, seed: int):
    """``call(i)``: the cell's i-th request or step, on the program its
    generator builds from ``seed``."""
    import torch

    from perfbench import manifest

    w = manifest.workload(manifest.load(), workload)
    cfg = manifest.read_json("configs", w["config"])
    traffic = manifest.read_json("traffic", w["traffic"])
    gen = manifest.module("generators", traffic["generator"])
    dev = torch.device("cuda", 0)
    if traffic["generator"] == "serve_volumes":
        pipe, _ = gen.build(cfg, seed, dev)
        pool = gen.pool(cfg, traffic, seed, dev)
        brats = cfg["serve"]["brats_labels"]

        def call(i):
            pipe.segment_volume(pool[i % len(pool)], seed=i, brats_labels=brats)
    else:
        trainer, state, _ = gen.build(cfg, seed, dev)
        pool = gen.pool(cfg, traffic, seed, dev)

        def call(i):
            trainer.train_step(state, *pool[i % len(pool)])
    return call


def selfcost(args) -> dict:
    """The host time spent inside the tracer's own calls (opening and
    closing records and spans, counting, reading finished events back
    into the pool; of it, in recording CUDA events) over ``args.calls`` of
    the cell's requests or steps, against their wall; us and per cent a
    call, and the CUDA events made. As shipped, with every
    ``gather.backward`` a device span (``TIMED_EVERY`` 1), and around
    no-ops (what the timing itself adds)."""
    import torch

    from perfbench import device as device_mod
    from pointunet_tpu_torch.core import trace
    from pointunet_tpu_torch.ops import scatter_sorted

    call = _cell_call(args.workload, args.seed)
    for i in range(3):
        call(i)
    spent = [0.0]

    def timed(fn):
        def inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        return inner

    class TimedCM:
        def __init__(self, cm):
            self.cm = cm

        def __enter__(self):
            t0 = time.perf_counter()
            out = self.cm.__enter__()
            spent[0] += time.perf_counter() - t0
            return out

        def __exit__(self, *exc):
            t0 = time.perf_counter()
            out = self.cm.__exit__(*exc)
            spent[0] += time.perf_counter() - t0
            return out

    names = ("request", "span", "count")
    real = {k: getattr(trace, k) for k in names}
    record = torch.cuda.Event.record
    in_record = [0.0]
    made = [0]
    new_event = trace._new_event

    def timed_record(ev, stream=None):
        t0 = time.perf_counter()
        try:
            return record(ev, stream)
        finally:
            in_record[0] += time.perf_counter() - t0

    def counted_new_event():
        made[0] += 1
        return new_event()

    stub = {"request": lambda kind: contextlib.nullcontext(0),
            "span": lambda name, device=False, every=1: contextlib.nullcontext(),
            "count": lambda name, n=1: None}

    def instrument(fns):
        trace.count = timed(fns["count"])
        trace.request = lambda kind: TimedCM(timed(fns["request"])(kind))
        trace.span = lambda name, device=False, every=1: TimedCM(
            timed(fns["span"])(name, device, every))

    torch.cuda.Event.record = timed_record
    trace._new_event = counted_new_event
    every = scatter_sorted.TIMED_EVERY
    out = {"card": device_mod.card_line(), "workload": args.workload,
           "calls": args.calls, "timed_every": every}
    for part, fns, k in (("shipped", real, every), ("every_gather_timed", real, 1),
                         ("no_ops", stub, every)):
        instrument(fns)
        scatter_sorted.TIMED_EVERY = k
        spent[0] = in_record[0] = 0.0
        made[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.calls):
            call(3 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.calls
        out[part] = {"wall_ms": wall * 1e3,
                     "tracer_us_a_call": spent[0] / args.calls * 1e6,
                     "event_record_us_a_call": in_record[0] / args.calls * 1e6,
                     "events_made": made[0],
                     "tracer_pct": 100 * spent[0] / args.calls / wall}
    scatter_sorted.TIMED_EVERY = every
    torch.cuda.Event.record = record
    trace._new_event = new_event
    for k, f in real.items():
        setattr(trace, k, f)
    own = out["shipped"]["tracer_us_a_call"] - out["no_ops"]["tracer_us_a_call"]
    out["shipped_less_timing_pct"] = 100 * own / 1e3 / out["shipped"]["wall_ms"]
    print(json.dumps(out), flush=True)
    _save(f"self_{args.workload}", out)
    return out


def ab(args) -> dict:
    """The tracer's cost in one process: a cell's calls (requests or
    steps, as its generator makes them) in blocks of ``args.per_block``,
    in turns ``on`` (the tracer recording) and ``off`` (``trace.request``,
    ``trace.span`` and ``trace.count`` replaced by no-ops), ``args.blocks``
    blocks of each, the order swapped every block; ms a call."""
    import statistics

    import torch

    from perfbench import device as device_mod
    from pointunet_tpu_torch.core import trace

    call = _cell_call(args.workload, args.seed)
    real = {k: getattr(trace, k) for k in ("request", "span", "count")}
    stub = {"request": lambda kind: contextlib.nullcontext(0),
            "span": lambda name, device=False, every=1: contextlib.nullcontext(),
            "count": lambda name, n=1: None}
    sides = {"on": real, "off": stub}
    for i in range(3):
        call(i)
    ms = {k: [] for k in sides}
    i = 3
    order = list(sides)
    for b in range(args.blocks):
        for side in order[b % len(order):] + order[:b % len(order)]:
            for k, f in sides[side].items():
                setattr(trace, k, f)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.per_block):
                call(i)
                i += 1
            torch.cuda.synchronize()
            ms[side].append((time.perf_counter() - t0) / args.per_block * 1e3)
    for k, f in real.items():
        setattr(trace, k, f)
    med = {k: statistics.median(v) for k, v in ms.items()}
    out = {"card": device_mod.card_line(), "workload": args.workload,
           "ms": ms, "median": med,
           "cost_pct": {k: 100 * (v / med["off"] - 1) for k, v in med.items()},
           "blocks_slower_than_off": {k: sum(a > b for a, b in zip(v, ms["off"]))
                                      for k, v in ms.items()}}
    print(json.dumps(out), flush=True)
    _save(f"ab_{args.workload}", out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("run")
    r.add_argument("--workload", required=True)
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--seconds", type=float, default=40.0)
    p = sub.add_parser("place")
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--requests", type=int, default=4)
    a = sub.add_parser("ab")
    a.add_argument("--workload", required=True)
    a.add_argument("--seed", type=int, default=13)
    a.add_argument("--blocks", type=int, default=8)
    a.add_argument("--per-block", type=int, default=10)
    c = sub.add_parser("self")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, default=13)
    c.add_argument("--calls", type=int, default=100)
    args = parser.parse_args(argv)
    _env()
    os.environ["USE_FLAX"] = "0"
    return {"run": run_cell, "place": place, "ab": ab,
            "self": selfcost}[args.mode](args)


if __name__ == "__main__":
    main()
