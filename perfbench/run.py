"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: reads ``BENCHMARK.json`` there, finds the
cell, its configuration, traffic mix, limits and metrics by name
(``perfbench/manifest.py``), builds the port's system under test
(``pointunet_tpu_torch``) on the card, warms it up, measures for
``--seconds``, checks what the timed path produced against the plain
reference (``perfbench/reference``), and prints one JSON line last: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the device's busy and traced seconds. Each number
compared is printed beside its limit, last on standard error and last in
the line. Exits non-zero, printing no result, without a CUDA card, or if
JAX or the JAX package is loaded when the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / ".perfbench_cache"


@dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    counter: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            t0: float, m: dict = None, cfg: dict = None,
            traffic: dict = None) -> dict:
    """Run cell ``name`` on ``device``: the result line as a dict, and the
    run's errors under ``errors`` and the judge's numbers that no limit
    compares under ``readings``. ``m``, ``cfg`` and ``traffic`` replace
    the manifest, the configuration and the mix (the tests run the cells
    at a tiny size on the CPU)."""
    from perfbench import manifest

    m = m or manifest.load()
    w = manifest.workload(m, name)
    cfg = cfg or manifest.read_json("configs", w["config"])
    traffic = traffic or manifest.read_json("traffic", w["traffic"])
    limits = manifest.read_json("limits", name)["numbers"]
    cell = Cell(name, cfg, traffic, manifest.module("counters", cfg["counter"]),
                seed, seconds, trace, device, t0)
    generator = manifest.module("generators", traffic["generator"])
    out = generator.run(cell)

    metrics = {}
    if trace:
        units = {x["name"]: x["unit"] for x in manifest.per_layer(m, name)}
        for metric, reader in manifest.readers(m, name).items():
            value = reader.read(out["record"])
            if value is not None:
                metrics[metric] = {"value": value, "unit": units[metric]}
    else:
        for x in manifest.end_to_end(m, name):
            metrics[x["name"]] = {"value": out["e2e"][x["name"]], "unit": x["unit"]}
    import torch
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": w["chips"], "memory_peak_bytes": out["peak"]}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        prof = out["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    checks = {k: {"value": out["checks"].get(k), "limit": v["limit"]}
              for k, v in limits.items()}
    result["correct"] = out["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks
    result["errors"] = out["errors"]
    result["readings"] = {k: v for k, v in out["checks"].items() if k not in limits}
    result["phases"] = dict(out["phases"], setup=out["setup_s"])
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    import torch
    from perfbench import device as device_mod, manifest

    chips = manifest.workload(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(device_mod.card_line(), file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T0)
    loaded = device_mod.forbidden_loaded()
    if loaded:
        print(f"perfbench: loaded in this process: {loaded}", file=sys.stderr)
        return 3
    print("set-up seconds since start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.pop("phases").items()), file=sys.stderr)
    for err in result.pop("errors"):
        print(f"error: {err}", file=sys.stderr)
    for k, v in result.pop("readings").items():
        print(f"reading {k} {v} (not compared)", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
