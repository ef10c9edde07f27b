"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name the manifest
gives it:

* ``configs/<config>.json``: the configuration as it is run; its
  ``counter`` key names ``counters/<counter>.py`` (its nets' operations
  and bytes);
* ``traffic/<traffic>.json``: the mix's parameters; its ``generator`` key
  names the general generator ``generators/<generator>.py`` that reads them;
* ``limits/<workload>.json``: each number the cell's check compares, with
  its limit and the readings the limit was set from;
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``,
  which returns its value or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def load(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def problems(m: dict) -> List[str]:
    """What in the manifest breaks the contract's rules of form."""
    out = []
    if set(m) != KEYS:
        out.append(f"keys {sorted(m)}")
    metrics = m.get("end_to_end", []) + m.get("per_layer", [])
    names = ([c["name"] for c in m.get("configs", [])]
             + [w["name"] for w in m.get("workloads", [])]
             + [x["name"] for x in metrics])
    for w in m.get("workloads", []):
        names += [w["config"], w["traffic"]]
    for c in m.get("configs", []):
        names += list(c["reduced"])
    for n in names:
        if not NAME.match(n):
            out.append(f"name {n!r}")
    for x in metrics:
        if not UNIT.match(x["unit"]):
            out.append(f"unit {x['unit']!r} of {x['name']}")
        if x["better"] not in ("lower", "higher"):
            out.append(f"better of {x['name']}")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in m.get(group, [])]
        if len(seen) != len(set(seen)):
            out.append(f"repeated names in {group}")
    seen = [x["name"] for x in metrics]
    if len(seen) != len(set(seen)):
        out.append("repeated metric names")
    pairs = [(w["config"], w["traffic"]) for w in m.get("workloads", [])]
    if len(pairs) != len(set(pairs)):
        out.append("a configuration and traffic pair appears twice")
    return out


def workload(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def read_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py``, loaded by path (a metric's name may
    hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(m: dict, workload_name: str) -> List[dict]:
    """The cell's end-to-end metrics."""
    return [x for x in m["end_to_end"]
            if workload_name in x.get("workloads", [workload_name])]


def per_layer(m: dict, workload_name: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    mine = {x["name"] for x in end_to_end(m, workload_name)}
    return [x for x in m["per_layer"]
            if (workload_name in x["workloads"] if "workloads" in x
                else x["moves"] in mine)]


def readers(m: dict, workload_name: str) -> Dict[str, ModuleType]:
    return {x["name"]: module("metrics", x["name"])
            for x in per_layer(m, workload_name)}
