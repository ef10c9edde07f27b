"""A configuration, a traffic mix, a cell's limits and a per-layer metric
added as new files and entries, and found by name, with no file of the
harness edited."""
import json
import shutil

import torch

from perfbench import manifest, run
from perfbench.tests import tiny

READER = '''"""Requests the window completed."""
import math


def read(run):
    return float(sum(1 for w in run["walls"] if math.isfinite(w)))
'''


def test_new_files_are_found(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "limits", "metrics", "generators", "counters"):
        shutil.copytree(manifest.HERE / kind, tmp_path / kind)
    cfg = tiny.config("pancreas")
    cfg["name"] = "pancreas_small"
    (tmp_path / "configs" / "pancreas_small.json").write_text(json.dumps(cfg))
    mix = tiny.traffic("serve")
    mix["pool"] = [300, 900]
    (tmp_path / "traffic" / "serve_two.json").write_text(json.dumps(mix))
    limits = manifest.read_json("limits", "pancreas.serve")
    (tmp_path / "limits" / "pancreas_small.serve_two.json").write_text(json.dumps(limits))
    (tmp_path / "metrics" / "requests.serve_two.py").write_text(READER)
    monkeypatch.setattr(manifest, "HERE", tmp_path)

    m = manifest.load()
    m["configs"].append({"name": "pancreas_small", "source": "x",
                         "file": "perfbench/configs/pancreas_small.json",
                         "reduced": ["volume"], "why": "x"})
    m["workloads"].append({"name": "pancreas_small.serve_two",
                           "config": "pancreas_small", "traffic": "serve_two",
                           "chips": 1, "why": "x"})
    for x in m["end_to_end"]:
        if "workloads" in x and "pancreas.serve" in x["workloads"]:
            x["workloads"].append("pancreas_small.serve_two")
    m["per_layer"].append({"name": "requests.serve_two", "unit": "requests",
                           "better": "higher", "source": "program_counter",
                           "layer": "fused path host side",
                           "moves": "volumes_per_s",
                           "workloads": ["pancreas_small.serve_two"]})
    assert manifest.problems(m) == []
    r = run.execute("pancreas_small.serve_two", 11, 0.3, False,
                    torch.device("cpu"), 0.0, m=m)
    assert set(r["metrics"]) == {"volumes_per_s", "latency_p90_ms", "setup_s"}
    assert r["correct"], r["checks"]
    readers = manifest.readers(m, "pancreas_small.serve_two")
    assert "requests.serve_two" in readers
    assert readers["requests.serve_two"].read({"walls": [0.1, 0.2, float("inf")]}) == 2.0
