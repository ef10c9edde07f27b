"""The control of each cell, the plain reference in the next lower
precision put in the program's place (for the saliency steps the
program's own bf16 path), has to fail the cell's check while the program
passes it: at a tiny size on the CPU, and at the cell's own size on three
seeds on a card (``card``; run on the card with
``python -m pytest perfbench/tests -m card``)."""
import pytest
import torch

from perfbench import control, manifest
from perfbench.tests import tiny

CELLS = ["brats.serve", "pancreas.serve", "brats.train_point",
         "brats.train_saliency"]
READINGS = {"serve_volumes": control.serve_readings,
            "train_points": control.train_point_readings,
            "train_patches": control.train_saliency_readings}


def _readings(cell, cfg, traffic, seed, dev):
    limits = manifest.read_json("limits", cell)["numbers"]
    return limits, READINGS[traffic["generator"]](cfg, traffic, seed, dev)


@pytest.mark.parametrize("cell", CELLS)
def test_control_separates_tiny(cell):
    """At a tiny size the limits, set at the cell's size, do not apply; the
    control still reads at least 3x the program on a compared number."""
    w = manifest.workload(manifest.load(), cell)
    limits, r = _readings(cell, tiny.config(w["config"]),
                          tiny.traffic(w["traffic"]), 1, torch.device("cpu"))
    assert any(r["control"][k] >= 3 * r["program"][k] > 0 or
               (r["program"][k] == 0 < r["control"][k])
               for k in limits if k in r["control"]), r


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_size(card, cell):
    w = manifest.workload(manifest.load(), cell)
    cfg = manifest.read_json("configs", w["config"])
    traffic = manifest.read_json("traffic", w["traffic"])
    for seed in (71, 72, 73):
        limits, r = _readings(cell, cfg, traffic, seed, card)
        assert any(r["control"][k] > v["limit"] for k, v in limits.items()
                   if k in r["control"]), r["control"]
        assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r["program"]
