"""Whole runs at a tiny size on the CPU, past the look for a card, with
the timed path broken underneath: ``correct`` has to come out false for
every fault the cell can have."""
import pytest
import torch

from perfbench import manifest, run
from perfbench.tests import tiny


def _run(cell, seed=2 ** 31 + 5):
    w = manifest.workload(manifest.load(), cell)
    return run.execute(cell, seed, 0.3, False, torch.device("cpu"), 0.0,
                       cfg=tiny.config(w["config"]),
                       traffic=tiny.traffic(w["traffic"]))


def _wrap(monkeypatch, owner, name, after):
    real = getattr(owner, name)

    def broken(*args, **kwargs):
        return after(real(*args, **kwargs))
    monkeypatch.setattr(owner, name, broken)


def test_sound_serve_is_correct():
    assert _run("brats.serve")["correct"]


def _far_neighbour(pyr):
    pyr.neigh_idx[0][0, :3, 4] = pyr.neigh_idx[0].shape[1] - 1
    return pyr


def _shift_feature(cloud):
    cloud.features[:3] += 1.0
    return cloud


def _flip_voxel(mask):
    mask = mask.clone()
    mask[20, 18, 10] = ~mask[20, 18, 10]
    return mask


def _alter_label(volume):
    """One point's label changed after the scatter wrote it."""
    volume = volume.clone()
    at = torch.nonzero(volume)[0] if volume.any() else (0, 0, 0)
    volume[tuple(at)] = (volume[tuple(at)] % 3) + 1
    return volume


SERVE_FAULTS = {
    # (where the fault is planted, attribute, how the output is altered,
    #  the number that catches it)
    "label": ("pointunet_tpu_torch.pipeline.fused", "scatter_labels_to_volume",
              _alter_label, "scatter_faults"),
    "neighbour": ("pointunet_tpu_torch.pipeline.fused", "build_pyramid_batch",
                  _far_neighbour, "knn_faults"),
    "sample": ("pointunet_tpu_torch.pipeline.fused", "sample_cloud_device",
               _shift_feature, "cloud_faults"),
    "mask": ("pointunet_tpu_torch.pipeline.fused.FusedPointUnet", "_attention_mask",
             _flip_voxel, "mask_faults"),
    "logits": ("pointunet_tpu_torch.models.randlanet.RandLANet", "forward",
               lambda t: t * 1.5, "logit_dist"),
    "probabilities": ("pointunet_tpu_torch.models.saliency_unet.SaliencyUNet",
                      "forward", lambda t: t * 1.5, "prob_dist"),
}


def _owner(path):
    import importlib
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_fault_is_caught(monkeypatch, fault):
    path, name, after, number = SERVE_FAULTS[fault]
    _wrap(monkeypatch, _owner(path), name, after)
    r = _run("brats.serve")
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]


@pytest.mark.parametrize("cell", ["brats.train_point", "brats.train_saliency"])
def test_unchanged_state_is_caught(monkeypatch, cell):
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    trainer = PointSegTrainer if cell == "brats.train_point" else SaliencyTrainer
    monkeypatch.setattr(trainer, "apply_update", lambda self, state, *a: None)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["update_gap"]["value"] > r["checks"]["update_gap"]["limit"]


def test_half_batch_is_caught(monkeypatch):
    """One patch of the saliency batch left out, the mean over the rest."""
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    real = SaliencyTrainer.prepare

    def half(self, images, weights, labels):
        b = images.shape[0] // 2
        return real(self, images[:b], weights[:b], labels[:b])
    monkeypatch.setattr(SaliencyTrainer, "prepare", half)
    r = _run("brats.train_saliency")
    assert not r["correct"], r["checks"]


def test_altered_gather_gradient_is_caught(monkeypatch):
    """The point net's gather backward altered where it is produced."""
    from pointunet_tpu_torch.ops import gather

    _wrap(monkeypatch, gather, "row_sum", lambda t: t * 2.0)
    r = _run("brats.train_point")
    assert not r["correct"], r["checks"]


def test_sound_train_is_correct():
    assert _run("brats.train_point")["correct"]
    assert _run("brats.train_saliency")["correct"]
