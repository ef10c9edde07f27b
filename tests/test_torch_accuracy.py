"""The port's accuracy path (pointunet_tpu_torch/cli/accuracy.py and
data/synthetic.py) against the reference's (bench.py:bench_accuracy and
bench_accuracy_pancreas), on the CPU at small sizes.

* the synthetic volumes are bit-equal to bench.py's (modalities and
  labels), and so are the QDA control and the scoring: both sides run the
  same numpy and scipy arithmetic, so equal means equal;
* the QDA control of the reduced task (the six (96, 96, 64) volumes of
  ``default_rng(0)``) is the value ``chip_smoke.py`` phase 15 pins;
* the loops: tests/test_torch_accuracy_loops.py;
* ``accuracy_brats`` and ``accuracy_pancreas`` run on the CPU at (32, 32,
  16) with 8,192 points and 2 + 2 steps and print the reference's keys.

``test_full_pipeline_learns`` is the port's counterpart of
tests/test_learning_e2e.py: minutes on the CPU, so marked slow as that
one is.
"""
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import bench
from pointunet_tpu.pipeline import postprocess as jax_post
from pointunet_tpu.train import metrics as jax_metrics
from pointunet_tpu_torch.cli import accuracy
from pointunet_tpu_torch.core.config import (
    brats_pointseg_config,
    brats_saliency_config,
)
from pointunet_tpu_torch.data import synthetic
from pointunet_tpu_torch.train.pointseg import PointSegTrainer
from pointunet_tpu_torch.train.saliency import SaliencyTrainer

torch.set_num_threads(2)

REDUCED = (96, 96, 64)
TINY_TASK = dict(shape=(32, 32, 16), n_points=8192, patch=(16, 32, 32))
# the keys of bench.py's lines: bench_accuracy (:973-1004, and the A/B
# passes :1011-1075) and bench_accuracy_pancreas (:696-767)
REF_KEYS = {
    "brats": [
        "metric", "value", "unit", "vs_baseline", "dice_wt", "dice_tc",
        "dice_et", "hd95_wt", "hd95_tc", "hd95_et", "postprocessed",
        "gmm_baseline_dice_mean", "gmm_baseline_dice_wt",
        "gmm_baseline_dice_tc", "gmm_baseline_dice_et", "latency_ms_median",
        "saliency_final_loss", "pointseg_final_loss", "volume_shape",
        "n_points", "pointseg_bf16", "note", "stride_ab", "downscale_ab",
        "downscale_band_ab"],
    "pancreas": [
        "metric", "value", "unit", "vs_baseline", "hd95", "postprocessed",
        "gmm_baseline_dice", "latency_ms_median", "saliency_final_loss",
        "pointseg_final_loss", "volume_shape", "n_points", "note",
        "downscale_ab", "downscale_band_ab", "stride_ab"],
}
REF_AB_KEYS = {
    "brats": {
        "stride_ab": ["sa_gate_stride", "dice_mean", "dice_wt", "dice_tc",
                      "dice_et", "latency_ms_median"],
        "downscale_ab": ["postprocessed", "att_downscale", "mask_dilate",
                         "dice_mean", "dice_wt", "dice_tc", "dice_et",
                         "hd95_wt", "hd95_tc", "hd95_et",
                         "latency_ms_median"],
        "downscale_band_ab": ["postprocessed", "att_downscale", "mask_band",
                              "band_threshold", "dice_mean", "dice_wt",
                              "dice_tc", "dice_et", "hd95_wt", "hd95_tc",
                              "hd95_et", "latency_ms_median"],
    },
    "pancreas": {
        "stride_ab": ["sa_gate_stride", "dice", "hd95", "postprocessed",
                      "latency_ms_median"],
        "downscale_ab": ["att_downscale", "mask_dilate", "dice", "hd95",
                         "postprocessed", "latency_ms_median"],
        "downscale_band_ab": ["att_downscale", "mask_band", "band_threshold",
                              "dice", "hd95", "postprocessed",
                              "latency_ms_median"],
    },
}
SYNTH = {
    "brats": (bench._synth_brats_volume, synthetic.synth_brats_volume),
    "pancreas": (bench._synth_pancreas_volume,
                 synthetic.synth_pancreas_volume),
}


def _assert_volumes_equal(got, want):
    assert len(got) == len(want)
    for (gm, gs), (wm, ws) in zip(got, want):
        assert gm.dtype == wm.dtype and gs.dtype == ws.dtype
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)


def _bench_volumes(dataset, shape, r_div=10):
    """bench.py's 4 training and 2 held-out volumes of one run."""
    rng = np.random.default_rng(0)
    ref, _ = SYNTH[dataset]
    args = (shape, r_div) if dataset == "brats" else (shape,)
    vols = [ref(rng, *args) for _ in range(6)]
    return vols[:4], vols[4:]


# ------------------------------------------------------------------ #
# volumes and the QDA control


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(24, 24, 16), (40, 32, 24), REDUCED])
@pytest.mark.parametrize("dataset", ["brats", "pancreas"])
def test_synthetic_volumes_match_reference(dataset, shape, seed):
    ref, port = SYNTH[dataset]
    extra = (7,) if dataset == "brats" else ()
    want = ref(np.random.default_rng(seed), shape, *extra)
    got = port(np.random.default_rng(seed), shape, *extra)
    _assert_volumes_equal([got], [want])
    assert got[0].shape == ((4 if dataset == "brats" else 1),) + shape
    assert set(np.unique(got[1])) <= ({0, 1, 2, 3} if dataset == "brats"
                                      else {0, 1})


@pytest.fixture(scope="module")
def reduced():
    """Both sides' six volumes of the reduced task, a dataset each."""
    out = {}
    for dataset in ("brats", "pancreas"):
        task = (accuracy.brats_task if dataset == "brats"
                else accuracy.pancreas_task)(False)
        assert task.shape == REDUCED
        out[dataset] = (accuracy.make_volumes(dataset, task),
                        _bench_volumes(dataset, REDUCED, task.r_div))
    return out


@pytest.mark.parametrize("dataset", ["brats", "pancreas"])
def test_reduced_task_volumes_and_qda_match_reference(reduced, dataset):
    """The reduced task's volumes are bench.py's, and its QDA control is
    bench.py's exactly: the value chip_smoke.py phase 15 pins."""
    import chip_smoke

    (train, test), (ref_train, ref_test) = reduced[dataset]
    _assert_volumes_equal(train + test, ref_train + ref_test)
    if dataset == "brats":
        got = accuracy.pervoxel_gmm_baseline(train, test)
        want = bench._pervoxel_gmm_baseline(ref_train, ref_test)
        assert got == want
        value = float(np.mean(list(got.values())))
    else:
        value = accuracy.pancreas_gmm_baseline(train, test)
        classes, params = bench._fit_qda(ref_train)
        want = float(np.mean([
            jax_metrics.binary_dice(
                bench._qda_predict(classes, params, ct) > 0, seg > 0)
            for ct, seg in ref_test]))
        assert value == want
    key, pinned = chip_smoke.ACC_QDA[dataset]
    assert round(value, 4) == pinned, (key, value)


@pytest.mark.parametrize("max_fit", [2_000_000, 5_000])
@pytest.mark.parametrize("dataset", ["brats", "pancreas"])
def test_qda_matches_reference(dataset, max_fit):
    """fit_qda and qda_predict equal bench.py's, with and without the
    ``default_rng(7)`` subsample of the fitted voxels."""
    train, test = accuracy.make_volumes(
        dataset, accuracy.Task((40, 32, 24), 0, (0, 0, 0), None))
    classes, params = accuracy.fit_qda(train, max_fit)
    ref_classes, ref_params = bench._fit_qda(train, max_fit)
    np.testing.assert_array_equal(classes, ref_classes)
    for got, want in zip(params, ref_params, strict=True):
        assert got[0] == want[0] and got[3] == want[3]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    for mods, _ in test:
        np.testing.assert_array_equal(
            accuracy.qda_predict(classes, params, mods),
            bench._qda_predict(ref_classes, ref_params, mods))
    if dataset == "brats":
        assert (accuracy.pervoxel_gmm_baseline(train, test)
                == bench._pervoxel_gmm_baseline(train, test))


# ------------------------------------------------------------------ #
# scoring


def _predictions(test, dataset, rng):
    """Labels near the truth: flipped voxels, a shifted lesion, and in
    the second volume no enhancing tumour at all (its HD95 is inf and is
    clamped to the diagonal)."""
    preds = []
    for i, (_, seg) in enumerate(test):
        pred = np.roll(seg, 1, axis=0).copy()
        flip = rng.uniform(size=seg.shape) < 0.002
        top = 3 if dataset == "brats" else 1
        pred[flip] = rng.integers(0, top + 1, size=int(flip.sum()))
        if dataset == "brats":
            if i == 1:
                pred[pred == 3] = 2
            pred[pred == 3] = 4
        preds.append(pred)
    return preds


def _reference_brats_scores(preds, test, shape):
    """bench.py:939-971 on the reference's metrics and postprocessing."""
    dices, hd95s, post_dices, post_hd95s = [], [], [], []
    for pred, (_, seg) in zip(preds, test):
        truth = np.where(seg == 3, 4, seg)
        dices.append(jax_metrics.brats_region_dice(pred, truth))
        hd95s.append(jax_metrics.brats_region_hd95(pred, truth))
        ppred = jax_post.postprocess_brats(pred)
        post_dices.append(jax_metrics.brats_region_dice(ppred, truth))
        post_hd95s.append(jax_metrics.brats_region_hd95(ppred, truth))
    wt = float(np.mean([d["WT"] for d in dices]))
    tc = float(np.mean([d["TC"] for d in dices]))
    et = float(np.mean([d["ET"] for d in dices]))
    diag = float(np.linalg.norm(shape))
    hd = {k: float(np.mean([min(h[k], diag) for h in hd95s]))
          for k in ("WT", "TC", "ET")}
    post = {
        "dice_wt": round(float(np.mean([d["WT"] for d in post_dices])), 4),
        "dice_tc": round(float(np.mean([d["TC"] for d in post_dices])), 4),
        "dice_et": round(float(np.mean([d["ET"] for d in post_dices])), 4),
        "hd95_wt": round(float(np.mean(
            [min(h["WT"], diag) for h in post_hd95s])), 2),
        "hd95_tc": round(float(np.mean(
            [min(h["TC"], diag) for h in post_hd95s])), 2),
        "hd95_et": round(float(np.mean(
            [min(h["ET"], diag) for h in post_hd95s])), 2),
    }
    post["dice_mean"] = round(float(np.mean(
        [post["dice_wt"], post["dice_tc"], post["dice_et"]])), 4)
    return {"dice_wt": wt, "dice_tc": tc, "dice_et": et,
            "hd95_wt": hd["WT"], "hd95_tc": hd["TC"], "hd95_et": hd["ET"],
            "postprocessed": post}, hd95s


def _reference_pancreas_scores(preds, test, shape):
    """bench.py:661-685 on the reference's metrics and postprocessing."""
    diag = float(np.linalg.norm(shape))
    dices, hd95s, post_dices, post_hd95s = [], [], [], []
    for pred, (_, seg) in zip(preds, test):
        dices.append(jax_metrics.binary_dice(pred > 0, seg > 0))
        hd95s.append(min(jax_metrics.hausdorff95(pred > 0, seg > 0), diag))
        ppred = jax_post.postprocess_pancreas(pred)
        post_dices.append(jax_metrics.binary_dice(ppred > 0, seg > 0))
        post_hd95s.append(
            min(jax_metrics.hausdorff95(ppred > 0, seg > 0), diag))
    return {"dice": float(np.mean(dices)), "hd95": float(np.mean(hd95s)),
            "postprocessed": {
                "dice": round(float(np.mean(post_dices)), 4),
                "hd95": round(float(np.mean(post_hd95s)), 2)}}


@pytest.mark.parametrize("dataset", ["brats", "pancreas"])
def test_scoring_matches_reference(dataset, rng):
    shape = (40, 32, 24)
    _, test = _bench_volumes(dataset, shape)
    preds = _predictions(test, dataset, rng)
    if dataset == "brats":
        got = accuracy.score_brats(preds, test, shape)
        want, hd95s = _reference_brats_scores(preds, test, shape)
        # the second volume's ET is empty in the prediction only
        assert hd95s[1]["ET"] == float("inf")
        assert got["hd95_et"] < float(np.linalg.norm(shape))
    else:
        got = accuracy.score_pancreas(preds, test, shape)
        want = _reference_pancreas_scores(preds, test, shape)
    assert got == want


# ------------------------------------------------------------------ #
# the whole path on the CPU


@pytest.mark.parametrize("dataset", ["brats", "pancreas"])
def test_accuracy_runs_on_cpu(dataset, monkeypatch, capsys):
    """``main`` at (32, 32, 16), 8,192 points, 2 + 2 steps, with both A/B
    passes: the reference's keys, labels of the dataset in (X, Y, Z),
    every step's loss finite, no launch."""
    roi = (28, 28, 14) if dataset == "brats" else None
    tiny = accuracy.Task(roi=roi, **TINY_TASK)
    monkeypatch.setattr(accuracy, f"{dataset}_task", lambda full: tiny)
    runs = []
    run_fn = getattr(accuracy, f"accuracy_{dataset}")
    monkeypatch.setattr(accuracy, f"accuracy_{dataset}",
                        lambda *a, **k: runs.append(run_fn(*a, **k))
                        or runs[-1])
    out = accuracy.main([
        "--dataset", dataset, "--device", "cpu", "--saliency_steps", "2",
        "--pointseg_steps", "2", "--sa_stride", "2", "--att_downscale", "2"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == json.loads(json.dumps(out))
    assert [k for k in out if k not in ("card", "launches")] == \
        REF_KEYS[dataset]
    for key, keys in REF_AB_KEYS[dataset].items():
        assert list(out[key]) == keys, key
    assert out["volume_shape"] == [32, 32, 16] and out["n_points"] == 8192
    assert out["card"] is None
    stages = ["volumes", "saliency_train", "clouds", "pointseg_train",
              "evaluate", "qda", "stride_ab", "downscale_ab",
              "downscale_band_ab"]
    assert sorted(out["launches"]) == sorted(stages)
    assert all(n == 0 for st in out["launches"].values() for n in st.values())

    (_, run), = runs
    assert run.pcfg.use_bfloat16 is False and run.scfg.use_bfloat16 is False
    assert len(run.evaluation.preds) == 2
    allowed = {0, 1, 2, 4} if dataset == "brats" else {0, 1}
    for pred in run.evaluation.preds:
        assert pred.shape == TINY_TASK["shape"]
        assert set(np.unique(pred)) <= allowed
    for losses in (run.saliency_losses, run.pointseg_losses):
        assert losses.shape == (2,) and np.isfinite(losses).all()
    assert out["saliency_final_loss"] == round(run.saliency_losses[-1], 4)
    assert out["pointseg_final_loss"] == round(run.pointseg_losses[-1], 4)
    s = run.score(run.evaluation)
    if dataset == "brats":
        dice = float(np.mean([s["dice_wt"], s["dice_tc"], s["dice_et"]]))
    else:
        dice = s["dice"]
    assert out["value"] == round(dice, 4) and 0.0 <= dice <= 1.0


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_path_runs_the_trained_weights_in_its_own_type(stride):
    """The saliency net trains in f32 (``--saliency_bf16`` asks for bf16
    on the card only); the fused path puts the trained weights into a
    net of ``Run.scfg``, which on the card computes in bf16. Here that
    config is set to bf16 by hand: the fused path's net is a new one,
    bf16, holding the trained weights, and it labels the volumes."""
    args = accuracy.parse_args(["--device", "cpu", "--saliency_bf16",
                                "--saliency_steps", "1",
                                "--pointseg_steps", "0"])
    task = accuracy.Task(roi=(28, 28, 14), **TINY_TASK)
    run = accuracy.train("brats", args, task, log=lambda *a: None)
    assert run.strainer.cfg.use_bfloat16 is False
    assert run.strainer.cfg == run.scfg
    reused = run.pipe(stride).saliency_model is run.sstate.model
    assert reused == (stride == 1)
    run.scfg = dataclasses.replace(run.scfg, use_bfloat16=True)
    pipe = run.pipe(stride)
    net = pipe.saliency_model
    assert net is not run.sstate.model
    assert net.config.sa_gate_stride == stride
    assert net.head.dtype == torch.bfloat16
    trained = run.sstate.model.state_dict()
    for name, value in net.state_dict().items():
        assert torch.equal(value, trained[name]), name
    ev = run.evaluate(stride)
    assert all(set(np.unique(p)) <= {0, 1, 2, 4} for p in ev.preds)


def test_saliency_stage_takes_tf32_convs_whatever_the_caller_set(
        monkeypatch):
    """The saliency stage trains with cuDNN's TF32 convs on even where the
    caller turned them off (as chip_smoke.py does for its bars), and the
    caller's setting is back after it."""
    seen = []

    def fake_train(trainer, state, records, steps, log):
        seen.append(torch.backends.cudnn.allow_tf32)
        return state, np.zeros(0)

    monkeypatch.setattr(accuracy, "train_saliency", fake_train)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = accuracy.parse_args(["--device", "cpu", "--pointseg_steps", "0"])
    accuracy.train("pancreas", args, accuracy.Task(**TINY_TASK, roi=None),
                   log=lambda *a: None)
    assert seen == [True]
    assert torch.backends.cudnn.allow_tf32 is False


def test_accuracy_cli_needs_the_card_unless_told():
    """With no card the CLI fails before any work; it does not fall back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy.main(["--dataset", "pancreas"])


def test_accuracy_module_imports_no_jax():
    """The accuracy path's modules name neither jax nor the JAX package
    nor bench.py in an import."""
    from pathlib import Path

    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|pointunet_tpu\b|bench\b)", re.M)
    root = Path(accuracy.__file__).resolve().parents[1]
    for rel in ("cli/accuracy.py", "data/synthetic.py"):
        assert not pattern.search((root / rel).read_text()), rel


# ------------------------------------------------------------------ #
# the port's counterpart of tests/test_learning_e2e.py


@pytest.mark.slow
def test_full_pipeline_learns(rng):
    """Stage 1 and stage 3 trained on blob volumes, the fused path with
    the trained weights: losses descend and the Dice clears 0.7 (the bars
    and sizes of tests/test_learning_e2e.py, whose docstrings say why)."""
    from pointunet_tpu_torch.ops.sampling import sample_cloud_device
    from pointunet_tpu_torch.pipeline.fused import FusedPointUnet
    from pointunet_tpu_torch.train.metrics import binary_dice
    from test_learning_e2e import N_POINTS, SHAPE, synth_volume

    volumes = [synth_volume(rng) for _ in range(4)]
    scfg = brats_saliency_config(
        patch_size=(16, 32, 32), base_filter=4, depth=3, remat=False,
        deep_supervision=False, batch_size=2, base_lr=0.05,
        lr_schedule=((1000, 0.05),),
    )
    strainer = SaliencyTrainer(scfg, attention=False, device="cpu")
    sstate = strainer.init_state()

    def sal_batch(k):
        mods, seg = volumes[k % len(volumes)]
        vol = np.transpose(mods, (3, 2, 1, 0))[:, :32, :32][None]
        lab = (np.transpose(seg, (2, 1, 0)) > 0).astype(np.int32)
        lab = lab[:, :32, :32][None]
        vol, lab = np.concatenate([vol, vol]), np.concatenate([lab, lab])
        return vol[:, :16], np.ones_like(lab, np.float32)[:, :16], lab[:, :16]

    losses = []
    for k in range(150):
        sstate, m = strainer.train_step(sstate, *sal_batch(k))
        losses.append(m["loss"])
    assert losses[-1] < losses[0] * 0.7, losses[::8]

    pcfg = brats_pointseg_config(num_points=N_POINTS, k_n=8,
                                 learning_rate=1e-3, bn_momentum=0.9,
                                 use_bfloat16=False)
    ptrainer = PointSegTrainer(pcfg, device="cpu")
    pstate = ptrainer.init_state()
    clouds = [
        sample_cloud_device(
            torch.from_numpy(mods), torch.from_numpy((seg > 0).astype(np.uint8)),
            torch.Generator().manual_seed(0), N_POINTS,
            labels=torch.from_numpy(seg))
        for mods, seg in volumes]
    pstate, plosses = accuracy.train_pointseg(ptrainer, pstate, clouds, 100,
                                              log=lambda *_: None)
    assert plosses[-1] < plosses[0] * 0.2, plosses[::12]

    pipe = FusedPointUnet(sstate.model, pstate.model, scfg, pcfg,
                          threshold=0.5, volume_shape=SHAPE, device="cpu")
    dices = [binary_dice(pipe.segment_volume(mods, brats_labels=False) > 0,
                         seg > 0) for mods, seg in volumes]
    assert float(np.mean(dices)) > 0.7, dices
