"""The port's offline stage-2 and scoring tools against the reference's,
on the CPU at small sizes, inputs made with numpy from a seed:
metrics (train/metrics.py), grid subsampling (ops/subsample.py) and the
CLIs data_prepare_brats, gen_binary_map, gen_segmentation, evaluation,
fold_cv_report, cvt_ct and generate_kfold.

Bars: the host tools (numpy and scipy on both sides) are equal: the same
arrays bit for bit, the same CSV text, stdout and pickles. The one
device function, ``grid_subsample_fixed``, gives the same cells, counts
and labels, and means within 1e-6 (f32 sums in another order).
``data_prepare_brats --write_proj`` searches with the port's exact KNN:
its nearest subsampled point equals the reference's up to distance ties
(tie-aware recall 1.0).
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.cli import (
    cvt_ct as ref_cvt_ct,
    data_prepare_brats as ref_prep_brats,
    evaluation as ref_evaluation,
    fold_cv_report as ref_fold_cv,
    gen_binary_map as ref_binary_map,
    gen_segmentation as ref_gen_seg,
    generate_kfold as ref_kfold,
)
from pointunet_tpu.data import nifti as ref_nifti
from pointunet_tpu.ops import subsample as ref_subsample
from pointunet_tpu.train import metrics as ref_metrics
from pointunet_tpu_torch.cli import (
    cvt_ct,
    data_prepare_brats,
    evaluation,
    fold_cv_report,
    gen_binary_map,
    gen_segmentation,
    generate_kfold,
)
from pointunet_tpu_torch.data import nifti
from pointunet_tpu_torch.data.ply import read_ply, write_ply
from pointunet_tpu_torch.ops import subsample
from pointunet_tpu_torch.train import metrics
from torch_parity import tie_aware_recall
from util_synthetic import make_brats_case

torch.set_num_threads(1)


def _labels(rng, shape, values=(0, 1, 2, 4)):
    """A BraTS-valued label volume: noise in a box, so that the regions
    have surfaces, plus a random speckle outside it."""
    lab = np.zeros(shape, np.int32)
    x, y, z = (s // 2 for s in shape)
    lab[x - 5:x + 4, y - 4:y + 5, z - 3:z + 3] = rng.choice(values, (9, 9, 6))
    speckle = rng.uniform(size=shape) < 0.01
    lab[speckle] = rng.choice(values, int(speckle.sum()))
    return lab


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_metrics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    pred = _labels(rng, (24, 22, 16))
    truth = _labels(rng, (24, 22, 16))
    assert metrics.brats_region_dice(pred, truth) == \
        ref_metrics.brats_region_dice(pred, truth)
    assert metrics.brats_region_hd95(pred, truth) == \
        ref_metrics.brats_region_hd95(pred, truth)
    for spacing in (None, (1.0, 0.8, 2.5)):
        got = metrics.hausdorff95(pred > 0, truth == 2, spacing)
        assert got == ref_metrics.hausdorff95(pred > 0, truth == 2, spacing)
        assert np.isfinite(got) and got > 0


@pytest.mark.parametrize("pred_any,truth_any,want", [
    (False, False, 0.0), (True, False, float("inf")),
    (False, True, float("inf")),
])
def test_hausdorff95_empty_masks(pred_any, truth_any, want):
    rng = np.random.default_rng(3)
    full = _labels(rng, (12, 12, 8)) > 0
    empty = np.zeros_like(full)
    pred, truth = (full if pred_any else empty), (full if truth_any else empty)
    assert metrics.hausdorff95(pred, truth) == want
    assert ref_metrics.hausdorff95(pred, truth) == want
    assert metrics.brats_region_hd95(pred * 4, truth * 4) == \
        ref_metrics.brats_region_hd95(pred * 4, truth * 4)


# ------------------------------------------------------------ subsampling


def _cloud(rng, n=3000):
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    feats = rng.standard_normal((n, 4)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    return pts, feats, labels


@pytest.mark.parametrize("grid", [0.05, 0.11])
def test_grid_subsample_equals_reference_numpy(grid):
    pts, feats, labels = _cloud(np.random.default_rng(4))
    got = subsample.grid_subsample(pts, feats, labels, grid)
    want = ref_subsample.grid_subsample_numpy(pts, feats, labels, grid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(subsample.grid_subsample(pts, grid_size=grid),
                                  ref_subsample.grid_subsample_numpy(
                                      pts, grid_size=grid))


@pytest.mark.parametrize("max_cells,masked", [(4096, False), (4096, True),
                                              (200, False)])
def test_grid_subsample_fixed_equals_reference(max_cells, masked):
    rng = np.random.default_rng(5)
    pts, feats, labels = _cloud(rng)
    labels[:20] = 7                     # outside num_classes: no vote
    valid = rng.uniform(size=len(pts)) < 0.8 if masked else None
    got = subsample.grid_subsample_fixed(
        torch.from_numpy(pts), torch.from_numpy(feats),
        torch.from_numpy(labels), 0.1, max_cells, 4,
        None if valid is None else torch.from_numpy(valid))
    want = ref_subsample.grid_subsample_fixed(
        jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(labels), 0.1,
        max_cells, 4, None if valid is None else jnp.asarray(valid))
    g_pts, g_feats, g_lab, g_valid = (t.numpy() for t in got)
    w_pts, w_feats, w_lab, w_valid = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(g_valid, w_valid)
    assert 0 < g_valid.sum() <= max_cells
    if max_cells == 200:
        assert g_valid.all()            # more cells than the budget
    np.testing.assert_array_equal(g_lab, w_lab)
    np.testing.assert_allclose(g_pts, w_pts, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_feats, w_feats, rtol=0, atol=1e-6)


# --------------------------------------------------------------- prep CLIs


def _tree_arrays(root):
    """{relative path: array(s)} of every ply, npy and pickle under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".ply"):
                out[rel] = read_ply(path)
            elif f.endswith(".npy"):
                out[rel] = np.load(path)
            elif f.endswith(".pkl"):
                with open(path, "rb") as fh:
                    out[rel] = pickle.load(fh)
    return out


@pytest.fixture(scope="module")
def brats_cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(6)
    for cid in ("case_001", "case_002"):
        make_brats_case(str(root), cid, shape=(24, 20, 12), rng=rng)
    return root


@pytest.mark.parametrize("mask", [False, True])
def test_data_prepare_brats_equals_reference(tmp_path, brats_cases, mask,
                                             monkeypatch):
    from pointunet_tpu import native

    # the reference takes its C++ subsampling when built, held equal to
    # its numpy path: compare the numpy path
    monkeypatch.setattr(native, "available", lambda: False)
    flags = ["--data_3D_path", str(brats_cases)]
    if mask:
        masks = tmp_path / "masks"
        masks.mkdir()
        rng = np.random.default_rng(7)
        for cid in ("case_001", "case_002"):
            nifti.save((rng.uniform(size=(24, 20, 12)) < 0.3).astype(np.uint8),
                       str(masks / f"{cid}.nii.gz"))
        flags += ["--attention_mask_path", str(masks)]
    ref_prep_brats.main(flags + ["--outPC_path", str(tmp_path / "ref")])
    data_prepare_brats.main(flags + ["--outPC_path", str(tmp_path / "port"),
                                     "--device", "cpu"])
    want, got = _tree_arrays(tmp_path / "ref"), _tree_arrays(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 6
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    classes = got["original_ply/case_001.ply"]["class"]
    assert set(np.unique(classes)) == ({0, 1} if mask else {0, 2, 3})


def test_data_prepare_brats_write_proj(tmp_path, brats_cases, monkeypatch):
    from pointunet_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    flags = ["--data_3D_path", str(brats_cases), "--write_proj"]
    ref_prep_brats.main(flags + ["--outPC_path", str(tmp_path / "ref")])
    data_prepare_brats.main(flags + ["--outPC_path", str(tmp_path / "port"),
                                     "--device", "cpu"])
    for cid in ("case_001", "case_002"):
        rel = os.path.join("input0.01", f"{cid}_proj.pkl")
        with open(tmp_path / "ref" / rel, "rb") as f:
            w_proj, w_lab = pickle.load(f)
        with open(tmp_path / "port" / rel, "rb") as f:
            g_proj, g_lab = pickle.load(f)
        assert g_proj.dtype == w_proj.dtype == np.int32
        np.testing.assert_array_equal(g_lab, w_lab)
        full = read_ply(str(tmp_path / "port" / "original_ply" / f"{cid}.ply"))
        sub = read_ply(str(tmp_path / "port" / "input0.01" / f"{cid}.ply"))
        xyz = np.stack([full[c] for c in "xyz"], -1)
        sub_xyz = np.stack([sub[c] for c in "xyz"], -1)
        assert tie_aware_recall(sub_xyz, xyz, 1, g_proj[:, None]) == 1.0
        assert tie_aware_recall(sub_xyz, xyz, 1, w_proj[:, None]) == 1.0
        assert (g_proj == w_proj).mean() > 0.9


def test_write_proj_defaults_to_the_card(tmp_path, brats_cases, monkeypatch):
    """``--write_proj`` searches on cuda unless asked for the CPU: on a
    host without a card it fails rather than searching on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        data_prepare_brats.main(["--data_3D_path", str(brats_cases),
                                 "--outPC_path", str(tmp_path), "--write_proj"])
    assert not (tmp_path / "input0.01" / "case_001_proj.pkl").exists()


# ------------------------------------------------------ stage-2 tool chain


def _run_both(ref_main, port_main, argv_of, capsys):
    """Run the reference's and the port's CLI, each on its own output
    (``argv_of(tag)``), and return their stdouts."""
    ref_main(argv_of("ref"))
    want = capsys.readouterr().out
    port_main(argv_of("port"))
    got = capsys.readouterr().out
    return want, got


def _nii_equal(a, b):
    ga, gb = nifti.load(str(a)), ref_nifti.load(str(b))
    assert ga.data.dtype == gb.data.dtype
    np.testing.assert_array_equal(ga.data, gb.data)
    np.testing.assert_array_equal(ga.affine, gb.affine)
    assert ga.spacing == gb.spacing


def test_gen_binary_map_equals_reference(tmp_path, capsys):
    rng = np.random.default_rng(8)
    maps = tmp_path / "maps"
    maps.mkdir()
    np.save(maps / "c1.npy", rng.uniform(size=(12, 10, 8, 2)).astype(np.float32))
    np.save(maps / "c2.npy", rng.uniform(size=(12, 10, 8)).astype(np.float32))
    want, got = _run_both(
        ref_binary_map.main, gen_binary_map.main,
        lambda tag: ["--inPros_path", str(maps), "--outBinary_path",
                     str(tmp_path / tag), "--threshold", "0.7"], capsys)
    assert got == want and "salient voxels" in got
    for c in ("c1", "c2"):
        _nii_equal(tmp_path / "port" / f"{c}.nii.gz",
                   tmp_path / "ref" / f"{c}.nii.gz")


@pytest.mark.parametrize("dataset", ["brats", "pancreas"])
def test_gen_segmentation_equals_reference(tmp_path, capsys, dataset):
    rng = np.random.default_rng(9)
    probs = tmp_path / "npy"
    probs.mkdir()
    c = 4 if dataset == "brats" else 2
    names = (["c1", "c2"] if dataset == "brats"
             else ["0001_loop_0", "0001_loop_1", "0002_loop_0"])
    for name in names:
        p = rng.dirichlet(np.ones(c), size=(8, 10, 12)).astype(np.float32)
        np.save(probs / f"{name}.npy", p)
    ref_fn = ref_gen_seg.main_brats if c == 4 else ref_gen_seg.main_pancreas
    port_fn = gen_segmentation.main_brats if c == 4 \
        else gen_segmentation.main_pancreas
    extra = [] if c == 4 else ["--threshold", "0.6"]
    want, got = _run_both(
        ref_fn, port_fn,
        lambda tag: ["--inPros_path", str(probs), "--outSegment_path",
                     str(tmp_path / tag)] + extra, capsys)
    assert got == want
    outs = sorted(os.listdir(tmp_path / "port"))
    assert outs == sorted(os.listdir(tmp_path / "ref"))
    assert outs == (["c1.nii.gz", "c2.nii.gz"] if c == 4
                    else ["0001.nii.gz", "0002.nii.gz"])
    for f in outs:
        _nii_equal(tmp_path / "port" / f, tmp_path / "ref" / f)
    lab = nifti.load(str(tmp_path / "port" / outs[0])).data
    assert lab.shape == (12, 10, 8)
    assert set(np.unique(lab)) <= ({0, 1, 2, 4} if c == 4 else {0, 1})


@pytest.mark.parametrize("dataset,hd95", [("brats", False), ("brats", True),
                                          ("pancreas", False)])
def test_evaluation_equals_reference(tmp_path, capsys, dataset, hd95):
    rng = np.random.default_rng(10)
    truth, pred = tmp_path / "truth", tmp_path / "pred"
    truth.mkdir()
    pred.mkdir()
    shape = (20, 18, 12)
    for i, cid in enumerate(("c001", "c002", "c003")):
        t = _labels(rng, shape)
        p = np.where(rng.uniform(size=shape) < 0.9, t, _labels(rng, shape))
        if dataset == "pancreas":
            t, p = (t > 0).astype(np.uint8), (p > 1).astype(np.uint8)
            nifti.save(t, str(truth / f"label{cid}.nii.gz"))
        elif i == 0:        # the case-folder layout, and the flat one
            (truth / cid).mkdir()
            nifti.save(t.astype(np.uint8), str(truth / cid / f"{cid}_seg.nii.gz"))
        else:
            nifti.save(t.astype(np.uint8), str(truth / f"{cid}_seg.nii.gz"))
        nifti.save(p.astype(np.uint8), str(pred / f"{cid}.nii.gz"))
    flags = ["--dataset", dataset] + (["--hd95"] if hd95 else [])
    want, got = _run_both(
        ref_evaluation.main, evaluation.main,
        lambda tag: ["--path_truth", str(truth), "--path_pred", str(pred),
                     "--path_report", str(tmp_path / f"{tag}.csv")] + flags,
        capsys)
    assert got == want and ("HD95_WT" in got) == hd95
    report = (tmp_path / "port.csv").read_text()
    assert report == (tmp_path / "ref.csv").read_text()
    assert len(report.splitlines()) == 4


def test_fold_cv_report_equals_reference(tmp_path, capsys):
    rng = np.random.default_rng(11)
    orig, pred = tmp_path / "orig", tmp_path / "pred"
    orig.mkdir()
    pred.mkdir()
    for cid in ("c1", "c2"):
        n = 500
        xyz = rng.uniform(size=(n, 3)).astype(np.float32)
        cls = rng.integers(0, 4, n).astype(np.uint8)
        cls[cls == 3] = 2                   # a class never in the truth
        guess = np.where(rng.uniform(size=n) < 0.7, cls,
                         rng.integers(0, 4, n)).astype(np.uint8)
        write_ply(str(orig / f"{cid}.ply"), (xyz, cls), ["x", "y", "z", "class"])
        write_ply(str(pred / f"{cid}.ply"), (xyz, guess), ["x", "y", "z", "pred"])
    want, got = _run_both(
        ref_fold_cv.main, fold_cv_report.main,
        lambda tag: ["--pred_path", str(pred), "--original_path", str(orig)],
        capsys)
    assert got == want and "mean IOU" in got


@pytest.mark.parametrize("flags", [[], ["--down_scale", "0.5"]])
def test_cvt_ct_equals_reference(tmp_path, capsys, flags):
    rng = np.random.default_rng(12)
    ct_dir, seg_dir = tmp_path / "ct", tmp_path / "seg"
    ct_dir.mkdir()
    seg_dir.mkdir()
    for cid in ("0001", "0002"):
        ct = rng.uniform(-1000, 600, (16, 14, 6)).astype(np.float32)
        seg = (rng.uniform(size=(16, 14, 6)) < 0.2).astype(np.uint8)
        sp = (0.8, 0.8, 2.5)
        nifti.save(nifti.Nifti1Image(ct, np.diag(list(sp) + [1.0]), sp),
                   str(ct_dir / f"PANCREAS_{cid}.nii.gz"))
        nifti.save(nifti.Nifti1Image(seg, np.diag(list(sp) + [1.0]), sp),
                   str(seg_dir / f"label{cid}.nii.gz"))
    want, got = _run_both(
        ref_cvt_ct.main, cvt_ct.main,
        lambda tag: ["--ct_path", str(ct_dir), "--seg_path", str(seg_dir),
                     "--out_ct_path", str(tmp_path / tag / "ct"),
                     "--out_seg_path", str(tmp_path / tag / "seg")] + flags,
        capsys)
    assert got == want
    for sub, name in (("ct", "PANCREAS_0001.nii.gz"), ("seg", "label0002.nii.gz")):
        _nii_equal(tmp_path / "port" / sub / name, tmp_path / "ref" / sub / name)
    out = nifti.load(str(tmp_path / "port" / "ct" / "PANCREAS_0001.nii.gz"))
    assert out.data.shape[2] == (15 if not flags else 8)
    assert out.data.min() >= -100 and out.data.max() <= 240


@pytest.mark.parametrize("layout", ["brats", "plain"])
def test_generate_kfold_equals_reference(tmp_path, capsys, layout):
    base = tmp_path / "cases"
    for i in range(7):
        if layout == "brats":
            make_brats_case(str(base), f"case_{i:03d}", shape=(8, 8, 6))
        else:
            (base / f"dir_{i}").mkdir(parents=True)
    want, got = _run_both(
        ref_kfold.main, generate_kfold.main,
        lambda tag: ["--basedir", str(base), "--n_folds", "3", "--seed", "2",
                     "--output", str(tmp_path / f"{tag}.pkl")], capsys)
    assert got == want
    with open(tmp_path / "port.pkl", "rb") as f:
        folds = pickle.load(f)
    with open(tmp_path / "ref.pkl", "rb") as f:
        assert folds == pickle.load(f)
    assert sorted(len(v) for v in folds.values()) == [2, 2, 3]
