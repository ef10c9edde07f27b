"""The port's last four host CLIs against the reference's, on seeded
synthetic cases in one process: n4_correction, oversampling_analysis,
visualize and data_prepare_blocks (numpy, scipy and matplotlib on both
sides).

Bar: equal. The same files byte for byte (NIfTI, its gzip stream
decompressed, as the gzip header holds the time of writing; PLY, PNG,
blocks.txt), the same stdout and return values. ``data_prepare_blocks`` seeds its
subsample with ``abs(hash(case_id)) % 2**31`` on both sides, which is
equal within one process (Python salts string hashes per process).
"""
import gzip
import os
import sys

import numpy as np
import pytest

from pointunet_tpu.cli import data_prepare_blocks as ref_blocks
from pointunet_tpu.cli import n4_correction as ref_n4
from pointunet_tpu.cli import oversampling_analysis as ref_over
from pointunet_tpu.cli import visualize as ref_vis
from pointunet_tpu_torch.cli import (
    data_prepare_blocks,
    n4_correction,
    oversampling_analysis,
    visualize,
)
from pointunet_tpu_torch.data import nifti
from util_synthetic import make_brats_case


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(got_root, want_root, n_min=1):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want) and len(want) >= n_min
    for name in want:
        assert got[name] == want[name], name


def test_polynomial_bias_correct_equals_reference(rng):
    vol = np.zeros((24, 20, 16), np.float32)
    vol[2:-2, 2:-2, 1:-1] = rng.uniform(50, 100, (20, 16, 14))
    xx = np.arange(24)[:, None, None] / 24.0
    vol *= (1.0 + 0.5 * xx)                      # a smooth bias field
    np.testing.assert_array_equal(n4_correction.polynomial_bias_correct(vol),
                                  ref_n4.polynomial_bias_correct(vol))
    tiny = np.zeros((8, 8, 8), np.float32)
    tiny[0, 0, :5] = 3.0                         # under 100 voxels: as is
    np.testing.assert_array_equal(n4_correction.polynomial_bias_correct(tiny),
                                  ref_n4.polynomial_bias_correct(tiny))


@pytest.mark.parametrize("skip", [False, True])
def test_n4_correction_equals_reference(tmp_path, capsys, skip, monkeypatch):
    # without ANTs on PATH on both sides: the polynomial fit, or copies
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    rng = np.random.default_rng(3)
    for cid in ("case_a", "case_b"):
        make_brats_case(str(tmp_path / "cases"), cid, rng=rng)
    flags = ["--data_3D_path", str(tmp_path / "cases")]
    flags += ["--skip_without_ants"] if skip else []
    ref_n4.main(flags + ["--out_path", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    n4_correction.main(flags + ["--out_path", str(tmp_path / "port")])
    assert capsys.readouterr().out == want
    assert ("corrected (polyfit)" in want) != skip
    _assert_same_tree(tmp_path / "port", tmp_path / "ref", n_min=10)


def test_oversampling_analysis_equals_reference(tmp_path, capsys, rng):
    pred_dir, truth_dir = tmp_path / "pred", tmp_path / "truth"
    pred_dir.mkdir()
    truth_dir.mkdir()
    for i, cid in enumerate(("0001", "0002", "0003")):
        truth = (rng.uniform(size=(20, 18, 12)) < 0.05 * (i + 1))
        pred = (rng.uniform(size=(20, 18, 12)) < 0.04)
        nifti.save(truth.astype(np.uint8), str(truth_dir / f"label{cid}.nii.gz"))
        name = f"PANCREAS_{cid}.nii.gz" if i else f"{cid}.nii.gz"
        if cid != "0003":
            nifti.save(pred.astype(np.uint8), str(pred_dir / name))
    flags = ["--pred_path", str(pred_dir), "--truth_path", str(truth_dir),
             "--dilations", "2"]
    ref_over.main(flags)
    want = capsys.readouterr().out
    got = oversampling_analysis.main(flags)
    assert capsys.readouterr().out == want
    assert "skip label0003.nii.gz" in want and got[0] > 0
    truth = rng.uniform(size=(10, 9, 8)) < 0.1
    pred = rng.uniform(size=(10, 9, 8)) < 0.1
    np.testing.assert_array_equal(
        oversampling_analysis.dilation_over_truth(pred, truth),
        ref_over.dilation_over_truth(pred, truth))


def test_save_colored_cloud_equals_reference(tmp_path, rng):
    xyz = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 500)
    for n_cls in (None, 3):
        visualize.save_colored_cloud(str(tmp_path / "port.ply"), xyz, labels,
                                     n_cls)
        ref_vis.save_colored_cloud(str(tmp_path / "ref.ply"), xyz, labels,
                                   n_cls)
        assert ((tmp_path / "port.ply").read_bytes()
                == (tmp_path / "ref.ply").read_bytes())
    assert visualize.random_colors(7, False, 3) == ref_vis.random_colors(
        7, False, 3)


def test_visualize_equals_reference(tmp_path, capsys):
    case_dir, seg = make_brats_case(str(tmp_path / "cases"), "case_v",
                                    shape=(24, 20, 12))
    vol = os.path.join(case_dir, "case_v_t1ce.nii.gz")
    segp = os.path.join(case_dir, "case_v_seg.nii.gz")
    nifti.save((seg > 0).astype(np.uint8) * 2, str(tmp_path / "pred.nii.gz"))
    flags = ["--volume", vol, "--truth", segp, "--pred",
             str(tmp_path / "pred.nii.gz"), "--stride", "5"]
    ref_vis.main(flags + ["--out_dir", str(tmp_path / "ref")])
    visualize.main(flags + ["--out_dir", str(tmp_path / "port")])
    capsys.readouterr()
    _assert_same_tree(tmp_path / "port", tmp_path / "ref", n_min=3)
    # the volume alone, along another axis
    ref_vis.main(["--volume", vol, "--axis", "0", "--stride", "12",
                  "--out_dir", str(tmp_path / "ref0")])
    visualize.main(["--volume", vol, "--axis", "0", "--stride", "12",
                    "--out_dir", str(tmp_path / "port0")])
    _assert_same_tree(tmp_path / "port0", tmp_path / "ref0", n_min=2)


def test_slice_overlays_without_matplotlib_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.save_slice_overlays(np.zeros((4, 4, 4)), None, None,
                                      str(tmp_path))
    # the PLY mode needs nothing more
    visualize.save_colored_cloud(str(tmp_path / "c.ply"),
                                 np.zeros((3, 3), np.float32), [0, 1, 2])


@pytest.mark.parametrize("n", [50, 3000])
def test_block_to_points_equals_reference(rng, n):
    """Under the budget the voxels repeat; over it a random subset."""
    vol = rng.standard_normal((4, 16, 16, 16)).astype(np.float32)
    weight = (rng.uniform(size=(16, 16, 16)) < 0.3).astype(np.float32)
    label = rng.integers(0, 5, (16, 16, 16)).astype(np.int32)
    got = data_prepare_blocks.block_to_points(
        vol, label, weight, n, (3, 4, 5), np.random.default_rng(9))
    want = ref_blocks.block_to_points(
        vol, label, weight, n, (3, 4, 5), np.random.default_rng(9))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert data_prepare_blocks.block_to_points(
        vol, label, np.zeros_like(weight), n) is None


def _write_case(root, case_id, shape, tumour):
    """A BraTS-layout case: a brain box of noise, a tumour box of
    ``tumour`` (lo, hi) corners labelled 2 (its core 4)."""
    rng = np.random.default_rng(len(case_id))
    case_dir = os.path.join(root, case_id)
    os.makedirs(case_dir)
    brain = np.zeros(shape, bool)
    brain[2:-2, 2:-2, 1:-1] = True
    seg = np.zeros(shape, np.uint8)
    (x0, y0, z0), (x1, y1, z1) = tumour
    seg[x0:x1, y0:y1, z0:z1] = 2
    seg[x0 + 2:x1 - 2, y0 + 2:y1 - 2, z0 + 2:z1 - 2] = 4
    for mod in ("t1ce", "t1", "flair", "t2"):
        vol = np.where(brain, rng.uniform(50, 100, shape), 0).astype(np.float32)
        vol[seg > 0] += 100.0
        nifti.save(vol, os.path.join(case_dir, f"{case_id}_{mod}.nii.gz"))
    nifti.save(seg, os.path.join(case_dir, f"{case_id}_seg.nii.gz"))


def test_data_prepare_blocks_equals_reference(tmp_path, capsys):
    """A case wider than a block (12 blocks at stride 54, a small
    tumour) and one under a block whose tumour fills over 1/20 of it
    (the stride-4 re-tiling), both subsampled to 3,000 points."""
    cases = str(tmp_path / "cases")
    _write_case(cases, "wide", (130, 70, 66), ((60, 30, 30), (66, 36, 34)))
    _write_case(cases, "dense", (28, 28, 26), ((2, 2, 1), (26, 26, 25)))
    flags = ["--data_3D_path", cases, "--n_point", "3000"]
    ref_blocks.main(flags + ["--outPC_path", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    data_prepare_blocks.main(flags + ["--outPC_path", str(tmp_path / "port")])
    assert capsys.readouterr().out == want
    assert "wide: 12 blocks" in want
    _assert_same_tree(tmp_path / "port", tmp_path / "ref", n_min=14)
    listed = (tmp_path / "port" / "blocks.txt").read_text().split()
    assert listed.count("dense_xyz_0_0_0.ply") > 1     # re-tiled
