"""The port's host I/O (pointunet_tpu_torch/data) against the reference's
``pointunet_tpu.data``, on the same files: NIfTI files written by either
side read back bit for bit by the other, case discovery lists the same
folders, and the served volume equals the reference's uncropped load bit
for bit."""
import os

import numpy as np
import pytest

from pointunet_tpu.data import nifti as ref_nifti
from pointunet_tpu.data.loader import (
    BRATS_MODALITIES as REF_MODALITIES,
    find_brats_cases as ref_find,
    load_brats_case,
)
from pointunet_tpu_torch.data import nifti
from pointunet_tpu_torch.data.loader import (
    BRATS_MODALITIES,
    find_brats_cases,
    load_brats_volume,
)
from util_synthetic import make_brats_case


@pytest.mark.parametrize(
    "dtype", [np.uint8, np.int16, np.int32, np.float32, np.float64, np.bool_]
)
def test_nifti_matches_reference(tmp_path, rng, dtype):
    data = (rng.standard_normal((7, 5, 3)) * 50).astype(dtype)
    affine = np.diag([1.5, 2.0, 0.5, 1.0]).astype(np.float32)
    for writer, reader, name in (
        (nifti, ref_nifti, "port"), (ref_nifti, nifti, "ref"),
    ):
        path = str(tmp_path / f"{name}.nii.gz")
        writer.save(data, path, affine=affine)
        img = reader.load(path)
        want = data.astype(np.uint8) if dtype == np.bool_ else data
        assert img.data.dtype == want.dtype
        np.testing.assert_array_equal(img.data, want)
        np.testing.assert_array_equal(img.affine, affine)
    # uncompressed, the two writers produce the same bytes
    nifti.save(data, str(tmp_path / "a.nii"), affine=affine)
    ref_nifti.save(data, str(tmp_path / "b.nii"), affine=affine)
    assert (tmp_path / "a.nii").read_bytes() == (tmp_path / "b.nii").read_bytes()


def test_find_brats_cases_matches_reference(tmp_path):
    root = str(tmp_path)
    make_brats_case(root, "flat_b")
    make_brats_case(root, "flat_a")
    make_brats_case(os.path.join(root, "HGG"), "hgg_0")
    make_brats_case(os.path.join(root, "LGG"), "lgg_0")
    os.makedirs(os.path.join(root, "not_a_case"))
    (tmp_path / "stray.txt").write_text("x")
    got = find_brats_cases(root)
    assert got == ref_find(root)
    assert [os.path.basename(c) for c in got] == [
        "hgg_0", "lgg_0", "flat_a", "flat_b",
    ]
    assert BRATS_MODALITIES == REF_MODALITIES


@pytest.mark.parametrize("kind", ["blob", "noise"])
def test_load_brats_volume_matches_reference(tmp_path, rng, kind):
    """(C, X, Y, Z) modalities, z-scored over their nonzero voxels, equal
    the reference's ``load_brats_case(crop=False)`` image transposed back
    to (C, X, Y, Z), bit for bit. ``noise`` has negative voxels too, which
    the statistics leave out, and an empty slab, which stays zero."""
    case_dir, _ = make_brats_case(str(tmp_path), "case0", shape=(24, 20, 12))
    if kind == "noise":
        for mod in BRATS_MODALITIES:
            vol = rng.standard_normal((24, 20, 12)).astype(np.float32) * 40
            vol[:3] = 0.0
            nifti.save(vol, os.path.join(case_dir, f"case0_{mod}.nii.gz"))
    got = load_brats_volume(case_dir)
    record, _ = load_brats_case(case_dir, with_label=False, crop=False)
    want = np.transpose(record.image, (0, 3, 2, 1))
    assert got.shape == want.shape == (4, 24, 20, 12)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if kind == "noise":
        assert (got[:, :3] == 0).all()
