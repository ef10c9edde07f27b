"""N4 bias-field correction of BraTS modalities
(``pointunet_tpu/cli/n4_correction.py``).

    python -m pointunet_tpu_torch.cli.n4_correction --data_3D_path cases/ \
        --out_path corrected/ [--skip_without_ants]

Copies every case of ``--data_3D_path`` (``find_brats_cases``) to
``--out_path``, correcting t1ce, t1 and t2 (flair and seg are copied as
they are): with ANTs' ``N4BiasFieldCorrection`` when it is on ``PATH``,
else with ``polynomial_bias_correct`` (an order-3 polynomial fitted to the
log intensities of the foreground and divided out), or, with
``--skip_without_ants``, not at all. Host numpy only.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np

from ..data import nifti
from ..data.loader import BRATS_MODALITIES, find_brats_cases

CORRECT = ("t1ce", "t1", "t2")   # flair and seg pass through


def polynomial_bias_correct(volume: np.ndarray, order: int = 3) -> np.ndarray:
    """Fit a polynomial of ``order`` in the normalised coordinates to the
    log intensities of the foreground (> 0) and divide out all but its
    constant term; a volume with under 100 foreground voxels is returned
    as f32 unchanged."""
    vol = np.asarray(volume, np.float32)
    mask = vol > 0
    if mask.sum() < 100:
        return vol
    coords = np.argwhere(mask).astype(np.float32)
    coords = coords / np.asarray(vol.shape, np.float32) - 0.5
    logv = np.log(vol[mask] + 1e-3)

    feats = [np.ones(len(coords), np.float32)]
    for o in range(1, order + 1):
        for ax in range(3):
            feats.append(coords[:, ax] ** o)
    a = np.stack(feats, axis=1)
    coef, *_ = np.linalg.lstsq(a, logv, rcond=None)
    field = a[:, 1:] @ coef[1:]          # the global mean (coef[0]) stays
    out = vol.copy()
    out[mask] = np.exp(logv - field)
    return out


def correct_file(in_path: str, out_path: str, use_ants: bool) -> str:
    """Correct one NIfTI file into ``out_path``; "ants" or "polyfit"."""
    if use_ants:
        subprocess.run(
            ["N4BiasFieldCorrection", "-i", in_path, "-o", out_path],
            check=True,
        )
        return "ants"
    img = nifti.load(in_path)
    nifti.save(
        nifti.Nifti1Image(
            polynomial_bias_correct(img.get_fdata()).astype(np.float32),
            img.affine,
            img.spacing,
        ),
        out_path,
    )
    return "polyfit"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_3D_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--skip_without_ants", action="store_true",
                        help="without ANTs, copy the volumes uncorrected "
                             "instead of the polynomial fit")
    args = parser.parse_args(argv)

    use_ants = shutil.which("N4BiasFieldCorrection") is not None
    skip_correction = not use_ants and args.skip_without_ants
    for case_dir in find_brats_cases(args.data_3D_path):
        case_id = os.path.basename(case_dir)
        out_case = os.path.join(args.out_path, case_id)
        os.makedirs(out_case, exist_ok=True)
        for mod in BRATS_MODALITIES + ("seg",):
            src = os.path.join(case_dir, f"{case_id}_{mod}.nii.gz")
            if not os.path.exists(src):
                continue
            dst = os.path.join(out_case, f"{case_id}_{mod}.nii.gz")
            if mod in CORRECT and not skip_correction:
                how = correct_file(src, dst, use_ants)
                print(f"{case_id}_{mod}: corrected ({how})")
            else:
                shutil.copyfile(src, dst)


if __name__ == "__main__":
    main()
