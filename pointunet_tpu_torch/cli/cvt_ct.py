"""Pancreas-CT preprocessing: resample to 1 mm slices, flip, HU clip
(``pointunet_tpu/cli/cvt_ct.py``).

    python -m pointunet_tpu_torch.cli.cvt_ct --ct_path ct/ --out_ct_path out/ \
        [--seg_path labels/ --out_seg_path out_labels/] \
        [--slice_thickness 1.0] [--down_scale 1.0] [--lower -100 --upper 240]

Each CT is zoomed along z by ``scipy.ndimage.zoom`` so that its slices are
``--slice_thickness`` mm apart (cubic for the CT, nearest for its
labels), flipped on the second array axis of its [z, y, x] layout,
optionally zoomed by ``--down_scale`` on every axis, clipped to [lower,
upper] HU and written back (X, Y, Z) as nii.gz with the new voxel size.
Host numpy and scipy only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from scipy import ndimage

from ..data import nifti


def convert_case(
    ct_path: str,
    seg_path: str | None,
    slice_thickness: float = 1.0,
    down_scale: float = 1.0,
    lower: float = -100.0,
    upper: float = 240.0,
):
    """(ct [z, y, x] f32, seg [z, y, x] uint8 or None, voxel size (x, y,
    z) mm) of one case."""
    ct_img = nifti.load(ct_path)
    ct = np.transpose(ct_img.get_fdata(), (2, 1, 0)).astype(np.float32)
    z_spacing = ct_img.spacing[2]
    seg = None
    if seg_path and os.path.exists(seg_path):
        seg = np.transpose(
            nifti.load(seg_path).get_fdata(), (2, 1, 0)
        ).astype(np.uint8)

    if abs(z_spacing - slice_thickness) > 1e-6:
        factor = z_spacing / slice_thickness
        ct = ndimage.zoom(ct, (factor, 1, 1), order=3)
        if seg is not None:
            seg = ndimage.zoom(seg, (factor, 1, 1), order=0)

    ct = np.flip(ct, 1)
    if seg is not None:
        seg = np.flip(seg, 1)

    if down_scale != 1.0:
        ct = ndimage.zoom(ct, (down_scale,) * 3, order=3)
        if seg is not None:
            seg = ndimage.zoom(seg, (down_scale,) * 3, order=0)

    ct = np.clip(ct, lower, upper)
    # z takes the slice thickness; a down-scale zoom widens every voxel
    sx, sy, _ = ct_img.spacing[:3]
    out_spacing = (
        sx / down_scale, sy / down_scale, slice_thickness / down_scale
    )
    return ct, seg, out_spacing


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ct_path", type=str, required=True,
                        help="dir of PANCREAS_<ID>.nii[.gz]")
    parser.add_argument("--seg_path", type=str, default=None,
                        help="dir of label<ID>.nii[.gz]")
    parser.add_argument("--out_ct_path", type=str, required=True)
    parser.add_argument("--out_seg_path", type=str, default=None)
    parser.add_argument("--slice_thickness", type=float, default=1.0)
    parser.add_argument("--down_scale", type=float, default=1.0)
    parser.add_argument("--lower", type=float, default=-100.0)
    parser.add_argument("--upper", type=float, default=240.0)
    args = parser.parse_args(argv)

    os.makedirs(args.out_ct_path, exist_ok=True)
    if args.out_seg_path:
        os.makedirs(args.out_seg_path, exist_ok=True)

    for fname in sorted(os.listdir(args.ct_path)):
        if ".nii" not in fname or fname.startswith("label"):
            continue
        seg_file = (
            os.path.join(args.seg_path, fname.replace("PANCREAS_", "label"))
            if args.seg_path
            else None
        )
        ct, seg, spacing = convert_case(
            os.path.join(args.ct_path, fname), seg_file,
            args.slice_thickness, args.down_scale, args.lower, args.upper,
        )
        out_name = fname if fname.endswith(".gz") else fname + ".gz"
        affine = np.diag(list(spacing) + [1.0]).astype(np.float32)
        nifti.save(
            nifti.Nifti1Image(
                np.transpose(ct, (2, 1, 0)).astype(np.float32),
                affine, spacing,
            ),
            os.path.join(args.out_ct_path, out_name),
        )
        if seg is not None and args.out_seg_path:
            nifti.save(
                nifti.Nifti1Image(
                    np.transpose(seg, (2, 1, 0)), affine, spacing
                ),
                os.path.join(
                    args.out_seg_path,
                    out_name.replace("PANCREAS_", "label"),
                ),
            )
        print(f"{fname}: -> {ct.shape[::-1]}")


if __name__ == "__main__":
    main()
