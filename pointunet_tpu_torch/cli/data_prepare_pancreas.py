"""Pancreas point-cloud prep: pre-sampled loops from CT and label volumes
(``pointunet_tpu/cli/data_prepare_pancreas.py``).

    python -m pointunet_tpu_torch.cli.data_prepare_pancreas \
        --data_3D_path ct/ --label_path labels/ --outPC_path pc/ \
        [--n_point 180000] [--seed 0]

Each ``PANCREAS_<ID>.nii*`` volume is z-scored whole, every voxel becomes
a point, and ``N_LOOPS`` independent fixed-budget samplings ("loops") of
all foreground plus random background are drawn from one
``default_rng(seed)`` and written:

  <out>/original_ply/<ID>_loop_<k>.ply               x, y, z, value, class
  <out>/input0.01/<ID>_xyz_origin_loop_<k>.npy       uint16 voxel coords

Host numpy only, as the reference.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import nifti
from ..data.ply import write_ply
from ..data.pointcloud import context_aware_sample
from ..data.volume import intensity_normalize_full

N_LOOPS = 8


def process_case(
    ct_path: str, seg_path: str, case_id: str,
    original_dir: str, sub_dir: str, n_point: int, rng: np.random.Generator,
):
    img = intensity_normalize_full(nifti.load(ct_path).get_fdata())
    seg = nifti.load(seg_path).get_fdata().astype(np.int32)

    coords = np.indices(img.shape).reshape(3, -1).T.astype(np.int32)
    values = img.reshape(-1).astype(np.float32)
    labels = seg.reshape(-1).astype(np.int32)
    dims = np.asarray(img.shape, np.float32)

    for loop in range(N_LOOPS):
        idx = context_aware_sample(labels, n_point, rng)
        xyz_origin = coords[idx].astype(np.uint16)
        np.save(
            os.path.join(sub_dir, f"{case_id}_xyz_origin_loop_{loop}.npy"),
            xyz_origin,
        )
        xyz = xyz_origin.astype(np.float32) / dims
        write_ply(
            os.path.join(original_dir, f"{case_id}_loop_{loop}.ply"),
            (xyz, values[idx][:, None], labels[idx].astype(np.uint8)),
            ["x", "y", "z", "value", "class"],
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n_point", type=int, default=180000)
    parser.add_argument("--data_3D_path", type=str, required=True,
                        help="dir of PANCREAS_<ID>.nii.gz CT volumes")
    parser.add_argument("--label_path", type=str, required=True,
                        help="dir of label<ID>.nii.gz segmentations")
    parser.add_argument("--outPC_path", type=str, default="train")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    original_dir = os.path.join(args.outPC_path, "original_ply")
    sub_dir = os.path.join(args.outPC_path, "input0.01")
    os.makedirs(original_dir, exist_ok=True)
    os.makedirs(sub_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    for fname in sorted(os.listdir(args.data_3D_path)):
        if not fname.startswith("PANCREAS_") or ".nii" not in fname:
            continue
        case_id = fname.split("PANCREAS_")[1].split(".nii")[0]
        seg_path = os.path.join(args.label_path, f"label{case_id}.nii.gz")
        process_case(
            os.path.join(args.data_3D_path, fname), seg_path, case_id,
            original_dir, sub_dir, args.n_point, rng,
        )
        print(f"{case_id}: {N_LOOPS} loops written")


if __name__ == "__main__":
    main()
