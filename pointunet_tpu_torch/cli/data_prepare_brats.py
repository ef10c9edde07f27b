"""BraTS point-cloud prep: case volumes -> prepared point-cloud tree
(``pointunet_tpu/cli/data_prepare_brats.py``).

    python -m pointunet_tpu_torch.cli.data_prepare_brats \
        --data_3D_path cases/ --outPC_path pc/ \
        [--attention_mask_path masks/] [--write_proj [--device cuda|cpu]]

Writes, per case ID:

  <out>/original_ply/<ID>.ply           the full nonzero-voxel cloud
  <out>/input0.01/<ID>.ply              the grid-subsampled (0.01) cloud
  <out>/input0.01/<ID>_xyz_origin.npy   the original int voxel coords

Training mode z-scores each modality over its nonzero voxels and writes
label 4 as 3; inference mode (``--attention_mask_path``, the masks of
``gen_binary_map``) takes the case's binary attention mask as the class
channel. ``--write_proj`` also pickles ``<ID>_proj.pkl``: [for each full
point the row of its nearest subsampled point, the full labels], by the
port's exact KNN (``ops/knn.py``) on ``--device`` (default ``cuda``; the
CPU only when asked). ``--n_point`` is accepted, as the reference's, and
unused: the full cloud is written.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..data import nifti
from ..data.ply import write_ply
from ..data.pointcloud import volume_to_points
from ..data.volume import intensity_normalize_nonzero
from ..ops.knn import knn
from ..ops.subsample import grid_subsample

MODALITIES = ("t1ce", "t1", "flair", "t2")
SUB_GRID_SIZE = 0.01


def load_volume(dataset_path: str, case_id: str, attention_mask_path=None):
    """(4, X, Y, Z) normalised modalities and the (X, Y, Z) class channel:
    the labels with 4 -> 3, or the attention mask."""
    base = os.path.join(dataset_path, case_id, case_id)
    mods = np.stack([
        intensity_normalize_nonzero(
            nifti.load(f"{base}_{mod}.nii.gz").get_fdata())
        for mod in MODALITIES
    ])
    if attention_mask_path is None:
        seg = nifti.load(f"{base}_seg.nii.gz").get_fdata().astype(np.int32)
        seg[seg == 4] = 3
    else:
        seg = (
            nifti.load(os.path.join(attention_mask_path, f"{case_id}.nii.gz"))
            .get_fdata()
            .astype(np.uint8)
            .astype(np.int32)
        )
    return mods, seg


def process_case(
    dataset_path: str,
    case_id: str,
    original_dir: str,
    sub_dir: str,
    attention_mask_path=None,
    write_proj: bool = False,
    device: str = "cuda",
):
    mods, seg = load_volume(dataset_path, case_id, attention_mask_path)
    cloud = volume_to_points(mods, seg)
    np.save(
        os.path.join(sub_dir, f"{case_id}_xyz_origin.npy"), cloud.xyz_origin
    )

    names = ["x", "y", "z", *MODALITIES, "class"]
    write_ply(
        os.path.join(original_dir, f"{case_id}.ply"),
        (cloud.xyz, cloud.features, cloud.labels.astype(np.uint8)),
        names,
    )
    sub_xyz, sub_feats, sub_labels = grid_subsample(
        cloud.xyz, cloud.features, cloud.labels, SUB_GRID_SIZE
    )
    write_ply(
        os.path.join(sub_dir, f"{case_id}.ply"),
        (sub_xyz, sub_feats, sub_labels.astype(np.uint8)),
        names,
    )
    if write_proj:
        proj = knn(
            torch.as_tensor(sub_xyz, device=device),
            torch.as_tensor(cloud.xyz, device=device), 1,
        )[:, 0].cpu().numpy().astype(np.int32)
        with open(os.path.join(sub_dir, f"{case_id}_proj.pkl"), "wb") as f:
            pickle.dump([proj, cloud.labels], f)
    return len(cloud.labels)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n_point", type=int, default=365000)
    parser.add_argument("--data_3D_path", type=str, required=True)
    parser.add_argument("--outPC_path", type=str, default="train")
    parser.add_argument("--attention_mask_path", type=str, default=None)
    parser.add_argument("--write_proj", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where --write_proj searches: cuda (default) "
                             "or cpu")
    args = parser.parse_args(argv)

    original_dir = os.path.join(args.outPC_path, "original_ply")
    sub_dir = os.path.join(args.outPC_path, "input0.01")
    os.makedirs(original_dir, exist_ok=True)
    os.makedirs(sub_dir, exist_ok=True)

    for case_id in sorted(os.listdir(args.data_3D_path)):
        if not os.path.isdir(os.path.join(args.data_3D_path, case_id)):
            continue
        n = process_case(
            args.data_3D_path, case_id, original_dir, sub_dir,
            args.attention_mask_path, args.write_proj, args.device,
        )
        print(f"{case_id}: {n} points")


if __name__ == "__main__":
    main()
