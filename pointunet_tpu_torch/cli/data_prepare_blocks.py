"""Block-based prep: 64^3 blocks of a brain-cropped BraTS volume ->
fixed-budget point clouds (``pointunet_tpu/cli/data_prepare_blocks.py``).

    python -m pointunet_tpu_torch.cli.data_prepare_blocks \
        --data_3D_path cases/ --outPC_path blocks/ [--n_point 180000]

Each case (``load_brats_case``, cropped) is tiled with 64^3 blocks at
stride 54 per axis, skipping blocks with no brain voxel; a block whose
tumour takes at least 1/20 of it re-tiles its column, row and plane at
stride 4. A block's brain voxels become points (xyz in the cropped
volume's voxels, the four modalities, the BraTS label), randomly
subsampled to ``--n_point`` or padded to it by repetition, and are
written as ``<case>_xyz_<x>_<y>_<z>.ply``; ``blocks.txt`` lists them.

The subsample's generator is seeded with ``abs(hash(case_id)) % 2**31``,
as the reference's is: Python salts ``hash`` of a string per process
(``PYTHONHASHSEED``), so the output of an oversized block is equal to the
reference's within one process and differs between processes. Host numpy
only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.loader import find_brats_cases, load_brats_case
from ..data.ply import write_ply

BLOCK = 64
STRIDE = 54
STRIDE_TUMOR = 4
TUMOR_FRACTION = 1.0 / 20.0


def block_to_points(volume, label, weight, n_points, origin=(0, 0, 0),
                    rng=None):
    """(C, 64, 64, 64) block -> (xyz f32, feats f32, labels uint8) of
    ``n_points`` points, or None without a brain voxel (``weight != 0``).
    Over the budget, a random subset without replacement (``rng``,
    default seed 0); under it, the voxels repeated in scan order."""
    mask = weight != 0
    coords = np.argwhere(mask).astype(np.float32)
    if coords.shape[0] == 0:
        return None
    feats = volume[:, mask].T.astype(np.float32)
    labels = label[mask].astype(np.uint8)
    coords += np.asarray(origin, np.float32)

    n = coords.shape[0]
    if n > n_points:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, n_points, replace=False)
    else:
        reps = max(n_points // n, 1)
        extra = n_points - reps * n
        sel = np.concatenate(
            [np.tile(np.arange(n), reps), np.arange(max(extra, 0))]
        )[:n_points]
    return coords[sel], feats[sel], labels[sel]


def process_case(case_dir, out_dir, n_points, index_list) -> None:
    """Write one case's blocks under ``out_dir`` and append their file
    names to ``index_list``."""
    rec, meta = load_brats_case(case_dir, with_label=True, crop=True)
    case_id = meta["case_id"]
    volume = rec.image                     # (C, D, H, W)
    label = meta["label_full"]
    weight = rec.weight
    x_axis, y_axis, z_axis = label.shape

    rng = np.random.default_rng(abs(hash(case_id)) % (2 ** 31))
    count = tumor = 0
    # each axis keeps its own stride: a dense block re-tiles its own
    # column, the row and plane that hold a dense column
    x = 0
    while x <= max(x_axis - 1, 0):
        xb = min(x, max(x_axis - BLOCK, 0))
        y = 0
        dense_in_plane = False
        while y <= max(y_axis - 1, 0):
            yb = min(y, max(y_axis - BLOCK, 0))
            z = 0
            dense_in_column = False
            stride_z = STRIDE
            while z <= max(z_axis - 1, 0):
                zb = min(z, max(z_axis - BLOCK, 0))
                sl = (
                    slice(xb, xb + BLOCK),
                    slice(yb, yb + BLOCK),
                    slice(zb, zb + BLOCK),
                )
                wblk = weight[sl]
                if wblk.max() != 0:
                    lblk = label[sl]
                    pts = block_to_points(
                        volume[(slice(None),) + sl], lblk, wblk, n_points,
                        rng=rng,
                    )
                    if pts is not None:
                        name = f"{case_id}_xyz_{xb}_{yb}_{zb}.ply"
                        write_ply(
                            os.path.join(out_dir, name), pts,
                            ["x", "y", "z", "t1ce", "t1", "flair", "t2",
                             "class"],
                        )
                        index_list.append(name)
                        count += 1
                        n_tumor = int((lblk > 0).sum())
                        tumor += n_tumor > 0
                        dense = n_tumor >= BLOCK ** 3 * TUMOR_FRACTION
                        stride_z = STRIDE_TUMOR if dense else STRIDE
                        dense_in_column |= dense
                z += stride_z
            dense_in_plane |= dense_in_column
            y += STRIDE_TUMOR if dense_in_column else STRIDE
        x += STRIDE_TUMOR if dense_in_plane else STRIDE
    print(f"{case_id}: {count} blocks ({tumor} with tumor)")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_3D_path", type=str, required=True)
    parser.add_argument("--outPC_path", type=str, required=True)
    parser.add_argument("--n_point", type=int, default=180000)
    args = parser.parse_args(argv)

    os.makedirs(args.outPC_path, exist_ok=True)
    index_list = []
    for case_dir in find_brats_cases(args.data_3D_path):
        process_case(case_dir, args.outPC_path, args.n_point, index_list)
    with open(os.path.join(args.outPC_path, "blocks.txt"), "w") as f:
        f.write("\n".join(index_list) + "\n")


if __name__ == "__main__":
    main()
