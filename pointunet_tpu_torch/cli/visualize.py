"""Slice overlays of truth and prediction, and coloured point clouds
(``pointunet_tpu/cli/visualize.py``).

    python -m pointunet_tpu_torch.cli.visualize --volume t1ce.nii.gz \
        [--truth seg.nii.gz] [--pred pred.nii.gz] [--out_dir overlays] \
        [--axis 2] [--stride 4]

``save_slice_overlays`` writes ``slice_<i>.png`` for every ``stride``-th
slice along ``axis``: the volume in grey under the truth and the
prediction, each class in its colour at half opacity. It needs
matplotlib, imported when called; without it the call raises an error
naming it. ``save_colored_cloud`` writes a point cloud with one colour a
class as a PLY file (``x, y, z, red, green, blue``), which needs nothing
beyond numpy. Host only.
"""
from __future__ import annotations

import argparse
import colorsys
import os
from typing import Optional

import numpy as np

from ..data import nifti
from ..data.ply import write_ply

# distinct colours per class (label -> RGB); the background stays bare
_CLASS_COLORS = {
    1: (255, 64, 64),
    2: (64, 192, 64),
    3: (64, 64, 255),
    4: (255, 192, 0),
}


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "save_slice_overlays needs matplotlib, which is not installed; "
            "save_colored_cloud (PLY) needs nothing more"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_slice_overlays(
    volume: np.ndarray,                 # (X, Y, Z) grey background
    truth: Optional[np.ndarray],        # (X, Y, Z) labels
    pred: Optional[np.ndarray],
    out_dir: str,
    axis: int = 2,
    stride: int = 1,
) -> None:
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    n = volume.shape[axis]
    panels = [(t, v) for t, v in (("truth", truth), ("pred", pred))
              if v is not None]
    for i in range(0, n, stride):
        sl = [slice(None)] * 3
        sl[axis] = i
        sl = tuple(sl)
        fig, axes = plt.subplots(
            1, max(len(panels), 1), figsize=(4 * max(len(panels), 1), 4)
        )
        axes = np.atleast_1d(axes)
        for ax, (title, vol) in zip(axes, panels or [("volume", volume)]):
            ax.imshow(volume[sl].T, cmap="gray", origin="lower")
            if vol is not volume:
                overlay = np.zeros(vol[sl].shape + (4,), np.float32)
                for lab, rgb in _CLASS_COLORS.items():
                    m = vol[sl] == lab
                    overlay[m] = [c / 255.0 for c in rgb] + [0.5]
                ax.imshow(np.transpose(overlay, (1, 0, 2)), origin="lower")
            ax.set_title(f"{title} z={i}")
            ax.axis("off")
        fig.savefig(os.path.join(out_dir, f"slice_{i:03d}.png"), dpi=80)
        plt.close(fig)


def random_colors(n, bright=True, seed=0):
    """``n`` distinct colours (RGB in [0, 1]), evenly spaced hues from
    0.15, shuffled by ``seed``."""
    brightness = 1.0 if bright else 0.7
    hsv = [(0.15 + i / float(n), 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    rng = np.random.default_rng(seed)
    rng.shuffle(colors)
    return colors


def save_colored_cloud(path, xyz, labels, num_classes=None) -> None:
    """A labelled cloud as a PLY file coloured by class (labels clipped
    to [0, num_classes))."""
    labels = np.asarray(labels).astype(np.int64)
    n_cls = num_classes or int(labels.max()) + 1
    palette = (np.asarray(random_colors(max(n_cls, 1))) * 255).astype(
        np.uint8
    )
    rgb = palette[np.clip(labels, 0, n_cls - 1)]
    write_ply(
        path,
        (np.asarray(xyz, np.float32), rgb),
        ["x", "y", "z", "red", "green", "blue"],
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--volume", type=str, required=True,
                        help="background nii.gz (e.g. a modality)")
    parser.add_argument("--truth", type=str, default=None)
    parser.add_argument("--pred", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default="overlays")
    parser.add_argument("--axis", type=int, default=2)
    parser.add_argument("--stride", type=int, default=4)
    args = parser.parse_args(argv)

    vol = nifti.load(args.volume).get_fdata()
    truth = nifti.load(args.truth).get_fdata() if args.truth else None
    pred = nifti.load(args.pred).get_fdata() if args.pred else None
    save_slice_overlays(vol, truth, pred, args.out_dir, args.axis,
                        args.stride)
    print(f"overlays written to {args.out_dir}")


if __name__ == "__main__":
    main()
