"""Attention probability maps -> binary sampling masks
(``pointunet_tpu/cli/gen_binary_map.py``).

    python -m pointunet_tpu_torch.cli.gen_binary_map --inPros_path maps/ \
        --outBinary_path masks/ [--threshold 0.9]

Reads each ``<ID>.npy`` map that ``train_attention --predict`` writes
((X, Y, Z, C) f32, or (X, Y, Z) salient probabilities), takes the salient
channel (index 1) and writes it thresholded as (X, Y, Z) uint8
``<ID>.nii.gz``, the masks ``data_prepare_brats --attention_mask_path``
reads. Host numpy only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import nifti


def gen_binary_map(prob: np.ndarray, threshold: float) -> np.ndarray:
    """(..., C) probabilities or (...) salient probabilities -> uint8
    mask."""
    if prob.ndim == 4:
        prob = prob[..., 1]
    return (prob >= threshold).astype(np.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--inPros_path", type=str, required=True)
    parser.add_argument("--outBinary_path", type=str, required=True)
    parser.add_argument("--threshold", type=float, default=0.9)
    args = parser.parse_args(argv)

    os.makedirs(args.outBinary_path, exist_ok=True)
    for fname in sorted(os.listdir(args.inPros_path)):
        if not fname.endswith(".npy"):
            continue
        case_id = fname[: -len(".npy")]
        prob = np.load(os.path.join(args.inPros_path, fname))
        binary = gen_binary_map(prob, args.threshold)
        nifti.save(
            binary, os.path.join(args.outBinary_path, f"{case_id}.nii.gz")
        )
        print(f"{case_id}: {int(binary.sum())} salient voxels")


if __name__ == "__main__":
    main()
