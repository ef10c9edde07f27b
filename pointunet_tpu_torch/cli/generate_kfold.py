"""Shuffle case directories into k folds and pickle the split
(``pointunet_tpu/cli/generate_kfold.py``).

    python -m pointunet_tpu_torch.cli.generate_kfold --basedir cases/ \
        [--n_folds 10] [--output folds.pkl] [--seed 0]

Output: a pickle of {fold index: [case dir, ...]}, the BraTS case
directories (or, if there are none, every subdirectory) dealt in a
``default_rng(seed)`` permutation. Host numpy only.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data.loader import find_brats_cases


def make_folds(cases, n_folds, seed=0):
    rng = np.random.default_rng(seed)
    cases = list(cases)
    order = rng.permutation(len(cases))
    folds = {i: [] for i in range(n_folds)}
    for pos, idx in enumerate(order):
        folds[pos % n_folds].append(cases[idx])
    return folds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--basedir", type=str, required=True)
    parser.add_argument("--n_folds", type=int, default=10)
    parser.add_argument("--output", type=str, default="folds.pkl")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    cases = find_brats_cases(args.basedir)
    if not cases:
        cases = [
            os.path.join(args.basedir, d)
            for d in sorted(os.listdir(args.basedir))
            if os.path.isdir(os.path.join(args.basedir, d))
        ]
    folds = make_folds(cases, args.n_folds, args.seed)
    with open(args.output, "wb") as f:
        pickle.dump(folds, f)
    for i, members in folds.items():
        print(f"fold {i}: {len(members)} cases")


if __name__ == "__main__":
    main()
