"""End-to-end segmentation: nii.gz volumes -> nii.gz labels
(``pointunet_tpu/cli/segment.py``).

    python -m pointunet_tpu_torch.cli.segment --data_3D_path cases/ \
        --outSegment_path out/ [--device cuda|cpu] [--fast --roi X Y Z] \
        [--postprocess] [--pointseg_checkpoint DIR] [...]

One in-process pipeline call per case found by ``find_brats_cases``,
``<case_id>.nii.gz`` written per case. The default path is the
reference-exact one (``pipeline/end2end.py``: the f32 saliency net over
sliding windows with the stride-1 spatial-attention gate, host sampling,
the point net, the probability scatter); ``--fast`` runs the fused
device-resident path (``pipeline/fused.py``: bf16 saliency net in one ROI
window, gate at stride 2). The reference's flags, plus ``--device``
(default ``cuda``; the CPU only when asked). ``POINTUNET_FASTCONV=pallas``
in the environment routes the saliency net's 3x3x3 convs through kernel 3
on both paths (and folds its gate's and 1x1x1 convs into 2-D convs; the
other routes: ``models/fastconv.py``).

Weights: random from seed 0, as the reference's when it is given no
checkpoint; ``--saliency_checkpoint`` and ``--pointseg_checkpoint``
restore the best checkpoint the port's saliency trainer
(``cli/train_attention.py``) or point trainer (``cli/run_brats.py``)
wrote, or one of the JAX package's trainers once
``export_jax_checkpoint.py`` has exported it (``core/checkpoint.py``). A
directory with no checkpoint ends the run with a message; one with the
JAX package's orbax checkpoints, with a message naming the exporter.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, NamedTuple

import torch

from ..core.checkpoint import BestMetricCheckpointer
from ..core.config import (
    PointSegConfig,
    SaliencyConfig,
    brats_pointseg_config,
    brats_saliency_config,
    pancreas_pointseg_config,
    pancreas_saliency_config,
)
from ..data import nifti
from ..data.loader import find_brats_cases, load_brats_volume
from ..models.randlanet import RandLANet, init_randlanet
from ..models.saliency_unet import SaliencyUNet, init_saliency_unet
from ..pipeline.end2end import PointUnetPipeline
from ..pipeline.fused import FusedPointUnet
from ..pipeline.postprocess import postprocess_brats
from ..train.pointseg import PointSegTrainer
from ..train.saliency import SaliencyTrainer


class Pipeline(NamedTuple):
    saliency_model: SaliencyUNet
    pointseg_model: RandLANet
    scfg: SaliencyConfig
    pcfg: PointSegConfig


def build_pipeline(args) -> Pipeline:
    """The configs and models of one run. ``args`` carries the CLI's
    ``dataset``, ``fast``, ``sa_stride``, ``n_point`` and checkpoint
    flags; an int ``n_point`` stands for the serving path's BraTS
    ``--fast`` models.

    ``--fast`` runs the saliency net in bf16 with its gate at stride 2,
    the default path in f32 at stride 1 (``--sa_stride`` overrides); the
    point net's dtype is auto (bf16 on CUDA, f32 on the CPU)."""
    if isinstance(args, int):
        args = argparse.Namespace(
            dataset="brats", fast=True, sa_stride=None, n_point=args,
            saliency_checkpoint=None, pointseg_checkpoint=None,
        )
    bf16 = args.fast
    stride = args.sa_stride if args.sa_stride is not None else (2 if bf16 else 1)
    if args.dataset == "brats":
        scfg = brats_saliency_config(use_bfloat16=bf16, sa_gate_stride=stride)
        pcfg = brats_pointseg_config(num_points=args.n_point)
    else:
        scfg = pancreas_saliency_config(
            use_bfloat16=bf16, sa_gate_stride=stride
        )
        pcfg = pancreas_pointseg_config(num_points=args.n_point)
    gen = torch.Generator().manual_seed(0)
    saliency = init_saliency_unet(scfg, gen)
    pointseg = init_randlanet(pcfg, gen)
    if args.saliency_checkpoint:
        saliency = _restore(args.saliency_checkpoint,
                            SaliencyTrainer(scfg, device="cpu"))
    if args.pointseg_checkpoint:
        pointseg = _restore(args.pointseg_checkpoint,
                            PointSegTrainer(pcfg, device="cpu"))
    return Pipeline(saliency, pointseg, scfg, pcfg)


def _restore(directory: str, trainer):
    """The model of the best checkpoint under ``directory`` (the port's,
    or an exported one of the JAX package), restored into a CPU state of
    ``trainer``, in eval mode; exits when there is none."""
    state = trainer.init_state()
    if BestMetricCheckpointer(directory).restore_best(state) is None:
        raise SystemExit(f"no checkpoint found under {directory}")
    return state.model.eval()


def main(argv=None) -> Dict[str, float]:
    """Segment every case; returns {case_id: seconds} (host clock around
    the pipeline call, file I/O excluded)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", choices=["brats", "pancreas"],
                        default="brats")
    parser.add_argument("--data_3D_path", type=str, required=True)
    parser.add_argument("--outSegment_path", type=str, required=True)
    parser.add_argument("--saliency_checkpoint", type=str, default=None)
    parser.add_argument("--pointseg_checkpoint", type=str, default=None)
    parser.add_argument("--threshold", type=float, default=0.9)
    parser.add_argument("--n_point", type=int, default=365000)
    parser.add_argument("--fast", action="store_true",
                        help="fused device-resident path: bf16 attention in "
                             "one window + on-device sampling "
                             "(pipeline/fused.py)")
    parser.add_argument("--roi", type=int, nargs=3, default=None,
                        metavar=("X", "Y", "Z"),
                        help="static brain-ROI crop for the fast path's "
                             "attention stage; e.g. --roi 192 208 155 for "
                             "BraTS")
    parser.add_argument("--postprocess", action="store_true")
    parser.add_argument("--sa_stride", type=int, default=None,
                        help="SA-gate resolution divisor; default: 2 on the "
                             "--fast path, 1 (reference-exact) otherwise")
    parser.add_argument("--att_downscale", type=int, default=1,
                        help="run the saliency net at 1/s resolution on the "
                             "--fast path")
    parser.add_argument("--mask_band", type=int, default=None,
                        help="boundary-band width for the downscaled fast "
                             "path; default: 4 when --att_downscale > 1")
    parser.add_argument("--mask_dilate", type=int, default=None,
                        help="isotropic mask dilation; mutually exclusive "
                             "with --mask_band")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    p = build_pipeline(args)
    os.makedirs(args.outSegment_path, exist_ok=True)
    brats = args.dataset == "brats"
    pipeline = fast_pipe = None
    if not args.fast:
        pipeline = PointUnetPipeline(
            p.saliency_model, p.pointseg_model, p.scfg, p.pcfg,
            threshold=args.threshold, device=args.device,
        )
    seconds = {}
    for case_dir in find_brats_cases(args.data_3D_path):
        case_id = os.path.basename(case_dir.rstrip("/"))
        mods = load_brats_volume(case_dir)              # (C, X, Y, Z)
        t0 = time.time()
        if args.fast:
            if fast_pipe is None:
                fast_pipe = FusedPointUnet(
                    p.saliency_model, p.pointseg_model, p.scfg, p.pcfg,
                    threshold=args.threshold,
                    volume_shape=mods.shape[1:],
                    roi_shape=args.roi,
                    att_downscale=args.att_downscale,
                    mask_dilate=args.mask_dilate or 0,
                    mask_band=(
                        args.mask_band if args.mask_band is not None
                        else (4 if args.att_downscale > 1
                              and not args.mask_dilate else 0)
                    ),
                    device=args.device,
                )
            labels = fast_pipe.segment_volume(mods, brats_labels=brats)
            if args.postprocess and brats:
                labels = postprocess_brats(labels)
        else:
            labels = pipeline.segment_volume(
                mods, brats_labels=brats, postprocess=args.postprocess
            )
        seconds[case_id] = time.time() - t0
        out = os.path.join(args.outSegment_path, f"{case_id}.nii.gz")
        nifti.save(labels, out)
        print(f"{case_id}: {seconds[case_id]:.2f} s -> {out}", flush=True)
    return seconds


if __name__ == "__main__":
    main()
