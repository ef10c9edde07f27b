"""Segmentation service: watch a directory, segment arrivals
(``pointunet_tpu/cli/serve.py``).

The process builds the models once, then polls an inbox for new cases
and writes ``<case>.nii.gz`` labels plus a ``<case>.json`` latency record
to the outbox: ``latency_s`` (the host clock around
``segment_volume``), ``split_ms`` (each span of the request's tracer
record, ``core/trace.py``: the stages' device ms on the card, the host's
ms for the copies, the wait and the relabel) and ``host_syncs`` (the
request's blocking reads of the device). Cases already in the outbox
are skipped, so the service is restart-safe. The inbox holds, by ``--dataset``:

* ``brats`` (default): BraTS-layout case folders
  (``<case>/<case>_{t1ce,t1,flair,t2}.nii.gz``, as
  ``data.loader.find_brats_cases`` reads them); labels in BraTS values
  {0, 1, 2, 4};
* ``pancreas``: CT files ``PANCREAS_<ID>.nii*`` (the case is the file
  name before ``.nii``), each read by ``data.loader.load_pancreas_case``
  (HU clipped to [-100, 240], scaled to [0, 1]); labels {0, 1}. CTs
  differ in their slice count: one pipe is built a volume shape.

Usage:
    python -m pointunet_tpu_torch.cli.serve --inbox in/ --outbox out/ \
        [--dataset brats|pancreas] [--once] [--device cuda] [--roi X Y Z] \
        [--n_point N] [--saliency_checkpoint DIR] [--pointseg_checkpoint DIR]

``--once`` drains the current inbox and exits; without it the service
polls every ``--poll_s`` seconds. The models come from
``cli/segment.py:build_pipeline`` on its ``--fast`` path (the dataset's
configs): random weights from seed 0; ``--saliency_checkpoint`` and
``--pointseg_checkpoint`` restore the best checkpoint the port's saliency
or point trainer wrote, or an exported one of the JAX package's
(``export_jax_checkpoint.py``), as ``segment`` does.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np

from ..core import trace
from ..data import nifti
from ..data.loader import (
    find_brats_cases,
    load_brats_volume,
    load_pancreas_case,
)
from ..pipeline.fused import FusedPointUnet
from .segment import build_pipeline


def _serve_case(fast_pipe, case, mods, outbox, brats_labels):
    out_nii = os.path.join(outbox, case + ".nii.gz")
    out_rec = os.path.join(outbox, case + ".json")
    t0 = time.perf_counter()
    labels = fast_pipe.segment_volume(mods, brats_labels=brats_labels)
    latency = time.perf_counter() - t0
    rec = trace.records()[-1]
    nifti.save(labels.astype(np.uint8), out_nii)
    with open(out_rec, "w") as f:
        json.dump(
            {"case": case, "latency_s": round(latency, 3),
             "split_ms": {k: round(v, 3) for k, v in trace.split_ms(rec).items()},
             "host_syncs": rec["counters"].get("host_sync", 0),
             "labels": out_nii, "voxels": int((labels > 0).sum())},
            f,
        )
    return latency


class Server:
    """The models, one ``FusedPointUnet`` per volume shape (the ROI and
    padding are fixed at construction; the models are shared), the count
    of served cases and the per-case failure counts."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.pipeline = build_pipeline(args)
        self.pipes: dict = {}
        self.failures: dict = {}
        self.served = 0
        os.makedirs(args.outbox, exist_ok=True)

    def pipe(self, shape) -> FusedPointUnet:
        if shape not in self.pipes:
            p = self.pipeline
            self.pipes[shape] = FusedPointUnet(
                p.saliency_model, p.pointseg_model, p.scfg, p.pcfg,
                threshold=self.args.threshold,
                volume_shape=shape,
                roi_shape=self.args.roi,
                device=self.args.device,
            )
        return self.pipes[shape]

    def cases(self):
        """(case, loader) for every case in the inbox; a loader returns
        the (C, X, Y, Z) f32 volume. Loading waits for the caller, so that
        a half-written case fails inside its ``try``."""
        inbox = self.args.inbox
        if self.args.dataset == "brats":
            for case_dir in find_brats_cases(inbox):
                yield (os.path.basename(case_dir.rstrip("/")),
                       lambda d=case_dir: load_brats_volume(d))
            return
        for fname in sorted(os.listdir(inbox)):
            if fname.startswith("PANCREAS_") and ".nii" in fname:
                path = os.path.join(inbox, fname)
                yield (fname.split(".nii")[0], lambda p=path: np.transpose(
                    load_pancreas_case(p).image, (0, 3, 2, 1)))

    def drain(self) -> None:
        """Serve every inbox case that has no record in the outbox yet."""
        outbox = self.args.outbox
        for case, load in self.cases():
            if (os.path.exists(os.path.join(outbox, case + ".json"))
                    or self.failures.get(case, 0) >= 3):
                continue
            try:
                mods = load()
                pipe = self.pipe(tuple(mods.shape[1:]))
                latency = _serve_case(pipe, case, mods, outbox,
                                      self.args.dataset == "brats")
            except Exception as e:       # contain per-case failures:
                # a malformed or half-copied case is retried on later polls
                # and skipped after 3 strikes, so it cannot crash-loop or
                # starve the rest of the inbox
                self.failures[case] = self.failures.get(case, 0) + 1
                print(f"ERROR {case} (attempt {self.failures[case]}/3): {e}",
                      flush=True)
                traceback.print_exc()
                continue
            self.served += 1
            print(f"served {case}: {latency:.2f} s (total {self.served})",
                  flush=True)


def main(argv=None) -> Server:
    """Run the service; returns the ``Server`` (its ``served`` count and
    per-shape ``pipes``) once ``--once`` has drained the inbox."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--inbox", type=str, required=True,
                        help="directory of incoming cases")
    parser.add_argument("--outbox", type=str, required=True)
    parser.add_argument("--dataset", choices=["brats", "pancreas"],
                        default="brats")
    parser.add_argument("--saliency_checkpoint", type=str, default=None)
    parser.add_argument("--pointseg_checkpoint", type=str, default=None)
    parser.add_argument("--threshold", type=float, default=0.9)
    parser.add_argument("--roi", type=int, nargs=3, default=None,
                        metavar=("X", "Y", "Z"))
    parser.add_argument("--poll_s", type=float, default=2.0)
    parser.add_argument("--once", action="store_true",
                        help="drain the inbox once and exit")
    parser.add_argument("--n_point", type=int, default=365000)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args.fast, args.sa_stride = True, None   # build_pipeline's serving path

    server = Server(args)
    while True:
        server.drain()
        if args.once:
            return server
        time.sleep(args.poll_s)


if __name__ == "__main__":
    main()
