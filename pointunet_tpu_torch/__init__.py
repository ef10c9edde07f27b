"""pointunet_tpu_torch — the PyTorch + CUDA port of ``pointunet_tpu``.

The JAX package beside it is the unchanged reference; this package mirrors
its module paths and names so that each counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing of the reference: its
host I/O (``data/``) is a numpy-only copy of ``pointunet_tpu.data``'s.

Ported so far: the fused single-volume inference path
(``pipeline/fused.py``) that ``cli/serve.py`` drives, the ``segment`` CLI
on both of its paths, point-net training (``cli/run_brats.py``) and
saliency-net training (``cli/train_attention.py``). The reference's four
Pallas kernels have hand-written CUDA counterparts in ``csrc/``.
"""

__version__ = "0.1.0"
