"""pointunet_tpu_torch — the PyTorch + CUDA port of ``pointunet_tpu``.

The JAX package beside it is the unchanged reference; this package mirrors
its module paths and names so that each counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing of the reference: its
host I/O (``data/``) is a numpy-only copy of ``pointunet_tpu.data``'s.

The slice ported so far is the fused single-volume inference path
(``pipeline/fused.py``): the saliency U-Net in an ROI window, on-device
context-aware sampling, the cell-sorted KNN decimation pyramid (whose
large levels run the hand-written CUDA kernel in
``csrc/knn_cell_window.cu``), the RandLA-Net forward and the scatter of
labels back to the voxel grid, driven by ``cli/serve.py``.
"""

__version__ = "0.1.0"
