"""pointunet_tpu_torch — the PyTorch + CUDA port of ``pointunet_tpu``.

The JAX package beside it is the unchanged reference; this package mirrors
its module paths and names so that each counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing of the reference: its
host I/O (``data/``) is a numpy-only copy of ``pointunet_tpu.data``'s.

Every module of the reference has its counterpart here, and each
subpackage exports the reference's public names: the fused inference
path that ``cli/serve.py`` drives, the ``segment`` CLI, both trainers and
their CLIs, the Pancreas path, the offline and host tools, the
checkpoint bridge, the (data, point) mesh and the conv routes. The
reference's four Pallas kernels have hand-written CUDA counterparts in
``csrc/``, built at first use. What is left out, and why, is in
``ROADMAP.md`` (queue 1 item 4).
"""

__version__ = "0.1.0"
