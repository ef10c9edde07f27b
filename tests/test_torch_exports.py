"""The port's subpackages export the JAX package's public names.

A caller of the reference who writes ``from pointunet_tpu.ops import knn``
can write the same line against ``pointunet_tpu_torch.ops``. One name is
left out on purpose: ``parallel.batch_point_sharding`` returns a
``NamedSharding``, and the port shards by explicit slabs
(``RandLANet(point_group=)``). Importing the subpackages loads no JAX and
builds or loads no library: the kernels build at first use.
"""
import importlib
import os
import subprocess
import sys

import pytest

SUBPACKAGES = ("ops", "core", "models", "data", "train", "pipeline",
               "parallel")
NOT_PORTED = {"parallel": {"batch_point_sharding"}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_reference_names(sub):
    ref = importlib.import_module(f"pointunet_tpu.{sub}")
    port = importlib.import_module(f"pointunet_tpu_torch.{sub}")
    want = [n for n in ref.__all__ if n not in NOT_PORTED.get(sub, ())]
    missing = [n for n in want if not hasattr(port, n)]
    assert not missing, missing
    # in the reference's order, each the port's own object
    assert [n for n in port.__all__ if n in ref.__all__] == want
    for name in want:
        obj = getattr(port, name)
        owner = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
        if owner:                   # constants carry no module
            assert owner.startswith("pointunet_tpu_torch"), (name, owner)


def test_subpackage_imports_load_no_jax_and_build_nothing():
    """In a fresh interpreter, importing the seven subpackages starts no
    compiler, loads no shared library and opens nothing for writing under
    ``pointunet_tpu_torch/_build``; no JAX and no module of the
    reference is loaded."""
    code = (
        # third-party imports first: numpy.testing runs lscpu on import
        "import builtins, ctypes, subprocess, sys, torch, numpy.testing\n"
        "import scipy.ndimage\n"
        "build = " + repr(os.path.join(ROOT, "pointunet_tpu_torch", "_build"))
        + "\n"
        "seen = []\n"
        "class Popen(subprocess.Popen):\n"
        "    def __init__(self, *a, **kw):\n"
        "        seen.append(('process', a[:1]))\n"
        "        super().__init__(*a, **kw)\n"
        "subprocess.Popen = Popen\n"
        "cdll = ctypes.CDLL.__init__\n"
        "def load(self, name, *a, **kw):\n"
        "    seen.append(('library', name))\n"
        "    cdll(self, name, *a, **kw)\n"
        "ctypes.CDLL.__init__ = load\n"
        "real_open = builtins.open\n"
        "def opened(file, mode='r', *a, **kw):\n"
        "    if str(file).startswith(build) and set(mode) & set('wax+'):\n"
        "        seen.append(('write', file))\n"
        "    return real_open(file, mode, *a, **kw)\n"
        "builtins.open = opened\n"
        "import pointunet_tpu_torch.ops, pointunet_tpu_torch.core\n"
        "import pointunet_tpu_torch.models, pointunet_tpu_torch.data\n"
        "import pointunet_tpu_torch.train, pointunet_tpu_torch.pipeline\n"
        "import pointunet_tpu_torch.parallel\n"
        "from pointunet_tpu_torch.ops import cuda_build\n"
        "assert not cuda_build._loaded, cuda_build._loaded\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'pointunet_tpu'))\n"
        "print(seen, bad)\n"
        "sys.exit(1 if seen or bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
