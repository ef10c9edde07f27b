"""Nothing the harness or its reference imports is JAX or the JAX package,
and the reference imports nothing of the program. Top-level module names
(before the first dot) are compared whole: the program's name begins with
the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import device

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = set(device.FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_sources(path):
    tops = set(_imports(HERE / path))
    assert not tops & FORBIDDEN
    if path.startswith("reference/"):
        assert "pointunet_tpu_torch" not in tops


def test_top_level_names_compared_whole():
    assert "pointunet_tpu" in FORBIDDEN
    assert "pointunet_tpu_torch".split(".")[0] not in FORBIDDEN


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import perfbench.reference.judge_serve, "
                   "perfbench.reference.judge_train")
    assert "pointunet_tpu_torch" not in tops
    assert not tops & FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("import torch\n"
            "from perfbench import run\n"
            "from perfbench.tests import tiny\n"
            "r = run.execute('brats.serve', 3, 0.2, False, torch.device('cpu'), 0.0,"
            " cfg=tiny.config('brats'), traffic=tiny.traffic('serve'))\n"
            "assert r['attempted'] >= 1")
    tops = _loaded(code)
    assert "pointunet_tpu_torch" in tops
    assert not tops & FORBIDDEN
