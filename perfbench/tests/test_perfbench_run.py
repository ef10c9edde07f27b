"""The command itself: without a CUDA card it exits non-zero and prints
no result; its seeds may pass 32 bits."""
import subprocess
import sys
from pathlib import Path

import torch

from perfbench import weights

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "brats.serve",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_large_seeds():
    for seed in (0, 2 ** 31 - 1, 2 ** 31 + 12345, 2 ** 40):
        s = weights.sub_seed(seed, 1)
        assert 0 <= s < 2 ** 63
        torch.Generator().manual_seed(s)
    assert weights.sub_seed(2 ** 31 + 1, 5, 3) != weights.sub_seed(2 ** 31 + 1, 5, 4)
