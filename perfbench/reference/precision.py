"""Operand precisions of the plain reference.

``F32`` leaves every conv and matmul operand in float32 (TF32 is switched
off by ``strict_f32``). ``FP8`` is the control of a bf16 configuration:
each conv and matmul operand is rounded to float8 e4m3 with one scale a
tensor (its largest magnitude maps to 448, e4m3's largest finite value),
and multiplied in float32 with float32 sums, as an fp8 GEMM with per-tensor
scales computes. Gradients pass through the rounding unchanged.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """Within: float32 convs and matmuls without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class F32:
    name = "f32"

    @staticmethod
    def __call__(x: torch.Tensor) -> torch.Tensor:
        return x.float()


class FP8:
    name = "fp8"

    @staticmethod
    def __call__(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())


PRECISIONS = {"f32": F32(), "fp8": FP8()}
