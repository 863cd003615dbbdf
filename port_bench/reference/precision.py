"""The precision the reference's products compute in.

The reference is float32 with TF32 off. The lower-precision control of the
benchmark's correctness check is the same reference with the inputs of every
convolution and matrix product rounded to float8 e4m3 first, each tensor
scaled so that its largest magnitude maps to e4m3's largest finite value
(448), as an fp8 inference path scales per tensor. In a backward pass the
rounding is a straight-through estimator: the gradient flows as if the
rounding were the identity.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

E4M3_MAX = 448.0
_mode = contextvars.ContextVar("reference_precision", default="float32")


@contextlib.contextmanager
def products_in(mode: str):
    """Run the reference's products in `mode`: "float32" or "fp8"."""
    if mode not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    token = _mode.set(mode)
    try:
        yield
    finally:
        _mode.reset(token)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def q(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product, at the reference's current precision."""
    if _mode.get() == "float32":
        return x
    return x + (fp8_round(x) - x).detach()
