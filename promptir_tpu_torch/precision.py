"""float32 on the card without TF32, in a scope.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32`), which keeps about three decimal
digits, and `torch.backends.cuda.matmul.allow_tf32` does the same for
cuBLAS products when a caller turns it on. The JAX package computes float32
in float32. The engine and the trainer therefore run float32 work inside
`exact_float32`, which turns both off and restores the caller's settings
afterwards; nothing is changed at import. The flags are process-wide, so
the scope also covers other threads while it is open.

A model whose float32 weights compute in bfloat16 casts them at use
(`weight_as`), as a flax module with `dtype=bfloat16` casts its params;
each such copy adds to the "weight_copies" counter (utils/tracing.py).
"""

from __future__ import annotations

import contextlib

import torch

from promptir_tpu_torch.utils import tracing


@contextlib.contextmanager
def exact_float32(dtype: torch.dtype):
    """TF32 off for cuDNN and cuBLAS while the block runs, when `dtype` (the
    work's compute dtype) is float32; a no-op for any other dtype."""
    if dtype != torch.float32:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def compute_dtype(model: torch.nn.Module) -> torch.dtype:
    """The dtype `model` computes in: its `compute_dtype` when it has one
    (a model built for training, models/__init__.py), else its weights'."""
    return getattr(model, "compute_dtype", None) or next(model.parameters()).dtype


def weight_as(t, dtype: torch.dtype, site: str):
    """Weight `t` (or None) in `dtype`: t itself when it is in it, else a
    fresh copy, counted as a weight copy at `site`."""
    if t is None or t.dtype == dtype:
        return t
    tracing.count("weight_copies", site)
    return t.to(dtype)
