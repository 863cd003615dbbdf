"""Model complexity accounting: parameters, FLOPs, bytes, peak memory.

Counterpart of promptir_tpu/utils/flops.py, whose numbers come from XLA's
cost analysis of the compiled program. Here:
  * `flops` is `torch.utils.flop_counter.FlopCounterMode`'s count over one
    forward of the model's plain route, always on a float32 CPU copy of
    the model: the kernels launch through ctypes (ops/cuda/build.py), so no
    aten op and no counter sees them, and their plain versions compute the
    same function. It counts convolutions and matrix products, 2 a
    multiply-add, a SAME convolution's padded taps included; XLA also
    counts elementwise ops and bias adds and leaves the padded taps out,
    so this count reads ~5% under the JAX one (0.945 for promptir at
    64x64);
  * `bytes_accessed` is the eager, unfused traffic of the same forward:
    every op that is not a view reads each tensor input once and writes
    each output once (a TorchDispatchMode). XLA counts its fused program's
    bytes, which are fewer;
  * `peak_memory_mb` is what one forward on the card, through the kernels,
    holds at its peak (1e6 bytes a MB): the model's parameters and
    buffers, and `torch.cuda.max_memory_allocated()` over a second forward
    (after `reset_peak_memory_stats()`) less what was allocated before the
    input was made and the first forward ran. So the input, the packed
    weight copies that the first forward makes (ops/cuda/packed.py) and
    the activations count, and the other tensors alive in the process do
    not. On the CPU it is None, as the JAX function returns None where its
    backend has no figure.
The CAMixer models route windows (and CATA images) by their content, so
their counts are those of what the forward's input, zeros, routes.
"""

from __future__ import annotations

import copy
import itertools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor input and output of the ops that run
    under it, views left out (they move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _forward(model, x, **apply_kwargs):
    with torch.inference_mode():
        return model(x, **apply_kwargs)


def model_cost(model: torch.nn.Module,
               input_shape: Tuple[int, ...] = (1, 64, 64, 3),
               **apply_kwargs) -> Dict[str, Any]:
    """{"params", "flops", "bytes_accessed", "peak_memory_mb"} of one
    forward of `model` at `input_shape` (B, H, W, C), as the JAX function
    takes it; the forward gets zeros in its (B, C, H, W) transpose."""
    b, h, w, c = input_shape
    x = torch.zeros(b, c, h, w)
    plain = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    if hasattr(plain, "compute_dtype"):
        plain.compute_dtype = torch.float32
    counter = ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        _forward(plain, x, **apply_kwargs)
    del plain
    peak = None
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        xd = x.to(device)
        _forward(model, xd, **apply_kwargs)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        _forward(model, xd, **apply_kwargs)
        torch.cuda.synchronize(device)
        own = sum(t.numel() * t.element_size() for t in
                  itertools.chain(model.parameters(), model.buffers()))
        peak = (torch.cuda.max_memory_allocated(device) - before + own) / 1e6
    return {
        "params": count_params(model),
        "flops": flops.get_total_flops(),
        "bytes_accessed": counter.bytes,
        "peak_memory_mb": peak,
    }


def summarize(model: torch.nn.Module, input_shape=(1, 64, 64, 3),
              cost: Optional[Dict[str, Any]] = None, **apply_kwargs) -> str:
    """The JAX function's lines: #Params, FLOPs at the shape, Bytes and,
    on the card, Memory (of `cost` when given, else measured)."""
    c = cost or model_cost(model, input_shape, **apply_kwargs)
    lines = [f"#Params : {c['params'] / 1e6:.4f} M"]
    if c["flops"]:
        lines.append(f"FLOPs  : {c['flops'] / 1e9:.4f} G @ {input_shape}")
    if c["bytes_accessed"]:
        lines.append(f"Bytes  : {c['bytes_accessed'] / 1e9:.4f} GB")
    if c["peak_memory_mb"]:
        lines.append(f"Memory : {c['peak_memory_mb']:.1f} MB")
    return "\n".join(lines)
