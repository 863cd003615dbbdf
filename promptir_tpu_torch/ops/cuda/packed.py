"""The bf16 route's copy of a GDFN's weights, in the kernels' packed layout.

The bf16 kernels (csrc/gdfn.cuh, "Packed layout") stream W2 and the hidden
tensor h with 16-byte copies, so F = int(2.66 C), which is odd at most
widths (127, 255, 425, 851, 1021), is padded to Fp, a multiple of
GATE_CHUNK, and h's 2Fp channels are ordered chunk by chunk: for gate
channels 32 i .. 32 i + 31, first their h1 then their h2, so one chunk's
h is 128 contiguous bytes. The copy holds, all zero in the padding:
  w1p   (2Fp, C) bf16, W1's rows in h's order;
  wdwp  (2Fp, 9) float32, the depthwise taps in h's order;
  w2p   (C, Fp) bf16.
It is made once for a set of weights and kept beside them, outside any
state_dict, until one of them changes (its version counter moves), as an
optimizer step or a load does. Weights made under torch.inference_mode
have no version counter; their copy is made anew on every call.

`cast_weight` gives a module's weight in the compute dtype the same way:
a model whose float32 weights compute in bfloat16 hands the kernels one
bf16 copy of each weight, kept beside it, so the packed copy above is made
once for it too, and serving such a model under torch.inference_mode makes
no inference tensors of its weights.

Each copy either function makes (a miss, or any call on inference
tensors) counts as a weight copy at "gdfn_weights" or "cast_weight"
(utils/tracing.py).
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from promptir_tpu_torch.utils import tracing

GATE_CHUNK = 32  # gate channels of one W2 chunk (csrc/gdfn.cuh: kGC)

_cache = WeakIdKeyDictionary()
_casts = WeakIdKeyDictionary()


def packed_f(f: int) -> int:
    """Fp: F rounded up to a gate chunk."""
    return -(-f // GATE_CHUNK) * GATE_CHUNK


def hidden_order(f: int) -> torch.Tensor:
    """Index into h's 2F channels ([h1 | h2]) of each packed channel, -1 for
    the padding: packed channel q is gate channel 32 (q // 64) + q % 32 of
    half (q // 32) % 2."""
    q = torch.arange(2 * packed_f(f))
    k = q // (2 * GATE_CHUNK) * GATE_CHUNK + q % GATE_CHUNK
    return torch.where(k < f, (q // GATE_CHUNK) % 2 * f + k, -1)


def _pack(w1, wdw, w2):
    tracing.count("weight_copies", "gdfn_weights")
    c, f = w2.shape
    order = hidden_order(f).to(w1.device)
    keep = (order >= 0)[:, None]
    src = order.clamp_min(0)
    w1p = torch.where(keep, w1.reshape(2 * f, c)[src], 0).to(torch.bfloat16)
    wdwp = torch.where(keep, wdw.reshape(2 * f, 9)[src].float(), 0)
    w2p = torch.zeros(c, packed_f(f), device=w2.device, dtype=torch.bfloat16)
    w2p[:, :f] = w2
    return w1p.contiguous(), wdwp.contiguous(), w2p


def _root(t):
    """The tensor that owns t's storage (t's views share its version)."""
    return t if t._base is None else t._base


def gdfn_weights(w1, w_dw, w2):
    """(w1p, wdwp, w2p) of a GDFN's bf16 weights w1 (2F, C[,1,1]), w_dw
    (2F, 1, 3, 3) or (2F, 9), w2 (C, F[,1,1]), or views of them: cached on
    w2's storage owner, remade when a weight is another tensor or has
    changed."""
    c = w2.shape[0]
    if any(t.is_inference() for t in (w1, w_dw, w2)):
        return _pack(w1, w_dw, w2.reshape(c, -1))
    stamp = tuple((id(_root(t)), t._version) for t in (w1, w_dw, w2))
    hit = _cache.get(_root(w2))
    if hit is not None and hit[0] == stamp:
        return hit[1]
    packed = _pack(w1, w_dw, w2.reshape(c, -1))
    _cache[_root(w2)] = (stamp, packed)
    return packed


def cast_weight(t, dtype):
    """Weight t in `dtype`: t itself when it is in it (or None), else a copy
    made outside autograd and inference mode and kept beside t until t
    changes. An inference tensor t is cast on every call."""
    if t is None or t.dtype == dtype:
        return t
    if t.is_inference():
        tracing.count("weight_copies", "cast_weight")
        return t.to(dtype)
    hit = _casts.get(t)
    if hit is not None and hit[0] == t._version:
        return hit[1]
    tracing.count("weight_copies", "cast_weight")
    with torch.inference_mode(False), torch.no_grad():
        copy = t.to(dtype)
    _casts[t] = (t._version, copy)
    return copy
