"""LN + GDFN, the X-Restormer spatial feed-forward.

`ln_gdfn` replaces promptir_tpu/ops/pallas/gdfn.py:536 fused_ln_gdfn:
  out = x + W2 (gelu(h1) * h2),  [h1, h2] = dw3x3(W1 LN(x)).
The kernels are csrc/ln_gdfn.cu: ln_gdfn_a up to the hidden tensor, then
the gdfn_out kernel that block_tail's tail_b also is (csrc/gdfn.cuh), with
the residual read from x (one `ln_gdfn` call launches both). In float32
they take the SIMT tile, in bfloat16 the tensor cores with the weights'
packed copy (ops/cuda/packed.py).

Rounding points, shared by the kernels and the plain version: LN(x), the
hidden h and the gated gelu(h1) * h2 are each rounded to x's dtype; the
products, LN statistics and taps are fp32. In float32 this is the unfused
composition exactly (promptir_tpu/ops/pallas/autodiff.py:78 xla_ln_gdfn).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda import build, packed
from promptir_tpu_torch.ops.cuda.block import TC_MAX_WIDTH
from promptir_tpu_torch.ops.cuda.mdta import (
    GEMM_STAGE_FLOATS,
    PIXELS,
    PROJ_WBUF,
    SMEM_LIMIT,
    tc_ld,
)
from promptir_tpu_torch.ops.norm import layernorm_nhwc

_P = ctypes.c_void_p
_I = ctypes.c_int
THREADS = 256


def ln_gdfn_smem(c: int, dtype=torch.float32) -> int:
    """Shared-memory bytes of one ln_gdfn_a block of 64 pixels
    (csrc/ln_gdfn.cu). float32: the x tile (C x 64 fp32), the product
    staging tiles and the LN reduction; bfloat16: the x tile (64 x tc_ld(C)
    bf16) and the weight double buffer."""
    if dtype == torch.bfloat16:
        return PIXELS * tc_ld(c) * 2 + PROJ_WBUF * 2
    return (c * PIXELS + GEMM_STAGE_FLOATS + THREADS + 2 * PIXELS) * 4


def _launch(x, lnw, lnb, w1, wdw, w2, bias_free, eps):
    b, h, w, c = x.shape
    f = w2.shape[1]
    smem = ln_gdfn_smem(c, x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ln_gdfn: C={c} needs {smem} bytes of shared memory "
                         f"(> {SMEM_LIMIT})")
    f2 = 2 * f
    if x.dtype == torch.bfloat16:
        if c > TC_MAX_WIDTH or c % 8:
            raise ValueError(f"ln_gdfn: bf16 takes C a multiple of 8 up to "
                             f"{TC_MAX_WIDTH}, got {c}")
        w1, wdw, w2 = packed.gdfn_weights(w1, wdw, w2)
        f2 = 2 * packed.packed_f(f)
    hid = torch.empty((b, h, w, f2), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    fn = build.function("ln_gdfn_launch",
                        [_I] + [_P] * 8 + [_I] * 6
                        + [ctypes.c_float, ctypes.c_longlong, _P])
    with build.on_card_of(x):
        code = fn(build.dtype_code(x), x.data_ptr(), lnw.data_ptr(),
                  None if lnb is None else lnb.data_ptr(), w1.data_ptr(),
                  wdw.data_ptr(), w2.data_ptr(), hid.data_ptr(),
                  out.data_ptr(), b, h, w, c, f, int(bias_free), eps, smem,
                  build.stream_of(x))
    build.check(code, "ln_gdfn")
    return out


def ln_gdfn(x, ln_w, ln_b, w1, w_dw, w2, *, bias_free: bool = False,
            eps: float = 1e-5):
    """x + GDFN(LN(x)) on NHWC `x` (B, H, W, C), float32 or bfloat16.

    ln_w, ln_b: (C,) (ln_b unused when bias_free); w1: (2F, C[,1,1]);
    w_dw: (2F, 1, 3, 3) or (2F, 9); w2: (C, F[,1,1]). Returns (B, H, W, C)
    in x's dtype.
    """
    if x.dim() != 4:
        raise ValueError(f"ln_gdfn: x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_gdfn: x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    f = w2.shape[1] if w2.dim() >= 2 else -1
    if (w2.numel() != c * f or w1.numel() != 2 * f * c
            or w_dw.numel() != 2 * f * 9 or ln_w.shape != (c,)
            or not (bias_free or (ln_b is not None and ln_b.shape == (c,)))):
        raise ValueError(
            f"ln_gdfn: weights w1 {tuple(w1.shape)}, w_dw "
            f"{tuple(w_dw.shape)}, w2 {tuple(w2.shape)}, ln_w "
            f"{tuple(ln_w.shape)}, ln_b "
            f"{None if ln_b is None else tuple(ln_b.shape)} do not fit C={c}")
    w1m = w1.reshape(2 * f, c)
    wdw = w_dw.reshape(2 * f, 9)
    w2m = w2.reshape(c, f)
    if x.device.type == "cpu":
        return ln_gdfn_plain(x, ln_w, ln_b, w1m, wdw, w2m,
                             bias_free=bias_free, eps=eps)
    ws = [ln_w, None if bias_free else ln_b, w1m, wdw, w2m]
    for t in ws:
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise TypeError("ln_gdfn: weights must match x's device and dtype")
    x = x.contiguous()
    ws = [None if t is None else t.contiguous() for t in ws]
    out = _launch(x, *ws, bias_free, eps)
    ln_gdfn.launches += 1
    return out


ln_gdfn.launches = 0


def ln_gdfn_plain(x, ln_w, ln_b, w1, w_dw, w2, *, bias_free: bool = False,
                  eps: float = 1e-5):
    """The same function in plain PyTorch (fp32 arithmetic, the kernels'
    rounding points)."""
    c = x.shape[-1]
    f = w2.shape[1]
    dt = x.dtype

    def rt(t):
        return t.to(dt).float()

    y = rt(layernorm_nhwc(x.float(), ln_w, ln_b, bias_free=bias_free, eps=eps))
    hid = rt(y @ w1.reshape(2 * f, c).float().t())
    g1, g2 = dwconv3x3_nhwc(hid, w_dw.reshape(2 * f, 9).float()).split(f, dim=-1)
    g = rt(F.gelu(g1) * g2)
    return (x.float() + g @ w2.reshape(c, f).float().t()).to(dt)
