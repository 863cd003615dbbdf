"""Uformer building blocks: window attention, LeFF, shift masks, projections.

Counterpart of promptir_tpu/ops/window_attention.py (reference
net/prompt_uformer.py): the torch LayerNorm, window partition and reverse,
the relative-position index and the Swin shift mask, the qkv projections
(`LinearProjection`, and `ConvProjection` of `SepConv2d`s), `WindowAttention`
with its learned relative-position bias, `Mlp` and `LeFF`, the
`LeWinTransformerBlock`, and the Uformer's input, output, down and up
projections. The state-dict names are the reference's (the integer buffer
`relative_position_index` included), so its checkpoints load verbatim.

The features stay channels-last (B, H, W, C), as in the JAX modules: the
LayerNorms and Linears act on the last axis, and a 3x3 convolution sees an
NCHW view of the same memory (`conv_nhwc`, through the `Conv` module and
so through its sharded plans). No kernel of the port runs here: the
products are `torch.matmul`, the convolutions cuDNN's, as the JAX package
leaves all of this to XLA. The rounding points are the JAX
module's: q scaled in its dtype, the logits, the bias, the shift mask and
the softmax in float32, the probabilities rounded to v's dtype before PV
(a float32 product), the result rounded to x's dtype before `proj`; the
transposed convolution of `UformerUpsample` computes in float32 in any
model. `DropPath` is the JAX module's stochastic depth: the identity at rate
0 or when deterministic (how the trainers apply these models), else one
keep draw an image from an explicit generator (the global batch's draw
under parallel/data.py's context, this rank's rows kept).

Under the H-sharded forward (parallel/spatial.py) a LeWin block works on
a stripe, as the JAX block does (promptir_tpu/ops/window_attention.py:
304-380): its windows lie inside the stripe, the shifted roll crosses the
seams (`sharded_roll_h` on H, `torch.roll` on W) and the Swin mask is this
stripe's window rows of the whole image's; a stripe thinner than a window
(a deep Uformer level) gathers the level and runs the block whole. The
window attention itself runs unsharded: its tokens are a window's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.norm import layernorm_nhwc
from promptir_tpu_torch.parallel.data import global_batch_shape, keep_rows
from promptir_tpu_torch.parallel.mesh import group_rank, group_size
from promptir_tpu_torch.parallel.spatial import (
    current_spatial_group,
    run_gathered,
    sharded_roll_h,
    spatial_sharding,
)
from promptir_tpu_torch.precision import weight_as


def linear(x, lin: nn.Linear):
    """`lin` in x's dtype (float32 weights cast at use, as a flax Dense
    with `dtype` casts its params)."""
    return F.linear(x, weight_as(lin.weight, x.dtype, "linear"),
                    weight_as(lin.bias, x.dtype, "linear"))


def conv_nhwc(x, conv: Conv):
    """NHWC `x` through the `Conv` module `conv` (its stride, padding,
    dilation and groups, and its sharded plans), in x's dtype; the NCHW view
    is channels-last memory, as cuDNN takes it."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class TorchLayerNorm(nn.Module):
    """nn.LayerNorm over the last axis, eps 1e-5: statistics in float32,
    the output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layernorm_nhwc(x, self.weight, self.bias, bias_free=False,
                              eps=self.eps)


def window_partition(x, win: int):
    """(B, H, W, C) -> (B * nH * nW, win * win, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def window_reverse(windows, win: int, h: int, w: int):
    """(B * nH * nW, win * win, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // win) * (w // win))
    x = windows.reshape(b, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(win: int) -> np.ndarray:
    """The static (win^2, win^2) index into the (2 win - 1)^2 bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(win), np.arange(win), indexing="ij")
    ).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """The Swin shifted-window mask: (nW, win^2, win^2) of {0, -100}."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    img = img.reshape(-1, win * win)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# a model's shifted stages meet ~4 window sizes a padded input shape; a
# server sees a few shapes: 16 masks keep those without holding every shape
# it ever saw (one 256x256 input's first level alone is 16.8 MB)
SHIFT_MASKS = 16


@functools.lru_cache(maxsize=SHIFT_MASKS)
def shift_mask(h: int, w: int, win: int, shift: int, device: torch.device):
    """shift_attn_mask as a float32 tensor on `device`, kept for the
    SHIFT_MASKS most recent (H, W, win, shift, device). Made outside
    inference mode, so that a training forward may use a mask a served
    forward made."""
    with torch.inference_mode(False):
        return torch.from_numpy(shift_attn_mask(h, w, win, shift)).to(device)


class LinearProjection(nn.Module):
    """qkv by two Linears, `to_q` and `to_kv` (the reference's, :423-446)."""

    def __init__(self, dim: int, heads: int, bias: bool = True):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_kv = nn.Linear(dim, 2 * dim, bias=bias)

    def forward(self, x):
        bn, n, c = x.shape
        d = self.to_q.out_features // self.heads
        q = linear(x, self.to_q).reshape(bn, n, self.heads, d).transpose(1, 2)
        kv = linear(x, self.to_kv).reshape(bn, n, 2, self.heads, d)
        kv = kv.permute(2, 0, 3, 1, 4)
        return q, kv[0], kv[1]


class SepConv2d(nn.Module):
    """Depthwise 3x3, ReLU, pointwise 1x1, both with bias (:344-371)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.depthwise = Conv(cin, cin, kernel, bias=True, groups=cin)
        self.pointwise = Conv(cin, cout, 1, bias=True)

    def forward(self, x):
        """NHWC in and out."""
        return conv_nhwc(F.relu(conv_nhwc(x, self.depthwise)), self.pointwise)


class ConvProjection(nn.Module):
    """qkv by SepConv2d on each window's square token grid (:381-398)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = SepConv2d(dim, dim)
        self.to_k = SepConv2d(dim, dim)
        self.to_v = SepConv2d(dim, dim)

    def forward(self, x):
        bn, n, c = x.shape
        s = int(round(n ** 0.5))
        grid = x.reshape(bn, s, s, c)

        def split(proj):
            t = proj(grid)
            return t.reshape(bn, n, self.heads, -1).transpose(1, 2)

        return split(self.to_q), split(self.to_k), split(self.to_v)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, win_size: int, num_heads: int,
                 token_projection: str = "linear", qkv_bias: bool = True):
        super().__init__()
        self.win_size = win_size
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(nn.init.trunc_normal_(
            torch.empty((2 * win_size - 1) ** 2, num_heads), std=0.02,
            a=-0.04, b=0.04))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(win_size)))
        if token_projection == "conv":
            self.qkv = ConvProjection(dim, num_heads)
        else:
            self.qkv = LinearProjection(dim, num_heads, qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """x: (B * nW, win^2, C); mask: (nW, win^2, win^2) float32 or None.
        The tokens are whole windows: ConvProjection's convolutions on a
        window's grid run unsharded."""
        with spatial_sharding(None):
            return self._attend(x, mask)

    def _attend(self, x, mask):
        bn, n, c = x.shape
        q, k, v = self.qkv(x)
        d = q.shape[-1]
        q = q * torch.tensor(d ** -0.5, dtype=q.dtype)
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, -1).permute(2, 0, 1).float()
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bn // nw, nw, self.num_heads, n, n)
                    + mask[None, :, None]).reshape(bn, self.num_heads, n, n)
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(bn, n, -1).to(x.dtype)
        return linear(out, self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class LeFF(nn.Module):
    """Linear + GELU, depthwise 3x3 + GELU on the token grid, Linear; NHWC
    of any H x W (the reference assumes a square grid)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden), nn.GELU())
        self.dwconv = nn.Sequential(
            Conv(hidden, hidden, 3, bias=True, groups=hidden), nn.GELU())
        self.linear2 = nn.Sequential(nn.Linear(hidden, dim))

    def forward(self, x):
        y = F.gelu(linear(x, self.linear1[0]))
        y = F.gelu(conv_nhwc(y, self.dwconv[0]))
        return linear(y, self.linear2[0])


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm's, as
    promptir_tpu/ops/window_attention.py:53 DropPath): the identity at rate
    0 or when `deterministic`; else each image is kept with probability
    1 - rate (a uniform draw from `generator`) and scaled by its inverse,
    or zeroed."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        draw = keep_rows(torch.rand(
            global_batch_shape((x.shape[0],) + (1,) * (x.dim() - 1)),
            generator=generator, device=x.device))
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class LeWinTransformerBlock(nn.Module):
    """x + WMSA(LN(x)) with the cyclic shift and the optional per-window
    `modulator` (the reference's nn.Embedding), then + FFN(LN(x)); each
    branch through `drop_path`'s stochastic depth."""

    def __init__(self, dim: int, num_heads: int, win_size: int = 8,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 modulator: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = DropPath(drop_path)
        self.win_size, self.shift_size = win_size, shift_size
        self.norm1 = TorchLayerNorm(dim)
        self.attn = WindowAttention(dim, win_size, num_heads, token_projection)
        self.modulator = nn.Embedding(win_size * win_size, dim) if modulator \
            else None
        self.norm2 = TorchLayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = Mlp(dim, hidden) if token_mlp in ("ffn", "mlp") \
            else LeFF(dim, hidden)

    def forward(self, x, deterministic: bool = True, generator=None):
        """x: (B, H, W, C), H and W multiples of the window (the whole
        image's H under the sharded forward)."""
        b, h, w, c = x.shape
        win = self.win_size
        group = current_spatial_group()
        n = group_size(group)
        if (h * n) % win or w % win:
            raise ValueError(f"LeWinTransformerBlock: H and W must be "
                             f"multiples of the window {win}, got "
                             f"{h * n}x{w}")
        if n > 1 and h % win:
            return run_gathered(
                lambda xg: self.forward(xg, deterministic, generator), x)
        return self._body(x, deterministic, generator, group)

    def _body(self, x, deterministic, generator, group):
        b, h, w, c = x.shape
        win, shift = self.win_size, self.shift_size
        n = group_size(group)
        y = self.norm1(x)
        mask = None
        if shift > 0:
            y = torch.roll(sharded_roll_h(y, -shift, group), -shift, 2)
            mask = shift_mask(h * n, w, win, shift, x.device)
            if n > 1:  # this stripe's window rows of the whole image's
                per_stripe = (h // win) * (w // win)
                mask = mask[group_rank(group) * per_stripe:][:per_stripe]
        yw = window_partition(y, win)
        if self.modulator is not None:
            yw = yw + weight_as(self.modulator.weight, yw.dtype, "modulator")
        y = window_reverse(self.attn(yw, mask), win, h, w)
        if shift > 0:
            y = torch.roll(sharded_roll_h(y, shift, group), shift, 2)
        x = x + self.drop_path(y, deterministic, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), deterministic,
                                  generator)


class InputProj(nn.Module):
    """3x3 conv then LeakyReLU(0.01) (:776-800)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Sequential(Conv(cin, cout, 3, bias=True),
                                  nn.LeakyReLU(0.01))

    def forward(self, x):
        return F.leaky_relu(conv_nhwc(x, self.proj[0]), 0.01)


class OutputProj(nn.Module):
    """3x3 conv (:803-836)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Sequential(Conv(cin, cout, 3, bias=True))

    def forward(self, x):
        return conv_nhwc(x, self.proj[0])


class UformerDownsample(nn.Module):
    """4x4 stride-2 conv, padding 1 (:730-750)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(Conv(cin, cout, 4, bias=True, stride=2,
                                       padding=1))

    def forward(self, x):
        return conv_nhwc(x, self.conv[0])


class UformerUpsample(nn.Module):
    """2x2 stride-2 transposed conv (:753-771), weight (cin, cout, 2, 2).
    It computes in float32 and rounds to x's dtype, as the JAX module's
    float32 einsum does in a bf16 model."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = nn.Sequential(nn.ConvTranspose2d(cin, cout, 2, stride=2))

    def forward(self, x):
        d = self.deconv[0]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).float(), d.weight.float(),
                               d.bias.float(), stride=2)
        return y.permute(0, 2, 3, 1).to(x.dtype)
