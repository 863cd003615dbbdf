"""NAFNet-style "easy" (attention-free) blocks, NCHW.

Counterpart of promptir_tpu/ops/easy.py, in its order:
  * round_to_nearest_power_of_2, simple_gate (split the channels in two,
    multiply) and ChannelsLN (a channel LayerNorm with eps 1e-6, keys
    `weight`/`bias` with no `body.` wrapper);
  * EasyFeedForward: 1x1 to the power of two nearest 2.66 dim, gate, 1x1,
    1x1 out;
  * EasyChannelAttention: 1x1, depthwise 3x3, gate, the simplified channel
    attention (the global mean over H and W through `sca.1`, a 1x1, scales
    the gated tensor), 1x1, 1x1 out;
  * EasySpatialAttention: a value projection scaled by a one-channel
    sigmoid map (1x1, ChannelsLN, LeakyReLU(0.1), 3x3);
  * EasyTransformerBlock (channel attention, channel FFN, spatial
    attention, spatial FFN) and EasyChannelTransformerBlock (the first
    two), each branch behind the Restormer LayerNorm and a residual;
  * local_avg_pool (the TLC local pool of NAFNetLocal) and NAFBlock.
The state-dict names are the reference's, so its checkpoints load verbatim.
The projections carry the reference's all-in-one biases (`use_bias=False`:
none on `project_out` and `proj_v`); `bias=True` gives those a bias too, as
the JAX modules' `use_bias` does.

No kernel of the port runs here: the convolutions are `Conv` modules
(cuDNN), the rest plain PyTorch, as the JAX module leaves all of it to
XLA. The rounding
points are the JAX module's. The Easy blocks keep their stream in the
compute dtype. NAFBlock's `x * beta` multiplies a compute-dtype tensor by a
float32 parameter, which JAX promotes to float32, so its residual stream is
float32 from the first block on and every convolution casts its input back
to the compute dtype, as a flax `Conv(dtype=...)` does: NAFBlock takes that
dtype as an argument. `beta` and `gamma` are stored as the model stores its
weights (rounded to bfloat16 in a served bf16 model, as its LayerNorm
weights are) and multiplied in float32.

Under the H-sharded forward (parallel/spatial.py) the convolutions take
`Conv`'s plans, the channel attention's pool (`mean_hw`: EasyChannel
Attention's and NAFBlock's SCA) is the whole image's mean, and the TLC
pool gathers the rows, pools the whole and keeps the stripe's (JAX
ops/easy.py:89-91, 233-252).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.norm import LayerNorm, layernorm_nhwc
from promptir_tpu_torch.parallel.spatial import (
    global_mean_hw,
    global_rows,
    run_gathered,
)


def round_to_nearest_power_of_2(x: int) -> int:
    if x & (x - 1) == 0:
        return x
    msb = x.bit_length() - 1
    lower, upper = 1 << msb, 1 << (msb + 1)
    return lower if x < (lower + upper) // 2 else upper


def simple_gate(x):
    """NCHW: the first half of the channels times the second."""
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


def mean_hw(x):
    """The mean over H and W of NCHW `x` (the whole image's under the
    sharded forward), kept as (B, C, 1, 1): summed in float32 and rounded
    to x's dtype, as `jnp.mean` computes a bf16 mean."""
    return global_mean_hw(x, dims=(2, 3)).to(x.dtype)


class ChannelsLN(nn.Module):
    """LayerNorm over the channels of an NCHW tensor, eps 1e-6 (basicsr's
    LayerNorm2d); statistics in float32, the output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        y = layernorm_nhwc(x.permute(0, 2, 3, 1), self.weight, self.bias,
                           bias_free=False, eps=self.eps)
        return y.permute(0, 3, 1, 2)


class EasyFeedForward(nn.Module):
    def __init__(self, dim: int, expansion: float = 2.66, bias: bool = False):
        super().__init__()
        ffn = round_to_nearest_power_of_2(int(expansion * dim))
        self.conv1 = Conv(dim, ffn, bias=True)
        self.conv2 = Conv(ffn // 2, dim, bias=True)
        self.project_out = Conv(dim, dim, bias=bias)

    def forward(self, x):
        return self.project_out(self.conv2(simple_gate(self.conv1(x))))


class EasyChannelAttention(nn.Module):
    def __init__(self, dim: int, bias: bool = False):
        super().__init__()
        c = dim
        self.conv1 = Conv(c, c, bias=True)
        self.conv2 = Conv(c, c, 3, bias=True, groups=c)
        # the reference's nn.Sequential(AdaptiveAvgPool2d(1), Conv2d): key
        # `sca.1`; the pool is mean_hw
        self.sca = nn.Sequential(nn.Identity(), Conv(c // 2, c // 2, bias=True))
        self.conv3 = Conv(c // 2, c, bias=True)
        self.project_out = Conv(c, c, bias=bias)

    def forward(self, x):
        y = simple_gate(self.conv2(self.conv1(x)))
        y = y * self.sca[1](mean_hw(y))
        return self.project_out(self.conv3(y))


class EasySpatialAttention(nn.Module):
    def __init__(self, dim: int, inner_dim: int = 64, bias: bool = False):
        super().__init__()
        q = inner_dim // 4
        self.proj_v = Conv(dim, inner_dim, bias=bias)
        self.in_conv = nn.Sequential(Conv(inner_dim, q, bias=True),
                                     ChannelsLN(q), nn.LeakyReLU(0.1))
        self.out_SA = nn.Sequential(Conv(q, 1, 3, bias=True), nn.Sigmoid())
        self.project_out = Conv(inner_dim, dim, bias=bias)

    def forward(self, x):
        vs = self.proj_v(x)
        return self.project_out(vs * self.out_SA(self.in_conv(vs)))


class EasyTransformerBlock(nn.Module):
    """4-norm easy block: ch-attn -> ch-ffn -> spatial-attn -> spatial-ffn."""

    def __init__(self, dim: int, inner_dim: int = 64, expansion: float = 2.66,
                 bias_free_norm: bool = False, bias: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.channel_attn = EasyChannelAttention(dim, bias)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.channel_ffn = EasyFeedForward(dim, expansion, bias)
        self.norm3 = LayerNorm(dim, bias_free_norm)
        self.spatial_attn = EasySpatialAttention(dim, inner_dim, bias)
        self.norm4 = LayerNorm(dim, bias_free_norm)
        self.spatial_ffn = EasyFeedForward(dim, expansion, bias)

    def forward(self, x):
        x = x + self.channel_attn(self.norm1(x))
        x = x + self.channel_ffn(self.norm2(x))
        x = x + self.spatial_attn(self.norm3(x))
        return x + self.spatial_ffn(self.norm4(x))


class EasyChannelTransformerBlock(nn.Module):
    """Easy channel attention + easy FFN (the Easy model's prompt
    interaction)."""

    def __init__(self, dim: int, expansion: float = 2.66,
                 bias_free_norm: bool = False, bias: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free_norm)
        self.channel_attn = EasyChannelAttention(dim, bias)
        self.norm2 = LayerNorm(dim, bias_free_norm)
        self.channel_ffn = EasyFeedForward(dim, expansion, bias)

    def forward(self, x):
        x = x + self.channel_attn(self.norm1(x))
        return x + self.channel_ffn(self.norm2(x))


def local_avg_pool(x, kernel):
    """TLC local average pooling of NCHW `x` with window `kernel` (kh, kw).

    The window means at the valid positions from a zero-padded integral
    image in float32, edge-padded back to H x W (the pad split `p // 2,
    p - p // 2`); the global mean when the window covers the map. The
    output is in x's dtype."""
    _, _, h, w = x.shape
    k1, k2 = min(int(kernel[0]), h), min(int(kernel[1]), w)
    if k1 >= h and k2 >= w:
        return mean_hw(x)
    s = F.pad(x.float().cumsum(2).cumsum(3), (1, 0, 1, 0))
    out = (s[:, :, k1:, k2:] + s[:, :, :-k1, :-k2]
           - s[:, :, :-k1, k2:] - s[:, :, k1:, :-k2]) / (k1 * k2)
    ph, pw = h - out.shape[2], w - out.shape[3]
    out = F.pad(out, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                mode="replicate")
    return out.to(x.dtype)


class NAFBlock(nn.Module):
    """The Simple Baselines block.

    `tlc_kernel=None` pools the SCA globally (NAFNet); a (kh, kw) tuple
    pools it locally (NAFNetLocal's TLC, a fixed per-level window). `beta`
    and `gamma` have the reference's (1, C, 1, 1) shape."""

    def __init__(self, dim: int, dw_expand: int = 2, ffn_expand: int = 2,
                 tlc_kernel: "tuple | None" = None):
        super().__init__()
        c, dw, ffn = dim, dim * dw_expand, dim * ffn_expand
        self.tlc_kernel = tlc_kernel
        self.norm1 = ChannelsLN(c)
        self.conv1 = Conv(c, dw, bias=True)
        self.conv2 = Conv(dw, dw, 3, bias=True, groups=dw)
        self.sca = nn.Sequential(nn.Identity(), Conv(dw // 2, dw // 2, bias=True))
        self.conv3 = Conv(dw // 2, c, bias=True)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.norm2 = ChannelsLN(c)
        self.conv4 = Conv(c, ffn, bias=True)
        self.conv5 = Conv(ffn // 2, c, bias=True)
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def tlc_pool(self, x):
        """local_avg_pool of NCHW `x`; under the sharded forward the whole
        image's: its mean where the window covers the image, else the
        pool of the gathered rows, this stripe's rows kept."""
        k1, k2 = self.tlc_kernel
        if k1 >= global_rows(x.shape[2]) and k2 >= x.shape[3]:
            return mean_hw(x)
        return run_gathered(lambda xg: local_avg_pool(xg, self.tlc_kernel),
                            x, dim=2)

    def forward(self, inp, dtype: "torch.dtype | None" = None):
        """`dtype`: the compute dtype of the convolutions (default inp's).
        Returns float32 when `dtype` is narrower, as the JAX block does."""
        dt = dtype or inp.dtype
        x = self.conv2(self.conv1(self.norm1(inp).to(dt)))
        x = simple_gate(x)
        pooled = mean_hw(x) if self.tlc_kernel is None else self.tlc_pool(x)
        x = self.conv3(x * self.sca[1](pooled))
        y = inp + x * self.beta.float()
        x = self.conv4(self.norm2(y).to(dt))
        x = self.conv5(simple_gate(x))
        return y + x * self.gamma.float()
