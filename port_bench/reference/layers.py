"""Plain float32 layers of Restormer, PromptIR and X-Restormer.

Written from the published models (Restormer, Zamir et al., CVPR 2022;
PromptIR, Potlapalli et al., NeurIPS 2023, its `net/model.py`; X-Restormer,
Chen et al., arXiv 2310.11881, its `net/xrestormer.py`), on NCHW tensors,
with no kernel, no cache and no batching trick. Parameter names are those
of the published code, so a state dict of the measured models loads here
with `strict=True`. Every convolution and matrix product takes its operands
through `precision.q`, which is the identity in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.precision import q


class Conv2d(nn.Conv2d):
    """A bias-free convolution with "same" padding for odd kernels."""

    def __init__(self, cin, cout, k=1, groups=1):
        super().__init__(cin, cout, k, padding=k // 2, groups=groups,
                         bias=False)

    def forward(self, x):
        return F.conv2d(q(x), q(self.weight), None, self.stride, self.padding,
                        self.dilation, self.groups)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(q(x), q(self.weight), self.bias)


def matmul(a, b):
    return q(a) @ q(b)


class _LNBody(nn.Module):
    def __init__(self, dim, bias_free):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if bias_free else nn.Parameter(torch.zeros(dim))


class LayerNorm(nn.Module):
    """Restormer's LayerNorm over the channels of each pixel, biased
    variance, eps 1e-5 inside the root; BiasFree does not subtract the
    mean."""

    def __init__(self, dim, bias_free=False):
        super().__init__()
        self.body = _LNBody(dim, bias_free)

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = x.var(1, keepdim=True, unbiased=False)
        w = self.body.weight[:, None, None]
        if self.body.bias is None:
            return x / torch.sqrt(var + 1e-5) * w
        return (x - mu) / torch.sqrt(var + 1e-5) * w \
            + self.body.bias[:, None, None]


class Attention(nn.Module):
    """MDTA: transposed (channel) attention with L2-normalised q and k."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv2d(dim, dim * 3, 1)
        self.qkv_dwconv = Conv2d(dim * 3, dim * 3, 3, groups=dim * 3)
        self.project_out = Conv2d(dim, dim, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        qq, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        qq, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w)
                    for t in (qq, k, v))
        qq = F.normalize(qq, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = (matmul(qq, k.transpose(-2, -1)) * self.temperature).softmax(-1)
        return self.project_out(matmul(attn, v).reshape(b, c, h, w))


class FeedForward(nn.Module):
    """GDFN: 1x1 to 2F, depthwise 3x3, gelu(x1) * x2, 1x1 back."""

    def __init__(self, dim, expansion):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv2d(dim, hidden * 2, 1)
        self.dwconv = Conv2d(hidden * 2, hidden * 2, 3, groups=hidden * 2)
        self.project_out = Conv2d(hidden, dim, 1)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, expansion=2.66, bias_free=False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, bias_free)
        self.ffn = FeedForward(dim, expansion)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class Downsample(nn.Module):
    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(Conv2d(n_feat, n_feat // 2, 3),
                                  nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(Conv2d(n_feat, n_feat * 2, 3),
                                  nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_c, dim):
        super().__init__()
        self.proj = Conv2d(in_c, dim, 3)

    def forward(self, x):
        return self.proj(x)


class PromptGenBlock(nn.Module):
    """softmax(Linear(GAP(x))) mixes a bank of prompt maps, resized
    bilinearly to x's size, then a 3x3 conv."""

    def __init__(self, prompt_dim, prompt_len, prompt_size, lin_dim,
                 align_corners=False):
        super().__init__()
        self.prompt_param = nn.Parameter(
            torch.rand(1, prompt_len, prompt_dim, prompt_size, prompt_size))
        self.linear_layer = Linear(lin_dim, prompt_len)
        self.conv3x3 = Conv2d(prompt_dim, prompt_dim, 3)
        self.align_corners = align_corners

    def forward(self, x):
        h, w = x.shape[-2:]
        weights = self.linear_layer(x.mean(dim=(-2, -1))).softmax(dim=1)
        prompt = (weights[:, :, None, None, None]
                  * self.prompt_param[0][None]).sum(1)
        prompt = F.interpolate(prompt, (h, w), mode="bilinear",
                               align_corners=self.align_corners)
        return self.conv3x3(prompt)


def _rel_to_abs(x):
    """HaloNet's relative-to-absolute index shift: (b, l, 2r - 1) ->
    (b, l, r)."""
    b, l, m = x.shape
    r = (m + 1) // 2
    x = torch.cat([x, x.new_zeros(b, l, 1)], dim=2).reshape(b, l * (m + 1))
    x = torch.cat([x, x.new_zeros(b, m - l)], dim=1).reshape(b, l + 1, m)
    return x[:, :l, -r:]


def _relative_logits_1d(qg, rel_k):
    """qg: (b, x, y, d), rel_k: (2r - 1, d) -> (b, x, r, y, r), the logits
    of query column y against key column j, uniform over the key row."""
    b, h, w, _ = qg.shape
    r = (rel_k.shape[0] + 1) // 2
    logits = matmul(qg, rel_k.t()).reshape(b * h, w, 2 * r - 1)
    logits = _rel_to_abs(logits).reshape(b, h, w, r)
    return logits[:, :, None].expand(b, h, r, w, r)


class RelPosEmb(nn.Module):
    def __init__(self, block_size, rel_size, dim_head):
        super().__init__()
        scale = dim_head ** -0.5
        self.block_size = block_size
        self.rel_height = nn.Parameter(torch.randn(rel_size * 2 - 1, dim_head) * scale)
        self.rel_width = nn.Parameter(torch.randn(rel_size * 2 - 1, dim_head) * scale)

    def forward(self, qs):
        """qs: (n, block * block, d) -> (n, block * block, rel * rel)."""
        n, _, d = qs.shape
        blk = self.block_size
        qg = qs.reshape(n, blk, blk, d)
        w = _relative_logits_1d(qg, self.rel_width)  # b x i y j
        r = w.shape[2]
        w = w.permute(0, 1, 3, 2, 4).reshape(n, blk * blk, r * r)
        h = _relative_logits_1d(qg.transpose(1, 2), self.rel_height)
        # b x i y j -> b (y x) (j i)
        h = h.permute(0, 3, 1, 4, 2).reshape(n, blk * blk, r * r)
        return w + h


class OCAB(nn.Module):
    """Overlapping cross-attention: queries from win x win windows, keys and
    values from zero-padded overlapping ow x ow windows (nn.Unfold), a
    content-dependent relative position bias on the logits."""

    def __init__(self, dim, window_size, overlap_ratio, num_heads, dim_head):
        super().__init__()
        self.window_size = window_size
        self.overlap_win = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.inner = dim_head * num_heads
        self.qkv = Conv2d(dim, self.inner * 3, 1)
        self.project_out = Conv2d(self.inner, dim, 1)
        self.rel_pos_emb = RelPosEmb(window_size, self.overlap_win, dim_head)

    def forward(self, x):
        b, c, h, w = x.shape
        win, ow, hd, inner = (self.window_size, self.overlap_win,
                              self.num_heads, self.inner)
        nh, nw = h // win, w // win
        qs, ks, vs = self.qkv(x).chunk(3, dim=1)
        # b c (h p1) (w p2) -> (b h w) (p1 p2) c
        qs = qs.reshape(b, inner, nh, win, nw, win).permute(0, 2, 4, 3, 5, 1)
        qs = qs.reshape(b * nh * nw, win * win, inner)

        def windows(t):  # b (c j) i -> (b i) j c
            u = F.unfold(t, ow, stride=win, padding=(ow - win) // 2)
            return u.reshape(b, inner, ow * ow, nh * nw).permute(0, 3, 2, 1) \
                .reshape(b * nh * nw, ow * ow, inner)

        ks, vs = windows(ks), windows(vs)

        def heads(t):  # b n (head c) -> (b head) n c
            n = t.shape[1]
            return t.reshape(-1, n, hd, self.dim_head).transpose(1, 2) \
                .reshape(-1, n, self.dim_head)

        qs, ks, vs = heads(qs), heads(ks), heads(vs)
        qs = qs * self.dim_head ** -0.5
        attn = matmul(qs, ks.transpose(-2, -1)) + self.rel_pos_emb(qs)
        out = matmul(attn.softmax(dim=-1), vs)
        # (b h w head) (p1 p2) c -> b (head c) (h p1) (w p2)
        out = out.reshape(b, nh, nw, hd, win, win, self.dim_head)
        out = out.permute(0, 3, 6, 1, 4, 2, 5).reshape(b, inner, h, w)
        return self.project_out(out)


class XTransformerBlock(nn.Module):
    """channel attention, channel FFN, OCAB, spatial FFN, each after its
    own LayerNorm and with its own residual."""

    def __init__(self, dim, window_size, overlap_ratio, channel_heads,
                 spatial_heads, dim_head, expansion, bias_free=False):
        super().__init__()
        self.norm1 = LayerNorm(dim, bias_free)
        self.channel_attn = Attention(dim, channel_heads)
        self.norm2 = LayerNorm(dim, bias_free)
        self.channel_ffn = FeedForward(dim, expansion)
        self.norm3 = LayerNorm(dim, bias_free)
        self.spatial_attn = OCAB(dim, window_size, overlap_ratio,
                                 spatial_heads, dim_head)
        self.norm4 = LayerNorm(dim, bias_free)
        self.spatial_ffn = FeedForward(dim, expansion)

    def forward(self, x):
        x = x + self.channel_attn(self.norm1(x))
        x = x + self.channel_ffn(self.norm2(x))
        x = x + self.spatial_attn(self.norm3(x))
        return x + self.spatial_ffn(self.norm4(x))
