"""CAMixer: content-aware window mixing with routed hard and easy parts.

Counterpart of promptir_tpu/ops/camixer.py (reference
net/camixer_prompt_xrestormer_eff.py:300-469, camixer_prompt_xrestormer_
effv2.py:325-551, ca_ta_promptxrestormer.py:317-357), channels-last:
  * `PredictorLG`: from the value projection and the per-window coordinate
    channels (and an optional global condition), a spatial gate `sa` and a
    two-way softmax score per window (float32); v1's (`with_offsets`) also
    the deformable offsets and a channel gate `ca`;
  * `route_mask`: in training a straight-through Gumbel-softmax sample
    (`gumbel_softmax_hard`, on uniforms the caller draws), at evaluation a
    static top-k of the windows by score, k = N at ratio >= 1 and
    max(1, round(N * ratio)) below (Python's round, half to even), kept by
    the JAX threshold rule `score >= sort(score)[N - k]`, so ties keep more
    than k windows;
  * `CAMixerV1`: window attention with deformable keys k = x +
    flow_warp(x, offsets) on the selected windows, `v * sa` on the others,
    as the dense masked blend `f_attn + vs * (1 - m)`; a depthwise 3x3 and a
    dilated depthwise 3x3 (`conv_sptial`), GELU times `ca` plus the blend,
    and the output projection. It returns the output and `decision`, the
    mean of the mask (the ratio loss's input);
  * `CAMixerV2`: OCAB-like attention of each window's queries over the
    overlapping (win + win * overlap) key and value windows with the
    relative position bias (ops/ocab.py), blended per window with the easy
    `v * sa` as `hard * m + easy * (1 - m)`, then the output projection;
    it returns the output and `decision`;
  * `BranchSelector`: a per-image label in float32, sigmoid of a classifier
    over the pooled squeeze-excite features; at evaluation the top
    max(1, round(B * hard_ratio)) images of the batch by label (ties keep
    more), in training the straight-through Gumbel sample over the batch
    axis (one image of the batch is hard).
Under the H-sharded forward (parallel/spatial.py) a mixer gathers the
level's rows and its condition, runs whole and keeps its stripe
(`run_gathered`, JAX ops/camixer.py:161-185): its top-k routing is over
every window of the image and flow_warp's offsets are unbounded; its mean
decision, taken on the gathered windows, is the same on every rank. The
selector's pool is the whole image's (`global_mean_hw`). Under a data
group (parallel/data.py) the Gumbel uniforms are the global batch's draw,
this rank's rows kept, and the selector decides on the global batch's
labels (gathered) and keeps this rank's images. No kernel of the port runs
here; the rounding points are the JAX module's (float32
logits, bias and softmax, the probabilities rounded to the compute dtype
before a float32 PV, the result in x's dtype).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.easy import ChannelsLN
from promptir_tpu_torch.ops.flow_warp import flow_warp
from promptir_tpu_torch.ops.norm import layernorm_nhwc
from promptir_tpu_torch.ops.ocab import RelPosEmb, extract_overlapping_windows
from promptir_tpu_torch.ops.window_attention import conv_nhwc, linear
from promptir_tpu_torch.parallel.data import (
    gather_batch,
    global_batch_shape,
    keep_rows,
)
from promptir_tpu_torch.parallel.spatial import global_mean_hw, run_gathered
from promptir_tpu_torch.precision import weight_as

# the uniform draw's range, the JAX module's (jax.random.uniform's minval
# and maxval): -log(-log(u)) stays finite
GUMBEL_LO, GUMBEL_HI = 1e-10, 1.0 - 1e-10


def gumbel_uniform(shape, generator, device):
    """The uniforms of one Gumbel-softmax sample, from `generator` (a
    torch.Generator on `device`), over the JAX module's range."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u * (GUMBEL_HI - GUMBEL_LO) + GUMBEL_LO).clamp_(min=GUMBEL_LO)


def batch_uniform(shape, generator, device):
    """gumbel_uniform for this rank's rows of a batch: the global batch's
    draw (parallel/data.py), its rows kept; `shape` itself alone."""
    return keep_rows(gumbel_uniform(global_batch_shape(shape), generator,
                                    device))


def gumbel_softmax_hard(logits, u, dim: int = -1):
    """torch F.gumbel_softmax(hard=True) on the uniforms `u`: the one-hot
    of the argmax with the soft sample's straight-through gradient."""
    y = (logits - torch.log(-torch.log(u))).softmax(dim)
    hard = F.one_hot(y.argmax(dim), y.shape[dim]).movedim(-1, dim).to(y.dtype)
    return hard + y - y.detach()


def topk_window_mask(scores, k: int):
    """(B, N) scores -> (B, N) {0, 1}: score >= the k-th largest."""
    n = scores.shape[-1]
    if k >= n:
        return torch.ones_like(scores)
    thresh = scores.sort(dim=-1).values[:, n - k, None]
    return (scores >= thresh).to(scores.dtype)


def keep_count(n: int, ratio: float) -> int:
    """Windows an image keeps at evaluation."""
    return n if ratio >= 1.0 else max(1, int(round(n * ratio)))


def route_mask(scores, ratio: float, deterministic: bool, u=None):
    """(B, N, 2) scores -> (B, N, 1) hard mask: the straight-through Gumbel
    sample on uniforms `u` in training, the static top-k at evaluation."""
    if deterministic:
        k = keep_count(scores.shape[1], ratio)
        return topk_window_mask(scores[:, :, 0], k)[..., None]
    return gumbel_softmax_hard(scores, u, dim=2)[:, :, 0:1]


@functools.lru_cache(maxsize=None)
def _coords(h: int, w: int, win: int, device: torch.device):
    lin = np.linspace(-1.0, 1.0, win, dtype=np.float32)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    tile = np.stack([gy, gx], axis=-1)
    with torch.inference_mode(False):
        return torch.from_numpy(np.tile(tile, (h // win, w // win, 1))).to(device)


def window_condition(b: int, h: int, w: int, win: int, device, dtype):
    """The per-window coordinate channels: a (win, win) grid of linspace(-1,
    1) coordinates, y first, tiled over the image; (B, H, W, 2)."""
    return _coords(h, w, win, torch.device(device)).to(dtype).expand(b, h, w, 2)


def mean_last(x, dims):
    """The mean over `dims`, summed in float32 and rounded to x's dtype, as
    jnp.mean computes a bf16 mean."""
    return x.float().mean(dim=dims, keepdim=True).to(x.dtype)


def pointwise(x, conv: nn.Conv2d):
    """A 1x1 `conv` on the last axis of `x`, in x's dtype."""
    w = conv.weight.reshape(conv.out_channels, -1)
    return F.linear(x, weight_as(w, x.dtype, "linear"),
                    weight_as(conv.bias, x.dtype, "linear"))


def to_windows(x, win: int):
    """(B, H, W, C) -> (B, N, win * win, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // win) * (w // win), win * win, c)


def from_windows(x, win: int, h: int, w: int):
    b, _, _, c = x.shape
    x = x.reshape(b, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class PredictorLG(nn.Module):
    """The window router (spatial gate and scores; v1's, `with_offsets`,
    also the offsets and the channel gate). `cdim` is its input's width,
    dim plus the condition channels."""

    def __init__(self, dim: int, cdim: int, window_size: int = 8,
                 with_offsets: bool = True):
        super().__init__()
        self.window_size = window_size
        self.with_offsets = with_offsets
        q = cdim // 4
        self.in_conv = nn.Sequential(Conv(cdim, q, bias=True), ChannelsLN(q),
                                     nn.LeakyReLU(0.1))
        if with_offsets:
            self.out_offsets = nn.Sequential(Conv(q, cdim // 8, bias=True),
                                             nn.LeakyReLU(0.1),
                                             Conv(cdim // 8, 2, bias=True))
            # the reference's Sequential(AdaptiveAvgPool2d(1), Conv2d,
            # Sigmoid)
            self.out_CA = nn.Sequential(nn.Identity(),
                                        Conv(q, dim, bias=True), nn.Sigmoid())
        self.out_SA = nn.Sequential(Conv(q, 1, 3, bias=True), nn.Sigmoid())
        win2 = window_size * window_size
        self.out_mask = nn.Sequential(nn.Linear(win2, window_size),
                                      nn.LeakyReLU(0.1),
                                      nn.Linear(window_size, 2))

    def forward(self, cond):
        """cond: (B, H, W, cdim). Returns {"sa": (B, H, W, 1), "scores":
        (B, N, 2) float32} and with offsets {"offsets": (B, H, W, 2), "ca":
        (B, 1, 1, dim)}."""
        win = self.window_size
        ln = self.in_conv[1]
        x = pointwise(cond, self.in_conv[0])
        x = F.leaky_relu(layernorm_nhwc(x, ln.weight, ln.bias, bias_free=False,
                                        eps=ln.eps), 0.1)
        out = {}
        if self.with_offsets:
            o = F.leaky_relu(pointwise(x, self.out_offsets[0]), 0.1)
            out["offsets"] = torch.tanh(pointwise(o, self.out_offsets[2])) * 8.0
            out["ca"] = torch.sigmoid(pointwise(mean_last(x, (1, 2)),
                                                self.out_CA[1]))
        out["sa"] = torch.sigmoid(conv_nhwc(x, self.out_SA[0]))
        b, h, w, _ = x.shape
        t = mean_last(x, (-1,))[..., 0]
        t = t.reshape(b, h // win, win, w // win, win).permute(0, 1, 3, 2, 4)
        s = F.leaky_relu(linear(t.reshape(b, -1, win * win), self.out_mask[0]),
                         0.1)
        out["scores"] = linear(s, self.out_mask[2]).float().softmax(-1)
        return out


class CAMixerV1(nn.Module):
    """Deformable-key window attention with routed hard and easy windows.
    `cond_dim` is the width of the optional global condition."""

    def __init__(self, dim: int, window_size: int = 8, ratio: float = 0.5,
                 bias: bool = True, cond_dim: int = 0):
        super().__init__()
        self.window_size, self.ratio = window_size, ratio
        self.project_v = Conv(dim, dim, bias=bias)
        self.project_q = nn.Linear(dim, dim, bias=bias)
        self.project_k = nn.Linear(dim, dim, bias=bias)
        self.conv_sptial = nn.Sequential(
            Conv(dim, dim, 3, bias=True, groups=dim),
            Conv(dim, dim, 3, bias=True, groups=dim, padding=2, dilation=2))
        self.project_out = Conv(dim, dim, bias=bias)
        self.route = PredictorLG(dim, dim + cond_dim + 2, window_size)

    def forward(self, x, condition_global=None, deterministic: bool = True,
                generator=None):
        """x: (B, H, W, C), H and W multiples of the window. In training
        (`deterministic=False`) the routing samples from `generator`.
        Returns (out, decision); under the sharded forward, gathered."""
        return run_gathered(
            lambda xg, cg: self._mix(xg, cg, deterministic, generator), x,
            condition_global)

    def _mix(self, x, condition_global, deterministic, generator):
        b, h, w, c = x.shape
        win = self.window_size
        if h % win or w % win:
            raise ValueError(f"CAMixerV1: H and W must be multiples of the "
                             f"window {win}, got {h}x{w}")
        v = pointwise(x, self.project_v)
        cond = [v, window_condition(b, h, w, win, x.device, v.dtype)]
        if condition_global is not None:
            cond.insert(1, condition_global.to(v.dtype))
        route = self.route(torch.cat(cond, -1))
        scores = route["scores"]
        u = None if deterministic else batch_uniform(scores.shape, generator,
                                                     scores.device)
        mask = route_mask(scores, self.ratio, deterministic, u)

        k_feat = x + flow_warp(x, route["offsets"])
        vs = v * route["sa"]
        vw, vsw = to_windows(v, win), to_windows(vs, win)
        m = mask[..., None].to(vw.dtype)  # (B, N, 1, 1)
        q1 = linear(to_windows(x, win) * m, self.project_q)
        k1 = linear(to_windows(k_feat, win) * m, self.project_k)
        attn = torch.matmul(q1.float(), k1.float().transpose(-2, -1))
        attn = attn.softmax(dim=-1).to(vw.dtype)
        f_attn = torch.matmul(attn.float(), (vw * m).float()).to(x.dtype)
        out = from_windows(f_attn + vsw * (1.0 - m), win, h, w)

        y = conv_nhwc(conv_nhwc(out, self.conv_sptial[0]), self.conv_sptial[1])
        out = F.gelu(y) * route["ca"] + out
        return pointwise(out, self.project_out), mask.mean()


class CAMixerV2(nn.Module):
    """Overlapping-window attention (the hard part) against `v * sa` (the
    easy part), routed per window. `cond_dim` is the width of the optional
    global condition."""

    def __init__(self, dim: int, window_size: int = 8,
                 overlap_ratio: float = 0.5, num_heads: int = 4,
                 dim_head: int = 16, ratio: float = 0.5, bias: bool = True,
                 cond_dim: int = 0):
        super().__init__()
        self.window_size, self.ratio = window_size, ratio
        self.overlap_win = int(window_size * overlap_ratio) + window_size
        self.num_heads, self.dim_head = num_heads, dim_head
        inner = dim_head * num_heads
        self.proj_q = Conv(dim, inner, bias=bias)
        self.proj_k = Conv(dim, inner, bias=bias)
        self.proj_v = Conv(dim, inner, bias=bias)
        self.route = PredictorLG(inner, inner + cond_dim + 2, window_size,
                                 with_offsets=False)
        self.rel_pos_emb = RelPosEmb(window_size, self.overlap_win, dim_head)
        self.project_out = Conv(inner, dim, bias=bias)

    def forward(self, x, condition_global=None, deterministic: bool = True,
                generator=None):
        """x: (B, H, W, C), H and W multiples of the window. In training
        (`deterministic=False`) the routing samples from `generator`.
        Returns (out, decision); under the sharded forward, gathered."""
        return run_gathered(
            lambda xg, cg: self._mix(xg, cg, deterministic, generator), x,
            condition_global)

    def _mix(self, x, condition_global, deterministic, generator):
        b, h, w, _ = x.shape
        win, ow = self.window_size, self.overlap_win
        if h % win or w % win:
            raise ValueError(f"CAMixerV2: H and W must be multiples of the "
                             f"window {win}, got {h}x{w}")
        hd, d = self.num_heads, self.dim_head
        nwin = (h // win) * (w // win)
        qs, ks, vs = (pointwise(x, p) for p in (self.proj_q, self.proj_k,
                                                 self.proj_v))
        cond = [vs, window_condition(b, h, w, win, x.device, vs.dtype)]
        if condition_global is not None:
            cond.insert(1, condition_global.to(vs.dtype))
        route = self.route(torch.cat(cond, -1))
        scores = route["scores"]
        u = None if deterministic else batch_uniform(scores.shape, generator,
                                                     scores.device)
        mask = route_mask(scores, self.ratio, deterministic, u)

        dt = qs.dtype
        qh = to_windows(qs, win).reshape(b, nwin, win * win, hd, d)
        qh = qh * torch.tensor(d ** -0.5, dtype=dt)
        kh = extract_overlapping_windows(ks, win, ow).reshape(b, nwin, ow * ow,
                                                              hd, d)
        vh = extract_overlapping_windows(vs, win, ow).reshape(b, nwin, ow * ow,
                                                              hd, d)
        attn = torch.einsum("bwqhd,bwkhd->bwhqk", qh.float(), kh.float())
        q_flat = qh.permute(0, 1, 3, 2, 4).reshape(b * nwin * hd, win * win, d)
        attn = attn + self.rel_pos_emb(q_flat).reshape(b, nwin, hd, win * win,
                                                       ow * ow)
        attn = attn.softmax(dim=-1).to(dt)
        hard = torch.einsum("bwhqk,bwkhd->bwqhd", attn.float(), vh.float())
        hard = hard.reshape(b, nwin, win * win, hd * d).to(x.dtype)

        easy = to_windows(vs * route["sa"], win)
        m = mask[..., None].to(hard.dtype)  # (B, N, 1, 1)
        out = from_windows(hard * m + easy * (1.0 - m), win, h, w)
        return pointwise(out, self.project_out), mask.mean()


class BranchSelector(nn.Module):
    """The per-image hard/easy router of CATA: keys `in_conv.0`, `in_conv.1`
    (ChannelsLN), `se.1`, `se.3` (bias-free 1x1s) and `classifier.0`."""

    def __init__(self, dim: int, hard_ratio: float = 0.5):
        super().__init__()
        self.hard_ratio = hard_ratio
        q = dim // 4
        self.in_conv = nn.Sequential(Conv(dim, q, bias=True), ChannelsLN(q),
                                     nn.LeakyReLU(0.1))
        # the reference's Sequential(AdaptiveAvgPool2d(1), Conv2d, LeakyReLU,
        # Conv2d)
        self.se = nn.Sequential(nn.Identity(), Conv(q, q), nn.LeakyReLU(0.1),
                                Conv(q, q))
        self.classifier = nn.Sequential(nn.Linear(q, 1), nn.Sigmoid())

    def forward(self, x, deterministic: bool = True, generator=None):
        """x: (B, H, W, C). Returns the (B,) float32 {0, 1} label of each
        image, 1 for the hard branch (straight through in training). Under
        a data group the choice is over the global batch's labels, and
        this rank's images keep theirs."""
        ln = self.in_conv[1]
        y = layernorm_nhwc(pointwise(x, self.in_conv[0]), ln.weight, ln.bias,
                           bias_free=False, eps=ln.eps)
        pooled = global_mean_hw(F.leaky_relu(y, 0.1)).to(y.dtype)
        z = F.leaky_relu(pointwise(pooled, self.se[1]), 0.1)
        z = pointwise(z, self.se[3])[:, 0, 0]  # the mean over one pixel
        label = torch.sigmoid(linear(z, self.classifier[0])).float()  # (B, 1)
        label = gather_batch(label)
        if deterministic:
            k = max(1, int(round(label.shape[0] * self.hard_ratio)))
            return keep_rows(topk_window_mask(label.T, k).T[:, 0])
        u = gumbel_uniform(label.shape, generator, label.device)
        return keep_rows(gumbel_softmax_hard(label, u, dim=0)[:, 0])
