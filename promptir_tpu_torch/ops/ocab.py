"""OCAB: overlapping cross-attention, the X-Restormer spatial attention.

Counterpart of promptir_tpu/ops/ocab.py (reference net/xrestormer.py:12-74,
215-283). Queries come from non-overlapping win x win windows; keys and
values from zero-padded overlapping ow x ow windows (ow = win + win *
overlap_ratio, stride win, torch `nn.Unfold`'s layout), with a
content-dependent 2-D relative position bias added to the logits.

The JAX package has no Pallas kernel here (XTransformerBlock leaves OCAB to
XLA), so this is plain PyTorch on NHWC tensors with the JAX rounding
points: q scaled in the compute dtype, logits, bias and softmax in fp32,
the probabilities cast to the compute dtype before the product with v.

Under the H-sharded forward (parallel/spatial.py) the query windows lie
inside the stripe (its height a multiple of the window) and the key and
value windows take their (ow - win) // 2 overlap rows from the
neighbours' stripes, zeros at the global top and bottom: the zero padding
of the whole image (promptir_tpu/ops/ocab.py:137-153).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.parallel.spatial import current_spatial_group, exchange_rows
from promptir_tpu_torch.precision import weight_as


def extract_overlapping_windows(x, win: int, ow: int):
    """(B, H, W, C) -> (B, nh * nw, ow * ow, C): zero-padded halo windows.

    Window i covers rows [i win - pad, i win - pad + ow) with pad =
    (ow - win) // 2, as torch Unfold(kernel=ow, stride=win, padding=pad).
    Under the sharded forward `x` is a stripe, a multiple of `win` rows,
    and the pad rows above and below come from its neighbours."""
    b, h, w, c = x.shape
    pad = (ow - win) // 2
    group = current_spatial_group()
    if group is None:
        xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    else:
        if h % win:
            raise ValueError(f"sharded OCAB needs a stripe height {h} that "
                             f"is a multiple of the window {win}")
        xp = F.pad(exchange_rows(x, pad, group), (0, 0, pad, pad))
    xw = xp.unfold(1, ow, win).unfold(2, ow, win)  # (B, nh, nw, C, ow, ow)
    nh, nw = xw.shape[1], xw.shape[2]
    return xw.permute(0, 1, 2, 4, 5, 3).reshape(b, nh * nw, ow * ow, c)


class RelPosEmb(nn.Module):
    """Content-dependent 2-D relative position bias (reference
    xrestormer.py:48-74): for q at in-window position (x, y) and k at halo
    position (i, j) the bias is q . rel_width[j - y + rs - 1]
    + q . rel_height[i - x + rs - 1], the reference's rel_to_abs indexing."""

    def __init__(self, block_size: int, rel_size: int, dim_head: int):
        super().__init__()
        self.block_size = block_size
        self.rel_size = rel_size
        scale = dim_head ** -0.5
        self.rel_height = nn.Parameter(torch.randn(rel_size * 2 - 1, dim_head) * scale)
        self.rel_width = nn.Parameter(torch.randn(rel_size * 2 - 1, dim_head) * scale)

    def forward(self, q):
        """q: (N, win * win, d) -> fp32 bias (N, win * win, rs * rs)."""
        win, rs = self.block_size, self.rel_size
        n, _, d = q.shape
        qg = q.float().reshape(n, win, win, d)
        pos = torch.arange(win, device=q.device)
        idx = torch.arange(rs, device=q.device)[None, :] - pos[:, None] + rs - 1
        # width: query column y, key column j; uniform over the key row
        logits_w = torch.einsum("nxyd,rd->nxyr", qg, self.rel_width.float())
        bias_w = logits_w[:, :, pos[:, None], idx]  # (n, x, y, j)
        # height: query row x, key row i; uniform over the key column
        logits_h = torch.einsum("nxyd,rd->nyxr", qg, self.rel_height.float())
        bias_h = logits_h[:, :, pos[:, None], idx].transpose(1, 2)  # (n, x, y, i)
        bias = bias_w[:, :, :, None, :] + bias_h[:, :, :, :, None]
        return bias.reshape(n, win * win, rs * rs)


class OCAB(nn.Module):
    def __init__(self, dim: int, window_size: int = 8,
                 overlap_ratio: float = 0.5, num_heads: int = 2,
                 dim_head: int = 16, bias: bool = False):
        super().__init__()
        self.window_size = window_size
        self.overlap_win = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        self.dim_head = dim_head
        inner = dim_head * num_heads
        self.qkv = Conv(dim, inner * 3, 1, bias=bias)
        self.rel_pos_emb = RelPosEmb(window_size, self.overlap_win, dim_head)
        self.project_out = Conv(inner, dim, 1, bias=bias)

    def forward(self, x):
        """x: (B, H, W, C) with H and W multiples of the window. Returns
        (B, H, W, C) in x's dtype."""
        b, h, w, c = x.shape
        win, ow = self.window_size, self.overlap_win
        if h % win or w % win:
            raise ValueError(f"OCAB: H and W must be multiples of the window "
                             f"{win}, got {h}x{w}")
        hd, d = self.num_heads, self.dim_head
        inner = hd * d
        nh, nw = h // win, w // win
        nwin = nh * nw
        dt = x.dtype

        qkv = F.linear(x, weight_as(self.qkv.weight.reshape(3 * inner, c), dt,
                                    "ocab"),
                       weight_as(self.qkv.bias, dt, "ocab"))
        qs, ks, vs = qkv.split(inner, dim=-1)
        qs = qs.reshape(b, nh, win, nw, win, inner).permute(0, 1, 3, 2, 4, 5)
        # channel = head * d + c (the reference's '(head c)')
        qs = qs.reshape(b, nwin, win * win, hd, d) * d ** -0.5
        ks = extract_overlapping_windows(ks, win, ow).reshape(b, nwin, ow * ow, hd, d)
        vs = extract_overlapping_windows(vs, win, ow).reshape(b, nwin, ow * ow, hd, d)

        attn = torch.einsum("bwqhd,bwkhd->bwhqk", qs.float(), ks.float())
        # the bias is computed on the scaled q, per (window, head)
        q_flat = qs.permute(0, 1, 3, 2, 4).reshape(b * nwin * hd, win * win, d)
        attn = attn + self.rel_pos_emb(q_flat).reshape(b, nwin, hd, win * win, ow * ow)
        attn = attn.softmax(dim=-1).to(dt)
        out = torch.einsum("bwhqk,bwkhd->bwqhd", attn.float(), vs.float()).to(dt)
        out = out.reshape(b, nh, nw, win, win, inner).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, inner)
        return F.linear(out, weight_as(self.project_out.weight.reshape(c, inner),
                                       dt, "ocab"),
                        weight_as(self.project_out.bias, dt, "ocab"))
