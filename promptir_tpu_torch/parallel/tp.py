"""Tensor parallelism of the block's GDFN and MDTA (Megatron-style).

Counterpart of promptir_tpu/parallel/tp.py. Each rank of a model group
holds a slice of one module's weights, the input and output are replicated
over the group, and each apply ends in one all_reduce:

  * GDFN, gate-aware: project_in's 2F output channels are [x1 | x2] and
    gelu(x1) * x2 pairs channel i with i + F, so rank k takes the same
    slice of both halves; the depthwise 3x3 is per channel and the gate
    stays local. F = int(2.66 C) rarely divides n, so the hidden is padded
    to a multiple of n with inert zero channels (gelu(0) * 0 through zero
    project_out columns adds nothing). project_out is row-parallel: each
    rank contracts its slice and the partial outputs are summed;
  * MDTA, head-parallel: qkv's output channels are [q | k | v] and head h
    owns channels [h d, (h + 1) d) of each, so rank k takes its heads' slab
    of all three and runs their L2 norms, Gram, softmax and apply alone;
    project_out is row-parallel.

Biases (`use_bias=True` modules) follow their weights; project_out's bias
is added once, after the sum. The slices are taken from the port's modules
(`shard_*_params`, a relayout of the weights on the host); the applies run
the plain ops, as JAX's do, on NCHW tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from promptir_tpu_torch.ops.attention import channel_attention
from promptir_tpu_torch.parallel.mesh import all_reduce_sum, group_rank, group_size


def _bias(conv, n_out):
    b = conv.bias
    return (torch.zeros(n_out, dtype=conv.weight.dtype,
                        device=conv.weight.device) if b is None else b.detach())


def shard_gdfn_params(ffn, n: int) -> list[dict]:
    """GDFN `ffn`'s weights in n gate-aware slices, one dict a rank: w1
    (2 fs, C, 1, 1), wdw (2 fs, 1, 3, 3), w2 (C, fs, 1, 1) and biases b1,
    bdw (2 fs) and b2 (C, replicated), fs = ceil(F / n)."""
    w1 = ffn.project_in.weight.detach()
    wdw = ffn.dwconv.weight.detach()
    w2 = ffn.project_out.weight.detach()
    f = w1.shape[0] // 2
    fs = -(-f // n)
    pad = fs * n - f

    def halves(t):
        """[x1 | x2] along dim 0, each padded with zeros to fs n."""
        z = t.new_zeros((pad,) + tuple(t.shape[1:]))
        return torch.cat([t[:f], z]), torch.cat([t[f:], z])

    def split(t):
        a, b = halves(t)
        return [torch.cat([a[k * fs:(k + 1) * fs], b[k * fs:(k + 1) * fs]])
                for k in range(n)]

    w2p = torch.cat([w2, w2.new_zeros((w2.shape[0], pad) + w2.shape[2:])], 1)
    b2 = _bias(ffn.project_out, w2.shape[0])
    return [dict(w1=a, wdw=b, w2=w2p[:, k * fs:(k + 1) * fs], b1=c, bdw=d,
                 b2=b2)
            for k, (a, b, c, d) in enumerate(zip(
                split(w1), split(wdw), split(_bias(ffn.project_in, 2 * f)),
                split(_bias(ffn.dwconv, 2 * f))))]


def gdfn_shard_apply(shard: dict, x, group):
    """One rank's slice of GDFN(x) on the replicated NCHW `x`, summed over
    `group` (one all_reduce), the replicated output bias added after."""
    dt = x.dtype
    fs2 = shard["w1"].shape[0]
    y = F.conv2d(x, shard["w1"].to(dt), shard["b1"].to(dt))
    y = F.conv2d(y, shard["wdw"].to(dt), shard["bdw"].to(dt), padding=1,
                 groups=fs2)
    y1, y2 = y.chunk(2, dim=1)
    out = F.conv2d(F.gelu(y1) * y2, shard["w2"].to(dt))
    return all_reduce_sum(out, group) + shard["b2"].to(dt)[:, None, None]


def tp_gdfn_apply(ffn, x, group):
    """GDFN `ffn`(x) with its hidden channels split over `group`: this
    rank's slice of the weights, then gdfn_shard_apply. For repeated calls
    slice once with shard_gdfn_params."""
    shard = shard_gdfn_params(ffn, group_size(group))[group_rank(group)]
    return gdfn_shard_apply(shard, x, group)


def shard_mdta_params(attn, n: int) -> list[dict]:
    """MDTA `attn`'s weights in n head-parallel slices, one dict a rank:
    wqkv (3 cs, C, 1, 1), wdw (3 cs, 1, 3, 3), temperature (heads / n, 1,
    1), wout (C, cs, 1, 1) and biases bqkv, bdw (3 cs) and bout (C,
    replicated), cs = C / n."""
    heads = attn.num_heads
    if heads % n:
        raise ValueError(f"{heads} heads do not split over {n} ranks")
    wqkv = attn.qkv.weight.detach()
    c = wqkv.shape[0] // 3
    cs, hs = c // n, heads // n

    def split(t):
        q, k, v = t.chunk(3)
        return [torch.cat([u[j * cs:(j + 1) * cs] for u in (q, k, v)])
                for j in range(n)]

    wout = attn.project_out.weight.detach()
    temp = attn.temperature.detach()
    bout = _bias(attn.project_out, c)
    return [dict(wqkv=a, wdw=b, temperature=temp[j * hs:(j + 1) * hs],
                 wout=wout[:, j * cs:(j + 1) * cs], bqkv=d, bdw=e, bout=bout)
            for j, (a, b, d, e) in enumerate(zip(
                split(wqkv), split(attn.qkv_dwconv.weight.detach()),
                split(_bias(attn.qkv, 3 * c)),
                split(_bias(attn.qkv_dwconv, 3 * c))))]


def mdta_shard_apply(shard: dict, x, group):
    """One rank's heads of MDTA(x) on the replicated NCHW `x`: its qkv slab,
    depthwise conv and channel attention alone, the row-parallel
    out-projection summed over `group` (one all_reduce)."""
    dt = x.dtype
    c3 = shard["wqkv"].shape[0]
    y = F.conv2d(x, shard["wqkv"].to(dt), shard["bqkv"].to(dt))
    y = F.conv2d(y, shard["wdw"].to(dt), shard["bdw"].to(dt), padding=1,
                 groups=c3)
    q, k, v = y.chunk(3, dim=1)
    out = channel_attention(q, k, v, shard["temperature"],
                            shard["temperature"].shape[0])
    out = F.conv2d(out, shard["wout"].to(dt))
    return all_reduce_sum(out, group) + shard["bout"].to(dt)[:, None, None]


def tp_mdta_apply(attn, x, group):
    """MDTA `attn`(x) with its heads split over `group` (see
    tp_gdfn_apply)."""
    shard = shard_mdta_params(attn, group_size(group))[group_rank(group)]
    return mdta_shard_apply(shard, x, group)
