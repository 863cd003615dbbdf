"""Operations and bytes of one XTransformerBlock (X-Restormer): channel
attention and its GDFN (the Restormer block's count,
counts/restormer_block.py), then LN, OCAB and LN + GDFN, counted from the
shapes.

OCAB: the qkv projection to 3 x inner channels, each query window's
win^2 x ow^2 logits and its product with v (2 a multiply-add), the
content-dependent relative position logits (q against the 2 rs - 1 rows of
each table, for the height and the width), the softmax (5 operations a
logit) and the projection back. The spatial GDFN as the port's kbench
counts ln_gdfn (tools/kbench.py:gdfn_work). The bytes count the block as
one function: its input read once, its output written once, each weight
read once, at 2 bytes an element.

`record(args, kwargs)` reads a call of `XTransformerBlock.forward(self,
x)`, x NCHW."""

from port_bench.counts import restormer_block

NBYTES = 2


def record(args, kwargs):
    blk, x = args[0], args[1]
    b, c, h, w = x.shape
    oc = blk.spatial_attn
    return (b, h, w, c, blk.channel_attn.num_heads, int(c * 2.66),
            oc.window_size, oc.overlap_win, oc.num_heads, oc.dim_head)


def work(rec):
    """(operations, bytes) of one call recorded by `record`."""
    b, h, w, c, ch_heads, f, win, ow, sp_heads, dh = rec
    ops, nbytes = restormer_block.work((b, h, w, c, ch_heads, f))
    px, inner = b * h * w, sp_heads * dh
    rows = px * sp_heads  # query rows over all windows and heads
    logits = rows * ow * ow
    rel = 2 * ow - 1
    ocab = (2 * px * c * 3 * inner + 2 * logits * dh * 2
            + 2 * rows * rel * dh * 2 + 5 * logits + 2 * px * inner * c)
    gdfn = 2 * px * (c * 2 * f + f * c) + 18 * px * 2 * f + 8 * px * c
    ln = 8 * px * c
    weights = 3 * inner * c + 2 * rel * dh + inner * c + 4 * c \
        + 2 * f * c + 18 * f + f * c
    return ops + ln + ocab + gdfn, nbytes + NBYTES * weights
