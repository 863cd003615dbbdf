"""Operations and bytes of one Restormer TransformerBlock,
x + MDTA(LN(x)), then x + GDFN(LN(x)), counted from its shapes.

The operations are a frozen copy of the port's kbench counts
(promptir_tpu_torch/tools/kbench.py:block_work, the stats pass and the
tail together): 2 a multiply-add, the depthwise taps, the Gram and the
attention product, the LayerNorms and the gates. The bytes count the
block as one function, whatever implements it: its input read once, its
output written once and each weight read once, at 2 bytes an element
(bfloat16). A block's share of its roofline is then the same work over
whatever time its implementation takes.

`record(args, kwargs)` reads the shapes from a call of the port's
`models/blocks.py:block_forward(norm1, attn, norm2, ffn, xh, ...)`, xh
NHWC."""

NBYTES = 2


def record(args, kwargs):
    attn, xh = args[1], args[4]
    b, h, w, c = xh.shape
    return (b, h, w, c, attn.num_heads, int(c * 2.66))


def work(rec):
    """(operations, bytes) of one call recorded by `record`."""
    b, h, w, c, heads, f = rec
    d, px = c // heads, b * h * w
    st_ops = 2 * px * (3 * c * c + 27 * c + d * c + 2 * c) + 8 * px * c
    tl_ops = 2 * px * (d * c + c * c + 2 * f * c + 18 * f + f * c) \
        + px * (8 * c + 10 * f)
    weights = 3 * c * c + 27 * c + c * c + 4 * c + 2 * f * c + 18 * f + f * c
    return st_ops + tl_ops, NBYTES * (2 * px * c + weights) + 4 * heads
