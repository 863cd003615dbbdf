"""The bf16 Gram kernel's work split (ops/cuda/mdta.py:gram_plan), on the
CPU.

csrc/mdta_gram.cu:gram_tc_kernel runs on the card only; what surrounds it
is Python that the tests reach: the plan's tiles, pixel slices and
clusters, and `gram_items`, which lists what each block takes in the
order the kernel's loops take it. At every wide shape of the served, tiled
and training paths and at the ragged B2 37x53 shapes, the items cover each
(image, head, output element, pixel) exactly once, each item's slices are
summed in rank order, and the kernel's decomposition, computed in float32
numpy slice by slice and summed in that order, gives the plain Gram.
"""

import numpy as np
import pytest
import torch

from promptir_tpu_torch.ops.cuda import mdta

# (B, H, W, C, heads) of the wide route: promptxrestormerir's one-head
# blocks and promptir's widened noise blocks at B4 256x256, the training
# step's B6 128x128, the tiler's B8 128x128 chunk, the ragged B2 37x53
WIDE = [(4, 64, 64, 192, 1), (4, 32, 32, 384, 1), (4, 32, 32, 704, 1),
        (4, 64, 64, 320, 1), (4, 128, 128, 160, 1), (4, 32, 32, 704, 4),
        (4, 64, 64, 320, 4), (6, 16, 16, 704, 4), (6, 32, 32, 320, 4),
        (6, 32, 32, 192, 1), (6, 16, 16, 384, 1), (6, 64, 64, 160, 1),
        (8, 16, 16, 704, 4), (8, 32, 32, 320, 4), (2, 37, 53, 160, 1),
        (2, 37, 53, 704, 4)]


def intervals_partition(spans, end):
    """Whether the (lo, hi) spans, in their order, tile [0, end) once."""
    at = 0
    for lo, hi in spans:
        if lo != at or hi <= lo:
            return False
        at = hi
    return at == end


@pytest.mark.parametrize("b,h,w,c,heads", WIDE)
def test_gram_plan_covers_every_output_and_pixel_once(b, h, w, c, heads):
    """Each (image, head) is cut into tiles that partition its d x d output;
    each tile is one item, walked by one cluster; each item's ranks 0 ..
    slices - 1 take pixel spans that partition the image, in rank order; the
    plan fits the kernel (tiles of GRAM_ROWS x cols with cols a multiple of
    16 up to GRAM_MAX_COLS, at most GRAM_MAX_CLUSTER slices of whole
    GRAM_CHUNKs, no more clusters than the card holds at once)."""
    d, px = c // heads, h * w
    p = mdta.gram_plan(b, h, w, c, heads)
    assert mdta.stats_route(c, heads) == "wide"
    assert p.cols % 16 == 0 and 16 <= p.cols <= mdta.GRAM_MAX_COLS
    assert 1 <= p.slices <= mdta.GRAM_MAX_CLUSTER
    assert p.span % mdta.GRAM_CHUNK == 0 and (p.slices - 1) * p.span < px
    assert 1 <= p.clusters <= p.items
    assert p.clusters <= mdta.GRAM_CLUSTERS.get(p.slices, mdta.NUM_SMS)
    assert p.clusters * p.slices <= mdta.NUM_SMS
    assert mdta.GRAM_SMEM <= mdta.SMEM_LIMIT
    walked = {}  # item (bh, rows, cols) -> (cluster, [(rank, pixels)])
    for cl, r, bh, rows, cols, pix in mdta.gram_items(p, d, heads, px):
        item = walked.setdefault((bh, rows, cols), (cl, []))
        assert item[0] == cl  # one cluster an item
        item[1].append((r, pix))
    assert len(walked) == p.items == b * heads * p.tiles_m * p.tiles_n
    for bh in range(b * heads):
        tiles = sorted((rows, cols) for (g, rows, cols) in walked if g == bh)
        row_spans = sorted({rows for rows, _ in tiles})
        col_spans = sorted({cols for _, cols in tiles})
        assert intervals_partition(row_spans, d)
        assert intervals_partition(col_spans, d)
        assert len(tiles) == len(row_spans) * len(col_spans) == len(set(tiles))
    for _, ranks in walked.values():
        assert [r for r, _ in ranks] == list(range(p.slices))
        assert intervals_partition([pix for _, pix in ranks], px)


@pytest.mark.parametrize("b,h,w,c,heads", [(2, 37, 53, 160, 1),
                                           (2, 37, 53, 704, 4),
                                           (4, 32, 32, 384, 1)])
def test_gram_plan_sums_to_the_plain_gram(b, h, w, c, heads):
    """The kernel's arithmetic in float32 numpy: each rank's partial tile
    over its pixels, the ranks summed in rank order into the item's output
    (the cluster's reduction), every output written once; against
    mdta_gram_plain of the same bf16 q and k, within float32 rounding."""
    d, px = c // heads, h * w
    rng = np.random.default_rng(c + heads)
    q, k = (torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    qn = q.float().numpy().reshape(b, px, heads, d)
    kn = k.float().numpy().reshape(b, px, heads, d)
    p = mdta.gram_plan(b, h, w, c, heads)
    out = np.full((b * heads, d, d), np.nan, np.float32)
    partial = {}
    for cl, r, bh, (i0, i1), (j0, j1), (p0, p1) in mdta.gram_items(p, d, heads, px):
        bi, hi = divmod(bh, heads)
        tile = qn[bi, p0:p1, hi, i0:i1].T @ kn[bi, p0:p1, hi, j0:j1]
        key = (bh, i0, j0)
        partial[key] = tile if r == 0 else partial[key] + tile
        if r == p.slices - 1:
            assert np.isnan(out[bh, i0:i1, j0:j1]).all()
            out[bh, i0:i1, j0:j1] = partial[key]
    ref = mdta.mdta_gram_plain(q, k, heads).reshape(b * heads, d, d).numpy()
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gram_plan_fills_the_card_with_clusters_it_holds():
    """The slices: the most of (16, 8, 4, 2, 1) whose one-item-a-cluster
    grid the card holds at once (GRAM_CLUSTERS) and whose slices keep
    GRAM_MIN_CHUNKS chunks each: 16 at the four one-tile items of
    promptxrestormerir's d = 192 and 160 levels, 4 at its 2 x 2-tile d = 384
    and 320 levels and promptir's 16 heads, 1 at d = 704's 4 x 4 tiles a
    head (GRAM_SPLIT_TILES) and at the training step's 16 x 16 level (256
    pixels); past 132 items one block a cluster, persistent."""
    slices = {s: mdta.gram_plan(*s).slices for s in WIDE[:8]}
    assert slices == {(4, 64, 64, 192, 1): 16, (4, 32, 32, 384, 1): 4,
                      (4, 32, 32, 704, 1): 1, (4, 64, 64, 320, 1): 4,
                      (4, 128, 128, 160, 1): 16, (4, 32, 32, 704, 4): 4,
                      (4, 64, 64, 320, 4): 4, (6, 16, 16, 704, 4): 1}
    assert mdta.gram_plan(1, 8, 8, 192, 1).slices == 1
    big = mdta.gram_plan(64, 16, 16, 704, 4)  # 256 items: persistent
    assert big.slices == 1 and big.clusters == mdta.NUM_SMS


def test_gram_launch_args_are_the_plan():
    """The one int array the launch takes (a ctypes call costs host time by
    the argument), made once a shape: the output's row length, the shape
    and gram_plan's split."""
    args = mdta.gram_launch_args(4, 32, 32, 704, 4, 176 * 176)
    p = mdta.gram_plan(4, 32, 32, 704, 4)
    assert list(args) == [176 * 176, 4, 1024, 704, 4, p.cols, p.slices, p.span,
                          p.clusters, mdta.GRAM_SMEM]
    assert mdta.gram_launch_args(4, 32, 32, 704, 4, 176 * 176) is args

