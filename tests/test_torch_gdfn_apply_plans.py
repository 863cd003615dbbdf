"""The plans of the bf16 ln_gdfn and apply kernels, and their wrappers'
launches, on the CPU: every plan of the promptxrestormerir serving path
(both buckets), of PromptIR's training forward and of ragged shapes fits
one block's shared memory, its tiles cover the image, its gate-chunk split
covers every chunk once and its column blocks every output; a recording
library shows each wrapper launching by its plan (no card here: the kernels
run only on one)."""

from __future__ import annotations

import contextlib

import pytest
import torch

from promptir_tpu_torch.ops.cuda import build, gdfn, mdta, packed

BF16 = torch.bfloat16
SCALES = [(1, 48, 1), (2, 96, 2), (4, 192, 4), (8, 384, 8), (8, 704, 4),
          (4, 320, 4), (2, 160, 4), (1, 96, 1)]  # PromptIR's (scale, C, heads)
XR_SCALES = [(1, 48), (2, 96), (4, 192), (8, 384), (8, 704), (4, 320),
             (2, 160), (1, 96)]  # promptxrestormerir's ln_gdfn widths


def xr_serving():
    """(B, H, W, C) of ln_gdfn on the promptxrestormerir serving path."""
    return [(4, h // s, w // s, c) for h, w in [(256, 256), (256, 192)]
            for s, c in XR_SCALES]


def training():
    """(B, H, W, C, heads) of PromptIR's training forward (B6 128x128)."""
    return [(6, 128 // s, 128 // s, c, heads) for s, c, heads in SCALES]


GDFN_SHAPES = (xr_serving() + [s[:4] for s in training()]
               + [(2, 37, 53, 96), (2, 37, 53, 704)])
APPLY_SHAPES = training() + [(2, 37, 53, 192, 4), (2, 37, 53, 40, 1)]


@pytest.mark.parametrize("b,h,w,c", GDFN_SHAPES)
def test_ln_gdfn_plan_fits_and_covers(b, h, w, c):
    f = int(c * 2.66)
    plan = gdfn.ln_gdfn_plan(b, h, w, c, f)
    th, tw = plan.tile
    assert plan.tile in gdfn.FUSED_TILES and gdfn.fused_nt2(plan.tile, c)
    assert plan.smem == gdfn.fused_smem(plan.tile, c) <= gdfn.SMEM_LIMIT
    assert plan.occupancy >= 1
    # the launch grid's tiles cover the image, none lies wholly outside it
    ty, tx = -(-h // th), -(-w // tw)
    assert (ty - 1) * th < h <= ty * th and (tx - 1) * tw < w <= tx * tw
    # every gate chunk in exactly one split, no split empty
    nk = packed.packed_f(f) // packed.GATE_CHUNK
    ranges = gdfn.chunk_ranges(nk, plan.split)
    assert len(ranges) == plan.split and all(len(r) for r in ranges)
    assert [k for r in ranges for k in r] == list(range(nk))
    # the launcher's conditions: the outputs fit the accumulators, and the
    # ring never overwrites a W2 buffer in use
    np_, kp, ns, nb, _ = gdfn._config(plan.tile, c)
    assert c <= np_ and ns <= nb * -(-c // kp)


def test_ln_gdfn_plan_fills_the_card_at_the_deep_shapes():
    """Where an image's tiles leave SMs idle, the plan splits the gate
    chunks: at least about one block an SM at (32, 32, 384) B4, (16, 16,
    384) B6 and (16, 16, 704) B6."""
    for b, h, w, c in [(4, 32, 32, 384), (6, 16, 16, 384), (6, 16, 16, 704)]:
        plan = gdfn.ln_gdfn_plan(b, h, w, c, int(c * 2.66))
        th, tw = plan.tile
        blocks = b * -(-h // th) * -(-w // tw) * plan.split
        assert plan.split > 1 and blocks >= 0.9 * gdfn.NUM_SMS, (c, plan)


@pytest.mark.parametrize("b,h,w,c,heads", APPLY_SHAPES)
def test_apply_plan_fits_and_covers(b, h, w, c, heads):
    plan = mdta.apply_plan(b, h, w, c, heads)
    d = c // heads
    d16 = -(-d // 16) * 16
    assert plan.pixels in mdta.APPLY_PIXELS
    assert plan.cols % 8 == 0 and 8 <= plan.cols <= mdta.APPLY_MAX_COLS
    # the column blocks cover C, none empty
    nblk = -(-c // plan.cols)
    assert (nblk - 1) * plan.cols < c <= nblk * plan.cols
    # a slab of attn: every head whole, or rows of one head
    assert plan.heads_staged in (1, heads) and heads % plan.heads_staged == 0
    assert plan.attn_rows % 16 == 0 and 16 <= plan.attn_rows <= d16
    assert plan.heads_staged == 1 or plan.attn_rows == d16
    slab = plan.heads_staged * plan.attn_rows * mdta.tc_ld(d) * 2
    assert plan.smem == mdta.apply_base_smem(c, plan.pixels, plan.cols) + slab
    assert plan.smem <= mdta.SMEM_LIMIT
    # persistent blocks: at least one, at most one a tile, about one wave
    tiles = -(-h * w // plan.pixels)
    assert 1 <= plan.slots <= tiles
    assert b * plan.slots * nblk <= 2 * mdta.NUM_SMS or plan.slots == 1
    assert plan.resident == mdta.apply_weight_smem(c, plan.cols)[0]


def recording_library(monkeypatch, calls):
    monkeypatch.setattr(build, "on_card_of", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_of", lambda t: 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)
    monkeypatch.setattr(build, "function", lambda name, argtypes, restype=None: (
        lambda *args: calls.append((name, args)) or 0))


def meta(*s, dt=BF16):
    return torch.zeros(*s, device="meta", dtype=dt)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("b,h,w,c", [(4, 256, 256, 96), (6, 16, 16, 384),
                                     (2, 37, 53, 704)])
def test_ln_gdfn_launches_by_the_plan(monkeypatch, b, h, w, c, dtype):
    """With storage-less tensors and a recording library, ln_gdfn passes the
    bf16 kernel the plan's tile, split and shared memory, the packed
    weights, and a partial-sum buffer only for a split; float32 launches
    its two-kernel route (tile 0 x 0, no split, its hidden tensor). One
    launch counts once."""
    calls, packs = [], []
    recording_library(monkeypatch, calls)
    real = packed.gdfn_weights
    monkeypatch.setattr(packed, "gdfn_weights", lambda *ws: packs.append(
        tuple(t.shape for t in ws)) or real(*ws))
    f = int(c * 2.66)
    monkeypatch.setattr(gdfn.ln_gdfn, "launches", 0)  # restored afterwards
    before = gdfn.ln_gdfn.launches
    out = gdfn.ln_gdfn(meta(b, h, w, c, dt=dtype), meta(c, dt=dtype),
                       meta(c, dt=dtype), meta(2 * f, c, 1, 1, dt=dtype),
                       meta(2 * f, 1, 3, 3, dt=dtype), meta(c, f, 1, 1, dt=dtype))
    assert out.shape == (b, h, w, c) and out.dtype == dtype
    assert gdfn.ln_gdfn.launches == before + 1
    assert [n for n, _ in calls] == ["ln_gdfn_launch"]
    args = calls[0][1]
    assert args[0] == (1 if dtype == BF16 else 0)
    assert args[9:15] == (b, h, w, c, f, 0) and args[-1] == 9
    if dtype == BF16:
        plan = gdfn.ln_gdfn_plan(b, h, w, c, f)
        assert args[16:20] == (*plan.tile, plan.split, plan.smem)
        assert (args[7] is None) == (plan.split == 1)  # the partial sums
        assert packs == [((2 * f, c, 1, 1), (2 * f, 1, 3, 3), (c, f, 1, 1))]
    else:
        assert args[16:20] == (0, 0, 1, gdfn.ln_gdfn_smem(c))
        assert args[7] is not None and packs == []


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,heads", [(6, 128, 128, 96, 1),
                                           (6, 16, 16, 704, 4),
                                           (2, 37, 53, 192, 4)])
def test_apply_launches_by_the_plan(monkeypatch, b, h, w, c, heads, dtype):
    """mdta_apply hands the kernel attn in float32 (no rounding launch: the
    bf16 kernel rounds it as it stages it) and, in bf16, the plan's pixels,
    columns, attn slab and shared memory; one launch counts once."""
    calls = []
    recording_library(monkeypatch, calls)
    monkeypatch.setattr(mdta, "kernel_attn", lambda *a: pytest.fail(
        "the apply rounds attn in its kernel"))
    d = c // heads
    x = meta(b, h, w, c, dt=dtype)
    monkeypatch.setattr(mdta.ln_mdta, "launches", 0)  # restored afterwards
    before = mdta.ln_mdta.launches
    out = mdta.mdta_apply(x, x, meta(b, heads, d, d, dt=torch.float32),
                          meta(c, c, dt=dtype))
    assert out.shape == x.shape and mdta.ln_mdta.launches == before + 1
    assert [n for n, _ in calls] == ["ln_mdta_launch"]
    args = calls[0][1]
    assert args[0] == (1 if dtype == BF16 else 0)
    assert args[6:11] == (b, h, w, c, heads) and args[-1] == 9
    if dtype == BF16:
        plan = mdta.apply_plan(b, h, w, c, heads)
        assert args[11:18] == (plan.pixels, plan.cols, plan.heads_staged,
                               plan.attn_rows, plan.slots, int(plan.resident),
                               plan.smem)
    else:
        assert args[11:18] == (mdta.apply_mp(c), c, heads, d, 1, 0,
                               mdta.ln_mdta_smem(c))
