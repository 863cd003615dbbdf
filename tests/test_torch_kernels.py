"""The kernels' plain versions against the JAX package's functions.

On the CPU every wrapper runs its kernel's plain version, so these tests
hold the arithmetic that each CUDA kernel reproduces (and that chip_smoke.py
compares it with on the card) against the JAX side on the same numpy inputs:
  * mdta_stats + attn_from_stats against the Pallas `mdta_stats` in
    interpret mode. The Pallas kernel rounds q and k to bf16 before the Gram
    even in float32 (promptir_tpu/ops/pallas/mdta.py:107-113) and returns
    attn in x's dtype; the port keeps them fp32, so attn is compared at 3e-4
    (measured 3e-5), v tightly;
  * block_tail against the Pallas `fused_block_tail` in interpret mode on
    the same v and attn (its rational erf and single-pass LN variance agree
    to ~1e-6);
  * the whole block, stats -> softmax -> tail, tightly in float32 against
    the unfused JAX composition xla_ln_gdfn(xla_ln_mdta(x))
    (promptir_tpu/ops/pallas/autodiff.py:78,89);
  * the seam against the Pallas `shuffle_concat_pad` in interpret mode after
    unpadding, bit for bit;
  * mdta_stats' route-and-tile rule at every shape of the four paths, the
    wide route's stats pass and Gram composing to mdta_stats_plain bit for
    bit, and the wrappers' launch arguments with the library mocked.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.ops.pallas import block as jblock
from promptir_tpu.ops.pallas import mdta as jmdta
from promptir_tpu.ops.pallas import seam as jseam
from promptir_tpu.ops.pallas.autodiff import xla_ln_gdfn, xla_ln_mdta
from promptir_tpu_torch.ops.cuda import block, mdta, seam


def block_weights(c, heads, seed):
    """numpy weights in the JAX kernels' layout."""
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    return dict(
        ln1w=1 + n(c, sc=0.1), ln1b=n(c, sc=0.1), wqkv=n(c, 3 * c, sc=c ** -0.5),
        wdwa=n(3, 3, 3 * c, sc=0.3), wproj=n(c, c, sc=c ** -0.5),
        temp=np.float32(1) + n(heads, sc=0.2), ln2w=1 + n(c, sc=0.1),
        ln2b=n(c, sc=0.1), w1=n(c, 2 * f, sc=c ** -0.5),
        wdwf=n(3, 3, 2 * f, sc=0.3), w2=n(f, c, sc=f ** -0.5),
    )


def torch_weights(w):
    """The same weights in the port's (torch conv) layout."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(
        ln1w=t(w["ln1w"]), ln1b=t(w["ln1b"]), wqkv=t(w["wqkv"].T),
        wdwa=t(w["wdwa"].reshape(9, -1).T), wproj=t(w["wproj"].T),
        temp=t(w["temp"].reshape(-1, 1, 1)), ln2w=t(w["ln2w"]),
        ln2b=t(w["ln2b"]), w1=t(w["w1"].T), wdwf=t(w["wdwf"].reshape(9, -1).T),
        w2=t(w["w2"].T),
    )


def port_stats(x, tw, heads, bias_free=False):
    return mdta.mdta_stats(torch.from_numpy(x), tw["ln1w"], tw["ln1b"],
                           tw["wqkv"], tw["wdwa"], heads, bias_free=bias_free)


def port_tail(v, x, attn, tw, bias_free=False):
    return block.block_tail(v, torch.from_numpy(x), attn, tw["wproj"],
                            tw["ln2w"], tw["ln2b"], tw["w1"], tw["wdwf"],
                            tw["w2"], bias_free=bias_free)


def block_diag(attn, cp):
    """(B, heads, d, d) -> the Pallas kernels' (B, cp, cp) block-diagonal."""
    b, heads, d, _ = attn.shape
    out = np.zeros((b, cp, cp), np.float32)
    for h in range(heads):
        out[:, h * d:(h + 1) * d, h * d:(h + 1) * d] = attn[:, h]
    return out


@pytest.mark.parametrize("c,heads,hw", [(48, 2, (8, 16)), (32, 1, (16, 8)),
                                        (160, 1, (8, 16))])
def test_mdta_stats_matches_pallas(c, heads, hw):
    w = block_weights(c, heads, seed=c)
    x = np.random.default_rng(1).normal(size=(2, *hw, c)).astype(np.float32)
    v_j, attn_j = jmdta.mdta_stats(
        jnp.asarray(x), w["ln1w"], w["ln1b"], w["wqkv"], w["wdwa"],
        jnp.asarray(w["temp"]), heads, interpret=True,
    )
    tw = torch_weights(w)
    v, stats = port_stats(x, tw, heads)
    attn = mdta.attn_from_stats(stats, tw["temp"]).numpy()
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j)[..., :c],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(block_diag(attn, c),
                               np.asarray(attn_j)[:, :c, :c], atol=3e-4)


@pytest.mark.parametrize("bias_free", [False, True])
def test_block_tail_matches_pallas(bias_free):
    c, heads = 48, 2
    w = block_weights(c, heads, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 8, 16, c)).astype(np.float32)
    tw = torch_weights(w)
    v, stats = port_stats(x, tw, heads, bias_free)
    attn = mdta.attn_from_stats(stats, tw["temp"])
    out = port_tail(v, x, attn, tw, bias_free)
    cp = 128
    v_p = np.pad(v.numpy(), ((0, 0), (0, 0), (0, 0), (0, cp - c)))
    ref = jblock.fused_block_tail(
        jnp.asarray(v_p), jnp.asarray(x), jnp.asarray(block_diag(attn.numpy(), cp)),
        w["wproj"], w["ln2w"], None if bias_free else w["ln2b"], w["w1"],
        w["wdwf"], w["w2"], bias_free=bias_free, interpret=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize("c,heads,hw", [(48, 1, (9, 13)), (64, 4, (12, 20))])
def test_block_path_matches_unfused_jax(c, heads, hw):
    w = block_weights(c, heads, seed=5)
    x = np.random.default_rng(6).normal(size=(2, *hw, c)).astype(np.float32)
    ref = xla_ln_gdfn(
        xla_ln_mdta(jnp.asarray(x), w["ln1w"], w["ln1b"], w["wqkv"], w["wdwa"],
                    w["wproj"], jnp.asarray(w["temp"]), heads),
        w["ln2w"], w["ln2b"], w["w1"], w["wdwf"], w["w2"],
    )
    tw = torch_weights(w)
    v, stats = port_stats(x, tw, heads)
    out = port_tail(v, x, mdta.attn_from_stats(stats, tw["temp"]), tw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_seam_matches_pallas_bit_exact(dtype):
    b, hc, wc, c = 2, 4, 8, 48
    rng = np.random.default_rng(7)
    y = rng.normal(size=(b, hc, wc, 4 * c)).astype(np.float32)
    skip = rng.normal(size=(b, 2 * hc, 2 * wc, c)).astype(np.float32)
    # the Pallas kernel's layout: ij-major lanes padded to 256, padded skip
    y_ij = y.reshape(b, hc, wc, c, 4).transpose(0, 1, 2, 4, 3)
    yc = np.pad(y_ij.reshape(b, hc, wc, 4 * c), ((0, 0),) * 3 + ((0, 64),))
    wp = 2 * wc + 2 + ((-(2 * wc + 2)) % 8)
    skip_p = np.zeros((b, 2 * hc, wp, 128), np.float32)
    skip_p[:, :, 1:1 + 2 * wc, :c] = skip
    ref = jseam.shuffle_concat_pad(jnp.asarray(yc, dtype),
                                   jnp.asarray(skip_p, dtype), c, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))[:, :, 1:1 + 2 * wc, :2 * c]
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    out = seam.seam(torch.from_numpy(y).to(tdt), torch.from_numpy(skip).to(tdt))
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and counts no kernel launch."""
    c, heads = 48, 2
    tw = torch_weights(block_weights(c, heads, seed=8))
    x = np.random.default_rng(9).normal(size=(1, 8, 8, c)).astype(np.float32)
    counts = (mdta.mdta_stats.launches, block.block_tail.launches,
              seam.seam.launches)
    v, stats = port_stats(x, tw, heads)
    v0, stats0 = mdta.mdta_stats_plain(
        torch.from_numpy(x), tw["ln1w"], tw["ln1b"], tw["wqkv"], tw["wdwa"],
        heads)
    assert torch.equal(v, v0) and torch.equal(stats, stats0)
    attn = mdta.attn_from_stats(stats, tw["temp"])
    out = port_tail(v, x, attn, tw)
    out0 = block.block_tail_plain(
        v, torch.from_numpy(x), attn, tw["wproj"], tw["ln2w"], tw["ln2b"],
        tw["w1"], tw["wdwf"], tw["w2"])
    assert torch.equal(out, out0)
    y = torch.randn(1, 2, 2, 4 * c)
    assert torch.equal(seam.seam(y, torch.randn(1, 4, 4, c))[..., :c],
                       seam.seam_plain(y, torch.zeros(1, 4, 4, c))[..., :c])
    assert counts == (mdta.mdta_stats.launches, block.block_tail.launches,
                      seam.seam.launches)


def test_kernel_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 4"):
        mdta.mdta_stats(torch.zeros(1, 4, 4, 6), torch.ones(6), torch.zeros(6),
                        torch.zeros(18, 6), torch.zeros(18, 9), 1)
    with pytest.raises(ValueError, match="do not fit"):
        seam.seam(torch.zeros(1, 2, 2, 8), torch.zeros(1, 4, 5, 2))


def served_stats_shapes():
    """(B, H, W, C, heads) of every mdta_stats launch of the four paths:
    both served models at B4 256x256 and 256x192, PromptIR's training forward
    at B6 128x128 and its tile forward at B8 128x128."""
    def promptir(b, h, w):
        return [(b, h // s, w // s, c, heads) for s, c, heads in [
            (1, 48, 1), (2, 96, 2), (4, 192, 4), (8, 384, 8), (8, 704, 4),
            (4, 320, 4), (2, 160, 4), (1, 96, 1)]]

    def xr(b, h, w):
        return [(b, h // s, w // s, c, 1) for s, c in [
            (1, 48), (2, 96), (4, 192), (8, 384), (8, 704), (4, 320), (2, 160),
            (1, 96)]]

    return (promptir(4, 256, 256) + promptir(4, 256, 192) + xr(4, 256, 256)
            + xr(4, 256, 192) + promptir(6, 128, 128) + promptir(8, 128, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_tile_fits_every_served_width(dtype):
    """Every (C, heads) that the forwards of promptir and of the training
    config of promptxrestormerir give mdta_stats, and every width that
    reaches ln_gdfn, fits one block's shared memory with the tile the
    wrappers pick (one-head widths reach d = 704 at prompt3), at every shape
    of the four paths. The route splits where stats_route says: narrow while
    all heads' d x d sums and norms fit STATS_SUMS_BUDGET (d = 48 up to
    C = 384, 96 at C = 96, 40 at C = 160), wide otherwise (d = 80 at
    C = 320, 176 at C = 704, every one-head width from 160)."""
    from promptir_tpu_torch import create_model
    from promptir_tpu_torch.ops.attention import MDTA
    from promptir_tpu_torch.ops.cuda.gdfn import ln_gdfn_smem
    from promptir_tpu_torch.ops.gdfn import GDFN

    models = [
        create_model("promptir", device="cpu"),
        create_model("promptxrestormerir", device="cpu", num_blocks=(2, 4, 4, 4),
                     num_refinement_blocks=4, channel_heads=(1, 1, 1, 1),
                     spatial_heads=(1, 2, 4, 8)),
    ]
    stats, ffn = set(), set()
    for m in models:
        for mod in m.modules():
            if isinstance(mod, MDTA):
                stats.add((mod.qkv.weight.shape[1], mod.num_heads))
            elif isinstance(mod, GDFN):
                ffn.add(mod.project_out.weight.shape[0])
    assert (704, 1) in stats and (704, 4) in stats and 704 in ffn
    assert stats == {(c, heads) for _, _, _, c, heads in served_stats_shapes()}
    narrow = {(48, 1), (96, 2), (192, 4), (384, 8), (96, 1), (160, 4)}
    for c, heads in sorted(stats):
        d = c // heads
        assert mdta.stats_route(c, heads) == (
            "narrow" if (c, heads) in narrow else "wide"), (c, heads)
        fits = heads * (d * d + 2 * d) * 4 <= mdta.STATS_SUMS_BUDGET
        assert fits == ((c, heads) in narrow)
        smem = mdta.stats_smem(c, heads, dtype)
        assert smem <= mdta.SMEM_LIMIT, (c, heads, smem)
    for b, h, w, c, heads in served_stats_shapes():
        plan = mdta.stats_plan(b, h, w, c, heads, dtype)
        th, tw = plan.tile
        assert plan.tile in mdta.STATS_TILES
        assert plan.smem == mdta.stats_smem(c, heads, dtype, plan.tile)
        assert plan.smem <= mdta.SMEM_LIMIT
        tiles = -(-h // th) * -(-w // tw)
        assert 1 <= plan.nslots <= tiles and b * plan.nslots <= mdta.NUM_SMS
        assert (plan.slices > 0) == (plan.route == "wide")
    for c in sorted(ffn):
        assert ln_gdfn_smem(c) <= mdta.SMEM_LIMIT, c
    # the largest tile that fits: 14 x 14 at the d = 48 level 1; at the
    # one-head d = 704, 4 x 6 in float32 (its pi x 2d fp32 q and k stay in
    # the block) and 6 x 6 in bf16 (q and k leave it)
    assert mdta.stats_tile(48, 1, dtype) == (14, 14)
    assert mdta.stats_tile(704, 1, dtype) == (
        (6, 6) if dtype == torch.bfloat16 else (4, 6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads", [(48, 2), (320, 4)])
def test_stats_pass_and_gram_compose_to_mdta_stats(c, heads, dtype):
    """The wide route's two kernels' plain versions, the stats pass (v, q
    and k in x's dtype, the fp32 norms) then the Gram of q and k, give
    mdta_stats_plain bit for bit, on a non-square batch-2 input at a narrow
    and a wide width."""
    w = torch_weights(block_weights(c, heads, seed=c + 1))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 6, 10, c)).astype(np.float32)).to(dtype)
    args = [w[k].to(dtype) for k in ("ln1w", "ln1b", "wqkv", "wdwa")]
    v, q, k, norms = mdta.stats_pass_plain(x, *args, heads)
    assert q.dtype == k.dtype == v.dtype == dtype and q.shape == x.shape
    gram = mdta.mdta_gram_plain(q, k, heads)
    d = c // heads
    v0, stats0 = mdta.mdta_stats_plain(x, *args, heads)
    assert torch.equal(v, v0)
    assert torch.equal(torch.cat([gram.reshape(2, heads, d * d), norms], -1),
                       stats0)
    assert mdta.stats_route(c, heads) == ("wide" if c == 320 else "narrow")
    launches = mdta.mdta_gram.launches
    assert torch.equal(mdta.mdta_gram(q, k, heads), gram)  # the CPU path
    assert mdta.mdta_gram.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,heads", [(4, 256, 256, 48, 1),
                                           (2, 20, 30, 96, 2),
                                           (4, 32, 32, 704, 4),
                                           (4, 64, 64, 192, 1)])
def test_stats_wrapper_launches_by_the_plan(monkeypatch, b, h, w, c, heads,
                                            dtype):
    """With storage-less tensors and a recording library, mdta_stats passes
    the stats kernel the route, tile, slots and shared memory of
    stats_plan, and on the wide route launches the Gram kernel with its
    slices (bf16: gram_plan's tiles, slices, span and clusters, one launch
    and no slot sum); each launch counts once."""
    from promptir_tpu_torch.ops.cuda import build

    calls = []
    monkeypatch.setattr(build, "on_card_of", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_of", lambda t: 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)

    def function(name, argtypes, restype=None):
        if name == "mdta_stats_smem":
            return lambda dt, th, tw, cc, hh, wide: mdta.stats_smem(
                cc, hh, dtype, (th, tw))

        def call(*args):  # ctypes refuses a call that misses an argtype
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            calls.append((name, args))
            return 0

        return call

    monkeypatch.setattr(build, "function", function)

    def z(*s):
        return torch.zeros(*s, device="meta", dtype=dtype)

    x = z(b, h, w, c)
    before = (mdta.mdta_stats.launches, mdta.mdta_gram.launches)
    v, stats = mdta.mdta_stats(x, z(c), z(c), z(3 * c, c), z(3 * c, 9), heads)
    plan = mdta.stats_plan(b, h, w, c, heads, dtype)
    wide = plan.route == "wide"
    d = c // heads
    gram_fn = ("mdta_gram_tc_launch" if dtype == torch.bfloat16
               else "mdta_gram_launch")
    assert [n for n, _ in calls] == ["mdta_stats_launch"] + [gram_fn] * wide
    args = calls[0][1]
    assert args[0] == (1 if dtype == torch.bfloat16 else 0)
    assert args[11:21] == (b, h, w, c, heads, *plan.tile, plan.nslots, 0,
                           int(wide))
    assert args[22] == plan.smem and args[23] == 9
    if wide:
        gram = calls[1][1]
        if dtype == torch.bfloat16:
            # q, k, stats, then one array: stats' row length, the shape and
            # gram_plan's split
            p = mdta.gram_plan(b, h, w, c, heads)
            assert p.slices == plan.slices
            assert list(gram[3]) == [d * d + 2 * d, b, h * w, c, heads, p.cols,
                                     p.slices, p.span, p.clusters,
                                     mdta.GRAM_SMEM] and gram[4] == 9
        else:
            assert gram[5:10] == (b, h * w, c, heads, plan.slices) and gram[-1] == 9
    assert (mdta.mdta_stats.launches, mdta.mdta_gram.launches) == (
        before[0] + 1, before[1] + wide)
    assert v.shape == x.shape and stats.shape == (b, heads, d * d + 2 * d)


def test_seam_kernel_path_takes_16_byte_pieces():
    """The seam kernel moves 16 bytes a copy: on a card tensor (here
    storage-less) a bf16 width that is not a multiple of 8 is refused
    before any launch."""
    y = torch.zeros(1, 2, 2, 16, device="meta", dtype=torch.bfloat16)
    skip = torch.zeros(1, 4, 4, 4, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        seam.seam(y, skip)
