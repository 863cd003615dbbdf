"""The bf16 route's rounding points, packed weights and tiles, on the CPU.

In bfloat16 the kernels multiply on the tensor cores from bf16 operands, so
the plain versions round where the kernels' operands are rounded, and where
the JAX package rounds:
  * attn enters the apply in the compute dtype (promptir_tpu/ops/
    attention.py:81): the plain apply and tail give the same output for attn
    and for attn rounded to bf16 first;
  * the port's channel attention in bf16 against the JAX package's on the
    same numpy inputs;
  * q and k enter the Gram rounded to bf16, their squared norms summed in
    fp32 (promptir_tpu/ops/pallas/mdta.py:113-124): mdta_stats and tail_stats
    in bf16 against the Pallas kernels in interpret mode, attn within one
    bf16 ulp of its largest value (the earlier float32 gate was 3e-4);
  * the packed copy of a GDFN's weights (ops/cuda/packed.py) computes the
    same feed-forward as the weights themselves, is made once for a model
    with float32 weights computing in bf16 served under inference mode, and
    anew on every call for inference tensors;
  * the bf16 tiles and shared-memory carvings fit one block at every width
    the served models give tail_stats and block_tail.
The models' global residual, summed in float32 as XLA computes it in the
JAX package's jitted bf16 forward, is held in tests/test_torch_precision.py,
beside the eager bf16 forwards it shares.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_kernels import block_diag, block_weights, torch_weights

from promptir_tpu.ops.attention import channel_attention as jax_channel_attention
from promptir_tpu.ops.pallas import mdta as jmdta
from promptir_tpu.ops.pallas.block import pad_nhwc, unpad_nhwc
from promptir_tpu.ops.pallas.megablock import fused_tail_stats_padded
from promptir_tpu_torch import create_model
from promptir_tpu_torch.ops.attention import channel_attention
from promptir_tpu_torch.ops.conv import dwconv3x3_nhwc
from promptir_tpu_torch.ops.cuda import block, gdfn, mdta, megablock, packed

BF16 = torch.bfloat16


def bf16_weights(c, heads, seed):
    """numpy weights rounded to bf16 (JAX layout) and the port's bf16 copy."""
    w = block_weights(c, heads, seed)
    wb = {k: v if k == "temp" else
          np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
          for k, v in w.items()}
    tw = {k: t if k == "temp" else t.to(BF16)
          for k, t in torch_weights(wb).items()}
    return wb, tw


def bf16_input(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(BF16)


def keep_launch_counts(monkeypatch):
    """Restore every wrapper's launch counter after a test whose recording
    library counts launches on the CPU (tests elsewhere read the counters)."""
    for fn in (mdta.mdta_stats, block.block_tail, gdfn.ln_gdfn, mdta.ln_mdta,
               megablock.tail_stats, mdta.mdta_gram):
        monkeypatch.setattr(fn, "launches", fn.launches)


def ulp(v):
    """One bf16 ulp at the magnitude of v."""
    return 2.0 ** (np.floor(np.log2(np.abs(v).max())) - 7)


@pytest.mark.parametrize("fn", ["mdta_apply_plain", "block_tail_plain"])
def test_attn_enters_the_apply_rounded(fn):
    c, heads = 48, 2
    _, tw = bf16_weights(c, heads, 11)
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(2, 6, 10, c, generator=gen).to(BF16)
    v = torch.randn(2, 6, 10, c, generator=gen).to(BF16)
    attn = torch.rand(2, heads, c // heads, c // heads, generator=gen)
    attn = attn / attn.sum(-1, keepdim=True)
    assert not torch.equal(attn, attn.to(BF16).float())
    if fn == "mdta_apply_plain":
        def run(a):
            return mdta.mdta_apply_plain(v, x, a, tw["wproj"])
    else:
        def run(a):
            return block.block_tail_plain(
                v, x, a, tw["wproj"], tw["ln2w"], tw["ln2b"], tw["w1"],
                tw["wdwf"], tw["w2"])
    assert torch.equal(run(attn), run(attn.to(BF16).float()))
    # float32 is unrounded
    x32, v32 = x.float(), v.float()
    out = mdta.mdta_apply_plain(v32, x32, attn, tw["wproj"].float())
    assert not torch.equal(out, mdta.mdta_apply_plain(
        v32, x32, attn.to(BF16).float(), tw["wproj"].float()))


def test_bf16_channel_attention_matches_jax():
    """ops/attention.py:channel_attention against the JAX package's in bf16:
    the port normalises q and k in fp32 where JAX rounds them to bf16, so
    the outputs agree within two bf16 ulps of their largest value."""
    b, h, w, c, heads = 2, 8, 12, 32, 2
    rng = np.random.default_rng(13)
    q, k, v = (jnp.asarray(rng.normal(size=(b, h, w, c)).astype(np.float32))
               .astype(jnp.bfloat16) for _ in range(3))
    temp = rng.uniform(0.5, 2.0, (heads,)).astype(np.float32)
    ref = np.asarray(jax_channel_attention(q, k, v, jnp.asarray(temp), heads)
                     .astype(jnp.float32))

    def t(a):  # NHWC bf16 -> the port's NCHW
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16) \
            .permute(0, 3, 1, 2)

    out = channel_attention(t(q), t(k), t(v), torch.from_numpy(temp)
                            .reshape(heads, 1, 1), heads)
    assert out.dtype == BF16
    out = out.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 * ulp(ref))


@pytest.mark.parametrize("c,heads,hw", [(48, 2, (8, 16)), (32, 1, (16, 8)),
                                        (160, 1, (8, 16))])
def test_bf16_stats_match_pallas(c, heads, hw):
    wb, tw = bf16_weights(c, heads, c)
    xb, xt = bf16_input((2, *hw, c), 1)
    v_j, attn_j = jmdta.mdta_stats(
        xb, *(jnp.asarray(wb[k]).astype(jnp.bfloat16)
              for k in ("ln1w", "ln1b", "wqkv", "wdwa")),
        jnp.asarray(wb["temp"]), heads, interpret=True)
    v, stats = mdta.mdta_stats(xt, tw["ln1w"], tw["ln1b"], tw["wqkv"],
                               tw["wdwa"], heads)
    assert v.dtype == BF16 and stats.dtype == torch.float32
    attn = mdta.attn_from_stats(stats, tw["temp"]).to(BF16).float().numpy()
    ref = np.asarray(attn_j.astype(jnp.float32))[:, :c, :c]
    vj = np.asarray(v_j.astype(jnp.float32))[..., :c]
    np.testing.assert_allclose(v.float().numpy(), vj, rtol=0, atol=ulp(vj))
    np.testing.assert_allclose(block_diag(attn, c), ref, rtol=0, atol=ulp(ref))


@pytest.mark.parametrize("shape,heads", [((2, 24, 16, 48), 2),
                                         ((2, 16, 24, 96), 1)])
def test_bf16_tail_stats_matches_pallas(shape, heads):
    b, h, w, c = shape
    wb, tw = bf16_weights(c, heads, 31)
    wb1, tw1 = bf16_weights(c, heads, 32)
    xb, xt = bf16_input(shape, 33)
    v, stats = mdta.mdta_stats(xt, tw["ln1w"], tw["ln1b"], tw["wqkv"],
                               tw["wdwa"], heads)
    attn = mdta.attn_from_stats(stats, tw["temp"])
    x3, v2, stats2 = megablock.tail_stats(
        v, xt, attn, tw["wproj"], tw["ln2w"], tw["ln2b"], tw["w1"],
        tw["wdwf"], tw["w2"], tw1["ln1w"], tw1["ln1b"], tw1["wqkv"],
        tw1["wdwa"], heads)
    attn2 = mdta.attn_from_stats(stats2, tw1["temp"]).to(BF16).float().numpy()

    cp = 128
    v_p = np.pad(v.float().numpy(), ((0, 0),) * 3 + ((0, cp - c),))
    attn_p = block_diag(attn.to(BF16).float().numpy(), cp)

    def j(a):
        return jnp.asarray(a).astype(jnp.bfloat16)

    x3_j, v2_j, (s_qk, ssq_q, ssq_k, qkp) = fused_tail_stats_padded(
        j(v_p), pad_nhwc(xb), j(attn_p), *(j(wb[k]) for k in (
            "wproj", "ln2w", "ln2b", "w1", "wdwf", "w2")),
        *(j(wb1[k]) for k in ("ln1w", "ln1b", "wqkv", "wdwa")),
        w=w, c=c, interpret=True)
    attn2_j = jmdta.attn_from_stats(s_qk, ssq_q, ssq_k, jnp.asarray(wb1["temp"]),
                                    c, cp, heads, qkp)
    ref_x3 = np.asarray(unpad_nhwc(x3_j, w, c).astype(jnp.float32))
    ref_v2 = np.asarray(v2_j.astype(jnp.float32))[..., :c]
    ref_a = np.asarray(attn2_j.astype(jnp.bfloat16).astype(jnp.float32))[:, :c, :c]
    np.testing.assert_allclose(x3.float().numpy(), ref_x3, rtol=0,
                               atol=2 * ulp(ref_x3))
    np.testing.assert_allclose(v2.float().numpy(), ref_v2, rtol=0,
                               atol=2 * ulp(ref_v2))
    np.testing.assert_allclose(block_diag(attn2, c), ref_a, rtol=0,
                               atol=ulp(ref_a))


def test_packed_weights_compute_the_gdfn():
    """The bf16 kernels' arithmetic on the packed copy (h in chunk order, Fp
    gate channels, zero padding) gives the feed-forward of the weights."""
    c = 48
    f = int(c * 2.66)  # 127: odd, padded to 128
    _, tw = bf16_weights(c, 1, 21)
    w1, wdw, w2 = (tw[k].reshape(tw[k].shape[0], -1) for k in ("w1", "wdwf", "w2"))
    w1p, wdwp, w2p = packed.gdfn_weights(w1, wdw, w2)
    fp = packed.packed_f(f)
    assert (fp, w1p.shape, wdwp.shape, w2p.shape) == (
        128, (2 * fp, c), (2 * fp, 9), (c, fp))
    y = torch.randn(2, 5, 7, c, generator=torch.Generator().manual_seed(22))
    y = y.to(BF16).float()

    def rt(t):
        return t.to(BF16).float()

    def gdfn_of(h, taps, w_out, n):
        g1, g2 = dwconv3x3_nhwc(h, taps).split(n, dim=-1)
        return rt(F.gelu(g1) * g2) @ w_out.float().t()

    ref = gdfn_of(rt(y @ w1.float().t()), wdw.float(), w2, f)
    hp = rt(y @ w1p.float().t())  # (..., 2Fp) chunk by chunk: [h1 of 32 | h2 of 32]
    halves = hp.unflatten(-1, (fp // 32, 2, 32)).transpose(-3, -2)
    taps = wdwp.unflatten(0, (fp // 32, 2, 32)).transpose(0, 1).reshape(2 * fp, 9)
    out = gdfn_of(halves.flatten(-3), taps, w2p, fp)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # made once, remade when a weight changes
    assert packed.gdfn_weights(w1, wdw, w2) is packed.gdfn_weights(w1, wdw, w2)
    before = packed.gdfn_weights(w1, wdw, w2)
    with torch.no_grad():
        w2.mul_(2)
    assert packed.gdfn_weights(w1, wdw, w2) is not before



def test_packed_weights_of_inference_tensors():
    """Weights made under torch.inference_mode have no version counter: they
    get the same packed copy as other tensors, made anew on every call."""
    _, tw = bf16_weights(48, 1, 21)
    ws = [tw[k].reshape(tw[k].shape[0], -1) for k in ("w1", "wdwf", "w2")]
    want = packed.gdfn_weights(*[w.clone() for w in ws])
    with torch.inference_mode():
        wi = [w.clone() for w in ws]
        got = packed.gdfn_weights(*wi)
        again = packed.gdfn_weights(*wi)
    assert all(t.is_inference() for t in wi)
    assert got is not again
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_cast_weight_is_made_once(mode):
    """A float32 weight's bf16 copy is made once, outside inference mode and
    autograd, and made again when the weight changes."""
    p = torch.nn.Parameter(torch.randn(6, 5, generator=torch.Generator()
                                       .manual_seed(23)))
    scope = torch.inference_mode if mode == "inference_mode" else torch.no_grad
    with scope():
        a = packed.cast_weight(p, BF16)
        b = packed.cast_weight(p, BF16)
    assert a is b and not a.is_inference() and not a.requires_grad
    assert torch.equal(a, p.detach().to(BF16))
    assert packed.cast_weight(p, torch.float32) is p
    assert packed.cast_weight(None, BF16) is None
    with torch.no_grad():
        p.mul_(2)
    with scope():
        c = packed.cast_weight(p, BF16)
    assert c is not a and torch.equal(c, p.detach().to(BF16))


def test_trained_bf16_model_serves_through_the_packed_weights(monkeypatch):
    """A promptir with float32 weights computing in bf16 (`train=True`),
    storage-less, served under torch.inference_mode and then under no_grad
    through a recording library: the served route's wrappers take the packed
    copy of every block's GDFN weights, made in the first forward only."""
    from promptir_tpu_torch.models.blocks import TransformerBlock
    from promptir_tpu_torch.ops.cuda import build

    keep_launch_counts(monkeypatch)
    log, packs = [], []
    monkeypatch.setattr(build, "on_card_of", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_of", lambda t: 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)
    real_pack = packed._pack
    monkeypatch.setattr(packed, "_pack", lambda *w: packs.append(1)
                        or real_pack(*w))

    def function(name, argtypes, restype=None):
        if name == "block_tail_smem":
            return lambda dtype, c: 0
        if name == "tail_stats_smem":
            return lambda dtype, th, tw, c, d: megablock._smem(
                c, c // d, (th, tw), BF16)
        if name == "mdta_stats_smem":
            return lambda dtype, th, tw, c, heads, wide: mdta.stats_smem(
                c, heads, BF16, (th, tw))
        return lambda *args: log.append(name) or 0

    monkeypatch.setattr(build, "function", function)
    model = create_model("promptir", device="meta", dtype=BF16, train=True,
                         num_blocks=(2, 2, 2, 2), num_refinement_blocks=2)
    model.eval()
    assert next(model.parameters()).dtype == torch.float32
    n_blocks = sum(isinstance(m, TransformerBlock) for m in model.modules())
    x = torch.zeros(1, 3, 64, 64, device="meta")
    for scope in (torch.inference_mode, torch.inference_mode, torch.no_grad):
        with scope():
            y = model(x)
        assert y.shape == (1, 3, 64, 64) and y.dtype == torch.float32
    assert len(packs) == n_blocks == 19
    # every block alone (the default route): 19 stats passes and tails a
    # forward, the bf16 Gram kernel at the two wide noise_level widths
    assert [log.count(n) for n in ("mdta_stats_launch", "block_tail_launch",
                                   "tail_stats_launch", "mdta_gram_tc_launch")] == [
        3 * 19, 3 * 19, 0, 3 * 2]

SOLO = [(48, 1), (96, 2), (192, 4), (384, 8), (96, 1), (704, 4), (320, 4),
        (160, 4), (704, 1), (384, 1), (320, 1), (192, 1), (160, 1)]


def test_bf16_tiles_fit_every_served_width():
    """Every chained width takes its TC_TILES tile, whose ring fills the W2
    product's rows, within one block's shared memory; every width that
    mdta_stats, block_tail, ln_gdfn and the apply run alone fits too (up to
    704)."""
    want = {(48, 1): (14, 14), (96, 2): (14, 14), (192, 4): (6, 14),
            (384, 8): (6, 6), (96, 1): (14, 14)}
    for (c, heads), tile in want.items():
        assert megablock.tail_stats_tile(c, heads, BF16) == tile
        th, tw = tile
        assert (th + 2) * (tw + 2) in (64, 128, 256)
        assert megablock.tail_stats_smem(c, heads, BF16) <= mdta.SMEM_LIMIT
    for c, heads in SOLO:
        tail_a, tail_b = block.tail_tc_smem(c)
        assert max(tail_a, tail_b, mdta.stats_smem(c, heads, BF16),
                   mdta.ln_mdta_smem(c, BF16),
                   gdfn.ln_gdfn_smem(c, BF16)) <= mdta.SMEM_LIMIT, (c, heads)
    with pytest.raises(ValueError, match="fits no tile"):
        megablock.tail_stats_tile(704, 4, BF16)


def test_bf16_wrappers_take_the_packed_weights(monkeypatch):
    """With storage-less bf16 tensors and a recording library: block_tail,
    tail_stats and ln_gdfn launch with the bf16 code and the packed copy of
    their GDFN weights, mdta_stats and the apply with the bf16 code; float32
    launches pack nothing."""
    from promptir_tpu_torch.ops.cuda import build

    keep_launch_counts(monkeypatch)
    log, packs = [], []
    monkeypatch.setattr(build, "on_card_of", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_of", lambda t: 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)
    real_pack = packed.gdfn_weights
    monkeypatch.setattr(packed, "gdfn_weights", lambda *w: packs.append(
        tuple(t.shape for t in w)) or real_pack(*w))

    def function(name, argtypes, restype=None):
        if name == "block_tail_smem":
            return lambda dtype, c: 0
        if name == "tail_stats_smem":
            return lambda dtype, th, tw, c, d: megablock._smem(
                c, c // d, (th, tw), BF16 if dtype == 1 else torch.float32)
        if name == "mdta_stats_smem":
            return lambda dtype, th, tw, c, heads, wide: mdta.stats_smem(
                c, heads, BF16 if dtype == 1 else torch.float32, (th, tw))
        return lambda *args: log.append((name, args[0])) or 0

    monkeypatch.setattr(build, "function", function)
    c, heads = 96, 2
    f, d = int(c * 2.66), c // heads
    for dt in (BF16, torch.float32):
        def z(*s):
            return torch.zeros(*s, device="meta", dtype=dt)

        x = z(2, 20, 30, c)
        attn = torch.zeros(2, heads, d, d, device="meta")
        mdta.mdta_stats(x, z(c), z(c), z(3 * c, c), z(3 * c, 9), heads)
        mdta.mdta_apply(x, x, attn, z(c, c))
        block.block_tail(x, x, attn, z(c, c), z(c), z(c), z(2 * f, c),
                         z(2 * f, 9), z(c, f))
        gdfn.ln_gdfn(x, z(c), z(c), z(2 * f, c), z(2 * f, 9), z(c, f))
        megablock.tail_stats(x, x, attn, z(c, c), z(c), z(c), z(2 * f, c),
                             z(2 * f, 9), z(c, f), z(c), z(c), z(3 * c, c),
                             z(3 * c, 9), heads)
    names = ["mdta_stats_launch", "ln_mdta_launch", "block_tail_launch",
             "ln_gdfn_launch", "tail_stats_launch"]
    assert log == [(n, 1) for n in names] + [(n, 0) for n in names]
    assert packs == [((2 * f, c), (2 * f, 9), (c, f))] * 3
