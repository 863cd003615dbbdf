"""The LN+MDTA apply path and the autograd Functions against the JAX package.

On the CPU every kernel wrapper runs its plain version, so these tests hold
the arithmetic that csrc/ln_mdta.cu reproduces (chip_smoke.py compares the
two on the card), and the gradients of the training path:
  * `ln_mdta` (stats, softmax, apply) against the Pallas `fused_ln_mdta` in
    interpret mode and against the unfused `xla_ln_mdta`, float32, 3e-4:
    the JAX test's own bound for the kernel (test_pallas_kernels.py:204; the
    Pallas stats pass rounds q and k to bf16);
  * the `LnMdta`, `LnGdfn` and `Seam` gradients of every input and weight
    against `jax.grad` of `xla_ln_mdta`, `xla_ln_gdfn` and `_xla_seam`,
    5e-4, the bound of test_pallas_kernels.py:265's gradient test;
  * the route a block takes: stats -> tail without autograd, LnMdta ->
    LnGdfn when autograd records, the same output either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.ops.pallas import mdta as jmdta
from promptir_tpu.ops.pallas.autodiff import xla_ln_gdfn, xla_ln_mdta
from promptir_tpu.ops.pallas.seam import _xla_seam
from promptir_tpu_torch.models import blocks
from promptir_tpu_torch.ops import autodiff
from promptir_tpu_torch.ops.cuda import mdta, seam

HEADS_BY_C = [(c, h) for c in (48, 64, 160) for h in (1, 2, 4)]


def mdta_weights(c, heads, seed):
    """numpy weights in the JAX kernels' layout."""
    rng = np.random.default_rng(seed)

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    return dict(lnw=1 + n(c, sc=0.1), lnb=n(c, sc=0.1),
                wqkv=n(c, 3 * c, sc=c ** -0.5), wdw=n(3, 3, 3 * c, sc=0.3),
                wproj=n(c, c, sc=c ** -0.5),
                temp=np.float32(1) + n(heads, sc=0.2))


def gdfn_weights(c, seed):
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    return dict(lnw=1 + n(c, sc=0.1), lnb=n(c, sc=0.1),
                w1=n(c, 2 * f, sc=c ** -0.5), wdw=n(3, 3, 2 * f, sc=0.3),
                w2=n(f, c, sc=f ** -0.5))


def t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def torch_mdta(w, grad=False):
    """The same weights in the port's (torch conv) layout."""
    return [t(w["lnw"], grad), t(w["lnb"], grad), t(w["wqkv"].T, grad),
            t(w["wdw"].reshape(9, -1).T, grad), t(w["wproj"].T, grad),
            t(w["temp"].reshape(-1, 1, 1), grad)]


def torch_gdfn(w, grad=False):
    return [t(w["lnw"], grad), t(w["lnb"], grad), t(w["w1"].T, grad),
            t(w["wdw"].reshape(9, -1).T, grad), t(w["w2"].T, grad)]


def jax_layout_mdta(g):
    """Gradients of the port's weights in the JAX layout."""
    lnw, lnb, wqkv, wdw, wproj, temp = (a.numpy() for a in g)
    return [lnw, lnb, wqkv.T, wdw.T.reshape(3, 3, -1), wproj.T, temp.reshape(-1)]


def jax_layout_gdfn(g):
    lnw, lnb, w1, wdw, w2 = (a.numpy() for a in g)
    return [lnw, lnb, w1.T, wdw.T.reshape(3, 3, -1), w2.T]


@pytest.mark.parametrize("c,heads", HEADS_BY_C)
def test_ln_mdta_matches_pallas(c, heads):
    w = mdta_weights(c, heads, seed=c + heads)
    x = np.random.default_rng(1).normal(size=(2, 8, 16, c)).astype(np.float32)
    ref = jmdta.fused_ln_mdta(
        jnp.asarray(x), w["lnw"], w["lnb"], w["wqkv"], w["wdw"], w["wproj"],
        jnp.asarray(w["temp"]), heads, interpret=True)
    assert ref is not None
    out = mdta.ln_mdta(t(x), *torch_mdta(w), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("c,heads", HEADS_BY_C)
def test_ln_mdta_matches_unfused_jax(c, heads):
    """A non-square size that is no multiple of 8."""
    w = mdta_weights(c, heads, seed=2 * c + heads)
    x = np.random.default_rng(2).normal(size=(2, 9, 13, c)).astype(np.float32)
    ref = xla_ln_mdta(jnp.asarray(x), w["lnw"], w["lnb"], w["wqkv"], w["wdw"],
                      w["wproj"], jnp.asarray(w["temp"]), heads)
    out = mdta.ln_mdta(t(x), *torch_mdta(w), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4,
                               atol=3e-4)


def test_ln_mdta_cpu_path_is_the_plain_composition():
    """On the CPU ln_mdta is mdta_stats_plain -> softmax -> mdta_apply_plain
    and counts no launch; the apply step equals the first two steps of the
    block tail's plain version."""
    c, heads = 48, 2
    w = mdta_weights(c, heads, seed=3)
    tw = torch_mdta(w)
    x = t(np.random.default_rng(4).normal(size=(1, 8, 8, c)).astype(np.float32))
    before = (mdta.ln_mdta.launches, mdta.mdta_stats.launches)
    v, stats = mdta.mdta_stats_plain(x, tw[0], tw[1], tw[2], tw[3], heads)
    attn = mdta.attn_from_stats(stats, tw[5])
    ref = mdta.mdta_apply_plain(v, x, attn, tw[4])
    assert torch.equal(mdta.ln_mdta(x, *tw, heads), ref)
    assert torch.equal(mdta.mdta_apply(v, x, attn, tw[4]), ref)
    assert (mdta.ln_mdta.launches, mdta.mdta_stats.launches) == before == (0, 0)


def test_apply_smem_fits_every_served_width():
    """Every width that the served and trained models give the apply kernel
    fits one block's shared memory."""
    for c in (48, 96, 160, 192, 320, 384, 704):
        assert mdta.ln_mdta_smem(c) <= mdta.SMEM_LIMIT, c
    assert mdta.apply_mp(256) == 4 and mdta.apply_mp(320) == 2


def test_stats_buffer_does_not_grow_with_the_image():
    """mdta_stats' scratch: one slot of d^2 + 2d fp32 (narrow) or 2d (wide)
    a stats block and head, about one block an SM over the batch, plus the
    wide float32 route's Gram slices (d^2 fp32 each, at most
    GRAM_MAX_SLICES; the bf16 Gram sums its slices in shared memory). The
    partial-Gram buffer with one slot a tile was 381 MB at one head, d = 704
    and a 256 px input; the wide route now writes q and k (each x's size)
    and keeps a few d^2 slices instead. Neither buffer grows with the image:
    the same bytes at 256 and 4096 px."""
    d = 704
    per_slice = 4 * d * d
    # one head, d = 704, B4 256 px (32 x 32 at the latent): 33 slots of 2d
    # norms; one Gram slice an image, in float32 through device memory, in
    # bf16 a block's own (its partial tiles never leave shared memory)
    for dtype, slices, gram_bytes in ((torch.float32, 1, per_slice),
                                      (torch.bfloat16, 1, 0)):
        plan = mdta.stats_plan(4, 32, 32, 704, 1, dtype)
        assert plan.route == "wide" and plan.nslots == 33
        assert plan.slices == slices
        assert mdta.stats_partial_bytes(4, 32, 32, 704, 1, dtype) == (
            4 * (33 * 4 * 2 * d + gram_bytes))
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, heads in [(1, 48, 1), (4, 96, 2), (6, 384, 8), (4, 704, 4),
                            (8, 160, 1), (4, 704, 1)]:
            small, big = (mdta.stats_partial_bytes(b, n, n, c, heads, dtype)
                          for n in (256, 4096))
            plan = mdta.stats_plan(b, 4096, 4096, c, heads, dtype)
            dh = c // heads
            sld = dh * dh + 2 * dh if plan.route == "narrow" else 2 * dh
            assert small == big, (b, c, heads, dtype)
            assert b * plan.nslots <= mdta.NUM_SMS
            assert plan.slices <= mdta.GRAM_MAX_SLICES
            slices = plan.slices if dtype == torch.float32 else 0
            assert big == 4 * b * heads * (plan.nslots * sld
                                           + slices * dh * dh)
    # a block's running sums fit its budget on the narrow route: the slot
    # buffer is at most NUM_SMS of them
    assert mdta.stats_partial_bytes(1, 4096, 4096, 384, 8) <= (
        mdta.NUM_SMS * mdta.STATS_SUMS_BUDGET)


@pytest.mark.parametrize("c,heads,bias_free", [(48, 1, False), (64, 2, True)])
def test_ln_mdta_grads_match_jax(c, heads, bias_free):
    """Every input and weight, the temperature and (WithBias) the LN bias
    included."""
    w = mdta_weights(c, heads, seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 12, c)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    names = ["lnw", "lnb", "wqkv", "wdw", "wproj", "temp"]
    keep = [i for i, k in enumerate(names) if not (bias_free and k == "lnb")]

    def loss(x_, *ws):
        full = dict(zip([names[i] for i in keep], ws))
        out = xla_ln_mdta(x_, full["lnw"], full.get("lnb"), full["wqkv"],
                          full["wdw"], full["wproj"], full["temp"], heads,
                          bias_free=bias_free)
        return jnp.sum(out * g)

    jargs = [jnp.asarray(x)] + [jnp.asarray(w[names[i]]) for i in keep]
    ref = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)

    xt = t(x, True)
    ws = torch_mdta(w, True)
    if bias_free:
        ws[1] = None
    out = autodiff.LnMdta.apply(xt, *ws, heads, bias_free, 1e-5)
    (out * t(g)).sum().backward()
    grads = [torch.zeros(c) if p is None else p.grad for p in ws]
    got = [xt.grad.numpy()] + [jax_layout_mdta(grads)[i] for i in keep]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("c,hw", [(48, (8, 12)), (44, (9, 13))])
def test_ln_gdfn_grads_match_jax(c, hw):
    w = gdfn_weights(c, seed=c)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, *hw, c)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(xla_ln_gdfn(*a) * g)

    jargs = [jnp.asarray(x)] + [jnp.asarray(w[k]) for k in
                                ("lnw", "lnb", "w1", "wdw", "w2")]
    ref = jax.grad(loss, argnums=tuple(range(6)))(*jargs)
    xt = t(x, True)
    ws = torch_gdfn(w, True)
    out = autodiff.LnGdfn.apply(xt, *ws, False, 1e-5)
    (out * t(g)).sum().backward()
    got = [xt.grad.numpy()] + jax_layout_gdfn([p.grad for p in ws])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=5e-4)


def test_seam_grads_match_jax():
    """`_xla_seam` takes the JAX kernel's layout: ij-major channels in, a
    padded skip and a padded output; the gradients are compared on the real
    entries."""
    b, hc, wc, c = 2, 3, 5, 8
    rng = np.random.default_rng(8)
    y = rng.normal(size=(b, hc, wc, 4 * c)).astype(np.float32)
    skip = rng.normal(size=(b, 2 * hc, 2 * wc, c)).astype(np.float32)
    g = rng.normal(size=(b, 2 * hc, 2 * wc, 2 * c)).astype(np.float32)
    wp, cp = 2 * wc + 2, 2 * c
    y_ij = y.reshape(b, hc, wc, c, 4).transpose(0, 1, 2, 4, 3).reshape(y.shape)
    skip_p = np.zeros((b, 2 * hc, wp, cp), np.float32)
    skip_p[:, :, 1:1 + 2 * wc, :c] = skip
    g_p = np.zeros((b, 2 * hc, wp, cp), np.float32)
    g_p[:, :, 1:1 + 2 * wc] = g

    def loss(a, s):
        return jnp.sum(_xla_seam(a, s, c, wp, cp) * g_p)

    gy, gs = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y_ij),
                                            jnp.asarray(skip_p))
    gy = np.asarray(gy).reshape(b, hc, wc, 4, c).transpose(0, 1, 2, 4, 3)
    yt, st = t(y, True), t(skip, True)
    out = autodiff.Seam.apply(yt, st)
    assert torch.equal(out, seam.seam_plain(yt, st))
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(yt.grad.numpy(), gy.reshape(y.shape), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(st.grad.numpy(),
                               np.asarray(gs)[:, :, 1:1 + 2 * wc, :c],
                               rtol=5e-4, atol=5e-4)


def test_bf16_activations_give_fp32_weight_grads():
    """x in bfloat16 with float32 weights: the forward casts them, the
    gradients return in float32 (the JAX model's param_dtype)."""
    c, heads = 48, 2
    ws = torch_mdta(mdta_weights(c, heads, seed=9), True)
    x = t(np.random.default_rng(10).normal(size=(1, 8, 8, c)).astype(np.float32))
    x = x.bfloat16().requires_grad_(True)
    out = autodiff.LnMdta.apply(x, *ws, heads, False, 1e-5)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in ws)


def test_block_route_follows_autograd(monkeypatch):
    """Without autograd a block runs stats -> tail; when autograd records it
    runs LnMdta -> LnGdfn (the per-branch route). Both give the block's
    output: the float32 forwards agree to rounding."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("mdta_stats", "block_tail"):
        monkeypatch.setattr(blocks, name, spy(name, getattr(blocks, name)))
    for cls in (autodiff.LnMdta, autodiff.LnGdfn):
        monkeypatch.setattr(blocks, cls.__name__, type(
            cls.__name__, (), {"apply": staticmethod(spy(cls.__name__, cls.apply))}))
    torch.manual_seed(0)
    blk = blocks.TransformerBlock(48, 2)
    x = torch.randn(2, 48, 8, 12).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y0 = blk(x)
    assert calls == ["mdta_stats", "block_tail"]
    y1 = blk(x)
    assert calls[2:] == ["LnMdta", "LnGdfn"]
    assert y1.requires_grad and not y0.requires_grad
    np.testing.assert_allclose(y1.detach().numpy(), y0.numpy(), rtol=1e-5,
                               atol=1e-5)
