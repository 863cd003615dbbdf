"""The LN+GDFN kernel's plain version against the JAX package.

On the CPU `ln_gdfn` runs its plain version, which holds the arithmetic
that csrc/ln_gdfn.cu reproduces (chip_smoke.py compares the two on the
card):
  * against the Pallas `fused_ln_gdfn` in interpret mode (its rational erf
    and single-pass LN variance agree to ~1e-6), 5e-5;
  * against the unfused JAX composition `xla_ln_gdfn` (the same rounding
    points in float32) at widths that are not multiples of 8, 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.ops.pallas import gdfn as jgdfn
from promptir_tpu.ops.pallas.autodiff import xla_ln_gdfn
from promptir_tpu_torch.ops.cuda import gdfn


def gdfn_weights(c, seed):
    """numpy weights in the JAX kernels' layout."""
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    return dict(lnw=1 + n(c, sc=0.1), lnb=n(c, sc=0.1),
                w1=n(c, 2 * f, sc=c ** -0.5), wdw=n(3, 3, 2 * f, sc=0.3),
                w2=n(f, c, sc=f ** -0.5))


def port_ln_gdfn(x, w, bias_free=False, fn=gdfn.ln_gdfn):
    """The port's call on the same weights in torch's conv layout."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return fn(torch.from_numpy(x), t(w["lnw"]), t(w["lnb"]), t(w["w1"].T),
              t(w["wdw"].reshape(9, -1).T), t(w["w2"].T), bias_free=bias_free)


@pytest.mark.parametrize("bias_free", [False, True])
def test_ln_gdfn_matches_pallas(bias_free):
    c = 48
    w = gdfn_weights(c, seed=11)
    x = np.random.default_rng(12).normal(size=(2, 8, 16, c)).astype(np.float32)
    ref = jgdfn.fused_ln_gdfn(
        jnp.asarray(x), w["lnw"], None if bias_free else w["lnb"], w["w1"],
        w["wdw"], w["w2"], bias_free=bias_free, interpret=True)
    out = port_ln_gdfn(x, w, bias_free)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize("c,hw", [(44, (9, 13)), (96, (6, 10))])
def test_ln_gdfn_matches_unfused_jax(c, hw):
    w = gdfn_weights(c, seed=c)
    x = np.random.default_rng(13).normal(size=(2, *hw, c)).astype(np.float32)
    ref = xla_ln_gdfn(jnp.asarray(x), w["lnw"], w["lnb"], w["w1"], w["wdw"],
                      w["w2"])
    out = port_ln_gdfn(x, w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_cpu_tensor_takes_the_plain_version():
    w = gdfn_weights(48, seed=14)
    x = np.random.default_rng(15).normal(size=(1, 8, 8, 48)).astype(np.float32)
    before = gdfn.ln_gdfn.launches
    out = port_ln_gdfn(x, w)
    assert torch.equal(out, port_ln_gdfn(x, w, fn=gdfn.ln_gdfn_plain))
    assert gdfn.ln_gdfn.launches == before == 0


def test_ln_gdfn_bf16_stays_close_to_fp32():
    w = gdfn_weights(48, seed=16)
    x = np.random.default_rng(17).normal(size=(1, 8, 8, 48)).astype(np.float32)
    out32 = port_ln_gdfn(x, w)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()  # noqa: E731
    out16 = gdfn.ln_gdfn(t(x), t(w["lnw"]), t(w["lnb"]), t(w["w1"].T),
                         t(w["wdw"].reshape(9, -1).T), t(w["w2"].T))
    assert out16.dtype == torch.bfloat16
    assert (out16.float() - out32).abs().max().item() < 0.1


def test_ln_gdfn_rejects_bad_shapes_and_dtypes():
    c, f = 8, 21
    x = torch.zeros(1, 4, 4, c)
    lnw, lnb = torch.ones(c), torch.zeros(c)
    w1, wdw, w2 = torch.zeros(2 * f, c), torch.zeros(2 * f, 9), torch.zeros(c, f)
    assert gdfn.ln_gdfn(x, lnw, lnb, w1, wdw, w2).shape == x.shape
    with pytest.raises(ValueError, match="do not fit"):
        gdfn.ln_gdfn(x, lnw, lnb, torch.zeros(2 * f, c + 1), wdw, w2)
    with pytest.raises(ValueError, match="do not fit"):
        gdfn.ln_gdfn(x, lnw, lnb, w1, torch.zeros(2 * f, 8), w2)
    with pytest.raises(ValueError, match="do not fit"):
        gdfn.ln_gdfn(x, lnw, None, w1, wdw, w2)
    assert gdfn.ln_gdfn(x, lnw, None, w1, wdw, w2, bias_free=True).shape == x.shape
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        gdfn.ln_gdfn(x[0], lnw, lnb, w1, wdw, w2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gdfn.ln_gdfn(x.double(), lnw, lnb, w1, wdw, w2)
