"""The port's metrics and flip pad against the JAX package's.

  * psnr, ssim and psnr_ssim on random float32 batches (B2, 41x37, clipped
    noise): PSNR within rtol 1e-5, SSIM within 1e-6;
  * gaussian_ssim within 2e-5 of the reference's own value
    (tests/goldens/gaussian_ssim.npz; the bound of the JAX test,
    tests/test_utils.py) and within 1e-6 of JAX's;
  * AverageMeter and Timer as tests/test_eval.py checks them;
  * pad_to_multiple_flip bit-exact against JAX's, on tensors and arrays.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.eval import metrics as jmetrics
from promptir_tpu.eval import padding as jpad
from promptir_tpu_torch.eval import metrics, padding

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def pair(seed, shape=(2, 41, 37, 3)):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(size=shape).astype(np.float32)
    noisy = clean + rng.normal(0, 0.1, shape).astype(np.float32)
    return clean, np.clip(noisy, 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_match_jax(seed):
    clean, noisy = pair(seed)
    c, r = torch.from_numpy(clean), torch.from_numpy(noisy)
    jc, jr = jnp.asarray(clean), jnp.asarray(noisy)
    np.testing.assert_allclose(metrics.psnr(c, r).numpy(),
                               np.asarray(jmetrics.psnr(jc, jr)), rtol=1e-5)
    np.testing.assert_allclose(metrics.psnr(c, r, data_range=2.0).numpy(),
                               np.asarray(jmetrics.psnr(jc, jr, 2.0)), rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(c, r).numpy(),
                               np.asarray(jmetrics.ssim(jc, jr)), rtol=0, atol=1e-6)
    # unclipped inputs: psnr_ssim clips both first
    r_wide = torch.from_numpy(noisy * 1.3 - 0.1)
    p, s = metrics.psnr_ssim(c, r_wide)
    jp, js = jmetrics.psnr_ssim(jc, jnp.asarray(noisy * 1.3 - 0.1))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    mine = metrics.compute_psnr_ssim(noisy, clean)
    ref = jmetrics.compute_psnr_ssim(noisy, clean)
    assert mine[2] == ref[2] == 2
    assert mine[0] == pytest.approx(ref[0], rel=1e-5)
    assert mine[1] == pytest.approx(ref[1], abs=1e-6)


def test_gaussian_ssim_matches_the_reference_and_jax():
    d = np.load(GOLDEN_DIR / "gaussian_ssim.npz")
    a = d["a"].transpose(0, 2, 3, 1)
    b = d["b"].transpose(0, 2, 3, 1)
    val = metrics.gaussian_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert float(val.mean()) == pytest.approx(float(d["val"]), abs=2e-5)
    ref = np.asarray(jmetrics.gaussian_ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(val.numpy(), ref, rtol=0, atol=1e-6)


def test_average_meter():
    m = metrics.AverageMeter()
    m.update(1.0, 2)
    m.update(4.0, 1)
    assert m.avg == pytest.approx(2.0)
    assert m.count == 3 and m.val == 4.0


def test_timer_hold_release():
    t = metrics.Timer()
    t.tic()
    assert t.toc() >= 0.0
    t.hold()
    t.tic()
    t.hold()
    assert t.release() >= 0.0
    assert t.release() == 0.0  # release clears the accumulator
    t.hold()
    t.reset()
    assert t.acc == 0.0


@pytest.mark.parametrize("hw,base", [((32, 48), 64), ((40, 56), 16),
                                     ((321, 481), 64), ((64, 64), 64),
                                     ((13, 30), 8), ((9, 70), (16, 8))])
def test_flip_pad_matches_jax_bit_exact(hw, base):
    x = np.random.default_rng(3).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jpad.pad_to_multiple_flip(jnp.asarray(x), base))
    np.testing.assert_array_equal(padding.pad_to_multiple_flip(x, base), ref)
    np.testing.assert_array_equal(
        padding.pad_to_multiple_flip(torch.from_numpy(x), base).numpy(), ref)


@pytest.mark.parametrize("hw,base", [((32, 48), 64), ((5, 3), 16), ((1, 4), 8)])
def test_reflect_pad_longer_than_the_side_matches_jax(hw, base):
    """A pad longer than the image reflects again, as jnp.pad does (the
    tiler's bucket pad of an image smaller than the bucket)."""
    x = np.random.default_rng(4).normal(size=(1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jpad.pad_to_multiple_reflect(jnp.asarray(x), base))
    np.testing.assert_array_equal(
        padding.pad_to_multiple_reflect(torch.from_numpy(x), base).numpy(), ref)
    np.testing.assert_array_equal(padding.pad_to_multiple_reflect(x, base), ref)
