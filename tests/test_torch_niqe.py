"""The port's NIQE, fit_niqe and imresize against the JAX package's.

  * the NIQE block features, the scores against the package's pristine
    model and `compute_niqe` (the model at PROMPTIR_NIQE_MODEL too), all
    within 1e-12 of their max of JAX's on the same PNG files, each package
    reading them with its own reader (the port's utils/png.py, PIL);
  * the port's `niqe_model.npz` byte for byte the JAX package's;
  * `cli.fit_niqe` on a directory of PNGs (one image too small, skipped):
    the fitted mean and covariance within 1e-12 of their max of JAX's CLI
    on the same directory, and the fitted model scores a clean image below
    its sigma = 50 copy (tests/test_eval.py:163);
  * `imresize` against the reference's golden outputs (tests/goldens/
    imresize.npz, 1e-9) and against JAX's function at odd sizes, both
    methods, with and without antialiasing, float and uint8, bit for bit.
"""

import os

import numpy as np
import pytest

from promptir_tpu.cli import fit_niqe as jax_fit_niqe
from promptir_tpu.data.datasets import load_image_rgb as jax_load_image_rgb
from promptir_tpu.eval import metrics as jmetrics
from promptir_tpu.eval import niqe as jniqe
from promptir_tpu.utils.imresize import imresize as jax_imresize
from promptir_tpu_torch.cli import fit_niqe
from promptir_tpu_torch.data.datasets import load_image_rgb
from promptir_tpu_torch.data.synthetic import synth_clean_image
from promptir_tpu_torch.eval import metrics, niqe
from promptir_tpu_torch.utils.imresize import imresize
from promptir_tpu_torch.utils.png import write_png

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "imresize.npz")


def gray(rgb):
    rgb = rgb.astype(np.float64)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Clean synthetic PNGs (sizes not multiples of the 96 px block, one
    smaller than a block) and a sigma = 50 noisy copy of a held-out one."""
    d = tmp_path_factory.mktemp("clean")
    for s, (h, w) in enumerate([(192, 192), (200, 230), (250, 196),
                                (96, 300), (80, 120)]):
        write_png(str(d / f"img{s}.png"), synth_clean_image(s, h, w))
    held = tmp_path_factory.mktemp("held")
    clean = synth_clean_image(99, 192, 224)
    noise = np.random.default_rng(1).normal(0, 50, clean.shape)
    write_png(str(held / "clean.png"), clean)
    write_png(str(held / "noisy.png"),
              np.clip(clean + noise, 0, 255).astype(np.uint8))
    return d, held


def test_niqe_model_is_a_byte_copy_of_jax():
    with open(niqe._default_model_path(), "rb") as a, \
            open(jniqe._default_model_path(), "rb") as b:
        data = a.read()
        assert data == b.read() and len(data) == 11152


def test_niqe_features_and_scores_match_jax(corpus):
    clean_dir, held = corpus
    for path in sorted(clean_dir.iterdir())[:3] + sorted(held.iterdir()):
        ours_rgb, ref_rgb = load_image_rgb(str(path)), jax_load_image_rgb(str(path))
        np.testing.assert_array_equal(ours_rgb, ref_rgb)
        f, sharp = niqe.niqe_features(gray(ours_rgb))
        f_ref, sharp_ref = jniqe.niqe_features(gray(ref_rgb))
        close(f, f_ref)
        close(sharp, sharp_ref)
        img = ours_rgb / 255.0
        close(niqe.niqe(img), jniqe.niqe(ref_rgb / 255.0))
        close(metrics.compute_niqe(img), jmetrics.compute_niqe(ref_rgb / 255.0))


def test_fit_niqe_cli_matches_jax_and_orders_noise(corpus, tmp_path, capsys,
                                                   monkeypatch):
    clean_dir, held = corpus
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    fit_niqe.main([str(clean_dir), "--out", ours])
    out = capsys.readouterr().out
    assert "fitted NIQE model on 4 images (1 skipped as smaller than 96px)" in out
    jax_fit_niqe.main([str(clean_dir), "--out", ref])
    model, model_ref = niqe.load_niqe_model(ours), jniqe.load_niqe_model(ref)
    close(model["mu"], model_ref["mu"])
    close(model["cov"], model_ref["cov"])

    clean = load_image_rgb(str(held / "clean.png")) / 255.0
    noisy = load_image_rgb(str(held / "noisy.png")) / 255.0
    s_clean, s_noisy = niqe.niqe(clean, model), niqe.niqe(noisy, model)
    assert np.isfinite(s_clean) and s_noisy > s_clean, (s_noisy, s_clean)
    # compute_niqe reads the fitted model through PROMPTIR_NIQE_MODEL
    monkeypatch.setenv("PROMPTIR_NIQE_MODEL", ours)
    assert metrics.compute_niqe(noisy) == s_noisy
    close(metrics.compute_niqe(clean), jmetrics.compute_niqe(clean))


def test_fit_niqe_cli_refuses_a_directory_without_usable_images(tmp_path):
    write_png(str(tmp_path / "small.png"), synth_clean_image(0, 64, 64))
    with pytest.raises(SystemExit, match="no usable images"):
        fit_niqe.main([str(tmp_path), "--out", str(tmp_path / "m.npz")])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images"):
        fit_niqe.main([str(empty)])


@pytest.mark.parametrize("scale", [0.5, 2.0, 1.3])
def test_imresize_matches_reference_golden(scale):
    d = np.load(GOLD)
    np.testing.assert_allclose(imresize(d["img"], scale=scale),
                               d[f"scale_{scale}"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
@pytest.mark.parametrize("antialias", [True, False])
def test_imresize_matches_jax_at_odd_sizes(method, antialias):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(37, 53, 3))
    img8 = (img * 255).astype(np.uint8)
    for kw in (dict(scale=0.37), dict(scale=1.7), dict(output_shape=(19, 41)),
               dict(output_shape=(73, 29))):
        for a in (img, img8, img[..., 0]):
            ours = imresize(a, method=method, antialias=antialias, **kw)
            ref = jax_imresize(a, method=method, antialias=antialias, **kw)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
