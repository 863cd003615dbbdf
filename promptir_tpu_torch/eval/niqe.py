"""NIQE: the Natural Image Quality Evaluator (no-reference metric).

A numpy copy of promptir_tpu/eval/niqe.py, Mittal, Soundararajan & Bovik,
"Making a 'Completely Blind' Image Quality Analyzer" (IEEE SPL 2013): the
metric the reference computes through skvideo (utils/val_utils.py:69-74).
skvideo's pristine multivariate-Gaussian model, fitted on a private corpus
of 125 images, cannot be redistributed, so this module holds the algorithm
and `fit_niqe_model`, which fits the pristine model on any directory of
clean images (`python -m promptir_tpu_torch.cli.fit_niqe`), or reads an
exported parameter set through `load_niqe_model`. The package's own
`niqe_model.npz` is a byte copy of the JAX package's. Scores compare within
one fitted model, which is how NIQE is meant to be used. It runs on the
host: no TPU kernel computes it.

Pipeline per the paper:
  1. MSCN coefficients: (I - mu) / (sigma + 1) with a 7x7 Gaussian window.
  2. Per 96x96 block, at two scales: GGD fit of the MSCN histogram
     (2 features) + AGGD fits of the 4 orientation pairwise products
     (4x4 features) -> 18 features/scale, 36 total.
  3. Pristine model: (mean, covariance) of block features over sharp
     blocks of clean images.
  4. Score: sqrt( (nu_p - nu_t)^T ((S_p + S_t)/2)^-1 (nu_p - nu_t) ).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

# precomputed gamma-ratio lookup used by the GGD/AGGD moment-matching fits
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.array(
    [
        (math.gamma(2.0 / g) ** 2) / (math.gamma(1.0 / g) * math.gamma(3.0 / g))
        for g in _GAM
    ]
)


def _gaussian_window(n: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = (n - 1) / 2.0
    x = np.arange(-half, half + 1)
    w = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(w, w)
    return k / k.sum()


def _filter2_same(im: np.ndarray, k: np.ndarray) -> np.ndarray:
    """2-D correlation, 'same' size, replicate border (MATLAB imfilter)."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(im, ((ph, ph), (pw, pw)), mode="edge")
    # im2col via stride tricks: views are (H, W, kh, kw)
    s = padded.strides
    shape = (im.shape[0], im.shape[1], kh, kw)
    windows = np.lib.stride_tricks.as_strided(
        padded, shape=shape, strides=(s[0], s[1], s[0], s[1]),
        writeable=False,
    )
    return np.einsum("hwij,ij->hw", windows, k, optimize=True)


def mscn(im_gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """MSCN coefficients and the local-deviation (sharpness) field."""
    k = _gaussian_window()
    im = im_gray.astype(np.float64)
    mu = _filter2_same(im, k)
    sigma = np.sqrt(np.abs(_filter2_same(im * im, k) - mu * mu))
    return (im - mu) / (sigma + 1.0), sigma


def _ggd_fit(vec: np.ndarray) -> Tuple[float, float]:
    """Moment-matching generalized-Gaussian fit -> (alpha, sigma^2)."""
    sigma_sq = float(np.mean(vec**2))
    e_abs = float(np.mean(np.abs(vec)))
    # degenerate (constant) blocks have zero moments; clamp rho so the
    # table lookup stays defined (alpha is arbitrary there — sigma^2 = 0
    # carries the information)
    rho = max(sigma_sq / (e_abs**2 + 1e-12), 1e-12)
    alpha = _GAM[np.argmin(np.abs(_R_GAM - 1.0 / rho))]
    return float(alpha), sigma_sq


def _aggd_fit(vec: np.ndarray) -> Tuple[float, float, float, float]:
    """Asymmetric GGD fit -> (alpha, mean, left sigma^2, right sigma^2)."""
    left = vec[vec < 0]
    right = vec[vec >= 0]
    l_std = math.sqrt(float(np.mean(left**2))) if left.size else 1e-6
    r_std = math.sqrt(float(np.mean(right**2))) if right.size else 1e-6
    gamma_hat = l_std / (r_std + 1e-12)
    e_abs = float(np.mean(np.abs(vec)))
    rho = float(np.mean(vec**2)) / (e_abs**2 + 1e-12)
    rho_hat = max(
        rho * (gamma_hat**3 + 1.0) * (gamma_hat + 1.0)
        / ((gamma_hat**2 + 1.0) ** 2),
        1e-12,
    )
    alpha = _GAM[np.argmin(np.abs(_R_GAM - 1.0 / rho_hat))]
    const = math.sqrt(math.gamma(1.0 / alpha) / math.gamma(3.0 / alpha))
    mean = (
        (r_std - l_std)
        * (math.gamma(2.0 / alpha) / math.gamma(1.0 / alpha))
        * const
    )
    return float(alpha), float(mean), l_std**2, r_std**2


_SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))  # H, V, D1, D2


def _block_features(hat: np.ndarray) -> np.ndarray:
    feats = list(_ggd_fit(hat.ravel()))
    for di, dj in _SHIFTS:
        shifted = np.roll(np.roll(hat, di, axis=0), dj, axis=1)
        feats.extend(_aggd_fit((hat * shifted).ravel()))
    return np.asarray(feats)  # (18,)


def niqe_features(
    im_gray: np.ndarray, block: int = 96
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block 36-dim feature matrix and per-block sharpness.

    im_gray: HxW in [0, 255]. Image is cropped to whole blocks.
    """
    h, w = im_gray.shape
    nbh, nbw = h // block, w // block
    if nbh == 0 or nbw == 0:
        raise ValueError(f"image {im_gray.shape} smaller than {block}px block")
    im = im_gray[: nbh * block, : nbw * block].astype(np.float64)

    feats = []
    sharp = []
    for scale in (1, 2):
        hat, sigma = mscn(im)
        b = block // scale
        for bi in range(nbh):
            for bj in range(nbw):
                patch = hat[bi * b : (bi + 1) * b, bj * b : (bj + 1) * b]
                f = _block_features(patch)
                if scale == 1:
                    feats.append([f])
                    sharp.append(
                        sigma[bi * b : (bi + 1) * b, bj * b : (bj + 1) * b]
                        .mean()
                    )
                else:
                    feats[bi * nbw + bj].append(f)
        if scale == 1:
            # 2x downscale (local average), as in the paper
            im = 0.25 * (
                im[0::2, 0::2] + im[1::2, 0::2]
                + im[0::2, 1::2] + im[1::2, 1::2]
            )
    return (
        np.stack([np.concatenate(f) for f in feats]),  # (nblocks, 36)
        np.asarray(sharp),
    )


def fit_niqe_model(
    images, block: int = 96, sharpness_threshold: float = 0.75
) -> dict:
    """Fit the pristine MVG model over an iterable of HxW [0,255] arrays.

    Only blocks whose mean local deviation exceeds `sharpness_threshold`
    x the image's peak block sharpness contribute (paper §IV-A).
    """
    rows = []
    for im in images:
        f, sharp = niqe_features(im, block)
        keep = sharp > sharpness_threshold * sharp.max()
        rows.append(f[keep if keep.any() else slice(None)])
    feats = np.concatenate(rows, axis=0)
    if feats.shape[0] < 2:
        raise ValueError("need at least 2 pristine blocks to fit NIQE")
    return {
        "mu": feats.mean(axis=0),
        "cov": np.cov(feats, rowvar=False),
    }


def save_niqe_model(path: str, model: dict) -> None:
    np.savez(path, mu=model["mu"], cov=model["cov"])


def load_niqe_model(path: str) -> dict:
    z = np.load(path)
    return {"mu": z["mu"], "cov": z["cov"]}


def _default_model_path() -> str:
    return os.environ.get(
        "PROMPTIR_NIQE_MODEL",
        os.path.join(os.path.dirname(__file__), "niqe_model.npz"),
    )


def niqe(
    image: np.ndarray, model: Optional[dict] = None, block: int = 96
) -> float:
    """NIQE score (lower = more natural). image: HxW or HxWx3 in [0,1]."""
    if model is None:
        p = _default_model_path()
        if not os.path.exists(p):
            raise NotImplementedError(
                "NIQE needs a pristine model: fit one with fit_niqe_model / "
                "`python -m promptir_tpu_torch.cli.fit_niqe <clean_dir>` or point "
                "PROMPTIR_NIQE_MODEL at an exported parameter file"
            )
        model = load_niqe_model(p)
    arr = np.asarray(image, np.float64)
    if arr.ndim == 3:
        # ITU-R BT.601 luma, as in the reference's gray conversion
        arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    feats, _ = niqe_features(np.clip(arr, 0, 1) * 255.0, block)
    mu_t = feats.mean(axis=0)
    cov_t = (
        np.cov(feats, rowvar=False)
        if feats.shape[0] > 1
        else np.zeros((36, 36))
    )
    d = model["mu"] - mu_t
    s = (model["cov"] + cov_t) / 2.0
    return float(np.sqrt(d @ np.linalg.pinv(s) @ d))
