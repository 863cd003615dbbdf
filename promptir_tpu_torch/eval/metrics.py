"""PSNR and SSIM with scikit-image semantics, on the tensors' device.

Counterpart of promptir_tpu/eval/metrics.py (reference
utils/val_utils.py:50-66, which clips both images to [0, 1] and calls
skimage's `peak_signal_noise_ratio(data_range=1)` and
`structural_similarity(data_range=1, channel_axis=2)`). Inputs are NHWC;
everything is computed in float32, per batch element:
  * PSNR = 10 log10(data_range^2 / mse), the mse over pixels and channels;
  * SSIM per channel with a 7x7 uniform window over the VALID positions
    (skimage crops (win - 1) / 2 border pixels), unbiased (co)variances
    (cov_norm = 49 / 48), C1 = (0.01 L)^2, C2 = (0.03 L)^2, the mean over
    positions and channels;
  * `gaussian_ssim`, the reference's standalone torch SSIM
    (utils/pytorch_ssim/__init__.py:45-78): an 11x11 gaussian window,
    SAME zero padding, depthwise, the mean over everything.
These are plain PyTorch (`F.avg_pool2d`, a depthwise `F.conv2d` with TF32
off): no TPU kernel computes them. `AverageMeter` and `Timer` are the reference's
(val_utils.py:8-26, 76-97). `compute_niqe` scores NIQE on the host
through eval/niqe.py, as the JAX package's does.
"""

from __future__ import annotations

import os
import time

import torch
import torch.nn.functional as F

from promptir_tpu_torch.precision import exact_float32


def psnr(clean: torch.Tensor, restored: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """skimage-compatible PSNR of each batch element (B,) of NHWC inputs;
    the caller clips, as metrics.py:psnr expects."""
    err = (clean.float() - restored.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10((data_range * data_range) / err)


def ssim(clean: torch.Tensor, restored: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """skimage-compatible multichannel SSIM of each batch element (B,) of
    NHWC inputs."""
    x = clean.float().permute(0, 3, 1, 2)
    y = restored.float().permute(0, 3, 1, 2)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)

    def mean(t):
        return F.avg_pool2d(t, win_size, stride=1)

    ux, uy = mean(x), mean(y)
    uxx, uyy, uxy = mean(x * x), mean(y * y), mean(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


def psnr_ssim(clean: torch.Tensor, restored: torch.Tensor):
    """Clip both to [0, 1], then (PSNR, SSIM) per batch element."""
    c = clean.float().clamp(0.0, 1.0)
    r = restored.float().clamp(0.0, 1.0)
    return psnr(c, r), ssim(c, r)


def compute_psnr_ssim(restored, clean):
    """Reference-shaped helper: (mean PSNR, mean SSIM, batch size) of NHWC
    arrays or tensors."""
    p, s = psnr_ssim(torch.as_tensor(clean), torch.as_tensor(restored))
    return float(p.mean()), float(s.mean()), int(p.shape[0])


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = torch.exp(-(torch.arange(size, dtype=torch.float32) - size // 2)
                  .square() / (2.0 * sigma * sigma))
    g = g / g.sum()
    return torch.outer(g, g)


def gaussian_ssim(img1: torch.Tensor, img2: torch.Tensor,
                  window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian-window SSIM (B,) of NHWC inputs in [0, 1]."""
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    w = _gaussian_window(window_size, sigma).to(x.device)
    w = w.expand(c, 1, window_size, window_size)

    def filt(t):
        return F.conv2d(t, w, padding=window_size // 2, groups=c)

    with exact_float32(torch.float32):  # cuDNN would convolve in TF32
        mu1, mu2 = filt(x), filt(y)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = filt(x * x) - mu1_sq
        s2 = filt(y * y) - mu2_sq
        s12 = filt(x * y) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


def compute_niqe(image, model=None) -> float:
    """NIQE (reference utils/val_utils.py:69-74 via skvideo) of an HxW or
    HxWx3 image in [0, 1].

    Runs the published algorithm (eval/niqe.py, a copy of
    promptir_tpu/eval/niqe.py) against the pristine model at
    `PROMPTIR_NIQE_MODEL`, else the package's `niqe_model.npz`, unless
    `model` is given. When neither file exists and skvideo is installed,
    its bundled parameters are used, for score parity with the
    reference."""
    import numpy as np

    from promptir_tpu_torch.eval import niqe as _niqe

    arr = np.clip(np.asarray(image), 0, 1)
    if model is None and not os.path.exists(_niqe._default_model_path()):
        try:
            from skvideo.measure import niqe as sk_niqe  # type: ignore

            return float(sk_niqe(arr).mean())
        except ImportError:
            pass  # fall through to our implementation's error message
    return _niqe.niqe(arr, model=model)


class Timer:
    """Accumulating wall-clock timer: `tic` marks a start, `toc` reads the
    elapsed span, `hold` accumulates it, `release` returns and clears the
    accumulator."""

    def __init__(self):
        self.acc = 0.0
        self.tic()

    def tic(self):
        self.t0 = time.perf_counter()

    def toc(self) -> float:
        return time.perf_counter() - self.t0

    def hold(self):
        self.acc += self.toc()

    def release(self) -> float:
        ret = self.acc
        self.acc = 0.0
        return ret

    def reset(self):
        self.acc = 0.0


class AverageMeter:
    """Running average tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
