"""Evaluation loops: the reference's `test_Denoise` / `test_Derain_Dehaze`.

Counterpart of promptir_tpu/eval/runner.py (reference test.py:84-164): per
image, flip-pad to a multiple of `pad_base`, forward, crop back, clip,
PSNR/SSIM into AverageMeters, and optional PNG dumps of the restored
images. The model is the port's NCHW module; images cross its boundary as
NHWC, as in the engine. The forward and the metrics run on the model's
device under `torch.inference_mode`, a float32 model with TF32 off
(precision.py), so that float32 PSNR on the card is not TF32's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from promptir_tpu_torch.eval.metrics import AverageMeter, Timer, psnr_ssim
from promptir_tpu_torch.eval.padding import pad_to_multiple_flip
from promptir_tpu_torch.eval.tiling import forward_nhwc
from promptir_tpu_torch.precision import compute_dtype, exact_float32
from promptir_tpu_torch.utils.image_io import save_image


def _restore_padded(model, degraded: torch.Tensor, pad_base) -> torch.Tensor:
    _, h, w, _ = degraded.shape
    y = forward_nhwc(model, pad_to_multiple_flip(degraded, pad_base))
    return y[:, :h, :w, :].clamp(0.0, 1.0)


def _loop(model, dataset, restore, output_dir: Optional[str]) -> dict:
    """Restore every sample of `dataset`. Returns the means, the count,
    each image's (PSNR, SSIM) under "images", and the loop's wall seconds
    (first image loaded to last metric read, PNG dumps included)."""
    device = next(model.parameters()).device
    psnr_m, ssim_m = AverageMeter(), AverageMeter()
    images = {}
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    timer = Timer()
    with torch.inference_mode(), exact_float32(compute_dtype(model)):
        for i in range(len(dataset)):
            name, degraded, clean = dataset.get(i)
            restored = restore(torch.from_numpy(degraded[None]).to(device))
            p, s = psnr_ssim(torch.from_numpy(clean[None]).to(device), restored)
            images[name] = (float(p[0]), float(s[0]))
            psnr_m.update(images[name][0], 1)
            ssim_m.update(images[name][1], 1)
            if output_dir:
                save_image(os.path.join(output_dir, f"{name}.png"),
                           restored[0].cpu().numpy())
    return {"psnr": psnr_m.avg, "ssim": ssim_m.avg, "n": psnr_m.count,
            "images": images, "seconds": timer.toc()}


def run_eval(model, dataset, output_dir: Optional[str] = None,
             pad_base=64) -> dict:
    """Evaluate `model` over a test dataset with the flip pad.

    Returns {"psnr": mean, "ssim": mean, "n": count, "images": {name:
    (psnr, ssim)}, "seconds": the loop's wall time}.
    """
    return _loop(model, dataset,
                 lambda x: _restore_padded(model, x, pad_base), output_dir)


def run_eval_nopad(model, dataset, json_path: Optional[str] = None,
                   output_dir: Optional[str] = None) -> dict:
    """Forward at the native (crop-16) size and dump each image's PSNR as
    JSON: the reference's test_promptir.py flavor (:64-86, 114-123).
    Returns run_eval's dict and "per_image": {name: psnr}, what the JSON
    holds."""
    r = _loop(model, dataset,
              lambda x: forward_nhwc(model, x).clamp(0.0, 1.0), output_dir)
    r["per_image"] = {k: p for k, (p, _) in r["images"].items()}
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(r["per_image"], f, indent=1)
    return r


def test_denoise(model, dataset, sigma: float, output_dir=None,
                 pad_base=64) -> dict:
    """The reference's `test_Denoise(opt, net, dataset, sigma)`
    (test.py:84-117)."""
    dataset.set_sigma(sigma)
    out = None if output_dir is None else os.path.join(
        output_dir, f"denoise_{int(sigma)}")
    r = run_eval(model, dataset, out, pad_base)
    print(f"Denoise sigma={int(sigma)}: psnr: {r['psnr']:.2f}, "
          f"ssim: {r['ssim']:.4f}")
    return r


def test_derain_dehaze(model, dataset, task: str = "derain", output_dir=None,
                       pad_base=64) -> dict:
    """The reference's `test_Derain_Dehaze` (test.py:121-164)."""
    dataset.set_dataset(task)
    out = None if output_dir is None else os.path.join(output_dir, task)
    r = run_eval(model, dataset, out, pad_base)
    print(f"{task}: psnr: {r['psnr']:.2f}, ssim: {r['ssim']:.4f}")
    return r


def make_epoch_eval_hook(denoise_path: Optional[str] = None,
                         derain_path: Optional[str] = None,
                         sigma: float = 15.0, pad_base=64):
    """Epoch-end evaluation for `Trainer(eval_hook=...)`: the reference's
    `EvaluationCallback.on_train_epoch_end` (train.py:134-172), BSD68
    sigma-15 and Rain100L PSNR/SSIM logged every epoch. Returns
    `hook(eval_step, model) -> metrics`, the trainer's signature
    (train/trainer.py); the hook runs `model` itself. Pass either path as
    None to skip that set."""
    from promptir_tpu_torch.data.datasets import (
        DenoiseTestDataset,
        DerainDehazeDataset,
    )

    denoise_ds = (DenoiseTestDataset(denoise_path, sigma=sigma)
                  if denoise_path else None)
    derain_ds = (DerainDehazeDataset(derain_path=derain_path)
                 if derain_path else None)

    def hook(eval_step, model) -> dict:
        metrics = {}
        if denoise_ds is not None:
            r = test_denoise(model, denoise_ds, sigma, pad_base=pad_base)
            metrics[f"eval_psnr_denoise{int(sigma)}"] = r["psnr"]
            metrics[f"eval_ssim_denoise{int(sigma)}"] = r["ssim"]
        if derain_ds is not None:
            r = test_derain_dehaze(model, derain_ds, "derain",
                                   pad_base=pad_base)
            metrics["eval_psnr_derain"] = r["psnr"]
            metrics["eval_ssim_derain"] = r["ssim"]
        return metrics

    return hook
