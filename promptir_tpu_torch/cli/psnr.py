"""Offline PSNR/SSIM between a directory of restored images and one of
ground truth.

Counterpart of promptir_tpu/cli/psnr.py (reference
compute_baseline_psnr.py:1-46): pair the two listings by file stem (or,
when the stems differ but the counts agree, by sorted position, with a
warning), crop each ground truth to its restored image's size (it may be a
crop larger), and report the set's mean skimage-semantics PSNR/SSIM.
Images are read as PNG (utils/png.py). The metrics run on the card unless
--device cpu.

  python -m promptir_tpu_torch.cli.psnr --restored out/denoise_15 \
      --gt test/denoise/bsd68 [--json per_image.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="offline PSNR/SSIM recompute")
    p.add_argument("--restored", required=True, help="restored images dir")
    p.add_argument("--gt", required=True, help="ground-truth images dir")
    p.add_argument("--json", default=None, help="write per-image PSNR here")
    p.add_argument("--device", default="cuda",
                   help="where the metrics run: cuda (the default) or cpu")
    return p


def pair_names(restored_dir: str, gt_dir: str) -> list:
    """(restored name, ground-truth name) pairs of two directories."""
    from promptir_tpu_torch.data.datasets import IMAGE_EXTENSIONS

    def listing(d):
        return sorted(n for n in os.listdir(d)
                      if n.lower().endswith(IMAGE_EXTENSIONS))

    def stem(n):
        return n.rsplit(".", 1)[0]

    restored_names, gt_names = listing(restored_dir), listing(gt_dir)
    if not restored_names:
        raise SystemExit(f"no images in {restored_dir}")
    gt_by_stem = {stem(n): n for n in gt_names}
    if all(stem(n) in gt_by_stem for n in restored_names):
        return [(n, gt_by_stem[stem(n)]) for n in restored_names]
    if len(restored_names) != len(gt_names):
        raise SystemExit(
            f"cannot pair: {len(restored_names)} restored vs {len(gt_names)} "
            f"GT images and stems don't match ({restored_dir} vs {gt_dir})")
    print("warning: filenames differ between dirs; pairing by sorted "
          "position (reference compute_baseline_psnr.py semantics)",
          file=sys.stderr)
    return list(zip(restored_names, gt_names))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from promptir_tpu_torch.data.datasets import load_image_rgb
    from promptir_tpu_torch.eval.metrics import AverageMeter, psnr_ssim

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    psnr_m, ssim_m = AverageMeter(), AverageMeter()
    per_image = {}
    for rn, gn in pair_names(args.restored, args.gt):
        restored = load_image_rgb(os.path.join(args.restored, rn))
        clean = load_image_rgb(os.path.join(args.gt, gn))
        h, w = restored.shape[:2]
        clean = clean[:h, :w]  # the GT may be a crop larger

        def t(a):
            return torch.from_numpy(a[None]).to(device).float() / 255.0

        p, s = psnr_ssim(t(clean), t(restored))
        per_image[rn.rsplit(".", 1)[0]] = float(p[0])
        psnr_m.update(float(p[0]), 1)
        ssim_m.update(float(s[0]), 1)

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(per_image, f, indent=1)
    print(f"PSNR: {psnr_m.avg:.2f}, SSIM: {ssim_m.avg:.4f}")
    return {"psnr": psnr_m.avg, "ssim": ssim_m.avg, "n": psnr_m.count}


if __name__ == "__main__":
    main()
