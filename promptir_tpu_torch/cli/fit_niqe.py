"""Fit the NIQE pristine natural-scene-statistics model from clean images.

Counterpart of promptir_tpu/cli/fit_niqe.py. The reference scores NIQE
through skvideo, whose fitted pristine model is not redistributable
(utils/val_utils.py:69-74). This CLI fits the same multivariate-Gaussian
model (Mittal et al. 2013, §IV) on any directory of clean images, read
through the port's image reader (PNG, JPEG, BMP), and saves it where
`compute_niqe` finds it:

  python -m promptir_tpu_torch.cli.fit_niqe data/Train/Denoise --out niqe_model.npz

It runs on the host; there is no `--device`.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="fit NIQE pristine model")
    p.add_argument("clean_dir", help="directory of pristine images")
    p.add_argument("--out", default=None,
                   help="output .npz (default: the package's model path)")
    p.add_argument("--block", type=int, default=96)
    p.add_argument("--max_images", type=int, default=200)
    args = p.parse_args(argv)

    import numpy as np

    from promptir_tpu_torch.data.datasets import IMAGE_EXTENSIONS, load_image_rgb
    from promptir_tpu_torch.eval.niqe import (
        _default_model_path,
        fit_niqe_model,
        save_niqe_model,
    )

    names = sorted(
        n for n in os.listdir(args.clean_dir)
        if n.lower().endswith(IMAGE_EXTENSIONS)
    )[: args.max_images]
    if not names:
        raise SystemExit(f"no images in {args.clean_dir}")

    used = []

    def grays():
        for n in names:
            rgb = load_image_rgb(os.path.join(args.clean_dir, n)).astype(
                np.float64
            )
            g = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                 + 0.114 * rgb[..., 2])
            if min(g.shape) >= args.block:
                used.append(n)
                yield g

    try:
        model = fit_niqe_model(grays(), block=args.block)
    except ValueError as e:
        raise SystemExit(
            f"no usable images: every image must be at least "
            f"{args.block}x{args.block} (--block); "
            f"{len(names)} candidates in {args.clean_dir} ({e})"
        )
    out = args.out or _default_model_path()
    save_niqe_model(out, model)
    skipped = len(names) - len(used)
    note = f" ({skipped} skipped as smaller than {args.block}px)" if skipped else ""
    print(f"fitted NIQE model on {len(used)} images{note} -> {out}")


if __name__ == "__main__":
    main()
