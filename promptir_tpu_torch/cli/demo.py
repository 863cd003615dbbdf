"""Demo CLI: inference at any resolution on a file or a directory.

Counterpart of promptir_tpu/cli/demo.py (reference demo.py:79-127):
--test_path (file or directory), --output_path, and --tile/--tile_size/
--tile_overlap/--tile_chunk. The plain path reflect-pads each image to the
model's pad bases (eval/padding.py:pad_bases; the reference pads to 8,
which covers only the window-free models: PromptIR, EasyPromptXRestormer,
NAFNet and NAFNetLocal), forwards, crops and clips; the
tiled path blends overlapping tiles (eval/tiling.py). Images are read and
written as PNG (utils/png.py). The JAX demo's --mesh and --spatial wait
for the port's parallelism (ROADMAP.md). Runs on the card unless --device
cpu.

  python -m promptir_tpu_torch.cli.demo --test_path photo.png \
      --output_path output/demo/ --ckpt_name model.ckpt --tile
"""

from __future__ import annotations

import argparse
import os

from promptir_tpu_torch.cli.test import add_model_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="promptir_tpu_torch demo inference")
    p.add_argument("--test_path", required=True)
    p.add_argument("--output_path", default="output/demo/")
    p.add_argument("--tile", action="store_true")
    p.add_argument("--tile_size", type=int, default=128)
    p.add_argument("--tile_overlap", type=int, default=32)
    p.add_argument("--tile_chunk", type=int, default=8)
    add_model_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from promptir_tpu_torch.cli.test import build_model
    from promptir_tpu_torch.data.datasets import TestSpecificDataset
    from promptir_tpu_torch.eval.padding import pad_bases, pad_to_multiple_reflect
    from promptir_tpu_torch.eval.tiling import forward_nhwc, tiled_inference
    from promptir_tpu_torch.precision import compute_dtype, exact_float32
    from promptir_tpu_torch.utils.image_io import save_image

    model = build_model(args)
    device = next(model.parameters()).device
    os.makedirs(args.output_path, exist_ok=True)
    ds = TestSpecificDataset(args.test_path)
    for i in range(len(ds)):
        name, img = ds.get(i)
        x = torch.from_numpy(img[None]).to(device)
        h, w = img.shape[:2]
        with torch.inference_mode(), exact_float32(compute_dtype(model)):
            if args.tile:
                y = tiled_inference(model, x, tile=args.tile_size,
                                    overlap=args.tile_overlap,
                                    chunk=args.tile_chunk)
            else:
                xp = pad_to_multiple_reflect(x, pad_bases(args.model))
                y = forward_nhwc(model, xp)[:, :h, :w].clamp(0.0, 1.0)
        out = os.path.join(args.output_path, f"{name}.png")
        save_image(out, y[0].cpu().numpy())
        print(f"{name}: {w}x{h} -> {out}")


if __name__ == "__main__":
    main()
