"""Demo CLI: inference at any resolution on a file or a directory.

Counterpart of promptir_tpu/cli/demo.py (reference demo.py:79-127):
--test_path (file or directory), --output_path, and --tile/--tile_size/
--tile_overlap/--tile_chunk. The plain path reflect-pads each image to the
model's pad bases (eval/padding.py:pad_bases; the reference pads to 8,
which covers only the window-free models: PromptIR, EasyPromptXRestormer,
NAFNet and NAFNetLocal), forwards, crops and clips; the
tiled path blends overlapping tiles (eval/tiling.py). Images are read and
written as PNG (utils/png.py). Runs on the card unless --device cpu.

The JAX demo's multi-device modes (cli/demo.py:33-40, 74-170) run over
`--n_data` ranks (parallel/mesh.py:launch; default every visible card, one
on the CPU), each rank reading every image and rank 0 writing it:
  * `--tile --mesh` shards each chunk of tiles over the ranks
    (eval/tiling.py, `group`);
  * `--spatial` pads each image to `pad_bases(model, n)` and runs the exact
    H-sharded forward (parallel/spatial.py:spatial_sharded_apply) of any
    registered model. It excludes `--tile` and `--fused`, with the JAX
    messages.

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
    p.add_argument("--mesh", action="store_true",
                   help="with --tile: shard the tile batch over the ranks")
    p.add_argument("--spatial", action="store_true",
                   help="shard each image's H axis over the ranks with exact "
                        "in-model collectives (parallel/spatial.py)")
    p.add_argument("--n_data", type=int, default=None,
                   help="ranks of --mesh / --spatial (default: every "
                        "visible card; one on the CPU)")
    add_model_args(p)
    return p


def check_args(args) -> None:
    """Exit non-zero on the flag combinations the demo does not run."""
    if args.tile and args.spatial:
        raise SystemExit(
            "--tile and --spatial are mutually exclusive: tiled "
            "overlap-blending is approximate at seams, --spatial is the "
            "exact multi-card path (use --tile --mesh for sharded tiling)")
    if args.mesh and not args.tile:
        raise SystemExit("--mesh shards the tile batch: add --tile")
    if args.spatial and args.fused:
        raise SystemExit("--spatial needs the unfused op path (drop --fused): "
                         "the kernels are single-card")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_args(args)
    if args.mesh or args.spatial:
        from promptir_tpu_torch.parallel.mesh import data_size, launch

        launch(restore_all, data_size(args.n_data, args.device),
               args.device, args=(args,))
    else:
        restore_all(args)


def restore_all(args) -> None:
    """Restore every image of --test_path: in this process, or as one rank
    of --mesh / --spatial (rank 0 writes the images)."""
    import torch

    from promptir_tpu_torch.cli.test import build_model
    from promptir_tpu_torch.data.datasets import TestSpecificDataset
    from promptir_tpu_torch.eval.padding import pad_bases, pad_to_multiple_reflect
    from promptir_tpu_torch.eval.tiling import forward_nhwc, tiled_inference
    from promptir_tpu_torch.parallel.mesh import create_mesh
    from promptir_tpu_torch.parallel.spatial import spatial_sharded_apply
    from promptir_tpu_torch.precision import compute_dtype, exact_float32
    from promptir_tpu_torch.utils.image_io import save_image

    mesh = create_mesh(device=args.device)
    group = mesh.data_group
    model = build_model(args)
    device = next(model.parameters()).device
    if mesh.rank == 0:
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
                                    chunk=args.tile_chunk, group=group)
            elif args.spatial:
                xp = pad_to_multiple_reflect(x, pad_bases(args.model,
                                                          mesh.n_data))
                y = spatial_sharded_apply(model, xp, group)
                y = y[:, :h, :w].clamp(0.0, 1.0)
            else:
                xp = pad_to_multiple_reflect(x, pad_bases(args.model))
                y = forward_nhwc(model, xp)[:, :h, :w].clamp(0.0, 1.0)
        if mesh.rank == 0:
            out = os.path.join(args.output_path, f"{name}.png")
            save_image(out, y[0].cpu().numpy())
            print(f"{name}: {w}x{h} -> {out}")


if __name__ == "__main__":
    main()
