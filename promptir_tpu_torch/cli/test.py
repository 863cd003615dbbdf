"""Evaluation CLI: the reference's `python test.py --mode {0,1,2,3}`.

Counterpart of promptir_tpu/cli/test.py (reference test.py:167-259): mode
0 denoises (sigma 15, 25, 50), 1 derains, 2 dehazes, 3 runs all three (the
all-in-one evaluation); PSNR/SSIM per set, the restored PNGs saved under
--output_path. The weights come from a PyTorch or Lightning checkpoint
(`.ckpt`, `.pt`, `.pth`: compat/torch_ckpt.py), from the JAX package's
flat `.npz` (compat/jax_params.py:load_params_npz), or, with no
--ckpt_name, from `torch.manual_seed(--seed)` with a warning. Runs on the
card unless --device cpu (then every kernel runs its plain version).
--model takes every ported model: `promptir`, the X-Restormer family
(`xrestormerir`, `promptxrestormerir`, `promptxrestormereffir`) and the
attention-free family (`easypromptxrestormer`, `nafnet`, `nafnetlocal`).

  python -m promptir_tpu_torch.cli.test --mode 3 --ckpt_name model.ckpt \
      --denoise_path test/denoise/bsd68/ --derain_path test/derain/ \
      --dehaze_path test/dehaze/ --output_path output/
"""

from __future__ import annotations

import argparse
import os


def add_model_args(p: argparse.ArgumentParser, dtype: str = "float32") -> None:
    """The flags that choose and load the model, shared by the CLIs."""
    p.add_argument("--model", default="promptir")
    p.add_argument("--ckpt_name", default=None, help=".ckpt/.pt/.pth/.npz weights")
    p.add_argument("--dtype", default=dtype, choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--num_refinement_blocks", type=int, default=None)
    p.add_argument("--fused", action="store_true",
                   help="fused_ffn=True: promptir chains its level stacks "
                        "through the merged tail + stats kernel; the "
                        "X-Restormer family takes it and serves as without "
                        "it; other models refuse it")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu: the kernels' plain versions")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="promptir_tpu_torch evaluation")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--denoise_path", default="test/denoise/bsd68/")
    p.add_argument("--derain_path", default="test/derain/")
    p.add_argument("--dehaze_path", default="test/dehaze/")
    p.add_argument("--output_path", default="output/")
    p.add_argument("--pad_base", type=int, default=64)
    p.add_argument(
        "--nopad", action="store_true",
        help="forward at native size and dump per-image PSNR JSON "
             "(reference test_promptir.py flavor)",
    )
    p.add_argument("--json_dir", default=None)
    add_model_args(p)
    return p


def validation_shape(model_name: str) -> tuple:
    """The smallest NHWC input `model_name` can forward: one image at its
    pad bases (eval/padding.py:pad_bases)."""
    from promptir_tpu_torch.eval.padding import pad_bases

    base_h, base_w = pad_bases(model_name)
    return (1, base_h, base_w, 3)


def size_kwargs(num_blocks=None, num_refinement_blocks=None, dim=None) -> dict:
    """The model kwargs of the size flags (--num_blocks, --num_refinement_blocks,
    --dim; None where a flag is not given). A model without such sizes
    (NAFNet) refuses them when it is built, as in the JAX CLIs."""
    kw = {}
    if num_blocks is not None:
        kw["num_blocks"] = tuple(num_blocks)
    if num_refinement_blocks is not None:
        kw["num_refinement_blocks"] = num_refinement_blocks
    if dim is not None:
        kw["dim"] = dim
    return kw


def model_kwargs(args) -> dict:
    import torch

    kw = {"dtype": torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
          "device": args.device}
    kw.update(size_kwargs(args.num_blocks, args.num_refinement_blocks,
                          getattr(args, "dim", None)))
    if args.fused:  # create_model refuses it where the model has no such option
        kw["fused_ffn"] = True
    return kw


def load_params(model, ckpt_name):
    """Load `ckpt_name` into `model` (strict); with None, keep its random
    weights and warn."""
    if ckpt_name is None:
        print("WARNING: no checkpoint given; using random init")
        return model
    if ckpt_name.endswith(".npz"):
        from promptir_tpu_torch.compat.jax_params import (
            load_params_npz,
            state_dict_from_flax,
        )

        sd = state_dict_from_flax(load_params_npz(ckpt_name), model)
        model.load_state_dict(sd, strict=True)
        return model
    from promptir_tpu_torch.compat.torch_ckpt import load_checkpoint

    return load_checkpoint(model, ckpt_name)


def build_model(args, **extra):
    """The model of the CLI's flags, its weights loaded, in eval mode."""
    import numpy as np
    import torch

    from promptir_tpu_torch.models import create_model

    np.random.seed(args.seed)  # the reference seeds np/torch (test.py:183-184)
    torch.manual_seed(args.seed)
    model = create_model(args.model, **model_kwargs(args), **extra)
    return load_params(model, args.ckpt_name)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from promptir_tpu_torch.data.datasets import (
        DenoiseTestDataset,
        DerainDehazeDataset,
    )
    from promptir_tpu_torch.eval import runner

    model = build_model(args)
    results = {}
    if args.mode in (0, 3):
        ds = DenoiseTestDataset(args.denoise_path)
        for sigma in (15, 25, 50):
            if args.nopad:
                ds.set_sigma(sigma)
                jp = (f"{args.json_dir or args.output_path}/"
                      f"psnr_denoise_{sigma}.json")
                r = runner.run_eval_nopad(
                    model, ds, jp,
                    os.path.join(args.output_path, f"denoise_{sigma}"))
                print(f"Denoise sigma={sigma}: psnr: {r['psnr']:.2f}, "
                      f"ssim: {r['ssim']:.4f}")
            else:
                r = runner.test_denoise(model, ds, sigma, args.output_path,
                                        args.pad_base)
            results[f"denoise_{sigma}"] = r
    for mode, task in ((1, "derain"), (2, "dehaze")):
        if args.mode in (mode, 3):
            ds = DerainDehazeDataset(derain_path=args.derain_path,
                                     dehaze_path=args.dehaze_path, task=task)
            results[task] = runner.test_derain_dehaze(
                model, ds, task, args.output_path, args.pad_base)
    return results


if __name__ == "__main__":
    main()
