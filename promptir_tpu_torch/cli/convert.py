"""Checkpoint conversion: a PyTorch or Lightning checkpoint -> the flat
`.npz` parameter file of the JAX package.

Counterpart of promptir_tpu/cli/convert.py, with its arguments: the
checkpoint (`.ckpt/.pt/.pth`, read by compat/torch_ckpt.py, the Lightning
or DataParallel prefix stripped), the output path, `--model`,
`--num_blocks` and `--skip_check`. Unless `--skip_check`, every key and
shape is checked against the port's model first, and a mismatch raises
listing the missing, unexpected and mis-shaped keys. The file written is
the one the JAX CLI writes from the same checkpoint, array for array
(compat/jax_params.py: flax_from_state_dict, save_params_npz), so both
packages' `load_params_npz` read it.

    python -m promptir_tpu_torch.cli.convert ckpt/model.ckpt model.npz
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="torch ckpt -> npz converter")
    p.add_argument("input", help=".ckpt/.pt/.pth file")
    p.add_argument("output", help="output .npz path")
    p.add_argument("--model", default="promptir")
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--skip_check", action="store_true")
    args = p.parse_args(argv)

    import torch

    from promptir_tpu_torch.compat.jax_params import (
        flax_from_state_dict,
        save_params_npz,
    )
    from promptir_tpu_torch.compat.torch_ckpt import load_torch_state_dict
    from promptir_tpu_torch.models import create_model

    sd = load_torch_state_dict(args.input)
    print(f"loaded {len(sd)} tensors from {args.input}")
    model = None
    if not args.skip_check:
        kw = {}
        if args.num_blocks is not None:
            kw["num_blocks"] = tuple(args.num_blocks)
        with torch.device("meta"):  # keys and shapes only: no weights made
            model = create_model(args.model, device="meta", **kw)
    params = flax_from_state_dict(sd, model)
    if model is not None:
        print("all param paths and shapes match the model")
    save_params_npz(args.output, params)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
