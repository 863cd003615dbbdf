"""Training CLI: the reference's `python train.py`, on the card.

Counterpart of promptir_tpu/cli/train.py, flag for flag (the reference's
options.py:1-39 and train.py:303-341): `--model`, `--de_type`, `--epochs`,
`--batch_size`, `--lr`, `--patch_size`, the corpus and checkpoint paths,
`--resume`, `--wblogger`, the epoch-end evaluation, `--profile_dir`,
`--synthetic`, the model-size overrides and the memory knobs `--fused`,
`--remat` and `--remat_levels`, plus `--device` (default `cuda`; `cpu`
runs the kernels' plain versions). Trains on the all-in-one
corpora in the reference's layout (data/datasets.py:PromptTrainDataset, on
its native path, as the JAX CLI does: the JAX CLI has no flag for it):

  python -m promptir_tpu_torch.cli.train --dtype bfloat16 \\
      --data_file_dir data_dir/ --denoise_dir data/Train/Denoise/ \\
      --derain_dir data/Train/Derain/ --dehaze_dir data/Train/Dehaze/

`--fused` trains every TransformerBlock as one LnBlock (mdta_stats and
block_tail forward, the whole block recomputed backward; the PromptIR and
X-Restormer families), `--remat` checkpoints PromptIR's blocks, and
`--remat_levels 1 2` only those of levels 1 and 2.

`--n_data N` trains data-parallel over N ranks (parallel/mesh.py:launch):
one a card over NCCL, or N gloo ranks on the CPU with `--device cpu`; the
default, every visible card (one process on the CPU). `--batch_size` is a
rank's, as the JAX CLI's ("per DP shard"), so the global batch is
batch_size * N. Every model trains over N ranks; a stochastic CAMixer
model's step over them is the one-process step on the global batch
(train/step.py, parallel/data.py).
"""

from __future__ import annotations

import argparse


def n_ranks(args) -> int:
    """The data-parallel ranks `--n_data` asks for (None: every visible
    card; one on the CPU)."""
    from promptir_tpu_torch.parallel.mesh import data_size

    return data_size(args.n_data, args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="promptir_tpu_torch trainer")
    p.add_argument("--model", default="promptir")
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument(
        "--de_type",
        nargs="+",
        default=["denoise_15", "denoise_25", "denoise_50", "derain", "dehaze"],
    )
    p.add_argument("--patch_size", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--data_file_dir", default="data_dir/")
    p.add_argument("--denoise_dir", default="data/Train/Denoise/")
    p.add_argument("--derain_dir", default="data/Train/Derain/")
    p.add_argument("--dehaze_dir", default="data/Train/Dehaze/")
    p.add_argument("--output_path", default="output/")
    p.add_argument("--ckpt_dir", default="ckpt/train_all")
    p.add_argument("--resume", default=None, help="resume from latest or epoch N")
    p.add_argument("--wblogger", default=None, help="wandb project name")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel ranks, --batch_size each (default: "
                        "every visible card; one process on the CPU)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint PromptIR's transformer blocks: their "
                        "forward runs again in the backward")
    p.add_argument("--remat_levels", type=int, nargs="*", default=None,
                   help="with --remat: checkpoint only these U-Net levels "
                        "(1=dim .. 4=latent)")
    p.add_argument("--fused", action="store_true",
                   help="train every transformer block as one autograd "
                        "Function through mdta_stats and block_tail (the "
                        "PromptIR and X-Restormer families)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of training steps 2-7 here")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (no image corpus needed)")
    # epoch-end eval (reference EvaluationCallback, train.py:134-172:
    # BSD68 sigma-15 + Rain100L PSNR/SSIM logged every epoch)
    p.add_argument("--eval_denoise_path", default=None,
                   help="clean BSD68-style dir for epoch-end sigma-15 eval")
    p.add_argument("--eval_derain_path", default=None,
                   help="Rain100L-style input/+target/ dir for epoch-end eval")
    p.add_argument("--eval_every_epochs", type=int, default=1)
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--num_refinement_blocks", type=int, default=None)
    p.add_argument("--dim", type=int, default=None, help="base channel width")
    p.add_argument("--log_dir", default=None,
                   help="metrics.jsonl / logger dir (default: config)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main(argv=None):
    """Train; returns the Trainer after its last epoch (None when the run
    went to N > 1 ranks)."""
    args = build_parser().parse_args(argv)
    n = n_ranks(args)
    if n > 1:
        from promptir_tpu_torch.parallel.mesh import launch

        launch(rank_main, n, args.device, args=(args, n))
        return None
    return train(args, n)


def rank_main(args, n: int) -> None:
    """One rank of `--n_data N`: train, return nothing."""
    train(args, n)


def train(args, n: int):
    """Train with the CLI's arguments in this process: one process, or one
    rank of n."""
    import torch

    from promptir_tpu_torch.cli.test import size_kwargs
    from promptir_tpu_torch.config import Config
    from promptir_tpu_torch.models import create_model
    from promptir_tpu_torch.train.trainer import DTYPES, Trainer

    cfg = Config()
    cfg.train.model = args.model
    cfg.train.epochs = args.epochs
    cfg.train.batch_size = args.batch_size
    cfg.train.grad_accum = args.grad_accum
    cfg.train.lr = args.lr
    cfg.train.seed = args.seed
    cfg.train.ckpt_dir = args.ckpt_dir
    if args.log_dir is not None:
        cfg.train.log_dir = args.log_dir
    cfg.train.wandb_project = args.wblogger
    cfg.data.patch_size = args.patch_size
    cfg.data.num_workers = args.num_workers
    cfg.data.de_type = args.de_type
    cfg.data.data_file_dir = args.data_file_dir
    cfg.data.denoise_dir = args.denoise_dir
    cfg.data.derain_dir = args.derain_dir
    cfg.data.dehaze_dir = args.dehaze_dir
    cfg.system.device = args.device
    cfg.system.compute_dtype = args.dtype
    cfg.system.profile_dir = args.profile_dir
    cfg.system.remat = args.remat
    cfg.system.n_data = n
    if args.remat_levels is not None:
        cfg.system.remat_levels = tuple(args.remat_levels)

    if args.synthetic:
        from promptir_tpu_torch.data.synthetic import SyntheticTrainDataset

        dataset = SyntheticTrainDataset(patch_size=args.patch_size)
    else:
        from promptir_tpu_torch.data.datasets import PromptTrainDataset

        dataset = PromptTrainDataset(
            data_file_dir=cfg.data.data_file_dir,
            denoise_dir=cfg.data.denoise_dir,
            derain_dir=cfg.data.derain_dir,
            dehaze_dir=cfg.data.dehaze_dir,
            de_type=cfg.data.de_type,
            patch_size=cfg.data.patch_size,
            seed=cfg.train.seed,
        )
        print(f"total samples: {len(dataset)}")

    model = None
    kw = size_kwargs(args.num_blocks, args.num_refinement_blocks, args.dim)
    if kw or args.fused:
        if args.fused:
            kw["fused_ffn"] = True
        if args.remat:  # keep remat when the CLI builds the model
            kw["remat"] = True
            if args.remat_levels is not None:
                kw["remat_levels"] = tuple(args.remat_levels)
        torch.manual_seed(args.seed)
        model = create_model(args.model, device=args.device,
                             dtype=DTYPES[args.dtype], train=True, **kw)

    eval_hook = None
    if args.eval_denoise_path or args.eval_derain_path:
        from promptir_tpu_torch.eval.runner import make_epoch_eval_hook

        cfg.train.eval_every_epochs = args.eval_every_epochs
        eval_hook = make_epoch_eval_hook(
            denoise_path=args.eval_denoise_path,
            derain_path=args.eval_derain_path,
        )
    trainer = Trainer(cfg, dataset, model=model, eval_hook=eval_hook)
    if args.resume is not None:
        trainer.resume(None if args.resume == "latest" else int(args.resume))
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
