"""End-to-end training demonstration on the card.

Counterpart of tools/train_demo.py. Runs the port's training harness
(Trainer -> train step through the kernels -> checkpoints -> JSONL metrics)
on the synthetic mixed-noise dataset and reports PSNR on a held-out
synthetic sigma = 25 denoise set before and after, the reference's
train.py -> test.py workflow in one command that needs no downloaded
corpora:

  python -m promptir_tpu_torch.cli.train_demo --epochs 3 --batch 4 --dtype bfloat16

A reduced-depth PromptIR (num_blocks (2, 3, 3, 4), 2 refinement blocks, as
TRAIN_DEMO.md) unless --full. `--fused` trains each block as one LnBlock
(mdta_stats and block_tail forward) and `--remat` checkpoints the blocks,
as the JAX tool's flags do. Exits non-zero when the held-out PSNR does not
rise. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def held_out_psnr(eval_step, test_ds, device) -> tuple:
    """(mean PSNR of the restored images, mean PSNR of the noisy inputs)."""
    from promptir_tpu_torch.eval.metrics import psnr

    ps, noisy_ps = [], []
    for i in range(len(test_ds)):
        _, noisy, clean = test_ds.get(i)
        noisy_t = torch.from_numpy(noisy[None])
        clean_t = torch.from_numpy(clean[None]).to(device)
        ps.append(float(psnr(clean_t, eval_step(noisy_t))[0]))
        noisy_ps.append(float(psnr(clean_t, noisy_t.to(device))[0]))
    return float(np.mean(ps)), float(np.mean(noisy_ps))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--n_train", type=int, default=48)
    p.add_argument("--patch", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fused", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--full", action="store_true",
                   help="full 35.6M-param PromptIR")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_dir", default="logs/train_demo/ckpt")
    p.add_argument("--log_dir", default="logs/train_demo")
    args = p.parse_args(argv)

    from promptir_tpu_torch.config import Config
    from promptir_tpu_torch.data.synthetic import (
        SyntheticDenoiseTestDataset,
        SyntheticTrainDataset,
    )
    from promptir_tpu_torch.models import create_model
    from promptir_tpu_torch.train.trainer import DTYPES, Trainer

    cfg = Config()
    cfg.train.epochs = args.epochs
    cfg.train.batch_size = args.batch
    cfg.train.lr = args.lr
    cfg.train.warmup_epochs = 1
    cfg.train.cosine_max_epochs = max(args.epochs, 2)
    cfg.train.seed = args.seed
    cfg.train.ckpt_dir = args.ckpt_dir
    cfg.train.log_dir = args.log_dir
    cfg.system.device = args.device
    cfg.system.compute_dtype = args.dtype

    kw = {} if args.full else dict(num_blocks=(2, 3, 3, 4),
                                   num_refinement_blocks=2)
    if args.fused:
        kw["fused_ffn"] = True
    if args.remat:
        kw["remat"] = True
    torch.manual_seed(args.seed)
    model = create_model("promptir", device=args.device,
                         dtype=DTYPES[args.dtype], train=True, **kw)
    train_ds = SyntheticTrainDataset(n=args.n_train, patch_size=args.patch)
    test_ds = SyntheticDenoiseTestDataset(n=4, size=args.patch, sigma=25.0)

    trainer = Trainer(cfg, train_ds, model=model)
    dev = trainer.device
    psnr0, psnr_noisy = held_out_psnr(trainer.eval_step, test_ds, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[demo] device: {name}; {sum(p.numel() for p in model.parameters())} "
          f"params, {args.dtype}")
    print(f"[demo] PSNR before training: {psnr0:.2f} dB "
          f"(noisy input: {psnr_noisy:.2f} dB)")
    t0 = time.time()
    trainer.fit()
    dt = time.time() - t0
    psnr1, _ = held_out_psnr(trainer.eval_step, test_ds, dev)
    print(f"[demo] PSNR after {args.epochs} epochs ({dt:.0f}s): "
          f"{psnr1:.2f} dB  (delta {psnr1 - psnr0:+.2f} dB)")
    if psnr1 <= psnr0:
        raise SystemExit("training demo FAILED: PSNR did not improve")
    print("[demo] OK: loss curve in", args.log_dir + "/metrics.jsonl",
          "checkpoints in", args.ckpt_dir)
    return dict(psnr_before=psnr0, psnr_noisy=psnr_noisy, psnr_after=psnr1,
                seconds=dt)


if __name__ == "__main__":
    main()
