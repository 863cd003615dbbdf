"""Steady-state training speed: ms a step and images/s.

Counterpart of tools/tbench.py: `train/step.py`'s step (forward, L1,
backward, AdamW) on a fixed seeded batch, full-depth promptir, bf16
compute, B6 128x128 by default (the reference recipe), after `--warmup`
steps; each of `--steps` steps timed by CUDA events, the median kept, with
the peak memory of the timed steps (`max_memory_allocated`) and the loss
of the first and last step (it falls on a fixed batch).

    python -m promptir_tpu_torch.tools.tbench [--batch 6 --size 128] [--fused] [--remat]

One JSON line names the device (and the card's name and power limit); on
`--device cpu` the plain versions run and the times are the host's.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from promptir_tpu_torch.tools.profile_train import (
    model_kwargs,
    train_fn,
    train_parser,
)
from promptir_tpu_torch.tools.trace import device_record, resolve_device


def main(argv=None) -> dict:
    p = train_parser("steady-state training speed")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    fn = train_fn(args, device)
    first = float(fn()["train_loss"])
    for _ in range(args.warmup - 1):
        fn()
    times, peak = [], None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
               for _ in range(args.steps)]
        for s, e in evs:
            s.record()
            metrics = fn()
            e.record()
        torch.cuda.synchronize(device)
        times = [s.elapsed_time(e) for s, e in evs]
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    else:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            metrics = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    line = {"tool": "tbench", **device_record(device), "model": args.model,
            "batch": args.batch, "size": args.size, "dtype": args.dtype,
            **model_kwargs(args), "steps": args.steps, "step_ms": ms,
            "step_ms_min": min(times), "step_ms_max": max(times),
            "images_per_s": args.batch / ms * 1e3, "peak_memory_gib": peak,
            "loss_first": first, "loss_last": float(metrics["train_loss"])}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
