"""Where a training step's time goes, from a torch.profiler trace.

Counterpart of tools/profile_train.py: one step of `train/step.py`
(forward, L1, backward, AdamW) at the reference recipe, full-depth
promptir, bf16 compute, B6 128x128 by default, traced over `--iters` steps
after two warm-up steps, the Chrome trace written to `--out`. The trace is
split (tools/trace.py:split_trace) into
  * the forward (the step's "forward" range): the port's kernels, by name,
    and the other ops;
  * the backward: autograd's `evaluate_function` ranges, which run on
    autograd's own thread, outside any forward range (the plain recompute
    of ops/autodiff.py's LnMdta, LnGdfn and LnBlock included);
  * the optimizer (the step's "optimizer" range: the gradient norm and
    AdamW);
  * what lies outside them, and the card's idle time in the window.
Two windows are traced and the one with more device time kept: a window
now and then loses kernel records. `--parse DIR` splits the newest trace
in DIR instead (the trainer's ProfilerWindow writes one there).

    python -m promptir_tpu_torch.tools.profile_train [--fused] [--remat]
    python -m promptir_tpu_torch.tools.profile_train --parse logs/run

One JSON line, ms a step, names the device (and the card's name and power
limit); `--device cpu` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile

import numpy as np
import torch

from promptir_tpu_torch.cli.test import size_kwargs
from promptir_tpu_torch.tools.trace import (
    device_record,
    load_trace,
    resolve_device,
    split_trace,
    traced_split,
)

RANGES = {"forward": "forward",
          "backward": "autograd::engine::evaluate_function:",
          "optimizer": "optimizer"}


def train_parser(description: str) -> argparse.ArgumentParser:
    """The flags of the step: model, batch, size, dtype, the JAX trainer's
    --fused, --remat and --remat_levels, the size flags and --device."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", default="promptir")
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_levels", type=int, nargs="*", default=None)
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--num_refinement_blocks", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = train_parser("split a training step's time")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--out", default=None,
                   help="directory for the trace (default: a temporary one)")
    p.add_argument("--parse", default=None,
                   help="split the newest *.json trace in this directory")
    return p


def model_kwargs(args) -> dict:
    """The model's options from the flags, as cli/train.py passes them."""
    kw = {}
    if args.fused:
        kw["fused_ffn"] = True
    if args.remat:
        kw["remat"] = True
        if args.remat_levels is not None:
            kw["remat_levels"] = tuple(args.remat_levels)
    kw.update(size_kwargs(args.num_blocks, args.num_refinement_blocks))
    return kw


def train_fn(args, device):
    """fn() running one training step of the model on a fixed seeded batch;
    it returns the step's metrics."""
    from promptir_tpu_torch.models import create_model
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    torch.manual_seed(0)
    dtype = getattr(torch, args.dtype)
    model = create_model(args.model, device=device, dtype=dtype, train=True,
                         **model_kwargs(args))
    state = TrainState(model, make_optimizer(model.parameters()))
    step = make_train_step(model)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.size, args.size, 3)
    batch = {k: torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
             .to(device) for k in ("degraded", "clean")}
    return lambda: step(state, batch)


def summarize(split: dict, steps: int) -> dict:
    """The split's parts as ms a step: forward kernels and other ops,
    backward, optimizer, outside, the card's idle time; with the share of
    the device time the three ranges hold and the share of the port's
    kernels' time the forward holds."""
    parts = split["parts"]
    port = sum(p["port_ms"] for p in parts.values())
    fwd = parts["forward"]
    ms = {
        "forward_kernels": fwd["port_ms"] / steps,
        "forward_other": (fwd["ms"] - fwd["port_ms"]) / steps,
        "backward": parts["backward"]["ms"] / steps,
        "optimizer": parts["optimizer"]["ms"] / steps,
        "outside": parts["(outside)"]["ms"] / steps,
        "idle": (split["window_ms"] - split["union_ms"]) / steps,
    }
    busy = split["busy_ms"]
    return {
        "window_ms_per_step": split["window_ms"] / steps,
        "device_ms_per_step": busy / steps,
        "parts_ms": ms,
        "in_ranges": 1 - parts["(outside)"]["ms"] / busy if busy else 0.0,
        "idle": split["idle"],
        "kernels_in_forward": fwd["port_ms"] / port if port else None,
        "ops_per_step": split["ops"] / steps,
        "top": {label: p["top"] for label, p in parts.items()},
    }


def parse(directory: str) -> dict:
    traces = sorted(pathlib.Path(directory).glob("*.json"),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        raise SystemExit(f"no *.json trace under {directory}")
    trace = load_trace(traces[-1])
    props = trace.get("deviceProperties") or []
    record = ({"device": "cuda", "card": props[0].get("name")} if props
              else {"device": "cpu"})
    split = split_trace(trace, RANGES)
    steps = max(1, sum(1 for e in trace.get("traceEvents", [])
                       if e.get("ph") == "X" and e.get("name") == "optimizer"
                       and e.get("cat") == "user_annotation"))
    return {"tool": "profile_train", "trace": str(traces[-1]), **record,
            "steps": steps, **summarize(split, steps)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.parse:
        line = parse(args.parse)
    else:
        device = resolve_device(args.device)
        fn = train_fn(args, device)
        fn()  # a second warm-up step: profile_trace runs one more
        with tempfile.TemporaryDirectory() as tmp:
            out = pathlib.Path(args.out or tmp)
            split = traced_split(fn, args.iters, out, device, RANGES)
        line = {"tool": "profile_train", **device_record(device),
                "model": args.model, "batch": args.batch, "size": args.size,
                "dtype": args.dtype, **model_kwargs(args),
                "steps": args.iters, **summarize(split, args.iters)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
