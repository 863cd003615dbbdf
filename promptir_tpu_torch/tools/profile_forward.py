"""Where a served forward's time goes, by module and by kernel.

Counterpart of tools/profile_forward.py: the bf16 promptir forward at B4
256x256 by default (seed-0 weights, served: the kernels' inference route),
traced over `--iters` calls after a warm-up call, twice, the window with
more device time kept (a window now and then loses kernel records). Every
forward runs inside a "forward" range, and each child module of the model
inside a range of its name (PromptIR's level stacks and noise blocks through
`blocks.run_stack` and `run_block`, which the model calls with the module;
the rest through the module's own forward), so the trace
(tools/trace.py:split_trace) gives each module's device time, kernels and
busiest ops; "forward" keeps what no module range holds (the seam, the
skip concatenations, the global residual). The stages are grouped as the
JAX tool groups them: levels, refinement, prompts, noise blocks and the
resampling and 1x1 reduces.

    python -m promptir_tpu_torch.tools.profile_forward [--batch 4 --size 256]

One JSON line, ms a forward, names the device (and the card's name and
power limit); `--device cpu` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from promptir_tpu_torch.tools.trace import (
    device_record,
    resolve_device,
    sync,
    time_ms,
    traced_split,
)

GROUPS = (("levels", ("encoder_level", "latent", "decoder_level")),
          ("refinement", ("refinement",)),
          ("prompts", ("prompt",)),
          ("noise_blocks", ("noise_level",)),
          ("resample_and_reduce", ("down", "up", "reduce_", "patch_embed",
                                   "output")))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="split a forward's time by module")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--num_refinement_blocks", type=int, default=None)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--out", default=None,
                   help="directory for the traces (default: a temporary one)")
    p.add_argument("--device", default="cuda")
    return p


@contextlib.contextmanager
def module_ranges(model):
    """Every child module of `model` inside a record_function range of its
    name, "module:<name>": the stacks and blocks that models/promptir.py
    hands to blocks.run_stack and run_block, the others called as modules."""
    from torch.profiler import record_function

    from promptir_tpu_torch.models import promptir

    names = {id(m): name for name, m in model.named_children()}

    def ranged(fn):
        def run(module, *a, **k):
            label = names.get(id(module))
            if label is None:
                return fn(module, *a, **k)
            with record_function(f"module:{label}"):
                return fn(module, *a, **k)
        return run

    with contextlib.ExitStack() as stack:
        for fn in ("run_stack", "run_block"):
            stack.enter_context(mock.patch.object(
                promptir, fn, ranged(getattr(promptir, fn))))
        for name, module in model.named_children():
            stack.enter_context(mock.patch.object(
                module, "forward", ranged(type(module).forward).__get__(module)))
        yield names.values()


def group_of(name: str) -> str:
    return next((g for g, prefixes in GROUPS if name.startswith(prefixes)),
                "other")


def main(argv=None) -> dict:
    from torch.profiler import record_function

    from promptir_tpu_torch.cli.test import size_kwargs
    from promptir_tpu_torch.models import create_model

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    kw = size_kwargs(args.num_blocks, args.num_refinement_blocks)
    torch.manual_seed(0)
    model = create_model("promptir", device=device,
                         dtype=getattr(torch, args.dtype), **kw)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(args.batch, 3, args.size, args.size)).astype(np.float32)).to(device)

    def forward():
        with torch.inference_mode(), record_function("forward"):
            return model(x)

    if device.type == "cuda":
        forward_ms = time_ms(forward, reps=10, warmup=2)
    else:
        forward()
        t0 = time.perf_counter()
        forward()
        forward_ms = (time.perf_counter() - t0) * 1e3
    with module_ranges(model) as names, tempfile.TemporaryDirectory() as tmp:
        ranges = {name: f"module:{name}" for name in names}
        ranges["forward"] = "forward"
        out = pathlib.Path(args.out or tmp)
        split = traced_split(forward, args.iters, out, device, ranges)
    sync(device)
    n = args.iters
    parts = split["parts"]
    by_module = {k: {"ms": p["ms"] / n, "kernels_ms": p["port_ms"] / n,
                     "ops": p["ops"] / n, "top": p["top"][:3]}
                 for k, p in parts.items() if p["ops"]}
    groups = {}
    for name, p in parts.items():
        if name in ("forward", "(outside)"):
            continue
        g = groups.setdefault(group_of(name), 0.0)
        groups[group_of(name)] = g + p["ms"] / n
    groups["outside_modules"] = parts["forward"]["ms"] / n
    busy = split["busy_ms"]
    line = {"tool": "profile_forward", **device_record(device),
            "model": "promptir", "batch": args.batch, "size": args.size,
            "dtype": args.dtype, **kw, "forward_ms": forward_ms,
            "device_ms": busy / n, "window_ms": split["window_ms"] / n,
            "idle": split["idle"], "ops": split["ops"] / n,
            "in_ranges": 1 - parts["(outside)"]["ms"] / busy if busy else 0.0,
            "kernels_ms": sum(p["port_ms"] for p in parts.values()) / n,
            "groups_ms": groups, "modules": by_module,
            "top": [[k, ms / n, c / n] for k, ms, c in split["top"]]}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
