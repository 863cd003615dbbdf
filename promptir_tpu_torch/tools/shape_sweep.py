"""The served size grid through every kernel of promptir, each call held
against its plain version.

Counterpart of tools/shape_sweep.py, which compiles and runs the fused
forward at the serving surface's size classes so that a kernel's layout
constraint shows in a sweep, not in production. Here promptir at reduced
depth (two blocks a level, so that the chained route runs tail_stats;
blocks add no new kernel shape), batch 2, runs each size of DEFAULT_GRID
block by block (mdta_stats with its Gram stage, block_tail, the seam) and
chained (`fused_ffn=True`: tail_stats), in float32 (TF32 off) and bf16.
Every kernel call on the way is repeated through its plain version on the
same inputs: max |kernel - plain| at most TOL of max |plain| (1e-4 fp32,
2e-2 bf16, chip_smoke.py's phase 3), the seam bit-exact. The output is held
against the same forward through the plain route (`plain_route`): within
FORWARD_TOL of max |plain| in fp32, FORWARD_TOL_BF16 in bf16 (the smoke's
gates). A size that fails is reported and the sweep goes on; the last line
counts the failures and the exit code is 1 if any.

    python -m promptir_tpu_torch.tools.shape_sweep [--sizes 224 320]

Each line names the device (and the card's name and power limit); on
`--device cpu` every wrapper runs its plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from promptir_tpu_torch.tools.trace import device_record, resolve_device

DEFAULT_GRID = [
    (192, 192), (224, 224), (288, 288), (320, 320), (384, 384), (448, 448),
    (224, 320), (192, 448),  # odd aspect ratios
]
REDUCED = dict(num_blocks=(2, 2, 2, 2), num_refinement_blocks=1)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FORWARD_TOL, FORWARD_TOL_BF16 = 2e-4, 1.5625e-2


@contextlib.contextmanager
def plain_route():
    """The forwards with every kernel swapped for its plain version: each
    autograd Function of the training route for its plain composition
    (ops/autodiff.py), and each wrapper of the serving route (the chained
    stacks included) for its plain version. Restored on exit."""
    from promptir_tpu_torch.models import blocks
    from promptir_tpu_torch.models import promptir as promptir_model
    from promptir_tpu_torch.ops import autodiff
    from promptir_tpu_torch.ops.cuda import block, gdfn, mdta, megablock
    from promptir_tpu_torch.ops.cuda.seam import seam_plain

    swaps = [
        (blocks, "LnMdta", SimpleNamespace(apply=autodiff.plain_ln_mdta)),
        (blocks, "LnGdfn", SimpleNamespace(apply=autodiff.plain_ln_gdfn)),
        (blocks, "LnBlock", SimpleNamespace(apply=autodiff.plain_ln_block)),
        (blocks, "mdta_stats", mdta.mdta_stats_plain),
        (blocks, "block_tail", block.block_tail_plain),
        (blocks, "tail_stats", megablock.tail_stats_plain),
        (blocks, "ln_gdfn", gdfn.ln_gdfn_plain),
        (promptir_model, "Seam", SimpleNamespace(apply=seam_plain)),
    ]
    with contextlib.ExitStack() as stack:
        for mod, name, fn in swaps:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@contextlib.contextmanager
def checked_kernels(worst: dict):
    """Every serving wrapper promptir calls (blocks.mdta_stats, block_tail,
    tail_stats; the seam under autodiff.Seam) also runs its plain version on
    the same inputs; `worst[name]` keeps the largest rel_err of its outputs
    (the seam: of any bit)."""
    from promptir_tpu_torch.models import blocks
    from promptir_tpu_torch.ops import autodiff
    from promptir_tpu_torch.ops.cuda import block, mdta, megablock, seam

    pairs = [(blocks, "mdta_stats", mdta.mdta_stats_plain),
             (blocks, "block_tail", block.block_tail_plain),
             (blocks, "tail_stats", megablock.tail_stats_plain),
             (autodiff, "seam", seam.seam_plain)]

    def checked(name, kernel, plain):
        def run(*args, **kw):
            out = kernel(*args, **kw)
            want = plain(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            wants = want if isinstance(want, tuple) else (want,)
            if name == "seam":
                err = float(not all(torch.equal(o, w)
                                    for o, w in zip(outs, wants)))
            else:
                err = max(rel_err(o, w) for o, w in zip(outs, wants))
            worst[name] = max(worst.get(name, 0.0), err)
            return out
        return run

    with contextlib.ExitStack() as stack:
        for mod, name, plain in pairs:
            kernel = getattr(mod, name)
            stack.enter_context(mock.patch.object(
                mod, name, checked(name, kernel, plain)))
        yield


def sweep_size(models: dict, hw, batch: int, device) -> dict:
    """One size through every (route, dtype) model: its kernels' worst
    errors, and its output against the plain route's."""
    from promptir_tpu_torch.precision import exact_float32

    h, w = hw
    x = torch.from_numpy(np.random.default_rng(h + w).uniform(
        size=(batch, 3, h, w)).astype(np.float32)).to(device)
    line = {"size": [h, w], "ok": True, "runs": {}}
    for (route, dtype), model in models.items():
        worst = {}
        with torch.inference_mode(), exact_float32(dtype):
            with checked_kernels(worst):
                out = model(x)
            with plain_route():
                want = model(x)
        tol = TOL[dtype]
        err = rel_err(out, want)
        gate = FORWARD_TOL if dtype == torch.float32 else FORWARD_TOL_BF16
        out_err = (err if dtype == torch.float32
                   else (out - want).abs().max().item())
        bad = [k for k, e in worst.items() if e > (0 if k == "seam" else tol)]
        ok = (not bad and out_err <= gate
              and bool(torch.isfinite(out).all()) and out.shape == x.shape)
        line["runs"][f"{route} {str(dtype)[6:]}"] = {
            "ok": ok, "kernels": worst, "forward_err": out_err,
            "failed_kernels": bad}
        line["ok"] &= ok
    return line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="served sizes through the kernels")
    p.add_argument("--sizes", type=int, nargs="*", default=None,
                   help="square sizes in place of the default grid")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--num_refinement_blocks", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> list:
    from promptir_tpu_torch.cli.test import size_kwargs
    from promptir_tpu_torch.models import create_model

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    record = device_record(device)
    grid = [(s, s) for s in args.sizes] if args.sizes else DEFAULT_GRID
    kw = dict(REDUCED, **size_kwargs(args.num_blocks,
                                     args.num_refinement_blocks))
    models = {}
    for route, extra in (("block", {}), ("chained", {"fused_ffn": True})):
        torch.manual_seed(0)
        base = create_model("promptir", device=device, **kw, **extra)
        for dtype in (torch.float32, torch.bfloat16):
            models[route, dtype] = create_model(
                "promptir", device=device, dtype=dtype, **kw, **extra)
            models[route, dtype].load_state_dict(base.state_dict())
    lines = []
    for hw in grid:
        line = {"tool": "shape_sweep", **record, "batch": args.batch,
                **sweep_size(models, hw, args.batch, device)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    failures = sum(not ln["ok"] for ln in lines)
    print(json.dumps({"tool": "shape_sweep", **record, "sweep": len(lines),
                      "failures": failures}), flush=True)
    if failures:
        raise SystemExit(1)
    return lines


if __name__ == "__main__":
    main()
