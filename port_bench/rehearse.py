"""Rehearse one cell on the CPU at a small size.

    python -m port_bench.rehearse --workload promptir-serve-photo --seed 7

runs the cell's whole flow (weights, inputs, warm-up, window, the check
against the reference, with `--trace 1` the profiled slice and the
readers) on the CPU, with the configuration cut to one block a level at
dim 16, and the traffic to small images, a low rate and small batches
(`SHRINK`). The port's kernel wrappers run their plain versions there. It
prints the result line it would print; nothing in it is a measurement of
the card. The measuring path, port_bench.run, refuses to run without a
card."""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

SHRINK = {
    "config": {"dim": 16, "num_blocks": [1, 1, 1, 1],
               "num_refinement_blocks": 1},
    "serve": {"rate_per_s": 4.0, "sample": 2, "profile_seconds": 0.5,
              "pool_clean": 2, "engine": {"max_batch": 2,
                                          "batch_timeout_ms": 5.0,
                                          "max_queue": 256}},
    "train": {"batch": 2, "haze_rows": 1, "pool_batches": 5, "reference_rows": 1,
              "profile_steps": 1},
}


def shrunk(cell: dict) -> dict:
    cell = copy.deepcopy(cell)
    cell["config"]["model"].update(SHRINK["config"])
    tr = cell["traffic"]
    tr.update(SHRINK[tr["driver"]])
    base = cell["config"]["pad_base"]
    if tr["driver"] == "serve":
        # a little off the pad base, so the reflect padding runs
        tr["sizes"] = [[base * 2 - 3, base * 3 - 3], [base * 3 - 3, base * 2 - 3]] \
            if base > 8 else [[37, 53], [53, 37]]
    else:
        tr["patch"] = [max(32, base), max(32, base)]
    return cell


def rehearse(workload: str, seed: int, seconds: float, trace: bool = False,
             fault=None, traffic: dict = None, control: bool = False) -> dict:
    """The result of one rehearsal; `traffic` overrides keys of the
    (shrunk) traffic."""
    import torch

    from port_bench import manifest, run

    cell = shrunk(manifest.cell(workload))
    cell["traffic"].update(traffic or {})
    return run.execute(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), fault=fault, control=control)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    out = rehearse(args.workload, args.seed, args.seconds, bool(args.trace),
                   args.fault)
    for s in out["stderr"]:
        print(s, file=sys.stderr)
    print(json.dumps(out["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
