"""Readings that a cell's limits are set from, in one process on the card.

    python3 -m port_bench.calibrate --workload promptir-serve-photo \
        --seconds 4 --seeds 1 2 3 ... [--faults answer_altered half_batch]

For each seed: the cell's driver at the cell's own sizes and load, with a
short window (`--seconds`, long enough for the sample's requests, or the
training cell's three checked steps), its checks (the program against the
reference: the lower readings) and the control's (the reference computed
with fp8 products against the reference in float32: the upper readings).
With `--faults`, each fault planted under the program (drivers/*._Fault)
on the first three seeds. One JSON line a run."""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)

    import importlib

    import torch

    from port_bench import manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = manifest.cell(args.workload)
    driver = importlib.import_module(
        f"port_bench.drivers.{cell['traffic']['driver']}")
    runs = [(s, None) for s in args.seeds]
    runs += [(s, f) for f in args.faults for s in args.seeds[:3]]
    for seed, fault in runs:
        t = time.perf_counter()
        res = driver.run(cell, seed, args.seconds, False, device, fault=fault,
                         control=fault is None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": fault, "checks": res["checks"],
                          "control": res["control_checks"],
                          "e2e": res["e2e"], "failed": res["failed"],
                          "notes": res.get("notes"), "log": res["log"],
                          "run_s": time.perf_counter() - t}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
