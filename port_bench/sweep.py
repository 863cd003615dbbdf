"""Find a serving cell's knee: the highest rate its open loop sustains.

    python3 -m port_bench.sweep --workload promptir-serve-photo \
        --rates 20 30 40 --seconds 10

runs the cell's serving driver once a rate (same seed, same traffic but
the rate) on the card and prints one JSON line a rate: the replies per
second inside the window, the p50 and p95 latency and how long the last
reply came after the window closed. Above the knee the replies fall
behind the offered rate and the latency grows with the window. A cell's
rate is set once, at about four fifths of the knee, by a benchmark change;
the runs of the benchmark never search for it."""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from port_bench import common, manifest
    from port_bench.drivers import serve

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    base = manifest.cell(args.workload)
    for rate in args.rates:
        cell = copy.deepcopy(base)
        cell["traffic"]["rate_per_s"] = rate
        t = time.perf_counter()
        res = serve.run(cell, args.seed, args.seconds, False, device)
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "replies_per_s": res["replies_per_s"],
            "p95_ms": res["e2e"]["serve_p95_ms"],
            "failed": res["failed"], "checks": res["checks"],
            "log": res["log"], "run_s": time.perf_counter() - t,
            "card": common.card_line()}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
