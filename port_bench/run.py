"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload promptir-serve-photo --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout on a machine with the card. The cell's
traffic file names its driver (drivers/<name>.py), which makes the
weights and inputs from the seed, warms up the cell's own shapes, runs the
measured window and checks what the window produced against the plain
reference (reference/). With `--trace 0` the result's metrics are the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read
from the same kind of window and two short profiled slices after it (the
device alone, then the host's ops and ranges too) by the readers in
metrics/.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the checks,
each compared number with its limit; the checks are also the last lines
of standard error. Without a card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed,
the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "promptir_tpu")
RANGES = {"forward": "forward", "optimizer": "optimizer",
          "block": "port_bench.block"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (promptir_tpu_torch is not promptir_tpu)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, fault=None, control: bool = False) -> dict:
    """Run the cell's driver and assemble the result line (as a dict) and
    the stderr lines."""
    import importlib

    from port_bench import manifest
    from port_bench.trace import split

    driver = importlib.import_module(
        f"port_bench.drivers.{cell['traffic']['driver']}")
    seed = int(seed) & (2 ** 63 - 1)
    res = driver.run(cell, seed, seconds, trace, device, fault=fault,
                     control=control)
    setup_s = res["t_window"] - t_start
    metrics, device_info, breakdown = {}, {}, None
    if not trace:
        values = dict(res["e2e"], setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(res["ctx"])
        prof = ctx.get("profile")
        if prof is not None:
            dev = split(prof["device"]["trace"], {},
                        wall_s=prof["device"]["wall_s"])
            host = split(prof["host"]["trace"], RANGES)
            ctx["device_split"], ctx["split"] = dev, host
            device_info = {"busy_s": dev["busy_s"], "window_s": dev["window_s"]}
            breakdown = {"device_ops": dev["device_ops"],
                         "idle_gaps": host["idle_gaps"]}
        for m in cell["per_layer"]:
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the cell's limits file names the numbers compared; the others are
    # readings for the log
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]["limit"]}
              for k, v in res["checks"].items() if k in limits}
    missing = set(limits) - set(checks)
    if missing:
        raise KeyError(f"the driver read no {sorted(missing)}")
    # a request refused or never answered is a wrong result too
    correct = res["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": _kind(device), "count": cell["chips"],
                       "memory_peak_bytes": int(res["memory_peak_bytes"]),
                       **device_info}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    stderr = list(res["log"]) + [
        f"reading {k} {v!r} (not compared)" for k, v in res["checks"].items()
        if k not in checks] + [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in checks.items()]
    return {"line": line, "stderr": stderr, "raw": res}


def _kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench import common, manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 3
    out["line"]["card"] = common.card_line()
    checks = out["line"].pop("checks")
    out["line"]["checks"] = checks
    for s in out["stderr"]:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
