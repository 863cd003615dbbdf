"""Model complexity summary: parameters, FLOPs, bytes, peak memory.

Counterpart of promptir_tpu/cli/summary.py (the reference's per-model
__main__ blocks and utils_modelsummary counters), with the JAX CLI's
flags and `--device` (default the card). The counts come from
utils/flops.py:model_cost: FLOPs and bytes from a forward of the plain
route on a CPU copy of the model, the peak memory from a forward on the
card through the kernels (none on the CPU); on the card the memory line
names the card and its power limit.

    python -m promptir_tpu_torch.cli.summary --model promptir --size 256
    python -m promptir_tpu_torch.cli.summary --size 64 --device cpu
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="model complexity summary")
    p.add_argument("--model", default="promptir")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from promptir_tpu_torch.models import create_model
    from promptir_tpu_torch.tools.trace import device_record, resolve_device
    from promptir_tpu_torch.utils.flops import model_cost, summarize

    device = resolve_device(args.device)
    kw = {}
    if args.num_blocks is not None:
        kw["num_blocks"] = tuple(args.num_blocks)
    model = create_model(args.model, device=device, **kw)
    shape = (args.batch, args.size, args.size, 3)
    cost = model_cost(model, shape)
    record = device_record(device)
    print(f"{args.model} @ {args.batch}x{args.size}x{args.size}x3")
    for line in summarize(model, shape, cost=cost).splitlines():
        if line.startswith("Memory") and "card" in record:
            line += f" on {record['card']}"
        print(line)
    return cost


if __name__ == "__main__":
    main()
