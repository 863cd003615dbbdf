"""Serving benchmark: closed-loop clients on the InferenceEngine.

Counterpart of tools/sbench.py: `--clients` threads each submit an image to
`serve/engine.py:InferenceEngine`, wait for its result and submit again,
for `--seconds`, at one bucket (`--size`) or two (`--size2`, a `--mix2`
share of the clients). The offered load is clients / latency, the natural
saturation measure of a single-card engine. Every bucket is run at full
batch first (a warm-up: the first forward at a shape packs the weights).
Latency is the caller's, submit to result: queueing, batching delay,
padding, the forward and the copies. The line holds p50, p90 and p99 (with
the sample count beside p99), images/s and MP/s, the engine's mean batch
fill over the timed run, and its shed (rejected) and timed-out counters.

    python -m promptir_tpu_torch.tools.sbench --size 256 --clients 8 --seconds 10
    python -m promptir_tpu_torch.tools.sbench --size 256 --size2 192 --seconds 10

Seed-0 weights, bf16 by default. One JSON line names the device (and the
card's name and power limit); `--device cpu` serves the plain versions.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from promptir_tpu_torch.tools.trace import device_record, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="closed-loop serving benchmark")
    p.add_argument("--model", default="promptir")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--size2", type=int, default=0,
                   help="a second square bucket (0: one bucket)")
    p.add_argument("--mix2", type=float, default=0.25,
                   help="the share of clients that submit size2 images")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--batch_timeout_ms", type=float, default=5.0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused", action="store_true")
    p.add_argument("--num_blocks", type=int, nargs=4, default=None)
    p.add_argument("--num_refinement_blocks", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def percentile(sorted_s, q: float) -> float:
    """The q-quantile of sorted seconds, in ms (nearest rank)."""
    return sorted_s[min(len(sorted_s) - 1, int(q * len(sorted_s)))] * 1e3


def main(argv=None) -> dict:
    from promptir_tpu_torch.cli.test import size_kwargs
    from promptir_tpu_torch.eval.padding import pad_bases
    from promptir_tpu_torch.models import create_model
    from promptir_tpu_torch.serve.engine import InferenceEngine

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    kw = {"fused_ffn": True} if args.fused else {}
    kw.update(size_kwargs(args.num_blocks, args.num_refinement_blocks))
    torch.manual_seed(0)
    model = create_model(args.model, device=device,
                         dtype=getattr(torch, args.dtype), **kw)
    engine = InferenceEngine(model, pad_base=pad_bases(args.model)[0],
                             max_batch=args.max_batch,
                             batch_timeout_ms=args.batch_timeout_ms,
                             max_queue=4 * args.clients + args.max_batch)
    sizes = [args.size] + ([args.size2] if args.size2 else [])
    rng = np.random.default_rng(0)
    imgs = {s: rng.uniform(size=(s, s, 3)).astype(np.float32) for s in sizes}
    lat = {s: [] for s in sizes}
    errors, lock, stop = [], threading.Lock(), threading.Event()

    def client(i):
        s = sizes[-1] if args.size2 and i < args.mix2 * args.clients \
            else sizes[0]
        while not stop.is_set():
            t = time.perf_counter()
            try:
                engine.submit(imgs[s]).result()
            except Exception as e:  # shed or timed out: counted, go on
                with lock:
                    errors.append(repr(e))
                time.sleep(0.005)
                continue
            with lock:
                lat[s].append(time.perf_counter() - t)

    try:
        t0 = time.perf_counter()
        for s in sizes:
            for r in engine.restore_many([imgs[s]] * args.max_batch):
                if r.shape != imgs[s].shape or not np.isfinite(r).all():
                    raise RuntimeError(f"bad warm-up reply at {s}x{s}")
        warmup_s = time.perf_counter() - t0
        base = engine.stats()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(args.clients)]
        start = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        elapsed = time.perf_counter() - start
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not finish")
        stats = engine.stats()
    finally:
        engine.close()
    every = sorted(x for v in lat.values() for x in v)
    if not every:
        raise RuntimeError(f"no request completed; errors: {errors[:3]}")
    n = len(every)
    batches = stats["batches"] - base["batches"]
    fill = (stats["mean_batch_fill"] * stats["batches"]
            - base["mean_batch_fill"] * base["batches"]) / max(1, batches)
    line = {
        "tool": "sbench", **device_record(device), "model": args.model,
        "dtype": args.dtype, **kw, "buckets": sizes, "clients": args.clients,
        "max_batch": args.max_batch, "seconds": elapsed,
        "warmup_s": warmup_s, "completed": n, "errors": len(errors),
        "images_per_s": n / elapsed,
        "mp_per_s": sum(len(v) * s * s for s, v in lat.items()) / 1e6 / elapsed,
        "latency_ms": {"p50": percentile(every, 0.50),
                       "p90": percentile(every, 0.90),
                       "p99": percentile(every, 0.99), "p99_samples": n,
                       "max": every[-1] * 1e3},
        "per_bucket": {str(s): {"n": len(v), "p50_ms": percentile(sorted(v), 0.5)
                                if v else None} for s, v in lat.items()},
        "mean_batch_fill": fill, "batches": batches,
        "rejected": stats["rejected"] - base["rejected"],
        "timed_out": stats["timed_out"] - base["timed_out"],
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
