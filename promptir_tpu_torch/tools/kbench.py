"""Time one of the port's kernels at one shape, beside its plain version.

Counterpart of tools/kbench.py: the kernel's wrapper launched many times
after a warm-up, timed by CUDA events (the median of `--reps`), with the
same inputs through its plain PyTorch version, the one PyTorch call that
computes the same function where there is one (the Gram stage: a batched
`torch.matmul`; the seam: `torch.cat` of `F.pixel_shuffle` and the skip)
and the kernel's bound: the larger of the bytes it must move over the
card's 3.35 TB/s and its operations over the peak rate of their type
(989 TFLOP/s bf16, 67 TFLOP/s float32), each input read once and each
output written once. `block_work`, `gdfn_work`, `apply_work` and
`pair_work` count them (chip_smoke.py's phase 9 reads them from here).

    python -m promptir_tpu_torch.tools.kbench --op block_tail --shape 4 256 256 48
    python -m promptir_tpu_torch.tools.kbench --op mdta_gram --shape 4 32 32 704 --heads 4

`--op` is one of KERNELS: mdta_stats (ops/pallas/mdta.py:317), its Gram
stage mdta_gram (the wide route), block_tail (block.py:158), ln_gdfn
(gdfn.py:536), ln_mdta (mdta.py:252, the apply of attn v and the
projection), seam (seam.py:222; the shape is the skip's, B H W 48) and
tail_stats (megablock.py:165). One JSON line names the device (and the
card's name and power limit); on `--device cpu` the wrapper runs its plain
version and the times are the host's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from promptir_tpu_torch.tools.trace import (
    device_record,
    resolve_device,
    time_ms,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNELS = ("mdta_stats", "mdta_gram", "block_tail", "ln_gdfn", "ln_mdta",
           "seam", "tail_stats")


def bound_ms(ops, nbytes, dtype) -> tuple[float, str]:
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def block_work(shape, nbytes, batch):
    """(operations, bytes) of the stats and tail functions at one shape:
    each input read once, each output written once."""
    h, w, c, heads = shape
    d, f, px = c // heads, int(c * 2.66), batch * h * w
    st_ops = 2 * px * (3 * c * c + 27 * c + d * c + 2 * c) + 8 * px * c
    st_bytes = nbytes * (2 * px * c + 3 * c * c + 27 * c + 2 * c) \
        + 4 * batch * heads * (d * d + 2 * d)
    tl_ops = 2 * px * (d * c + c * c + 2 * f * c + 18 * f + f * c) \
        + px * (8 * c + 10 * f)
    tl_bytes = nbytes * (3 * px * c + c * c + 2 * c + 2 * f * c + 18 * f
                         + f * c) + 4 * batch * heads * d * d
    return (st_ops, st_bytes), (tl_ops, tl_bytes)


def gdfn_work(shape, nbytes, batch):
    """(operations, bytes) of ln_gdfn at one shape: the JAX kernel's cost
    estimate (promptir_tpu/ops/pallas/gdfn.py:584) for the operations; x
    read, out written and each weight read once for the bytes."""
    h, w, c, _ = shape
    f, px = int(c * 2.66), batch * h * w
    ops = 2 * px * (c * 2 * f + f * c) + 18 * px * 2 * f
    return ops, nbytes * (2 * px * c + 2 * c + 2 * f * c + 18 * f + f * c)


def apply_work(shape, nbytes, batch):
    """(operations, bytes) of the apply kernel (ln_mdta) at one shape: attn v
    and the projection, 2dC + 2C^2 operations a pixel, and the residual; v
    and x read, x2 written, W_proj and the fp32 attention read once."""
    h, w, c, heads = shape
    d, px = c // heads, batch * h * w
    ops = 2 * px * (d * c + c * c) + px * c
    return ops, nbytes * (3 * px * c + c * c) + 4 * batch * heads * d * d


def pair_work(shape, nbytes, batch):
    """(operations, bytes) of tail_stats at one shape: block n's tail and
    block n+1's stats pass, where n's output x3 feeds n+1 without being
    read back (one px * C read less than the two functions apart)."""
    h, w, c, _ = shape
    (so, sb), (to, tb) = block_work(shape, nbytes, batch)
    return so + to, sb + tb - nbytes * batch * h * w * c


def gram_work(shape, nbytes, batch):
    """(operations, bytes) of the Gram stage: q and k read, the fp32 d x d
    sums written."""
    h, w, c, heads = shape
    d, px = c // heads, h * w
    return (2 * batch * heads * d * d * px,
            2 * batch * px * c * nbytes + 4 * batch * heads * d * d)


def seam_work(shape, nbytes, batch):
    """(operations, bytes) of the seam at the skip's shape (B, H, W, 48):
    y (B, H/2, W/2, 192) and the skip read, the concatenation written."""
    h, w, c, _ = shape
    skip = batch * h * w * c
    return 0, nbytes * (skip + skip + 2 * skip)


def block_inputs(shape, dtype, gen, batch, device="cuda"):
    """A block's input x (B, H, W, C) and weights at `shape` (H, W, C,
    heads), drawn from `gen`."""
    h, w, c, heads = shape
    f = int(c * 2.66)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=device) * scale).to(dtype)

    return dict(
        x=r(batch, h, w, c), ln1w=1 + r(c, scale=0.1), ln1b=r(c, scale=0.1),
        wqkv=r(3 * c, c, scale=c ** -0.5), wdw=r(3 * c, 9, scale=0.3),
        temp=1 + r(heads, 1, 1, scale=0.2).float(),
        wproj=r(c, c, scale=c ** -0.5), ln2w=1 + r(c, scale=0.1),
        ln2b=r(c, scale=0.1), w1=r(2 * f, c, scale=c ** -0.5),
        wdwf=r(2 * f, 9, scale=0.3), w2=r(c, f, scale=f ** -0.5),
        heads=heads,
    )


def seam_inputs(h, w, dtype, gen, batch, device="cuda"):
    """up2_1's conv output (B, h/2, w/2, 192) and the enc1 skip (B, h, w, 48)."""
    y = torch.randn(batch, h // 2, w // 2, 192, generator=gen,
                    device=device).to(dtype)
    skip = torch.randn(batch, h, w, 48, generator=gen, device=device).to(dtype)
    return y, skip


def run_stats(fn, a):
    return fn(a["x"], a["ln1w"], a["ln1b"], a["wqkv"], a["wdw"], a["heads"])


def run_tail(fn, a, v, attn):
    return fn(v, a["x"], attn, a["wproj"], a["ln2w"], a["ln2b"], a["w1"],
              a["wdwf"], a["w2"])


def run_ln_gdfn(fn, a):
    return fn(a["x"], a["ln2w"], a["ln2b"], a["w1"], a["wdwf"], a["w2"])


def run_apply(fn, a, v, attn):
    return fn(v, a["x"], attn, a["wproj"])


def run_tail_stats(fn, a, a2, v, attn):
    """Block n's tail (inputs and weights a) with block n+1's stats pass
    (weights a2)."""
    return fn(v, a["x"], attn, a["wproj"], a["ln2w"], a["ln2b"], a["w1"],
              a["wdwf"], a["w2"], a2["ln1w"], a2["ln1b"], a2["wqkv"],
              a2["wdw"], a2["heads"])


def calls(op, shape, batch, dtype, device, gen):
    """(kernel fn, plain fn, library fn or None, (operations, bytes))."""
    from promptir_tpu_torch.ops.cuda import block, gdfn, mdta, megablock, seam

    nb = torch.finfo(dtype).bits // 8
    if op == "seam":
        y, skip = seam_inputs(shape[0], shape[1], dtype, gen, batch, device)
        yc, sc = y.permute(0, 3, 1, 2), skip.permute(0, 3, 1, 2)
        return (lambda: seam.seam(y, skip), lambda: seam.seam_plain(y, skip),
                lambda: torch.cat([F.pixel_shuffle(yc, 2), sc], 1),
                seam_work(shape, nb, batch))
    a = block_inputs(shape, dtype, gen, batch, device)
    v, st = run_stats(mdta.mdta_stats_plain, a)
    attn = mdta.attn_from_stats(st, a["temp"])
    stats_w, tail_w = block_work(shape, nb, batch)
    if op == "mdta_stats":
        return (lambda: run_stats(mdta.mdta_stats, a),
                lambda: run_stats(mdta.mdta_stats_plain, a), None, stats_w)
    if op == "mdta_gram":
        heads = shape[3]
        _, q, k, _ = mdta.stats_pass_plain(a["x"], a["ln1w"], a["ln1b"],
                                           a["wqkv"], a["wdw"], heads)
        d, px = shape[2] // heads, shape[0] * shape[1]
        qh = q.reshape(batch, px, heads, d).permute(0, 2, 3, 1)
        kh = k.reshape(batch, px, heads, d).permute(0, 2, 1, 3)
        return (lambda: mdta.mdta_gram(q, k, heads),
                lambda: mdta.mdta_gram_plain(q, k, heads),
                lambda: torch.matmul(qh, kh), gram_work(shape, nb, batch))
    if op == "block_tail":
        return (lambda: run_tail(block.block_tail, a, v, attn),
                lambda: run_tail(block.block_tail_plain, a, v, attn), None,
                tail_w)
    if op == "ln_gdfn":
        return (lambda: run_ln_gdfn(gdfn.ln_gdfn, a),
                lambda: run_ln_gdfn(gdfn.ln_gdfn_plain, a), None,
                gdfn_work(shape, nb, batch))
    if op == "ln_mdta":
        return (lambda: run_apply(mdta.mdta_apply, a, v, attn),
                lambda: run_apply(mdta.mdta_apply_plain, a, v, attn), None,
                apply_work(shape, nb, batch))
    a2 = block_inputs(shape, dtype, gen, 1, device)
    return (lambda: run_tail_stats(megablock.tail_stats, a, a2, v, attn),
            lambda: run_tail_stats(megablock.tail_stats_plain, a, a2, v, attn),
            None, pair_work(shape, nb, batch))


def host_ms(fn, reps, warmup) -> float:
    """The mean host time of fn() (the CPU's plain versions)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="time one kernel at one shape")
    p.add_argument("--op", choices=KERNELS, default="block_tail")
    p.add_argument("--shape", type=int, nargs=4, default=[4, 256, 256, 48],
                   metavar=("B", "H", "W", "C"))
    p.add_argument("--heads", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    b, h, w, c = args.shape
    shape = (h, w, c, args.heads)
    gen = torch.Generator(device=device).manual_seed(1)
    kernel, plain, library, (ops, nbytes) = calls(args.op, shape, b, dtype,
                                                   device, gen)
    if device.type == "cuda":
        def timed(fn):
            return time_ms(fn, reps=args.reps, warmup=args.warmup)
    else:
        def timed(fn):
            return host_ms(fn, args.reps, args.warmup)
    ms = timed(kernel)
    bound, by = bound_ms(ops, nbytes, dtype)
    line = {"tool": "kbench", **device_record(device), "op": args.op,
            "shape": [b, h, w, c], "heads": args.heads, "dtype": args.dtype,
            "ms": ms, "plain_ms": timed(plain),
            "library_ms": None if library is None else timed(library),
            "bound_ms": bound, "bound_by": by, "operations": ops,
            "bytes": nbytes, "reps": args.reps}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
