#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each printed with the seconds since start:
  1. the card's name and power limit (nvidia-smi);
  2. one nvcc build of every kernel source, with ptxas register and shared
     memory use;
  3. each kernel against its plain PyTorch version on the card, at every
     shape a batch-4 forward of the serving run's 256x256 and 256x192
     buckets gives it, in float32 (TF32 off) and bfloat16; the seam
     bit-exact;
  4. the reference PromptIR's own 64 px output (tests/goldens/
     promptir_full.npz) reproduced in float32 through the kernels;
  5. full-width, full-depth PromptIR (random weights from a seed, bf16)
     serving eight requests through the port's engine, with the kernels'
     launch counts read around that run;
  6. each kernel timed with CUDA events beside its plain version, the one
     PyTorch call that computes the same function where there is one, and
     its bound.
It ends with one JSON line of kernel records and, as the last line, the
device record. Any failure raises and exits non-zero before those lines.
Imports torch, numpy, the standard library and promptir_tpu_torch only.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

BUCKETS = [(256, 256), (256, 192)]  # the serving run's padded sizes


def block_shapes(h, w):
    """(H, W, C, heads) of the 47 TransformerBlocks of an h x w forward,
    with how many blocks run at each."""
    return [
        ((h, w, 48, 1), 4),                  # encoder_level1
        ((h // 2, w // 2, 96, 2), 12),       # encoder_level2, decoder_level2
        ((h // 4, w // 4, 192, 4), 12),      # encoder_level3, decoder_level3
        ((h // 8, w // 8, 384, 8), 8),       # latent
        ((h // 8, w // 8, 704, 4), 1),       # noise_level3
        ((h // 4, w // 4, 320, 4), 1),       # noise_level2
        ((h // 2, w // 2, 160, 4), 1),       # noise_level1
        ((h, w, 96, 1), 8),                  # decoder_level1, refinement
    ]


BATCH = 4
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max |kernel - plain| / max |plain|
GOLDEN_TOL = 2e-4


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


# ------------------------------------------------------------------ setup

def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def import_port():
    sys.path.insert(0, str(ROOT))
    import promptir_tpu_torch

    if pathlib.Path(promptir_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("promptir_tpu_torch does not come from this checkout")
    from promptir_tpu_torch.ops.cuda import block, build, mdta, seam

    return promptir_tpu_torch, build, mdta, block, seam


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


def block_inputs(shape, dtype, gen):
    h, w, c, heads = shape
    f = int(c * 2.66)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dtype)

    return dict(
        x=r(BATCH, h, w, c), ln1w=1 + r(c, scale=0.1), ln1b=r(c, scale=0.1),
        wqkv=r(3 * c, c, scale=c ** -0.5), wdw=r(3 * c, 9, scale=0.3),
        temp=1 + r(heads, 1, 1, scale=0.2).float(),
        wproj=r(c, c, scale=c ** -0.5), ln2w=1 + r(c, scale=0.1),
        ln2b=r(c, scale=0.1), w1=r(2 * f, c, scale=c ** -0.5),
        wdwf=r(2 * f, 9, scale=0.3), w2=r(c, f, scale=f ** -0.5),
        heads=heads,
    )


def run_stats(fn, a):
    return fn(a["x"], a["ln1w"], a["ln1b"], a["wqkv"], a["wdw"], a["heads"])


def run_tail(fn, a, v, attn):
    return fn(v, a["x"], attn, a["wproj"], a["ln2w"], a["ln2b"], a["w1"],
              a["wdwf"], a["w2"])


def seam_inputs(h, w, dtype, gen):
    """up2_1's conv output (B, h/2, w/2, 192) and the enc1 skip (B, h, w, 48)."""
    y = torch.randn(BATCH, h // 2, w // 2, 192, generator=gen,
                    device="cuda").to(dtype)
    skip = torch.randn(BATCH, h, w, 48, generator=gen, device="cuda").to(dtype)
    return y, skip


# ------------------------------------------------------------ phase 3

def check_kernels(mdta, block, seam):
    gen = torch.Generator(device="cuda").manual_seed(0)
    # per kernel and dtype: [max |kernel - plain|, that over max |plain|]
    worst = {k: {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
             for k in ("mdta_stats", "block_tail", "seam")}
    for dtype, (bh, bw) in [(d, b) for d in (torch.float32, torch.bfloat16)
                            for b in BUCKETS]:
        for shape, _ in block_shapes(bh, bw):
            a = block_inputs(shape, dtype, gen)
            v, st = run_stats(mdta.mdta_stats, a)
            v0, st0 = run_stats(mdta.mdta_stats_plain, a)
            torch.cuda.synchronize()
            ev, rv = rel_err(v, v0)
            es, rs = rel_err(st, st0)
            attn = mdta.attn_from_stats(st0, a["temp"])
            out = run_tail(block.block_tail, a, v0, attn)
            out0 = run_tail(block.block_tail_plain, a, v0, attn)
            torch.cuda.synchronize()
            et, rtl = rel_err(out, out0)
            say(f"check {str(dtype)[6:]:8s} B{BATCH} {shape}: mdta_stats v "
                f"{ev:.2e} (rel {rv:.2e}) stats {es:.2e} (rel {rs:.2e}); "
                f"block_tail {et:.2e} (rel {rtl:.2e})")
            if max(rv, rs) > TOL[dtype] or rtl > TOL[dtype]:
                fail(f"kernel disagrees with its plain version at {shape} "
                     f"{dtype} (tolerance {TOL[dtype]} of max |plain|)")
            if not (torch.isfinite(out).all() and torch.isfinite(v).all()):
                fail(f"non-finite kernel output at {shape} {dtype}")
            for name, e, r in (("mdta_stats", ev, rv), ("mdta_stats", es, rs),
                               ("block_tail", et, rtl)):
                w = worst[name][dtype]
                w[0], w[1] = max(w[0], e), max(w[1], r)
        y, skip = seam_inputs(bh, bw, dtype, gen)
        out = seam.seam(y, skip)
        torch.cuda.synchronize()
        if not torch.equal(out, seam.seam_plain(y, skip)):
            fail(f"seam is not bit-exact in {dtype}")
        say(f"check {str(dtype)[6:]:8s} seam {tuple(y.shape)} + "
            f"{tuple(skip.shape)}: bit-exact")
    return worst


# ------------------------------------------------------------ phase 4

def check_golden(port, counters):
    data = np.load(ROOT / "tests" / "goldens" / "promptir_full.npz")
    sd = {k[4:]: torch.from_numpy(data[k].astype(np.float32))
          for k in data.files if k.startswith("sd::")}
    model = port.create_model("promptir", device="cuda")
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(data["x"]).cuda()
    before = counters()
    with torch.inference_mode():
        y = model(x)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(counters(), before)]
    err = (y.cpu() - torch.from_numpy(data["y"])).abs().max().item()
    say(f"golden promptir_full (548 tensors, {tuple(x.shape)}, fp32, TF32 "
        f"off): max |err| {err:.3e} (tolerance {GOLDEN_TOL}); launches "
        f"stats/tail/seam {ran}")
    if ran != [47, 47, 1]:
        fail(f"golden forward did not run through the kernels: {ran}")
    if not err <= GOLDEN_TOL:
        fail(f"golden output off by {err:.3e} > {GOLDEN_TOL}")
    del model
    return err


# ------------------------------------------------------------ phase 5

def serve(port, counters, reset, card):
    from promptir_tpu_torch.serve.engine import InferenceEngine

    torch.manual_seed(0)
    model = port.create_model("promptir", device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    sizes = [(256, 256)] * 6 + [(250, 190)] * 2
    imgs = [rng.random((h, w, 3), dtype=np.float32) for h, w in sizes]
    eng = InferenceEngine(model, max_batch=4, pad_base=8, batch_timeout_ms=50)
    try:
        # warm-up: one forward per bucket (cuDNN plans, allocator)
        for f in [eng.submit(imgs[0]), eng.submit(imgs[-1])]:
            f.result(timeout=600)
        batches0 = eng.stats()["batches"]
        reset()
        done = {}
        t_start = time.perf_counter()
        futs = []
        for i, im in enumerate(imgs):
            f = eng.submit(im)
            f.add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append((f, time.perf_counter()))
        outs = [f.result(timeout=600) for f, _ in futs]
        t_end = max(done.values())
        ran = counters()
        batches = eng.stats()["batches"] - batches0
    finally:
        eng.close(join_timeout_s=60)
    for im, out in zip(imgs, outs):
        if out.shape != im.shape or not np.isfinite(out).all():
            fail(f"bad reply {out.shape} for a {im.shape} request")
        if out.min() < 0.0 or out.max() > 1.0:
            fail("reply outside [0, 1]")
    lat = sorted(done[i] - t for i, (_, t) in enumerate(futs))
    p50 = float(np.median(lat))
    ips = len(imgs) / (t_end - t_start)
    say(f"serve: full-depth promptir bf16, 8 requests (6x 256x256, 2x "
        f"250x190) in {batches} batches of max 4; p50 latency {p50 * 1e3:.1f}"
        f" ms, {ips:.2f} images/s on {card}; launches stats/tail/seam {ran}")
    if ran != [47 * batches, 47 * batches, batches]:
        fail(f"serving launches {ran} != 47/47/1 per forward x {batches}")
    return ran


# ------------------------------------------------------------ phase 6

def time_ms(fn, reps=20, warmup=3) -> float:
    """Median of `reps` CUDA-event timings of fn() (after a warm-up)."""
    for _ in range(warmup):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def block_work(shape, nbytes):
    """(operations, bytes) of the stats and tail functions at one shape:
    each input read once, each output written once."""
    h, w, c, heads = shape
    d, f, px = c // heads, int(c * 2.66), BATCH * h * w
    st_ops = 2 * px * (3 * c * c + 27 * c + d * c + 2 * c) + 8 * px * c
    st_bytes = nbytes * (2 * px * c + 3 * c * c + 27 * c + 2 * c) \
        + 4 * BATCH * heads * (d * d + 2 * d)
    tl_ops = 2 * px * (d * c + c * c + 2 * f * c + 18 * f + f * c) \
        + px * (8 * c + 10 * f)
    tl_bytes = nbytes * (3 * px * c + c * c + 2 * c + 2 * f * c + 18 * f
                         + f * c) + 4 * BATCH * heads * d * d
    return (st_ops, st_bytes), (tl_ops, tl_bytes)


def bound_ms(ops, nbytes, dtype) -> tuple[float, str]:
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def time_kernels(mdta, block, seam, reset):
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    tot = {k: dict(ms=0.0, plain_ms=0.0, ops=0, bytes=0)
           for k in ("mdta_stats", "block_tail")}
    for shape, n in block_shapes(*BUCKETS[0]):
        a = block_inputs(shape, dtype, gen)
        v, st = run_stats(mdta.mdta_stats, a)
        attn = mdta.attn_from_stats(st, a["temp"])
        times = {
            "mdta_stats": (time_ms(lambda: run_stats(mdta.mdta_stats, a)),
                           time_ms(lambda: run_stats(mdta.mdta_stats_plain, a))),
            "block_tail": (time_ms(lambda: run_tail(block.block_tail, a, v, attn)),
                           time_ms(lambda: run_tail(block.block_tail_plain, a, v,
                                                    attn))),
        }
        work = dict(zip(("mdta_stats", "block_tail"), block_work(shape, 2)))
        for k, (ms, pms) in times.items():
            b, by = bound_ms(*work[k], dtype)
            say(f"time {k:10s} B{BATCH} {shape} bf16: {ms:.3f} ms (plain "
                f"{pms:.3f} ms, bound {b:.4f} ms by {by}) x{n} per forward")
            tot[k]["ms"] += n * ms
            tot[k]["plain_ms"] += n * pms
            tot[k]["ops"] += n * work[k][0]
            tot[k]["bytes"] += n * work[k][1]
    split = sum(n * BATCH * h * w * 2 * (2 * int(c * 2.66) + c) * 2
                for (h, w, c, _), n in block_shapes(*BUCKETS[0]))
    say(f"block_tail split at the hidden tensor: h and x2 written and read "
        f"back add {split / 1e9:.2f} GB per forward "
        f"({split / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s)")
    y, skip = seam_inputs(*BUCKETS[0], dtype, gen)
    yc = y.permute(0, 3, 1, 2)  # NCHW views (channels_last) for the library call
    sc = skip.permute(0, 3, 1, 2)
    seam_rec = dict(
        ms=time_ms(lambda: seam.seam(y, skip)),
        plain_ms=time_ms(lambda: seam.seam_plain(y, skip)),
        library_ms=time_ms(lambda: torch.cat([F.pixel_shuffle(yc, 2), sc], 1)),
        ops=0, bytes=2 * (y.numel() + skip.numel() + 2 * skip.numel()),
    )
    reset()  # the timing launches are not the main path's
    recs = {}
    for k, t in list(tot.items()) + [("seam", seam_rec)]:
        b, by = bound_ms(t["ops"], t["bytes"], dtype)
        recs[k] = dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b,
                       bound_by=by, library_ms=t.get("library_ms"))
        lib = t.get("library_ms")
        say(f"time {k:10s} per forward (B{BATCH} 256x256 bf16): {t['ms']:.3f} ms"
            f", plain {t['plain_ms']:.3f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.3f} ms'}, bound {b:.4f} ms "
            f"by {by}")
    return recs


# ------------------------------------------------------------------ main

def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(3)
    port, build, mdta, block, seam = import_port()
    if not (ROOT / "tests" / "goldens" / "promptir_full.npz").exists():
        fail("tests/goldens/promptir_full.npz is missing")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    so = build.build()
    say(f"build: {so.name} in {build.build_seconds or 0.0:.1f} s (one nvcc "
        "call over csrc/*.cu)")
    for line in (build.build_log or "").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("    " + line.strip(), flush=True)
    build.lib()

    kernels = (mdta.mdta_stats, block.block_tail, seam.seam)

    def counters():
        return [k.launches for k in kernels]

    def reset():
        for k in kernels:
            k.launches = 0

    worst = check_kernels(mdta, block, seam)
    check_golden(port, counters)
    reset()
    launches = serve(port, counters, reset, card)
    recs = time_kernels(mdta, block, seam, reset)

    replaces = {
        "mdta_stats": ("promptir_tpu_torch/csrc/mdta_stats.cu",
                       "promptir_tpu/ops/pallas/mdta.py:317"),
        "block_tail": ("promptir_tpu_torch/csrc/block_tail.cu",
                       "promptir_tpu/ops/pallas/block.py:158"),
        "seam": ("promptir_tpu_torch/csrc/seam.cu",
                 "promptir_tpu/ops/pallas/seam.py:222"),
    }
    out = []
    for (name, (src, rep)), n in zip(replaces.items(), launches):
        r = recs[name]
        out.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=n,
            max_abs_err=worst[name][torch.float32][0],
            max_rel_err=worst[name][torch.float32][1],
            max_abs_err_bf16=worst[name][torch.bfloat16][0],
            max_rel_err_bf16=worst[name][torch.bfloat16][1],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    say(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
