"""Serving: photographs offered to the port's engine at a fixed rate.

The traffic file (traffic/*.json, "driver": "serve") gives the rate, the
image sizes, the noise levels, the engine's settings, the size of the
sample that the check compares and the length of the traced slice. The
load is an open loop: request i is due at a time fixed before the window,
and is submitted then whether or not earlier ones have come back. Every
seed gets the same inter-arrival gaps in each second of the window (the
quantiles of an exponential distribution at the rate, so that arrivals
bunch and thin as Poisson arrivals do), the same sizes in equal shares in
each second, and the same number of each pool image, in an order drawn
from the seed. Images come from a pool of noisy
photographs made on the device in set-up.

The window runs `seconds`. A request's latency runs from when it was due
to when its reply resolved, so a stall of the submitting thread counts
against the requests it delays. Replies of requests due in the window
are waited for (up to `drain_s`) once it has closed. The engine's batch
call is timed on the host's clock and its FLOPs counted (`_Batches`), for
the share of the card's peak that a served batch reaches.

With `trace`, two further slices of `profile_seconds` of the same
traffic run under torch.profiler after the unprofiled window: the first
records the device alone, the second also the host's ops on every thread,
with a range around each transformer block (the configuration's `blocks`
entry).

The check: a sample of the window's requests, drawn from the seed, is
restored again by the plain float32 reference from the same input, with
the same reflect padding, crop and clip, and compared pixel by pixel with
the reply.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from port_bench import common, spans
from port_bench.counts.flops import padded_flops
from port_bench.reference.precision import exact_float32, products_in


def _arrivals(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """n due times (seconds from the window's start, the first at 0). Each
    second's worth of requests (m = rate of them) takes the same m gaps,
    the exponential quantiles at the mid-points of m equal shares scaled to
    a mean of 1 / rate, in an order drawn from the seed: arrivals bunch and
    thin within each second as Poisson arrivals do, and every second offers
    the same load."""
    m = max(1, int(round(rate)))
    base = -np.log(1.0 - (np.arange(m) + 0.5) / m)
    base = base / base.mean() / rate
    gaps = np.concatenate([base[rng.permutation(m)]
                           for _ in range(-(-n // m))])[:n]
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def _pad_reflect(img: np.ndarray, base: int) -> np.ndarray:
    h, w = img.shape[:2]
    th, tw = -(-h // base) * base, -(-w // base) * base
    return np.pad(img, ((0, th - h), (0, tw - w), (0, 0)), mode="reflect")


class _Fault:
    """The faults the tests plant under the engine's model, where its
    output is produced: "answer_altered" adds 0.2 to an 8 x 8 corner of
    every image; "half_batch" leaves every other image of the batch out
    and returns it unrestored (a batch of two or more requests shows it)."""

    def __init__(self, model, kind):
        self.kind, self.real = kind, model.forward
        model.forward = self

    def __call__(self, x):
        if self.kind == "answer_altered":
            y = self.real(x).clone()
            y[:, :, :8, :8] += 0.2
            return y
        if self.kind == "half_batch":
            y = self.real(x).clone()
            y[1::2] = x[1::2].float()
            return y
        raise ValueError(f"unknown fault {self.kind!r}")


class _Batches:
    """Times the engine's batch call (serve/engine.py:_forward: pad, copy
    in, forward, copy out) on the host's clock, and counts the model FLOPs
    it runs: the whole padded batch at its padded shape."""

    def __init__(self, engine, cfg):
        self.real, self.cfg = engine._forward, cfg
        engine._forward = self
        self.n, self.s, self.flops = 0, 0.0, 0

    def __call__(self, group):
        t = time.perf_counter()
        y = self.real(group)
        dt = time.perf_counter() - t
        b, h, w = y.shape[:3]
        self.n, self.s = self.n + 1, self.s + dt
        self.flops += b * padded_flops(self.cfg, (h, w))
        return y

    def read(self):
        return self.n, self.s, self.flops


def _offer(engine, schedule, images, keep, out, t0):
    """Submit images[i] at t0 + schedule[i]; out[i] = (due, done or None,
    error or None); keep: indices whose futures are kept in out["futures"]."""
    lock = threading.Lock()
    late = []

    def finished(i, due, fut):
        now = time.perf_counter()
        err = fut.exception()
        with lock:
            out[i] = (due, now, None if err is None else repr(err))

    for i, at in enumerate(schedule):
        due = t0 + at
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - due)
        try:
            fut = engine.submit(images[i])
        except Exception as e:  # shed by the engine: a failed request
            with lock:
                out[i] = (due, None, repr(e))
            continue
        if i in keep:
            out["futures"][i] = fut
        fut.add_done_callback(lambda f, i=i, due=due: finished(i, due, f))
    return late


def _wait(out, n, deadline):
    while time.perf_counter() < deadline:
        if sum(1 for i in range(n) if i in out) == n:
            return
        time.sleep(0.01)


def run(cell, seed, seconds, trace, device, fault=None, control=False):
    cfg, tr = cell["config"], cell["traffic"]
    log = []
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)

    t_setup = time.perf_counter()
    model = common.port_model(cfg, seed, device, train=False)
    log.append(f"set-up: model and weights {time.perf_counter() - t_setup:.3f} s")
    if fault:
        _Fault(model, fault)
    from promptir_tpu_torch.serve.engine import InferenceEngine

    eng_cfg = tr["engine"]
    engine = InferenceEngine(model, pad_base=cfg["pad_base"], **eng_cfg)
    timed = _Batches(engine, cfg)
    sizes = [tuple(s) for s in tr["sizes"]]
    h, w = sizes[0]
    n_clean = tr["pool_clean"]
    sigmas = tr["sigmas"]
    clean = common.photographs(n_clean, h, w, gen, device)
    noisy = common.add_noise(clean.repeat(len(sigmas), 1, 1, 1),
                             [s for s in sigmas for _ in range(n_clean)], gen)
    pool = noisy.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    del clean, noisy

    def image(k, size):
        img = pool[k]
        return img if tuple(img.shape[:2]) == size else \
            np.ascontiguousarray(img.transpose(1, 0, 2))

    rate = float(tr["rate_per_s"])
    n = int(round(rate * seconds))
    sched = _arrivals(rate, n, rng)
    per_s = max(1, int(round(rate)))
    which = common.balanced(list(range(len(pool))), n, rng)
    shape = common.balanced(sizes, n, rng, block=per_s)
    sample = set(rng.choice(n, size=min(tr["sample"], n), replace=False)
                 .tolist())
    n_prof = int(round(rate * tr["profile_seconds"])) if trace else 0
    which += common.balanced(list(range(len(pool))), 2 * n_prof, rng)
    shape += common.balanced(sizes, 2 * n_prof, rng)
    images = [image(k, s) for k, s in zip(which, shape)]

    for size in sizes:  # counted here, not on the engine's thread
        padded_flops(cfg, size)
    for size in sizes:  # warm-up: the cell's two buckets, twice each
        for _ in range(2):
            engine.restore_many([image(0, size)] * eng_cfg["max_batch"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.append(f"set-up: pool and warm-up done at "
               f"{time.perf_counter() - t_setup:.3f} s")
    base = timed.read()

    out = {"futures": {}}
    t0 = time.perf_counter()
    late = _offer(engine, sched, images[:n], sample, out, t0)
    t_end = t0 + seconds
    wait = t_end - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    batches, batch_s, batch_flops = (
        a - b for a, b in zip(timed.read(), base))
    _wait(out, n, time.perf_counter() + tr["drain_s"])
    in_window = sum(1 for i in range(n) if i in out and out[i][1] is not None
                    and out[i][2] is None and out[i][1] <= t_end)

    prof = None
    if trace:
        from port_bench.trace import profiled, ranges_on

        def offer_slice(imgs):
            got = {"futures": {}}
            _offer(engine, _arrivals(rate, len(imgs), rng), imgs, set(), got,
                   time.perf_counter())
            _wait(got, len(imgs), time.perf_counter() + tr["drain_s"])

        # the device alone first (the profiler's least host cost), then the
        # host's ranges around each block
        with profiled(host=False) as dev:
            offer_slice(images[n:n + n_prof])
        counter = spans.BlockCounter(cfg)
        with ranges_on(counter.patches()), profiled(host=True) as host:
            offer_slice(images[n + n_prof:])
        prof = {"device": dev, "host": host, "blocks": counter}

    engine.close()
    # a request that failed or never came back counts as missing any limit
    lat = [(out[i][1] - out[i][0]) * 1e3
           if i in out and out[i][1] is not None and out[i][2] is None
           else float("inf") for i in range(n)]
    failed = sum(1 for v in lat if v == float("inf"))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    log.append(f"window: {n} requests due at {rate}/s over {seconds} s, "
               f"{in_window} replies inside it, {failed} failed; generator "
               f"late p50 {np.median(late) * 1e3:.3f} ms max "
               f"{max(late) * 1e3:.3f} ms; {batches} batches, "
               f"{batch_s * 1e3 / max(1, batches):.3f} ms a batch call")
    replies = {i: out["futures"][i] for i in sample if i in out["futures"]}
    del engine, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, control_checks = _check(cfg, seed, device, images, replies, sample,
                                    control)
    res = {
        "t_window": t0,
        "attempted": n,
        "failed": failed,
        "e2e": {"serve_p95_ms": common.nearest_rank(lat, 95)},
        "replies_per_s": in_window / seconds,
        "ctx": {
            "kind": "serve",
            "batch_s": batch_s,
            "batch_flops": batch_flops,
            "profile": prof,
        },
        "checks": checks,
        "control_checks": control_checks,
        "memory_peak_bytes": peak,
        "log": log,
    }
    return res


@torch.no_grad()
def _restore(ref, img, base, device):
    h, w = img.shape[:2]
    x = torch.from_numpy(_pad_reflect(img, base)).to(device)
    y = ref(x.permute(2, 0, 1)[None].contiguous())
    return y[0, :, :h, :w].clamp(0, 1).permute(1, 2, 0)


def _gaps(a, b):
    d = (a - b).abs()
    return d.max().item(), d.square().mean().sqrt().item()


def _check(cfg, seed, device, images, replies, sample, control):
    """(checks, control checks): the widest pixel gap and the worst
    reply's RMS gap between the sampled replies and the reference's
    restorations; with `control`, the same two between the reference
    computed with fp8 products and in float32. A sampled request with no
    reply reads inf."""
    ref = common.reference_model(cfg, seed, device)
    worst = {"reply_max_abs": 0.0, "reply_rms": 0.0}
    ctrl = {"reply_max_abs": 0.0, "reply_rms": 0.0} if control else None
    with exact_float32():
        for i in sorted(sample):
            want = _restore(ref, images[i], cfg["pad_base"], device)
            fut = replies.get(i)
            if fut is None or fut.exception() is not None:
                worst = {k: float("inf") for k in worst}
                continue
            got = torch.from_numpy(fut.result()).to(device)
            mx, rms = _gaps(got, want)
            worst["reply_max_abs"] = max(worst["reply_max_abs"], mx)
            worst["reply_rms"] = max(worst["reply_rms"], rms)
            if control:
                with products_in("fp8"):
                    low = _restore(ref, images[i], cfg["pad_base"], device)
                mx, rms = _gaps(low, want)
                ctrl["reply_max_abs"] = max(ctrl["reply_max_abs"], mx)
                ctrl["reply_rms"] = max(ctrl["reply_rms"], rms)
    return worst, ctrl
