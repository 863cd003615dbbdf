"""Training: the port's training step on seeded (degraded, clean) pairs.

The traffic file (traffic/*.json, "driver": "train") gives the batch, the
patch size, the mix of degradations (noise levels, and the hazy rows of a
batch), the optimizer's settings, the size of the pool of batches, the steps of set-up and the steps each of the two traced
slices profiles (the device alone, then the host's ops and ranges too). Set-up builds one TrainState (the port's model with float32
master weights computing in the configuration's dtype, AdamW) and one step
(`train/step.py:make_train_step`), and drives that same step object
through its first `check_steps` steps on the pool's first batches, then
`warmup_steps` more; the window then calls it on the pool's batches in
turn (a pool on the device, cycled without waiting on the card) until
`seconds` have passed on the host's clock, and closes at a synchronize
after the last step. The rate is the images of every step launched over
the window's whole time.

The check follows the first `check_steps` steps with the plain float32
reference (its own forward, L1 loss, backward and a hand-written AdamW
with the same settings), from the same initial weights and on the same
batches, and reads (`_compare`): the loss gaps; each leaf's step-1
gradient, the program's read from AdamW's first moment after one step
(exp_avg / (1 - beta1)), by its norm and by its difference from the
reference's; each leaf's change over the steps. Leaves whose reference
gradient is under a thousandth of the median leaf's (the dead
convolutions, which only weight decay moves) are left out of the change
and the difference. The cell's limits file names the numbers compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench import common, spans
from port_bench.counts.flops import padded_flops
from port_bench.reference.precision import exact_float32, products_in

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _pool(tr, seed, device):
    """`pool_batches` (degraded, clean) batches, each (B, H, W, 3), of the
    all-in-one mix in blocks of rows: the first B - `haze_rows` rows noisy
    at the noise levels in equal shares (in an order drawn from the seed),
    the last `haze_rows` hazy. A step that saw half of its batch would see
    one degradation alone, so its gradients read apart from the whole
    batch's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    b, (h, w) = tr["batch"], tr["patch"]
    n_haze = tr["haze_rows"]
    n = tr["pool_batches"] * b
    clean = common.photographs(n, h, w, gen, device).view(-1, b, 3, h, w)
    noisy = clean[:, :b - n_haze].reshape(-1, 3, h, w)
    sigmas = common.balanced(tr["sigmas"], noisy.shape[0], rng, block=b - n_haze)
    noisy = common.add_noise(noisy, sigmas, gen).view(-1, b - n_haze, 3, h, w)
    hazy = common.add_haze(clean[:, b - n_haze:].reshape(-1, 3, h, w), gen)
    degraded = torch.cat([noisy, hazy.view(-1, n_haze, 3, h, w)], dim=1)
    nhwc = [t.permute(0, 1, 3, 4, 2).contiguous() for t in (degraded, clean)]
    return [{"degraded": nhwc[0][i], "clean": nhwc[1][i]}
            for i in range(tr["pool_batches"])]


def _norms(named) -> dict:
    """{name: float norm} of (name, tensor) pairs, read in one copy."""
    names, ts = zip(*named)
    v = torch.stack([t.detach().float().norm() for t in ts]).cpu().tolist()
    return dict(zip(names, v))


class _Fault:
    """The faults the tests plant in the training step: "unchanged" (the
    update leaves the state as it was), "half_batch" (the step sees the
    first half of the batch, its loss the mean over it)."""

    def __init__(self, kind, state, step):
        self.kind, self.step = kind, step
        if kind == "unchanged":
            state.optimizer.step = lambda *a, **k: None
        elif kind != "half_batch":
            raise ValueError(f"unknown fault {kind!r}")

    def __call__(self, state, batch):
        if self.kind == "half_batch":
            half = batch["degraded"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        return self.step(state, batch)


def run(cell, seed, seconds, trace, device, fault=None, control=False):
    cfg, tr = cell["config"], cell["traffic"]
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    log = []
    t_setup = time.perf_counter()
    model = common.port_model(cfg, seed, device, train=True)
    log.append(f"set-up: model and weights {time.perf_counter() - t_setup:.3f} s")
    state = TrainState(model, make_optimizer(model.parameters(), tr["lr"],
                                             tr["weight_decay"]))
    step = make_train_step(model)
    if fault:
        step = _Fault(fault, state, step)
    pool = _pool(tr, seed, device)
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    log.append(f"set-up: optimizer, step and pool at "
               f"{time.perf_counter() - t_setup:.3f} s")
    losses = []
    for i in range(tr["check_steps"]):
        losses.append(step(state, pool[i])["train_loss"])
        if i == 0:
            log.append(f"set-up: first step returned at "
                       f"{time.perf_counter() - t_setup:.3f} s")
        if i == 0:
            moments = [(k, state.optimizer.state[p]["exp_avg"] / (1 - BETA1)
                        if p in state.optimizer.state else torch.zeros_like(p))
                       for k, p in model.named_parameters()]
            grad1 = _norms(moments)
            grad1_host = {k: g.detach().float().cpu() for k, g in moments}
            del moments
    change = _norms([(k, p - initial[k]) for k, p in model.named_parameters()])
    losses = [float(v) for v in losses]
    del initial
    k = tr["check_steps"]
    for i in range(tr["warmup_steps"]):
        step(state, pool[(k + i) % len(pool)])
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    log.append(f"set-up: pool, checked and warm-up steps done at "
               f"{time.perf_counter() - t_setup:.3f} s")

    t0 = time.perf_counter()
    n_steps, i, ends = 0, k + tr["warmup_steps"], []
    while time.perf_counter() - t0 < seconds:
        step(state, pool[i % len(pool)])
        i += 1
        n_steps += 1
        ends.append(time.perf_counter())
    sync()
    window_s = time.perf_counter() - t0
    # the host's time between returns of the step, for the log: a run that
    # reads slow shows here whether every step slowed or a few stalled
    per_step = np.diff([t0] + ends) * 1e3
    images = n_steps * tr["batch"]

    prof = None
    if trace:
        from port_bench.trace import profiled, ranges_on

        def steps():
            nonlocal i
            for _ in range(tr["profile_steps"]):
                step(state, pool[i % len(pool)])
                i += 1

        # the device alone first (the profiler's least host cost), then the
        # host's ranges around each block
        with profiled(host=False) as dev:
            steps()
        counter = spans.BlockCounter(cfg)
        with ranges_on(counter.patches()), profiled(host=True) as host:
            steps()
        prof = {"device": dev, "host": host, "blocks": counter,
                "steps": tr["profile_steps"]}

    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    log.append(f"window: {n_steps} steps of {tr['batch']} in {window_s:.3f} s; "
               f"host ms a step p10/p50/p90/max "
               f"{np.percentile(per_step, [10, 50, 90, 100]).round(1).tolist()}; "
               f"set-up losses {losses}")
    del state, model, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = _reference(cfg, seed, device, pool, tr, "float32")
    checks, notes = _compare((losses, grad1, change, grad1_host), ref)
    log.append(f"check: reference losses {ref[0]}; {notes}")
    control_checks = None
    if control:
        low = _reference(cfg, seed, device, pool, tr, "fp8")
        control_checks, cnotes = _compare(low, ref)
        log.append(f"control: fp8 losses {low[0]}; {cnotes}")
    flops = 3 * padded_flops(cfg, tuple(tr["patch"]))
    return {
        "t_window": t0,
        "attempted": n_steps,
        "failed": 0,
        "e2e": {"train_images_per_s": images / window_s},
        "ctx": {"kind": "train", "window_s": window_s,
                "model_flops": images * flops, "profile": prof},
        "checks": checks,
        "control_checks": control_checks,
        "memory_peak_bytes": peak,
        "log": log,
        "notes": notes,
    }


def _compare(program, ref):
    """(readings, notes) of a run against the reference, each a tuple
    (losses, step-1 gradient norms, change norms, step-1 gradients on the
    host): the first step's loss gap (relative); the step-1 gradient norms'
    gap of the worst leaf and of the median leaf (each leaf against the
    larger of its own and the median leaf's reference norm) and of the
    global norm; over the leaves the reference's gradient moves, the median
    leaf's step-1 gradient difference |g - g_ref| / |g_ref| and the worst
    leaf's change gap. The cell's limits file says which are compared."""
    losses, grad1, change, g1 = program
    r_losses, r_grad1, r_change, r_g1 = ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
    grad_gap, g_leaf = common.worst_gap(grad1, r_grad1)
    med = float(np.median(list(r_grad1.values())))
    per_leaf = [abs(grad1[k] - v) / max(v, med) for k, v in r_grad1.items()]
    total = np.sqrt(sum(v * v for v in r_grad1.values()))
    total_p = np.sqrt(sum(v * v for v in grad1.values()))
    moved = [k for k, v in r_grad1.items() if v >= 1e-3 * med]
    diff = [float((g1[k] - r_g1[k]).norm() / r_g1[k].norm()) for k in moved]
    change_gap, c_leaf = common.worst_gap(change, r_change, moved)
    return ({"loss1_gap": gaps[0], "grad_gap": grad_gap,
             "grad_median_gap": float(np.median(per_leaf)),
             "grad_global_gap": float(abs(total_p - total) / total),
             "grad_diff_median": float(np.median(diff)),
             "change_gap": change_gap},
            {"loss_gaps": gaps, "grad_gap": g_leaf, "change_gap": c_leaf})


def _reference(cfg, seed, device, pool, tr, precision):
    """(losses, step-1 gradient norms, change norms, step-1 gradients on the
    host) of `check_steps` steps
    of the reference, its batches in blocks of `reference_rows` rows (their
    gradients summed, each block's loss weighted by its share of rows)."""
    model = common.reference_model(cfg, seed, device)
    params = dict(model.named_parameters())
    initial = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, wd = tr["lr"], tr["weight_decay"]
    losses, grad1 = [], None
    with exact_float32(), products_in(precision):
        for t in range(1, tr["check_steps"] + 1):
            batch = pool[t - 1]
            x = batch["degraded"].permute(0, 3, 1, 2)
            y = batch["clean"].permute(0, 3, 1, 2)
            b, rows = x.shape[0], tr["reference_rows"]
            for p in params.values():
                p.grad = None
            total = 0.0
            for s in range(0, b, rows):
                part = (model(x[s:s + rows]) - y[s:s + rows]).abs().mean()
                (part * (min(rows, b - s) / b)).backward()
                total += part.item() * min(rows, b - s) / b
            losses.append(total)
            with torch.no_grad():
                grads = {k: (p.grad if p.grad is not None
                             else torch.zeros_like(p)) for k, p in params.items()}
                if t == 1:
                    grad1 = _norms(grads.items())
                    grad1_host = {k: g.float().cpu() for k, g in grads.items()}
                for k, p in params.items():
                    g = grads[k]
                    m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                    v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    p.mul_(1 - lr * wd)
                    denom = (v2[k].sqrt() / (1 - BETA2 ** t) ** 0.5).add_(EPS)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - BETA1 ** t))
    change = _norms([(k, p - initial[k]) for k, p in params.items()])
    del model
    gc.collect()
    return losses, grad1, change, grad1_host
