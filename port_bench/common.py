"""What the drivers share: the port's model and the reference built from a
configuration with the same seeded weights, seeded photographs, the
nearest-rank percentile and the checks' arithmetic."""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import weights
from port_bench.reference import models as reference

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reference_shapes(config: dict):
    with torch.device("meta"):
        return weights.shapes_of(reference.build(config))


def port_model(config: dict, seed: int, device, train: bool):
    """The port's model of `config` (promptir_tpu_torch.models.create_model,
    built on the meta device) with the seeded float32 weights: served, its
    weights stored in the compute dtype; for training, float32 master
    weights computing in it."""
    from promptir_tpu_torch.models import create_model

    model = create_model(config["port_model"], device="meta",
                         dtype=DTYPES[config["compute_dtype"]], train=train,
                         **config["model"], **config.get("port_options", {}))
    state = weights.seeded_state_dict(reference_shapes(config), seed, device)
    return weights.load_into(model, state, device)


def reference_model(config: dict, seed: int, device):
    """The plain float32 reference with the same seeded weights."""
    with torch.device("meta"):
        model = reference.build(config)
    state = weights.seeded_state_dict(weights.shapes_of(model), seed, device)
    return weights.load_into(model, state, device)


def photographs(n: int, h: int, w: int, gen: torch.Generator, device):
    """n clean (n, 3, h, w) float32 images in [0, 1]: three octaves of
    bilinearly upsampled uniform noise (a smooth field, edges and texture),
    each image stretched to [0, 1]."""
    x = torch.zeros(n, 3, h, w, device=device)
    for div, amp in ((32, 1.0), (8, 0.5), (2, 0.25)):
        z = torch.rand(n, 3, max(2, h // div), max(2, w // div),
                       generator=gen, device=device)
        x += amp * F.interpolate(z, (h, w), mode="bilinear",
                                 align_corners=False)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo)


def add_noise(clean, sigmas, gen):
    """clip(clean + sigma / 255 * N(0, 1), 0, 1), sigma per image (on
    the 0-255 scale, as the all-in-one denoising sets add it)."""
    s = torch.as_tensor(sigmas, dtype=clean.dtype, device=clean.device)
    noise = torch.randn(clean.shape, generator=gen, device=clean.device)
    return (clean + noise * (s / 255.0)[:, None, None, None]).clamp(0, 1)


def add_haze(clean, gen):
    """The atmospheric scattering model of synthetic haze (RESIDE's outdoor
    sets): clean * t + A * (1 - t), t = exp(-beta * d), with a smooth depth
    field d in [0, 1] of each image's own, beta in [0.6, 1.8] and the
    airlight A in [0.7, 1.0] drawn per image."""
    n, _, h, w = clean.shape
    z = torch.rand(n, 1, max(2, h // 32), max(2, w // 32), generator=gen,
                   device=clean.device)
    d = F.interpolate(z, (h, w), mode="bilinear", align_corners=False)
    beta, air = torch.rand(2, n, 1, 1, 1, generator=gen, device=clean.device)
    t = torch.exp(-(0.6 + 1.2 * beta) * d)
    return clean * t + (0.7 + 0.3 * air) * (1 - t)


def balanced(values, n: int, rng: np.random.Generator, block: int = None) -> list:
    """n draws of `values` in equal shares, in an order drawn from `rng`:
    every seed gets the same multiset. With `block`, each run of `block`
    draws is balanced on its own (as near as its length allows, the odd
    draw going to each value in turn) and shuffled within itself."""
    block = block or max(n, 1)
    out = []
    for b, start in enumerate(range(0, n, block)):
        size = min(block, n - start)
        picks = [values[(i + b) % len(values)] for i in range(size)]
        out += [picks[i] for i in rng.permutation(size)]
    return out


def nearest_rank(values, p: float) -> float:
    """The p-th percentile (0 < p <= 100) by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100.0 * len(ordered)) - 1)]


def worst_gap(program: dict, ref: dict, keys=None):
    """(gap, leaf): the largest |program norm - reference norm| over the
    leaves `keys` (default all of `ref`), each against the larger of the
    reference's norm of that leaf and of the median leaf among `keys`."""
    keys = list(ref if keys is None else keys)
    med = float(np.median([ref[k] for k in keys]))
    worst, where = -1.0, None
    for k in keys:
        gap = abs(program[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"
    return r.stdout.strip().splitlines()[0]
