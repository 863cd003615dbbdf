"""Seeded weights, made on the device in a few large calls.

One `torch.randn` over every parameter of the configuration at once, from
a `torch.Generator` on the device seeded with the run's seed, then one
multiply and one add by per-tensor scales and offsets spread with
`repeat_interleave`. The state dict is views of that one float32 buffer,
in the reference's key order; the same seed gives the same weights on the
same device. The scales keep a deep residual network's activations of
order one, as the published initialisation does:

  * a convolution or linear weight: N(0, 1 / (3 fan_in)), the variance of
    torch's default kaiming_uniform(a=sqrt(5));
  * the LayerNorms' weights and MDTA's temperatures: 1 + N(0, 0.1^2), their
    biases N(0, 0.1^2), so that a transposed weight or a lost bias shows;
  * the prompt banks: 0.5 + N(0, 0.29^2), the spread of their U[0, 1) init;
  * OCAB's relative position tables: N(0, 1 / dim_head), as published;
  * the prompt's linear bias: N(0, 0.05^2).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch


def _scale_offset(key: str, shape) -> tuple[float, float]:
    leaf = key.rsplit(".", 1)[-1]
    if key.endswith("body.weight") or leaf == "temperature":
        return 0.1, 1.0
    if key.endswith("body.bias"):
        return 0.1, 0.0
    if leaf == "prompt_param":
        return 0.29, 0.5
    if leaf in ("rel_height", "rel_width"):
        return shape[1] ** -0.5, 0.0
    if leaf == "bias":
        return 0.05, 0.0
    fan_in = math.prod(shape[1:])
    return (3 * fan_in) ** -0.5, 0.0


def seeded_state_dict(shapes: "OrderedDict[str, torch.Size]", seed: int,
                      device) -> "OrderedDict[str, torch.Tensor]":
    """{key: float32 tensor of `shapes[key]`} on `device`, drawn from `seed`."""
    device = torch.device(device)
    numels = [math.prod(s) for s in shapes.values()]
    stats = [_scale_offset(k, s) for k, s in shapes.items()]
    counts = torch.tensor(numels, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([s for s, _ in stats], device=device), counts)
    offset = torch.repeat_interleave(
        torch.tensor([o for _, o in stats], device=device), counts)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(numels), generator=gen, device=device)
    flat.mul_(scale).add_(offset)
    out, i = OrderedDict(), 0
    for (key, shape), n in zip(shapes.items(), numels):
        out[key] = flat[i:i + n].view(shape)
        i += n
    return out


def shapes_of(module: torch.nn.Module) -> "OrderedDict[str, torch.Size]":
    return OrderedDict((k, v.shape) for k, v in module.state_dict().items())


def load_into(module: torch.nn.Module, state: dict, device) -> torch.nn.Module:
    """Give `module`, built on the meta device, storage on `device` and the
    values of `state` (strict: every key, no other)."""
    module = module.to_empty(device=device)
    missing = set(dict(module.named_buffers())) - set(state)
    if missing:
        raise ValueError(f"buffers outside the state dict: {sorted(missing)}")
    module.load_state_dict(state, strict=True)
    return module
