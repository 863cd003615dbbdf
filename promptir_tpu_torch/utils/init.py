"""The reference's weight re-initialisers.

Counterpart of promptir_tpu/utils/init.py:init_weights (the reference's
`init_weights(net, 'normal'|'xavier'|'kaiming'|'orthogonal')`,
utils/image_utils.py:185-252, dead code in its main path). Each
convolution's and linear layer's weight with ndim >= 2 is drawn anew from
an explicit torch.Generator; biases, LayerNorms, prompt banks and every
other tensor stay as they are:
  * normal:     U[0, 0.02)                 (torch init.uniform_(0, 0.02))
  * xavier:     N(0, 2 / (fan_in + fan_out))  (xavier_normal_, gain 1)
  * kaiming:    N(0, 2 / fan_in)           (kaiming_normal_, a=0, fan_in)
  * orthogonal: orthogonal_ over (out, in * kh * kw), gain 1
with torch's fans: fan_in = in / groups * kh * kw, fan_out = out * kh * kw.
The JAX helper's `torch_kernel_init` has no counterpart: it is torch's own
default initialisation, which the port's modules keep.
"""

from __future__ import annotations

import math

import torch
from torch import nn

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
# the JAX helper re-draws the leaves named `kernel`: Conv and Dense, not
# the Uformer's transposed convs (`deconv_kernel`) or its modulators
LAYERS = (nn.Conv2d, nn.Linear)


def _fans(w: torch.Tensor):
    receptive = math.prod(w.shape[2:])
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def init_weights(module: nn.Module, init_type: str = "normal",
                 generator: torch.Generator = None) -> nn.Module:
    """Re-initialise, in place, the weight of every conv and linear layer of
    `module` with ndim >= 2; returns `module`. `generator` (a
    torch.Generator on the CPU, default seeded 0) draws every value."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    gen = generator or torch.Generator().manual_seed(0)
    for layer in module.modules():
        if not isinstance(layer, LAYERS) or layer.weight.dim() < 2:
            continue
        w = layer.weight
        fan_in, fan_out = _fans(w)
        if init_type == "normal":
            new = torch.rand(w.shape, generator=gen) * 0.02
        elif init_type == "xavier":
            new = torch.randn(w.shape, generator=gen) * math.sqrt(
                2.0 / (fan_in + fan_out))
        elif init_type == "kaiming":
            new = torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / fan_in)
        else:
            new = torch.empty(w.shape[0], fan_in)
            nn.init.orthogonal_(new, generator=gen)
        w.copy_(new.reshape(w.shape))
    return module
