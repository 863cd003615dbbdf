"""Model FLOPs of one image, counted on the plain reference.

`torch.utils.flop_counter.FlopCounterMode` over one forward of the
reference (reference/models.py) on the meta device at the padded shape:
convolutions and matrix products, 2 a multiply-add, a same convolution's
padded taps included, as the port's utils/flops.py:model_cost counts its
plain route. Nothing is computed, so any shape counts in milliseconds."""

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.models import build


@functools.lru_cache(maxsize=None)
def forward_flops(config_json: str, h: int, w: int) -> int:
    """FLOPs of one forward of the configuration (its JSON text) on one
    (3, h, w) image."""
    with torch.device("meta"):
        model = build(json.loads(config_json))
        x = torch.zeros(1, 3, h, w)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return counter.get_total_flops()


def padded_flops(config: dict, size) -> int:
    """FLOPs of one image of `size` (H, W) at the configuration's padded
    shape (each side up to a multiple of its pad base)."""
    base = config["pad_base"]
    h, w = (-(-v // base) * base for v in size)
    return forward_flops(json.dumps(config, sort_keys=True), h, w)
