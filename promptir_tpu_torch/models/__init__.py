"""Model registry of the port.

Counterpart of promptir_tpu/models/__init__.py, with all 12 of its models:
the flagship `promptir`, the X-Restormer family's `xrestormerir`,
`promptxrestormerir` and `promptxrestormereffir`, the attention-free
family's `easypromptxrestormer`, `nafnet` and `nafnetlocal`, the Uformer
family's `promptuformerir` and `capromptuformerir` (CAMixer v1), and the
CAMixer X-Restormers `capromptxrestormereff` (v1), `capromptxrestormereffv2`
and `catapromptxrestormer`.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from promptir_tpu_torch.utils import tracing

_REGISTRY: Dict[str, Callable[..., torch.nn.Module]] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_models():
    return sorted(_REGISTRY)


def create_model(name: str, *, device="cuda", dtype=torch.float32,
                 train: bool = False, **kwargs):
    """Build model `name` on `device` (default the card) computing in `dtype`
    (inside a `setup.model` span, utils/tracing.py).

    For serving (`train=False`) the weights are stored in `dtype` and the
    model is in eval mode. For training the weights stay float32 (the
    optimizer's master weights) and the forward computes in `dtype`, as the
    JAX models do with `dtype=bfloat16`; the model is in train mode.

    Raises when `device` is a CUDA device and no card is present: the port
    never falls back to the CPU unless the caller asks for it, and, as the
    JAX registry does, a ValueError when `fused_ffn=True` goes to a model
    without that option (any but the PromptIR and X-Restormer families).
    """
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {available_models()}"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions"
        )
    with tracing.setup_span("setup.model", model=name):
        try:
            model = _REGISTRY[name](**kwargs)
        except TypeError as e:
            if "fused_ffn" in str(e) and kwargs.get("fused_ffn"):
                raise ValueError(
                    f"model {name!r} has no fused Pallas path (fused_ffn/"
                    "--fused is supported by the PromptIR and X-Restormer "
                    "families)"
                ) from e
            raise
        if not train:
            return model.to(device=device, dtype=dtype).eval()
        model = model.to(device=device, dtype=torch.float32).train()
        model.compute_dtype = dtype
        return model


from promptir_tpu_torch.models import promptir as _promptir  # noqa: E402,F401
from promptir_tpu_torch.models import xrestormer as _xrestormer  # noqa: E402,F401
from promptir_tpu_torch.models import prompt_xrestormer as _pxr  # noqa: E402,F401
from promptir_tpu_torch.models import prompt_xrestormer_eff as _pxre  # noqa: E402,F401
from promptir_tpu_torch.models import easy_promptxrestormer as _easy  # noqa: E402,F401
from promptir_tpu_torch.models import nafnet as _nafnet  # noqa: E402,F401
from promptir_tpu_torch.models import prompt_uformer as _uformer  # noqa: E402,F401
from promptir_tpu_torch.models import camixer_prompt_uformer as _capu  # noqa: E402,F401
from promptir_tpu_torch.models import camixer_models as _ca  # noqa: E402,F401
