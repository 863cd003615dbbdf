"""PyTorch / CUDA port of promptir_tpu for one NVIDIA H100.

The JAX package `promptir_tpu` is the reference; this package imports none
of it. Its entry points run on the card unless the caller passes
device="cpu", where each hand-written kernel is replaced by its plain
PyTorch version.
"""

from promptir_tpu_torch.models import available_models, create_model

__all__ = ["available_models", "create_model"]
