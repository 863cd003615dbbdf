"""Loading a PyTorch or Lightning checkpoint into the port's models.

Counterpart of promptir_tpu/compat/torch_ckpt.py:load_torch_state_dict and
check_params_match. The port's modules take the reference's state-dict keys
verbatim (548 tensors for promptir), so no layout is converted: the file is
read with `torch.load(map_location="cpu", weights_only=False)` as the JAX
package reads it (a Lightning `.ckpt` holds more than tensors), its
`state_dict` taken when present, the `net.`, `module.` or `model.` prefix
stripped, and the tensors loaded with `strict=True`. Any mismatch raises
first, listing the missing, unexpected and mis-shaped keys.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

PREFIXES = ("net.", "module.", "model.")


def _strip_prefix(key: str) -> str:
    for pref in PREFIXES:
        if key.startswith(pref):
            return key[len(pref):]
    return key


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a .ckpt/.pt/.pth file, their keys without the
    Lightning or DataParallel prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {_strip_prefix(k): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def check_state_dict(model: torch.nn.Module,
                     state_dict: Mapping[str, torch.Tensor]) -> None:
    """Raise a ValueError listing the keys missing from `state_dict`, those
    `model` does not have and those whose shapes differ."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    have = {k: tuple(v.shape) for k, v in state_dict.items()}
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    bad = sorted(k for k in set(have) & set(want) if have[k] != want[k])
    msg = []
    if missing:
        msg.append(f"missing from checkpoint ({len(missing)}): {missing[:8]}")
    if extra:
        msg.append(f"unexpected in checkpoint ({len(extra)}): {extra[:8]}")
    if bad:
        msg.append("shape mismatches: " + ", ".join(
            f"{k}: ckpt{have[k]} vs model{want[k]}" for k in bad[:8]))
    if msg:
        raise ValueError("; ".join(msg))


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the checkpoint at `path` into `model` (strict) and return it."""
    state_dict = load_torch_state_dict(path)
    check_state_dict(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    return model
