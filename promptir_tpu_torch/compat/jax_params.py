"""Weight bridge: the JAX package's flax parameter tree -> this port's state_dict.

The inverse of promptir_tpu/compat/torch_ckpt.py:convert_state_dict, written
afresh (the port imports nothing of the JAX package). The flax tree holds
numpy-convertible arrays with HWIO conv kernels, (in, out) dense kernels,
(heads,) temperatures, NAFBlock's (C,) `beta`/`gamma` (torch's are
(1, C, 1, 1)), (L, S, S, C) prompt banks, Sequential indices merged into
names (`encoder_level1_0`) and no LayerNorm `body` wrapper. The target
model's own state_dict keys say where each tensor goes, so names such as
`down1_2`, which are not Sequential indices, are never split. The Uformer
family's leaves: a LeWin block's `modulator.weight` is flax's untransposed
(N, dim) `modulator`, a transposed conv's `deconv.0.weight` (cin, cout, 2,
2) and `deconv.0.bias` are flax's `deconv_kernel` (cin, 2, 2, cout) and
`deconv_bias`, and the integer buffers (`relative_position_index`) have no
flax leaf: the model's own copy is kept, as the JAX converter skips them.
`load_params_npz` reads the flat `.npz` that the JAX package's
`train/checkpoints.py:save_params_npz` writes ('/'-joined paths) back into
that tree, so a model trained by the JAX package loads into the port.
The other way, `flax_from_state_dict` lays a state dict out as that tree
(the JAX converter's layout, promptir_tpu/compat/torch_ckpt.py:
convert_state_dict) and `save_params_npz` writes the same flat file, so a
torch checkpoint converted by the port loads into either package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def flax_path(key: str, ndim: int) -> Tuple[str, ...]:
    """Where the flax tree keeps the tensor of torch state-dict `key`."""
    parts = key.split(".")
    merged: list = []
    for i, p in enumerate(parts):
        if p == "body" and not (i + 1 < len(parts) and parts[i + 1].isdigit()):
            continue  # LayerNorm wrapper
        if p.isdigit() and merged and i < len(parts) - 1:
            merged[-1] = f"{merged[-1]}_{p}"  # Sequential index
        else:
            merged.append(p)
    if merged[-2:] == ["modulator", "weight"]:
        return tuple(merged[:-1])
    if len(merged) > 1 and merged[-2] == "deconv_0":
        return tuple(merged[:-2]) + ("deconv_" + (
            "kernel" if merged[-1] == "weight" else "bias"),)
    if merged[-1] == "weight" and ndim in (2, 4):
        merged[-1] = "kernel"
    return tuple(merged)


def load_params_npz(path: str) -> Dict[str, Any]:
    """The nested flax parameter tree of a JAX `save_params_npz` file."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(arr, key: str, shape) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    leaf = key.rsplit(".", 1)[-1]
    if key.endswith("modulator.weight"):
        pass  # (N, dim) in both
    elif key.endswith("deconv.0.weight"):
        a = a.transpose(0, 3, 1, 2)  # (cin, 2, 2, cout) -> (cin, cout, 2, 2)
    elif leaf == "weight" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif leaf == "weight" and a.ndim == 2:
        a = a.T  # (in, out) -> (out, in)
    elif leaf == "prompt_param":
        a = a.transpose(0, 3, 1, 2)[None]  # (L, S, S, C) -> (1, L, C, S, S)
    elif leaf in ("temperature", "beta", "gamma"):
        a = a.reshape(tuple(shape))  # (heads,), NAFBlock's (C,) scales
    if a.shape != tuple(shape):
        raise ValueError(f"{key}: flax shape gives {a.shape}, model wants "
                         f"{tuple(shape)}")
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def state_dict_from_flax(variables: Mapping[str, Any],
                         model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """float32 state_dict for `model` from flax `variables` ({'params': ...}
    or the params tree itself). Raises listing missing and unexpected paths."""
    tree = variables.get("params", variables)
    flat = dict(_flatten(tree))
    out, missing = {}, []
    for key, t in model.state_dict().items():
        if not t.is_floating_point():
            out[key] = t.detach().clone()  # an integer buffer: the model's
            continue
        path = flax_path(key, t.dim())
        if path not in flat:
            missing.append("/".join(path))
            continue
        out[key] = _to_torch_layout(flat.pop(path), key, t.shape)
    if missing or flat:
        unexpected = sorted("/".join(p) for p in flat)
        raise ValueError(
            f"flax tree does not fit the model: missing ({len(missing)}) "
            f"{missing[:8]}; unexpected ({len(unexpected)}) {unexpected[:8]}"
        )
    return out


def _to_flax_layout(t: torch.Tensor, key: str) -> np.ndarray:
    """The flax array of state-dict tensor `key`: the inverse of
    _to_torch_layout."""
    a = t.detach().cpu().float().numpy()
    leaf = key.rsplit(".", 1)[-1]
    if key.endswith("modulator.weight"):
        return a  # (N, dim) in both
    if key.endswith("deconv.0.weight"):
        return a.transpose(0, 2, 3, 1)  # (cin, cout, 2, 2) -> (cin, 2, 2, cout)
    if leaf == "weight" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if leaf == "weight" and a.ndim == 2:
        return a.T  # (out, in) -> (in, out)
    if leaf == "prompt_param":
        return a[0].transpose(0, 2, 3, 1)  # (1, L, C, S, S) -> (L, S, S, C)
    if leaf in ("temperature", "beta", "gamma"):
        return a.reshape(-1)  # (heads, 1, 1) and NAFBlock's (1, C, 1, 1)
    return a


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                         model: torch.nn.Module = None) -> Dict[str, Any]:
    """The nested flax parameter tree of a torch `state_dict`, float32, as
    the JAX converter lays it out; integer buffers (the Uformer's
    `relative_position_index`) are left out, as the JAX converter leaves
    them. With `model`, first raise (compat/torch_ckpt.py:check_state_dict)
    listing the keys the state dict lacks, those the model does not have
    and those whose shapes differ."""
    if model is not None:
        from promptir_tpu_torch.compat.torch_ckpt import check_state_dict

        check_state_dict(model, state_dict)
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        if not t.is_floating_point() or key.endswith("relative_position_index"):
            continue
        node = tree
        *parents, leaf = flax_path(key, t.dim())
        for p in parents:
            node = node.setdefault(p, {})
        if leaf in node:
            raise ValueError(f"two tensors map to {'/'.join(parents + [leaf])}")
        node[leaf] = _to_flax_layout(t, key)
    return tree


def save_params_npz(path: str, params: Mapping[str, Any]) -> None:
    """The flat `.npz` of a parameter tree, '/'-joined paths, as the JAX
    package's train/checkpoints.py:save_params_npz writes it."""
    np.savez(path, **{"/".join(p): np.asarray(v) for p, v in _flatten(params)})
