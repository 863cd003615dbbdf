"""Tensor-parallel GDFN and MDTA (promptir_tpu_torch/parallel/tp.py) on the
CPU, over 2 and 4 gloo ranks, against the JAX package's
`parallel.tp.tp_gdfn_apply` / `tp_mdta_apply` on its 2-D CPU mesh (n_data
1, n_model n) and against the unsharded modules, fp32, within 1e-5 of the
output's max |value| (the row-parallel sum reassociates the contraction).

The cases: PromptIR's level-1 and level-2 widths (48 and 96 channels; MDTA
with 4 heads, which 2 and 4 ranks divide), bias-free and biased
(`use_bias`). F = int(2.66 C) = 127 and 255 divide neither 2 nor 4, so the
hidden is padded with inert zero channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from promptir_tpu.parallel.mesh import create_mesh as jax_create_mesh
from promptir_tpu.parallel.tp import shard_gdfn_params as jax_shard_gdfn
from promptir_tpu.parallel.tp import tp_gdfn_apply as jax_tp_gdfn
from promptir_tpu.parallel.tp import tp_mdta_apply as jax_tp_mdta
from promptir_tpu_torch.compat.jax_params import flax_from_state_dict
from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.parallel.mesh import launch
from promptir_tpu_torch.parallel.tp import shard_gdfn_params
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

WORLDS = (2, 4)
DEADLINE_S = 60
TOL = 1e-5  # of the output's max |value|
# label: (kind, constructor arguments)
CASES = {
    "gdfn 48": ("gdfn", (48, 2.66, False)),
    "gdfn 96 biased": ("gdfn", (96, 2.66, True)),
    "mdta 48 4 heads": ("mdta", (48, 4, False)),
    "mdta 96 4 heads biased": ("mdta", (96, 4, True)),
}


def module(kind, args, seed):
    torch.manual_seed(seed)
    mod = (GDFN if kind == "gdfn" else MDTA)(*args)
    with torch.no_grad():  # biases and temperatures away from their inits
        for name, p in mod.named_parameters():
            if "weight" not in name:
                p.add_(torch.randn(p.shape) * 0.5)
    return mod


@pytest.fixture(scope="module")
def inputs():
    states = {label: (kind, args, module(kind, args, i).state_dict())
              for i, (label, (kind, args)) in enumerate(CASES.items())}
    rng = np.random.default_rng(0)
    xs = {label: rng.normal(size=(2, args[0], 12, 10)).astype(np.float32)
          for label, (_, args) in CASES.items()}
    return states, xs


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def sharded(request, inputs, tmp_path_factory):
    states, xs = inputs
    n = request.param
    res = launch(torch_ranks.tp_rank, n, "cpu", args=(states, xs),
                 timeout_s=DEADLINE_S, threads=1,
                 store_dir=str(tmp_path_factory.mktemp("store")))
    return n, {label: [r[label] for r in res] for label in states}


def unsharded(state, x):
    kind, args, sd = state
    mod = (GDFN if kind == "gdfn" else MDTA)(*args)
    mod.load_state_dict(sd)
    with torch.no_grad():
        return mod(torch.from_numpy(x)).numpy()


def jax_tp(state, x, n):
    kind, args, sd = state
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(sd))
    mesh = jax_create_mesh(1, n, devices=jax.devices()[:n])
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    if kind == "gdfn":
        y = jax_tp_gdfn(params, xj, mesh)
    else:
        y = jax_tp_mdta(params, xj, args[1], mesh)
    return np.asarray(y).transpose(0, 3, 1, 2)


def close(a, b):
    return np.abs(a - b).max() <= TOL * np.abs(b).max()


@pytest.mark.parametrize("label", list(CASES))
def test_tp_matches_the_unsharded_module(sharded, inputs, label):
    _, out = sharded
    states, xs = inputs
    want = unsharded(states[label], xs[label])
    for y in out[label]:
        assert close(y, want), np.abs(y - want).max()


@pytest.mark.parametrize("label", list(CASES))
def test_tp_matches_jax_tp(sharded, inputs, label):
    n, out = sharded
    states, xs = inputs
    want = jax_tp(states[label], xs[label], n)
    for y in out[label]:
        assert close(y, want), np.abs(y - want).max()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gdfn_shards_match_jax_shards(n):
    """The gate-aware split itself, bias-free: every rank's slice of W1,
    the depthwise taps and W2 equals the JAX shard's (layouts aside)."""
    mod = module("gdfn", (48, 2.66, False), 0)
    ours = shard_gdfn_params(mod, n)
    params = flax_from_state_dict(mod.state_dict())
    theirs = jax_shard_gdfn(jax.tree_util.tree_map(jnp.asarray, params), n)
    for k, shard in enumerate(ours):
        np.testing.assert_array_equal(
            shard["w1"].numpy()[:, :, 0, 0].T, np.asarray(theirs["w1"][k, 0, 0]))
        np.testing.assert_array_equal(
            shard["wdw"].numpy()[:, 0].transpose(1, 2, 0),
            np.asarray(theirs["wdw"][k, :, :, 0]))
        np.testing.assert_array_equal(
            shard["w2"].numpy()[:, :, 0, 0].T, np.asarray(theirs["w2"][k, 0, 0]))
