"""The weight bridge: flax param tree -> the port's state_dict."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.compat.torch_ckpt import convert_state_dict
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import flax_path, state_dict_from_flax


def test_golden_round_trip_is_identical(golden):
    """reference state dict -> JAX converter -> bridge: the same 548 tensors,
    bit for bit."""
    g = golden("promptir_full")
    variables = convert_state_dict(g.state_dict)
    model = create_model("promptir", device="cpu")
    sd = state_dict_from_flax(variables, model)
    assert len(sd) == len(g.state_dict) == 548
    for k, v in g.state_dict.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_jax_initialised_reduced_promptir_loads_strict():
    kw = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    variables = init_variables(jax_create_model("promptir", **kw), 0,
                               jnp.zeros((1, 16, 16, 3)))
    model = create_model("promptir", device="cpu", **kw)
    result = model.load_state_dict(state_dict_from_flax(variables, model),
                                   strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("key,ndim,path", [
    ("encoder_level1.0.norm1.body.weight", 1,
     ("encoder_level1_0", "norm1", "weight")),
    ("down1_2.body.0.weight", 4, ("down1_2", "body_0", "kernel")),
    ("prompt1.linear_layer.weight", 2, ("prompt1", "linear_layer", "kernel")),
    ("latent.3.attn.temperature", 3, ("latent_3", "attn", "temperature")),
    ("prompt3.attn.spatial_attn.rel_pos_emb.rel_height", 2,
     ("prompt3", "attn", "spatial_attn", "rel_pos_emb", "rel_height")),
])
def test_flax_path(key, ndim, path):
    assert flax_path(key, ndim) == path


def test_bridge_reports_missing_and_unexpected():
    model = create_model("promptir", device="cpu",
                         num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    tree = {"output": {"kernel": np.zeros((3, 3, 96, 3), np.float32)},
            "bogus": {"kernel": np.zeros((1,), np.float32)}}
    with pytest.raises(ValueError, match="missing .*unexpected .*bogus"):
        state_dict_from_flax({"params": tree}, model)
    assert torch.is_tensor(next(iter(model.state_dict().values())))
