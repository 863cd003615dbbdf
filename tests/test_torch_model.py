"""The port's PromptIR: goldens, parameter count, JAX parity, device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.compat.torch_ckpt import convert_state_dict
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax

REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


def load_golden(g, **kw):
    model = create_model("promptir", device="cpu", **kw)
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in g.state_dict.items()}, strict=True
    )
    return model


@pytest.mark.parametrize("name,kw,tol", [
    ("promptir_small", REDUCED, 5e-5),
    ("promptir_full", {}, 2e-4),
])
def test_promptir_matches_golden(golden, name, kw, tol):
    """The reference's own output, through the port's plain path on the
    CPU; promptir_full is the full-depth 548-tensor state dict."""
    g = golden(name)
    model = load_golden(g, **kw)
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), g.y, rtol=tol, atol=tol)


def test_promptir_param_count():
    model = create_model("promptir", device="cpu")
    assert len(model.state_dict()) == 548
    assert sum(p.numel() for p in model.parameters()) == 35_592_263


def test_reduced_promptir_matches_jax_nonsquare_batch2():
    """Same flax-initialised weights in both packages, fp32, on a
    non-square batch-2 input (no golden covers this shape)."""
    x = np.random.default_rng(0).uniform(size=(2, 32, 48, 3)).astype(np.float32)
    jmodel = jax_create_model("promptir", **REDUCED)
    variables = init_variables(jmodel, 3, jnp.asarray(x))
    # jitted: within 1.2e-7 of the eager forward (a tenth of the bound is
    # 1e-5), which compiles op by op
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = create_model("promptir", device="cpu", **REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-4, atol=1e-4)


def test_bf16_storage_forward_is_close_to_fp32(golden):
    g = golden("promptir_small")
    model = load_golden(g, **REDUCED)
    x = torch.from_numpy(g.x)
    with torch.no_grad():
        y32 = model(x)
        y16 = model.to(torch.bfloat16)(x)
    assert y16.dtype == torch.float32
    assert (y16 - y32).abs().max().item() < 0.1


def test_create_model_defaults_to_the_card():
    """Without device='cpu' the port asks for the card, and this machine
    has none: it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("promptir")


def test_unported_model_points_to_roadmap():
    """Every model of the JAX package is ported: a name outside the registry
    raises the JAX registry's "unknown model" error, listing the models."""
    with pytest.raises(KeyError, match="unknown model 'restormer'.*promptir"):
        create_model("restormer", device="cpu")


def test_available_models_equal_jax():
    from promptir_tpu.models import available_models as jax_available_models
    from promptir_tpu_torch.models import available_models

    assert available_models() == jax_available_models()
    assert len(available_models()) == 12


def test_golden_state_dict_matches_jax_converter_keys(golden):
    """Every reference key lands in the port verbatim and in the JAX tree
    through the JAX converter: the two packages name the same tensors."""
    g = golden("promptir_full")
    tree = convert_state_dict(g.state_dict)["params"]
    model = create_model("promptir", device="cpu")
    sd = state_dict_from_flax({"params": tree}, model)
    assert sorted(sd) == sorted(g.state_dict)
