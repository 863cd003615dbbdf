"""utils/init.py:init_weights: the statistics of the JAX helper's test
(tests/test_utils.py:52) for each init type on the same layers, biases and
norms untouched, the draws from the generator, unknown types refused."""

import math

import pytest
import torch
from torch import nn

from promptir_tpu_torch import create_model
from promptir_tpu_torch.utils.init import init_weights

FAN_IN = 3 * 3 * 16


def layers():
    """The JAX test's tree: a (3, 3, 16, 32) conv with a bias, a (64, 8)
    dense kernel and a norm of 16; the bias zero, the norm weight one."""
    m = nn.ModuleDict({"conv": nn.Conv2d(16, 32, 3), "dense": nn.Linear(64, 8),
                       "norm": nn.LayerNorm(16)})
    with torch.no_grad():
        m["conv"].bias.zero_()
    return m


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
def test_init_weights_statistics(init_type):
    m = init_weights(layers(), init_type, gen(1))
    k = m["conv"].weight.detach()
    if init_type == "normal":  # torch init.uniform_(0, 0.02)
        assert 0.0 <= k.min() and k.max() <= 0.02
    elif init_type == "kaiming":
        assert abs(k.std().item() - math.sqrt(2.0 / FAN_IN)) < 0.01
    elif init_type == "xavier":
        assert abs(k.std().item() - math.sqrt(2.0 / (FAN_IN + 2 * 9 * 16))) < 0.01
    else:
        flat = k.reshape(32, -1)
        torch.testing.assert_close(flat @ flat.T, torch.eye(32), atol=1e-5,
                                   rtol=0)
        d = m["dense"].weight.detach()  # (8, 64): orthonormal rows
        torch.testing.assert_close(d @ d.T, torch.eye(8), atol=1e-5, rtol=0)
    assert float(m["conv"].bias.detach().abs().max()) == 0.0
    assert float(m["norm"].weight.detach().min()) == 1.0
    assert float(m["norm"].bias.detach().abs().max()) == 0.0
    again = init_weights(layers(), init_type, gen(1))
    assert torch.equal(again["conv"].weight, m["conv"].weight)
    other = init_weights(layers(), init_type, gen(2))
    assert not torch.equal(other["conv"].weight, m["conv"].weight)


def test_init_weights_leaves_a_models_other_tensors():
    """On promptir: every conv and linear weight drawn anew; the LayerNorms,
    temperatures, prompt banks and biases as they were."""
    model = create_model("promptir", device="cpu", num_blocks=(1, 1, 1, 1),
                         num_refinement_blocks=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    init_weights(model, "kaiming", gen(0))
    convs = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))}
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) != (k in convs), k


def test_unknown_init_type_is_refused():
    with pytest.raises(NotImplementedError, match="bogus"):
        init_weights(layers(), "bogus")
