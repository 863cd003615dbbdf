"""The port's own padding helpers against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.eval import padding as jpad
from promptir_tpu.parallel.spatial import pad_bases as jax_pad_bases
from promptir_tpu_torch.eval import padding


@pytest.mark.parametrize("hw,base", [((13, 30), 8), ((16, 16), 8), ((9, 70), (16, 8))])
def test_padding_matches_jax(hw, base):
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    assert padding.target_size(*hw, base) == jpad.target_size(*hw, base)
    if isinstance(base, int):
        ref = np.asarray(jpad.pad_to_multiple_reflect(jnp.asarray(x), base))
        np.testing.assert_array_equal(padding.pad_to_multiple_reflect(x, base), ref)
        t = padding.pad_to_multiple_reflect(torch.from_numpy(x), base)
        np.testing.assert_array_equal(t.numpy(), ref)
        np.testing.assert_array_equal(padding.crop(t, *hw).numpy(), x)


@pytest.mark.parametrize("name", ["promptir", "xrestormerir", "promptxrestormerir",
                                  "promptuformerir", "capromptuformerir",
                                  "capromptxrestormereff",
                                  "capromptxrestormereffv2",
                                  "catapromptxrestormer"])
def test_pad_bases_match_jax_on_one_chip(name):
    assert padding.pad_bases(name) == jax_pad_bases(name, 1)


def test_pad_bases_of_an_unported_model_raise():
    """Every model is ported: a name outside the registry raises."""
    with pytest.raises(KeyError, match="unknown model 'restormer'"):
        padding.pad_bases("restormer")
