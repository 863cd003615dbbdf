"""utils/flops.py and cli/summary.py against the JAX package's
utils/flops.py: the parameter counts of every model equal, FLOPs of one
convolution exact, and the plain route's FLOP count of promptir within
[0.90, 1.00] of XLA's cost analysis (which also counts elementwise ops and
bias adds and leaves a SAME convolution's padded taps out)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from promptir_tpu.cli.test import validation_shape
from promptir_tpu.models import available_models
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.utils.flops import count_params as jax_count_params
from promptir_tpu.utils.flops import model_cost as jax_model_cost
from promptir_tpu_torch import create_model
from promptir_tpu_torch.cli import summary
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.utils.flops import count_params, model_cost, summarize
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


@pytest.mark.parametrize("name", available_models())
def test_param_count_equals_jax(name):
    """The defaults' parameters: the port's on storage-less tensors, the JAX
    model's variables through jax.eval_shape (no init)."""
    model = create_model(name, device="meta")
    tree = jax.eval_shape(jax_create_model(name).init, jax.random.PRNGKey(0),
                          jnp.zeros(validation_shape(name)))
    assert count_params(model) == jax_count_params(tree)


# the models whose JAX dataclass has `use_bias`
BIASED = ("promptir", "xrestormerir", "promptxrestormerir",
          "promptxrestormereffir", "easypromptxrestormer",
          "capromptxrestormereff", "capromptxrestormereffv2",
          "catapromptxrestormer")


@pytest.mark.parametrize("name", BIASED)
def test_biased_param_count_equals_jax(name):
    """`use_bias=True` adds the same biases in both packages."""
    model = create_model(name, device="meta", use_bias=True)
    tree = jax.eval_shape(jax_create_model(name, use_bias=True).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros(validation_shape(name)))
    assert count_params(model) == jax_count_params(tree)
    assert count_params(model) > count_params(create_model(name,
                                                           device="meta"))


def test_one_conv_counts_exactly():
    """2 H W Cin Cout 9 operations; the input, weight and output bytes."""
    conv = Conv(16, 32, 3)
    cost = model_cost(conv, (1, 20, 24, 16))
    assert cost["flops"] == 2 * 20 * 24 * 16 * 32 * 9
    assert cost["bytes_accessed"] == 4 * (20 * 24 * 16 + 32 * 16 * 9
                                          + 20 * 24 * 32)
    assert cost["params"] == 32 * 16 * 9
    assert cost["peak_memory_mb"] is None  # no card: no figure


@pytest.mark.parametrize("kw", [REDUCED, {}], ids=["reduced", "full"])
def test_promptir_flops_within_jax_cost(one_torch_thread, kw):
    """Measured 0.953 (reduced) and 0.945 (full depth) at 64x64."""
    shape = (1, 64, 64, 3)
    want = jax_model_cost(jax_create_model("promptir", **kw), shape)
    cost = model_cost(create_model("promptir", device="cpu", **kw), shape)
    assert cost["params"] == want["params"]
    assert 0.90 <= cost["flops"] / want["flops"] <= 1.00
    assert cost["bytes_accessed"] > 0


def test_summary_cli_prints_the_jax_lines(one_torch_thread, capsys):
    cost = summary.main(["--model", "promptir", "--size", "32", "--device",
                         "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "promptir @ 1x32x32x3"
    assert out[1] == "#Params : 35.5923 M"
    assert out[2] == f"FLOPs  : {cost['flops'] / 1e9:.4f} G @ (1, 32, 32, 3)"
    assert out[3].startswith("Bytes  : ") and len(out) == 4
    # FLOPs scale with the pixels: a quarter of 64x64's 21.5930 G
    assert abs(cost["flops"] * 4 / 21_592_952_384 - 1) < 1e-3


def test_summary_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        summary.main(["--size", "8"])


def test_summarize_takes_a_given_cost():
    text = summarize(None, (2, 8, 8, 3), cost={
        "params": 1_500_000, "flops": 3e9, "bytes_accessed": 2e9,
        "peak_memory_mb": 12.5})
    assert text.splitlines() == ["#Params : 1.5000 M",
                                 "FLOPs  : 3.0000 G @ (2, 8, 8, 3)",
                                 "Bytes  : 2.0000 GB", "Memory : 12.5 MB"]
