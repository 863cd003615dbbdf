"""Precision and placement of the port against the JAX package's behaviour.

  * bfloat16 model outputs against the JAX models with `dtype=bfloat16`
    (`fused_ffn=False`) on identical weights: reduced promptir, for a model
    stored in bf16 (serving) and one with float32 weights computing in bf16
    (training), and reduced promptxrestormerir. The bound is
    BF16_MODEL_TOL; measured 7.8125e-3 in every case, one bf16 ulp at the
    outputs near 1 (the forwards end in bf16: output conv + input image).
    PromptGenBlock follows the JAX dtype order (ops/prompt.py).
  * the models' global residual is summed in float32, as XLA computes it in
    the JAX package's jitted bf16 forward (the eager forwards above are
    shared with that test).
  * float32 work runs with TF32 off in a scope that restores the caller's
    settings (precision.py).
  * every kernel wrapper launches on its tensor's card: it makes that card
    current around the launch and takes that card's stream; any card index
    is accepted.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.ops.cuda import block, build, gdfn, mdta, seam
from promptir_tpu_torch.precision import compute_dtype, exact_float32

REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
SHAPES = {"promptir": (2, 32, 48, 3), "promptxrestormerir": (2, 64, 128, 3)}
BF16_MODEL_TOL = 1.5625e-2  # two bf16 ulps at 1.0; measured one


@functools.lru_cache(maxsize=None)
def jax_bf16(name):
    """(input, flax variables, the JAX bf16 output) of reduced `name`."""
    x = np.random.default_rng(0).uniform(size=SHAPES[name]).astype(np.float32)
    variables = init_variables(jax_create_model(name, **REDUCED), 3,
                               jnp.asarray(x))
    jmodel = jax_create_model(name, dtype=jnp.bfloat16, fused_ffn=False,
                              **REDUCED)
    return x, variables, np.asarray(jmodel.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("name,train", [("promptir", False), ("promptir", True),
                                        ("promptxrestormerir", False)])
def test_bf16_model_matches_jax_bf16(name, train):
    x, variables, ref = jax_bf16(name)
    sd = state_dict_from_flax(variables, create_model(name, device="cpu", **REDUCED))
    model = create_model(name, device="cpu", dtype=torch.bfloat16, train=train,
                         **REDUCED)
    model.load_state_dict(sd, strict=True)
    assert compute_dtype(model) == torch.bfloat16
    assert next(model.parameters()).dtype == (torch.float32 if train
                                              else torch.bfloat16)
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert y.dtype == torch.float32
    err = np.abs(y.numpy().transpose(0, 2, 3, 1) - ref).max()
    assert err <= BF16_MODEL_TOL, err


def on_bf16_grid(a):
    """Share of the values of float32 array a that bf16 holds exactly."""
    return float(np.mean(a == np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))))


@pytest.mark.parametrize("name,shape", [("promptir", (2, 32, 48, 3)),
                                        ("promptxrestormerir", (2, 64, 128, 3)),
                                        ("easypromptxrestormer", (2, 32, 48, 3)),
                                        ("nafnet", (2, 32, 48, 3))])
def test_global_residual_sums_in_float32_as_jitted_jax(name, shape):
    """The JAX models end in `(out + inp.astype(out.dtype)).astype(float32)`
    (promptir_tpu/models/promptir.py:397), a bf16 sum. Eager, every output
    lies on the bf16 grid; jitted, most lie off it, because XLA keeps the
    sum in float32 (its excess precision; with
    --xla_allow_excess_precision=false the jitted outputs lie on the grid
    too). The port sums the bf16 output conv and the bf16 input in float32,
    and lands closer to the jitted forward than the same sum rounded to
    bf16. Reduced models, the weights of test_torch_precision.py; measured
    on the grid 0.256 / 0.276 jitted, mean |port - jitted| 4.37e-4 against
    8.02e-4 rounded (promptir), 1.20e-3 against 1.65e-3
    (promptxrestormerir). The attention-free family ends the same way
    (promptir_tpu/models/easy_promptxrestormer.py:136, nafnet.py:82-83),
    its weights seeded as in tests/test_torch_easy.py (an eager init of the
    reduced Easy model takes ~46 s); their eager forwards are not run (the
    same last line as PromptIR's, and ~40 s and ~13 s of op-by-op compiles
    here). The kernel models' eager forwards are jax_bf16's, shared with
    test_bf16_model_matches_jax_bf16 (the same input, variables and
    model). NAFNet at a multiple of 16: where it
    pads the input inside and crops the output, the jitted JAX forward
    rounds the sum to bf16 before the crop
    (test_torch_nafnet.py::test_padded_global_residual_is_rounded_by_jitted_jax)."""
    reduced = REDUCED
    jax_only = dict(fused_ffn=False)
    kernel_model = name in SHAPES
    if kernel_model:  # the eager bf16 forward of the test above
        x, variables, eager = jax_bf16(name)
        assert x.shape == shape
    else:
        from test_torch_easy import jax_variables

        x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
        jax_only = {}
        if name == "nafnet":
            reduced = dict(width=16, middle_blk_num=1, enc_blk_nums=(1, 1, 1, 1),
                           dec_blk_nums=(1, 1, 1, 1))
        variables = jax_variables(name, reduced, shape, 3)
    jmodel = jax_create_model(name, dtype=jnp.bfloat16, **jax_only, **reduced)
    jitted = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    assert on_bf16_grid(jitted) < 0.5
    if kernel_model:
        assert on_bf16_grid(eager) == 1.0

    model = create_model(name, device="cpu", dtype=torch.bfloat16, **reduced)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    y = y.numpy().transpose(0, 2, 3, 1)
    rounded = np.asarray(jnp.asarray(y).astype(jnp.bfloat16).astype(jnp.float32))
    assert on_bf16_grid(y) < 0.5
    assert np.abs(y - jitted).mean() < np.abs(rounded - jitted).mean()


def test_prompt_gen_rounds_as_jax_does():
    """The GAP and the Linear in the compute dtype, the mix rounded to it
    before the resize: in bf16 the prompt is built from bf16 logits."""
    from promptir_tpu_torch.ops.prompt import PromptGenBlock

    torch.manual_seed(0)
    blk = PromptGenBlock(16, 5, 8, 32)
    x = torch.rand(2, 32, 12, 10)
    with torch.no_grad():
        y32 = blk(x)
        y16 = blk.bfloat16()(x.bfloat16())
    assert y16.dtype == torch.bfloat16 and y16.shape == (2, 16, 12, 10)
    assert (y16.float() - y32).abs().max().item() < 0.05


def test_exact_float32_is_scoped():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        with exact_float32(torch.float32):
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with exact_float32(torch.bfloat16):
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with pytest.raises(KeyError):
            with exact_float32(torch.float32):
                raise KeyError
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


class FakeDevice:
    """torch.cuda.device stand-in that records the card made current."""

    def __init__(self, log, device):
        self.log, self.device = log, device

    def __enter__(self):
        self.log.append(("enter", self.device))

    def __exit__(self, *exc):
        self.log.append(("exit", self.device))


def test_stream_and_device_of_any_card(monkeypatch):
    """A launch on card 1 makes card 1 current around it (and changes
    nothing when it already is) and takes card 1's current stream."""
    log = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: FakeDevice(log, d))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: (
        log.append(("stream", i)), 7)[1], raising=False)
    t = types.SimpleNamespace(device=torch.device("cuda", 1))
    for current in (0, 1):
        monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
        with build.on_card_of(t):
            assert build.stream_of(t) == 7
    card = torch.device("cuda", 1)
    assert log == [("enter", card), ("stream", 1), ("exit", card),
                   ("stream", 1)]


def test_every_wrapper_launches_inside_its_card(monkeypatch):
    """Drive each wrapper's launch path with storage-less tensors and a
    recording library: every C launcher is called with the card of its
    input current and that card's stream."""
    log = []
    dev = torch.device("meta")
    monkeypatch.setattr(build, "on_card_of", lambda t: FakeDevice(log, t.device))
    monkeypatch.setattr(build, "stream_of", lambda t: log.append(("stream", t.device)) or 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)

    def function(name, argtypes, restype=None):
        if name == "block_tail_smem":
            return lambda dtype, c: 0
        if name == "mdta_stats_smem":
            return lambda dtype, th, tw, c, heads, wide: mdta.stats_smem(
                c, heads, torch.float32, (th, tw))
        return lambda *args: log.append(("launch", name, args[-1])) or 0

    monkeypatch.setattr(build, "function", function)
    for fn in (mdta.mdta_stats, mdta.ln_mdta, block.block_tail, gdfn.ln_gdfn,
               seam.seam):
        monkeypatch.setattr(fn, "launches", 0)
    c, f, heads, d = 8, 21, 2, 4

    def z(*s, dt=torch.float32):
        return torch.zeros(*s, device=dev, dtype=dt)

    x = z(1, 4, 4, c)
    attn = z(1, heads, d, d)
    mdta.mdta_stats(x, z(c), z(c), z(3 * c, c), z(3 * c, 9), heads)
    mdta.mdta_apply(x, x, attn, z(c, c))
    block.block_tail(x, x, attn, z(c, c), z(c), z(c), z(2 * f, c), z(2 * f, 9),
                     z(c, f))
    gdfn.ln_gdfn(x, z(c), z(c), z(2 * f, c), z(2 * f, 9), z(c, f))
    seam.seam(z(1, 2, 2, 4 * c), x)
    launches = [e for e in log if e[0] == "launch"]
    assert [e[1] for e in launches] == ["mdta_stats_launch", "ln_mdta_launch",
                                        "block_tail_launch", "ln_gdfn_launch",
                                        "seam_launch"]
    assert all(e[2] == 9 for e in launches)  # the card's stream
    for i, e in enumerate(log):
        if e[0] == "launch":
            assert log[i - 2:i] == [("enter", dev), ("stream", dev)]
            assert log[i + 1] == ("exit", dev)
    assert (mdta.mdta_stats.launches, mdta.ln_mdta.launches,
            block.block_tail.launches, gdfn.ln_gdfn.launches,
            seam.seam.launches) == (1, 1, 1, 1, 1)
