"""Repairs of the port's listed faults, on the CPU.

  * PyTorch's CPU bf16 weight gradient of a dilated depthwise conv of
    channels-last memory (conv_nhwc's NCHW view) is wrong: 1.32 of max
    |fp32 grad| at B6 32x32 C 48 and 1.46 at B6 64x64 C 96 (torch 2.13);
    every shape of 32x32 or more pixels so far, no dilation-1 or dense
    conv. `ops/conv.py:Conv._plain` convolves a contiguous copy there. The
    first test holds that gradient (CAMixer v1's `conv_sptial.1`) and the
    second a reduced bf16 CAMixer v1 model's gradients, each against its
    own fp32 gradient;
  * bf16 gradients on torch's own init: the port's bf16 gradients lie a
    median of 0.014 from JAX's bf16 ones there (0.0085 on JAX's init, where
    BF16_GRAD_MEDIAN = 0.011 was measured). Each package's bf16 gradient
    against its own fp32 gradient on the same torch-init weights shows
    whose rounding is at fault: the medians are 0.02965 (port) and 0.02961
    (JAX), so neither; the third test holds the port's median to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.window_attention import conv_nhwc
from promptir_tpu_torch.tools.parity import grad_errors
from promptir_tpu_torch.train.losses import l1_loss
from test_torch_train import REDUCED, one_torch_thread  # noqa: F401

# a bf16 weight gradient against the fp32 one, over max |fp32 grad|:
# measured 2.9e-3 to 3.9e-3 on contiguous memory at these shapes
DILATED_TOL = 2e-2
# the reduced CAMixer v1 model's bf16 gradients against its fp32 ones:
# conv_sptial's measured at most 0.035 (decoder_level3's conv_sptial.1),
# the median tensor 0.013; the worst tensors are the offset predictor's
# (0.62, route.out_offsets: through flow_warp's bilinear cells, which bf16
# positions change) and a temperature (0.30)
CONV_SPTIAL_TOL = 0.1
V1_GRAD_MEDIAN = 0.02
# the port's median bf16-against-fp32 gradient gap over JAX's on the same
# weights and batch: measured 1.001 (torch's init) and 1.003 (JAX's init).
# The two frameworks round bf16 at the same points but sum in other orders,
# so the medians over 146 tensors move by a few percent with the thread
# count; a rounding point missed or added moves the port's by ~50% (q and k
# rounded into the Gram moved it 0.0138 -> 0.0082 against JAX's bf16
# gradients).
BF16_SELF_GAP_RATIO = 1.1


def nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("b,h,w,c", [(6, 32, 32, 48), (6, 64, 64, 96)])
def test_dilated_depthwise_conv_bf16_weight_grad(b, h, w, c):
    """CAMixer v1's dilated depthwise 3x3 through conv_nhwc (channels-last
    memory) at B6: its bf16 weight and bias gradients within DILATED_TOL of
    the fp32 ones (the parent commit: 1.32 and 1.46 of the weight's)."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    go = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    conv = Conv(c, c, 3, padding=2, dilation=2, groups=c, bias=True)
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        conv.zero_grad()
        y = conv_nhwc(x.to(dt), conv)
        assert y.dtype == dt and y.shape == x.shape
        y.backward(go.to(dt))
        grads[dt] = (conv.weight.grad.clone(), conv.bias.grad.clone())
    for g32, g16 in zip(grads[torch.float32], grads[torch.bfloat16]):
        err = (g16 - g32).abs().max() / g32.abs().max()
        assert err <= DILATED_TOL, err.item()


def test_ca_v1_bf16_grads_match_its_fp32_grads():
    """A reduced CAMixer v1 X-Restormer (dim 16, one block a level, ratio 1
    so that every window routes alike in both dtypes) on a (2, 64, 64, 3)
    batch: its level-1 mixers' dilated convs run at 64x64. Each bf16
    gradient against the fp32 one over that tensor's max (the median
    tensor's for project_k's bias, zero in exact arithmetic:
    tools/parity.py:grad_errors): conv_sptial's within CONV_SPTIAL_TOL, the
    median within V1_GRAD_MEDIAN, every tensor within 1 (the parent commit:
    up to 1.9e27)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    kw = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8),
              ratio=1.0)
    torch.manual_seed(0)
    sd = create_model("capromptxrestormereff", device="cpu", **kw).state_dict()
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        model = create_model("capromptxrestormereff", device="cpu", train=True,
                             dtype=dt, **kw)
        model.load_state_dict(sd, strict=True)
        loss = l1_loss(model(nchw(x), deterministic=True), nchw(y))
        loss.backward()
        grads[dt] = {n: p.grad for n, p in model.named_parameters()
                     if p.grad is not None}
    errs = grad_errors(grads[torch.bfloat16], grads[torch.float32])
    spatial = {k: e for k, e in errs.items() if "conv_sptial" in k}
    assert len(spatial) == 4 * 8  # 2 convs x (weight, bias) x 8 blocks
    worst = max(spatial, key=spatial.get)
    assert spatial[worst] <= CONV_SPTIAL_TOL, (worst, spatial[worst])
    assert np.median(list(errs.values())) <= V1_GRAD_MEDIAN
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1.0, (worst, errs[worst])


@functools.lru_cache(maxsize=None)
def jax_grad(jdt):
    """The jitted gradient of reduced PromptIR's L1 loss computing in jdt,
    compiled once for both inits."""
    jm = jax_create_model("promptir", dtype=jdt, fused_ffn=False, **REDUCED)
    return jax.jit(jax.grad(lambda p, x, y: jax_l1_loss(
        jm.apply({"params": p}, x), y)))


@functools.lru_cache(maxsize=None)
def self_gaps(init):
    """Median over tensors of max |bf16 grad - fp32 grad| / max |fp32 grad|
    for the port and for JAX: reduced PromptIR, the (2, 32, 48, 3) batch of
    test_torch_train_grads.py's bf16 test, on the port's torch init (seed 0)
    or JAX's (seed 1)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    model = create_model("promptir", device="cpu", train=True, **REDUCED)
    if init == "torch":
        torch.manual_seed(0)
        model = create_model("promptir", device="cpu", train=True, **REDUCED)
        sd = model.state_dict()
        params = jax.tree.map(jnp.asarray, flax_from_state_dict(sd, model))
    else:
        from jax_init import init_variables

        variables = init_variables(
            jax_create_model("promptir", fused_ffn=False, **REDUCED), 1,
            jnp.asarray(x))
        params = variables["params"]
        sd = state_dict_from_flax(variables, model)
    port, ref = {}, {}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        m = create_model("promptir", device="cpu", train=True, dtype=dt,
                         **REDUCED)
        m.load_state_dict(sd, strict=True)
        l1_loss(m(nchw(x)), nchw(y)).backward()
        port[dt] = {n: p.grad.numpy() for n, p in m.named_parameters()
                    if p.grad is not None}
        g = jax_grad(jdt)(params, jnp.asarray(x), jnp.asarray(y))
        g = jax.tree.map(lambda a: np.asarray(a, np.float32), g)
        ref[dt] = {k: v.numpy() for k, v in
                   state_dict_from_flax({"params": g}, m).items()}

    def median(grads):
        lo, hi = grads[torch.bfloat16], grads[torch.float32]
        return float(np.median([np.abs(lo[n] - hi[n]).max() / np.abs(hi[n]).max()
                                for n in port[torch.float32]]))

    return median(port), median(ref)


@pytest.mark.parametrize("init", ["torch", "jax"])
def test_bf16_grad_gap_matches_jax(init):
    """The port's bf16 gradients lie no farther from its own fp32 gradients
    than JAX's from JAX's, up to BF16_SELF_GAP_RATIO in the median (torch's
    init: 0.02965 and 0.02961; JAX's: 0.01454 and 0.01449, at 4 threads)."""
    port, ref = self_gaps(init)
    assert port <= BF16_SELF_GAP_RATIO * ref, (port, ref)
    assert 0.005 < ref < 0.05, ref  # the gap is bf16's, not a broken step
