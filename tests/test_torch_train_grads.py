"""The port's training gradients against the JAX package's, on the CPU.

A reduced PromptIR's and a reduced PromptXRestormer's L1 loss and every
parameter's gradient against `jax.value_and_grad` of the JAX model
(`fused_ffn=False`) on identical weights, in float32 and in bf16 compute
with float32 weights, within the bounds of tests/test_torch_train.py.

The JAX side is jitted and its variables initialised under jit
(tests/jax_init.py: bit-equal to the eager init). The float32 PromptIR
step is jitted too: against its eager form it moves the loss by 8.5e-8 of
itself and each gradient by at most 2.4e-5 of its tensor's max |grad|
(median 3.4e-7), under a tenth of the test's bounds (1e-6 and GRAD_TOL),
and it takes 15 s against 123 s alone on the test host.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jax_init import init_variables
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.train.losses import l1_loss
from test_torch_train import (
    BF16_GRAD_MEDIAN,
    BF16_GRAD_TOL,
    GRAD_TOL,
    REDUCED,
)


def test_reduced_promptir_loss_and_grads_match_jax():
    """One (2, 64, 96, 3) batch, the flax-initialised weights in both
    packages: the L1 loss within 1e-6 and each parameter's gradient within
    GRAD_TOL of that tensor's max |grad| (the dead convs get none in the
    port and zero in JAX)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 64, 96, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 64, 96, 3)).astype(np.float32)
    jmodel = jax_create_model("promptir", fused_ffn=False, **REDUCED)
    variables = init_variables(jmodel, 1, jnp.asarray(x))
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_l1_loss(jmodel.apply({"params": p}, jnp.asarray(x)),
                              jnp.asarray(y))))(variables["params"])

    model = create_model("promptir", device="cpu", train=True, **REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    assert model.training and all(p.dtype == torch.float32
                                  for p in model.parameters())
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    loss = l1_loss(model(nchw(x)), nchw(y))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * float(loss_j)
    ref = state_dict_from_flax({"params": jax.tree.map(np.asarray, grads_j)},
                               model)
    dead = 0
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        if p.grad is None:
            assert not want.any(), name
            dead += 1
            continue
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (name, err)
    assert dead == 6


def test_reduced_promptir_bf16_grads_match_jax():
    """One (2, 32, 48, 3) batch through reduced PromptIR computing in bf16
    with float32 weights in both packages (`dtype=bfloat16`, the jitted
    `jax.value_and_grad`): the loss within 2e-4 of JAX's (measured 5.9e-5)
    and every gradient within the bf16 bounds above."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    variables = init_variables(
        jax_create_model("promptir", fused_ffn=False, **REDUCED), 1,
        jnp.asarray(x))
    jmodel = jax_create_model("promptir", dtype=jnp.bfloat16, fused_ffn=False,
                              **REDUCED)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_l1_loss(jmodel.apply({"params": p}, jnp.asarray(x)),
                              jnp.asarray(y))))(variables["params"])

    model = create_model("promptir", device="cpu", train=True,
                         dtype=torch.bfloat16, **REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    loss = l1_loss(model(nchw(x)), nchw(y))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 2e-4 * float(loss_j)
    ref = state_dict_from_flax(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads_j)},
        model)
    errs = []
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        if p.grad is None:
            assert not want.any(), name
            continue
        assert p.grad.dtype == torch.float32
        err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= BF16_GRAD_TOL, (name, err)
        errs.append(err)
    assert len(errs) == len(list(model.parameters())) - 6
    assert np.median(errs) <= BF16_GRAD_MEDIAN, np.median(errs)


# the reference's training config of promptxrestormerir, one block a level
XR_REDUCED = dict(REDUCED, channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))


@functools.lru_cache(maxsize=None)
def xrestormer_batch():
    """(x, y, flax variables) of the X-Restormer tests: one (2, 64, 128, 3)
    batch, the variables initialised once for both dtypes."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 64, 128, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 64, 128, 3)).astype(np.float32)
    variables = init_variables(
        jax_create_model("promptxrestormerir", **XR_REDUCED), 1,
        jnp.asarray(x[:1, :, :64]))
    return x, y, variables


def xrestormer_grads(dtype):
    """Reduced promptxrestormerir (the training config's heads, one block a
    level), flax-initialised weights in both packages, one (2, 64, 128, 3)
    batch: (port loss, JAX loss, port model, JAX gradients as a state
    dict)."""
    x, y, variables = xrestormer_batch()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = jax_create_model("promptxrestormerir", dtype=jdtype, **XR_REDUCED)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_l1_loss(jmodel.apply({"params": p}, jnp.asarray(x)),
                              jnp.asarray(y))))(variables["params"])
    model = create_model("promptxrestormerir", device="cpu", train=True,
                         dtype=dtype, **XR_REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    loss = l1_loss(model(nchw(x)), nchw(y))
    loss.backward()
    ref = state_dict_from_flax(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads_j)},
        model)
    return loss.item(), float(loss_j), model, ref


def xrestormer_grad_errors(model, ref):
    """Each parameter's max |port - JAX| over its max |JAX|; every
    parameter has a gradient."""
    errs = {}
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        want = ref[name].numpy()
        errs[name] = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
    return errs


def test_reduced_xrestormer_loss_and_grads_match_jax():
    """fp32: the loss within 1e-6 of JAX's and every gradient within
    GRAD_TOL of its tensor's max |grad| (probe: 2.27e-5, median 5.3e-7)."""
    loss, loss_j, model, ref = xrestormer_grads(torch.float32)
    assert abs(loss - loss_j) <= 1e-6 * loss_j
    errs = xrestormer_grad_errors(model, ref)
    assert len(errs) == len(list(model.parameters()))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_reduced_xrestormer_bf16_grads_match_jax():
    """bf16 compute with float32 weights in both packages (the jitted JAX
    bf16 gradients): the loss within 2e-4 of JAX's, every gradient within
    BF16_GRAD_TOL and the median within BF16_GRAD_MEDIAN (probe: max 0.051,
    median 0.0031)."""
    loss, loss_j, model, ref = xrestormer_grads(torch.bfloat16)
    assert abs(loss - loss_j) <= 2e-4 * loss_j
    errs = xrestormer_grad_errors(model, ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BF16_GRAD_TOL, (worst, errs[worst])
    assert np.median(list(errs.values())) <= BF16_GRAD_MEDIAN
