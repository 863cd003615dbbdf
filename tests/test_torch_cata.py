"""The port's BranchSelector and CATAPromptXRestormer
(`catapromptxrestormer`) on the CPU, against the reference's golden and the
JAX package (no golden of a whole CATA model exists):

  * CATABlock against `cata_block.npz` (16x16, ratio and hard ratio 1)
    within 5e-5, the JAX suite's bound; the parameter counts at the
    training config and the JAX defaults;
  * BranchSelector: at evaluation it keeps max(1, round(B / 2)) images of
    a batch at hard_ratio 0.5 (B = 1, 2, 4, 6), and every image whose label
    ties the threshold, as the JAX selector does; in training its label
    and the straight-through gradient through the mix `xh * lbl + xe *
    (1 - lbl)` equal JAX's on the same uniforms;
  * one block a level (dim 16, the training config's heads, prompts on)
    with seeded weights carried across from the JAX tree, 64x128: the fp32
    eval forward at ratio 0.5 (B4, so the selector keeps 2 of 4 images a
    block) and 1.0 (B2) within 1e-5 of max |JAX|, the bf16 forward at ratio
    and hard ratio 1 within BF16_MODEL_TOL, and at B2 the stochastic
    training loss (L1 plus the ratio and hard-ratio losses) and every fp32
    gradient against the JAX step's on the same Gumbel uniforms, drawn in
    JAX's order (the selector, then the mixer, block after block); the flax
    tree round-trips;
  * a resumed run draws what an unbroken run draws; the served and
    training forwards call the kernel layer as chip_smoke.py gates it; the
    CLIs take the model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promptir_tpu.ops.camixer as jax_camixer
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import create_model
from promptir_tpu_torch.models.camixer_models import CATABlock
from promptir_tpu_torch.ops import camixer
from promptir_tpu_torch.tools.parity import grad_errors
from promptir_tpu_torch.train.checkpoints import CheckpointManager
from promptir_tpu_torch.train.losses import l1_loss
from promptir_tpu_torch.train.state import TrainState, make_optimizer
from promptir_tpu_torch.train.step import make_train_step
from test_torch_ca_xrestormer import (
    BLOCK_TOL,
    CA_TRAIN,
    REDUCED,
    check_window_counts,
    clis_take,
    count_kernel_calls,
    jax_training_loss,
    spy_route_mask,
    with_draws,
)
from test_torch_camixer import Draws, jax_gumbel, port_draws
from test_torch_easy import (  # noqa: F401 (one_torch_thread: a fixture)
    filled,
    flax_grads,
    forward_np,
    jax_variables,
    nchw,
    one_torch_thread,
    port_model,
)
from test_torch_precision import BF16_MODEL_TOL
from test_torch_train import GRAD_TOL
from test_torch_uformer import check_round_trip, load_golden, run_jax

NAME = "catapromptxrestormer"
SHAPE = (2, 64, 128, 3)
SHAPE4 = (4, 64, 128, 3)


@pytest.fixture(scope="module")
def jax_side():
    """(variables, {key: (x, JAX eval output)}, (x, y, JAX training loss,
    output, [ratio loss, hard-ratio loss], {parameter: gradient})): the
    eval forwards at ratio 0.5 (B4) and 1.0 (B2) in fp32 and at ratio and
    hard ratio 1 in bf16 (B2); the training step at B2 on Draws(41)."""
    rng = np.random.default_rng(40)
    x4 = rng.uniform(size=SHAPE4).astype(np.float32)
    x, y = x4[:2], rng.uniform(size=SHAPE).astype(np.float32)
    variables = jax_variables(NAME, REDUCED, SHAPE, 42)
    inputs = {("fp32", 0.5): x4, ("fp32", 1.0): x, ("bf16", 1.0): x}
    jobs = [(jax_create_model(NAME, ratio=0.5, **REDUCED).apply,
             (variables, x4)),
            (jax_create_model(NAME, ratio=1.0, **REDUCED).apply,
             (variables, x)),
            (jax_create_model(NAME, dtype=jnp.bfloat16, ratio=1.0,
                              hard_ratio=1.0, **REDUCED).apply, (variables, x)),
            (with_draws(Draws(41), jax_training_loss(NAME, x, y, "cata")),
             (variables["params"],))]
    *evals, ((value, (out, aux)), g) = run_jax(jobs)
    evals = {k: (inputs[k], np.asarray(o)) for k, o in zip(inputs, evals)}
    train = (x, y, float(value), np.asarray(out), [float(a) for a in aux],
             flax_grads(g, NAME, REDUCED))
    return variables, evals, train


def test_block_matches_golden(golden):
    """Ratio and hard ratio 1: every window and image hard (measured
    <= 2e-6)."""
    g = golden("cata_block")
    blk = load_golden(CATABlock(48, 8, 1.0, 1.0, num_channel_heads=2,
                                num_heads=2, dim_head=16), g)
    with torch.no_grad():
        y, decision, label = blk(torch.from_numpy(g.x_nhwc.copy()),
                                 torch.from_numpy(g.cond_nhwc.copy()))
    assert decision.item() == 1.0 and label.item() == 1.0
    np.testing.assert_allclose(y.numpy(), g.y_nhwc, **BLOCK_TOL)


def test_parameter_counts():
    for kw, params, tensors in ((CA_TRAIN, 46_388_053, 1903),
                                ({}, 74_308_557, 2943)):
        with torch.device("meta"):
            model = create_model(NAME, device="meta", **kw)
        assert sum(p.numel() for p in model.parameters()) == params
        assert len(model.state_dict()) == tensors
    assert model.variant == "cata" and model.hard_ratio == 0.5


def jax_selector(dim, hard_ratio, x, seed):
    """(JAX BranchSelector, seeded variables) for NHWC `x`."""
    sel = jax_camixer.BranchSelector(dim, hard_ratio)
    tree = jax.eval_shape(sel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    return sel, filled(tree, seed)


def port_selector(dim, hard_ratio, variables):
    from promptir_tpu_torch.compat.jax_params import state_dict_from_flax

    sel = camixer.BranchSelector(dim, hard_ratio)
    sel.load_state_dict(state_dict_from_flax(variables, sel), strict=True)
    return sel


@pytest.mark.parametrize("b,k", [(1, 1), (2, 1), (4, 2), (6, 3)])
def test_selector_keeps_round_b_half_images(b, k):
    """k = max(1, round(B * 0.5)) with Python's round (1 -> 0.5 -> 0 -> 1,
    2 -> 1); the labels equal the JAX selector's."""
    x = np.random.default_rng(b).normal(size=(b, 8, 16, 16)).astype(np.float32)
    sel, variables = jax_selector(16, 0.5, x, b)
    want = np.asarray(sel.apply(variables, jnp.asarray(x), True))
    with torch.no_grad():
        got = port_selector(16, 0.5, variables)(torch.from_numpy(x))
    assert got.shape == (b,) and got.dtype == torch.float32
    assert got.sum().item() == k
    np.testing.assert_array_equal(got.numpy(), want)


def test_selector_keeps_every_tied_image():
    """Equal labels (a zero classifier kernel): the threshold rule keeps all
    four images at hard_ratio 0.5, as JAX's does."""
    x = np.random.default_rng(0).normal(size=(4, 8, 8, 16)).astype(np.float32)
    sel, variables = jax_selector(16, 0.5, x, 1)
    variables["params"]["classifier_0"]["kernel"][:] = 0.0
    want = np.asarray(sel.apply(variables, jnp.asarray(x), True))
    with torch.no_grad():
        got = port_selector(16, 0.5, variables)(torch.from_numpy(x))
    assert got.tolist() == want.tolist() == [1.0] * 4


def test_selector_straight_through_gradient_equals_jax():
    """Training, B3, the same uniforms: the sampled label (one hard image
    over the batch axis) and the gradients of sum((xh * lbl + xe * (1 -
    lbl)) * w) for the selector's parameters and its input."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8, 8, 16)).astype(np.float32)
    xh, xe, w = (rng.normal(size=(3, 8, 8, 16)).astype(np.float32)
                 for _ in range(3))
    sel, variables = jax_selector(16, 0.5, x, 4)
    u = Draws(5)((3, 1))

    def jax_loss(params, xj):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_camixer, "gumbel_softmax_hard",
                       jax_gumbel(lambda shape: u))
            lbl = sel.apply({"params": params}, xj, False,
                            rngs={"gumbel": jax.random.PRNGKey(0)})
        lbl = lbl[:, None, None, None]
        return jnp.sum((xh * lbl + xe * (1.0 - lbl)) * w), lbl

    (_, lbl_j), (gp, gx) = jax.value_and_grad(jax_loss, (0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    port = port_selector(16, 0.5, variables)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(camixer, "gumbel_uniform",
                   lambda shape, g, device: torch.from_numpy(u))
        lbl = port(xt, False, torch.Generator())[:, None, None, None]
    mix = torch.from_numpy(xh) * lbl + torch.from_numpy(xe) * (1.0 - lbl)
    (mix * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lbl.detach().numpy(), np.asarray(lbl_j),
                               rtol=0, atol=1e-6)
    assert lbl.detach().round().sum().item() == 1.0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(gx)).max())
    # the classifier's bias shifts every image's logit alike, which the
    # softmax over the batch ignores: its gradient is rounding in both
    # packages (~8e-6), so its error is held over the median tensor's max
    # (tools/parity.py:ZERO_IN_EXACT_ARITHMETIC), every other tensor's over
    # its own, within GRAD_TOL as the model's (measured 3.0e-5 for that
    # bias, <= 1.6e-6 for the others)
    ref = flax_param_grads(gp, port)
    errs = grad_errors(
        {k: p.grad.numpy() for k, p in port.named_parameters()}, ref)
    assert max(errs.values()) <= GRAD_TOL, errs
    assert np.abs(ref["classifier.0.weight"]).max() > 0


def flax_param_grads(grads, module):
    from promptir_tpu_torch.compat.jax_params import state_dict_from_flax

    sd = state_dict_from_flax(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads)},
        module)
    return {k: v.numpy() for k, v in sd.items()}


def spy_selector(monkeypatch):
    """The (B,) labels and the (1, B) scores of every selector at
    evaluation."""
    kept, real = [], camixer.topk_window_mask

    def spy(scores, k):
        mask = real(scores, k)
        if scores.shape[0] == 1:  # the selector's label.T
            kept.append((scores, mask))
        return mask

    monkeypatch.setattr(camixer, "topk_window_mask", spy)
    return kept


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_reduced_eval_forward_matches_jax(jax_side, ratio, monkeypatch):
    """fp32 within 1e-5 of max |JAX| (measured ~2e-6); each of the 8
    mixers keeps max(1, round(N * ratio)) windows an image, each of the 8
    selectors round(B / 2) images (B4 at ratio 0.5, B2 at 1.0), more only on
    a tie."""
    variables, evals, _ = jax_side
    x, want = evals[("fp32", ratio)]
    windows = spy_route_mask(monkeypatch)
    images = spy_selector(monkeypatch)
    y = forward_np(port_model(NAME, REDUCED, variables, ratio=ratio), x)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert len(windows) == 8 and len(images) == 8
    check_window_counts(windows, ratio)
    k = round(x.shape[0] / 2)
    for scores, mask in images:
        if mask.sum() > k:
            thresh = scores[0].sort().values[x.shape[0] - k]
            assert (scores[0] == thresh).sum() > 1
        assert mask.sum() >= k


def test_reduced_bf16_forward_matches_jax_at_ratio_1(jax_side):
    """Ratio and hard ratio 1 (every window and image hard, so bf16 ties
    cannot route differently): the served bf16 model against the jitted
    JAX bf16 model within BF16_MODEL_TOL."""
    variables, evals, _ = jax_side
    x, want = evals[("bf16", 1.0)]
    model = port_model(NAME, REDUCED, variables, dtype=torch.bfloat16,
                       ratio=1.0, hard_ratio=1.0)
    err = np.abs(forward_np(model, x) - want).max()
    assert err <= BF16_MODEL_TOL, err


def test_reduced_stochastic_loss_and_grads_match_jax(jax_side, monkeypatch):
    """B2 on the same uniforms: the training output within 1e-5 of max
    |JAX|, the ratio and hard-ratio losses within 1e-6, the loss within 1e-6
    of JAX's, every gradient within GRAD_TOL of its own max
    (tools/parity.py:grad_errors)."""
    variables, _, (x, y, loss_j, out_j, aux_j, ref) = jax_side
    monkeypatch.setattr(camixer, "gumbel_uniform", port_draws(Draws(41)))
    model = port_model(NAME, REDUCED, variables, train=True)
    out, ratio_term, hard_term = model(nchw(x), deterministic=False)
    loss = l1_loss(out, nchw(y)) + ratio_term + hard_term
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1),
                               out_j, rtol=0, atol=1e-5 * np.abs(out_j).max())
    assert abs(ratio_term.item() - aux_j[0]) <= 1e-6
    assert abs(hard_term.item() - aux_j[1]) <= 1e-6
    assert abs(loss.item() - loss_j) <= 1e-6 * loss_j
    errs = grad_errors(
        {k: p.grad.numpy() for k, p in model.named_parameters()}, ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_flax_tree_round_trips(jax_side):
    check_round_trip(NAME, REDUCED, jax_side[0])


def test_a_resumed_run_draws_what_an_unbroken_run_draws(tmp_path, monkeypatch):
    """Two train steps; then a new run restored from the checkpoint after
    the first: its step draws the unbroken run's second step's uniforms, in
    the same order (each block's selector, then its mixer), and gives its
    loss."""
    drawn, real = [], camixer.gumbel_uniform
    monkeypatch.setattr(camixer, "gumbel_uniform",
                        lambda *a: drawn.append(real(*a)) or drawn[-1])
    batch = {k: torch.rand(2, 64, 64, 3,
                           generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(("degraded", "clean"))}

    def run():
        torch.manual_seed(0)
        model = create_model(NAME, device="cpu", train=True, prompt=False,
                             **dict(REDUCED, dim=8))
        state = TrainState(model, make_optimizer(model.parameters()))
        return state, make_train_step(model, seed=7)

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    state, step = run()
    step(state, batch)
    ckpt.save(0, state)
    first = list(drawn)
    drawn.clear()
    loss = step(state, batch)["train_loss"].item()
    unbroken = list(drawn)
    drawn.clear()
    state, step = run()
    ckpt.restore(state, 0)
    resumed_loss = step(state, batch)["train_loss"].item()
    assert len(drawn) == len(unbroken) == len(first) == 16
    assert [tuple(d.shape) for d in drawn[:2]] == [(2, 1), (2, 64, 2)]
    assert all(torch.equal(a, b) for a, b in zip(drawn, unbroken))
    assert not any(torch.equal(a, b) for a, b in zip(first, unbroken))
    assert resumed_loss == loss


def test_the_training_config_runs_the_kernels_the_smoke_gates(monkeypatch):
    """A served forward of the training config: mdta_stats and block_tail 28
    times (the hard branch of each of the 28 blocks runs for every image;
    the Easy prompt blocks launch nothing), ln_gdfn 28, 12 stats calls on
    the wide route; a training forward LnMdta 28 and LnGdfn 56 (at dim 8)."""
    torch.manual_seed(0)
    model = create_model(NAME, device="cpu", **CA_TRAIN)

    def serve():
        with torch.no_grad():
            model(torch.rand(1, 3, 64, 64))

    assert count_kernel_calls(monkeypatch, serve) == {
        "mdta_stats": 28, "block_tail": 28, "ln_gdfn": 28, "mdta_gram": 12}
    model = create_model(NAME, device="cpu", train=True, dim=8, **CA_TRAIN)
    calls = count_kernel_calls(monkeypatch, lambda: model(
        torch.rand(1, 3, 64, 64), deterministic=False,
        generator=torch.Generator().manual_seed(0)))
    assert calls == {"LnMdta": 28, "LnGdfn": 56}


def test_the_clis_take_the_model(tmp_path, monkeypatch):
    trainer = clis_take(NAME, tmp_path, monkeypatch)
    assert type(trainer.model).__name__ == "CATAPromptXRestormer"
