"""The port's CAMixer v1 and CAPromptUformerIR (`capromptuformerir`) on the
CPU, against the reference's golden and the JAX package:

  * CAMixerV1 with a global condition against `camixer_v1.npz` (ratio 1,
    where the reference's routing is exact) within 5e-5, the JAX suite's
    bound;
  * flow_warp equal to JAX's and within 1e-5 of torch's grid_sample
    (border, align_corners=True); the top-k threshold rule keeps ties;
    route_mask's k rounds half to even; the straight-through Gumbel sample
    equals JAX's formula on the same uniforms, value and gradient;
  * the reduced model (embed 8, one block a stage, prompts on) with seeded
    weights carried across from the JAX tree: the eval forward at ratio 0.5
    and 1.0 (B2 128x256) within 1e-5 of max |JAX|, each mixer keeping
    max(1, round(N / 2)) windows an image at 0.5; the stochastic training
    loss (L1 + the ratio loss), its mean decision and its gradients (B1
    128x128, fp32) against the JAX step's, on the same uniforms: in the
    test only, the JAX package's `gumbel_softmax_hard` takes the next array
    of a seeded numpy stream and the port's `gumbel_uniform` the same
    stream's;
  * the default config's 103,104,001 parameters; the flax tree round-trips;
    `model(x)` is the deterministic forward even in train mode; the train
    step draws from (seed, step): a resumed run draws what an unbroken run
    draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import promptir_tpu.ops.camixer as jax_camixer
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.ops.flow_warp import flow_warp as jax_flow_warp
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu.train.losses import ratio_loss as jax_ratio_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.ops import camixer
from promptir_tpu_torch.ops.flow_warp import flow_warp
from promptir_tpu_torch.train.checkpoints import CheckpointManager
from promptir_tpu_torch.train.losses import l1_loss, ratio_loss
from promptir_tpu_torch.tools.parity import grad_errors
from promptir_tpu_torch.train.state import TrainState, make_optimizer
from promptir_tpu_torch.train.step import make_train_step
from test_torch_easy import (  # noqa: F401 (one_torch_thread: a fixture)
    flax_grads,
    forward_np,
    jax_variables,
    nchw,
    one_torch_thread,
    port_model,
)
from test_torch_train import GRAD_TOL
from test_torch_uformer import check_round_trip, run_jax

NAME = "capromptuformerir"
REDUCED = dict(embed_dim=8, depths=(1,) * 9)
SHAPE = (2, 128, 256, 3)  # the eval forwards'
TRAIN_SHAPE = (1, 128, 128, 3)


class Draws:
    """A seeded stream of uniforms over the JAX module's range, one array
    of the asked shape a call: the Gumbel draws both packages are fed."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape):
        return self.rng.uniform(camixer.GUMBEL_LO, 1.0, shape).astype(
            np.float32)


def jax_gumbel(draws):
    """promptir_tpu.ops.camixer.gumbel_softmax_hard on `draws`' uniforms:
    the JAX module's formula, its own jax.random draw replaced."""
    def gumbel_softmax_hard(rng, logits, axis=-1):
        u = jnp.asarray(draws(logits.shape))
        y = jax.nn.softmax(logits - jnp.log(-jnp.log(u)), axis=axis)
        hard = jax.nn.one_hot(jnp.argmax(y, axis=axis), y.shape[axis],
                              axis=axis, dtype=y.dtype)
        return hard + y - jax.lax.stop_gradient(y)

    return gumbel_softmax_hard


def port_draws(draws):
    return lambda shape, generator, device: torch.from_numpy(
        draws(tuple(shape))).to(device)


def test_camixer_v1_matches_golden(golden):
    """Measured 2.1e-6 of outputs up to 1.35; every window routed hard."""
    g = golden("camixer_v1")
    mixer = camixer.CAMixerV1(48, 8, ratio=1.0, cond_dim=2)
    mixer.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g.state_dict.items()}, strict=True)
    with torch.no_grad():
        y, decision = mixer(torch.from_numpy(g.x_nhwc.copy()),
                            torch.from_numpy(g.cond_nhwc.copy()))
    assert decision.item() == 1.0
    np.testing.assert_allclose(y.numpy(), g.y_nhwc, rtol=5e-5, atol=5e-5)


def grid_sample_warp(x, flow):
    """basicsr's flow_warp through torch grid_sample (border,
    align_corners=True), NHWC in and out."""
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    _, _, h, w = xt.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    vgrid = torch.stack((gx, gy), 2)[None] + torch.from_numpy(flow)
    vx = 2.0 * vgrid[..., 0] / max(w - 1, 1) - 1.0
    vy = 2.0 * vgrid[..., 1] / max(h - 1, 1) - 1.0
    out = F.grid_sample(xt, torch.stack((vx, vy), 3), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.numpy().transpose(0, 2, 3, 1)


def test_flow_warp_matches_jax_and_grid_sample():
    """fp32 within 1e-6 of JAX (measured 0: the same formula) and within
    1e-5 of grid_sample (measured 1.7e-6); bf16 bit-equal to JAX's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    flow = (rng.normal(size=(2, 9, 11, 2)) * 3).astype(np.float32)
    ours = flow_warp(torch.from_numpy(x), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jax_flow_warp(jnp.asarray(x), jnp.asarray(flow))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, grid_sample_warp(x, flow), rtol=1e-5,
                               atol=1e-5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_flow_warp(xb, jnp.asarray(flow)).astype(jnp.float32))
    got = flow_warp(torch.from_numpy(np.asarray(xb.astype(jnp.float32)))
                    .bfloat16(), torch.from_numpy(flow))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_topk_window_mask_keeps_ties():
    scores = torch.tensor([[0.9, 0.1, 0.5, 0.7], [0.2, 0.8, 0.3, 0.4],
                           [0.5, 0.5, 0.5, 0.1]])
    want = [[1, 0, 0, 1], [0, 1, 0, 1], [1, 1, 1, 0]]
    m = camixer.topk_window_mask(scores, 2)
    assert m.tolist() == want  # the tie keeps 3 of 4, not 2
    np.testing.assert_array_equal(
        np.asarray(jax_camixer.topk_window_mask(jnp.asarray(scores.numpy()),
                                                2)), want)
    assert camixer.topk_window_mask(scores, 4).tolist() == [[1.0] * 4] * 3


@pytest.mark.parametrize("n,ratio,k", [(5, 0.5, 2), (7, 0.5, 4), (1, 0.5, 1),
                                       (3, 0.5, 2), (9, 0.5, 4), (4, 1.0, 4),
                                       (4, 0.25, 1), (6, 0.25, 2)])
def test_route_mask_rounds_half_to_even(n, ratio, k):
    """k = max(1, round(n * ratio)) with Python's round (2.5 -> 2, 3.5 -> 4,
    0.5 -> 0 -> 1, 1.5 -> 2, 4.5 -> 4), n at ratio >= 1, as JAX's."""
    assert camixer.keep_count(n, ratio) == k
    scores = torch.rand(2, n, 2, generator=torch.Generator().manual_seed(n))
    mask = camixer.route_mask(scores, ratio, True)
    assert mask.shape == (2, n, 1) and mask.sum((1, 2)).tolist() == [k, k]
    want = jax_camixer.route_mask(jnp.asarray(scores.numpy()), ratio, True, None)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_gumbel_softmax_hard_equals_jax_on_the_same_uniforms():
    """The one-hot value and the soft sample's gradient (straight through)."""
    rng = np.random.default_rng(1)
    logits = rng.uniform(size=(2, 7, 2)).astype(np.float32)
    w = rng.normal(size=(2, 7, 2)).astype(np.float32)
    u = Draws(2)((2, 7, 2))
    jax_fn = jax_gumbel(lambda shape: u)

    def jax_loss(lg):
        return jnp.sum(jax_fn(None, lg, 2) * w)

    want = np.asarray(jax_fn(None, jnp.asarray(logits), 2))
    want_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(logits)))
    lt = torch.from_numpy(logits).requires_grad_()
    got = camixer.gumbel_softmax_hard(lt, torch.from_numpy(u), dim=2)
    (got * torch.from_numpy(w)).sum().backward()
    # (hard + y) - y: one-hot up to the rounding of y, which differs by an
    # ulp between the two softmaxes
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.detach().numpy().round(), want.round())
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, rtol=0, atol=1e-6)


def test_gumbel_uniform_draws_from_the_generator():
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    u = camixer.gumbel_uniform((4, 5, 2), g1, "cpu")
    assert torch.equal(u, camixer.gumbel_uniform((4, 5, 2), g2, "cpu"))
    assert u.min() >= camixer.GUMBEL_LO and u.max() < 1.0


@pytest.fixture(scope="module")
def jax_side():
    """(variables, {ratio: (x, JAX eval forward)}, (x, y, JAX training
    output, decision, loss, {parameter: gradient})): the eval forwards at
    B2 128x256, the JAX step's stochastic loss (L1 + ratio loss, as
    promptir_tpu/train/step.py:loss_fn with the trainer's v1 aux loss) on
    Draws(5), jitted, at B1 128x128."""
    variables = jax_variables(NAME, REDUCED, TRAIN_SHAPE, 11)
    rng = np.random.default_rng(12)
    x = rng.uniform(size=SHAPE).astype(np.float32)
    xt = rng.uniform(size=TRAIN_SHAPE).astype(np.float32)
    yt = rng.uniform(size=TRAIN_SHAPE).astype(np.float32)
    jmodel = jax_create_model(NAME, **REDUCED)

    def loss(p):
        out, decision = jmodel.apply({"params": p}, jnp.asarray(xt), False,
                                     rngs={"gumbel": jax.random.PRNGKey(0)})
        value = (jax_l1_loss(out, jnp.asarray(yt))
                 + jax_ratio_loss(decision, jmodel.ratio))
        return value, (out, decision)

    jobs = [(jax_create_model(NAME, ratio=r, **REDUCED).apply, (variables, x))
            for r in (0.5, 1.0)]
    jobs.append((jax.value_and_grad(loss, has_aux=True), (variables["params"],)))
    with pytest.MonkeyPatch.context() as mp:  # traced inside
        mp.setattr(jax_camixer, "gumbel_softmax_hard", jax_gumbel(Draws(5)))
        y05, y10, ((value, (out, decision)), g) = run_jax(jobs)
    evals = {0.5: (x, np.asarray(y05)), 1.0: (x, np.asarray(y10))}
    train = (xt, yt, np.asarray(out), float(decision), float(value),
             flax_grads(g, NAME, REDUCED))
    return variables, evals, train


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_reduced_eval_forward_matches_jax(jax_side, ratio, monkeypatch):
    """Within 1e-5 of max |JAX| (measured ~2e-6 of outputs up to ~1.5); at
    0.5 every mixer keeps max(1, round(N / 2)) windows an image (more only
    on an exact tie of scores), at 1.0 all of them."""
    variables, evals, _ = jax_side
    x, want = evals[ratio]
    kept, real = [], camixer.route_mask

    def spy(scores, r, deterministic, u=None):
        mask = real(scores, r, deterministic, u)
        kept.append((scores[:, :, 0], mask[..., 0]))
        return mask

    monkeypatch.setattr(camixer, "route_mask", spy)
    model = port_model(NAME, REDUCED, variables, ratio=ratio)
    y = forward_np(model, x)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert len(kept) == 9
    for scores, mask in kept:
        n = scores.shape[1]
        k = camixer.keep_count(n, ratio)
        for s, m in zip(scores, mask):
            if m.sum() > k:  # only ties at the threshold keep more
                thresh = s.sort().values[n - k]
                assert (s[m.bool()] >= thresh).all() and (s == thresh).sum() > 1
            assert m.sum() >= k
        assert ratio < 1.0 or bool(mask.all())


def test_reduced_stochastic_loss_and_grads_match_jax(jax_side, monkeypatch):
    """On the same uniforms: the training output within 1e-5 of max |JAX|,
    the mean decision equal, the loss within 1e-6 of JAX's, every gradient
    within GRAD_TOL (measured: loss and decision bit-equal, gradients
    <= 3e-6)."""
    variables, _, (x, y, out_j, decision_j, loss_j, ref) = jax_side
    monkeypatch.setattr(camixer, "gumbel_uniform", port_draws(Draws(5)))
    model = port_model(NAME, REDUCED, variables, train=True)
    out, decision = model(nchw(x), deterministic=False)
    loss = l1_loss(out, nchw(y)) + ratio_loss(decision, model.ratio)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1),
                               out_j, rtol=0, atol=1e-5 * np.abs(out_j).max())
    assert decision.item() == decision_j and 0.0 < decision_j < 1.0
    assert abs(loss.item() - loss_j) <= 1e-6 * loss_j
    errs = grad_errors(
        {k: p.grad.numpy() for k, p in model.named_parameters()}, ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_flax_tree_round_trips(jax_side):
    check_round_trip(NAME, REDUCED, jax_side[0])


def test_default_config():
    with torch.device("meta"):
        model = create_model(NAME, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 103_104_001
    assert len(model.state_dict()) == 1628 + 4  # the prompt blocks' indices
    assert model.variant == "v1" and model.ratio == 0.5


def test_model_call_is_deterministic_in_train_mode():
    """create_model(train=True) leaves the model in train mode; model(x), as
    the engine, the runner and the eval step call it, still routes by top-k
    and returns the output alone."""
    torch.manual_seed(0)
    model = create_model(NAME, device="cpu", train=True, prompt=False,
                         **REDUCED)
    assert model.training
    x = torch.rand(1, 3, 128, 128)
    with torch.no_grad():
        y = model(x)
        assert torch.is_tensor(y) and torch.equal(y, model.eval()(x))


def test_a_resumed_run_draws_what_an_unbroken_run_draws(tmp_path, monkeypatch):
    """Two train steps; then a new run restored from the checkpoint after
    the first: its step draws the unbroken run's second step's uniforms and
    gives its loss. The two steps' draws differ."""
    drawn, real = [], camixer.gumbel_uniform
    monkeypatch.setattr(camixer, "gumbel_uniform",
                        lambda *a: drawn.append(real(*a)) or drawn[-1])
    batch = {k: torch.rand(1, 128, 128, 3,
                           generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(("degraded", "clean"))}

    def run():
        torch.manual_seed(0)
        model = create_model(NAME, device="cpu", train=True, prompt=False,
                             **REDUCED)
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
    assert state.step == 1
    resumed_loss = step(state, batch)["train_loss"].item()
    assert len(drawn) == len(unbroken) == len(first) == 9
    assert all(torch.equal(a, b) for a, b in zip(drawn, unbroken))
    assert not any(torch.equal(a, b) for a, b in zip(first, unbroken))
    assert resumed_loss == loss
