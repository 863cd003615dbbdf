"""The port's `--fused` and `--remat` training routes against the JAX package.

On the CPU every kernel wrapper runs its plain version, so these tests hold
the arithmetic and the routes; chip_smoke.py holds the kernels against the
plain versions on the card:
  * `LnBlock` (the whole TransformerBlock: mdta_stats, softmax, block_tail
    forward; `plain_ln_block` recomputed backward): its forward and the
    gradient of every input and weight against the JAX package's
    `ln_block(..., interpret=True)`, the Pallas kernels in interpret mode
    and their custom VJP, at test_pallas_kernels.py:386's shapes and bound
    (2e-3);
  * reduced PromptIR with `fused_ffn=True, remat=True`: its gradients
    against the plain model's at the bound of JAX's own test of that
    route (test_pallas_kernels.py:585: rtol 2e-3, atol 2e-4), and against
    JAX's jitted `value_and_grad` of the same configuration (GRAD_TOL);
  * `remat=True` and `remat=True, remat_levels=(1, 2)` at `decoder=False`,
    dim 8: the loss within 1e-6 and every gradient within 1e-5 of the plain
    model's (tests/test_train.py:157's bounds), the model's key tree and
    shapes those of JAX's `init` at `decoder=False`, and the loss and
    gradients against JAX's jitted ones;
  * bf16 compute with float32 weights under `fused_ffn=True`: the
    gradients within BF16_GRAD_TOL / BF16_GRAD_MEDIAN of JAX's jitted bf16
    ones;
  * the launches of a full-depth training step of each route, counted
    through a recording library on storage-less tensors, the recompute of
    a checkpointed block included;
  * `fused_ffn` on a model without it raises the JAX registry's
    ValueError; `remat` in the config, the model's TypeError.
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.compat.torch_ckpt import convert_state_dict
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.ops.pallas.autodiff import ln_block as jax_ln_block
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.config import Config
from promptir_tpu_torch.ops import autodiff
from promptir_tpu_torch.ops.cuda import block, build, gdfn, mdta, megablock, seam
from promptir_tpu_torch.train.losses import l1_loss
from promptir_tpu_torch.train.trainer import Trainer
from test_pallas_kernels import _block_weights
from test_torch_autograd import (
    gdfn_weights,
    jax_layout_gdfn,
    jax_layout_mdta,
    mdta_weights,
    t,
    torch_gdfn,
    torch_mdta,
)
from test_torch_train import (  # noqa: F401 (one_torch_thread: a fixture)
    BF16_GRAD_MEDIAN,
    BF16_GRAD_TOL,
    GRAD_TOL,
    REDUCED,
    one_torch_thread,
)

BF16 = torch.bfloat16
FUSED_KW = dict(num_blocks=(2, 2, 1, 1), num_refinement_blocks=2)
NO_DECODER = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                  decoder=False)
REMAT_VARIANTS = [dict(remat=True), dict(remat=True, remat_levels=(1, 2))]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def seeded_params(kw, seed=0):
    """The port's reduced PromptIR, its weights drawn from `seed` by torch,
    and the same weights as a flax params tree (the JAX package's
    converter): no JAX init to compile."""
    torch.manual_seed(seed)
    model = create_model("promptir", device="cpu", train=True, **kw)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model.state_dict(), convert_state_dict(sd)["params"]


def batch(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(size=shape).astype(np.float32) for _ in "xy")


def flax_init_params(kw, seed, x):
    """The JAX model's own init (jitted) and its weights as the port's
    state dict: the weights test_torch_train_grads.py's bf16 test runs on,
    on which BF16_GRAD_MEDIAN was measured."""
    variables = init_variables(jax_create_model("promptir", **kw), seed,
                               jnp.asarray(x))
    model = create_model("promptir", device="cpu", train=True, **kw)
    return state_dict_from_flax(variables, model), variables["params"]


# the JAX steps of this file: (model kwargs, dtype, batch shape, its seed,
# flax init seed or None for the port's seeded weights)
JAX_STEPS = {
    "fused_remat": (dict(FUSED_KW, fused_ffn=True, remat=True), jnp.float32,
                    (1, 32, 32, 3), 7, None),
    "bf16": (REDUCED, jnp.bfloat16, (2, 32, 48, 3), 0, 1),
    "no_decoder": (NO_DECODER, jnp.float32, (1, 32, 32, 3), 0, None),
}


@pytest.fixture(scope="module")
def jax_steps():
    """{key: (torch state dict, x, y, JAX loss, JAX gradients)} of
    JAX_STEPS: the jitted JAX value_and_grad of each model on the port's
    seeded weights, traced one after the other, then compiled and run in
    threads (XLA releases the GIL: the three take ~25 s side by side against
    ~47 s one after the other on the test host)."""
    jobs = {}
    for key, (kw, dtype, shape, seed, init_seed) in JAX_STEPS.items():
        x, y = batch(shape, seed)
        sizes = {k: v for k, v in kw.items() if k not in ("fused_ffn", "remat")}
        sd, params = (seeded_params(sizes) if init_seed is None
                      else flax_init_params(sizes, init_seed, x))
        jmodel = jax_create_model("promptir", dtype=dtype, **kw)

        def loss(p, m=jmodel, x=x, y=y):
            return jax_l1_loss(m.apply({"params": p}, jnp.asarray(x)),
                               jnp.asarray(y))

        lowered = jax.jit(jax.value_and_grad(loss)).lower(params)
        jobs[key] = (sd, x, y, lowered, params)

    def run(key):
        *_, lowered, params = jobs[key]
        loss, grads = jax.block_until_ready(lowered.compile()(params))
        return key, float(loss), grads

    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(run, jobs))
    return {key: (*jobs[key][:3], loss, grads) for key, loss, grads in done}


def trained_model(sd, dtype=torch.float32, **kw):
    model = create_model("promptir", device="cpu", train=True, dtype=dtype,
                         **kw)
    model.load_state_dict(sd, strict=True)
    return model


def torch_grads(model, x, y):
    """The port's L1 loss and {name: grad} (None for the dead convs)."""
    model.zero_grad(set_to_none=True)
    loss = l1_loss(model(nchw(x)), nchw(y))
    loss.backward()
    return loss.item(), {n: None if p.grad is None else p.grad.clone()
                         for n, p in model.named_parameters()}


def jax_grads_as_torch(grads, model):
    return state_dict_from_flax(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads)},
        model)


def port_block_weights(w, grad=False):
    """test_pallas_kernels.py:_block_weights in the port's layout, in
    LnBlock's order (after x)."""
    m = dict(lnw=w["ln1w"], lnb=w["ln1b"], wqkv=w["wqkv"], wdw=w["wdwa"],
             wproj=w["wproj"], temp=w["temp"])
    g = dict(lnw=w["ln2w"], lnb=w["ln2b"], w1=w["w1"], wdw=w["wdwf"],
             w2=w["w2"])
    m, g = ({k: np.asarray(v) for k, v in d.items()} for d in (m, g))
    return torch_mdta(m, grad) + torch_gdfn(g, grad)


def test_ln_block_matches_pallas_ln_block():
    """test_pallas_kernels.py:386 with the port on one side: forward and
    every gradient of sum(LnBlock(x)^2) against the JAX package's ln_block
    in interpret mode (its forward: the Pallas stats and tail kernels; its
    backward: jax.vjp of the unfused composition), same weights, 2e-3."""
    c, heads = 48, 2
    wts = _block_weights(c, heads, seed=13)
    x = np.random.default_rng(14).normal(size=(1, 16, 16, c)).astype(np.float32)
    order = ("ln1w", "ln1b", "wqkv", "wdwa", "wproj", "temp", "ln2w", "ln2b",
             "w1", "wdwf", "w2")

    def loss_j(x_, *w):
        out = jax_ln_block(x_, *w[:6], heads, *w[6:], interpret=True)
        return jnp.sum(jnp.square(out)), out

    (_, ref), g_ref = jax.value_and_grad(
        loss_j, argnums=tuple(range(12)), has_aux=True)(
        jnp.asarray(x), *(wts[k] for k in order))

    xt, ws = t(x, True), port_block_weights(wts, True)
    out = autodiff.LnBlock.apply(xt, *ws, heads, False, 1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)
    out.square().sum().backward()
    got = ([xt.grad.numpy()] + jax_layout_mdta([p.grad for p in ws[:6]])
           + jax_layout_gdfn([p.grad for p in ws[6:]]))
    for name, a, b in zip(("x",) + order, got, g_ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_ln_block_is_the_plain_composition_on_the_cpu():
    """On the CPU LnBlock's forward is the stats pass, the softmax and the
    plain block tail, launches nothing, and its gradients are those of
    plain_ln_block (the backward differentiates exactly that)."""
    c, heads = 48, 2
    wm, wg = mdta_weights(c, heads, seed=3), gdfn_weights(c, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 8, 12, c)).astype(np.float32)
    before = [f.launches for f in (mdta.mdta_stats, block.block_tail)]
    grads = []
    for fn in (autodiff.LnBlock.apply, autodiff.plain_ln_block):
        xt, ws = t(x, True), torch_mdta(wm, True) + torch_gdfn(wg, True)
        out = fn(xt, *ws, heads, False, 1e-5)
        out.sum().backward()
        grads.append([xt.grad] + [p.grad for p in ws])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in (mdta.mdta_stats, block.block_tail)] == before


def test_fused_remat_promptir_grads_match_plain_and_jax(jax_steps):
    """Reduced PromptIR (2, 2, 1, 1 blocks, 2 refinement) with fused_ffn and
    remat: every block one LnBlock, unwrapped. Its gradients against the
    plain model's (the per-branch route) at JAX's bound for the same
    comparison, and its loss and gradients against JAX's jitted ones of the
    same configuration (the JAX model's fused blocks fall back to plain XLA
    on the CPU)."""
    sd, x, y, loss_j, grads_j = jax_steps["fused_remat"]
    loss_p, g_plain = torch_grads(trained_model(sd, **FUSED_KW), x, y)
    fused = trained_model(sd, fused_ffn=True, remat=True, **FUSED_KW)
    loss_f, g_fused = torch_grads(fused, x, y)
    assert abs(loss_f - loss_p) <= 1e-6 * loss_p
    assert abs(loss_f - loss_j) <= 1e-6 * loss_j
    ref = jax_grads_as_torch(grads_j, fused)
    dead = 0
    for name, g in g_fused.items():
        if g is None:
            assert g_plain[name] is None and not ref[name].numpy().any(), name
            dead += 1
            continue
        np.testing.assert_allclose(g.numpy(), g_plain[name].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)
        want = ref[name].numpy()
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (name, err)
    assert dead == 6


def test_no_decoder_model_has_jax_init_key_tree(jax_steps):
    """decoder=False: no prompts, noise blocks or reduce_noise_level convs;
    up4_3's conv reads the latent's 8d channels, as flax infers it. The
    state dict converts from the shapes of JAX's init (jax.eval_shape) leaf
    for leaf, and the model's loss and gradients are JAX's."""
    sd, x, y, loss_j, grads_j = jax_steps["no_decoder"]
    model = trained_model(sd, **NO_DECODER)
    shapes = jax.eval_shape(jax_create_model("promptir", **NO_DECODER).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    model.load_state_dict(state_dict_from_flax(zeros, model), strict=True)
    model.load_state_dict(sd, strict=True)
    names = [n for n, _ in model.named_parameters()]
    assert not [n for n in names if n.startswith(
        ("prompt", "noise_level", "reduce_noise_level"))]
    assert model.up4_3.body[0].weight.shape == (64, 64, 3, 3)
    loss, grads = torch_grads(model, x, y)
    assert abs(loss - loss_j) <= 1e-6 * loss_j
    ref = jax_grads_as_torch(grads_j, model)
    dead = 0
    for name, g in grads.items():
        want = ref[name].numpy()
        if g is None:
            assert not want.any(), name
            dead += 1
            continue
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (name, err)
    assert dead == 6


@pytest.mark.parametrize("variant", REMAT_VARIANTS,
                         ids=["remat", "remat_levels_1_2"])
def test_remat_preserves_loss_and_grads(jax_steps, variant):
    """The checkpointed blocks recompute the same forward: the loss within
    1e-6 and every gradient within 1e-5 (atol 1e-7) of the plain model's,
    as JAX's test of its remat variants; the loss within 1e-6 of JAX's."""
    sd, x, y, loss_j, _ = jax_steps["no_decoder"]
    loss_p, g_plain = torch_grads(trained_model(sd, **NO_DECODER), x, y)
    loss_r, g_remat = torch_grads(trained_model(sd, **NO_DECODER, **variant),
                                  x, y)
    np.testing.assert_allclose(loss_r, loss_p, rtol=1e-6)
    assert abs(loss_r - loss_j) <= 1e-6 * loss_j
    for name, g in g_remat.items():
        if g is None:
            assert g_plain[name] is None, name
            continue
        np.testing.assert_allclose(g.numpy(), g_plain[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_fused_bf16_grads_match_jax(jax_steps):
    """Reduced PromptIR computing in bf16 with float32 weights under
    fused_ffn=True, on the weights and batch of test_torch_train_grads.py's
    bf16 test: every gradient within BF16_GRAD_TOL of that tensor's max
    |grad| in JAX's jitted bf16 step (fused_ffn=False: the JAX model's
    fused blocks run the same XLA composition on the CPU), the median over
    tensors within BF16_GRAD_MEDIAN, the loss within 2e-4. Measured: a
    median of 0.0089 at one thread, 0.0086 at eight (the per-branch route
    0.0083 and 0.0086)."""
    sd, x, y, loss_j, grads_j = jax_steps["bf16"]
    model = trained_model(sd, dtype=BF16, fused_ffn=True, **REDUCED)
    loss, grads = torch_grads(model, x, y)
    assert abs(loss - loss_j) <= 2e-4 * loss_j
    ref = jax_grads_as_torch(grads_j, model)
    errs = []
    for name, g in grads.items():
        want = ref[name].numpy()
        if g is None:
            assert not want.any(), name
            continue
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= BF16_GRAD_TOL, (name, err)
        errs.append(err)
    assert len(errs) == len(grads) - 6
    assert np.median(errs) <= BF16_GRAD_MEDIAN, np.median(errs)


# the reference's training config of the X-Restormers (the smoke's XR_TRAIN)
XR_TRAIN = dict(num_blocks=(2, 4, 4, 4), num_refinement_blocks=4,
                channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))
COUNTED = (mdta.mdta_stats, block.block_tail, gdfn.ln_gdfn, seam.seam,
           mdta.ln_mdta, megablock.tail_stats, mdta.mdta_gram)
# a full-depth bf16 training step's launches of stats/tail/ln_gdfn/seam/
# ln_mdta/tail_stats/gram, B6 128x128
STEP_LAUNCHES = [
    ("promptir", {}, (47, 0, 47, 1, 47, 0, 2)),
    ("promptir", dict(fused_ffn=True), (47, 47, 0, 1, 0, 0, 2)),
    ("promptir", dict(fused_ffn=True, remat=True), (47, 47, 0, 1, 0, 0, 2)),
    ("promptir", dict(remat=True), (94, 0, 94, 1, 94, 0, 4)),
    ("promptir", dict(remat=True, remat_levels=(1, 2)),
     (72, 0, 72, 1, 72, 0, 2)),
    ("promptxrestormerir", dict(XR_TRAIN, fused_ffn=True),
     (31, 31, 31, 0, 0, 0, 15)),
    ("promptxrestormereffir", dict(XR_TRAIN, fused_ffn=True),
     (31, 31, 28, 0, 0, 0, 15)),
]


@pytest.fixture
def recording_library(monkeypatch):
    """Every wrapper launches into a library that only answers the
    shared-memory queries; the counters come back as they were."""
    for fn in COUNTED:
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(build, "on_card_of",
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_of", lambda t: 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)

    def function(name, argtypes, restype=None):
        if name == "block_tail_smem":
            return lambda dtype, c: 0
        if name == "mdta_stats_smem":
            return lambda dtype, th, tw, c, heads, wide: mdta.stats_smem(
                c, heads, BF16, (th, tw))
        return lambda *args: 0

    monkeypatch.setattr(build, "function", function)


@pytest.mark.parametrize("name,kw,want", STEP_LAUNCHES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_training_step_launches(recording_library, name, kw, want):
    """One bf16 training step of the full-depth model on storage-less
    tensors: the forward's kernels, and under remat the recompute's in the
    backward. A whole (fused) block launches mdta_stats and block_tail, a
    per-branch block ln_mdta (with its stats pass) and ln_gdfn."""
    model = create_model(name, device="meta", dtype=BF16, train=True, **kw)
    x = torch.zeros(6, 3, 128, 128, device="meta")
    l1_loss(model(x), x).backward()
    assert tuple(f.launches for f in COUNTED) == want
    assert all(p.grad is not None for p in model.encoder_level1.parameters())


def test_fused_ffn_on_a_model_without_it_raises_the_registry_error():
    """The JAX registry's message; `fused_ffn=False` stays the model's own
    TypeError in both packages."""
    for make in (lambda **k: create_model("nafnet", device="cpu", **k),
                 lambda **k: jax_create_model("nafnet", **k)):
        with pytest.raises(ValueError) as e:
            make(fused_ffn=True)
        assert str(e.value).startswith(
            "model 'nafnet' has no fused Pallas path (fused_ffn/--fused")
        with pytest.raises(TypeError, match="fused_ffn"):
            make(fused_ffn=False)


def test_trainer_passes_remat_and_a_model_without_it_raises(tmp_path):
    cfg = Config()
    cfg.system.device = "cpu"
    cfg.system.remat, cfg.system.remat_levels = True, (1, 2)
    cfg.train.model = "promptir"
    cfg.train.ckpt_dir, cfg.train.log_dir = str(tmp_path / "c"), str(tmp_path)
    trainer = Trainer(cfg, dataset=[None])
    assert (trainer.model.remat, trainer.model.remat_levels) == (True, (1, 2))
    cfg.train.model = "xrestormerir"
    with pytest.raises(TypeError, match="remat"):
        Trainer(cfg, dataset=[None])
