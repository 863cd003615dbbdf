"""The port's CAMixer v2 and the CAMixer X-Restormers v1 and v2
(`capromptxrestormereff`, `capromptxrestormereffv2`) on the CPU, against
the reference's goldens and the JAX package:

  * CAMixerV2 and the v1 and v2 blocks against their goldens (16x16, ratio
    1) within 5e-5, and one block a level at dim 48 (`ca_v1_small`,
    `ca_v2_small`, 64x64, ratio 1) within 2e-4, the JAX suite's bounds;
  * v2's router builds no offsets and no channel gate; the training config
    of v2 has the 1,126 keys and shapes of the reference's state dict, and
    a reference-layout state dict of random values loads with strict=True
    through compat/torch_ckpt.py; the parameter counts of both models at
    the training config and the JAX defaults;
  * one block a level (dim 16, the training config's heads, prompts on)
    with seeded weights carried across from the JAX tree, B2 64x128: the
    fp32 eval forward at ratio 0.5 and 1.0 within 1e-5 of max |JAX| (at 0.5
    each mixer keeps max(1, round(N / 2)) windows an image, more only on a
    tie), the bf16 forward at ratio 1 within BF16_MODEL_TOL, and the
    stochastic training loss (L1 plus v1's ratio loss or v2's in-model
    ratio loss) and every fp32 gradient against the JAX step's, on the
    same Gumbel uniforms (tests/test_torch_camixer.py:Draws); the flax tree
    round-trips;
  * the served and training forwards of the training config call the
    kernel layer as chip_smoke.py gates it; the CLIs take both models.

The JAX programs are traced one by one and compiled side by side
(test_torch_uformer.py:run_jax), one module fixture for the file.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promptir_tpu.ops.camixer as jax_camixer
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu.train.losses import ratio_loss as jax_ratio_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.compat.torch_ckpt import load_checkpoint
from promptir_tpu_torch.models.camixer_models import CATransformerBlock
from promptir_tpu_torch.ops import camixer
from promptir_tpu_torch.tools.parity import grad_errors
from promptir_tpu_torch.train.losses import l1_loss, ratio_loss
from test_torch_camixer import Draws, jax_gumbel, port_draws
from test_torch_easy import (  # noqa: F401 (one_torch_thread: a fixture)
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

V1, V2 = "capromptxrestormereff", "capromptxrestormereffv2"
MODELS = (V1, V2)
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
# the reference's training config (chip_smoke.py's CA_TRAIN)
CA_TRAIN = dict(num_blocks=(2, 4, 4, 4), num_refinement_blocks=4,
                channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))
REDUCED = dict(CA_TRAIN, dim=16, num_blocks=(1, 1, 1, 1),
               num_refinement_blocks=1)
SHAPE = (2, 64, 128, 3)
BLOCK_TOL = dict(rtol=5e-5, atol=5e-5)


def with_draws(draws, fn):
    """fn with the JAX package's Gumbel sample taking `draws`' uniforms while
    it is traced."""
    def traced(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_camixer, "gumbel_softmax_hard", jax_gumbel(draws))
            return fn(*args)
    return traced


def jax_training_loss(name, x, y, variant):
    """The JAX step's stochastic loss (promptir_tpu/train/step.py:loss_fn
    with the trainer's aux losses: v1's ratio loss of its mean decision, the
    others' returned losses summed), with the output and the aux outputs."""
    jmodel = jax_create_model(name, **REDUCED)

    def loss(p):
        out, *aux = jmodel.apply({"params": p}, jnp.asarray(x), False,
                                 rngs={"gumbel": jax.random.PRNGKey(0)})
        extra = (jax_ratio_loss(aux[0], jmodel.ratio) if variant == "v1"
                 else sum(aux))
        return jax_l1_loss(out, jnp.asarray(y)) + extra, (out, aux)

    return jax.value_and_grad(loss, has_aux=True)


@pytest.fixture(scope="module")
def jax_sides():
    """{name: (variables, {("fp32", ratio) or ("bf16", 1.0): JAX eval
    output}, (JAX training loss, output, aux, {parameter: gradient}))} on
    one (2, 64, 128, 3) input x and target y; the training steps on
    Draws(seed)."""
    rng = np.random.default_rng(20)
    x = rng.uniform(size=SHAPE).astype(np.float32)
    y = rng.uniform(size=SHAPE).astype(np.float32)
    jobs, variables = [], {}
    for i, (name, variant) in enumerate(((V1, "v1"), (V2, "v2"))):
        variables[name] = v = jax_variables(name, REDUCED, SHAPE, 21 + i)
        for ratio in (0.5, 1.0):
            jobs.append((jax_create_model(name, ratio=ratio, **REDUCED).apply,
                         (v, x)))
        jobs.append((jax_create_model(name, dtype=jnp.bfloat16, ratio=1.0,
                                      **REDUCED).apply, (v, x)))
        jobs.append((with_draws(Draws(31 + i),
                                jax_training_loss(name, x, y, variant)),
                     (v["params"],)))
    results = iter(run_jax(jobs))
    sides = {}
    for name in MODELS:
        evals = {("fp32", 0.5): next(results), ("fp32", 1.0): next(results),
                 ("bf16", 1.0): next(results)}
        (value, (out, aux)), g = next(results)
        sides[name] = (variables[name],
                       {k: np.asarray(o) for k, o in evals.items()},
                       (float(value), np.asarray(out),
                        [float(a) for a in aux], flax_grads(g, name, REDUCED)))
    return x, y, sides


@pytest.mark.parametrize("file", ["camixer_v2", "ca_block_v1", "ca_block_v2"])
def test_block_matches_golden(golden, file):
    """At ratio 1 every window is routed hard (measured <= 2e-6)."""
    g = golden(file)
    mixers = {
        "camixer_v2": lambda: camixer.CAMixerV2(48, 8, 0.5, 2, 16, ratio=1.0,
                                                cond_dim=2),
        "ca_block_v1": lambda: CATransformerBlock(
            48, camixer.CAMixerV1(48, 8, 1.0, cond_dim=2), 2),
        "ca_block_v2": lambda: CATransformerBlock(
            48, camixer.CAMixerV2(48, 8, 0.5, 2, 16, 1.0, cond_dim=2), 2),
    }
    module = load_golden(mixers[file](), g)
    with torch.no_grad():
        y, decision = module(torch.from_numpy(g.x_nhwc.copy()),
                             torch.from_numpy(g.cond_nhwc.copy()))
    assert decision.item() == 1.0
    np.testing.assert_allclose(y.numpy(), g.y_nhwc, **BLOCK_TOL)


@pytest.mark.parametrize("name,file", [(V1, "ca_v1_small"),
                                       (V2, "ca_v2_small")])
def test_small_model_matches_golden(golden, name, file):
    """One block a level at dim 48 (the JAX defaults' heads), ratio 1: the
    reference's own 64x64 output within 2e-4."""
    g = golden(file)
    model = load_golden(create_model(
        name, device="cpu", num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
        ratio=1.0), g)
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32 and y.shape == g.x.shape
    np.testing.assert_allclose(y.numpy(), g.y, rtol=2e-4, atol=2e-4)


def test_v2_router_has_no_offsets_and_no_channel_gate():
    mixer = camixer.CAMixerV2(32, 8, 0.5, 2, 16, cond_dim=2)
    keys = {k for k in mixer.state_dict() if k.startswith("route.")}
    assert keys == {f"route.{k}" for k in (
        "in_conv.0.weight", "in_conv.0.bias", "in_conv.1.weight",
        "in_conv.1.bias", "out_SA.0.weight", "out_SA.0.bias",
        "out_mask.0.weight", "out_mask.0.bias", "out_mask.2.weight",
        "out_mask.2.bias")}
    assert mixer.route.in_conv[0].weight.shape == (9, 36, 1, 1)
    v1 = camixer.CAMixerV1(32, 8, cond_dim=2)
    assert {"route.out_offsets.0.weight", "route.out_CA.1.weight"} <= set(
        v1.state_dict())


def test_v2_training_config_has_the_reference_keys_and_loads_strict(tmp_path):
    """The 1,126 names and shapes of tests/goldens/
    sd_keys_capromptxrestormereffv2.json; a Lightning-style checkpoint of
    random values in that layout loads with strict=True."""
    ref = json.loads((GOLDENS / f"sd_keys_{V2}.json").read_text())
    with torch.device("meta"):
        model = create_model(V2, device="meta", **CA_TRAIN)
    sd = model.state_dict()
    assert len(ref) == len(sd) == 1126
    assert {k: list(v.shape) for k, v in sd.items()} == {
        k: v["shape"] for k, v in ref.items()}
    rng = np.random.default_rng(0)
    state = {"model." + k: torch.from_numpy(
        rng.normal(size=v["shape"]).astype(np.float32)) for k, v in ref.items()}
    torch.save({"state_dict": state}, tmp_path / "v2.ckpt")
    model = create_model(V2, device="cpu", **CA_TRAIN)
    load_checkpoint(model, str(tmp_path / "v2.ckpt"))
    key = "encoder_level2.layer.0.spatial_attn.rel_pos_emb.rel_height"
    assert torch.equal(model.state_dict()[key], state["model." + key])


@pytest.mark.parametrize("name,train_cfg,default", [
    (V1, (38_722_636, 1350), (58_729_284, 2086)),
    (V2, (35_350_452, 1126), (52_745_900, 1734))])
def test_parameter_counts(name, train_cfg, default):
    """The JAX trees' sizes (jax.eval_shape) at the training config and at
    the JAX defaults."""
    for kw, (params, tensors) in ((CA_TRAIN, train_cfg), ({}, default)):
        with torch.device("meta"):
            model = create_model(name, device="meta", **kw)
        assert sum(p.numel() for p in model.parameters()) == params
        assert len(model.state_dict()) == tensors
        assert model.variant == ("v1" if name == V1 else "v2")


def check_window_counts(kept, ratio):
    """Each mixer's mask keeps max(1, round(N * ratio)) windows an image, more
    only on a tie of scores at the threshold."""
    for scores, mask in kept:
        n = scores.shape[1]
        k = camixer.keep_count(n, ratio)
        for s, m in zip(scores, mask):
            if m.sum() > k:
                thresh = s.sort().values[n - k]
                assert (s[m.bool()] >= thresh).all() and (s == thresh).sum() > 1
            assert m.sum() >= k
        assert ratio < 1.0 or bool(mask.all())


def spy_route_mask(monkeypatch):
    kept, real = [], camixer.route_mask

    def spy(scores, r, deterministic, u=None):
        mask = real(scores, r, deterministic, u)
        kept.append((scores[:, :, 0], mask[..., 0]))
        return mask

    monkeypatch.setattr(camixer, "route_mask", spy)
    return kept


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_reduced_eval_forward_matches_jax(jax_sides, name, ratio, monkeypatch):
    """fp32 within 1e-5 of max |JAX| (measured ~2e-6); 8 mixers."""
    x, _, sides = jax_sides
    variables, evals, _ = sides[name]
    want = evals[("fp32", ratio)]
    kept = spy_route_mask(monkeypatch)
    y = forward_np(port_model(name, REDUCED, variables, ratio=ratio), x)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert len(kept) == 8
    check_window_counts(kept, ratio)


@pytest.mark.parametrize("name", MODELS)
def test_reduced_bf16_forward_matches_jax_at_ratio_1(jax_sides, name):
    """The served bf16 model (bf16 weights) against the jitted JAX model
    with dtype=bfloat16 on the same float32 weights, ratio 1 (every window
    hard, so bf16 score ties cannot route differently): BF16_MODEL_TOL."""
    x, _, sides = jax_sides
    variables, evals, _ = sides[name]
    model = port_model(name, REDUCED, variables, dtype=torch.bfloat16,
                       ratio=1.0)
    err = np.abs(forward_np(model, x) - evals[("bf16", 1.0)]).max()
    assert err <= BF16_MODEL_TOL, err


@pytest.mark.parametrize("name", MODELS)
def test_reduced_stochastic_loss_and_grads_match_jax(jax_sides, name,
                                                     monkeypatch):
    """On the same uniforms: the training output within 1e-5 of max |JAX|,
    the aux output (v1's mean decision, v2's ratio loss) within 1e-6, the
    loss within 1e-6 of JAX's, every gradient within GRAD_TOL of its own
    max (tools/parity.py:grad_errors: project_k's bias, zero in exact
    arithmetic, of the median tensor's)."""
    x, y, sides = jax_sides
    variables, _, (loss_j, out_j, aux_j, ref) = sides[name]
    monkeypatch.setattr(camixer, "gumbel_uniform",
                        port_draws(Draws(31 + MODELS.index(name))))
    model = port_model(name, REDUCED, variables, train=True)
    out, aux = model(nchw(x), deterministic=False)
    extra = ratio_loss(aux, model.ratio) if name == V1 else aux
    loss = l1_loss(out, nchw(y)) + extra
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1),
                               out_j, rtol=0, atol=1e-5 * np.abs(out_j).max())
    assert abs(aux.item() - aux_j[0]) <= 1e-6
    assert abs(loss.item() - loss_j) <= 1e-6 * loss_j
    errs = grad_errors(
        {k: p.grad.numpy() for k, p in model.named_parameters()}, ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("name", MODELS)
def test_flax_tree_round_trips(jax_sides, name):
    check_round_trip(name, REDUCED, jax_sides[2][name][0])


@pytest.mark.parametrize("name", MODELS)
def test_without_prompts_the_tree_is_jax_and_it_runs(name):
    """flax infers up4_3's input width from the latent (8d)."""
    tree = jax.eval_shape(lambda: jax_create_model(
        name, prompt=False, **REDUCED).init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    model = create_model(name, device="cpu", prompt=False, **REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    assert not any(k.startswith(("prompt", "noise_level"))
                   for k in model.state_dict())
    with torch.no_grad():
        out = model(torch.rand(1, 3, 64, 128))
    assert out.shape == (1, 3, 64, 128) and torch.isfinite(out).all()


def count_kernel_calls(monkeypatch, run):
    """Calls of models/blocks.py's kernel entry points (and of the wide
    stats route, which launches the Gram kernel) while `run()` runs."""
    from types import SimpleNamespace

    from promptir_tpu_torch.models import blocks
    from promptir_tpu_torch.ops.cuda.mdta import stats_route

    calls = {}

    def spy(name, fn, wide=False):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            if wide and stats_route(a[0].shape[-1], a[5]) == "wide":
                calls["mdta_gram"] = calls.get("mdta_gram", 0) + 1
            return fn(*a, **kw)
        return wrapped

    with monkeypatch.context() as mp:
        for name in ("block_tail", "ln_gdfn"):
            mp.setattr(blocks, name, spy(name, getattr(blocks, name)))
        mp.setattr(blocks, "mdta_stats",
                   spy("mdta_stats", blocks.mdta_stats, wide=True))
        for name in ("LnMdta", "LnGdfn"):
            fn = getattr(blocks, name)
            mp.setattr(blocks, name, SimpleNamespace(apply=spy(name, fn.apply)))
        run()
    return calls


@pytest.mark.parametrize("name", MODELS)
def test_the_training_config_runs_the_kernels_the_smoke_gates(name,
                                                              monkeypatch):
    """A served forward of the training config: mdta_stats and block_tail 31
    times (28 CA blocks, 3 channel prompt blocks), ln_gdfn 28 (the spatial
    FFNs), 15 stats calls on the wide route (the Gram kernel: the one-head
    widths from 160); a training forward LnMdta 31 and LnGdfn 59 (at dim 8,
    where the counts do not hang on the width)."""
    torch.manual_seed(0)
    model = create_model(name, device="cpu", **CA_TRAIN)

    def serve():
        with torch.no_grad():
            model(torch.rand(1, 3, 64, 64))

    assert count_kernel_calls(monkeypatch, serve) == {
        "mdta_stats": 31, "block_tail": 31, "ln_gdfn": 28, "mdta_gram": 15}
    model = create_model(name, device="cpu", train=True, dim=8, **CA_TRAIN)
    calls = count_kernel_calls(monkeypatch, lambda: model(
        torch.rand(1, 3, 64, 64), deterministic=False,
        generator=torch.Generator().manual_seed(0)))
    assert calls == {"LnMdta": 31, "LnGdfn": 59}


def clis_take(name, tmp_path, monkeypatch):
    """cli/train.py trains `name` for one synthetic step (B2 64x64),
    cli/demo.py restores an odd-sized PNG through it and cli/serve.py serves
    it at pad base 64, with create_model wrapped to one block a level at
    dim 8 without prompts."""
    import threading
    import urllib.request

    from promptir_tpu_torch import models
    from promptir_tpu_torch.cli import demo, serve, train
    from promptir_tpu_torch.data import synthetic
    from promptir_tpu_torch.train import trainer as trainer_mod
    from promptir_tpu_torch.utils.png import decode_png, encode_png, write_png

    real = models.create_model

    def reduced(model_name, **kw):
        return real(model_name, **{**REDUCED, "dim": 8, "prompt": False, **kw})

    monkeypatch.setattr(models, "create_model", reduced)
    monkeypatch.setattr(trainer_mod, "create_model", reduced)
    small = synthetic.SyntheticTrainDataset
    monkeypatch.setattr(synthetic, "SyntheticTrainDataset",
                        lambda **kw: small(n=2, **kw))
    tiny = ["--model", name, "--device", "cpu"]
    trainer = train.main(["--synthetic", "--patch_size", "64", "--batch_size",
                          "2", "--epochs", "1", "--ckpt_dir",
                          str(tmp_path / "ckpt"), "--log_dir", str(tmp_path),
                          *tiny])
    assert trainer.global_step == 1
    img = np.random.default_rng(6).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    demo.main(["--test_path", str(tmp_path / "in.png"),
               "--output_path", str(tmp_path / "demo"), *tiny])
    assert decode_png((tmp_path / "demo" / "in.png").read_bytes()).shape == \
        (32, 64, 3)  # crop-16
    args = serve.build_parser().parse_args(["--port", "0", "--max_batch", "1",
                                            *tiny])
    httpd, engine = serve.make_server(args)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["model"] == name and health["pad_base"] == 64
        req = urllib.request.Request(url + "/restore", data=encode_png(img),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert decode_png(r.read()).shape == img.shape
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        th.join(timeout=30)
    return trainer


@pytest.mark.parametrize("name", MODELS)
def test_the_clis_take_the_model(name, tmp_path, monkeypatch):
    trainer = clis_take(name, tmp_path, monkeypatch)
    assert type(trainer.model).__name__ == {
        V1: "CAPromptXRestormerEff", V2: "CAPromptXRestormerEffv2"}[name]
