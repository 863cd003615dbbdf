"""The port's Easy blocks and EasyPromptXRestormer (`easypromptxrestormer`)
on the CPU, against the reference's goldens and the JAX package:

  * the blocks against their goldens within 3e-5, the JAX suite's bound;
    one block a level against `easy_prompt_xrestormer_small.npz` within
    1e-4, its weights loaded verbatim from a Lightning `.ckpt` through
    compat/torch_ckpt.py;
  * the default config: 1,619 tensors, 35,223,771 parameters, every key
    at the flax path that compat/jax_params.py:flax_path names;
  * one block a level on a (2, 32, 56, 3) batch with seeded weights carried
    across from the JAX tree: the forward in fp32 within 1e-5, in bf16
    within test_torch_precision.py's BF16_MODEL_TOL served and training,
    the L1 loss and every gradient within test_torch_train.py's
    X-Restormer bounds in fp32; in bf16 the loss within its bound and each
    gradient as exact as JAX's bf16 one on the same step, within a factor
    (check_bf16_grads says why not the X-Restormer's bf16 bounds);
  * a bf16 EasyTransformerBlock keeps its stream in bf16, as JAX's does;
  * the engine serves odd sizes at pad base 8; the CLIs take the model;
  * no kernel wrapper of the port runs on its forward or its backward, and
    the launch counters stay 0.

The JAX variables come from `jax.eval_shape` of the init, filled by a
seeded numpy generator (an eager init of the reduced model takes ~46 s).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.ops.easy import EasyTransformerBlock as JaxEasyBlock
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import flax_path, state_dict_from_flax
from promptir_tpu_torch.compat.torch_ckpt import load_checkpoint
from promptir_tpu_torch.eval.padding import pad_bases
from promptir_tpu_torch.ops.easy import (
    EasyChannelTransformerBlock,
    EasyTransformerBlock,
    round_to_nearest_power_of_2,
)
from promptir_tpu_torch.serve.engine import InferenceEngine, pad_image_np
from promptir_tpu_torch.train.losses import l1_loss
from test_torch_precision import BF16_MODEL_TOL
from test_torch_train import (  # noqa: F401 (one_torch_thread: a fixture)
    GRAD_TOL,
    one_torch_thread,
)

NAME = "easypromptxrestormer"
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
SHAPE = (2, 32, 56, 3)


# ------------------------------------------------------------ shared helpers

def filled(tree, seed):
    """Seeded numpy values for a flax shape tree: conv and dense kernels
    uniform within 1/sqrt(fan_in) (torch's default scale), LayerNorm weights
    near 1, biases near 0, prompt banks uniform, NAFBlock's beta and gamma
    N(0, 0.3) (not the init's 0, which makes every NAFBlock an identity)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            b = 1 / np.sqrt(np.prod(s.shape[:-1]))
            a = rng.uniform(-b, b, s.shape)
        elif name in ("beta", "gamma"):
            a = rng.normal(0, 0.3, s.shape)
        elif name == "weight":
            a = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == "prompt_param":
            a = rng.uniform(size=s.shape)
        else:
            a = 0.05 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_variables(name, kwargs, shape, seed):
    """Seeded variables of the JAX model `name` (through jax.eval_shape)."""
    tree = jax.eval_shape(jax_create_model(name, **kwargs).init,
                          jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:]))
    return filled(tree, seed)


def flax_grads(grads, name, kwargs):
    """A flax gradient tree as {parameter: numpy array} in the port's names
    and layout."""
    sd = state_dict_from_flax(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads)},
        create_model(name, device="cpu", **kwargs))
    return {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}


def jax_sides(name, kwargs, shape, seed):
    """(x, y, variables, outputs, steps) of the jitted JAX model: one L1
    step (`jax.value_and_grad`) in fp32 and one with dtype=bfloat16 on the
    same float32 weights. `outputs[dt]` is the step's output and `steps[dt]`
    its (loss, {parameter: gradient}), dt "fp32" or "bf16"."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = rng.uniform(size=shape).astype(np.float32)
    variables = jax_variables(name, kwargs, shape, seed + 1)
    out, steps = {}, {}
    for dt, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jmodel = jax_create_model(name, dtype=dtype, **kwargs)

        def loss(p, jmodel=jmodel):
            o = jmodel.apply({"params": p}, jnp.asarray(x))
            return jax_l1_loss(o, jnp.asarray(y)), o

        (value, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        out[dt] = np.asarray(o)
        steps[dt] = (float(value), flax_grads(g, name, kwargs))
    return x, y, variables, out, steps


def port_model(name, kwargs, variables, **kw):
    model = create_model(name, device="cpu", **kwargs, **kw)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return model


def nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2))


def forward_np(model, x):
    with torch.no_grad():
        y = model(nchw(x))
    assert y.dtype == torch.float32
    return y.numpy().transpose(0, 2, 3, 1)


def check_bf16(name, kwargs, side, train):
    """Served (bf16 weights) or training (fp32 weights computing in bf16)
    against the JAX model with dtype=bfloat16 on the same float32 weights.
    Returns the max |difference|."""
    x, _, variables, ref, _ = side
    model = port_model(name, kwargs, variables, dtype=torch.bfloat16,
                       train=train)
    return np.abs(forward_np(model, x) - ref["bf16"]).max()


def port_grads(name, kwargs, side, dtype):
    """(loss, {parameter: gradient}) of the same step through the port's
    training model (float32 weights computing in `dtype`)."""
    x, y, variables = side[:3]
    model = port_model(name, kwargs, variables, dtype=dtype, train=True)
    loss = l1_loss(model(nchw(x)), nchw(y))
    loss.backward()
    grads = {}
    for pname, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, pname
        grads[pname] = p.grad.numpy()
    return loss.item(), grads


def grad_errors(grads, ref):
    """{parameter: max |grad - ref| / max |ref|}."""
    assert grads.keys() == ref.keys()
    return {k: np.abs(grads[k] - ref[k]).max() / np.abs(ref[k]).max()
            for k in ref}


def check_fp32_grads(name, kwargs, side):
    """fp32: the loss within 1e-6 of JAX's and every gradient within
    GRAD_TOL of its tensor's max |grad|, the X-Restormer bounds
    (tests/test_torch_train.py). Returns the worst error."""
    loss, grads = port_grads(name, kwargs, side, torch.float32)
    loss_j, ref = side[4]["fp32"]
    assert abs(loss - loss_j) <= 1e-6 * loss_j
    errs = grad_errors(grads, ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    return errs[worst]


def check_bf16_grads(name, kwargs, side):
    """bf16 compute with float32 weights, against JAX's jitted bf16 step on
    the same weights: the loss within 2e-4 of JAX's (the X-Restormer
    bound), and each gradient's error against the fp32 (JAX) gradient (its
    max |difference| over its max |grad|) at most twice the larger of JAX's
    bf16 error on the same tensor and JAX's median bf16 error (measured
    <= 1.61x for both models: two roundings of one step agree only in
    scale); the port's median error at most JAX's and at least a quarter
    of it (a step computing in float32 lies ~1e-5 away). The X-Restormer
    test's bounds (BF16_GRAD_TOL, BF16_GRAD_MEDIAN, against JAX's bf16
    gradients) cannot hold here: JAX's own bf16 gradients lie up to 0.53
    from its fp32 ones, a bias's gradient summing the L1 loss's signs over
    the image. Returns the port's (worst ratio, median error)."""
    x, y, _, _, steps = side
    loss, grads = port_grads(name, kwargs, side, torch.bfloat16)
    loss_j, jax_bf16 = steps["bf16"]
    assert abs(loss - loss_j) <= 2e-4 * loss_j, (loss, loss_j)
    exact = steps["fp32"][1]
    errs, ref = grad_errors(grads, exact), grad_errors(jax_bf16, exact)
    median, median_j = (float(np.median(list(e.values()))) for e in (errs, ref))
    ratio = {k: errs[k] / max(ref[k], median_j) for k in errs}
    worst = max(ratio, key=ratio.get)
    assert ratio[worst] <= 2, (worst, errs[worst], ref[worst], median_j)
    assert median_j / 4 <= median <= median_j, (median, median_j)
    return ratio[worst], median


def kernel_calls(fn):
    """Names of the functions of the port's kernel layer (ops/cuda/, the
    block dispatch models/blocks.py, the autograd Functions ops/autodiff.py)
    that fn() calls, and the launch counters after it."""
    from promptir_tpu_torch.ops.cuda import block, gdfn, mdta, megablock, seam

    wrappers = (mdta.mdta_stats, block.block_tail, gdfn.ln_gdfn, seam.seam,
                mdta.ln_mdta, megablock.tail_stats, mdta.mdta_gram)
    for k in wrappers:
        k.launches = 0
    seen = set()

    def profile(frame, event, arg):
        f = frame.f_code.co_filename.replace("\\", "/")
        if event == "call" and ("promptir_tpu_torch/ops/cuda/" in f or f.endswith(
                ("promptir_tpu_torch/models/blocks.py",
                 "promptir_tpu_torch/ops/autodiff.py"))):
            seen.add(frame.f_code.co_name)

    sys.setprofile(profile)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return seen, [k.launches for k in wrappers]


def serves_odd_sizes(name, **kwargs):
    """The engine at the model's pad base (8) on odd sizes: each reply is
    the model's forward of the padded image, cropped."""
    torch.manual_seed(0)
    model = create_model(name, device="cpu", **kwargs)
    base = pad_bases(name)[0]
    assert base == 8
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(size=s).astype(np.float32)
            for s in [(21, 35, 3), (24, 24, 3), (13, 50, 3)]]
    with InferenceEngine(model, pad_base=base, max_batch=2,
                         batch_timeout_ms=100) as eng:
        outs = eng.restore_many(imgs)
        s = eng.stats()
    for im, out in zip(imgs, outs):
        assert out.shape == im.shape and 0.0 <= out.min() and out.max() <= 1.0
        xp = torch.from_numpy(pad_image_np(im, base)[None]).permute(0, 3, 1, 2)
        with torch.no_grad():
            ref = model(xp).clamp(0, 1).permute(0, 2, 3, 1).numpy()[0]
        np.testing.assert_allclose(out, ref[:im.shape[0], :im.shape[1]],
                                   atol=1e-5)
    assert s["requests"] == 3 and s["compiled_shapes"] == 3


def clis_take(name, tmp_path, size=(), dim=None):
    """cli/train.py trains `name` (one synthetic step at 16 px), cli/demo.py
    restores an odd-sized PNG through it, cli/serve.py serves it at pad
    base 8. `size`: the depth flags; `dim`: --dim of the trainer and the
    server (the demo has none); none given: the default model."""
    import threading
    import urllib.request

    from promptir_tpu_torch.cli import demo, serve, train
    from promptir_tpu_torch.utils.png import decode_png, encode_png, write_png

    tiny = ["--model", name, *size, "--device", "cpu"]
    width = [] if dim is None else ["--dim", str(dim)]
    trainer = train.main(["--synthetic", "--patch_size", "16", "--batch_size",
                          "64", "--epochs", "1", "--ckpt_dir",
                          str(tmp_path / "ckpt"), "--log_dir", str(tmp_path),
                          *width, *tiny])
    assert trainer.global_step == 1
    img = np.random.default_rng(6).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    demo.main(["--test_path", str(tmp_path / "in.png"),
               "--output_path", str(tmp_path / "demo"), *tiny])
    assert decode_png((tmp_path / "demo" / "in.png").read_bytes()).shape == \
        (32, 64, 3)  # crop-16
    args = serve.build_parser().parse_args(
        ["--port", "0", "--max_batch", "1", *width, *tiny])
    httpd, engine = serve.make_server(args)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["model"] == name and health["pad_base"] == 8
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


# ------------------------------------------------------------------- tests

def test_round_to_pow2():
    assert round_to_nearest_power_of_2(int(2.66 * 48)) == 128
    assert round_to_nearest_power_of_2(64) == 64
    assert round_to_nearest_power_of_2(96) == 128
    assert round_to_nearest_power_of_2(95) == 64


@pytest.mark.parametrize("file,block", [
    ("easy_block", lambda: EasyTransformerBlock(48, inner_dim=16)),
    ("easy_channel_block", lambda: EasyChannelTransformerBlock(48)),
])
def test_block_matches_golden(golden, file, block):
    g = golden(file)
    blk = block()
    blk.load_state_dict({k: torch.from_numpy(v)
                         for k, v in g.state_dict.items()}, strict=True)
    with torch.no_grad():
        y = blk(torch.from_numpy(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, rtol=3e-5, atol=3e-5)


def test_small_model_matches_golden_from_a_lightning_ckpt(golden, tmp_path):
    g = golden("easy_prompt_xrestormer_small")
    assert len(g.state_dict) == 359
    torch.save({"state_dict": {"net." + k: torch.from_numpy(v)
                               for k, v in g.state_dict.items()}},
               tmp_path / "easy.ckpt")
    model = load_checkpoint(create_model(NAME, device="cpu", **REDUCED),
                            str(tmp_path / "easy.ckpt"))
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32 and y.shape == g.x.shape
    np.testing.assert_allclose(y.numpy(), g.y, rtol=1e-4, atol=1e-4)


def test_default_config_keys_are_the_flax_paths():
    with torch.device("meta"):
        model = create_model(NAME, device="meta")
    sd = model.state_dict()
    assert len(sd) == 1619
    assert sum(p.numel() for p in model.parameters()) == 35_223_771
    tree = jax.eval_shape(jax_create_model(NAME).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))
    paths = {tuple(p.key for p in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(tree["params"])}
    assert {flax_path(k, v.dim()) for k, v in sd.items()} == paths
    assert flax_path("encoder_level1.layer.0.spatial_attn.in_conv.0.weight",
                     4) == ("encoder_level1", "layer_0", "spatial_attn",
                            "in_conv_0", "kernel")
    assert flax_path("latent.layer.3.spatial_attn.in_conv.1.weight", 1)[-2:] \
        == ("in_conv_1", "weight")
    assert flax_path("refinement.layer.0.spatial_attn.out_SA.0.bias", 1)[-2:] \
        == ("out_SA_0", "bias")
    assert flax_path("noise_level3.channel_attn.sca.1.weight", 4)[-2:] == \
        ("sca_1", "kernel")
    # every tensor lands at its flax shape
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    assert len(state_dict_from_flax(zeros, model)) == 1619


@pytest.fixture(scope="module")
def jax_side():
    return jax_sides(NAME, REDUCED, SHAPE, 3)


def test_reduced_model_matches_jax_fp32_nonsquare_batch2(jax_side):
    """fp32 within 1e-5 (measured 5.4e-7 of outputs up to 1.49)."""
    x, _, variables, ref, _ = jax_side
    y = forward_np(port_model(NAME, REDUCED, variables), x)
    np.testing.assert_allclose(y, ref["fp32"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_reduced_model_matches_jax_bf16(jax_side, train):
    """BF16_MODEL_TOL (measured 1.07e-2 served, 1.17e-2 training, of
    outputs up to 1.49)."""
    err = check_bf16(NAME, REDUCED, jax_side, train)
    assert err <= BF16_MODEL_TOL, err


def test_reduced_loss_and_grads_match_jax(jax_side):
    """fp32 (measured 2.1e-5)."""
    check_fp32_grads(NAME, REDUCED, jax_side)


def test_reduced_bf16_loss_and_grads_match_jax(jax_side):
    """bf16 (measured: worst ratio 1.60, median error 0.035 against JAX's
    0.0445)."""
    check_bf16_grads(NAME, REDUCED, jax_side)


def test_without_prompts_the_tree_is_jax_and_it_matches_jax():
    """prompt=False: the keys are the JAX tree's and the fp32 forward
    equals JAX's within 1e-5 (dim 8, one block a level)."""
    kw = dict(prompt=False, dim=8, **REDUCED)
    x = np.random.default_rng(9).uniform(size=(1, 16, 24, 3)).astype(np.float32)
    variables = jax_variables(NAME, kw, x.shape, 10)
    model = port_model(NAME, kw, variables)
    paths = {tuple(p.key for p in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(variables["params"])}
    sd = model.state_dict()
    assert {flax_path(k, v.dim()) for k, v in sd.items()} == paths
    assert not any(k.startswith(("prompt", "noise_level")) for k in sd)
    assert model.up4_3.body[0].in_channels == 64
    want = np.asarray(jax.jit(jax_create_model(NAME, **kw).apply)(variables, x))
    np.testing.assert_allclose(forward_np(model, x), want, rtol=0, atol=1e-5)


def test_bf16_easy_block_keeps_its_stream_in_bf16():
    """A bf16 EasyTransformerBlock returns bf16, as the JAX one does."""
    x = np.random.default_rng(7).normal(size=(2, 6, 10, 16)).astype(np.float32)
    jblk = JaxEasyBlock(16, inner_dim=16, dtype=jnp.bfloat16)
    v = filled(jax.eval_shape(jblk.init, jax.random.PRNGKey(0), x), 8)
    jy = jax.eval_shape(jblk.apply, v, jnp.asarray(x).astype(jnp.bfloat16))
    blk = EasyTransformerBlock(16, inner_dim=16)
    blk.load_state_dict(state_dict_from_flax(v, blk), strict=True)
    with torch.no_grad():
        y = blk.bfloat16()(nchw(x).bfloat16())
    assert jy.dtype == jnp.bfloat16 and y.dtype == torch.bfloat16


def test_engine_serves_odd_sizes_cropped_with_pad_base_8():
    serves_odd_sizes(NAME, dim=8, **REDUCED)


def test_the_clis_take_the_model(tmp_path):
    trainer = clis_take(NAME, tmp_path, ["--num_blocks", "1", "1", "1", "1",
                                         "--num_refinement_blocks", "1"], 8)
    assert type(trainer.model).__name__ == "EasyPromptXRestormer"


def test_no_kernel_runs_and_the_launches_stay_0():
    """Served forward, and a training forward and backward: no function of
    the kernel layer is called."""
    torch.manual_seed(0)
    served = create_model(NAME, device="cpu", dtype=torch.bfloat16, dim=8,
                          **REDUCED)
    trained = create_model(NAME, device="cpu", dtype=torch.bfloat16,
                           train=True, dim=8, **REDUCED)
    x = torch.rand(1, 3, 16, 24)

    def run():
        with torch.no_grad():
            served(x)
        trained(x).mean().backward()

    seen, launches = kernel_calls(run)
    assert seen == set() and launches == [0] * 7
