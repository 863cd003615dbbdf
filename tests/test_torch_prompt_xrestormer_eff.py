"""The port's PromptXRestormerEff (`promptxrestormereffir`) on the CPU,
against the reference's golden and the JAX package:

  * one block a level (the default heads), the reference's own 64 px
    output within 1e-4, the JAX suite's tolerance;
  * the training config's state dict: the reference's 674 names and
    shapes;
  * one block a level with the training config's heads, flax-initialised
    weights carried across, a (2, 64, 128, 3) batch: the forward in fp32
    within 1e-4 and in bf16 within test_torch_precision.py's
    BF16_MODEL_TOL; the L1 loss and every gradient in fp32 within
    test_torch_train.py's X-Restormer bounds; `prompt=False` builds the JAX
    parameter tree;
  * the engine serves odd sizes at the family's 64-pixel pad base.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.eval.padding import pad_bases
from promptir_tpu_torch.models.prompt_xrestormer_eff import (
    ChannelTransformerBlock,
)
from promptir_tpu_torch.serve.engine import InferenceEngine, pad_image_np
from promptir_tpu_torch.train.losses import l1_loss
from test_torch_precision import BF16_MODEL_TOL
from test_torch_train import (  # noqa: F401 (one_torch_thread: a fixture)
    GRAD_TOL,
    one_torch_thread,
)

NAME = "promptxrestormereffir"
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
# the reference's training config (tests/test_convert_fulldepth.py:41-47)
TRAIN = dict(num_blocks=(2, 4, 4, 4), num_refinement_blocks=4,
             channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))
TRAIN_REDUCED = dict(TRAIN, **REDUCED)


def test_small_model_matches_golden(golden):
    g = golden("prompt_xrestormer_eff_small")
    model = create_model(NAME, device="cpu", **REDUCED)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g.state_dict.items()}, strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32 and y.shape == g.x.shape
    np.testing.assert_allclose(y.numpy(), g.y, rtol=1e-4, atol=1e-4)


def test_training_config_state_dict_matches_reference_keys():
    """674 tensors, 35,291,462 parameters, the reference's names and
    shapes (tests/goldens/sd_keys_promptxrestormereffir.json)."""
    ref = json.loads((GOLDENS / f"sd_keys_{NAME}.json").read_text())
    model = create_model(NAME, device="cpu", **TRAIN)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref) and len(sd) == 674
    for k, v in ref.items():
        assert list(sd[k].shape) == v["shape"], k
    assert sum(p.numel() for p in model.parameters()) == 35_291_462
    blocks = [m for m in model.modules() if isinstance(m, ChannelTransformerBlock)]
    assert [b.channel_attn.qkv.weight.shape[1] for b in blocks] == [704, 320, 160]


@pytest.fixture(scope="module")
def jax_side():
    """(x, y, flax variables, the JAX fp32 and bf16 outputs) of the
    reduced training config."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(2, 64, 128, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 64, 128, 3)).astype(np.float32)
    variables = init_variables(jax_create_model(NAME, **TRAIN_REDUCED), 4,
                               jnp.asarray(x[:1, :, :64]))
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jmodel = jax_create_model(NAME, dtype=dt, **TRAIN_REDUCED)
        out[dt] = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    return x, y, variables, out


def port_model(variables, **kw):
    model = create_model(NAME, device="cpu", **TRAIN_REDUCED, **kw)
    sd = state_dict_from_flax(variables, create_model(NAME, device="cpu",
                                                      **TRAIN_REDUCED))
    model.load_state_dict(sd, strict=True)
    return model


def nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2))


def test_reduced_model_matches_jax_fp32_nonsquare_batch2(jax_side):
    """fp32, 1e-4 (measured 1.2e-6)."""
    x, _, variables, ref = jax_side
    with torch.no_grad():
        y = port_model(variables)(nchw(x))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               ref[jnp.float32], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_reduced_model_matches_jax_bf16(jax_side, train):
    """Served (bf16 weights) and training (fp32 weights computing in bf16)
    against the JAX model with dtype=bfloat16: BF16_MODEL_TOL (measured
    7.8125e-3 in both, one bf16 ulp at 1.0)."""
    x, _, variables, ref = jax_side
    model = port_model(variables, dtype=torch.bfloat16, train=train)
    with torch.no_grad():
        y = model(nchw(x))
    assert y.dtype == torch.float32
    err = np.abs(y.numpy().transpose(0, 2, 3, 1) - ref[jnp.bfloat16]).max()
    assert err <= BF16_MODEL_TOL, err


def test_reduced_loss_and_grads_match_jax(jax_side):
    """fp32: the loss within 1e-6 of JAX's and every gradient within
    GRAD_TOL of its tensor's max |grad|, the bound of the X-Restormer
    gradient test (tests/test_torch_train.py)."""
    x, y, variables, _ = jax_side
    jmodel = jax_create_model(NAME, **TRAIN_REDUCED)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_l1_loss(jmodel.apply({"params": p}, jnp.asarray(x)),
                              jnp.asarray(y))))(variables["params"])
    model = port_model(variables, train=True)
    loss = l1_loss(model(nchw(x)), nchw(y))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * float(loss_j)
    ref = state_dict_from_flax(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads_j)},
        model)
    errs = {}
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        want = ref[name].numpy()
        errs[name] = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_without_prompts_the_tree_is_jax_and_it_runs():
    x = jnp.zeros((1, 64, 64, 3))
    tree = jax.eval_shape(lambda: jax_create_model(
        NAME, prompt=False, **TRAIN_REDUCED).init(jax.random.PRNGKey(0), x))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    model = create_model(NAME, device="cpu", prompt=False, **TRAIN_REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    assert not any(k.startswith(("prompt", "noise_level"))
                   for k in model.state_dict())
    with torch.no_grad():
        out = model(torch.rand(1, 3, 64, 128))
    assert out.shape == (1, 3, 64, 128) and torch.isfinite(out).all()


def test_engine_serves_odd_sizes_cropped_with_pad_base_64():
    torch.manual_seed(0)
    model = create_model(NAME, device="cpu", **TRAIN_REDUCED)
    base = pad_bases(NAME)[0]
    assert base == 64
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(size=s).astype(np.float32)
            for s in [(50, 70, 3), (64, 64, 3), (33, 100, 3)]]
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
    assert s["requests"] == 3 and s["compiled_shapes"] == 2


def test_the_clis_take_the_model(tmp_path):
    """cli/train.py trains it (one synthetic step at 64 px), cli/demo.py
    restores an odd-sized PNG through it, cli/serve.py serves it at pad
    base 64."""
    import threading
    import urllib.request

    from promptir_tpu_torch.cli import demo, serve, train
    from promptir_tpu_torch.utils.png import decode_png, encode_png, write_png

    tiny = ["--model", NAME, "--num_blocks", "1", "1", "1", "1",
            "--num_refinement_blocks", "1", "--device", "cpu"]
    trainer = train.main(["--synthetic", "--patch_size", "64", "--batch_size",
                          "64", "--epochs", "1", "--dim", "8",
                          "--ckpt_dir", str(tmp_path / "ckpt"),
                          "--log_dir", str(tmp_path), *tiny])
    assert trainer.global_step == 1
    assert type(trainer.model).__name__ == "PromptXRestormerEff"
    img = np.random.default_rng(6).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    demo.main(["--test_path", str(tmp_path / "in.png"),
               "--output_path", str(tmp_path / "demo"), *tiny])
    assert decode_png((tmp_path / "demo" / "in.png").read_bytes()).shape == \
        (32, 64, 3)  # crop-16
    args = serve.build_parser().parse_args(
        ["--port", "0", "--max_batch", "1", "--dim", "8", *tiny])
    httpd, engine = serve.make_server(args)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["model"] == NAME and health["pad_base"] == 64
        req = urllib.request.Request(url + "/restore", data=encode_png(img),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert decode_png(r.read()).shape == img.shape
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        th.join(timeout=30)


def test_the_training_config_runs_the_kernels_the_smoke_gates(monkeypatch):
    """The launch counts that chip_smoke.py gates, from the code: a served
    forward of the training config calls mdta_stats 31 times (28 X-blocks,
    3 channel blocks), block_tail 31 and ln_gdfn 28 (the X-blocks' spatial
    FFN), 15 of the stats calls on the wide route (the Gram kernel: every
    one-head width from 160); a training forward runs LnMdta 31 times and
    LnGdfn 59 (28 x 2 + 3; at width 8, the counts not hanging on it)."""
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

    for name in ("block_tail", "ln_gdfn"):
        monkeypatch.setattr(blocks, name, spy(name, getattr(blocks, name)))
    monkeypatch.setattr(blocks, "mdta_stats",
                        spy("mdta_stats", blocks.mdta_stats, wide=True))
    torch.manual_seed(0)
    model = create_model(NAME, device="cpu", **TRAIN)
    with torch.no_grad():
        model(torch.rand(1, 3, 64, 64))
    assert calls == {"mdta_stats": 31, "block_tail": 31, "ln_gdfn": 28,
                     "mdta_gram": 15}
    calls.clear()
    for name in ("LnMdta", "LnGdfn"):
        fn = getattr(blocks, name)
        monkeypatch.setattr(blocks, name,
                            SimpleNamespace(apply=spy(name, fn.apply)))
    model = create_model(NAME, device="cpu", train=True, dim=8, **TRAIN)
    model(torch.rand(1, 3, 64, 64))
    assert calls == {"LnMdta": 31, "LnGdfn": 59}
