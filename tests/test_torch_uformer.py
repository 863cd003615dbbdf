"""The port's Uformer blocks and PromptUformerIR (`promptuformerir`) on the
CPU, against the reference's goldens and the JAX package:

  * the four LeWin goldens, the prompt block and the down- and upsample
    within 3e-5, the JAX suite's bound; embed 8, one block a stage, no
    prompts against `uformer_small.npz` within 1e-4, its weights loaded
    verbatim from a Lightning `.ckpt` (the index buffers included);
  * the default config: the 855 keys and shapes of the reference's state
    dict (`sd_keys_promptuformerir.json`), 101,441,188 parameters, every
    floating tensor at the flax path that compat/jax_params.py:flax_path
    names; a reference-layout state dict of random values loads with
    strict=True through compat/torch_ckpt.py;
  * the reduced model (embed 8, one block a stage, prompts and modulators
    on) with seeded weights carried across from the JAX tree: the fp32
    forward at B1 128x128 and B2 128x256 within 1e-5 of max |JAX|, bf16
    within BF16_MODEL_TOL served and training, the loss and gradients (B1
    128x128) in fp32 as tests/test_torch_easy.py holds them, and in bf16
    so but for the loss and the prompt mix's Linear (see that test); the
    global residual summed in float32, as jitted JAX sums it; the flax tree
    round-trips through state_dict_from_flax and the JAX converter;
  * shift_attn_mask and relative_position_index equal JAX's; a forward off
    the multiple of 128 raises; the engine pads to 128; the CLIs take both
    Uformer models (tests/test_torch_camixer.py holds CAPromptUformerIR to
    JAX) and refuse the size flags; no kernel wrapper runs.

One jitted JAX value_and_grad a dtype gives the B1 forward, the loss and
the gradients, as tests/test_torch_easy.py:jax_sides; the JAX programs are
traced one by one, then compiled and run side by side (`run_jax`).
"""

import copy
import json
import pathlib
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.compat.torch_ckpt import convert_state_dict
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.ops import window_attention as jax_wa
from promptir_tpu.train.losses import l1_loss as jax_l1_loss
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import flax_path, state_dict_from_flax
from promptir_tpu_torch.compat.torch_ckpt import load_checkpoint
from promptir_tpu_torch.eval.padding import pad_bases
from promptir_tpu_torch.models.prompt_uformer import UformerPromptBlock
from promptir_tpu_torch.ops import window_attention as wa
from promptir_tpu_torch.serve.engine import InferenceEngine, pad_image_np
from test_torch_easy import (  # noqa: F401 (one_torch_thread: a fixture)
    check_bf16,
    check_fp32_grads,
    flax_grads,
    forward_np,
    grad_errors,
    jax_variables,
    kernel_calls,
    one_torch_thread,
    port_grads,
    port_model,
)
from test_torch_precision import BF16_MODEL_TOL
from test_torch_train import BF16_GRAD_TOL

NAME = "promptuformerir"
REDUCED = dict(embed_dim=8, depths=(1,) * 9)
SHAPE = (2, 128, 256, 3)
GOLDENS = pathlib.Path(__file__).parent / "goldens"


def run_jax(jobs):
    """[fn(*args)] for jobs [(fn, args)], each jitted with LLVM's
    optimisation off (a third less compile time for these models; the
    outputs stay within 4e-7 of the default build's, the fp32 forward here
    measured), traced one after the other, then compiled and run in
    threads: XLA releases the GIL (31 s one after the other, 18 s side by
    side for this file's three)."""
    lowered = [jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0}).lower(*args) for fn, args in jobs]

    def run(i):
        return jax.block_until_ready(lowered[i].compile()(*jobs[i][1]))

    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(run, range(len(jobs))))


def l1_step(name, kwargs, dtype, x, y):
    """The JAX model's L1 value_and_grad on (x, y), with the output."""
    model = jax_create_model(name, dtype=dtype, **kwargs)

    def loss(params):
        out = model.apply({"params": params}, jnp.asarray(x))
        return jax_l1_loss(out, jnp.asarray(y)), out

    return jax.value_and_grad(loss, has_aux=True)


def tokens(x):
    """The goldens' (B, L, C) square token grids as (B, s, s, C)."""
    b, n, c = x.shape
    s = int(round(n ** 0.5))
    return torch.from_numpy(x.reshape(b, s, s, c))


def load_golden(module, g):
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in g.state_dict.items()}, strict=True)
    return module


@pytest.mark.parametrize("file,block", [
    ("lewin_block", lambda: wa.LeWinTransformerBlock(
        32, 4, 8, 0, token_mlp="leff", modulator=True)),
    ("lewin_block_shift", lambda: wa.LeWinTransformerBlock(
        32, 4, 8, 4, token_mlp="leff")),
    ("lewin_block_mlp", lambda: wa.LeWinTransformerBlock(
        32, 2, 8, 0, token_mlp="mlp")),
    ("lewin_block_convproj", lambda: wa.LeWinTransformerBlock(
        32, 2, 8, 0, token_mlp="leff", token_projection="conv")),
    ("uformer_prompt_block", lambda: UformerPromptBlock(
        32, 5, 8, 32, 4, 8, token_mlp="leff")),
    ("uformer_downsample", lambda: wa.UformerDownsample(16, 32)),
    ("uformer_upsample", lambda: wa.UformerUpsample(32, 16)),
])
def test_block_matches_golden(golden, file, block):
    """Measured <= 1.1e-6 (the prompt block), 0 for the down and up."""
    g = golden(file)
    blk = load_golden(block(), g)
    with torch.no_grad():
        y = blk(tokens(g.x))
    np.testing.assert_allclose(y.numpy().reshape(g.y.shape), g.y, rtol=3e-5,
                               atol=3e-5)


def test_small_model_matches_golden_from_a_lightning_ckpt(golden, tmp_path):
    """Measured 2.4e-7; the golden stores the index buffers as float16."""
    g = golden("uformer_small")
    assert len(g.state_dict) == 186 and g.x.shape == (1, 3, 128, 128)
    torch.save({"state_dict": {"net." + k: torch.from_numpy(v)
                               for k, v in g.state_dict.items()}},
               tmp_path / "uformer.ckpt")
    model = load_checkpoint(
        create_model(NAME, device="cpu", prompt=False, **REDUCED),
        str(tmp_path / "uformer.ckpt"))
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32 and y.shape == g.x.shape
    np.testing.assert_allclose(y.numpy(), g.y, rtol=1e-4, atol=1e-4)


def test_default_config_is_the_reference_state_dict():
    """855 keys with the reference's shapes, the 44 integer index buffers
    among them (the reduced model's tensors land at the JAX tree's paths:
    test_flax_tree_round_trips)."""
    with torch.device("meta"):
        model = create_model(NAME, device="meta")
    sd = model.state_dict()
    want = json.loads((GOLDENS / "sd_keys_promptuformerir.json").read_text())
    assert {k: list(v.shape) for k, v in sd.items()} == \
        {k: v["shape"] for k, v in want.items()}
    ints = {k for k, v in sd.items() if not v.is_floating_point()}
    assert ints == {k for k, v in want.items() if v["kind"] == "i"}
    assert len(ints) == 44 and all(k.endswith("relative_position_index")
                                   for k in ints)
    assert sum(p.numel() for p in model.parameters()) == 101_441_188
    assert flax_path("decoderlayer_0.blocks.3.modulator.weight", 2) == \
        ("decoderlayer_0", "blocks_3", "modulator")
    assert flax_path("upsample_2.deconv.0.weight", 4) == \
        ("upsample_2", "deconv_kernel")


def test_reference_state_dict_loads_strict(tmp_path):
    """Random values at the reference's 855 keys and shapes (the index
    buffers the reference's own), saved as a Lightning .ckpt, load into the
    default model with strict=True and are its tensors."""
    want = json.loads((GOLDENS / "sd_keys_promptuformerir.json").read_text())
    gen = torch.Generator().manual_seed(0)
    index = torch.from_numpy(wa.relative_position_index(8))
    sd = {k: (index.clone() if v["kind"] == "i"
              else torch.randn(v["shape"], generator=gen))
          for k, v in want.items()}
    torch.save({"state_dict": {"net." + k: v for k, v in sd.items()}},
               tmp_path / "ref.ckpt")
    model = load_checkpoint(create_model(NAME, device="cpu"),
                            str(tmp_path / "ref.ckpt"))
    got = model.state_dict()
    assert len(got) == 855
    assert all(torch.equal(got[k], v) for k, v in sd.items())


@pytest.mark.parametrize("hw,win,shift", [((16, 16), 8, 4), ((16, 32), 8, 4),
                                          ((24, 40), 8, 4), ((12, 18), 6, 3)])
def test_shift_mask_and_index_equal_jax(hw, win, shift):
    np.testing.assert_array_equal(wa.shift_attn_mask(*hw, win, shift),
                                  jax_wa.shift_attn_mask(*hw, win, shift))
    np.testing.assert_array_equal(wa.relative_position_index(win),
                                  jax_wa.relative_position_index(win))
    m = wa.shift_mask(*hw, win, shift, torch.device("cpu"))
    assert m is wa.shift_mask(*hw, win, shift, torch.device("cpu"))  # cached
    assert m.dtype == torch.float32 and not m.is_inference()


@pytest.fixture(scope="module")
def jax_side():
    """(x, y, variables, outputs, steps) as test_torch_easy.py:jax_sides
    gives them, at B1 128x128, and (x2, the fp32 B2 128x256 forward)."""
    rng = np.random.default_rng(3)
    x, y, x2 = (rng.uniform(size=s).astype(np.float32)
                for s in ((1, 128, 128, 3), (1, 128, 128, 3), SHAPE))
    variables = jax_variables(NAME, REDUCED, x.shape, 4)
    p = variables["params"]
    fp32, bf16, y2 = run_jax([
        (l1_step(NAME, REDUCED, jnp.float32, x, y), (p,)),
        (l1_step(NAME, REDUCED, jnp.bfloat16, x, y), (p,)),
        (jax_create_model(NAME, **REDUCED).apply, (variables, x2))])
    out, steps = {}, {}
    for dt, ((value, o), g) in (("fp32", fp32), ("bf16", bf16)):
        out[dt] = np.asarray(o)
        steps[dt] = (float(value), flax_grads(g, NAME, REDUCED))
    return (x, y, variables, out, steps), (x2, np.asarray(y2))


def test_reduced_model_matches_jax_fp32(jax_side):
    """B1 128x128 and B2 128x256 within 1e-5 of max |JAX| (measured
    <= 2e-6 of outputs up to ~1.5)."""
    (x, _, variables, ref, _), (x2, y2) = jax_side
    model = port_model(NAME, REDUCED, variables)
    for inp, want in ((x, ref["fp32"]), (x2, y2)):
        y = forward_np(model, inp)
        assert y.shape == inp.shape
        np.testing.assert_allclose(y, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("train", [False, True])
def test_reduced_model_matches_jax_bf16(jax_side, train):
    err = check_bf16(NAME, REDUCED, jax_side[0], train)
    assert err <= BF16_MODEL_TOL, err


def test_reduced_loss_and_grads_match_jax(jax_side):
    check_fp32_grads(NAME, REDUCED, jax_side[0])


def test_reduced_bf16_loss_and_grads_match_jax(jax_side):
    """bf16 compute with float32 weights against JAX's jitted bf16 step, as
    test_torch_easy.py:check_bf16_grads holds them, with two differences:

      * the loss: the two packages' bf16 losses lie ~1e-4 of the loss from
        the fp32 one on opposite sides (measured JAX +3.1e-5, the port
        -4.8e-5 of 0.3519; the port's outputs are the nearer to fp32 on
        average, 1.08e-3 against 1.24e-3), 2.3e-4 of the loss apart, past
        the 2e-4 bound on their difference: the port's distance from the
        fp32 loss is held to twice JAX's (floored at 1e-4 of the loss);
      * the prompt mix's Linear (`promptlayer_*.linear_layer`): its
        gradient is a softmax's, a difference of near-equal sums over the
        whole prompt bank, and the port's error on promptlayer_3's varies
        from 0.035 to 0.099 with the CPU's thread count (oneDNN's bf16
        blocking) against JAX's 0.022; it is held to BF16_GRAD_TOL, the
        bound of every bf16 gradient of the PromptIR test.
    Every other gradient's error against the fp32 one at most twice JAX's
    (floored at JAX's median; measured worst 1.46), and the port's median
    error between a quarter of JAX's and JAX's (measured 0.0091 against
    0.0136)."""
    x, y, _, _, steps = jax_side[0]
    loss, grads = port_grads(NAME, REDUCED, jax_side[0], torch.bfloat16)
    (loss_j, jax_bf16), (exact_loss, exact) = steps["bf16"], steps["fp32"]
    assert abs(loss - exact_loss) <= 2 * max(abs(loss_j - exact_loss),
                                             1e-4 * exact_loss), \
        (loss, loss_j, exact_loss)
    errs, ref = grad_errors(grads, exact), grad_errors(jax_bf16, exact)
    median, median_j = (float(np.median(list(e.values()))) for e in (errs, ref))
    mix = {k for k in errs if ".linear_layer." in k}
    assert len(mix) == 8
    assert max(errs[k] for k in mix) <= BF16_GRAD_TOL
    ratio = {k: errs[k] / max(ref[k], median_j) for k in errs if k not in mix}
    worst = max(ratio, key=ratio.get)
    assert ratio[worst] <= 2, (worst, errs[worst], ref[worst], median_j)
    assert median_j / 4 <= median <= median_j, (median, median_j)


def test_global_residual_sums_in_float32_as_jitted_jax(jax_side):
    """The JAX model ends in `(out + inp).astype(float32)`, a bf16 sum,
    which its jitted forward keeps in float32: most of its bf16 outputs lie
    off the bf16 grid (measured 0.26 on it). The port sums in float32 and
    lands closer to it than the same sum rounded to bf16 (measured mean
    |port - JAX| 8.3e-4 against 1.24e-3), as the port's other models do
    (tests/test_torch_bf16_route.py)."""
    from test_torch_precision import on_bf16_grid

    x, _, variables, ref, _ = jax_side[0]
    y = forward_np(port_model(NAME, REDUCED, variables, dtype=torch.bfloat16,
                              train=True), x)
    rounded = torch.from_numpy(y).bfloat16().float().numpy()
    assert on_bf16_grid(ref["bf16"]) < 0.5
    assert np.abs(y - ref["bf16"]).mean() < np.abs(rounded - ref["bf16"]).mean()


def check_round_trip(name, kwargs, variables):
    """state_dict_from_flax, then the JAX package's own torch -> flax
    converter, gives back the flax tree exactly: the modulators untransposed,
    the transposed convs (cin, cout, 2, 2) from flax's (cin, 2, 2, cout),
    the model's index buffers kept (the JAX converter skips them)."""
    model = create_model(name, device="cpu", **kwargs)
    sd = state_dict_from_flax(variables, model)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            assert torch.equal(sd[k], v)
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
    return sd


def test_flax_tree_round_trips(jax_side):
    variables = jax_side[0][2]
    sd = check_round_trip(NAME, REDUCED, variables)
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["decoderlayer_1.blocks.0.modulator.weight"].numpy(),
        p["decoderlayer_1"]["blocks_0"]["modulator"])
    np.testing.assert_array_equal(
        sd["upsample_1.deconv.0.weight"].numpy(),
        p["upsample_1"]["deconv_kernel"].transpose(0, 3, 1, 2))


@pytest.mark.parametrize("name", [NAME, "capromptuformerir"])
def test_a_forward_off_the_multiple_of_128_raises(name):
    assert pad_bases(name) == (128, 128)
    model = create_model(name, device="cpu", prompt=False, **REDUCED)
    with pytest.raises(ValueError, match="multiples of 128"):
        model(torch.zeros(1, 3, 128, 192))


def test_bf16_upsample_computes_in_float32():
    """A bf16 UformerUpsample equals its float32 computation on the same
    (bf16) values, rounded to bf16 once."""
    up = wa.UformerUpsample(16, 8).bfloat16()
    x = torch.randn(2, 4, 6, 16, generator=torch.Generator().manual_seed(0))
    xb = x.bfloat16()
    with torch.no_grad():
        got = up(xb)
        want = copy.deepcopy(up).float()(xb.float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("name", [NAME, "capromptuformerir"])
def test_engine_pads_to_128(name):
    """A 250x190 and a 128x128 request: each reply is the model's forward
    of the image padded to 256x256 or 128x128, cropped."""
    torch.manual_seed(0)
    model = create_model(name, device="cpu", prompt=False, **REDUCED)
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(size=s).astype(np.float32)
            for s in [(250, 190, 3), (128, 128, 3)]]
    with InferenceEngine(model, pad_base=pad_bases(name)[0], max_batch=1,
                         batch_timeout_ms=10) as eng:
        outs = eng.restore_many(imgs)
    for im, out in zip(imgs, outs):
        xp = pad_image_np(im, 128)
        assert xp.shape[0] % 128 == 0 and xp.shape[1] % 128 == 0
        with torch.no_grad():
            ref = model(torch.from_numpy(xp[None]).permute(0, 3, 1, 2))
        ref = ref.clamp(0, 1).permute(0, 2, 3, 1).numpy()[0]
        np.testing.assert_allclose(out, ref[:im.shape[0], :im.shape[1]],
                                   atol=1e-5)


@pytest.mark.parametrize("name", [NAME, "capromptuformerir"])
def test_the_clis_take_the_model(tmp_path, monkeypatch, name):
    """cli/train.py trains the model for one synthetic step (B2 128x128),
    cli/demo.py restores an odd-sized PNG through it, cli/serve.py serves it
    at pad base 128, each with create_model wrapped to the reduced size
    without prompts; the size flags are refused as the JAX CLIs refuse
    them."""
    from promptir_tpu_torch import models
    from promptir_tpu_torch.cli import demo, serve, train
    from promptir_tpu_torch.cli import test as cli_test
    from promptir_tpu_torch.data import synthetic
    from promptir_tpu_torch.train import trainer as trainer_mod
    from promptir_tpu_torch.utils.png import decode_png, encode_png, write_png

    real = models.create_model

    def reduced(model_name, **kw):
        return real(model_name, **{**REDUCED, "prompt": False, **kw})

    monkeypatch.setattr(models, "create_model", reduced)
    monkeypatch.setattr(trainer_mod, "create_model", reduced)
    small = synthetic.SyntheticTrainDataset
    monkeypatch.setattr(synthetic, "SyntheticTrainDataset",
                        lambda **kw: small(n=2, **kw))
    tiny = ["--model", name, "--device", "cpu"]
    trainer = train.main(["--synthetic", "--patch_size", "128",
                          "--batch_size", "2", "--epochs", "1", "--ckpt_dir",
                          str(tmp_path / "ckpt"), "--log_dir", str(tmp_path),
                          *tiny])
    assert trainer.global_step == 1
    assert type(trainer.model).__name__ == {
        NAME: "PromptUformerIR", "capromptuformerir": "CAPromptUformerIR"}[name]
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
        assert health["model"] == name and health["pad_base"] == 128
        req = urllib.request.Request(url + "/restore", data=encode_png(img),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert decode_png(r.read()).shape == img.shape
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        th.join(timeout=30)
    monkeypatch.setattr(models, "create_model", real)
    for parser, flags in ((cli_test, ["--num_blocks", "1", "1", "1", "1"]),
                          (cli_test, ["--num_refinement_blocks", "1"]),
                          (serve, ["--dim", "8"])):
        args = parser.build_parser().parse_args(["--model", name, "--device",
                                                 "cpu", *flags])
        with pytest.raises(TypeError, match=flags[0][2:]):
            cli_test.build_model(args)


def test_no_kernel_runs_and_the_launches_stay_0():
    """Served and training forwards (and a backward) of both models: no
    function of the kernel layer is called."""
    torch.manual_seed(0)
    x = torch.rand(1, 3, 128, 128)
    nets = [(create_model(n, device="cpu", dtype=torch.bfloat16, train=t,
                          prompt=False, **REDUCED), t)
            for n in (NAME, "capromptuformerir") for t in (False, True)]

    def run():
        for model, train in nets:
            if train:
                out = model(x)
                out.mean().backward()
            else:
                with torch.no_grad():
                    model(x)

    seen, launches = kernel_calls(run)
    assert seen == set() and launches == [0] * 7
