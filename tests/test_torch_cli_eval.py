"""The port's evaluation surface (cli/test.py, demo.py, psnr.py, serve.py,
eval/runner.py) on the CPU, against the JAX package where it has a result.

  * One module-scoped JAX run: a reduced PromptIR (one block a level, one
    refinement block), flax-initialised, evaluated by the JAX runner
    (eval/runner.py:test_denoise at sigma 15/25/50, test_derain_dehaze for
    derain and dehaze) on a 40x56 corpus that crop-16 and the flip pad make
    one 64x64 shape, its weights read from a Lightning .ckpt. The port's
    `cli.test --mode 3 --device cpu` reads the same .ckpt (with `net.`
    keys) and the JAX package's `save_params_npz` file of the same weights:
    per set, PSNR within 1e-3 dB and SSIM within 1e-4 for both.
  * Port-only: --nopad's JSON, the dumped PNGs' size, a checkpoint with a
    wrong key, the demo plain and tiled, the offline PSNR against the JAX
    CLI's (within 1e-4 dB and 1e-6), the HTTP server on port 0, and the
    epoch-end evaluation hook run by the port's trainer.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jax_init import init_variables
from promptir_tpu.cli import psnr as jax_psnr_cli
from promptir_tpu.cli.test import load_params as jax_load_params
from promptir_tpu.data import datasets as jds
from promptir_tpu.eval import runner as jrunner
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.train.checkpoints import save_params_npz
from promptir_tpu_torch import create_model
from promptir_tpu_torch.cli import demo, psnr, serve
from promptir_tpu_torch.cli import test as cli_test
from promptir_tpu_torch.compat.jax_params import load_params_npz, state_dict_from_flax
from promptir_tpu_torch.utils.png import decode_png, encode_png, read_png, write_png
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
TINY = ["--num_blocks", "1", "1", "1", "1", "--num_refinement_blocks", "1",
        "--device", "cpu"]
SETS = ("denoise_15", "denoise_25", "denoise_50", "derain", "dehaze")


def scene(hw, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 200, h), np.linspace(0, 200, w),
                         indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 12, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def put(path, hw, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(path), scene(hw, seed))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """BSD68/Rain100L/SOTS-shaped miniature corpus (tests/test_cli_eval.py)."""
    d = tmp_path_factory.mktemp("data")
    for i in range(2):
        put(d / "denoise" / f"img{i}.png", (40, 56), i)
        put(d / "derain" / "input" / f"rain-{i}.png", (40, 56), 10 + i)
        put(d / "derain" / "target" / f"rain-{i}.png", (40, 56), 20 + i)
        put(d / "dehaze" / "input" / f"{i:04d}_0.95_0.2.png", (40, 56), 30 + i)
        put(d / "dehaze" / "target" / f"{i:04d}.png", (40, 56), 40 + i)
    return d


def data_args(corpus, out):
    return ["--denoise_path", str(corpus / "denoise"),
            "--derain_path", str(corpus / "derain"),
            "--dehaze_path", str(corpus / "dehaze"),
            "--output_path", str(out)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Flax-initialised reduced PromptIR written as a Lightning .ckpt and as
    the JAX package's flat .npz."""
    d = tmp_path_factory.mktemp("weights")
    variables = init_variables(jax_create_model("promptir", **REDUCED), 0,
                               jnp.zeros((1, 64, 64, 3)))
    model = create_model("promptir", device="cpu", **REDUCED)
    sd = state_dict_from_flax(variables, model)
    torch.save({"state_dict": {"net." + k: v for k, v in sd.items()},
                "epoch": 3}, d / "model.ckpt")
    save_params_npz(str(d / "model.npz"), variables["params"])
    return d


@pytest.fixture(scope="module")
def jax_results(corpus, weights):
    """The JAX runner's per-set results: one compile (64x64)."""
    model = jax_create_model("promptir", **REDUCED)
    params = jax_load_params(model, str(weights / "model.ckpt"))
    fwd = jax.jit(lambda p, x: model.apply({"params": p}, x))
    ds = jds.DenoiseTestDataset(str(corpus / "denoise"))
    out = {f"denoise_{s}": jrunner.test_denoise(fwd, params, ds, s)
           for s in (15, 25, 50)}
    pairs = jds.DerainDehazeDataset(derain_path=str(corpus / "derain"),
                                    dehaze_path=str(corpus / "dehaze"))
    for task in ("derain", "dehaze"):
        out[task] = jrunner.test_derain_dehaze(fwd, params, pairs, task)
    return out


@pytest.mark.parametrize("weights_file", ["model.ckpt", "model.npz"])
def test_mode3_matches_the_jax_runner(corpus, weights, jax_results,
                                      weights_file, tmp_path):
    out = tmp_path / "out"
    res = cli_test.main(["--mode", "3", "--ckpt_name",
                         str(weights / weights_file),
                         *data_args(corpus, out), *TINY])
    assert set(res) == set(SETS)
    for k in SETS:
        assert res[k]["n"] == jax_results[k]["n"] == 2
        assert abs(res[k]["psnr"] - jax_results[k]["psnr"]) <= 1e-3, k
        assert abs(res[k]["ssim"] - jax_results[k]["ssim"]) <= 1e-4, k
    # the restored PNGs: cropped back to the crop-16 size (40, 56) -> (32, 48)
    for sub, name in [("denoise_15", "img0"), ("derain", "rain-1"),
                      ("dehaze", "0001_0.95_0.2")]:
        assert read_png(str(out / sub / f"{name}.png")).shape == (32, 48, 3)


def test_npz_and_ckpt_load_the_same_tensors(weights):
    model = create_model("promptir", device="cpu", **REDUCED)
    a = state_dict_from_flax(load_params_npz(str(weights / "model.npz")), model)
    b = cli_test.load_params(model, str(weights / "model.ckpt")).state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_nopad_json_equals_the_returned_dict(corpus, tmp_path):
    res = cli_test.main(["--mode", "0", "--nopad", "--json_dir",
                         str(tmp_path / "json"),
                         *data_args(corpus, tmp_path / "out"), *TINY])
    for sigma in (15, 25, 50):
        d = json.loads((tmp_path / "json" / f"psnr_denoise_{sigma}.json")
                       .read_text())
        assert set(d) == {"img0", "img1"}
        assert res[f"denoise_{sigma}"]["per_image"] == d


def test_per_image_metrics_average_to_the_set(corpus, tmp_path):
    """run_eval returns each image's (PSNR, SSIM) beside the set's means,
    and its loop's seconds."""
    res = cli_test.main(["--mode", "1", *data_args(corpus, tmp_path / "out"),
                         *TINY])["derain"]
    assert sorted(res["images"]) == ["rain-0", "rain-1"]
    p, s = np.mean(list(res["images"].values()), axis=0)
    assert abs(p - res["psnr"]) <= 1e-9 and abs(s - res["ssim"]) <= 1e-12
    assert res["seconds"] > 0


def test_a_checkpoint_with_a_wrong_key_raises_naming_it(weights, tmp_path):
    ck = torch.load(weights / "model.ckpt", weights_only=False)
    sd = ck["state_dict"]
    sd["net.bogus.weight"] = sd.pop("net.output.weight")
    torch.save(ck, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match=r"missing .*output\.weight.*"
                                         r"unexpected .*bogus\.weight"):
        cli_test.main(["--mode", "1", "--ckpt_name", str(tmp_path / "bad.ckpt"),
                       "--derain_path", "unused", *TINY])


def test_fused_is_refused_for_the_xrestormer_family():
    """`--fused` reaches create_model as fused_ffn=True for every model: the
    X-Restormer family takes it now (its channel halves then train as one
    LnBlock; served, nothing changes), and a model without the option
    refuses it with the JAX registry's ValueError."""
    args = cli_test.build_parser().parse_args(
        ["--model", "promptxrestormerir", "--fused", *TINY])
    model = cli_test.build_model(args)
    halves = [m for m in model.modules() if hasattr(m, "channel_attn")]
    assert halves and all(m.fused_ffn for m in halves)
    with pytest.raises(ValueError, match="no fused Pallas path"):
        cli_test.main(["--mode", "1", "--model", "nafnet", "--fused",
                       "--derain_path", "unused", "--device", "cpu"])


@pytest.mark.parametrize("name", ["promptir", "promptxrestormerir"])
def test_validation_shape_matches_jax(name):
    from promptir_tpu.cli.test import validation_shape

    assert cli_test.validation_shape(name) == validation_shape(name)


def test_demo_plain_and_tiled_write_the_crop16_size(corpus, tmp_path):
    demo.main(["--test_path", str(corpus / "denoise"),
               "--output_path", str(tmp_path / "plain"), *TINY])
    for i in range(2):
        assert read_png(str(tmp_path / "plain" / f"img{i}.png")).shape == (32, 48, 3)
    demo.main(["--test_path", str(corpus / "denoise" / "img1.png"),
               "--output_path", str(tmp_path / "tiled"), "--tile",
               "--tile_size", "32", "--tile_overlap", "8", *TINY])
    assert read_png(str(tmp_path / "tiled" / "img1.png")).shape == (32, 48, 3)


def test_offline_psnr_matches_the_jax_cli(tmp_path):
    rdir, gdir = tmp_path / "restored", tmp_path / "gt"
    put(rdir / "a.png", (32, 48), 1)
    # GT 1px larger each way (the reference's 321x481-vs-320x480 case), one
    # uint8 step off the restored image inside the crop
    img = read_png(str(rdir / "a.png"))
    step = np.random.default_rng(7).integers(-1, 2, img.shape)
    gt = np.clip(img.astype(int) + step, 0, 255).astype(np.uint8)
    gdir.mkdir()
    Image.fromarray(np.pad(gt, ((0, 1), (0, 1), (0, 0)), mode="edge")).save(
        gdir / "a.png", optimize=True)
    put(rdir / "b.png", (32, 48), 2)
    put(gdir / "b.png", (32, 48), 3)
    argv = ["--restored", str(rdir), "--gt", str(gdir)]
    mine = psnr.main(argv + ["--json", str(tmp_path / "p.json"),
                             "--device", "cpu"])
    ref = jax_psnr_cli.main(argv + ["--json", str(tmp_path / "q.json")])
    assert mine["n"] == ref["n"] == 2
    assert abs(mine["psnr"] - ref["psnr"]) <= 1e-4
    assert abs(mine["ssim"] - ref["ssim"]) <= 1e-6
    d = json.loads((tmp_path / "p.json").read_text())
    assert set(d) == {"a", "b"} and d["a"] > 45  # a step apart after the crop
    # stems that differ pair by sorted position, with the same numbers
    (rdir / "b.png").rename(rdir / "c.png")
    again = psnr.main(["--restored", str(rdir), "--gt", str(gdir),
                       "--device", "cpu"])
    assert again["psnr"] == mine["psnr"]


def test_server_restores_a_png_and_refuses_a_jpeg():
    """The server restores a PNG, a JPEG and a BMP, as the JAX server
    restores any format PIL opens: each reply equals the reply to the PNG
    of the same decoded pixels. A body that is none of the three gets a
    400 naming the formats. (The name is the PNG-only server's.)"""
    from promptir_tpu_torch.utils.image_io import decode_image

    args = serve.build_parser().parse_args(
        ["--port", "0", "--max_batch", "2", "--batch_timeout_ms", "1", *TINY])
    httpd, engine = serve.make_server(args)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def restore(body):
        req = urllib.request.Request(url + "/restore", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"] == "image/png"
            return decode_png(r.read())

    try:
        out = restore(encode_png(scene((33, 45), 5)))
        assert out.shape == (33, 45, 3)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert set(health) == {"model", "backend", "device_count", "max_batch",
                               "pad_base", "dtype", "status"}
        assert health["backend"] == "cpu" and health["pad_base"] == 8
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            assert json.loads(r.read())["compiled_shapes"] == 1
        for fmt in ("JPEG", "BMP"):
            body = pil_bytes(scene((16, 24), 6), fmt)
            got = restore(body)
            assert got.shape == (16, 24, 3)
            np.testing.assert_array_equal(got, restore(encode_png(
                decode_image(body))))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                url + "/restore", data=pil_bytes(scene((16, 16), 7), "GIF"),
                method="POST"), timeout=60)
        assert e.value.code == 400
        assert ("request body: not a PNG, JPEG or BMP file"
                in json.loads(e.value.read())["error"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        th.join(timeout=30)
    assert not th.is_alive()


def pil_bytes(rgb, fmt):
    import io

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format=fmt)
    return buf.getvalue()


def test_epoch_eval_hook_logs_through_the_trainer(corpus, tmp_path):
    from promptir_tpu_torch.config import Config
    from promptir_tpu_torch.data.synthetic import SyntheticTrainDataset
    from promptir_tpu_torch.eval.runner import make_epoch_eval_hook
    from promptir_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.train.epochs = 1
    cfg.train.batch_size = 2
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    cfg.data.num_workers = 1
    cfg.system.device = "cpu"
    torch.manual_seed(0)
    model = create_model("promptir", device="cpu", train=True, **REDUCED)
    hook = make_epoch_eval_hook(denoise_path=str(corpus / "denoise"),
                                derain_path=str(corpus / "derain"))
    Trainer(cfg, SyntheticTrainDataset(n=2, patch_size=32), model=model,
            eval_hook=hook).fit()
    records = [json.loads(line) for line in
               (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in records if "eval_psnr_denoise15" in r]
    assert len(evals) == 1
    for k in ("eval_psnr_denoise15", "eval_ssim_denoise15", "eval_psnr_derain",
              "eval_ssim_derain"):
        assert np.isfinite(evals[0][k]), k
