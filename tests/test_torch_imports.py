"""The port stands alone: no file of promptir_tpu_torch/ nor chip_smoke.py
imports JAX, flax, optax, orbax, PIL or anything of the JAX package."""

import ast
import pathlib

import jax  # noqa: F401  (both frameworks share the test process)
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "PIL", "promptir_tpu"}
FILES = sorted((ROOT / "promptir_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_files():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(imported_roots(path)) & BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


NEW_MODULES = [
    "promptir_tpu_torch.utils.png", "promptir_tpu_torch.utils.image_io",
    "promptir_tpu_torch.data.augment", "promptir_tpu_torch.data.datasets",
    "promptir_tpu_torch.eval.runner", "promptir_tpu_torch.compat.torch_ckpt",
    "promptir_tpu_torch.cli.test", "promptir_tpu_torch.cli.demo",
    "promptir_tpu_torch.cli.psnr", "promptir_tpu_torch.cli.serve",
    "promptir_tpu_torch.utils.jpeg", "promptir_tpu_torch.utils.bmp",
    "promptir_tpu_torch.data.patches", "promptir_tpu_torch.data.degradations",
    "promptir_tpu_torch.cli.train", "promptir_tpu_torch.utils.cxx",
    "promptir_tpu_torch.data.native",
    "promptir_tpu_torch.models.prompt_xrestormer_eff",
    "promptir_tpu_torch.ops.easy",
    "promptir_tpu_torch.models.easy_promptxrestormer",
    "promptir_tpu_torch.models.nafnet",
    "promptir_tpu_torch.ops.window_attention",
    "promptir_tpu_torch.models.prompt_uformer",
    "promptir_tpu_torch.ops.flow_warp", "promptir_tpu_torch.ops.camixer",
    "promptir_tpu_torch.models.camixer_prompt_uformer",
    "promptir_tpu_torch.models.camixer_models",
    "promptir_tpu_torch.eval.niqe", "promptir_tpu_torch.utils.imresize",
    "promptir_tpu_torch.cli.fit_niqe", "promptir_tpu_torch.cli.viz",
    "promptir_tpu_torch.cli.train_demo",
    "promptir_tpu_torch.utils.flops", "promptir_tpu_torch.utils.init",
    "promptir_tpu_torch.cli.summary", "promptir_tpu_torch.cli.convert",
    "promptir_tpu_torch.tools.trace", "promptir_tpu_torch.tools.kbench",
    "promptir_tpu_torch.tools.profile_forward",
    "promptir_tpu_torch.tools.profile_train",
    "promptir_tpu_torch.tools.tbench", "promptir_tpu_torch.tools.sbench",
    "promptir_tpu_torch.tools.shape_sweep",
]
# Blocks JAX, PIL and the JAX package, imports the evaluation and training
# surface, reads a committed JPEG fixture and a BMP written by hand, and
# runs each entry point once on the CPU (fit_niqe and viz compare too), so
# that an import inside a
# function body (which the AST scan above sees, but a mistake could hide
# behind a name built at run time) fails here too.
BLOCKED_RUN = """
import importlib, json, os, sys, threading, urllib.request
for name in ("jax", "jaxlib", "flax", "PIL", "promptir_tpu"):
    sys.modules[name] = None
import numpy as np
for m in {modules!r}:
    importlib.import_module(m)
import shutil, struct
from promptir_tpu_torch.cli import demo, psnr, serve, test, train
from promptir_tpu_torch.utils.image_io import read_image, save_image
from promptir_tpu_torch.utils.png import decode_png, encode_png
tiny = ["--num_blocks", "1", "1", "1", "1", "--num_refinement_blocks", "1",
        "--device", "cpu"]
d = {workdir!r}
rng = np.random.default_rng(0)
for sub in ("clean", "rain/input", "rain/target", "haze/input", "haze/target"):
    os.makedirs(os.path.join(d, sub))
save_image(os.path.join(d, "clean", "a.png"), rng.random((20, 36, 3)))
save_image(os.path.join(d, "rain", "input", "rain-1.png"), rng.random((20, 36, 3)))
save_image(os.path.join(d, "rain", "target", "rain-1.png"), rng.random((20, 36, 3)))
save_image(os.path.join(d, "haze", "input", "1_0.9_0.2.png"), rng.random((20, 36, 3)))
save_image(os.path.join(d, "haze", "target", "1.png"), rng.random((20, 36, 3)))
out = os.path.join(d, "out")
r = test.main(["--mode", "3", "--pad_base", "16", "--denoise_path",
               os.path.join(d, "clean"), "--derain_path", os.path.join(d, "rain"),
               "--dehaze_path", os.path.join(d, "haze"), "--output_path", out,
               *tiny])
demo.main(["--test_path", os.path.join(d, "clean"), "--output_path",
           os.path.join(d, "demo"), *tiny])
psnr.main(["--restored", os.path.join(out, "derain"), "--gt",
           os.path.join(d, "rain", "target"), "--device", "cpu"])
httpd, engine = serve.make_server(serve.build_parser().parse_args(
    ["--port", "0", "--max_batch", "1", *tiny]))
th = threading.Thread(target=httpd.serve_forever, daemon=True)
th.start()
req = urllib.request.Request(
    f"http://127.0.0.1:{{httpd.server_address[1]}}/restore",
    data=encode_png(np.zeros((9, 11, 3), np.uint8)), method="POST")
with urllib.request.urlopen(req, timeout=60) as resp:
    shape = decode_png(resp.read()).shape
httpd.shutdown()
httpd.server_close()
engine.close()
jpg = os.path.join({fixtures!r}, "dehaze")
shutil.copytree(jpg, os.path.join(d, "train", "dehaze"))
bmp = (b"BM" + struct.pack("<IHHI", 14 + 40 + 8, 0, 0, 54)
       + struct.pack("<IiiHHIIiiII", 40, 2, -1, 1, 24, 0, 8, 0, 0, 0, 0)
       + bytes([0, 0, 255, 0, 255, 0, 0, 0]))
open(os.path.join(d, "x.bmp"), "wb").write(bmp)
decoded = [list(read_image(os.path.join(jpg, "original", "0001.jpg")).shape),
           read_image(os.path.join(d, "x.bmp")).tolist()]
for sub, text in (("noisy/denoise.txt", "a.png"), ("rainy/rainTrain.txt", ""),
                  ("hazy/hazy_outside.txt", "synthetic/0001_0.8_0.2.jpg")):
    os.makedirs(os.path.dirname(os.path.join(d, "lists", sub)), exist_ok=True)
    open(os.path.join(d, "lists", sub), "w").write(text)
trainer = train.main(["--de_type", "denoise_15", "dehaze", "--epochs", "1",
                      "--batch_size", "2", "--patch_size", "16",
                      "--data_file_dir", os.path.join(d, "lists") + "/",
                      "--denoise_dir", os.path.join(d, "clean") + "/",
                      "--dehaze_dir", os.path.join(d, "train", "dehaze") + "/",
                      "--ckpt_dir", os.path.join(d, "ckpt"),
                      "--log_dir", os.path.join(d, "logs"), *tiny])
from promptir_tpu_torch.cli import fit_niqe, viz
from promptir_tpu_torch.eval.metrics import compute_niqe
os.makedirs(os.path.join(d, "pristine"))
for i in range(2):
    save_image(os.path.join(d, "pristine", f"p{{i}}.png"), rng.random((100, 100, 3)))
fit_niqe.main([os.path.join(d, "pristine"), "--out", os.path.join(d, "niqe.npz")])
niqe_ok = bool(np.isfinite(compute_niqe(rng.random((100, 100, 3)))))
for name, psnrs in (("a", {{"x": 30.0}}), ("b", {{"x": 31.0}})):
    json.dump(psnrs, open(os.path.join(d, name + ".json"), "w"))
viz.main(["compare", os.path.join(d, "a.json"), os.path.join(d, "b.json"),
          "--out", os.path.join(d, "cmp.json")])
delta = json.load(open(os.path.join(d, "cmp.json")))["mean_delta"]
print(json.dumps({{"sets": sorted(r), "served": list(shape),
                  "decoded": decoded, "trained": trainer.global_step,
                  "niqe": niqe_ok and os.path.exists(os.path.join(d, "niqe.npz")),
                  "delta": delta}}))
"""


def test_entry_points_run_with_jax_and_pil_blocked(tmp_path):
    import json
    import subprocess
    import sys

    code = BLOCKED_RUN.format(modules=NEW_MODULES, workdir=str(tmp_path),
                              fixtures=str(ROOT / "tests" / "torch_fixtures" / "jpeg"))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=300,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"sets": ["dehaze", "denoise_15", "denoise_25", "denoise_50",
                            "derain"], "served": [9, 11, 3],
                   "decoded": [[413, 550, 3], [[[255, 0, 0], [0, 255, 0]]]],
                   "trained": 2, "niqe": True, "delta": 1.0}
