"""The port's viz CLI against the JAX package's, on the same files.

  * `compare`: the same summary and the same JSON as JAX's;
  * `zoombox`: pixel-equal to JAX's figure (PIL's default bicubic resize,
    ImageDraw's outlines) over random images, boxes that leave the image,
    boxes narrower than their outline, scales 1 to 3; its resize alone
    equal to PIL's at arbitrary sizes, up and down;
  * `windowgrid`: pixel-equal to JAX's, with and without noise;
  * `curves`: a figure from two runs' metrics.jsonl.
The JAX CLI reads and writes through PIL, the port through its own codecs;
both figures are compared after decoding.
"""

import json

import numpy as np
import pytest
from PIL import Image

from promptir_tpu.cli import viz as jviz
from promptir_tpu_torch.cli import viz
from promptir_tpu_torch.utils.png import read_png, write_png


def image(rng, h, w):
    if rng.integers(2):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (np.stack([3 * xx, 5 * yy, 7 * (xx + yy)], -1) % 256).astype(np.uint8)


def both(tmp_path, args, img):
    """The port's and JAX's CLI output for `args` on `img`, decoded."""
    src = tmp_path / "in.png"
    write_png(str(src), img)
    out = []
    for name, main in (("ours", viz.main), ("jax", jviz.main)):
        path = tmp_path / f"{name}.png"
        main([args[0], str(src), *args[1:], "--out", str(path)])
        out.append(read_png(str(path)))
    return out


def test_compare_matches_jax(tmp_path, capsys):
    base = {"a": 30.0, "b": 31.5, "c": 32.0, "only_base": 1.0}
    ours = {"a": 30.5, "b": 30.0, "c": 33.25, "only_ours": 2.0}
    assert viz.compare_psnr_dicts(base, ours) == jviz.compare_psnr_dicts(
        base, ours)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(base))
    b.write_text(json.dumps(ours))
    printed, written = [], []
    for i, main in enumerate((viz.main, jviz.main)):
        out = tmp_path / f"cmp{i}.json"
        main(["compare", str(a), str(b), "--top", "2", "--out", str(out)])
        printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
        written.append(json.loads(out.read_text()))
    assert printed[0] == printed[1] and written[0] == written[1]
    assert written[0]["deltas"] == {"c": 1.25, "a": 0.5, "b": -1.5}


def test_zoombox_cli_is_pixel_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    for h, w, box, scale in [(64, 96, (10, 12, 16), 2), (80, 70, (60, 50, 30), 2),
                             (48, 48, (-5, 3, 12), 3), (40, 64, (5, 5, 1), 1)]:
        ours, ref = both(tmp_path, ["zoombox", "--box", *map(str, box),
                                    "--scale", str(scale)], image(rng, h, w))
        np.testing.assert_array_equal(ours, ref)


def test_zoombox_and_resize_equal_pil_over_random_cases():
    rng = np.random.default_rng(1)
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        img = image(rng, h, w)
        size, scale = int(rng.integers(1, 30)), int(rng.integers(1, 4))
        x, y = int(rng.integers(-5, w)), int(rng.integers(-5, h))
        width = int(rng.integers(1, 4))
        ref = np.array(jviz.zoombox(Image.fromarray(img), x, y, size,
                                    scale=scale, box_width=width))
        np.testing.assert_array_equal(
            viz.zoombox(img, x, y, size, scale=scale, box_width=width), ref)
        oh, ow = (int(v) for v in rng.integers(1, 90, 2))
        np.testing.assert_array_equal(
            viz.resize_bicubic(img, oh, ow),
            np.array(Image.fromarray(img).resize((ow, oh))))


@pytest.mark.parametrize("flags", [[], ["--sigma", "15", "--seed", "3"],
                                   ["--window", "5", "--sigma", "40"]],
                         ids=["grid", "noise", "window5"])
def test_windowgrid_cli_is_pixel_equal_to_jax(tmp_path, flags):
    img = image(np.random.default_rng(2), 45, 61)
    ours, ref = both(tmp_path, ["windowgrid", *flags], img)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[0, :] == viz.YELLOW).all()


def test_curves_plots_two_runs(tmp_path, capsys):
    runs = []
    for r in range(2):
        path = tmp_path / f"run{r}" / "metrics.jsonl"
        path.parent.mkdir()
        path.write_text("".join(json.dumps({"step": i, "train_loss": 1 / (i + r + 1)})
                                + "\n" for i in range(5)))
        runs.append(str(path))
    out = tmp_path / "c.png"
    viz.main(["curves", *runs, "--out", str(out)])
    assert out.stat().st_size > 0
    assert "run1: 5 points, last train_loss=0.1667" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="nothing to plot"):
        viz.main(["curves", runs[0], "--metric", "psnr", "--out", str(out)])
