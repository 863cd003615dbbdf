"""The port's test datasets against the JAX package's, on a PNG corpus
(and SOTS-shaped JPEG inputs).

A BSD68-, Rain100L- and SOTS-shaped corpus at odd sizes, written to
tmp_path partly by PIL's optimizing encoder (every row filter) and partly
by the port's writer: both packages must give the same names and the same
degraded and clean arrays, bit for bit, at every index (the denoise set at
sigma 15, 25 and 50). crop_to_multiple matches too.
"""

import numpy as np
import pytest
from PIL import Image

from promptir_tpu.data import augment as jaugment
from promptir_tpu.data import datasets as jds
from promptir_tpu_torch.data import augment, datasets
from promptir_tpu_torch.utils.png import write_png


def scene(hw, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 200, h), np.linspace(0, 200, w),
                         indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 12, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def write(path, hw, seed, pil):
    path.parent.mkdir(parents=True, exist_ok=True)
    if pil:
        Image.fromarray(scene(hw, seed)).save(path, optimize=True)
    else:
        write_png(str(path), scene(hw, seed))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for i, hw in enumerate([(43, 61), (61, 43), (50, 37)]):
        write(d / "bsd68" / f"{i + 1}.png", hw, i, pil=i % 2 == 0)
    for i, hw in enumerate([(45, 67), (45, 67)]):
        write(d / "rain100l" / "input" / f"rain-{i + 1}.png", hw, 10 + i, pil=True)
        write(d / "rain100l" / "target" / f"rain-{i + 1}.png", hw, 20 + i,
              pil=False)
    for i, hw in enumerate([(53, 70), (41, 58)]):
        write(d / "sots" / "input" / f"{i + 1:04d}_0.9_0.2.png", hw, 30 + i,
              pil=False)
        write(d / "sots" / "target" / f"{i + 1:04d}.png", hw, 40 + i, pil=True)
    (d / "bsd68" / "notes.txt").write_text("not an image")
    return d


def assert_same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_denoise_sets_are_bit_identical(corpus):
    mine = datasets.DenoiseTestDataset(str(corpus / "bsd68"))
    ref = jds.DenoiseTestDataset(str(corpus / "bsd68"))
    assert len(mine) == len(ref) == 3
    for sigma in (15, 25, 50):
        mine.set_sigma(sigma)
        ref.set_sigma(sigma)
        for i in range(len(ref)):
            assert_same(mine.get(i), ref.get(i))


@pytest.mark.parametrize("task,root", [("derain", "rain100l"), ("dehaze", "sots")])
def test_paired_sets_are_bit_identical(corpus, task, root):
    kw = dict(derain_path=str(corpus / "rain100l"),
              dehaze_path=str(corpus / "sots"))
    mine = datasets.DerainDehazeDataset(**kw, task=task)
    ref = jds.DerainDehazeDataset(**kw, task=task)
    assert len(mine) == len(ref) == 2
    for i in range(len(ref)):
        assert mine._gt_path(mine.ids[i]) == ref._gt_path(ref.ids[i])
        assert_same(mine.get(i), ref.get(i))
    noisy = dict(kw, task=task, addnoise=True, sigma=25.0)
    assert_same(datasets.DerainDehazeDataset(**noisy).get(1),
                jds.DerainDehazeDataset(**noisy).get(1))


def test_demo_loader_is_bit_identical(corpus):
    for path in [corpus / "bsd68", corpus / "sots" / "input" / "0002_0.9_0.2.png"]:
        mine = datasets.TestSpecificDataset(str(path))
        ref = jds.TestSpecificDataset(str(path))
        assert len(mine) == len(ref)
        for i in range(len(ref)):
            assert_same(mine.get(i), ref.get(i))


def test_jpeg_input_is_refused_naming_the_file(tmp_path):
    """A JPEG the port's baseline decoder does not read (progressive) is
    refused naming the file; baseline JPEG reads (the test below)."""
    path = tmp_path / "photo.jpg"
    Image.fromarray(scene((32, 32), 0)).save(path, format="JPEG",
                                             progressive=True)
    ds = datasets.TestSpecificDataset(str(path))
    with pytest.raises(ValueError, match="progressive JPEG is not supported") as e:
        ds.get(0)
    assert str(path) in str(e.value)


def test_sots_hazy_jpegs_are_bit_identical(tmp_path):
    """SOTS outdoor's hazy inputs are JPEG (its targets PNG): both
    packages read the same arrays, the demo loader too."""
    for i, hw in enumerate([(53, 70), (41, 58)]):
        inp = tmp_path / "sots" / "input" / f"{i + 1:04d}_0.9_0.2.jpg"
        inp.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(scene(hw, 50 + i)).save(inp, quality=75 + 10 * i)
        write(tmp_path / "sots" / "target" / f"{i + 1:04d}.png", hw, 60 + i,
              pil=True)
    kw = dict(dehaze_path=str(tmp_path / "sots"), task="dehaze")
    mine, ref = datasets.DerainDehazeDataset(**kw), jds.DerainDehazeDataset(**kw)
    for i in range(2):
        assert_same(mine.get(i), ref.get(i))
    inputs = str(tmp_path / "sots" / "input")
    mine, ref = datasets.TestSpecificDataset(inputs), jds.TestSpecificDataset(inputs)
    for i in range(2):
        assert_same(mine.get(i), ref.get(i))


@pytest.mark.parametrize("hw,base", [((43, 61), 16), ((321, 481), 16),
                                     ((64, 64), 16), ((413, 550), 8)])
def test_crop_to_multiple_matches_jax(hw, base):
    img = scene(hw, 5)
    np.testing.assert_array_equal(augment.crop_to_multiple(img, base),
                                  jaugment.crop_to_multiple(img, base))
