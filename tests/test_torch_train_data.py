"""The port's training data against the JAX package's, on the CPU.

  * `dihedral`, `random_augmentation`, `random_crop`, the patch slicing and
    splicing and `degrade_by_type` bit-equal to promptir_tpu/data's;
  * `PromptTrainDataset` on a `tmp_path` corpus of the five tasks in the
    reference's layout, written with PIL as PNG, BMP and JPEG: JAX's sample
    list, length and every `get` bit for bit, both on the numpy path
    (`use_native=False`; the native path is held in test_torch_native.py);
  * the port's `TrainLoader` batches over that dataset equal
    `promptir_tpu.data.loader.TrainLoader`'s.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from promptir_tpu.data import augment as jaugment
from promptir_tpu.data import datasets as jds
from promptir_tpu.data import degradations as jdeg
from promptir_tpu.data import loader as jloader
from promptir_tpu.data import patches as jpatches
from promptir_tpu_torch.data import augment, datasets, degradations, loader, patches

ALL_TASKS = ("denoise_15", "denoise_25", "denoise_50", "derain", "dehaze")


def scene(hw, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 200, h), np.linspace(0, 200, w),
                         indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 20, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", range(8))
def test_dihedral_matches_jax(mode):
    img = scene((5, 7), mode)
    np.testing.assert_array_equal(augment.dihedral(img, mode),
                                  jaugment.dihedral(img, mode))


def test_dihedral_refuses_a_ninth_mode():
    with pytest.raises(ValueError, match="invalid augmentation mode 8"):
        augment.dihedral(scene((4, 4), 0), 8)


@pytest.mark.parametrize("seed", range(4))
def test_random_crop_and_augmentation_draw_as_jax(seed):
    """The same window and mode for a pair, from the same draws; mode 0
    is never drawn."""
    a, b = scene((40, 56), seed), scene((40, 56), seed + 10)
    mine, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):
        got = augment.random_augmentation(mine, *augment.random_crop(mine, 16, a, b))
        want = jaugment.random_augmentation(ref, *jaugment.random_crop(ref, 16, a, b))
        for u, v in zip(got, want):
            assert u.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(u, v)
    assert mine.integers(0, 2**31) == ref.integers(0, 2**31)
    modes = {int(np.random.default_rng(s).integers(1, 8)) for s in range(200)}
    assert 0 not in modes


@pytest.mark.parametrize("overlap", [0, 3])
def test_patches_match_jax(overlap):
    img = scene((32, 48), overlap)
    got = patches.slice_image_to_patches(img, 16, overlap)
    np.testing.assert_array_equal(got, jpatches.slice_image_to_patches(img, 16, overlap))
    back = patches.splice_patches_to_image(got, img.shape, overlap)
    np.testing.assert_array_equal(
        back, jpatches.splice_patches_to_image(got, img.shape, overlap))
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError, match="not a grid"):
        patches.slice_image_to_patches(img[:30], 16)


@pytest.mark.parametrize("de_type", [0, 1, 2])
def test_degrade_by_type_matches_jax(de_type):
    img = scene((12, 9), de_type)
    got = degradations.degrade_by_type(np.random.default_rng(5), img, de_type)
    want = jdeg.degrade_by_type(np.random.default_rng(5), img, de_type)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(degradations.to_float_chw_free(got),
                                  jdeg.to_float_chw_free(want))
    assert degradations.DE_TYPES == jdeg.DE_TYPES


def test_degrade_by_type_refuses_paired_tasks():
    with pytest.raises(ValueError, match="paired task"):
        degradations.degrade_by_type(np.random.default_rng(0), scene((4, 4), 0), 3)


def save(path, img, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path, **kw)


@pytest.fixture
def corpus(tmp_path):
    """The reference's layout (tests/test_data_pipeline.py:36-61): the
    denoise set as PNG, BMP and JPEG (one listed file missing, one present
    file unlisted), a rain pair as PNG, a haze pair as JPEG at 4:2:0."""
    root = str(tmp_path)
    for sub, text in [("noisy/denoise.txt", "a.png\nb.bmp\nc.jpg\nmissing.png\n"),
                      ("rainy/rainTrain.txt", "rainy/rain-1.png\n"),
                      ("hazy/hazy_outside.txt", "synthetic/0001_0.8_0.2.jpg\n")]:
        os.makedirs(os.path.dirname(f"{root}/data_dir/{sub}"), exist_ok=True)
        with open(f"{root}/data_dir/{sub}", "w") as f:
            f.write(text)
    save(f"{root}/denoise/a.png", scene((40, 56), 1))
    save(f"{root}/denoise/b.bmp", scene((37, 50), 2))
    save(f"{root}/denoise/c.jpg", scene((45, 41), 3), quality=90)
    save(f"{root}/denoise/d.png", scene((40, 56), 4))  # not listed
    save(f"{root}/derain/rainy/rain-1.png", scene((36, 52), 5))
    save(f"{root}/derain/gt/norain-1.png", scene((36, 52), 6))
    save(f"{root}/dehaze/synthetic/0001_0.8_0.2.jpg", scene((43, 38), 7), quality=75)
    save(f"{root}/dehaze/original/0001.jpg", scene((43, 38), 8), quality=75)
    return root


def train_sets(root, de_type=ALL_TASKS, patch=16):
    kw = dict(data_file_dir=f"{root}/data_dir/", denoise_dir=f"{root}/denoise/",
              derain_dir=f"{root}/derain/", dehaze_dir=f"{root}/dehaze/",
              de_type=de_type, patch_size=patch)
    return (datasets.PromptTrainDataset(use_native=False, **kw),
            jds.PromptTrainDataset(use_native=False, **kw))


def test_gt_names_match_jax():
    for name in ["/d/rainy/rain-42.png", "/x/rainy/sub/rain-7.jpg"]:
        assert datasets.derain_gt_name(name) == jds.derain_gt_name(name)
    for name in ["/d/synthetic/part1/0025_0.8_0.04.jpg", "/d/synthetic/9_1_2.png"]:
        assert datasets.dehaze_gt_name(name) == jds.dehaze_gt_name(name)


@pytest.mark.parametrize("de_type", [ALL_TASKS, ("denoise_25", "dehaze"),
                                     ("derain",)], ids=["all", "noise_haze", "rain"])
def test_sample_list_matches_jax(corpus, de_type):
    mine, ref = train_sets(corpus, de_type)
    assert len(mine) == len(ref)
    assert [(s.degraded_path, s.clean_path, s.de_type) for s in mine.samples] == \
        [(s.degraded_path, s.clean_path, s.de_type) for s in ref.samples]
    n_noise = sum(t.startswith("denoise") for t in de_type)
    assert len(mine) == 3 * 3 * n_noise + 120 * ("derain" in de_type) + (
        "dehaze" in de_type)


def test_every_sample_is_bit_equal_to_jax(corpus):
    """All 148 samples of the five tasks (27 denoise over PNG, BMP and
    JPEG, 120 rain, 1 haze), each from its own generator."""
    mine, ref = train_sets(corpus)
    assert len(mine) == 148
    seen = set()
    for i in range(len(mine)):
        got = mine.get(i, np.random.default_rng((3, i)))
        want = ref.get(i, np.random.default_rng((3, i)))
        assert got[0] == want[0]
        seen.add(got[0])
        for u, v in zip(got[1:], want[1:]):
            assert u.dtype == np.float32 and u.shape == (16, 16, 3)
            np.testing.assert_array_equal(u, v)
    assert seen == {0, 1, 2, 3, 4}


def test_loader_batches_over_the_corpus_are_bit_equal_to_jax(corpus):
    """The port's TrainLoader over the port's dataset against the JAX
    loader over the JAX dataset: the same shuffle, draws and batches."""
    mine, ref = train_sets(corpus, ("denoise_15", "derain", "dehaze"))
    ours = loader.TrainLoader(mine, batch_size=4, seed=3, num_workers=2)
    theirs = jloader.TrainLoader(ref, batch_size=4, seed=3, num_workers=2)
    assert len(ours) == len(theirs) == (9 + 120 + 1) // 4
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert a["degraded"].dtype == torch.float32
            for k in ("de_type", "degraded", "clean"):
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), k)
