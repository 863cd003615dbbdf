"""The port's native loader library (promptir_tpu_torch/data/native.py,
native/png_decode.cpp and native/fused_augment.cpp) on the CPU:

  * the PNG reader bit-equal to utils/png.py's plain decoder, to the JAX
    package's native reader and to PIL, on every color type and row
    filter of tests/test_torch_png.py's fixtures; each refusal a ValueError
    naming the file, with the plain decoder's message; a palette index past
    the PLTE read as 0; four threads, and sixteen, decoding at once as one
    thread;
  * `prepare_paired_sample` and `prepare_denoise_sample` bit-equal to the
    JAX package's library (built by its Makefile on the same host) for all
    8 modes and several seeds and sigmas, and their clean patches to the
    numpy crop and dihedral;
  * `PromptTrainDataset` on its default native path: every sample of the
    five-task corpus and the loader's batches bit-equal to the JAX
    package's `use_native=True`;
  * the build: keyed by sources and flags, a missing g++ raises and never
    falls back to the numpy path.
"""

import io
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from promptir_tpu.data import datasets as jds
from promptir_tpu.data import loader as jloader
from promptir_tpu.data import native as jnative
from promptir_tpu_torch.data import augment, datasets, loader, native
from promptir_tpu_torch.utils import cxx, png
from test_torch_png import as_mode, bands, hand_png, pil_png
from test_torch_train_data import ALL_TASKS, corpus, scene  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    assert jnative.available(), "the JAX package's native library did not build"


def chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def png_of(ihdr, idat, plte=None):
    """A PNG of raw parts: IHDR fields, the zlib stream, an optional PLTE."""
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + (b"" if plte is None else chunk(b"PLTE", plte))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def random_img(hw, bpp, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, bpp),
                                                dtype=np.uint8)


def fixture_png(case):
    kind, *arg = case
    if kind == "pil":
        return pil_png(as_mode(bands(), arg[0]), optimize=True)
    if kind == "filter":
        f, ctype = arg
        return hand_png(random_img((13, 17), {2: 3, 6: 4}[ctype], 10 * f + ctype),
                        f, ctype)
    if kind == "mixed":
        (h, w), ctype = arg
        bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        rng = np.random.default_rng(h * 100 + w + ctype)
        filters = rng.integers(0, 5, h)
        filters[:min(5, h)] = [3, 4, 0, 1, 2][:min(5, h)]
        return hand_png(random_img((h, w), bpp, h + w), filters, ctype)
    img = np.ascontiguousarray(np.tile(bands(96, 481), (4, 1, 1))[:321])
    return pil_png(Image.fromarray(img), optimize=True)


CASES = ([("pil", m) for m in ["RGB", "L", "LA", "P", "RGBA"]]
         + [("filter", f, c) for f in range(5) for c in (2, 6)]
         + [("mixed", hw, c) for hw in [(1, 9), (9, 1), (23, 5)]
            for c in (0, 2, 4, 6)]
         + [("test_set_sized",)])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_reader_equals_plain_jax_and_pil(case):
    data = fixture_png(case)
    got = native.decode_png_rgb(data)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, png.decode_png_plain(data))
    np.testing.assert_array_equal(got, jnative.decode_png_rgb(data))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    np.testing.assert_array_equal(png.decode_png(data), got)


def refused(kind):
    """PNG bytes the reader refuses, and the message's key words."""
    img = bands()[:16, :16]
    ok = png.encode_png(img)
    raw = zlib.compress(np.concatenate(
        [np.zeros((16, 1), np.uint8), img.reshape(16, -1)], 1).tobytes())
    if kind == "16bit":
        buf = io.BytesIO()
        Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(buf, "PNG")
        return buf.getvalue(), "16-bit gray PNG is not supported"
    if kind == "interlaced":
        return hand_png(img, 0, interlace=1), "interlaced"
    if kind == "truncated":
        return ok[:-20], "truncated PNG"
    if kind == "corrupt_zlib":
        bad = bytearray(ok)
        i = ok.index(b"IDAT") + 4
        bad[i:i + 8] = b"\x00" * 8
        return bytes(bad), "corrupt PNG image data: Error -3"
    if kind == "corrupt_tail":
        # the rows are all there; the stream breaks after them
        broken = raw[:-4] + bytes([raw[-4] ^ 0xFF]) + raw[-3:]
        return png_of((16, 16, 8, 2, 0, 0, 0), broken), "corrupt PNG image data"
    if kind == "oversized":
        return png_of(((1 << 20) + 1, 16, 8, 2, 0, 0, 0), raw), "out of range"
    if kind == "too_short":
        return png_of((16, 17, 8, 2, 0, 0, 0), raw), "too short"
    if kind == "stream_cut":
        return png_of((16, 16, 8, 2, 0, 0, 0), raw[:-30]), \
            "incomplete or truncated stream"
    if kind == "no_plte":
        return png_of((16, 16, 8, 3, 0, 0, 0), zlib.compress(
            bytes(16 * 17))), "palette PNG without a PLTE chunk"
    if kind == "color_type_5":
        return png_of((16, 16, 8, 5, 0, 0, 0), raw), "unknown PNG color type 5"
    if kind == "row_filter":
        rows = bytearray(zlib.decompress(raw))
        rows[3 * (16 * 3 + 1)] = 7
        return png_of((16, 16, 8, 2, 0, 0, 0), zlib.compress(bytes(rows))), \
            "unknown PNG row filter 7"
    if kind == "no_idat":
        return (png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 16, 16, 8, 2, 0, 0, 0)) + chunk(b"IEND", b"")), \
            "without a header or image data"
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue(), "JPEG is not supported"


REFUSALS = ["16bit", "interlaced", "truncated", "corrupt_zlib", "corrupt_tail",
            "oversized", "too_short", "stream_cut", "no_plte", "color_type_5",
            "row_filter", "no_idat", "jpeg"]


@pytest.mark.parametrize("kind", REFUSALS)
def test_refusals_name_the_file_with_the_plain_message(kind, tmp_path):
    data, words = refused(kind)
    path = tmp_path / f"{kind}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError) as plain:
        png.decode_png_plain(data, name=str(path))
    with pytest.raises(ValueError) as got:
        png.read_png(str(path))
    assert str(got.value) == str(plain.value)
    assert str(path) in str(got.value) and words in str(got.value)
    if kind == "too_short":
        # the JAX reader leaves the rows the stream lacks 0 (its buffer's
        # initial value); the plain decoder, and so the port, refuses them
        assert not jnative.decode_png_rgb(data)[16:].any()
    elif kind != "jpeg":  # where the JAX reader declines, the port raises
        assert jnative.decode_png_rgb(data) is None
        with pytest.raises(ValueError, match=words.split(":")[0]):
            native.decode_png_rgb(data, name=str(path))


def test_a_palette_index_past_the_plte_reads_as_zero():
    """The JAX reader declines the file and falls back to PIL; PIL and the
    plain decoder read the missing entries as 0, and so does the port."""
    idx = np.random.default_rng(4).integers(0, 10, (9, 14), dtype=np.uint8)
    plte = bytes(np.arange(4 * 3, dtype=np.uint8) * 20 + 5)
    rows = np.concatenate([np.zeros((9, 1), np.uint8), idx], 1).tobytes()
    data = png_of((14, 9, 8, 3, 0, 0, 0), zlib.compress(rows), plte)
    got = png.decode_png(data)
    want = np.zeros((10, 3), np.uint8)
    want[:4] = np.frombuffer(plte, np.uint8).reshape(4, 3)
    np.testing.assert_array_equal(got, want[idx])
    np.testing.assert_array_equal(got, png.decode_png_plain(data))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert jnative.decode_png_rgb(data) is None


@pytest.mark.parametrize("threads", [4, 16])
def test_threads_decode_as_one_thread(threads):
    """The loader's four threads, and more threads than the host's cores,
    with the interpreter switching threads often."""
    files = [fixture_png(c) for c in CASES] * 3
    want = [native.decode_png_rgb(d) for d in files]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            got = list(pool.map(native.decode_png_rgb, files, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def bits(a):
    assert a.dtype == np.float32
    return a.view(np.uint32)


@pytest.mark.parametrize("mode", range(8))
def test_paired_sample_is_bit_equal_to_jax(mode):
    """The JAX library's crop and dihedral, and the numpy crop, dihedral and
    float conversion, at three windows of a pair."""
    d, c = scene((41, 57), mode), scene((41, 57), mode + 20)
    for ci, cj, p in [(0, 0, 16), (25, 41, 16), (3, 10, 32)]:
        got = native.prepare_paired_sample(d, c, ci, cj, p, mode)
        want = jnative.prepare_paired_sample(d, c, ci, cj, p, mode)
        for u, v, img in zip(got, want, (d, c)):
            assert u.shape == (p, p, 3)
            np.testing.assert_array_equal(bits(u), bits(v))
            plain = augment.dihedral(img[ci:ci + p, cj:cj + p], mode)
            np.testing.assert_array_equal(
                bits(u), bits(plain.astype(np.float32) / 255.0))


@pytest.mark.parametrize("sigma", [15.0, 25.0, 50.0, 7.3])
@pytest.mark.parametrize("mode", range(8))
def test_denoise_sample_is_bit_equal_to_jax(mode, sigma):
    img = scene((48, 40), mode)
    for seed in (0, 1, 12345, 2**63 - 2):
        got = native.prepare_denoise_sample(img, 5, 7, 24, mode, sigma, seed)
        want = jnative.prepare_denoise_sample(img, 5, 7, 24, mode, sigma, seed)
        for u, v in zip(got, want):
            np.testing.assert_array_equal(bits(u), bits(v))
        plain = augment.dihedral(img[5:29, 7:31], mode)
        np.testing.assert_array_equal(
            bits(got[1]), bits(plain.astype(np.float32) / 255.0))
        assert 0 < np.abs(got[0] - got[1]).mean() < 3 * sigma / 255.0


def test_a_window_outside_the_image_raises():
    img = scene((20, 20), 0)
    with pytest.raises(ValueError, match="does not fit a 20x20 image"):
        native.prepare_denoise_sample(img, 8, 0, 16, 1, 15.0, 0)
    with pytest.raises(ValueError, match="does not fit"):
        native.prepare_paired_sample(img, img, 0, 0, 16, 8)
    with pytest.raises(ValueError, match="of one size"):
        native.prepare_paired_sample(img, img[:19], 0, 0, 16, 1)


def native_sets(root, de_type=ALL_TASKS, patch=16, use_native=None):
    kw = dict(data_file_dir=f"{root}/data_dir/", denoise_dir=f"{root}/denoise/",
              derain_dir=f"{root}/derain/", dehaze_dir=f"{root}/dehaze/",
              de_type=de_type, patch_size=patch)
    return (datasets.PromptTrainDataset(use_native=use_native, **kw),
            jds.PromptTrainDataset(use_native=True, **kw))


@pytest.mark.parametrize("use_native", [None, True])
def test_every_native_sample_is_bit_equal_to_jax(corpus, use_native):  # noqa: F811
    """All 148 samples of the five tasks (27 denoise over PNG, BMP and
    JPEG, 120 rain, 1 haze) on the default path and with use_native=True,
    each from its own generator, which both sides leave in one state."""
    mine, ref = native_sets(corpus, use_native=use_native)
    assert len(mine) == 148
    seen = set()
    for i in range(len(mine)):
        r_mine, r_ref = np.random.default_rng((4, i)), np.random.default_rng((4, i))
        got, want = mine.get(i, r_mine), ref.get(i, r_ref)
        assert got[0] == want[0]
        seen.add(got[0])
        for u, v in zip(got[1:], want[1:]):
            assert u.shape == (16, 16, 3)
            np.testing.assert_array_equal(bits(u), bits(v))
        assert r_mine.integers(0, 2**62) == r_ref.integers(0, 2**62)
    assert seen == {0, 1, 2, 3, 4}


def test_native_loader_batches_are_bit_equal_to_jax(corpus):  # noqa: F811
    mine, ref = native_sets(corpus, ("denoise_25", "derain", "dehaze"))
    ours = loader.TrainLoader(mine, batch_size=4, seed=5, num_workers=3)
    theirs = jloader.TrainLoader(ref, batch_size=4, seed=5, num_workers=3)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == (9 + 120 + 1) // 4
        for a, b in zip(got, want):
            assert a["degraded"].dtype == torch.float32
            for k in ("de_type", "degraded", "clean"):
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), k)


def test_the_paths_differ_only_in_the_noise(corpus):  # noqa: F811
    """Same generator, both paths: a paired sample is the same (the draws
    are the same: window, mode); a denoise sample's clean patch too, while
    its noise comes from another stream."""
    nat, _ = native_sets(corpus)
    num, _ = native_sets(corpus, use_native=False)
    rain = next(i for i, s in enumerate(nat.samples) if s.de_type == 3)
    for i, same_noise in [(0, False), (rain, True)]:
        a = nat.get(i, np.random.default_rng(9))
        b = num.get(i, np.random.default_rng(9))
        np.testing.assert_array_equal(a[2], b[2])
        assert np.array_equal(a[1], b[1]) == same_noise


def test_no_gpp_raises_and_never_falls_back(corpus, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(cxx, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.LIBRARY, "_cdll", None)
    mine, _ = native_sets(corpus)
    with mock.patch.object(cxx.shutil, "which", return_value=None):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            mine.get(0, np.random.default_rng(0))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            png.decode_png(png.encode_png(bands()[:4, :4]))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.available()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(cxx, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cxx, "NATIVE", tmp_path)
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    lib = cxx.Library("broken", ["broken.cpp"], ("-shared", "-fPIC"))
    with pytest.raises(RuntimeError, match="building broken.cpp failed"):
        lib.load()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_the_library_is_keyed_by_sources_and_flags(monkeypatch):
    a = native.LIBRARY.path()
    monkeypatch.setattr(native.LIBRARY, "flags", native.LIBRARY.flags + ("-g",))
    b = native.LIBRARY.path()
    assert a != b and a.parent == b.parent == cxx.BUILD_DIR
    assert a.name.startswith("libpromptir_native_")
    assert "-march=native" in native.LIBRARY.flags and native.LIBRARY.link == ("-lz",)
