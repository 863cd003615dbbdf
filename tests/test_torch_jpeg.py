"""The port's JPEG and BMP readers against PIL's decode, on the CPU.

  * JPEGs that PIL writes (4:4:4, 4:2:2, 4:2:0, gray; quality 75 and 95;
    sides that are multiples of neither 8 nor 16; with and without restart
    markers) decode bit-equal to `np.asarray(Image.open(p).convert("RGB"))`
    through `utils/jpeg.py` (native/jpeg_decode.cpp, built with g++);
  * the committed fixtures (tests/torch_fixtures/jpeg) decode to the PIL
    decodes stored beside them, and those still equal PIL's;
  * BMPs of 24 and 32 bits and 8-bit palettes, bottom-up and top-down,
    decode bit-equal too (`utils/bmp.py`);
  * unsupported files raise a ValueError naming the file and the feature;
    so do Huffman tables that libjpeg refuses and frames past PIL's
    decompression-bomb limit, as PIL raises for them;
  * `utils/image_io.read_image` picks the reader by the magic bytes.
"""

import hashlib
import io
import pathlib
import struct
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from promptir_tpu_torch.utils import bmp, cxx, image_io, jpeg

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_fixtures" / "jpeg"


def scene(hw, seed, noise=25.0):
    """A gradient with noise, HWC uint8: every DCT coefficient busy."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 200, h), np.linspace(0, 200, w),
                         indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, noise, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def jpeg_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("restart", [None, 1, 3], ids=["plain", "rst1", "rst3"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_color_jpeg_is_bit_equal_to_pil(subsampling, quality, restart):
    kw = dict(quality=quality, subsampling=subsampling)
    if restart:
        kw["restart_marker_blocks"] = restart
    for hw in [(37, 53), (64, 48), (21, 90)]:
        data = jpeg_bytes(scene(hw, sum(hw)), **kw)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_rgb(data))


@pytest.mark.parametrize("restart", [None, 2])
@pytest.mark.parametrize("quality", [75, 95])
def test_gray_jpeg_is_bit_equal_to_pil(quality, restart):
    kw = dict(quality=quality)
    if restart:
        kw["restart_marker_blocks"] = restart
    for hw in [(29, 41), (16, 24)]:
        img = scene(hw, 7)[..., 0]
        data = jpeg_bytes(img, **kw)
        got = jpeg.decode_jpeg(data)
        assert got.shape == hw + (3,)
        np.testing.assert_array_equal(got, pil_rgb(data))


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (3, 5), (9, 17), (17, 4)])
@pytest.mark.parametrize("subsampling", [1, 2], ids=["422", "420"])
def test_tiny_sides_take_libjpegs_edge_rules(hw, subsampling):
    """Chroma 2 samples wide or less is replicated, not triangle-filtered
    (jdsample.c), and a single row or column has no context."""
    data = jpeg_bytes(scene(hw, 3), quality=90, subsampling=subsampling)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_rgb(data))


def fixture_decodes():
    with np.load(FIXTURES / "decodes.npz") as z:
        return {k: z[k] for k in z.files}


def fixture_names():
    return sorted(k.split(":", 1)[-1] for k in fixture_decodes()
                  if not k.startswith("shape:"))


@pytest.mark.parametrize("rel", fixture_names())
def test_committed_fixtures_decode_to_the_stored_pil_decode(rel):
    """What the card's smoke holds the decoder against (chip_smoke.py phase
    11): the stored decode, or for the 550x413 haze pair its SHA-256; and
    the stored decode is still PIL's."""
    want = fixture_decodes()
    path = FIXTURES / rel
    got = jpeg.read_jpeg(str(path))
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    if rel in want:
        np.testing.assert_array_equal(got, want[rel])
        np.testing.assert_array_equal(pil, want[rel])
    else:
        assert list(got.shape) == list(want["shape:" + rel])
        digest = str(want["sha256:" + rel])
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest
        assert hashlib.sha256(pil.tobytes()).hexdigest() == digest


def test_fixtures_stay_small():
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 300_000


@pytest.mark.parametrize("kind,match", [
    ("progressive", "progressive JPEG is not supported"),
    ("cmyk", "CMYK/YCCK JPEG is not supported"),
    ("truncated", "truncated"),
])
def test_unsupported_jpeg_raises_naming_the_file(kind, match, tmp_path):
    rgb = scene((24, 32), 1)
    path = tmp_path / f"bad_{kind}.jpg"
    if kind == "progressive":
        path.write_bytes(jpeg_bytes(rgb, progressive=True))
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG")
        path.write_bytes(buf.getvalue())
    else:
        path.write_bytes(jpeg_bytes(rgb)[:100])
    with pytest.raises(ValueError, match=match) as e:
        jpeg.read_jpeg(str(path))
    assert str(path) in str(e.value)


def test_sof_markers_name_the_refused_feature():
    """A frame header of each refused process names it."""
    data = bytearray(jpeg_bytes(scene((16, 16), 2)))
    sof = data.index(b"\xff\xc0")
    for marker, what in [(0xC2, "progressive"), (0xC3, "lossless"),
                         (0xC9, "arithmetic-coded"), (0xC5, "hierarchical")]:
        bad = bytearray(data)
        bad[sof + 1] = marker
        with pytest.raises(ValueError, match=f"x.jpg: {what}"):
            jpeg.decode_jpeg(bytes(bad), "x.jpg")
    bad = bytearray(data)
    bad[sof + 4] = 12  # sample precision
    with pytest.raises(ValueError, match="12-bit samples are not supported"):
        jpeg.decode_jpeg(bytes(bad), "x.jpg")


def dht(tc, counts, vals):
    """A DHT segment: table class and id `tc`, {code length: count}."""
    c = [0] * 16
    for length, n in counts.items():
        c[length - 1] = n
    body = bytes([tc]) + bytes(c) + bytes(vals)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("tc,counts,vals", [
    (0x00, {1: 3}, [0, 1, 2]),           # a code past its length
    (0x10, {1: 200}, range(200)),         # kilobytes past the lookup table
    (0x00, {1: 2}, [0, 1]),               # an all-ones code
    (0x00, {2: 3}, [0, 1, 16]),           # a DC symbol above 15
], ids=["overfull", "far_overfull", "all_ones", "dc_symbol_16"])
def test_a_bad_huffman_table_raises_naming_the_file(tc, counts, vals, tmp_path):
    """A table that libjpeg refuses, placed where the scan uses it, raises
    (PIL raises too) and writes nothing past the decoder's tables."""
    data = jpeg_bytes(scene((24, 32), 3))
    sos = data.index(b"\xff\xda")
    bad = data[:sos] + dht(tc, counts, vals) + data[sos:]
    with pytest.raises(OSError):
        pil_rgb(bad)
    path = tmp_path / "bad_dht.jpg"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match="bad Huffman table") as e:
        jpeg.read_jpeg(str(path))
    assert str(path) in str(e.value)


def test_a_bad_huffman_table_no_scan_uses_decodes():
    """As in libjpeg, a table is checked where a scan uses it: an over-full
    table in a slot the scan never reads leaves the decode as PIL's."""
    data = jpeg_bytes(scene((24, 32), 3))
    sos = data.index(b"\xff\xda")
    odd = data[:sos] + dht(0x03, {1: 3}, [0, 1, 2]) + data[sos:]
    np.testing.assert_array_equal(jpeg.decode_jpeg(odd), pil_rgb(odd))


def test_a_huge_frame_raises_before_allocating(tmp_path):
    """A 65535x65535 frame header raises as PIL's decompression-bomb limit
    does (twice Image.MAX_IMAGE_PIXELS), before any buffer is made."""
    data = bytearray(jpeg_bytes(scene((16, 16), 2)))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = b"\xff\xff\xff\xff"  # height, width
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bytes(data)))
    path = tmp_path / "huge.jpg"
    path.write_bytes(bytes(data))
    with mock.patch.object(jpeg.np, "empty", side_effect=AssertionError):
        with pytest.raises(ValueError, match="65535x65535 pixels exceed the "
                           "limit of 178956970") as e:
            jpeg.read_jpeg(str(path))
    assert str(path) in str(e.value)


def test_the_build_raises_without_gpp(tmp_path, monkeypatch):
    monkeypatch.setattr(cxx, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg.LIBRARY, "_cdll", None)
    with mock.patch.object(cxx.shutil, "which", return_value=None):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            jpeg.lib()


def test_the_library_is_keyed_by_source_and_flags(monkeypatch):
    a = jpeg.LIBRARY.path()
    monkeypatch.setattr(jpeg.LIBRARY, "flags", jpeg.LIBRARY.flags + ("-g",))
    b = jpeg.LIBRARY.path()
    assert a != b and a.parent == b.parent == cxx.BUILD_DIR
    assert a.name.startswith("libjpeg_decode_") and a.suffix == ".so"


def bmp_bytes(img, bits, top_down=False, palette=None, pad_byte=0x5A):
    """A BITMAPINFOHEADER BMP written by hand: 8 bits (img holds palette
    indices), 24 (BGR) or 32 (BGRX, the fourth byte `pad_byte`)."""
    h, w = img.shape[:2]
    stride = (w * bits + 31) // 32 * 4
    if bits == 8:
        body = img
    elif bits == 24:
        body = img[..., ::-1].reshape(h, -1)
    else:
        x = np.full((h, w, 1), pad_byte, np.uint8)
        body = np.concatenate([img[..., ::-1], x], 2).reshape(h, -1)
    rows = np.full((h, stride), 0xEE, np.uint8)  # the padding is not read
    rows[:, :body.shape[1]] = body
    if not top_down:
        rows = rows[::-1]
    pal = b""
    if palette is not None:
        pal = np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1),
                                                         np.uint8)], 1).tobytes()
    off = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                       0, stride * h, 2835, 2835,
                       0 if palette is None else len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", off + stride * h, 0, 0, off) + info
            + pal + rows.tobytes())


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("bits", [8, 24, 32])
def test_bmp_is_bit_equal_to_pil(bits, top_down):
    rng = np.random.default_rng(bits)
    for hw in [(7, 5), (33, 47), (1, 3)]:
        if bits == 8:
            img = rng.integers(0, 20, hw, dtype=np.uint8)
            data = bmp_bytes(img, 8, top_down,
                             rng.integers(0, 256, (20, 3), dtype=np.uint8))
        else:
            data = bmp_bytes(scene(hw, 4), bits, top_down)
        np.testing.assert_array_equal(bmp.decode_bmp(data), pil_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_pil_written_bmp_is_bit_equal(mode, tmp_path):
    img = Image.fromarray(scene((19, 30), 5))
    img = {"RGB": img, "L": img.convert("L"), "P": img.quantize(37)}[mode]
    path = tmp_path / "x.bmp"
    img.save(path, format="BMP")
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(bmp.read_bmp(str(path)), want)


def test_unsupported_bmp_raises_naming_the_file(tmp_path):
    path = tmp_path / "rle.bmp"
    Image.fromarray(scene((8, 8), 1)).convert("P").save(path, format="BMP",
                                                         compression=1)
    data = bytearray(path.read_bytes())
    data[30:34] = struct.pack("<I", 1)  # BI_RLE8
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="compressed BMP") as e:
        bmp.read_bmp(str(path))
    assert str(path) in str(e.value)
    data[30:34] = struct.pack("<I", 0)
    data[28:30] = struct.pack("<H", 4)  # 4 bits a pixel
    with pytest.raises(ValueError, match="4-bit BMP is not supported"):
        bmp.decode_bmp(bytes(data), "x.bmp")


def test_read_image_goes_by_the_magic_bytes(tmp_path):
    """A JPEG named .png and a BMP named .jpg read as what they are; an
    unknown format raises naming the file."""
    rgb = scene((24, 40), 9)
    data = jpeg_bytes(rgb, quality=90)
    (tmp_path / "photo.png").write_bytes(data)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "photo.png")),
                                  pil_rgb(data))
    (tmp_path / "bitmap.jpg").write_bytes(bmp_bytes(rgb, 24))
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "bitmap.jpg")),
                                  rgb)
    image_io.save_image(str(tmp_path / "saved.jpg"), rgb / 255.0)
    assert image_io.read_image(str(tmp_path / "saved.jpg")).shape == (24, 40, 3)
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="x.gif: not a PNG, JPEG or BMP"):
        image_io.read_image(str(tmp_path / "x.gif"))
