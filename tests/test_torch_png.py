"""The port's PNG codec (promptir_tpu_torch/utils/png.py) against PIL.

PIL is imported here only, as the reference: the port reads and writes PNG
without it. Reading must equal `PIL.Image.open(...).convert("RGB")` bit for
bit on the five color types (RGB, gray, gray+alpha, palette, RGBA) and the
five row filters; the writer must read back through PIL bit for bit; what
the codec does not read (JPEG, 16-bit, interlaced) raises a ValueError
naming the file.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from promptir_tpu_torch.utils import png


def bands(h=96, w=80, seed=0):
    """An image whose rows take, under PIL's optimizing encoder, each of
    the five filters: uniform noise (None), ramps (Sub, Up), gaussian noise
    (Average), smooth shading (Paeth)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.zeros((h, w, 3))
    img[:16] = rng.integers(0, 256, (16, w, 3))
    img[16:32] = (xx * 3)[16:32, :, None]
    img[32:48] = 128 + rng.normal(0, 12, (16, w, 3))
    img[48:64] = (yy * 5)[48:64, :, None]
    img[64:80] = 100 + 40 * (np.sin(xx / 5) * np.cos(yy / 4))[64:80, :, None]
    img[80:] = (xx + yy)[80:, :, None] * 2 + rng.normal(0, 12, (16, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def row_filters(data):
    """The filter type of every row of a PNG, read from its raw stream."""
    off, idat = 8, b""
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        kind, payload = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", payload[:8])
            bpp = png.COLOR_TYPES[payload[9]][1]
        elif kind == b"IDAT":
            idat += payload
        off += 12 + n
    raw = zlib.decompress(idat)
    return set(raw[::w * bpp + 1][:h])


def pil_png(im, **kw):
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def as_mode(rgb, mode, seed=1):
    im = Image.fromarray(rgb)
    if mode == "P":
        return im.convert("P", palette=Image.ADAPTIVE, colors=200)
    if mode == "RGBA":
        alpha = np.random.default_rng(seed).integers(0, 256, rgb.shape[:2],
                                                     dtype=np.uint8)
        im = im.convert("RGBA")
        im.putalpha(Image.fromarray(alpha))
        return im
    return im.convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "P", "RGBA"])
def test_reads_what_pil_writes(mode, tmp_path):
    data = pil_png(as_mode(bands(), mode), optimize=True)
    path = tmp_path / f"{mode}.png"
    path.write_bytes(data)
    ref = np.asarray(Image.open(path).convert("RGB"))
    out = png.read_png(str(path))
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_photo_like_rgb_uses_all_five_filters():
    data = pil_png(Image.fromarray(bands()), optimize=True)
    assert row_filters(data) == {0, 1, 2, 3, 4}
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode_png(data), ref)


def filter_row(cur, prev, bpp, f):
    """PNG filter `f` of one row (the encoder's side, per the spec)."""
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def hand_png(img, f, ctype=2, interlace=0):
    """A PNG of `img` with filter `f` on every row (or `f[y]` on row y),
    built through zlib (with `interlace`, only the header says Adam7: PIL
    writes no interlaced PNG)."""
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    bpp = rows.shape[1] // w
    fs = [f] * h if isinstance(f, int) else [int(x) for x in f]
    raw, prev = b"", bytes(rows.shape[1])
    for r, fy in zip(rows, fs):
        raw += bytes([fy]) + filter_row(r.tobytes(), prev, bpp, fy)
        prev = r.tobytes()

    def chunk(kind, payload):
        crc = zlib.crc32(kind + payload)
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("f", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [2, 6])
def test_each_filter_on_every_row(f, ctype):
    rng = np.random.default_rng(10 * f + ctype)
    img = rng.integers(0, 256, (13, 17, 3 if ctype == 2 else 4), dtype=np.uint8)
    data = hand_png(img, f, ctype)
    np.testing.assert_array_equal(png.decode_png(data), img[..., :3])
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img[..., :3])


@pytest.mark.parametrize("hw", [(1, 9), (9, 1), (23, 5), (6, 31)])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_mixed_filters_row_by_row(hw, ctype):
    """Every filter in random order down the rows, each color type: the
    decoder undoes Average and Paeth along the image's diagonals, so a row
    of one filter must not upset the rows around it."""
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(hw[0] * 100 + hw[1] + ctype)
    img = rng.integers(0, 256, (*hw, bpp), dtype=np.uint8)
    filters = rng.integers(0, 5, hw[0])
    filters[: min(5, hw[0])] = [3, 4, 0, 1, 2][: min(5, hw[0])]
    data = hand_png(img, filters, ctype)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode_png(data), ref)


def test_pil_written_test_set_sized_image():
    """A 481x321 (BSD68-sized) image as PIL's optimizing encoder writes it,
    Average and Paeth rows among the rest, reads as PIL reads it."""
    img = np.ascontiguousarray(np.tile(bands(96, 481), (4, 1, 1))[:321])
    data = pil_png(Image.fromarray(img), optimize=True)
    assert {3, 4} & row_filters(data)
    np.testing.assert_array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("hw", [(1, 1), (7, 3), (96, 80)])
def test_writer_reads_back_through_pil(hw, tmp_path):
    img = bands()[:hw[0], :hw[1]]
    path = tmp_path / "w.png"
    png.write_png(str(path), img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


def test_writer_rejects_what_is_not_hwc_uint8_rgb():
    with pytest.raises(ValueError, match="HWC uint8 RGB"):
        png.encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="HWC uint8 RGB"):
        png.encode_png(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("kind,match", [
    ("jpeg", "JPEG is not supported"),
    ("bmp", "BMP is not supported"),
    ("16bit", "16-bit gray PNG is not supported"),
    ("interlaced", "interlaced"),
])
def test_unsupported_files_raise_naming_the_file(kind, match, tmp_path):
    rgb = bands()[:16, :16]
    path = tmp_path / f"bad_{kind}.img"
    if kind == "jpeg":
        Image.fromarray(rgb).save(path, format="JPEG")
    elif kind == "bmp":
        Image.fromarray(rgb).save(path, format="BMP")
    elif kind == "16bit":
        Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(
            path, format="PNG")
    else:
        path.write_bytes(hand_png(rgb, 0, interlace=1))
    with pytest.raises(ValueError, match=match) as e:
        png.read_png(str(path))
    assert str(path) in str(e.value)


def test_truncated_and_corrupt_data_raise():
    data = png.encode_png(bands()[:8, :8])
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(data[:-20], name="t.png")
    bad = bytearray(data)
    i = data.index(b"IDAT") + 4
    bad[i:i + 8] = b"\x00" * 8
    with pytest.raises(ValueError, match="corrupt"):
        png.decode_png(bytes(bad), name="c.png")
