"""PNG read and write without PIL.

The port's own codec: the machine with the card has no PIL. Its scope is
that of the JAX package's native reader (native/png_decode.cpp,
promptir_tpu/data/native.py:decode_png_rgb): 8-bit gray, gray+alpha,
palette, RGB and RGBA, non-interlaced, with all five row filters. Every
image reads back as HWC uint8 RGB, as PIL's `convert("RGB")` gives it: gray
is replicated, a palette index looked up (an index past the PLTE reads as
0), alpha dropped. Anything else (16-bit or sub-byte samples, Adam7
interlacing, a file that is not PNG) raises a ValueError that names the
file and what it does not support. JPEG and BMP have readers of their own
(utils/jpeg.py, utils/bmp.py); utils/image_io.py:read_image picks one by
the file's magic bytes.

`decode_png` reads through the port's C++ reader (data/native.py,
promptir_tpu_torch/native/png_decode.cpp: inflate, unfilter and RGB
expansion with the GIL released), as the JAX package's `load_image_rgb` reads every PNG.
`decode_png_plain` is its plain version, in the standard library's zlib and
numpy: the reader's reference in the tests, giving the same pixels and the
same errors; nothing on the loader's path calls it.

The writer emits RGB at 8 bits with filter 0 (none) on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from promptir_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (name, samples a pixel)
COLOR_TYPES = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1),
               4: ("gray+alpha", 2), 6: ("RGBA", 4)}
MAX_SIDE = 1 << 20  # as the native reader: reject absurd headers early


def _kind(data: bytes) -> str:
    """What a non-PNG file looks like, for the error message."""
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:2] == b"BM":
        return "BMP"
    return "not PNG"


def _chunks(data: bytes, name: str):
    """(type, payload) of each chunk up to IEND."""
    off = len(SIGNATURE)
    while off + 12 <= len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        kind = data[off + 4:off + 8]
        if off + 12 + n > len(data):
            break
        yield kind, data[off + 8:off + 8 + n]
        if kind == b"IEND":
            return
        off += 12 + n
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _unfilter_diagonal(rows: np.ndarray, filters: np.ndarray,
                       bpp: int) -> np.ndarray:
    """Undo any mix of the five filters on (h, w, bpp) uint8 samples, one
    anti-diagonal of pixels at a time: pixel (y, x) depends on (y, x-1),
    (y-1, x) and (y-1, x-1) only, so every pixel with y + x = d follows
    from the two diagonals before it. The image is held sheared (pixel
    (y, x) at column y + x, behind a zero row and column) so that each
    diagonal is a column slice: h + w - 1 vectorised steps in all, where a
    loop along the rows takes h * w * bpp."""
    h, w, _ = rows.shape
    yy, xx = np.mgrid[0:h, 0:w]
    raw = np.zeros((h, h + w, bpp), np.uint8)
    raw[yy, yy + xx] = rows
    # column h + w is never written: the up-left of diagonal 0 reads it as 0
    out = np.zeros((h + 1, h + w + 1, bpp), np.int16)
    f = filters.astype(np.intp)[:, None]
    zero = np.zeros((min(h, w), bpp), np.int16)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = out[y0 + 1:y1 + 1, d]      # left
        b = out[y0:y1, d]              # up
        c = out[y0:y1, d - 1]          # up-left
        bc, ac = b - c, a - c          # Paeth: p - a, p - b for p = a + b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(f[y0:y1], [zero[:y1 - y0], a, b, (a + b) >> 1, paeth])
        pred += raw[y0:y1, d]
        pred &= 0xFF
        out[y0 + 1:y1 + 1, d + 1] = pred
    return out[1:, 1:][yy, yy + xx].astype(np.uint8)


def _unfilter(raw: bytes, h: int, w: int, bpp: int,
              name: str) -> np.ndarray:
    """Undo the row filters of `h` rows of [filter byte | w * bpp bytes]:
    (h, w, bpp) uint8. Images with None, Sub and Up rows only (what the
    writer emits) go row by row, each row vectorised (Sub a running sum mod
    256, Up a sum); Average and Paeth depend on the pixel to the left, so
    an image with either goes along the diagonals."""
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{name}: PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    filters, data = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if filters.max() > 4:
        raise ValueError(f"{name}: unknown PNG row filter {filters.max()}")
    if filters.max() > 2:
        return _unfilter_diagonal(data, filters, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    prev = np.zeros((w, bpp), np.uint8)
    for y in range(h):
        f, cur = filters[y], data[y]
        if f == 0:
            out[y] = cur
        elif f == 1:  # Sub: a running sum of each sample mod 256
            out[y] = np.cumsum(cur, axis=0, dtype=np.uint8)
        else:  # Up
            out[y] = cur + prev
        prev = out[y]
    return out


def _check_signature(data: bytes, name: str) -> None:
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{name}: {_kind(data)} is not supported by the PNG "
                         "reader (image_io.read_image reads JPEG and BMP)")


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes to HWC uint8 RGB through the C++ reader. `name`
    goes into the errors."""
    _check_signature(data, name)
    return native.decode_png_rgb(bytes(data), name)


def decode_png_plain(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_png` in Python: the same pixels and the same errors."""
    _check_signature(data, name)
    ihdr, plte, idat = None, None, []
    for kind, payload in _chunks(data, name):
        if kind == b"IHDR":
            ihdr = payload
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if ihdr is None or len(ihdr) != 13 or not idat:
        raise ValueError(f"{name}: PNG without a header or image data")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if ctype not in COLOR_TYPES:
        raise ValueError(f"{name}: unknown PNG color type {ctype}")
    kind, bpp = COLOR_TYPES[ctype]
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit {kind} PNG is not supported "
                         "(8-bit samples only)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE):
        raise ValueError(f"{name}: PNG size {w}x{h} out of range")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data: {e}") from None
    px = _unfilter(raw, h, w, bpp, name)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)  # PIL reads a missing entry as 0
        pal = np.frombuffer(plte, np.uint8)[:len(plte) // 3 * 3].reshape(-1, 3)
        table[:len(pal)] = pal[:256]
        return table[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path: str) -> np.ndarray:
    """The PNG file at `path` as HWC uint8 RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read(), name=str(path))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """HWC uint8 RGB to PNG bytes: 8-bit RGB, filter 0 on every row."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes HWC uint8 RGB, got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write HWC uint8 RGB to `path` as PNG."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
