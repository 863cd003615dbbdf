"""Write the JPEG fixtures and PIL's decode of each (decodes.npz).

    python tests/torch_fixtures/jpeg/make_fixtures.py

Run once with PIL; the files are committed, so that the machine with the
card, which has no PIL, can hold the port's decoder against PIL's decode
(chip_smoke.py phase 11) and the CPU tests can too. Small files cover the
chroma subsamplings PIL writes, gray, two qualities, restart markers and
sides that are multiples of neither 8 nor 16; one 550x413 haze pair in the
reference's dehaze layout (synthetic/<n>_<A>_<beta>.jpg, original/<n>.jpg)
is the dehaze task of phase 11's corpus.

decodes.npz holds, under each small file's name, PIL's decode
(`np.asarray(Image.open(p).convert("RGB"))`); for the haze pair, whose
decodes would take ~150 KB each compressed, the SHA-256 of the decode's
bytes under "sha256:<name>" and its shape under "shape:<name>".
"""

import hashlib
import io
import pathlib

import numpy as np
from PIL import Image

HERE = pathlib.Path(__file__).resolve().parent
HAZE_HW = (413, 550)  # SOTS outdoor's size


def scene(h, w, seed):
    """A smooth photograph-like scene (gradients, discs, a little texture)
    as HWC uint8: it compresses as photographs do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([180 * xx / w + 40, 160 * yy / h + 50,
                    120 + 60 * np.sin(xx / 23 + yy / 31)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(5, h / 3)
        col = rng.uniform(0, 255, 3)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        img[m] = 0.5 * img[m] + 0.5 * col
    img += (3 * np.sin(xx / 9.0) * np.cos(yy / 11.0))[..., None]
    return img.clip(0, 255).astype(np.uint8)


def variants():
    """(file name, HWC uint8 image, PIL save keywords)."""
    small = scene(37, 53, 1)
    return [
        ("444_q75.jpg", small, dict(quality=75, subsampling=0)),
        ("422_q95.jpg", small, dict(quality=95, subsampling=1)),
        ("420_q75.jpg", small, dict(quality=75, subsampling=2)),
        ("420_q95_restart.jpg", scene(45, 70, 2),
         dict(quality=95, subsampling=2, restart_marker_blocks=2)),
        ("gray_q75.jpg", scene(29, 41, 3)[..., 1], dict(quality=75)),
    ]


def haze_pair():
    clean = scene(*HAZE_HW, 4)
    t = np.linspace(0.5, 0.9, HAZE_HW[1])[None, :, None]
    hazy = (clean * t + 0.8 * 255 * (1 - t)).clip(0, 255).astype(np.uint8)
    return [("dehaze/synthetic/0001_0.8_0.2.jpg", hazy, dict(quality=75)),
            ("dehaze/original/0001.jpg", clean, dict(quality=75))]


def main():
    decodes = {}
    for rel, img, kw in variants() + haze_pair():
        path = HERE / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", **kw)
        path.write_bytes(buf.getvalue())
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        if rel.startswith("dehaze/"):
            decodes["sha256:" + rel] = np.array(
                hashlib.sha256(rgb.tobytes()).hexdigest())
            decodes["shape:" + rel] = np.array(rgb.shape)
        else:
            decodes[rel] = rgb
    np.savez_compressed(HERE / "decodes.npz", **decodes)


if __name__ == "__main__":
    main()
