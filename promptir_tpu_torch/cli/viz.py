"""Visualization toolkit: training curves, per-image PSNR A/B, zoom-box
figures, window-grid overlays.

Counterpart of promptir_tpu/cli/viz.py, with the same four commands and
flags. Images are read through the port's own codecs (PNG, JPEG, BMP;
utils/image_io.py) and written as PNG (utils/png.py), whatever the
extension of `--out`; boxes, lines and the inset are drawn with numpy, so
no PIL is needed:

- ``curves``   — plot metric curves from one or more training runs'
  ``metrics.jsonl`` streams (matplotlib, imported only by this command).
- ``compare``  — A/B two per-image PSNR JSON dumps (as ``cli/test.py
  --json`` writes them): summary deltas plus the biggest wins/regressions.
- ``zoombox``  — crop a box, enlarge it by an integer scale, paste it
  bottom-right, draw a red box around the source and a green box around the
  inset (the reference's crop_image.py:4-31). The enlargement is PIL's
  default bicubic ``resize`` computed as Pillow computes it (Resample.c:
  a = -0.5, coefficients in 22-bit fixed point, a horizontal pass rounded to
  uint8, then a vertical one), so the figure is the JAX CLI's pixel for
  pixel.
- ``windowgrid`` — overlay the 8px attention-window grid on an image,
  optionally after adding sigma-Gaussian noise.

Usage:
  python -m promptir_tpu_torch.cli.viz curves runA/metrics.jsonl runB/metrics.jsonl \
      --metric eval_rain100l_psnr --out curves.png
  python -m promptir_tpu_torch.cli.viz compare base.json ours.json --top 10
  python -m promptir_tpu_torch.cli.viz zoombox img.png --box 180 70 80 --out fig.png
  python -m promptir_tpu_torch.cli.viz windowgrid img.png --sigma 15 --out grid.png
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from promptir_tpu_torch.utils.image_io import read_image
from promptir_tpu_torch.utils.png import write_png

RED, GREEN, YELLOW = (255, 0, 0), (0, 255, 0), (255, 255, 0)
_PRECISION_BITS = 32 - 8 - 2  # Pillow's Resample.c


def _read_jsonl(path: str) -> List[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def cmd_curves(args) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(12, 6))
    plotted = 0
    for path in args.runs:
        records = _read_jsonl(path)
        label = args.labels.pop(0) if args.labels else (
            os.path.basename(os.path.dirname(path)) or path
        )
        xs = [r["step"] for r in records if args.metric in r]
        ys = [r[args.metric] for r in records if args.metric in r]
        if not xs:
            available = sorted({k for r in records for k in r} - {"step", "time"})
            print(f"{path}: no '{args.metric}' records; available: {available}")
            continue
        plt.plot(xs, ys, label=label, linewidth=2)
        plotted += 1
        print(f"{label}: {len(xs)} points, last {args.metric}={ys[-1]:.4f}")
    if not plotted:
        raise SystemExit("nothing to plot")
    plt.xlabel(args.xlabel)
    plt.ylabel(args.metric)
    plt.title(args.title)
    plt.legend()
    plt.grid(True)
    plt.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"wrote {args.out}")


def compare_psnr_dicts(base: Dict[str, float], ours: Dict[str, float]) -> dict:
    """Per-image A/B: mean PSNRs over the common keyset plus sorted deltas
    (the reference's compare_psnr.ipynb cells 3-8)."""
    common = sorted(set(base) & set(ours))
    deltas = {k: ours[k] - base[k] for k in common}
    result = {
        "n_common": len(common),
        "n_base_only": len(set(base) - set(ours)),
        "n_ours_only": len(set(ours) - set(base)),
        "mean_base": sum(base[k] for k in common) / max(len(common), 1),
        "mean_ours": sum(ours[k] for k in common) / max(len(common), 1),
        "deltas": dict(sorted(deltas.items(), key=lambda kv: -kv[1])),
    }
    result["mean_delta"] = result["mean_ours"] - result["mean_base"]
    return result


def cmd_compare(args) -> None:
    with open(args.base) as f:
        base = json.load(f)
    with open(args.ours) as f:
        ours = json.load(f)
    r = compare_psnr_dicts(base, ours)
    print(
        f"common images: {r['n_common']} "
        f"(base-only {r['n_base_only']}, ours-only {r['n_ours_only']})"
    )
    print(f"mean PSNR  base: {r['mean_base']:.4f}  ours: {r['mean_ours']:.4f}  "
          f"delta: {r['mean_delta']:+.4f} dB")
    items = list(r["deltas"].items())
    if items:
        print(f"top {min(args.top, len(items))} improvements:")
        for k, d in items[: args.top]:
            print(f"  {k}: {d:+.3f} dB")
        print(f"top {min(args.top, len(items))} regressions:")
        for k, d in items[-args.top :][::-1]:
            print(f"  {k}: {d:+.3f} dB")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
        print(f"wrote {args.out}")


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bicubic
    filter: per output index, the first input index and the fixed-point
    weights of its taps."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        ww = sum(k)
        k = [w / ww if ww != 0.0 else w for w in k]
        fixed = [int(w * (1 << _PRECISION_BITS) + (-0.5 if w < 0 else 0.5))
                 for w in k]
        rows.append((xmin, np.asarray(fixed, np.int64)))
    return rows


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's 8-bit resampling passes along `axis` of uint8 HWC
    `img`: the fixed-point sum, rounded and clipped to uint8."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    out = np.empty((out_size,) + src.shape[1:], np.uint8)
    for i, (xmin, k) in enumerate(_resample_coeffs(src.shape[0], out_size)):
        ss = np.tensordot(k, src[xmin:xmin + k.size], axes=(0, 0))
        ss += 1 << (_PRECISION_BITS - 1)
        out[i] = np.clip(ss >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC uint8 `img` resized as PIL's `Image.resize((out_w, out_h))`
    (BICUBIC) resizes an RGB image: horizontal pass first, each pass only
    where the size changes."""
    if out_w != img.shape[1]:
        img = _resample_axis(img, out_w, 1)
    if out_h != img.shape[0]:
        img = _resample_axis(img, out_h, 0)
    return img


def _rectangle(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color, width: int) -> None:
    """ImageDraw.rectangle's outline of `width` pixels inside the box
    [x0, x1] x [y0, y1], clipped to the image. As Pillow's Draw.c draws it:
    rows y0 + i and y1 - i, and columns x1 - i and x0 + i from y0 + width
    towards y1 - width + 1, that end left out (so a box narrower than the
    outline grows sideways)."""
    h, w = img.shape[:2]

    def fill(ya, yb, xa, xb):
        ya, yb = max(ya, 0), min(yb, h - 1)
        xa, xb = max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color

    a, b = y0 + width, y1 - width + 1
    side = (a, b - 1) if a < b else (b + 1, a)
    for i in range(width):
        fill(y0 + i, y0 + i, x0, x1)
        fill(y1 - i, y1 - i, x0, x1)
        if a != b:
            fill(*side, x1 - i, x1 - i)
            fill(*side, x0 + i, x0 + i)


def _crop(img: np.ndarray, x: int, y: int, size: int) -> np.ndarray:
    """The size x size box at (x, y), zeros where it leaves the image (as
    PIL's crop)."""
    h, w = img.shape[:2]
    out = np.zeros((size, size) + img.shape[2:], img.dtype)
    ya, yb, xa, xb = max(y, 0), min(y + size, h), max(x, 0), min(x + size, w)
    if ya < yb and xa < xb:
        out[ya - y:yb - y, xa - x:xb - x] = img[ya:yb, xa:xb]
    return out


def zoombox(img: np.ndarray, x: int, y: int, size: int, scale: int = 2,
            box_width: int = 2) -> np.ndarray:
    """Crop (x, y, size) of HWC uint8 RGB `img`, enlarge it by `scale`,
    paste it at the bottom-right, a red box on the source area and a green
    box on the inset (crop_image.py:10-27). Returns a new array."""
    img = np.array(img[..., :3], np.uint8)
    n = size * scale
    inset = resize_bicubic(_crop(img, x, y, size), n, n)
    h, w = img.shape[:2]
    sx, sy = w - n, h - n
    ox, oy = max(-sx, 0), max(-sy, 0)
    img[sy + oy:, sx + ox:] = inset[oy:, ox:]
    _rectangle(img, x, y, x + size - 1, y + size - 1, RED, box_width)
    _rectangle(img, sx, sy, w - 1, h - 1, GREEN, box_width)
    return img


def cmd_zoombox(args) -> None:
    x, y, size = args.box
    write_png(args.out, zoombox(read_image(args.image), x, y, size,
                                scale=args.scale))
    print(f"wrote {args.out}")


def window_grid(img: np.ndarray, window: int = 8, sigma: float = 0.0,
                seed: int = 0) -> np.ndarray:
    """Overlay the attention-window grid on HWC uint8 RGB `img`; optional
    uint8-domain noise first (apply_window_grid.ipynb cells 2-3)."""
    arr = np.asarray(img[..., :3]).astype(np.float64)
    if sigma > 0:
        rng = np.random.default_rng(seed)
        arr = arr + rng.normal(0.0, sigma, arr.shape)
    out = np.clip(arr, 0, 255).astype(np.uint8)
    out[:, ::window] = YELLOW
    out[::window, :] = YELLOW
    return out


def cmd_windowgrid(args) -> None:
    out = window_grid(read_image(args.image), window=args.window,
                      sigma=args.sigma, seed=args.seed)
    write_png(args.out, out)
    print(f"wrote {args.out}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="promptir_tpu_torch.cli.viz",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("curves", help="plot metric curves from metrics.jsonl runs")
    c.add_argument("runs", nargs="+", help="metrics.jsonl paths")
    c.add_argument("--metric", default="train_loss")
    c.add_argument("--labels", nargs="*", default=[])
    c.add_argument("--xlabel", default="step")
    c.add_argument("--title", default="Training Curve Comparison")
    c.add_argument("--out", default="curves.png")
    c.set_defaults(fn=cmd_curves)

    c = sub.add_parser("compare", help="A/B two per-image PSNR JSON dumps")
    c.add_argument("base")
    c.add_argument("ours")
    c.add_argument("--top", type=int, default=10)
    c.add_argument("--out", default=None, help="write full comparison JSON")
    c.set_defaults(fn=cmd_compare)

    c = sub.add_parser("zoombox", help="zoom-box detail figure")
    c.add_argument("image")
    c.add_argument("--box", nargs=3, type=int, required=True, metavar=("X", "Y", "SIZE"))
    c.add_argument("--scale", type=int, default=2)
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_zoombox)

    c = sub.add_parser("windowgrid", help="overlay attention-window grid")
    c.add_argument("image")
    c.add_argument("--window", type=int, default=8)
    c.add_argument("--sigma", type=float, default=0.0)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_windowgrid)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
