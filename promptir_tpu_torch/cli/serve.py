"""Serving CLI: an HTTP inference server with dynamic batching.

Counterpart of promptir_tpu/cli/serve.py. Concurrent clients POST images;
the engine (serve/engine.py) groups them into batches of one padded size
on its worker thread, the only one that touches the card.

Endpoints:
  POST /restore       PNG, JPEG or BMP bytes -> restored PNG (anything
                      else: 400 with the decoder's message;
                      utils/image_io.py:decode_image)
  GET  /healthz       JSON: model, backend, device count, max batch, pad
                      base, dtype, status
  GET  /stats         JSON: the engine's request/batch counters, latency
                      and compiled_shapes

The engine's overload, timeout and shutdown errors answer 429, 504 and
503, any other failure of the forward 500. --model takes every ported
model (cli/test.py). Runs on the card unless --device cpu.

  python -m promptir_tpu_torch.cli.serve --model promptir \
      --ckpt_name model.ckpt --port 8000 --max_batch 8 --warmup 512x512
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from promptir_tpu_torch.cli.test import add_model_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="promptir_tpu_torch inference server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8,
                   help="fixed device batch; short groups are zero-padded")
    p.add_argument("--batch_timeout_ms", type=float, default=5.0)
    p.add_argument("--pad_base", type=int, default=None,
                   help="pad inputs to multiples of this; default = the "
                        "model's pad base (8 for PromptIR and the "
                        "attention-free family, 64 for the X-Restormer "
                        "family)")
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--warmup", nargs="*", default=[],
                   help="HxW sizes to run once before serving, e.g. 512x512")
    p.add_argument("--tile_threshold_px", type=int, default=None,
                   help="images padded beyond this many pixels are served "
                        "through overlap-blend tiling")
    p.add_argument("--tile_size", type=int, default=128)
    p.add_argument("--tile_overlap", type=int, default=32)
    p.add_argument("--tile_chunk", type=int, default=8)
    p.add_argument("--max_queue", type=int, default=256,
                   help="in-flight request bound; submits beyond it are "
                        "rejected with HTTP 429")
    p.add_argument("--request_timeout_s", type=float, default=None,
                   help="fail (504) requests that wait longer than this "
                        "before the worker can take them")
    add_model_args(p, dtype="bfloat16")
    return p


def build_engine(args):
    """(engine, info): separate from main() so that tests and applications
    can run the server in-process."""
    import numpy as np
    import torch

    from promptir_tpu_torch.cli.test import build_model
    from promptir_tpu_torch.serve.engine import InferenceEngine

    model = build_model(args)
    engine = InferenceEngine(
        model,
        pad_base=args.pad_base,
        max_batch=args.max_batch,
        batch_timeout_ms=args.batch_timeout_ms,
        tile_threshold_px=args.tile_threshold_px,
        tile_size=args.tile_size,
        tile_overlap=args.tile_overlap,
        tile_chunk=args.tile_chunk,
        max_queue=args.max_queue,
        request_timeout_s=args.request_timeout_s,
    )
    device = engine.device
    info = {
        "model": args.model,
        "backend": device.type,
        "device_count": (torch.cuda.device_count() if device.type == "cuda"
                         else 1),
        "max_batch": args.max_batch,
        "pad_base": args.pad_base,
        "dtype": args.dtype,
    }
    for size in args.warmup:
        h, w = (int(v) for v in size.lower().split("x"))
        engine.restore(np.zeros((h, w, 3), np.float32))
        print(f"warmed up {h}x{w}")
    return engine, info


class _Handler(BaseHTTPRequestHandler):
    engine = None
    info = None

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def log_message(self, fmt, *fa):  # quiet; the stats endpoint instead
        pass

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, dict(self.info, status="ok"))
        elif self.path == "/stats":
            self._json(200, self.engine.stats())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/restore":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        import numpy as np

        from promptir_tpu_torch.serve.engine import (
            EngineClosed,
            EngineOverloaded,
            RequestTimeout,
        )
        from promptir_tpu_torch.utils.image_io import decode_image
        from promptir_tpu_torch.utils.png import encode_png

        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n)
        try:
            img = decode_image(raw, name="request body").astype(np.float32) / 255.0
        except ValueError as e:
            self._json(400, {"error": f"cannot decode image: {e}"})
            return
        try:
            out = self.engine.restore(img)
        except EngineOverloaded as e:
            self._json(429, {"error": str(e)})
            return
        except RequestTimeout as e:
            self._json(504, {"error": str(e)})
            return
        except EngineClosed as e:
            self._json(503, {"error": str(e)})
            return
        except Exception as e:  # the server keeps serving; the client sees it
            self._json(500, {"error": str(e)})
            return
        # rounded, as the JAX server does, where save_image truncates
        body = encode_png((np.clip(out, 0.0, 1.0) * 255.0).round()
                          .astype(np.uint8))
        self._send(200, body, "image/png")


def make_server(args):
    """(httpd, engine) ready for serve_forever(); port 0 -> ephemeral."""
    if args.pad_base is None:
        from promptir_tpu_torch.eval.padding import pad_bases

        args.pad_base = pad_bases(args.model)[0]
    engine, info = build_engine(args)
    handler = type("Handler", (_Handler,), {"engine": engine, "info": info})
    httpd = ThreadingHTTPServer((args.host, args.port), handler)
    return httpd, engine


def main(argv=None):
    args = build_parser().parse_args(argv)
    httpd, engine = make_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving {args.model} on http://{host}:{port} "
          f"(max_batch={args.max_batch}, pad_base={args.pad_base}, "
          f"device={args.device})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close()


if __name__ == "__main__":
    main()
