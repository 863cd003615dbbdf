"""Dynamic-batching inference engine on the card.

Counterpart of promptir_tpu/serve/engine.py. Concurrent callers submit HWC
float images of any size; one worker thread, the only one that touches the
device, groups requests of the same padded (H, W) bucket into a batch of
exactly `max_batch` (short groups are zero-padded) and runs one forward per
group:
  * each image is reflect-padded to a multiple of `pad_base` (the reference
    demo's semantics) and its reply cropped back to its own size;
  * `submit` sheds load with `EngineOverloaded` once `max_queue` requests are
    in flight; a request that waited longer than `request_timeout_s` before
    the worker took it fails with `RequestTimeout`;
  * the output is clipped to [0, 1];
  * a float32 model runs with TF32 off (precision.py);
  * `close()` stops taking requests, lets the worker finish what it holds,
    joins it with a time limit and fails whatever it never reached. The
    worker is a daemon thread, so a wedged forward cannot keep the process
    alive.
  * with `tile_threshold_px`, a request whose padded area is above it runs
    alone through the overlap-blend tiler (eval/tiling.py) at `tile_size`,
    `tile_overlap` and `tile_chunk`: the model then sees one fixed tile
    batch whatever the image's size. The tiler clips once after blending,
    so the engine's own clip is skipped for it; `stats()` counts
    `tiled_requests`.
  * `stats()` reports each request's queue wait, from its submit to the
    start of its batch, as `mean_queue_wait_s` and `max_queue_wait_s`.

While a torch.profiler session runs, the engine records spans
(utils/tracing.py): `engine.request` from a request's submit to its
result (its id), and on the worker `engine.collect` (the wait for a head
and the batch timeout), `engine.batch` (the batch call: its request ids,
bucket and fill) holding `engine.pad`, `engine.h2d`, `engine.model` and
`engine.d2h` (the copy out, with its wait for the card), then
`engine.resolve` (the counters, crops and results). The first batch of a
new bucket runs inside a `setup.first_call` span, recorded always.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from promptir_tpu_torch.eval.padding import target_size
from promptir_tpu_torch.eval.tiling import tiled_inference
from promptir_tpu_torch.precision import compute_dtype, exact_float32
from promptir_tpu_torch.utils import tracing


class EngineOverloaded(RuntimeError):
    """submit() found `max_queue` requests in flight: shed or retry later."""


class EngineClosed(RuntimeError):
    """Set on requests still queued when the engine shuts down."""


class RequestTimeout(TimeoutError):
    """Set on a request that waited longer than request_timeout_s."""


def pad_image_np(img: np.ndarray, base: int) -> np.ndarray:
    """Reflect-pad HWC to multiples of `base` (edge padding where a side is
    too short to reflect); the padding is cropped off the reply."""
    h, w = img.shape[:2]
    th, tw = target_size(h, w, base)
    if (th, tw) == (h, w):
        return img
    mode = "reflect" if (th - h) < h and (tw - w) < w else "edge"
    return np.pad(img, ((0, th - h), (0, tw - w), (0, 0)), mode=mode)


_request_ids = itertools.count()


class _Request:
    __slots__ = ("id", "img", "future", "t_submit", "t_batch", "shape")

    def __init__(self, img: np.ndarray):
        self.id = next(_request_ids)
        self.img = img
        self.future: Future = Future()
        self.t_submit = tracing.now_ns()  # the profiler's clock, ns
        self.t_batch = None  # set when its batch starts
        self.shape = img.shape


_NO_SPAN = contextlib.nullcontext()


class InferenceEngine:
    """Serves `model` (an NCHW module, e.g. from `create_model`) on the
    device of its parameters."""

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        pad_base: int = 8,
        max_batch: int = 4,
        batch_timeout_ms: float = 5.0,
        clip: bool = True,
        channels: int = 3,
        max_queue: int = 256,
        request_timeout_s: Optional[float] = None,
        tile_threshold_px: Optional[int] = None,
        tile_size: int = 128,
        tile_overlap: int = 32,
        tile_chunk: int = 8,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.compute_dtype = compute_dtype(model)
        self.channels = int(channels)
        self.pad_base = int(pad_base)
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.clip = clip
        self.max_queue = int(max_queue)
        self.request_timeout_s = request_timeout_s
        self.tile_threshold_px = tile_threshold_px
        self.tile_size = int(tile_size)
        self.tile_overlap = int(tile_overlap)
        self.tile_chunk = int(tile_chunk)

        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._lock = threading.Lock()
        self._inflight = 0  # submitted, not yet resolved
        self._stats: Dict[str, float] = {
            "requests": 0,
            "batches": 0,
            "tiled_requests": 0,
            "rejected": 0,
            "timed_out": 0,
            "batch_fill_sum": 0.0,
            "latency_sum_s": 0.0,
            "latency_max_s": 0.0,
            "queue_wait_sum_s": 0.0,
            "queue_wait_max_s": 0.0,
        }
        self._buckets: set = set()
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="promptir-serve-worker", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- API

    def submit(self, img_hwc: np.ndarray) -> Future:
        """Enqueue one HWC float [0, 1] image; the future resolves to the
        restored HWC float32 image of the same size.

        Raises EngineClosed after close() and EngineOverloaded when
        `max_queue` requests are in flight."""
        img = np.asarray(img_hwc, dtype=np.float32)
        if img.ndim != 3 or img.shape[2] != self.channels:
            raise ValueError(
                f"expected HW{self.channels} image, got shape {img.shape}"
            )
        req = _Request(img)
        # the closed check and the put happen under the lock close() takes
        # before it posts the sentinel, so no request lands behind it
        with self._lock:
            if self._closed:
                raise EngineClosed("engine is closed")
            if self._inflight >= self.max_queue:
                self._stats["rejected"] += 1
                raise EngineOverloaded(
                    f"{self._inflight} requests in flight (max_queue="
                    f"{self.max_queue}); retry with backoff"
                )
            self._inflight += 1
            self._q.put(req)
        return req.future

    def restore(self, img_hwc: np.ndarray) -> np.ndarray:
        return self.submit(img_hwc).result()

    def restore_many(self, imgs: Sequence[np.ndarray]) -> list:
        futs = [self.submit(im) for im in imgs]
        return [f.result() for f in futs]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            s = dict(self._stats)
            inflight = self._inflight
            buckets = len(self._buckets)
        n = max(1, int(s["requests"]))
        b = max(1, int(s["batches"]))
        return {
            "requests": int(s["requests"]),
            "batches": int(s["batches"]),
            "tiled_requests": int(s["tiled_requests"]),
            "rejected": int(s["rejected"]),
            "timed_out": int(s["timed_out"]),
            "mean_batch_fill": s["batch_fill_sum"] / b,
            "mean_latency_s": s["latency_sum_s"] / n,
            "max_latency_s": s["latency_max_s"],
            "mean_queue_wait_s": s["queue_wait_sum_s"] / n,
            "max_queue_wait_s": s["queue_wait_max_s"],
            # the JAX engine's key: the padded shapes run so far
            "compiled_shapes": buckets,
            "queue_depth": self._q.qsize() + len(self._pending),
            "inflight": inflight,
        }

    def close(self, join_timeout_s: float = 60.0) -> None:
        """Stop taking requests, drain, and join the worker (bounded)."""
        with self._lock:
            first = not self._closed
            if first:
                self._closed = True
                self._q.put(None)
        self._worker.join(timeout=join_timeout_s)
        if first:
            # fails what the worker never reached (its join timed out)
            self._drain_failed(EngineClosed("engine closed before request ran"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- worker

    def _drain_failed(self, exc: Exception) -> None:
        """Resolve every queued or parked request with `exc`."""
        leftovers = list(self._pending)
        self._pending.clear()
        saw_sentinel = False
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is None:
                saw_sentinel = True
            else:
                leftovers.append(r)
        if saw_sentinel:
            # a worker wedged in a forward still needs it to exit
            self._q.put(None)
        for r in leftovers:
            self._resolve_exc(r, exc)

    def _resolve_exc(self, req: _Request, exc: Exception) -> None:
        with self._lock:
            self._inflight -= 1
        f = req.future
        if f.running() or f.set_running_or_notify_cancel():
            tracing.record("engine.request", req.t_submit, tracing.now_ns(),
                           request=req.id)
            f.set_exception(exc)

    def _bucket(self, req: _Request) -> Tuple[int, int]:
        h, w = req.shape[:2]
        return target_size(h, w, self.pad_base)

    def _is_tiled(self, req: _Request) -> bool:
        if self.tile_threshold_px is None:
            return False
        th, tw = self._bucket(req)
        return th * tw > self.tile_threshold_px

    def _expire(self, req: _Request) -> bool:
        """Fail and drop a request that waited past request_timeout_s."""
        if self.request_timeout_s is None:
            return False
        waited = (tracing.now_ns() - req.t_submit) / 1e9
        if waited <= self.request_timeout_s:
            return False
        with self._lock:
            self._stats["timed_out"] += 1
        self._resolve_exc(
            req,
            RequestTimeout(
                f"request queued {waited:.2f}s > "
                f"request_timeout_s={self.request_timeout_s}"
            ),
        )
        return True

    def _collect_group(self) -> Optional[list]:
        """Block for the oldest request, then gather up to max_batch requests
        of its bucket within the batch timeout; None on shutdown."""
        head = None
        while head is None:
            if self._pending:
                head = self._pending.popleft()
            else:
                head = self._q.get()
                if head is None:
                    return None
            if self._expire(head):
                head = None
        if self._is_tiled(head):
            # an oversized image runs alone through the tiler; a request in
            # the bucket of a head that is not oversized is not either
            return [head]
        key = self._bucket(head)
        group = [head]
        for r in list(self._pending):
            if len(group) >= self.max_batch:
                break
            if self._expire(r):
                self._pending.remove(r)
            elif self._bucket(r) == key:
                self._pending.remove(r)
                group.append(r)
        deadline = time.perf_counter() + self.batch_timeout_s
        stash = []
        while len(group) < self.max_batch:
            wait = deadline - time.perf_counter()
            if wait <= 0:
                break
            try:
                r = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if r is None:
                self._q.put(None)  # re-post the sentinel for shutdown
                break
            if self._expire(r):
                continue
            if self._bucket(r) == key:
                group.append(r)
            else:
                stash.append(r)
        self._pending.extend(stash)
        return group

    def _tiled(self, req: _Request) -> np.ndarray:
        req.t_batch = tracing.now_ns()
        with exact_float32(self.compute_dtype):
            y = tiled_inference(self.model, torch.from_numpy(req.img[None]),
                                tile=self.tile_size, overlap=self.tile_overlap,
                                chunk=self.tile_chunk, bucket=self.pad_base)
            return y.cpu().numpy()

    def _forward(self, group: list) -> np.ndarray:
        th, tw = self._bucket(group[0])
        with tracing.span("engine.batch", requests=[r.id for r in group],
                          bucket=(th, tw), fill=len(group)) as batch:
            # the queue waits end where the span starts
            t_batch = tracing.now_ns() if batch is None else batch.t0
            for r in group:
                r.t_batch = t_batch
            with tracing.span("engine.pad"):
                xb = np.zeros((self.max_batch, th, tw, self.channels),
                              np.float32)
                for i, r in enumerate(group):
                    xb[i] = pad_image_np(r.img, self.pad_base)
            with tracing.span("engine.h2d"):
                x = torch.from_numpy(xb).to(self.device).permute(0, 3, 1, 2)
            with torch.inference_mode(), exact_float32(self.compute_dtype):
                with tracing.span("engine.model"):
                    y = self.model(x)
                    if self.clip:
                        y = y.clamp(0.0, 1.0)
                with tracing.span("engine.d2h"):
                    return y.permute(0, 2, 3, 1).float().cpu().numpy()

    def _run(self) -> None:
        while True:
            with tracing.span("engine.collect") as collecting:
                group = self._collect_group()
                if collecting is not None and group is not None:
                    collecting.attrs["size"] = len(group)
            if group is None:
                self._drain_failed(EngineClosed("engine closed before request ran"))
                break
            # claim each future first: a caller may have cancelled it
            claimed = []
            for r in group:
                if r.future.set_running_or_notify_cancel():
                    claimed.append(r)
                else:
                    with self._lock:
                        self._inflight -= 1
            group = claimed
            if not group:
                continue
            tiled = self._is_tiled(group[0])
            bucket = None if tiled else self._bucket(group[0])
            # the worker alone writes _buckets
            first = (tracing.setup_span("setup.first_call", bucket=bucket)
                     if bucket is not None and bucket not in self._buckets
                     else _NO_SPAN)
            try:
                with first:
                    y = self._tiled(group[0]) if tiled else self._forward(group)
            except Exception as e:  # the worker keeps serving; callers see it
                for r in group:
                    self._resolve_exc(r, e)
                continue
            with tracing.span("engine.resolve"):
                self._resolve(group, y, bucket)

    def _resolve(self, group: list, y: np.ndarray, bucket) -> None:
        """Count the batch (of `bucket`, None for a tiled request), then set
        each request's cropped result."""
        now = tracing.now_ns()
        with self._lock:
            if bucket is None:
                self._stats["tiled_requests"] += 1
            else:
                self._buckets.add(bucket)
            self._stats["batches"] += 1
            self._stats["batch_fill_sum"] += len(group)
            for r in group:
                lat = (now - r.t_submit) / 1e9
                wait = (r.t_batch - r.t_submit) / 1e9
                self._stats["requests"] += 1
                self._stats["latency_sum_s"] += lat
                self._stats["latency_max_s"] = max(
                    self._stats["latency_max_s"], lat
                )
                self._stats["queue_wait_sum_s"] += wait
                self._stats["queue_wait_max_s"] = max(
                    self._stats["queue_wait_max_s"], wait
                )
                self._inflight -= 1
        for i, r in enumerate(group):
            h, w = r.shape[:2]
            tracing.record("engine.request", r.t_submit, tracing.now_ns(),
                           request=r.id)
            r.future.set_result(y[i, :h, :w, :])
