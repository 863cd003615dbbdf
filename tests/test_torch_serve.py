"""The port's serving engine on device='cpu' at reduced depth."""

import sys
import threading
import time

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch

from promptir_tpu_torch import create_model
from promptir_tpu_torch.eval.tiling import tiled_inference
from promptir_tpu_torch.serve.engine import (
    EngineClosed,
    EngineOverloaded,
    InferenceEngine,
    RequestTimeout,
    pad_image_np,
)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return create_model("promptir", device="cpu", num_blocks=(1, 1, 1, 1),
                        num_refinement_blocks=1)


class Gated(torch.nn.Module):
    """Wraps a model; each forward waits until the test opens the gate."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.started = threading.Event()
        self.gate = threading.Event()

    def forward(self, x):
        self.started.set()
        assert self.gate.wait(timeout=30)
        return self.inner(x)


def img(seed, h, w):
    return np.random.default_rng(seed).uniform(size=(h, w, 3)).astype(np.float32)


def direct(model, im, base=8):
    x = torch.from_numpy(pad_image_np(im, base)[None]).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = model(x).clamp(0, 1).permute(0, 2, 3, 1).numpy()[0]
    return y[: im.shape[0], : im.shape[1]]


def test_odd_sizes_come_back_cropped_and_batched(model):
    imgs = [img(0, 21, 30), img(1, 24, 27), img(2, 17, 40), img(3, 30, 30)]
    with InferenceEngine(model, pad_base=8, max_batch=4,
                         batch_timeout_ms=200) as eng:
        outs = eng.restore_many(imgs)
        s = eng.stats()
    for im, out in zip(imgs, outs):
        assert out.shape == im.shape and out.dtype == np.float32
        assert 0.0 <= out.min() and out.max() <= 1.0
        np.testing.assert_allclose(out, direct(model, im), atol=1e-5)
    # buckets: 24x32 (first two), 24x40, 32x32
    assert (s["requests"] == 4 and s["compiled_shapes"] == 3
            and s["inflight"] == 0)


def test_overload_raises(model):
    gated = Gated(model)
    with InferenceEngine(gated, max_batch=1, batch_timeout_ms=0,
                         max_queue=2) as eng:
        f1 = eng.submit(img(0, 16, 16))
        assert gated.started.wait(timeout=30)
        f2 = eng.submit(img(1, 16, 16))
        with pytest.raises(EngineOverloaded):
            eng.submit(img(2, 16, 16))
        gated.gate.set()
        assert f1.result(timeout=30).shape == (16, 16, 3)
        assert f2.result(timeout=30).shape == (16, 16, 3)
        s = eng.stats()
    assert s["rejected"] == 1 and s["requests"] == 2 and s["inflight"] == 0


def test_request_timeout(model):
    gated = Gated(model)
    with InferenceEngine(gated, max_batch=1, batch_timeout_ms=0,
                         request_timeout_s=0.05) as eng:
        f1 = eng.submit(img(0, 16, 16))
        assert gated.started.wait(timeout=30)
        f2 = eng.submit(img(1, 16, 16))
        time.sleep(0.15)
        gated.gate.set()
        assert f1.result(timeout=30).shape == (16, 16, 3)
        with pytest.raises(RequestTimeout):
            f2.result(timeout=30)
        assert eng.stats()["timed_out"] == 1


def test_close_drains_queued_requests(model):
    """close() lets the worker finish what was queued before it, then joins."""
    gated = Gated(model)
    eng = InferenceEngine(gated, max_batch=1, batch_timeout_ms=0)
    futs = [eng.submit(img(i, 16, 8 * (i + 1))) for i in range(3)]
    assert gated.started.wait(timeout=30)
    gated.gate.set()
    eng.close(join_timeout_s=60)
    assert not eng._worker.is_alive()
    assert [f.result(timeout=1).shape for f in futs] == [
        (16, 8, 3), (16, 16, 3), (16, 24, 3)]
    with pytest.raises(EngineClosed):
        eng.submit(img(9, 16, 16))


def test_close_fails_what_a_wedged_worker_never_reached(model):
    gated = Gated(model)
    eng = InferenceEngine(gated, max_batch=1, batch_timeout_ms=0)
    f1 = eng.submit(img(0, 16, 16))
    assert gated.started.wait(timeout=30)
    f2 = eng.submit(img(1, 16, 16))
    eng.close(join_timeout_s=0.2)
    with pytest.raises(EngineClosed):
        f2.result(timeout=10)
    gated.gate.set()
    assert f1.result(timeout=30).shape == (16, 16, 3)
    eng.close()
    assert not eng._worker.is_alive()


def test_tiled_path_is_not_ported(model):
    """The engine's tiled path (the name predates its port): an image whose
    padded area is above tile_threshold_px is served alone through the
    overlap-blend tiler, exactly as a direct tiled_inference call with
    bucket = pad_base, and is counted in tiled_requests."""
    big = img(1, 40, 48)  # 40x48 = 1920 px > 1500: tiled
    with InferenceEngine(model, pad_base=8, max_batch=4, batch_timeout_ms=0,
                         tile_threshold_px=1500, tile_size=16,
                         tile_overlap=8, tile_chunk=4) as eng:
        out = eng.restore(big)
        s = eng.stats()
    ref = tiled_inference(model, torch.from_numpy(big[None]), tile=16,
                          overlap=8, chunk=4, bucket=8).numpy()[0]
    assert out.shape == big.shape
    np.testing.assert_array_equal(out, ref)
    assert s["tiled_requests"] == 1 and s["requests"] == 1
    assert s["compiled_shapes"] == 0


def test_rejects_wrong_channels(model):
    with InferenceEngine(model) as eng:
        with pytest.raises(ValueError, match="HW3"):
            eng.submit(np.zeros((8, 8, 4), np.float32))


class Identity(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x + self.w


def test_concurrent_submitters_lose_no_request():
    """16 threads submit 400 requests of 3 buckets under a short switch
    interval: every reply is its own image, and the in-flight count returns
    to 0 (a lost update under the lock would break either)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng = InferenceEngine(Identity(), max_batch=4, batch_timeout_ms=1,
                              max_queue=10_000)
        subs = {}

        def submitter(t):
            for i in range(25):
                im = np.full((8 * (1 + i % 3), 16, 3), (25 * t + i) / 1000,
                             np.float32)
                subs[(t, i)] = (im, eng.submit(im))

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for im, fut in subs.values():
            np.testing.assert_array_equal(fut.result(timeout=60), im)
        eng.close(join_timeout_s=60)
        s = eng.stats()
    finally:
        sys.setswitchinterval(old)
    assert len(subs) == 400 and s["requests"] == 400 and s["inflight"] == 0
    assert not eng._worker.is_alive()
