"""The port's spans and counters (utils/tracing.py) on the CPU: when they
are recorded, how they nest, the clock they share with torch.profiler, the
bounded store, and the spans and counters of the engine, the training step
and set-up."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from promptir_tpu_torch import create_model
from promptir_tpu_torch.ops.cuda import packed
from promptir_tpu_torch.serve.engine import InferenceEngine
from promptir_tpu_torch.train.state import TrainState, make_optimizer
from promptir_tpu_torch.train.step import make_train_step
from promptir_tpu_torch.utils import tracing

TINY = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.clear()
    yield
    tracing.clear()


def profiled(fn, tmp_path):
    """fn() under a CPU torch.profiler; returns the exported trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def annotations(trace):
    """(name, start ns, end ns) of the trace's record_function ranges, on
    the Unix clock."""
    base = trace["baseTimeNanoseconds"]
    return [(e["name"], base + round(e["ts"] * 1e3),
             base + round((e["ts"] + e["dur"]) * 1e3))
            for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def by_id():
    return {s.id: s for s in tracing.spans()}


def busy(n=64):
    x = torch.randn(n, n)
    return (x @ x).sum()


@pytest.mark.parametrize("kind,stored", [("span", 0), ("record", 0),
                                         ("setup_span", 1)])
def test_what_is_stored_without_a_profiler(kind, stored):
    assert not torch.autograd.profiler._is_profiler_enabled
    if kind == "record":
        tracing.record("engine.request", 1, 2, request=0)
    else:
        with getattr(tracing, kind)("a") as s:
            busy()
        assert (s is None) == (stored == 0)
    assert len(tracing.spans()) == stored


def test_spans_nest_with_their_parents(tmp_path):
    seen = {}

    def work():
        with tracing.span("outer", k=1) as outer:
            with tracing.span("inner"):
                busy()
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    busy()
            tracing.record("across", outer.t0, tracing.now_ns())

        def other():
            with tracing.span("elsewhere"):
                seen["tid"] = threading.get_native_id()

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    profiled(work, tmp_path)
    spans = by_id()
    named = {}
    for s in spans.values():
        named.setdefault(s.name, []).append(s)
    outer, = named["outer"]
    assert outer.parent is None and outer.attrs == {"k": 1}
    assert [s.parent for s in named["inner"]] == [outer.id, outer.id]
    leaf, = named["leaf"]
    assert leaf.parent == named["inner"][1].id
    across, = named["across"]
    assert across.parent is None and across.t0 == outer.t0
    elsewhere, = named["elsewhere"]
    assert elsewhere.parent is None and elsewhere.tid == seen["tid"]
    me = threading.get_native_id()
    assert {s.tid for s in spans.values() if s is not elsewhere} == {me}
    for s in spans.values():
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1


def test_spans_lie_on_the_profilers_clock(tmp_path):
    """Each span holds its record_function event, within 50 us: the spans
    and the trace share one clock."""
    def work():
        for i in range(5):
            with tracing.span(f"s{i}"):
                busy()

    trace = profiled(work, tmp_path)
    events = {name: (t0, t1) for name, t0, t1 in annotations(trace)}
    spans = tracing.spans()
    assert len(spans) == 5
    for s in spans:
        t0, t1 = events[s.name]
        assert s.t0 - 50_000 <= t0 <= t1 <= s.t1 + 50_000, (s, t0, t1)


def test_the_store_keeps_the_newest_spans(tmp_path):
    n = tracing.CAPACITY + 10

    def work():
        for i in range(n):
            tracing.record("r", i, i + 1, i=i)

    profiled(work, tmp_path)
    kept = tracing.spans()
    assert len(kept) == tracing.CAPACITY
    assert [s.attrs["i"] for s in (kept[0], kept[-1])] == [10, n - 1]


@pytest.fixture(scope="module")
def served():
    torch.manual_seed(0)
    return create_model("promptir", device="cpu", **TINY)


def img(seed, h, w):
    return np.random.default_rng(seed).uniform(size=(h, w, 3)).astype(np.float32)


def test_engine_spans_and_queue_waits(served, tmp_path):
    """Each request: one engine.request span and one batch whose ids hold
    it; its queue wait is its batch's start less its submit, as stats()
    reports it."""
    imgs = [img(i, 21 + i % 2 * 8, 30) for i in range(7)]
    with InferenceEngine(served, pad_base=8, max_batch=4,
                         batch_timeout_ms=20) as eng:
        profiled(lambda: eng.restore_many(imgs), tmp_path)
        stats = eng.stats()
    requests = tracing.spans("engine.request")
    batches = tracing.spans("engine.batch")
    assert len(requests) == len(imgs) == stats["requests"]
    assert len({s.attrs["request"] for s in requests}) == len(imgs)
    start = {}
    for b in batches:
        assert b.attrs["fill"] == len(b.attrs["requests"]) <= 4
        for rid in b.attrs["requests"]:
            assert rid not in start
            start[rid] = b.t0
    assert set(start) == {s.attrs["request"] for s in requests}
    waits = [(start[s.attrs["request"]] - s.t0) / 1e9 for s in requests]
    assert min(waits) > 0
    assert stats["max_queue_wait_s"] == max(waits)
    assert stats["mean_queue_wait_s"] == pytest.approx(np.mean(waits), rel=1e-9)
    spans = by_id()
    worker = {b.tid for b in batches}
    assert len(worker) == 1
    for name in ("engine.pad", "engine.h2d", "engine.model", "engine.d2h"):
        inner = tracing.spans(name)
        assert len(inner) == len(batches)
        assert all(spans[s.parent].name == "engine.batch" for s in inner)
    for name in ("engine.collect", "engine.resolve"):
        assert {s.tid for s in tracing.spans(name)} == worker
    assert len(tracing.spans("engine.resolve")) == len(batches)
    # the worker waited for the first group before the profiler started
    sizes = [s.attrs["size"] for s in tracing.spans("engine.collect")
             if "size" in s.attrs]
    assert len(sizes) >= len(batches) - 1
    assert sizes == [b.attrs["fill"] for b in batches][-len(sizes):]


def test_stats_report_queue_waits_without_a_profiler(served):
    with InferenceEngine(served, pad_base=8, max_batch=2,
                         batch_timeout_ms=1) as eng:
        eng.restore_many([img(i, 24, 24) for i in range(5)])
        stats = eng.stats()
    assert 0 < stats["mean_queue_wait_s"] <= stats["max_queue_wait_s"]
    assert stats["max_queue_wait_s"] < stats["max_latency_s"]
    assert not tracing.spans("engine.request")


def test_first_call_once_per_bucket(served):
    """setup.first_call is recorded (with no profiler) at each bucket's
    first batch, and never again."""
    with InferenceEngine(served, pad_base=8, max_batch=2,
                         batch_timeout_ms=1) as eng:
        for _ in range(2):
            eng.restore_many([img(0, 24, 24), img(1, 24, 24)])
            eng.restore_many([img(2, 17, 40)])
        buckets = eng.stats()["compiled_shapes"]
    first = tracing.spans("setup.first_call")
    assert buckets == 2
    assert sorted(s.attrs["bucket"] for s in first) == [(24, 24), (24, 40)]
    assert tracing.spans("setup.model") == []  # the model came before


class ParamCasts(TorchDispatchMode):
    """Counts the dtype changes of tensors that share a parameter's storage,
    as the dispatcher sees them (the backward's too): the copies a step
    makes of its weights, seen from outside the port."""

    def __init__(self, model):
        super().__init__()
        self.ptrs = {p.untyped_storage().data_ptr() for p in model.parameters()}
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        src = args[0] if args else None
        if (isinstance(src, torch.Tensor) and isinstance(out, torch.Tensor)
                and out.dtype != src.dtype
                and src.untyped_storage().data_ptr() in self.ptrs):
            self.n += 1
        return out


@pytest.mark.parametrize("name,size", [("promptir", 32),
                                       ("promptxrestormerir", 64)])
def test_train_step_spans_and_weight_copies(name, size, tmp_path, monkeypatch):
    """train.step holds forward, backward and optimizer; its weight_copies
    are the casts of the float32 weights to bfloat16 that the step makes
    (at use, in the forward and in the recomputing backward) plus the
    packed GDFN weights."""
    torch.manual_seed(0)
    model = create_model(name, device="cpu", dtype=torch.bfloat16, train=True,
                         **TINY)
    state = TrainState(model, make_optimizer(model.parameters(), 2e-4, 0.01))
    step = make_train_step(model)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.rand(2, size, size, 3, generator=gen)
             for k in ("degraded", "clean")}
    packs = []
    real_pack = packed._pack
    monkeypatch.setattr(packed, "_pack",
                        lambda *a: packs.append(1) or real_pack(*a))
    step(state, batch)  # the first call, outside any profiler
    first, = tracing.spans("setup.first_call")
    assert first.attrs == {"step": 0} and len(tracing.spans()) == 2
    casts = ParamCasts(model)
    with casts:
        profiled(lambda: step(state, batch), tmp_path)
    spans = by_id()
    top, = tracing.spans("train.step")
    assert top.attrs["step"] == 1 and top.parent is None
    for phase in ("forward", "backward", "optimizer"):
        s, = tracing.spans(phase)
        assert s.parent == top.id and top.t0 <= s.t0 <= s.t1 <= top.t1
    assert casts.n > 0
    assert top.attrs["weight_copies"] == casts.n + len(packs)
    assert len(spans) == 6  # the first call's two, and these four


@pytest.mark.parametrize("which", ["cast_weight", "gdfn_weights"])
def test_cached_copies_count_once(which):
    """A cached bf16 or packed copy counts when it is made, not when it is
    reused, and again once its weight changes."""
    c, f = 16, 42
    w1, wdw, w2 = (torch.randn(2 * f, c), torch.randn(2 * f, 9),
                   torch.randn(c, f))

    def use():
        if which == "cast_weight":
            packed.cast_weight(w1, torch.bfloat16)
        else:
            packed.gdfn_weights(w1, wdw, w2)

    use()
    use()
    assert tracing.counts("weight_copies") == {which: 1}
    with torch.no_grad():
        w1.add_(1)
    use()
    assert tracing.total("weight_copies") == 2


def test_create_model_records_a_setup_span():
    create_model("promptir", device="cpu", **TINY)
    s, = tracing.spans("setup.model")
    assert s.attrs == {"model": "promptir"} and s.seconds > 0
