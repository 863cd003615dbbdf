"""The readers of the program's own spans (program_spans.py and the
metrics that use it): a `--trace 1` rehearsal of a serving and a training
cell on the CPU reads each of them that has something to read there, and
the device-idle arithmetic of `engine_gap_ms.serve` on a made-up trace."""

import types

import pytest

from port_bench import manifest, program_spans, rehearse

SPAN_METRICS = {
    "promptir-serve-photo": ["queue_wait_ms.serve", "first_call_s"],
    "promptir-train-b24": ["forward_host_ms.train", "backward_host_ms.train",
                           "optimizer_host_ms.train", "weight_copies.train",
                           "first_call_s"],
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_rehearsal_reads_the_program_spans(cell):
    out = rehearse.rehearse(cell, 2 ** 31 + 77, 2.0, trace=True)
    metrics = out["line"]["metrics"]
    for name in SPAN_METRICS[cell]:
        assert metrics[name]["value"] > 0, name
    listed = {m["name"] for m in manifest.cell(cell)["per_layer"]}
    assert set(SPAN_METRICS[cell]) <= listed
    # the CPU slice holds no device op, so the engine's share of the
    # card's idle time has nothing to read there
    assert "engine_gap_ms.serve" not in metrics
    if cell.endswith("train-b24"):
        prof = out["raw"]["ctx"]["profile"]
        host = sum(metrics[f"{p}_host_ms.train"]["value"]
                   for p in ("forward", "backward", "optimizer"))
        assert host <= prof["device"]["wall_s"] * 1e3 / prof["steps"]


def span(name, t0, t1, **attrs):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, attrs=attrs)


def test_engine_gap_counts_the_idle_time_under_host_work(monkeypatch):
    """Device ops at [10, 20] and [50, 60] us of a 0-100 us slice: idle
    [0, 10], [20, 50], [60, 100]. The worker's pad [0, 15] and d2h
    [40, 70] overlap 10 + 10 + 10 us of it; its collect [70, 100] is left
    out; two batches."""
    trace = {"baseTimeNanoseconds": 1_000_000, "traceEvents": [
        dict(ph="X", cat="Trace", name="PyTorch Profiler (0)", ts=0, dur=100),
        dict(ph="X", cat="kernel", name="k", ts=10, dur=10),
        dict(ph="X", cat="gpu_memcpy", name="m", ts=50, dur=10),
    ]}
    base = 1_000_000
    us = 1000
    spans = [span("engine.pad", base, base + 15 * us),
             span("engine.batch", base, base + 70 * us, requests=[1]),
             span("engine.d2h", base + 40 * us, base + 70 * us),
             span("engine.batch", base + 75 * us, base + 76 * us, requests=[2]),
             span("engine.collect", base + 70 * us, base + 100 * us)]
    assert program_spans.window_ns(trace) == (base, base + 100 * us)
    assert program_spans.idle_ns(trace) == [
        (base, base + 10 * us), (base + 20 * us, base + 50 * us),
        (base + 60 * us, base + 100 * us)]
    monkeypatch.setattr(program_spans, "stored", lambda: spans)
    ctx = {"kind": "serve", "profile": {"device": {"trace": trace}}}
    gap = manifest.reader("engine_gap_ms.serve")(ctx)
    assert gap == pytest.approx(30 * us / 2 / 1e6)
    assert manifest.reader("engine_gap_ms.serve")(dict(ctx, kind="train")) is None


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """A checkout whose program records no spans gives every reader None."""
    monkeypatch.setattr(program_spans, "stored", lambda: None)
    trace = {"traceEvents": [dict(ph="X", cat="kernel", ts=0, dur=1)]}
    for kind, names in (("serve", SPAN_METRICS["promptir-serve-photo"]),
                        ("train", SPAN_METRICS["promptir-train-b24"])):
        ctx = {"kind": kind, "profile": {"device": {"trace": trace}}}
        for name in names + ["engine_gap_ms.serve"]:
            assert manifest.reader(name)(ctx) is None, name
