"""Arithmetic that the readers of the program's own spans share.

The port records spans while a torch.profiler session runs
(promptir_tpu_torch/utils/tracing.py), stamped on the profiler's clock: the
Unix clock in nanoseconds, which is an exported trace's event `ts` in
microseconds x 1000 plus its `baseTimeNanoseconds`. So the spans that fall
inside the device-only slice (ctx["profile"]["device"], where the profiler
costs the host least) line up with that slice's device ops. A program that
records no spans (one without utils/tracing.py) gives every reader None.
"""

from __future__ import annotations

from port_bench.trace import DEVICE_CATEGORIES


def stored():
    """The program's stored spans, oldest first; None where it has none."""
    try:
        from promptir_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def _events(trace: dict) -> list:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e]


def _ns(trace: dict, ts_us: float) -> int:
    return trace.get("baseTimeNanoseconds", 0) + round(ts_us * 1e3)


def window_ns(trace: dict):
    """(start, end) of a profiled slice in ns: the profiler's own event
    that spans its session where the trace has one, else its first to its
    last event; None for an empty trace."""
    events = _events(trace)
    whole = [e for e in events if e.get("cat") == "Trace"] or events
    if not whole:
        return None
    return (_ns(trace, min(e["ts"] for e in whole)),
            _ns(trace, max(e["ts"] + e.get("dur", 0) for e in whole)))


def slice_spans(ctx: dict):
    """The spans the program recorded inside the device-only slice, or
    None (no profiled slice, or no spans)."""
    prof = ctx.get("profile")
    spans = stored()
    if prof is None or spans is None:
        return None
    window = window_ns(prof["device"]["trace"])
    if window is None:
        return None
    return [s for s in spans
            if s.t1 is not None and window[0] <= s.t0 and s.t1 <= window[1]]


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def idle_ns(trace: dict):
    """The device's idle intervals [(start, end), ...] in ns inside the
    slice's window: the gaps in the union of its device ops and the two
    edges. None where the trace holds no device op (a CPU run)."""
    ops = sorted((_ns(trace, e["ts"]), _ns(trace, e["ts"] + e.get("dur", 0)))
                 for e in _events(trace) if e.get("cat") in DEVICE_CATEGORIES)
    window = window_ns(trace)
    if not ops or window is None:
        return None
    gaps, end = [], window[0]
    for s, t in ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if window[1] > end:
        gaps.append((end, window[1]))
    return gaps


def overlap_ns(intervals: list, spans: list) -> int:
    """The time the sorted, disjoint `intervals` share with `spans`."""
    total = 0
    for s in spans:
        for a, b in intervals:
            if b <= s.t0:
                continue
            if a >= s.t1:
                break
            total += min(b, s.t1) - max(a, s.t0)
    return total


def per_step_ms(ctx: dict, name: str):
    """The summed length of the `name` spans inside the device-only slice
    over its `train.step` spans, in ms; None outside a training cell."""
    spans = slice_spans(ctx) if ctx.get("kind") == "train" else None
    if not spans:
        return None
    steps = named(spans, "train.step")
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in named(spans, name)) / len(steps) / 1e6
