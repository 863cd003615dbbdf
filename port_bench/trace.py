"""Reading a torch.profiler window: device time by host range, idle share
and where the card waits.

`split` is a frozen copy of the port's trace reader
(promptir_tpu_torch/tools/trace.py:split_trace): each device op (kernel,
memcpy, memset) goes to the innermost named host range that holds its
launch, matched by the launch's correlation id, so the port's ctypes
launches are placed by the thread and time of their `cudaLaunchKernel`.
Two changes: the idle share is measured against the profiled wall window
(the first to the last event of any kind in the trace), not against the
span from the first device op to the last; and `breakdown` lists the
busiest device ops and the idle gaps by what the host was doing, named
after the innermost host op on the launching thread before the op that
ended the gap.

`profiled` runs a function under the profiler, with record_function
ranges, and exports the trace into a temporary directory under TMPDIR,
which is deleted before it returns.
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import tempfile
import time
from typing import Iterable, Mapping, Union

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _spans(events, tids_of):
    out = collections.defaultdict(list)
    for e in events:
        out[tids_of(e)].append((e["ts"], e["ts"] + e.get("dur", 0), e))
    for v in out.values():
        v.sort(key=lambda s: (s[0], -s[1]))
    return out


def _innermost(points, spans):
    """For each (key, ts, payload) in `points`, the innermost of `spans`
    (properly nested ranges on one thread) that holds ts, or None."""
    found = {}
    by_key = collections.defaultdict(list)
    for key, ts, payload in points:
        by_key[key].append((ts, id(payload), payload))
    for key, pts in by_key.items():
        pts.sort(key=lambda p: p[:2])
        rs, i, stack = spans.get(key, []), 0, []
        for ts, _, payload in pts:
            while i < len(rs) and rs[i][0] <= ts:
                while stack and stack[-1][1] < rs[i][0]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            found[id(payload)] = stack[-1] if stack else None
    return found


def _union(intervals):
    """(time covered, [(gap start, gap end), ...]) of sorted intervals."""
    union, end, gaps = 0.0, None, []
    for s, t in intervals:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            union += t - s
            end = t
        elif t > end:
            union += t - end
            end = t
    return union, gaps


def split(trace: dict, ranges: Mapping[str, Union[str, Iterable[str]]],
          top: int = 10, wall_s: float = None) -> dict:
    """Device time of a Chrome trace by host range.

    `ranges`, label: name prefix (or prefixes) of the host events that
    delimit it. Returns {"ops", "busy_s" (the time some device op runs),
    "window_s" (`wall_s`, the profiled window's length on the host's clock,
    where given; else the first to the last event of any kind), "idle" (1 -
    busy_s / window_s), "parts": {label: {"ms", "ops"}} with "(outside)" for ops in
    no range, "device_ops": [[name, seconds], ...] the busiest op names,
    "idle_gaps": [[host op, seconds], ...] the idle time between device
    ops by the host op before the launch that ended each gap}."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
    prefixes = {label: (p,) if isinstance(p, str) else tuple(p)
                for label, p in ranges.items()}

    def label_of(name):
        return next((label for label, ps in prefixes.items()
                     if name.startswith(ps)), None)

    def thread(e):
        return (e.get("pid"), e.get("tid"))

    named = [e for e in events if e.get("cat") not in DEVICE_CATEGORIES
             and label_of(e.get("name", "")) is not None]
    spans = _spans(named, thread)
    ops = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATEGORIES
                and "correlation" in e.get("args", {})}
    points, launch_of = [], {}
    for op in ops:
        launch = launches.get(op.get("args", {}).get("correlation"))
        if launch is not None:
            points.append((thread(launch), launch["ts"], op))
            launch_of[id(op)] = launch
    inner = _innermost(points, spans)
    parts = {label: [0.0, 0] for label in [*ranges, "(outside)"]}
    by_name = collections.defaultdict(float)
    for op in ops:
        r = inner.get(id(op))
        label = label_of(r[2]["name"]) if r else "(outside)"
        parts[label][0] += op.get("dur", 0) / 1e3
        parts[label][1] += 1
        by_name[op.get("name", "?")] += op.get("dur", 0) / 1e6
    ordered = sorted(ops, key=lambda o: o["ts"])
    busy, gaps = _union([(o["ts"], o["ts"] + o.get("dur", 0)) for o in ordered])
    first = min((e["ts"] for e in events), default=0.0)
    last = max((e["ts"] + e.get("dur", 0) for e in events), default=0.0)
    window = wall_s * 1e6 if wall_s is not None else last - first
    # each gap is named after the host op that launched the op ending it
    host = [e for e in events if e.get("cat") == "cpu_op"
            or e.get("cat") == "user_annotation"]
    host_spans = _spans(host, thread)
    starts = {o["ts"]: o for o in reversed(ordered)}
    gap_points = []
    for s, t in gaps:
        launch = launch_of.get(id(starts[t]))
        if launch is not None:
            gap_points.append((thread(launch), launch["ts"], (s, t)))
    gap_host = _innermost(gap_points, host_spans)
    by_host = collections.defaultdict(float)
    for _, _, gap in gap_points:
        r = gap_host.get(id(gap))
        by_host[r[2]["name"] if r else "(no host op)"] += (gap[1] - gap[0]) / 1e6
    return {
        "ops": len(ops),
        "busy_s": busy / 1e6,
        "window_s": window / 1e6,
        "idle": 1 - busy / window if window else 0.0,
        "parts": {k: {"ms": ms, "ops": n} for k, (ms, n) in parts.items()},
        "device_ops": [[k, v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(
            by_host.items(), key=lambda kv: -kv[1])[:top]],
    }


@contextlib.contextmanager
def ranges_on(patches: Iterable[tuple]):
    """Each (owner, attribute, label, on_call) in `patches`: the callable
    `owner.attribute` (a module's function or a class's method) runs inside
    a record_function range named `label`, and `on_call(args, kwargs)` is
    called first (None: nothing), for as long as the block runs."""
    from torch.profiler import record_function

    saved = []
    try:
        for owner, attr, label, on_call in patches:
            real = getattr(owner, attr)

            def wrapped(*a, _real=real, _label=label, _on=on_call, **k):
                if _on is not None:
                    _on(a, k)
                with record_function(_label):
                    return _real(*a, **k)

            saved.append((owner, attr, real))
            setattr(owner, attr, wrapped)
        yield
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


def _all_threads():
    """The profiler's option to record the host ops of every thread (the
    engine's worker thread too), where this PyTorch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def profiled(host: bool = True):
    """Profile the block's device activity and, with `host`, the host ops of
    every thread. Yields a dict that, after the block, holds "trace" (the
    exported Chrome trace, loaded) and "wall_s" (the host clock's length of
    the profiled block, up to a synchronize). Without `host` the profiler
    costs the host least, so its idle share is closest to an unprofiled
    window's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host or not card else []) \
        + ([ProfilerActivity.CUDA] if card else [])
    kw = {}
    if host:
        config = _all_threads()
        if config is not None:
            kw["experimental_config"] = config
    with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as tmp:
        with profile(activities=acts, **kw) as prof:
            t0 = time.perf_counter()
            yield out
            if card:
                torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
        path = pathlib.Path(tmp) / "window.pt.trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            out["trace"] = json.load(f)
