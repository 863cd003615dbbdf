"""The instruments' shared parts: the device a tool runs on, CUDA-event
timing, torch.profiler windows and the trace reader.

`device_record` names what a number was measured on: `{"device": "cpu"}`,
or the card with its name and power limit as nvidia-smi reports them (a
card may be capped below its 700 W and then runs slower). `resolve_device`
refuses "cuda" without a card: a tool never falls back to the CPU.

`time_ms` times a function by CUDA events. Every profiled reading goes
through one trace reader: `split_trace` reads an exported Chrome trace
(`prof.export_chrome_trace`) and attributes each device kernel to the
innermost named host range that launched it, by the correlation id of its
`cudaLaunchKernel` runtime event: the port's kernels launch through ctypes
(ops/cuda/build.py), so no aten op lies above them and only the launch's
thread and time place them. A trace without device activity (a CPU run)
is split the same way over its outermost host ops. `traced_split` takes
the better of two profiled windows, and `profiled_ms`, `module_shares` and
`forward_breakdown` are views of it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import pathlib
import re
import subprocess
import tempfile
from typing import Iterable, Mapping, Union
from unittest import mock

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def resolve_device(name: str) -> torch.device:
    """torch.device(`name`); raises when it is a card and none is present."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions on the CPU")
    return device


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    """{"device": "cpu"}, or {"device": "cuda", "card": card_line()}."""
    if device.type != "cuda":
        return {"device": device.type}
    return {"device": "cuda", "card": card_line()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps=20, warmup=3) -> float:
    """Median of `reps` CUDA-event timings of fn() (after a warm-up)."""
    for _ in range(warmup):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


@contextlib.contextmanager
def ranges_on(spans: Mapping[str, tuple]):
    """Each `spans` entry, label: (class, method name), runs inside a
    torch.profiler record_function range of that label."""
    from torch.profiler import record_function

    with contextlib.ExitStack() as stack:
        for label, (cls, name) in spans.items():
            real = getattr(cls, name)

            def wrapped(self, *a, _real=real, _label=label, **k):
                with record_function(_label):
                    return _real(self, *a, **k)

            stack.enter_context(mock.patch.object(cls, name, wrapped))
        yield


def profile_trace(fn, reps: int, path: pathlib.Path, device: torch.device,
                  spans: Mapping[str, tuple] = None,
                  host: bool = True) -> pathlib.Path:
    """Run fn() once, then `reps` times under torch.profiler, with `spans`
    as ranges_on puts them; export the Chrome trace to `path` and return
    it. The card's activity is recorded where `device` is one, the host's
    where `host` is set or there is no card (a trace needs the host's
    launches only to place the kernels in ranges)."""
    from torch.profiler import ProfilerActivity, profile

    acts = []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if host or device.type != "cuda":
        acts.append(ProfilerActivity.CPU)
    with ranges_on(spans or {}):
        fn()
        sync(device)
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            sync(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def traced_split(fn, reps: int, out: pathlib.Path, device: torch.device,
                 ranges: Mapping, spans: Mapping[str, tuple] = None) -> dict:
    """split_trace of the better of two profiled windows of `reps` calls
    of fn() (the one with more device time: a window now and then loses
    kernel records), their traces written to `out`. With no `ranges` the
    host's activity is left out of the windows."""
    best = None
    for i in range(2):
        path = profile_trace(fn, reps, out / f"window_{i}.pt.trace.json",
                             device, spans, host=bool(ranges))
        split = split_trace(path, ranges)
        if best is None or split["busy_ms"] > best["busy_ms"]:
            best = split
    return best


def split_of(fn, reps: int, device: torch.device, ranges: Mapping = None,
             spans: Mapping[str, tuple] = None) -> dict:
    """traced_split with its traces in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        return traced_split(fn, reps, pathlib.Path(tmp), device, ranges or {},
                            spans)


def profiled_ms(fn, reps=10, device=torch.device("cuda")) -> float:
    """Device time of one fn() in ms: its device ops' summed times over
    `reps` calls (split_of), over the calls; no host time."""
    return split_of(fn, reps, device)["busy_ms"] / reps


def module_shares(fn, spans, reps=2, device=torch.device("cuda")) -> str:
    """Where fn()'s device time goes by module: each `spans` entry, label:
    (class, method name), runs inside a record_function range of that
    label (ranges_on), and each device op counts for the innermost range
    that launched it (split_of over `reps` calls), beside all device ops'
    time a call."""
    split = split_of(fn, reps, device, {label: label for label in spans},
                     spans)
    busy = split["busy_ms"] / reps
    out = []
    for label in spans:
        ms = split["parts"][label]["ms"] / reps
        out.append(f"{label} {ms:.2f} ms ({ms / max(busy, 1e-9):.1%})")
    return (f"device time by module over {reps} calls: " + "; ".join(out)
            + f"; all device ops {busy:.2f} ms a call")


def forward_breakdown(fn, reps=10) -> str:
    """Where the time of a forward with no kernel of the port goes: the
    device ops a call of split_of over `reps` calls, their device time a
    call beside the window's span a call (the first op's start to the last
    op's end), the share of it the card is idle, and the five ops that take
    most device time. Beside it the median of `reps` unprofiled calls
    (CUDA events) and the idle share against it: the profiler's own host
    cost lengthens a host-bound call, so the two idle shares bracket the
    card's."""
    alone = time_ms(fn, reps=reps, warmup=1)
    split = split_of(fn, reps, torch.device("cuda"))
    busy, wall = split["busy_ms"] / reps, split["window_ms"] / reps
    return (f"profile over {reps} calls: {split['ops'] / reps:.0f} device ops "
            f"a forward, device time {busy:.2f} ms of {wall:.2f} ms a call "
            f"from the first op's start to the last's end (idle "
            f"{split['idle']:.1%}); unprofiled median {alone:.2f} ms (idle "
            f"against it {1 - busy / alone:.1%}); busiest: " + "; ".join(
                f"{k[:60]} x{n / reps:.0f} {ms / reps:.2f} ms"
                for k, ms, n in split["top"]))


@functools.lru_cache(maxsize=1)
def port_kernels() -> frozenset:
    """The names of the kernels in csrc/*.cu and *.cuh."""
    names = set()
    for src in sorted(CSRC.glob("*.cu*")):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)\s*\(", src.read_text()))
    return frozenset(names)


def is_port_kernel(name: str) -> bool:
    """True for a device kernel built from csrc (its demangled name holds
    one of port_kernels() as a word)."""
    return any(re.search(rf"\b{k}\b", name) for k in port_kernels())


def load_trace(trace: Union[str, pathlib.Path, dict]) -> dict:
    """An exported Chrome trace: its path, or the loaded dict itself."""
    if isinstance(trace, dict):
        return trace
    with open(trace) as f:
        return json.load(f)


def _spans(events, tids_of):
    """{(pid, tid): [(start, end, event), ...]} of `events`, sorted by start
    and, at one start, outermost first."""
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


def split_trace(trace, ranges: Mapping[str, Union[str, Iterable[str]]],
                top: int = 5) -> dict:
    """Device time of a Chrome trace by host range.

    `ranges`, label: name prefix (or prefixes) of the host events that
    delimit it (record_function ranges, `autograd::engine::evaluate_
    function:` ops, ...). Each device op (kernel, memcpy, memset) goes to
    the label of the innermost such event, on the thread and at the time of
    its launch, that holds the launch (matched by correlation id);
    "(outside)" where none does. In a trace with no device op, the
    outermost host ops (cpu_op events inside no other) stand in for them,
    placed by their own thread and start.

    Returns {"device": True for device ops, "ops", "busy_ms" (the sum of
    the ops' times), "union_ms" (the time some op runs), "window_ms" (the
    first op's start to the last's end), "idle" (1 - union / window), and
    "parts": {label: {"ms", "ops", "port_ms" (the ms of the port's own
    kernels, is_port_kernel), "top": [[name, ms, count], ...]}}, "top": the
    busiest ops of the whole window}.
    """
    events = [e for e in load_trace(trace).get("traceEvents", [])
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
    device_ops = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if device_ops:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATEGORIES
                    and "correlation" in e.get("args", {})}
        ops, points = device_ops, []
        for op in ops:
            launch = launches.get(op.get("args", {}).get("correlation"))
            if launch is not None:
                points.append((thread(launch), launch["ts"], op))
    else:
        cpu = _spans([e for e in events if e.get("cat") == "cpu_op"], thread)
        ops = []
        for key, rs in cpu.items():
            end = -1
            for s, t, e in rs:
                if s >= end:
                    ops.append(e)
                    end = t
        points = [(thread(op), op["ts"], op) for op in ops]
    inner = _innermost(points, spans)
    parts = {label: collections.defaultdict(lambda: [0.0, 0])
             for label in [*ranges, "(outside)"]}
    for op in ops:
        r = inner.get(id(op))
        label = label_of(r[2]["name"]) if r else "(outside)"
        row = parts[label][op.get("name", "?")]
        row[0] += op.get("dur", 0) / 1e3
        row[1] += 1
    intervals = sorted((op["ts"], op["ts"] + op.get("dur", 0)) for op in ops)
    union, end = 0.0, None
    for s, t in intervals:
        if end is None or s > end:
            union += t - s
            end = t
        elif t > end:
            union += t - end
            end = t
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    everything = collections.defaultdict(lambda: [0.0, 0])
    for rows in parts.values():
        for name, (ms, n) in rows.items():
            everything[name][0] += ms
            everything[name][1] += n
    out = {}
    for label, rows in parts.items():
        ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
        out[label] = {"ms": sum(r[0] for r in rows.values()),
                      "ops": sum(r[1] for r in rows.values()),
                      "port_ms": sum(r[0] for k, r in rows.items()
                                     if is_port_kernel(k)),
                      "top": [[k, ms, n] for k, (ms, n) in ranked[:top]]}
    return {"device": bool(device_ops), "ops": len(ops),
            "busy_ms": sum(op.get("dur", 0) for op in ops) / 1e3,
            "union_ms": union / 1e3, "window_ms": window / 1e3,
            "idle": 1 - union / window if window else 0.0, "parts": out,
            "top": [[k, ms, n] for k, (ms, n) in sorted(
                everything.items(), key=lambda kv: -kv[1][0])[:top]]}

