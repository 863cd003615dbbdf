"""The median request's wait in the engine's queue, in the device-only
slice: the start of its `engine.batch` span less the start of its
`engine.request` span (its submit), from the program's own spans
(program_spans.py), in ms. Layer: engine."""

import statistics

from port_bench.program_spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx) if ctx.get("kind") == "serve" else None
    if not spans:
        return None
    start = {rid: b.t0 for b in named(spans, "engine.batch")
             for rid in b.attrs["requests"]}
    waits = [start[r.attrs["request"]] - r.t0
             for r in named(spans, "engine.request")
             if r.attrs["request"] in start]
    return statistics.median(waits) / 1e6 if waits else None
