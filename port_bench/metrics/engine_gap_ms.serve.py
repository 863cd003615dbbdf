"""The card's idle time a batch that the engine's own host work holds it
to, in the device-only slice: the device's idle intervals (program_spans.
idle_ns) that overlap the worker's `engine.pad`, `engine.h2d`, `engine.d2h`
and `engine.resolve` spans, over the slice's `engine.batch` spans, in ms.
Time in `engine.collect`, the wait for requests that the offered rate
sets, is left out. None without device ops (a CPU run). Layer: engine."""

from port_bench.program_spans import idle_ns, named, overlap_ns, slice_spans

HOST_WORK = ("engine.pad", "engine.h2d", "engine.d2h", "engine.resolve")


def read(ctx):
    spans = slice_spans(ctx) if ctx.get("kind") == "serve" else None
    if not spans:
        return None
    batches = named(spans, "engine.batch")
    idle = idle_ns(ctx["profile"]["device"]["trace"])
    if not batches or idle is None:
        return None
    work = sorted((s for s in spans if s.name in HOST_WORK),
                  key=lambda s: s.t0)
    return overlap_ns(idle, work) / len(batches) / 1e6
