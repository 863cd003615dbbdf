"""Seconds of set-up spent in first calls: the summed length of the
program's `setup.first_call` spans over the whole run (the engine's first
batch at each bucket, a training step's first call; recorded with no
profiler running), which hold the kernel library's build or load, cuDNN's
first plans and the first launches. Layer: set-up."""

from port_bench.program_spans import stored


def read(ctx):
    spans = stored()
    first = [s for s in spans or () if s.name == "setup.first_call"
             and s.t1 is not None]
    return sum(s.t1 - s.t0 for s in first) / 1e9 if first else None
