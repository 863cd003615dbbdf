"""Weight copies a training step makes: the mean `weight_copies` attribute
of the `train.step` spans inside the device-only slice, the growth of the
program's "weight_copies" counter over each step (every cast of a float32
weight to the compute dtype, every packed GDFN copy; utils/tracing.py),
as a count. Layer: model."""

import statistics

from port_bench.program_spans import named, slice_spans


def read(ctx):
    spans = slice_spans(ctx) if ctx.get("kind") == "train" else None
    steps = named(spans, "train.step") if spans else []
    if not steps:
        return None
    return statistics.mean(s.attrs["weight_copies"] for s in steps)
