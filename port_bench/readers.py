"""Arithmetic that more than one per-layer reader (metrics/) shares: a
reader of a `.serve` or `.train` metric reads its own kind of cell and
returns None in the other."""

from __future__ import annotations


def blocks_roofline(ctx: dict, kind: str):
    """The transformer blocks' share of their roofline in the profiled
    slice: the least time the card could take for the blocks that ran
    (counts/, from their recorded shapes) over the device time of the ops
    launched inside the ranges the benchmark puts around them (spans.py),
    in percent."""
    split = ctx.get("split")
    if ctx.get("kind") != kind or split is None:
        return None
    ms = split["parts"]["block"]["ms"]
    bound = ctx["profile"]["blocks"].bound_s()
    if ms <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (ms / 1e3)
