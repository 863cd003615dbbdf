"""Ranges the benchmark puts around the port's transformer blocks.

A configuration's `blocks` entry names the callable that runs one block
(`patch`, "module:attribute" or "module:Class.method") and the count of
its work (`count`, a module of port_bench/counts/). While its patches are
on (trace.ranges_on), each call runs inside a record_function range named
BLOCK, so the trace reader places the kernels it launches, and its shapes
are recorded so that the same work can be counted from them."""

from __future__ import annotations

import importlib

from port_bench.counts import peaks

BLOCK = "port_bench.block"


class BlockCounter:
    def __init__(self, config: dict):
        spec = config["blocks"]
        module, attr = spec["patch"].split(":")
        owner = importlib.import_module(module)
        *path, self.attr = attr.split(".")
        for name in path:
            owner = getattr(owner, name)
        self.owner = owner
        self.count = importlib.import_module(f"port_bench.counts.{spec['count']}")
        self.calls = []

    def patches(self):
        def on_call(args, kwargs):
            self.calls.append(self.count.record(args, kwargs))

        return [(self.owner, self.attr, BLOCK, on_call)]

    def bound_s(self) -> float:
        """The least time the recorded calls could take on the card."""
        return sum(peaks.bound_s(*self.count.work(r)) for r in self.calls)
