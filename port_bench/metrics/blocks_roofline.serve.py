"""The served forward's transformer blocks at their roofline
(readers.blocks_roofline), in percent. Layer: blocks."""

from port_bench.readers import blocks_roofline


def read(ctx):
    return blocks_roofline(ctx, "serve")
