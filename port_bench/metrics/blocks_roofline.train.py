"""The training step's forward blocks at their roofline
(readers.blocks_roofline; only the forward's blocks are ranged), in
percent. Layer: blocks."""

from port_bench.readers import blocks_roofline


def read(ctx):
    return blocks_roofline(ctx, "train")
