"""Model FLOPs of the window's training steps (3 x the reference's forward
count per image: the forward and the backward, not the port's recompute)
over the window's seconds and the card's bf16 peak, in percent. Layer:
model."""

from port_bench.counts.peaks import BF16_FLOPS_PER_S


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["model_flops"]:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / BF16_FLOPS_PER_S
