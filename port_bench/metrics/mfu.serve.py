"""A served batch's share of the card's bf16 peak: the model FLOPs of
the engine's batch calls in the window (the plain reference's count,
counts/flops.py, for the whole padded batch at its padded shape) over
their summed time on the host's clock (pad, copy in, forward, copy out;
drivers/serve.py:_Batches), in percent. The offered rate does not set it:
the time the engine waits for requests is outside the calls. Layer: model."""

from port_bench.counts.peaks import BF16_FLOPS_PER_S


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["batch_s"]:
        return None
    return 100.0 * ctx["batch_flops"] / ctx["batch_s"] / BF16_FLOPS_PER_S
