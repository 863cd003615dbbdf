"""The host's ms a training step spends in autograd's backward ("backward", train/step.py): the recomputing backward's launches, from the program's own
spans inside the device-only slice, their summed length over the slice's
`train.step` spans (program_spans.per_step_ms). Layer: train step."""

from port_bench.program_spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "backward")
