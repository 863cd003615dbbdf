"""Device milliseconds a training step launches outside the step's
"forward" and "optimizer" ranges (train/step.py): autograd's backward and
its recompute, from the profiled slice's trace. Layer: train step."""


def read(ctx):
    split = ctx.get("split")
    if ctx.get("kind") != "train" or split is None or not split["ops"]:
        return None
    return split["parts"]["(outside)"]["ms"] / ctx["profile"]["steps"]
