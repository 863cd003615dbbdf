"""Share of the profiled window (its length on the host's clock, the
slice that records the device alone) in which no device op runs, from the
union of the device ops, in percent. Layer: device."""


def read(ctx):
    split = ctx.get("device_split")
    if ctx.get("kind") != "train" or split is None or not split["ops"]:
        return None
    return 100.0 * split["idle"]
