"""Device time of the host-to-device copies per batch, in ms: the pinned
uint8 pixels of each batch (the encoder's entry, encoders/build.py's
to_device)."""


def read(ctx):
    s = ctx.trace.seconds_of(lambda op: op.kind == "memcpy"
                             and "HtoD" in op.name)
    return 1e3 * s / ctx.work["batches"] if ctx.work["batches"] else None
