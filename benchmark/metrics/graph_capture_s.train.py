"""Seconds the program spent capturing its CUDA graphs at set-up, train
and eval, summed over the shape groups (engine/graphs.py's
GraphSteps.capture_s, a program counter)."""


def read(ctx):
    return ctx.work.get("capture_s")
