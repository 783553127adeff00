"""Device time per bag, in ms, of every kernel outside the B1/B2 family
(kernels/attn_pool.json): STKIM's correction, the classifiers, the loss,
the optimizer and the graphs' index and copy kernels (the model and
engine layers), over the traced epochs' train, val and test bags."""

from harness.spec import in_family, kernel_table


def read(ctx):
    table = kernel_table("attn_pool")
    s = ctx.trace.seconds_of(lambda op: op.kind == "kernel"
                             and not in_family(table, op.name))
    bags = ctx.work["epochs"] * (len(ctx.work["train_lengths"])
                                 + len(ctx.work["eval_lengths"]))
    return 1e3 * s / bags if bags else None
