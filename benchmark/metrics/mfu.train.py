"""The whole step's share of the card's stated peak, in %: the ACMIL_GA
head's useful operations over the traced epochs (forward and backward of
every train bag, forward of every val and test bag, at their valid
lengths) over the window's time at the peak the configuration states for
the head (f32 products: dense TF32)."""

from harness.readers import head_dims
from harness.spec import flops


def read(ctx):
    f = flops("acmil_ga")
    dims = head_dims(ctx)
    per_epoch = (sum(f.train_flops(n, *dims)
                     for n in ctx.work["train_lengths"])
                 + sum(f.eval_flops(n, *dims)
                       for n in ctx.work["eval_lengths"]))
    peak = ctx.peaks()[ctx.cell.config["head"]["peak"]]
    return (100.0 * ctx.work["epochs"] * per_epoch
            / (ctx.trace.window_s * peak))
