"""Kernels B1 and B2 against their roofline, in %: the least time of the
work they must do for the traced bags (B1 and B2 on every train bag, B1 on
every val and test bag, at their valid lengths; flops/acmil_ga.py), each
bag at the larger of its operations over the dense bf16 peak and its bytes
over the HBM rate, over the device time of the family's kernels
(kernels/attn_pool.json)."""

from harness.common import share_pct
from harness.readers import head_dims
from harness.spec import flops


def read(ctx):
    f = flops("acmil_ga")
    df, l, a, k, _ = head_dims(ctx)
    p = ctx.peaks()
    peak, bw = p["bf16_flops"], p["hbm_bytes_per_s"]
    per_epoch = sum(f.bound_s(*f.b1(n, df, l, a, k), peak, bw)
                    + f.bound_s(*f.b2(n, df, l, a, k), peak, bw)
                    for n in ctx.work["train_lengths"])
    per_epoch += sum(f.bound_s(*f.b1(n, df, l, a, k), peak, bw)
                     for n in ctx.work["eval_lengths"])
    return share_pct(ctx.work["epochs"] * per_epoch,
                     ctx.family_seconds("attn_pool"))
