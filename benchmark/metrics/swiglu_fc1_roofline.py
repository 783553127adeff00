"""fc1 of a SwiGLU trunk against its roofline, in %: the least time of
every block's fc1 over the traced patches (flops/vit_swiglu.py; bf16
operands, each read once, the half-width output written once) at the
trunk's stated peak, over the device time of the GEMM's SwiGLU-epilogue
instance alone (kernels/swiglu_fc1.json). None where no such kernel ran."""

from harness.readers import images, trunk_bound_pct, trunk_dims
from harness.spec import flops


def read(ctx):
    work = flops("vit_swiglu").fc1_work(*trunk_dims(ctx), images(ctx))
    return trunk_bound_pct(ctx, "swiglu_fc1", work)
