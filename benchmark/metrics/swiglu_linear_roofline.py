"""The linear layers of a SwiGLU trunk against their roofline, in %: the
least time of every block's qkv, proj, fc1 and fc2 over the traced patches
(flops/vit_swiglu.py, fc2 from half of fc1's packed width; bf16 operands,
each read once) at the trunk's stated peak, over the device time of every
GEMM kernel, the port's and the library's (kernels/vit_linear.json)."""

from harness.readers import images, trunk_bound_pct, trunk_dims
from harness.spec import flops


def read(ctx):
    work = flops("vit_swiglu").linear_work(*trunk_dims(ctx), images(ctx))
    return trunk_bound_pct(ctx, "vit_linear", work)
