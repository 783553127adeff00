"""The whole step's share of the card's stated peak for a SwiGLU trunk, in
%: the trunk's useful operations per patch (flops/vit_swiglu.py, fc2 at
half of fc1's packed width) times the traced patches, over the window's
time at the peak of the trunk's stated dtype."""

from harness.readers import images, trunk_dims
from harness.spec import flops


def read(ctx):
    per_image = flops("vit_swiglu").flops_per_image(*trunk_dims(ctx))
    peak = ctx.peaks()[ctx.cell.config["trunk"]["peak"]]
    return 100.0 * per_image * images(ctx) / (ctx.trace.window_s * peak)
