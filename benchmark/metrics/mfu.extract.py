"""The whole step's share of the card's stated peak, in %: the trunk's
useful operations per patch (flops/vit.py) times the traced patches, over
the window's time at the peak of the trunk's stated dtype."""

from harness.readers import images, trunk_dims
from harness.spec import flops


def read(ctx):
    img, patch, dim, depth, hidden = trunk_dims(ctx)
    per_image = flops("vit").flops_per_image(img, patch, dim, depth, hidden)
    total = per_image * images(ctx)
    peak = ctx.peaks()[ctx.cell.config["trunk"]["peak"]]
    return 100.0 * total / (ctx.trace.window_s * peak)
