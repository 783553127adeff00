"""Kernel B5' (the packed attention) against its roofline, in %: the least
time of q k^T and p v over all heads and blocks of the traced patches
(flops/vit.py), the larger of operations over the trunk's stated peak and
bytes over the HBM rate, over the device time of kernels/vit_attn.json."""

from harness.readers import images, trunk_bound_pct, trunk_dims
from harness.spec import flops


def read(ctx):
    img, patch, dim, depth, _ = trunk_dims(ctx)
    return trunk_bound_pct(ctx, "vit_attn", flops("vit").attention_work(
        img, patch, dim, depth, images(ctx)))
