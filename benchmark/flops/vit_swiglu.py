"""Work of a ViT trunk with a SwiGLU-packed MLP (Prov-GigaPath, DINOv2
ViT-g) from its shapes, per image (2 x multiply-adds).

``hidden`` is fc1's packed width (``mlp_hidden`` of the configuration): fc1
goes ``dim -> hidden``, SwiGLU halves it, fc2 goes ``hidden / 2 -> dim``.
``flops/vit.py`` counts fc2 at the packed width, ``4 n dim hidden``, which
is why this file exists. ``flops_per_image`` is the useful operations of
the whole trunk (the patch embed over the patches, then every block's
linear layers and attention; LayerNorms, softmax and SwiGLU's elementwise
work not counted); ``linear`` lists every block's linear layers as (rows,
in, out); ``fc1_work`` is fc1's alone, whose output the SwiGLU epilogue
writes at half width.
"""

from __future__ import annotations


def tokens(img: int, patch: int) -> int:
    return (img // patch) ** 2 + 1


def linear(img: int, patch: int, dim: int, depth: int, hidden: int):
    """(rows, in, out) of each linear layer of the blocks, one image:
    qkv, proj, fc1 (to the packed width), fc2 (from half of it)."""
    n = tokens(img, patch)
    per = [(n, dim, 3 * dim), (n, dim, dim), (n, dim, hidden),
           (n, hidden // 2, dim)]
    return per * depth


def flops_per_image(img: int, patch: int, dim: int, depth: int,
                    hidden: int) -> int:
    n = tokens(img, patch)
    embed = 2 * (n - 1) * dim * (patch * patch * 3)
    attention = 4 * n * n * dim * depth                # q k^T and p v
    return embed + attention + sum(2 * m * k * o for m, k, o in
                                   linear(img, patch, dim, depth, hidden))


def linear_work(img: int, patch: int, dim: int, depth: int, hidden: int,
                images: int, bytes_per_el: int = 2):
    """(operations, bytes) of every linear layer over ``images`` images:
    each layer's input read once, its weight read once (once per layer, in
    the trunk's dtype), its output written once (fc1's at half width: the
    SwiGLU epilogue writes silu(gate) * value)."""
    ops = nbytes = 0
    for m, k, o in linear(img, patch, dim, depth, hidden):
        written = o // 2 if (k, o) == (dim, hidden) else o
        ops += 2 * m * k * o * images
        nbytes += bytes_per_el * (m * k * images + k * o
                                  + m * written * images)
    return ops, nbytes


def fc1_work(img: int, patch: int, dim: int, depth: int, hidden: int,
             images: int, bytes_per_el: int = 2):
    """(operations, bytes) of fc1 with its SwiGLU epilogue over ``images``
    images: its input and weight read once, its half-width output written
    once."""
    n = tokens(img, patch)
    ops = 2 * n * dim * hidden * depth * images
    nbytes = bytes_per_el * depth * (n * dim * images + dim * hidden
                                     + n * (hidden // 2) * images)
    return ops, nbytes
