"""Work of a ViT trunk from its shapes, per image (2 x multiply-adds).

``flops_per_image`` is the useful operations of the whole trunk (the
arithmetic of the repository's ``scripts/bench_mfu.py::vit_flops_per_image``,
copied). ``linear`` lists the trunk's linear layers per image (qkv, proj,
fc1, fc2 of every block) as (rows, in, out); ``attention`` counts the
packed attention's products and bytes per image.
"""

from __future__ import annotations


def tokens(img: int, patch: int) -> int:
    return (img // patch) ** 2 + 1


def flops_per_image(img: int, patch: int, dim: int, depth: int,
                    hidden: int) -> int:
    n = tokens(img, patch)
    f = 2 * n * dim * (patch * patch * 3)              # patch embed
    per_layer = (2 * n * dim * 3 * dim                 # qkv
                 + 2 * n * n * dim                     # q k^T, all heads
                 + 2 * n * n * dim                     # p v
                 + 2 * n * dim * dim                   # out proj
                 + 4 * n * dim * hidden)               # fc1, fc2
    return f + depth * per_layer


def linear(img: int, patch: int, dim: int, depth: int, hidden: int):
    """(rows, in, out) of each linear layer of the blocks, one image."""
    n = tokens(img, patch)
    per = [(n, dim, 3 * dim), (n, dim, dim), (n, dim, hidden),
           (n, hidden, dim)]
    return per * depth


def linear_work(img: int, patch: int, dim: int, depth: int, hidden: int,
                images: int, bytes_per_el: int = 2):
    """(operations, bytes) of every linear layer over ``images`` images:
    each layer's input read once, its weight read once (once per layer, in
    the trunk's dtype), its output written once."""
    ops = nbytes = 0
    for m, k, n in linear(img, patch, dim, depth, hidden):
        ops += 2 * m * k * n * images
        nbytes += bytes_per_el * (m * k * images + k * n + m * n * images)
    return ops, nbytes


def attention_work(img: int, patch: int, dim: int, depth: int, images: int,
                   bytes_per_el: int = 2):
    """(operations, bytes) of the packed attention over ``images`` images:
    q k^T and p v over all heads; q, k, v read once and the output written
    once, in the trunk's dtype."""
    n = tokens(img, patch)
    ops = 4 * n * n * dim * depth * images
    nbytes = 4 * n * dim * bytes_per_el * depth * images
    return ops, nbytes
