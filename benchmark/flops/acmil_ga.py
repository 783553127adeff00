"""Work of the ACMIL_GA head from its shapes, at a bag's valid length ``n``.

``b1`` and ``b2`` count what kernels B1 (the gated attention pooling) and
B2 (its backward, weight gradients only) must do for one fp16 bag, as the
kernel table of ``PERF.md`` counts it (each input read once, each output
written once; f32 weights): the least work, whatever kernel computes it.
``train_flops`` and ``eval_flops`` are the head's useful operations
(2 x multiply-adds): the forward, and in training the backward of every
product but the features' (which need no gradient).
"""

from __future__ import annotations


def _weights(df: int, l: int, a: int, k: int) -> int:
    return df * l + l + 2 * (l * a + a) + a * k + k


def b1(n: int, df: int, l: int, a: int, k: int):
    """(operations, bytes) of B1 on one bag: x W1, both gates, the logits
    and the pooling; reads features, mask and weights, writes the logits,
    the pooled bag and the softmax statistics."""
    ops = 2 * n * (df * l + 2 * l * a + a * k + k * l)
    nbytes = n * df * 2 + n + 4 * _weights(df, l, a, k) + 4 * (
        k * n + k * l + 2 * k)
    return ops, nbytes


def b2(n: int, df: int, l: int, a: int, k: int):
    """(operations, bytes) of B2 on one bag, weight gradients only: the
    forward's recompute and the backward's products; reads features, mask,
    weights and the upstream gradients, writes the weight gradients."""
    ops = 2 * n * (2 * df * l + 6 * l * a + 3 * a * k + 2 * l * k)
    nbytes = n * df * 2 + n + 8 * _weights(df, l, a, k) + 4 * (
        2 * k + k * l + k * n)
    return ops, nbytes


def bound_s(ops: float, nbytes: float, peak_flops: float,
            bytes_per_s: float) -> float:
    """The least time: the larger of operations over the peak and bytes
    over the memory's rate."""
    return max(ops / peak_flops, nbytes / bytes_per_s)


def eval_flops(n: int, df: int, l: int, a: int, k: int, c: int) -> int:
    """One bag's forward: dim-reduction, gates, logits, pooling, the K
    branch classifiers and the slide classifier."""
    return 2 * n * (df * l + 2 * l * a + a * k + k * l) + 2 * (k + 1) * l * c


def train_flops(n: int, df: int, l: int, a: int, k: int, c: int) -> int:
    """One bag's step: the forward, then the backward of each product: the
    weight gradient of x W1 (the features need none), both gradients of
    the gates, the logits, the pooling and the classifiers."""
    fwd = eval_flops(n, df, l, a, k, c)
    bwd = 2 * n * df * l + 2 * (2 * n * (2 * l * a + a * k + k * l)) + 2 * (
        2 * (k + 1) * l * c)
    return fwd + bwd
