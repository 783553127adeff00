"""Masked numerics over padded bags, the port of ``acmil_tpu/ops/masked.py``.

Shapes use ``...`` for leading batch/branch axes; the masked axis is last
(``dim=-1``) unless stated. STKIM (``stkim_mask``/``stkim_drop``) comes with
the training slice.
"""

from __future__ import annotations

import torch

# Matches the reference's masked_fill value (transformer.py:320). Large but
# finite so the softmax stays NaN-free even when a row is fully masked.
NEG_INF = -1e9


def masked_fill(x: torch.Tensor, mask: torch.Tensor, value: float = NEG_INF) -> torch.Tensor:
    """Where ``mask`` is False, replace with ``value``. mask broadcasts to x."""
    return torch.where(mask, x, torch.as_tensor(value, dtype=x.dtype))


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor | None, dim: int = -1) -> torch.Tensor:
    """Softmax that assigns exactly 0 probability to masked positions.

    Stable for fully-masked rows (returns all zeros rather than NaN).
    """
    if mask is None:
        return torch.softmax(logits, dim=dim)
    x = masked_fill(logits, mask)
    x = x - x.amax(dim=dim, keepdim=True).detach()
    ex = torch.exp(x) * mask.to(logits.dtype)
    denom = ex.sum(dim=dim, keepdim=True)
    return ex / denom.clamp_min(1e-12)


def softmax_one(logits: torch.Tensor, mask: torch.Tensor | None = None, dim: int = -1) -> torch.Tensor:
    """'softmax_one' / quiet-softmax: a virtual zero logit joins the
    denominator so attention may attend to nothing (reference
    `utils/utils.py:54`, used by CLAM_MB at `architecture/clam.py:248`)."""
    x = logits if mask is None else masked_fill(logits, mask)
    # stabilise around m = max(max(x), 0) so the virtual zero logit is
    # included in the max
    m = x.amax(dim=dim, keepdim=True).clamp_min(0.0).detach()
    ex = torch.exp(x - m)
    if mask is not None:
        ex = ex * mask.to(x.dtype)
    denom = ex.sum(dim=dim, keepdim=True) + torch.exp(-m)
    return ex / denom


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None, dim: int = -2) -> torch.Tensor:
    """Mean over the patch axis counting only valid entries."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask.unsqueeze(-1).to(x.dtype)
    s = (x * m).sum(dim=dim)
    n = m.sum(dim=dim).clamp_min(1.0)
    return s / n


def masked_max(x: torch.Tensor, mask: torch.Tensor | None, dim: int = -2) -> torch.Tensor:
    """Max over the patch axis ignoring padded entries."""
    if mask is None:
        return x.amax(dim=dim)
    return masked_fill(x, mask.unsqueeze(-1)).amax(dim=dim)
