"""Smooth top-k SVM losses, the port of ``acmil_tpu/ops/topk_svm.py``
(reference: `modules/topk/`, whose ``SmoothTop1SVM`` CLAM's instance loss
may use, `modules/clam.py:5`).

For top-1 the smooth hinge is a temperature-τ log-sum-exp over the
margin-augmented scores,

    L(s, y) = τ · logsumexp_j((s_j + α·[j != y]) / τ) − s_y

and for k > 1 it is written with the elementary symmetric polynomials of
the scores' exponentials, in log space (:func:`log_elementary_symmetric`).
Every loss takes an optional ``valid`` weighting: the mean over valid rows
only, as the instance loss weights its gathered slots.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _weighted_mean(loss: torch.Tensor,
                   valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return loss.mean()
    w = valid.to(loss.dtype)
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def smooth_top1_svm_loss(scores: torch.Tensor, labels: torch.Tensor,
                         alpha: float = 1.0, tau: float = 1.0,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean smooth top-1 SVM loss. scores ``[..., C]``, labels ``[...]``
    int."""
    onehot = F.one_hot(labels.long(), scores.shape[-1]).to(scores.dtype)
    aug = scores + alpha * (1.0 - onehot)
    lse = tau * torch.logsumexp(aug / tau, dim=-1)
    loss = lse - (scores * onehot).sum(dim=-1)
    return _weighted_mean(loss, valid)


def _safe_logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``logaddexp`` whose gradient is 0, not NaN, where both arguments are
    -inf (the result log 0 = -inf stays exact)."""
    mx = torch.maximum(a, b)
    m = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    s = torch.exp(a - m) + torch.exp(b - m)
    pos = s > 0
    return torch.where(pos, m + torch.log(torch.where(pos, s,
                                                      torch.ones_like(s))),
                       torch.full_like(s, -torch.inf))


def log_elementary_symmetric(logx: torch.Tensor, k: int) -> torch.Tensor:
    """``log σ_j(exp(logx))`` for j = 0..k over the last axis, ``[..., k+1]``.

    The recurrence ``σ_j⁽ⁱ⁾ = σ_j⁽ⁱ⁻¹⁾ + x_i σ_{j-1}⁽ⁱ⁻¹⁾`` over the classes,
    in log space. Entries equal to -inf contribute a factor 0 (used to drop
    the ground-truth class)."""
    shape = logx.shape[:-1]
    neg = torch.full(shape + (1,), -torch.inf, dtype=logx.dtype,
                     device=logx.device)
    le = torch.cat([torch.zeros_like(neg), neg.expand(shape + (k,))], dim=-1)
    for i in range(logx.shape[-1]):
        prev = torch.cat([neg, le[..., :-1]], dim=-1)      # log σ_{j-1}
        le = _safe_logaddexp(le, logx[..., i:i + 1] + prev)
    return le


def smooth_topk_svm_loss(scores: torch.Tensor, labels: torch.Tensor, k: int,
                         alpha: float = 1.0, tau: float = 1.0,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean smooth top-k SVM loss (Berrada et al.; `Topk_Smooth_SVM`,
    `modules/topk/functional.py:46-72`). With s~ = s / (k τ) and y's entry
    dropped from the symmetric sums,

        L = τ · softplus(log σ_k + α/τ − log σ_{k−1} − s~_y)

    which is the top-1 closed form at k = 1."""
    if k == 1:
        return smooth_top1_svm_loss(scores, labels, alpha, tau, valid)
    onehot = F.one_hot(labels.long(), scores.shape[-1]).bool()
    x = scores / (k * tau)
    s_y = torch.where(onehot, x, torch.zeros_like(x)).sum(dim=-1)
    le = log_elementary_symmetric(
        torch.where(onehot, torch.full_like(x, -torch.inf), x), k)
    loss = tau * F.softplus(le[..., k] + alpha / tau - le[..., k - 1] - s_y)
    return _weighted_mean(loss, valid)


def topk_hard_svm_loss(scores: torch.Tensor, labels: torch.Tensor, k: int,
                       alpha: float = 1.0) -> torch.Tensor:
    """Hard top-k SVM (`Topk_Hard_SVM`, `modules/topk/functional.py:19-32`):
    ``clamp(mean(top-k of non-y scores + α) − (sum(top-(k−1) of non-y) +
    s_y) / k, 0)``, averaged."""
    onehot = F.one_hot(labels.long(), scores.shape[-1]).bool()
    s_y = torch.where(onehot, scores, torch.zeros_like(scores)).sum(dim=-1)
    top = torch.topk(torch.where(onehot, torch.full_like(scores, -torch.inf),
                                 scores), k, dim=-1).values
    max_1 = top.mean(dim=-1) + alpha
    max_2 = (top[..., :k - 1].sum(dim=-1) + s_y) / k
    return torch.clamp(max_1 - max_2, min=0.0).mean()
