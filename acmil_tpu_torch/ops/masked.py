"""Masked numerics over padded bags, the port of ``acmil_tpu/ops/masked.py``.

Shapes use ``...`` for leading batch/branch axes; the masked axis is last
(``dim=-1``) unless stated.

STKIM's uniforms (``stkim_drop``'s ``u``) are drawn from a
``torch.Generator``, or passed in: the JAX package draws them with
``jax.random.uniform``, whose bits torch cannot reproduce, so a test hands
both packages the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from acmil_tpu_torch.parallel.mesh import draw

# Matches the reference's masked_fill value (transformer.py:320). Large but
# finite so the softmax stays NaN-free even when a row is fully masked.
NEG_INF = -1e9


def masked_fill(x: torch.Tensor, mask: torch.Tensor, value: float = NEG_INF) -> torch.Tensor:
    """Where ``mask`` is False, replace with ``value``. mask broadcasts to x.
    The fill value is made on ``x``'s device: a host scalar tensor would be
    a copy from pageable host memory, which a CUDA graph cannot hold."""
    return torch.where(mask, x, x.new_full((), value))


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


def masked_topk_mask(scores: torch.Tensor, k: int,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean mask selecting the top-k valid entries along the last axis
    (`transformer.py:314-319`'s ``topk`` + ``scatter_``). Masked entries
    never make the top-k."""
    if mask is not None:
        scores = masked_fill(scores, mask)
    idx = torch.topk(scores, k, dim=-1).indices
    out = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    out.scatter_(-1, idx, True)
    if mask is not None:
        out = out & mask
    return out


def stkim_mask(attn_logits: torch.Tensor, n_masked_patch: int,
               mask_drop: float, mask: torch.Tensor | None = None,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic Top-K Instance Masking (ACMIL, `transformer.py:311-320`):
    logits ``[..., K, N]`` with a random ``floor(k * mask_drop)``-subset of
    each branch's top-``n_masked_patch`` positions filled with NEG_INF.
    ``mask`` is ``[..., 1, N]`` or ``[..., K, N]`` validity."""
    drop, _ = stkim_drop(attn_logits, n_masked_patch, mask_drop, mask, u,
                         generator)
    if drop is None:
        return attn_logits
    return masked_fill(attn_logits, ~drop)


def stkim_drop(attn_logits: torch.Tensor, n_masked_patch: int,
               mask_drop: float, mask: torch.Tensor | None = None,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The STKIM selection: ``(drop [..., K, N] bool, topk_idx [..., K, k])``,
    or ``(None, None)`` when STKIM is a no-op.

    ``u`` holds the uniforms ``[..., K, N]`` in [0, 1); without it they are
    drawn with ``generator`` (torch's default generator when None), the
    global batch's under an active mesh (``parallel/mesh.py::draw``). The
    top-k runs on detached scores.
    """
    n = attn_logits.shape[-1]
    k = min(n_masked_patch, n)
    n_drop_max = int(k * mask_drop)
    if k <= 0 or n_drop_max <= 0:
        return None, None
    scores = attn_logits.detach()
    if mask is not None:
        scores = masked_fill(scores, mask)
    topk_idx = torch.topk(scores, k, dim=-1).indices
    topk = torch.zeros(attn_logits.shape, dtype=torch.bool,
                       device=attn_logits.device)
    topk.scatter_(-1, topk_idx, True)
    # the reference clamps k by the real bag length (`transformer.py:313`);
    # a padded bag clamps by its valid count, or a bag with fewer than k
    # valid patches would drop floor(k * mask_drop) of them
    if mask is not None:
        topk = topk & mask
        k_eff = torch.clamp(mask.sum(dim=-1), max=k)           # [..., 1|K]
    else:
        k_eff = torch.full(attn_logits.shape[:-1], k,
                           device=attn_logits.device)
    n_drop = torch.floor(k_eff * mask_drop).to(torch.int64)
    n_drop = n_drop.expand(attn_logits.shape[:-1])
    # rank trick: the top-k positions compete on iid uniforms and the
    # n_drop smallest are dropped, a uniform random n_drop-subset
    if u is None:
        u = draw(attn_logits.shape, generator, attn_logits.device)
    elif tuple(u.shape) != tuple(attn_logits.shape):
        raise ValueError(f"u must have the logits' shape "
                         f"{tuple(attn_logits.shape)}, got {tuple(u.shape)}")
    u = torch.where(topk, u.to(torch.float32), torch.inf)
    smallest = torch.topk(-u, n_drop_max, dim=-1).values     # [..., n_drop_max]
    idx = torch.clamp(n_drop - 1, 0, n_drop_max - 1)[..., None]
    threshold = torch.gather(smallest, -1, idx)              # [..., 1]
    drop = topk & (-u >= threshold) & (n_drop[..., None] > 0)
    return drop, topk_idx


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
