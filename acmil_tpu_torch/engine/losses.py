"""Loss functions of the training slice, the port of
``acmil_tpu/engine/losses.py`` (ACMIL losses at
`Step3_WSI_classification_ACMIL.py:199-216`).

Padded batch rows are excluded through a ``valid`` vector (rows whose bag
mask is all False). Under an active mesh (``parallel/mesh.py::active``)
each data rank holds some rows of the batch, and each mean over the batch is
this rank's share of the global mean, ``sum_local w x / sum_global w``, as
the JAX losses over the global arrays are; the shares sum to it.
"""

from __future__ import annotations

import torch

from acmil_tpu_torch.ops.masked import masked_softmax
from acmil_tpu_torch.parallel.mesh import weighted_mean


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy. ``logits [B, C]``, ``labels [B]``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return weighted_mean(nll, valid)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor,
                                     valid: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Elementwise sigmoid cross-entropy from log-sigmoids, averaged: over
    every element, or over the elements of the rows ``valid [B]`` keeps (its
    shape broadcast over the trailing axes). Not sharded: the JAX function's
    plain mean, whatever mesh is active."""
    loss = -(targets * torch.nn.functional.logsigmoid(logits)
             + (1.0 - targets) * torch.nn.functional.logsigmoid(-logits))
    if valid is None:
        return loss.mean()
    w = valid.reshape(valid.shape + (1,) * (loss.dim() - valid.dim())
                      ).expand(loss.shape).to(loss.dtype)
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def attention_diversity_loss(attn_logits: torch.Tensor,
                             mask: torch.Tensor | None, n_token: int,
                             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean pairwise cosine similarity between branch attention maps
    (`Step3_WSI_classification_ACMIL.py:205-213`). ``attn_logits`` is
    ``[B, K, N]`` (GA) or ``[B, H, K, N]`` (MHA: a softmax and a similarity
    per head, then the mean over heads, as the reference's ``.mean()`` over
    the leading axis); masked positions get 0 probability."""
    if n_token <= 1:
        return torch.zeros((), dtype=attn_logits.dtype,
                           device=attn_logits.device)
    if attn_logits.dim() == 3:
        attn_logits = attn_logits[:, None]                           # [B, 1, K, N]
    m = None if mask is None else mask[:, None, None, :]
    p = masked_softmax(attn_logits, m)                               # [B, H, K, N]
    pn = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = pn @ pn.transpose(-1, -2)                                  # [B, H, K, K]
    iu = torch.triu(torch.ones(n_token, n_token, dtype=torch.bool,
                               device=sim.device), diagonal=1)
    per_bag = torch.where(iu, sim, 0.0).sum(dim=(-1, -2)) / (
        n_token * (n_token - 1) / 2)                                 # [B, H]
    per_bag = per_bag.mean(dim=1)                                    # [B]
    return weighted_mean(per_bag, valid)


def acmil_loss(sub_preds, slide_preds, attn_logits, labels, mask, n_token,
               valid=None):
    """loss = branch CE + slide CE + diversity (`Step3_ACMIL:199-216`).
    Returns (total, {"sub_loss", "slide_loss", "diff_loss"})."""
    if n_token > 1:
        b, k, c = sub_preds.shape
        loss0 = cross_entropy(sub_preds.reshape(b * k, c),
                              labels.repeat_interleave(k),
                              None if valid is None
                              else valid.repeat_interleave(k))
    else:
        loss0 = torch.zeros((), dtype=slide_preds.dtype,
                            device=slide_preds.device)
    loss1 = cross_entropy(slide_preds, labels, valid)
    div = attention_diversity_loss(attn_logits, mask, n_token, valid)
    return loss0 + loss1 + div, {"sub_loss": loss0, "slide_loss": loss1,
                                 "diff_loss": div}
