"""ABMIL and ACMIL_GA, the port of ``acmil_tpu/models/acmil.py``.

Reference: `architecture/transformer.py` — `ABMIL:270`, `ACMIL_GA:291`.
Batched over ``[B, N_pad, D]`` bags with validity masks (the reference
unbatches with ``x[0]``). Call convention:
``model(feats [B,N,D], mask [B,N] | None, deterministic=True)``.

ACMIL_GA's training forward applies STKIM (``ops/masked.py::stkim_mask``)
with uniforms passed in (``stkim_u``) or drawn from ``stkim_generator``.
ACMIL_MHA and MHA are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.common import (AttentionGated, Classifier1fc,
                                           DimReduction)
from acmil_tpu_torch.ops.masked import masked_softmax, stkim_mask


def _as_weight_dtype(feats: torch.Tensor, module: nn.Module) -> torch.Tensor:
    # bags cross to the device in fp16; the heads compute in their weights'
    # dtype, as the JAX heads promote fp16 features to f32
    return feats.to(next(module.parameters()).dtype)


class ABMIL(nn.Module):
    """Gated-attention pooling baseline (`transformer.py:270-287`)."""

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 d_attn: int = 128, droprate: float = 0.0):
        super().__init__()
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.attention = AttentionGated(d_inner, d_attn, 1)
        self.classifier = Classifier1fc(d_inner, n_class, droprate)

    def forward(self, feats, mask=None, deterministic: bool = True,
                return_attn: bool = False):
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        a = self.attention(x)                                     # [B, 1, N]
        attn = masked_softmax(a, None if mask is None else mask[:, None, :])
        afeat = (attn @ x)[:, 0]                                  # [B, L]
        logits = self.classifier(afeat)
        if return_attn:
            return logits, a
        return logits


class ACMIL_GA(nn.Module):
    """Multi-branch gated attention (`transformer.py:291-354`).

    Returns ``(sub_preds [B,K,C], slide_preds [B,C], attn_logits [B,K,N])``
    where ``attn_logits`` are the raw logits, after STKIM in training (the
    reference's ``A_out``).
    """

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 d_attn: int = 128, n_token: int = 1, n_masked_patch: int = 0,
                 mask_drop: float = 0.0, droprate: float = 0.0):
        super().__init__()
        self.n_masked_patch = n_masked_patch
        self.mask_drop = mask_drop
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.attention = AttentionGated(d_inner, d_attn, n_token)
        self.classifier = nn.ModuleList(
            Classifier1fc(d_inner, n_class, droprate) for _ in range(n_token))
        self.Slide_classifier = Classifier1fc(d_inner, n_class, droprate)

    def forward(self, feats, mask=None, deterministic: bool = True,
                use_attention_mask: Optional[bool] = None,
                stkim_u: Optional[torch.Tensor] = None,
                stkim_generator: Optional[torch.Generator] = None):
        """``stkim_u [B, K, N]`` are STKIM's uniforms; without them STKIM
        draws from ``stkim_generator`` (torch's default one when None)."""
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        a = self.attention(x)                                     # [B, K, N]
        apply_stkim = (not deterministic) if use_attention_mask is None else use_attention_mask
        if self.n_masked_patch > 0 and apply_stkim:
            a = stkim_mask(a, self.n_masked_patch, self.mask_drop,
                           None if mask is None else mask[:, None, :],
                           stkim_u, stkim_generator)
        attn = masked_softmax(a, None if mask is None else mask[:, None, :])
        branch_feat = attn @ x                                    # [B, K, L]
        sub_preds = torch.stack(
            [head(branch_feat[:, k]) for k, head in enumerate(self.classifier)],
            dim=1)                                                # [B, K, C]
        # slide pooling reuses the SAME branch softmax, mean over branches
        # (`transformer.py:328`: bag_A = softmax(A_out).mean(0))
        bag_feat = (attn.mean(dim=1, keepdim=True) @ x)[:, 0]     # [B, L]
        slide_preds = self.Slide_classifier(bag_feat)
        return sub_preds, slide_preds, a
