"""ABMIL, MHA and ACMIL (GA and MHA variants), the port of
``acmil_tpu/models/acmil.py``.

Reference: `architecture/transformer.py` — `ABMIL:270`, `MHA:86`,
`ACMIL_GA:291`, `ACMIL_MHA:50`, `MutiHeadAttention:107`,
`MutiHeadAttention_modify:187`. Batched over ``[B, N_pad, D]`` bags with
validity masks (the reference unbatches with ``x[0]``). Call convention:
``model(feats [B,N,D], mask [B,N] | None, deterministic=True)``.

The training forwards of ACMIL_GA and ACMIL_MHA apply STKIM
(``ops/masked.py::stkim_mask``) with uniforms passed in (``stkim_u``) or
drawn from ``stkim_generator``. ACMIL_MHA's K branches are K modules
``sub_attention.{k}``, the reference's names, so a reference checkpoint
loads as it is; the JAX package stacks them into one vmapped module.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.common import (AttentionGated, Classifier1fc,
                                           DimReduction, dropout)
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
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
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


class MultiHeadAttention(nn.Module):
    """Q/K/V multi-head cross-attention with optional STKIM inside the
    logits (`transformer.py:107-236`). Queries are few (1..K tokens); keys
    and values are the bag. Returns ``(out [B, Q, dim], logits
    [B, H, Q, N])``, the logits after STKIM when it applied. The JAX
    module's ``downsample_rate``, which no head sets, is not ported."""

    def __init__(self, dim: int, num_heads: int = 8, droprate: float = 0.1,
                 n_masked_patch: int = 0, mask_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.droprate = droprate
        self.n_masked_patch = n_masked_patch
        self.mask_drop = mask_drop
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        # flax's LayerNorm epsilon, which the JAX package keeps
        self.layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        b, n, d = t.shape
        return t.reshape(b, n, self.num_heads, d // self.num_heads
                         ).transpose(1, 2)                        # [B, H, n, dh]

    def forward(self, q, k, v, mask=None, deterministic: bool = True,
                use_attention_mask: bool = False,
                stkim_u: Optional[torch.Tensor] = None,
                stkim_generator: Optional[torch.Generator] = None):
        """``stkim_u [B, H, Q, N]`` are STKIM's uniforms; without them STKIM
        draws from ``stkim_generator``."""
        qh = self._split(self.q_proj(q))
        kh = self._split(self.k_proj(k))
        vh = self._split(self.v_proj(v))
        logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        m = None if mask is None else mask[:, None, None, :]
        if self.n_masked_patch > 0 and use_attention_mask:
            logits = stkim_mask(logits, self.n_masked_patch, self.mask_drop,
                                m, stkim_u, stkim_generator)
        attn = masked_softmax(logits, m)                          # [B, H, Q, N]
        out = (attn @ vh).transpose(1, 2).flatten(2)              # [B, Q, dim]
        out = self.out_proj(out)
        if self.training and not deterministic and self.droprate > 0:
            out = dropout(out, self.droprate)
        return self.layer_norm(out), logits


class BagAttention(nn.Module):
    """Value-only head that pools the bag with attention given from outside
    (`MutiHeadAttention_modify`, `transformer.py:187-236`)."""

    def __init__(self, dim: int, num_heads: int = 8, droprate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.droprate = droprate
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, v, attn, deterministic: bool = True):
        """``v [B, N, dim]``, ``attn [B, H, Q, N]`` → the first query's
        pooled feature ``[B, dim]``."""
        b, n, d = v.shape
        vh = self.v_proj(v).reshape(b, n, self.num_heads,
                                    d // self.num_heads).transpose(1, 2)
        out = (attn @ vh).transpose(1, 2).flatten(2)              # [B, Q, dim]
        out = self.out_proj(out)
        if self.training and not deterministic and self.droprate > 0:
            out = dropout(out, self.droprate)
        return self.layer_norm(out)[:, 0]


class MHA(nn.Module):
    """Single learned-query multi-head attention baseline
    (`transformer.py:86-105`)."""

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 num_heads: int = 8, droprate: float = 0.1):
        super().__init__()
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.q = nn.Parameter(torch.empty(1, 1, d_inner))
        nn.init.normal_(self.q, std=1e-6)
        self.attention = MultiHeadAttention(d_inner, num_heads,
                                            droprate=droprate)
        self.classifier = Classifier1fc(d_inner, n_class)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        q = self.q.expand(x.shape[0], -1, -1)
        out, _ = self.attention(q, x, x, mask, deterministic)
        return self.classifier(out[:, 0])


class ACMIL_MHA(nn.Module):
    """ACMIL with K learned-query cross-attention branches
    (`transformer.py:50-84`).

    Returns ``(sub_preds [B,K,C], slide_preds [B,C], attn [B,H,K,N])``:
    per-head attention logits, after STKIM in training, the reference's
    ``attns`` layout (the diversity loss averages over heads). The slide
    pools the bag with the branches' mean softmax, per head.
    """

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 n_token: int = 1, num_heads: int = 8, n_masked_patch: int = 0,
                 mask_drop: float = 0.0, droprate: float = 0.1):
        super().__init__()
        self.n_masked_patch = n_masked_patch
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.q = nn.Parameter(torch.empty(1, n_token, d_inner))
        nn.init.normal_(self.q, std=1e-6)
        self.sub_attention = nn.ModuleList(
            MultiHeadAttention(d_inner, num_heads, droprate=droprate,
                               n_masked_patch=n_masked_patch,
                               mask_drop=mask_drop)
            for _ in range(n_token))
        self.bag_attention = BagAttention(d_inner, num_heads, droprate)
        self.classifier = nn.ModuleList(
            Classifier1fc(d_inner, n_class) for _ in range(n_token))
        self.Slide_classifier = Classifier1fc(d_inner, n_class)

    def forward(self, feats, mask=None, deterministic: bool = True,
                use_attention_mask: Optional[bool] = None,
                stkim_u: Optional[torch.Tensor] = None,
                stkim_generator: Optional[torch.Generator] = None):
        """``stkim_u [B, H, K, N]`` are STKIM's uniforms (branch k takes
        ``[:, :, k]``); without them each branch draws its own from
        ``stkim_generator``, in branch order."""
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        apply_stkim = ((not deterministic) if use_attention_mask is None
                       else use_attention_mask)
        apply_stkim = apply_stkim and self.n_masked_patch > 0
        q = self.q.expand(x.shape[0], -1, -1)                     # [B, K, L]
        feats_k, logits_k = [], []
        for k, branch in enumerate(self.sub_attention):
            u = None if stkim_u is None else stkim_u[:, :, k:k + 1]
            out, logits = branch(q[:, k:k + 1], x, x, mask, deterministic,
                                 apply_stkim, u, stkim_generator)
            feats_k.append(out[:, 0])
            logits_k.append(logits[:, :, 0])
        attn = torch.stack(logits_k, dim=2)                       # [B, H, K, N]
        sub_preds = torch.stack(
            [head(f) for head, f in zip(self.classifier, feats_k)], dim=1)
        m = None if mask is None else mask[:, None, None, :]
        bag_attn = masked_softmax(attn, m).mean(dim=2, keepdim=True)
        bag_feat = self.bag_attention(x, bag_attn, deterministic)
        return sub_preds, self.Slide_classifier(bag_feat), attn
