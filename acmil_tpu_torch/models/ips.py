"""IPS, Iterative Patch Selection, the port of ``acmil_tpu/models/ips.py``
(reference: `architecture/ips_net.py:13-244`, dead code upstream).

A gated-attention scorer ranks every patch with no gradient; the top-``M``
valid patches are kept; gated attention pooling over the kept M and a
linear classifier give the logits. The JAX module streams the bag through
a ``lax.scan`` of ``chunk``-sized pieces with a running top-M buffer; the
top-M of (buffer ∪ chunk), chunk after chunk, is the top-M of the whole
bag's scores, so the port selects with one ``torch.topk`` over ``[B, N]``.
The two differ only where scores tie exactly at the cutoff. Masked slots
score ``NEG_INF`` and keep their mask, so a kept pad stays inert; a bag of
at most M patches keeps them all. With no stream there is no chunk: the
config's ``ips_chunk``, which sets the JAX module's, is ignored.

The scorer's parameters get no gradient (the JAX module stop-gradients its
output); the trainer gives them a zero one, so AdamW still decays them as
optax does. IPS has no reference checkpoint: the port names its modules
``dimreduction``, ``scorer``, ``attention`` and ``classifier``. Weights are
torch ``nn.Linear``'s default draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import (AttentionGated, Classifier1fc,
                                           DimReduction, torch_linear_init_)
from acmil_tpu_torch.ops.masked import masked_fill, masked_softmax


class IPSNet(nn.Module):
    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 d_attn: int = 128, m_keep: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.m_keep = m_keep
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.scorer = AttentionGated(d_inner, d_attn, 1)
        self.attention = AttentionGated(d_inner, d_attn, 1)
        self.classifier = Classifier1fc(d_inner, n_class)
        torch_linear_init_(self, generator)

    def select(self, x, mask):
        """``(x [B, M, L], mask [B, M])`` of the top-M scored valid rows, or
        the whole bag when it has at most M rows."""
        b, n, _ = x.shape
        if n <= self.m_keep:
            return x, mask
        with torch.no_grad():
            score = masked_fill(self.scorer(x)[:, 0], mask)      # [B, N]
            idx = torch.topk(score, self.m_keep, dim=1).indices  # [B, M]
        rows = torch.arange(b, device=x.device)[:, None]
        return x[rows, idx], mask[rows, idx]

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        sel_x, sel_mask = self.select(x, mask)
        a = self.attention(sel_x)                                 # [B, 1, M]
        attn = masked_softmax(a, sel_mask[:, None, :])
        return self.classifier((attn @ sel_x)[:, 0])
