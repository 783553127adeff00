"""LBMIL, closed-form attention from the classifier's own weights, the port
of ``acmil_tpu/models/lbmil.py`` (reference: `architecture/lbmil.py:8-40`).

Per-patch class logits come from the bag classifier; a patch's attention is
``Σ_c exp(logit_ic − max)``, normalised over the bag; the attention-weighted
feature sum goes through the same classifier. Masked slots take a finite
``-1e30`` fill (not ``-inf``), so a bag with every slot masked gives finite
outputs and gradients. Parameter names are the reference's
(``dimreduction.fc1``, ``classifier``), which
``scripts/import_torch_checkpoint.py::convert_lbmil`` reads; weights are
torch ``nn.Linear``'s default draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import DimReduction, torch_linear_init_


class LBMIL(nn.Module):
    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.classifier = nn.Linear(d_inner, n_class)
        torch_linear_init_(self, generator)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        out_c = self.classifier(x)                                # [B, N, C]
        out_m = out_c if mask is None else torch.where(
            mask[..., None], out_c, torch.full_like(out_c, -1e30))
        gmax = out_m.amax(dim=(1, 2), keepdim=True)
        score = torch.exp(out_m - gmax).sum(dim=-1)               # [B, N]
        alpha = score / score.sum(dim=1, keepdim=True).clamp_min(1e-12)
        return self.classifier(torch.einsum("bn,bnl->bl", alpha, x))
