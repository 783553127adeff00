"""attMIL, attention MIL on a feature stem, the port of
``acmil_tpu/models/attmil.py`` (reference: `architecture/attmil.py`,
``AttentionGated:45``, ``DAttention:100``).

A stem (Linear to ``d_stem``, ReLU, [Dropout]) feeds gated or ungated
attention pooling and a linear classifier. Parameter names are the
reference's: ``feature.0``, ``attention.{0,2}`` (ungated) or
``attention_a.0``, ``attention_b.0``, ``attention_c`` (gated, bias-free as
in the JAX module), ``classifier.0``, which
``scripts/import_torch_checkpoint.py::convert_attmil`` reads. Weights are
xavier-normal with zero biases from an explicit ``torch.Generator``; dropout
runs only in a training forward, with the draws of the ``generator`` passed
in. The JAX module's ``act`` option (gelu stem, tanh gate), which no
registry build sets, is not ported: the stem and the gated branch use ReLU.
The end-to-end ``ResnetE2EMIL`` waits for the ResNet trunks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import dropout, xavier_normal_init_
from acmil_tpu_torch.ops.masked import masked_softmax


class DAttentionMIL(nn.Module):
    """Feature stem + (optionally gated) attention pooling + classifier
    (`attmil.py:100-143`)."""

    def __init__(self, n_class: int, d_feat: int = 384, d_stem: int = 512,
                 d_attn: int = 128, gated: bool = False,
                 droprate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gated, self.droprate = gated, droprate
        stem = [nn.Linear(d_feat, d_stem), nn.ReLU()]
        if droprate > 0:
            stem.append(nn.Dropout(droprate))
        self.feature = nn.Sequential(*stem)
        if gated:
            self.attention_a = nn.Sequential(
                nn.Linear(d_stem, d_attn, bias=False), nn.ReLU())
            self.attention_b = nn.Sequential(
                nn.Linear(d_stem, d_attn, bias=False), nn.Sigmoid())
            self.attention_c = nn.Linear(d_attn, 1, bias=False)
        else:
            self.attention = nn.Sequential(nn.Linear(d_stem, d_attn),
                                           nn.Tanh(), nn.Linear(d_attn, 1))
        self.classifier = nn.Sequential(nn.Linear(d_stem, n_class))
        xavier_normal_init_(self, generator)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.feature[0](_as_weight_dtype(feats, self)))
        if self.droprate > 0 and self.training and not deterministic:
            h = dropout(h, self.droprate, generator)
        if self.gated:
            a = self.attention_c(torch.relu(self.attention_a[0](h))
                                 * torch.sigmoid(self.attention_b[0](h)))
        else:
            a = self.attention[2](torch.tanh(self.attention[0](h)))
        a = a.transpose(-1, -2)                                   # [B, 1, N]
        attn = masked_softmax(a, None if mask is None else mask[:, None, :])
        return self.classifier((attn @ h)[:, 0])
