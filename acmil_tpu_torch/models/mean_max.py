"""Mean and max pooling MIL baselines, the port of
``acmil_tpu/models/mean_max.py`` (reference: `modules/mean_max.py:14,39`).

A per-patch MLP (Linear, ReLU, [Dropout,] Linear) gives per-patch class
logits, pooled over the valid patches by a masked mean or a masked max.
(The JAX module's gelu option, which no registry build sets, is not
ported.)
The MLP is ``head``, a Sequential as the reference names it, so a reference
checkpoint loads as it is and
``scripts/import_torch_checkpoint.py::convert_mean_max`` reads the port's.
Weights are the reference's ``initialize_weights``: xavier-normal, zero
biases, from an explicit ``torch.Generator``. Dropout runs only in a
training forward, with the draws of the ``generator`` passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import dropout, xavier_normal_init_
from acmil_tpu_torch.ops.masked import masked_max, masked_mean


class _PoolMIL(nn.Module):
    pool = "mean"

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 droprate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.droprate = droprate
        layers = [nn.Linear(d_feat, d_inner), nn.ReLU()]
        if droprate > 0:
            layers.append(nn.Dropout(droprate))
        layers.append(nn.Linear(d_inner, n_class))
        self.head = nn.Sequential(*layers)
        xavier_normal_init_(self, generator)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.head[0](_as_weight_dtype(feats, self)))
        if self.droprate > 0 and self.training and not deterministic:
            h = dropout(h, self.droprate, generator)
        h = self.head[-1](h)                                      # [B, N, C]
        if self.pool == "mean":
            return masked_mean(h, mask, dim=1)
        return masked_max(h, mask, dim=1)


class MeanMIL(_PoolMIL):
    pool = "mean"


class MaxMIL(_PoolMIL):
    pool = "max"
