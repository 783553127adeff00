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

``ResnetE2EMIL`` is the end-to-end patch-pixel model (no registry build, as
in the JAX package): the port's ResNet-50 trunk with frozen batch-norm
statistics, an MLP stem 2048 → 4096 → 512 → ``n_class`` with dropout, and
the masked max over the bag's patches.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import dropout, xavier_normal_init_
from acmil_tpu_torch.ops.masked import masked_max, masked_softmax


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


class ResnetE2EMIL(nn.Module):
    """End-to-end patch-pixel MIL (`architecture/attmil.py:17-44`,
    ``Resnet``; the JAX ``ResnetE2EMIL``): ``patches [B, N, H, W, 3]``
    through ResNet-50 (``models/encoders/resnet.py``: batch norm on frozen
    statistics, trainable affine), ``fc1`` 2048 → 4096, ReLU, dropout,
    ``fc2`` 4096 → 512, ReLU, dropout, ``fc3`` 512 → ``n_class`` per patch,
    then the masked max over N → ``[B, n_class]``. Dropout runs in a
    training forward, drawn from ``generator``."""

    def __init__(self, n_class: int, droprate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from acmil_tpu_torch.models.encoders.resnet import resnet50

        self.droprate = droprate
        self.resnet = resnet50()
        self.fc1 = nn.Linear(self.resnet.embed_dim, 4096)
        self.fc2 = nn.Linear(4096, 512)
        self.fc3 = nn.Linear(512, n_class)
        xavier_normal_init_(self, generator)

    def forward(self, patches, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, n = patches.shape[:2]
        feats = self.resnet(patches.reshape((b * n,) + patches.shape[2:]))
        h = feats.reshape(b, n, -1)
        drop = self.training and not deterministic and self.droprate
        for fc in (self.fc1, self.fc2):
            h = torch.relu(fc(h))
            if drop:
                h = dropout(h, self.droprate, generator)
        return masked_max(self.fc3(h), mask, dim=1)
