"""Shared MIL building blocks, the port of ``acmil_tpu/models/common.py``
(reference: `architecture/network.py`, `architecture/transformer.py:239-266`).

Only what ABMIL and ACMIL_GA need. Module and parameter names are the
reference's, so a reference ``state_dict`` loads as it is and
``scripts/import_torch_checkpoint.py::convert_acmil_ga`` reads the port's.
All blocks are batched: bags are ``[B, N, D]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def torch_linear_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every ``nn.Linear`` in ``module`` from torch's default
    distribution, ``U(±1/sqrt(fan_in))`` for weight and bias, with
    ``generator``, so a seed alone fixes the weights."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
    return module


class Classifier1fc(nn.Module):
    """One-linear-layer classifier with optional dropout
    (`architecture/network.py:6`)."""

    def __init__(self, n_channels: int, n_classes: int, droprate: float = 0.0):
        super().__init__()
        self.fc = nn.Linear(n_channels, n_classes)
        self.dropout = nn.Dropout(droprate) if droprate > 0.0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout(x)
        return self.fc(x)


class DimReduction(nn.Module):
    """Bias-free linear + ReLU (`network.py:37`). Maps encoder features
    D_feat → D_inner. The reference's residual blocks (``numLayer_Res``)
    default to none and are not ported."""

    def __init__(self, n_channels: int, m_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(n_channels, m_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc1(x))


class AttentionGated(nn.Module):
    """Ilse-style gated attention scorer (`transformer.py:239-266`).

    Input ``[B, N, L]`` → attention logits ``[B, K, N]``.
    """

    def __init__(self, L: int = 128, D: int = 128, K: int = 1):
        super().__init__()
        self.attention_V = nn.Sequential(nn.Linear(L, D), nn.Tanh())
        self.attention_U = nn.Sequential(nn.Linear(L, D), nn.Sigmoid())
        self.attention_weights = nn.Linear(D, K)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attention_weights(self.attention_V(x) * self.attention_U(x))
        return a.transpose(-1, -2)
