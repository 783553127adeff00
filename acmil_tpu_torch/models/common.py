"""Shared MIL building blocks, the port of ``acmil_tpu/models/common.py``
(reference: `architecture/network.py`, `architecture/transformer.py:239-266`).

What ABMIL, ACMIL_GA and CLAM need. Module and parameter names are the
reference's, so a reference ``state_dict`` loads as it is and
``scripts/import_torch_checkpoint.py::convert_acmil_ga`` and
``convert_clam`` read the port's. All blocks are batched: bags are
``[B, N, D]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from acmil_tpu_torch.parallel.mesh import draw


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


def xavier_normal_init_(module: nn.Module,
                        generator: Optional[torch.Generator]) -> nn.Module:
    """Re-draw every ``nn.Linear`` in ``module`` as CLAM's reference
    initialises it (`utils/utils.py:519`): weights from a full normal of
    std ``sqrt(2 / (fan_in + fan_out))`` (torch's ``xavier_normal_``), biases
    zero, drawn with ``generator`` (torch's default one when None)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(2.0 / (m.in_features + m.out_features))
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout at rate ``p`` with its draws from ``generator``:
    each element kept with probability 1 - p and scaled by 1 / (1 - p).
    ``x``'s first axis is the batch: under an active mesh the global
    batch's draws are made (``parallel/mesh.py::draw``)."""
    keep = draw(x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Classifier1fc(nn.Module):
    """One-linear-layer classifier with optional dropout
    (`architecture/network.py:6`)."""

    def __init__(self, n_channels: int, n_classes: int, droprate: float = 0.0):
        super().__init__()
        self.fc = nn.Linear(n_channels, n_classes)
        self.dropout = nn.Dropout(droprate) if droprate > 0.0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the module's dropout in training, its draws from torch's default
        # generator through :func:`dropout`
        if self.dropout is not None and self.training:
            x = dropout(x, self.dropout.p)
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


class Attn_Net(nn.Module):
    """CLAM's ungated attention scorer (`architecture/clam.py:17`):
    ``module`` is Linear, Tanh, [Dropout,] Linear, as the reference names
    them. Input ``[B, N, L]`` → logits ``[B, K, N]``."""

    def __init__(self, L: int = 1024, D: int = 256, droprate: float = 0.0,
                 n_classes: int = 1):
        super().__init__()
        self.droprate = droprate
        layers = [nn.Linear(L, D), nn.Tanh()]
        if droprate > 0:
            layers.append(nn.Dropout(droprate))
        layers.append(nn.Linear(D, n_classes))
        self.module = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, drop: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``drop``: apply the dropout, with ``generator``'s draws."""
        h = torch.tanh(self.module[0](x))
        if drop and self.droprate > 0:
            h = dropout(h, self.droprate, generator)
        return self.module[-1](h).transpose(-1, -2)


class Attn_Net_Gated(nn.Module):
    """CLAM's gated attention scorer (`architecture/clam.py:46`):
    ``attention_a`` (Linear, Tanh, [Dropout]), ``attention_b`` (Linear,
    Sigmoid, [Dropout]) and ``attention_c``, as the reference names them.
    Input ``[B, N, L]`` → logits ``[B, K, N]``."""

    def __init__(self, L: int = 1024, D: int = 256, droprate: float = 0.0,
                 n_classes: int = 1):
        super().__init__()
        self.droprate = droprate
        a, b = [nn.Linear(L, D), nn.Tanh()], [nn.Linear(L, D), nn.Sigmoid()]
        if droprate > 0:
            a.append(nn.Dropout(droprate))
            b.append(nn.Dropout(droprate))
        self.attention_a = nn.Sequential(*a)
        self.attention_b = nn.Sequential(*b)
        self.attention_c = nn.Linear(D, n_classes)

    def forward(self, x: torch.Tensor, drop: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``drop``: apply the dropouts (on the tanh branch, then the sigmoid
        branch), with ``generator``'s draws."""
        av = torch.tanh(self.attention_a[0](x))
        au = torch.sigmoid(self.attention_b[0](x))
        if drop and self.droprate > 0:
            av = dropout(av, self.droprate, generator)
            au = dropout(au, self.droprate, generator)
        return self.attention_c(av * au).transpose(-1, -2)
