"""Positional embeddings of the bag transformers, the port of
``acmil_tpu/models/emb_position.py``: ``PEG`` (one depthwise conv),
``sincos_2d`` and ``SINCOS`` (a fixed 2-D sin-cos table). The pyramid
``PPEG`` lives in :mod:`acmil_tpu_torch.models.transmil`. These are the
``pos`` options of MHIM's SAttention (`modules/satten.py:40-48`).

Bodies are ``[B, N, C]`` seen as a ``C x grid_h x grid_w`` image, N =
grid_h · grid_w.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def torch_conv_init_(conv: nn.Conv2d,
                     generator: Optional[torch.Generator]) -> nn.Conv2d:
    """Re-draw ``conv`` from torch's default distribution, ``U(±1/sqrt(
    fan_in))`` for weight and bias (fan_in = in_channels/groups · kh · kw),
    with ``generator``."""
    w = conv.weight
    bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def _grid_image(x: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.transpose(1, 2).reshape(b, c, grid_h, grid_w)


class PEG(nn.Module):
    """One depthwise ``k x k`` conv with bias over the grid view, added to
    the input (`emb_position.py:41`); ``proj`` as the reference names it."""

    def __init__(self, dim: int, k: int = 7,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = torch_conv_init_(
            nn.Conv2d(dim, dim, k, 1, k // 2, groups=dim), generator)

    def forward(self, x: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
        b, n, c = x.shape
        out = self.proj(_grid_image(x, grid_h, grid_w))
        return x + out.reshape(b, c, n).transpose(1, 2)


def sincos_2d(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """The 2-D sin-cos table ``[grid_h · grid_w, embed_dim]``
    (`emb_position.py:66-141`), computed in float64 and returned as float32,
    as in the JAX package."""
    def one_dim(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (dim / 2))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_h, dtype=np.float32)
    gw = np.arange(grid_w, dtype=np.float32)
    grid = np.meshgrid(gw, gh)  # (w, h) order like the reference
    emb_h = one_dim(embed_dim // 2, np.stack(grid)[1])
    emb_w = one_dim(embed_dim // 2, np.stack(grid)[0])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


class SINCOS(nn.Module):
    """The fixed 2-D sin-cos embedding, added to the input; no parameters.
    The table is kept on the input's device per grid shape."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self._tables = {}

    def forward(self, x: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
        key = (grid_h, grid_w, x.device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                sincos_2d(self.dim, grid_h, grid_w)).to(x.device)
        table = self._tables[key]
        return x + table[None, : x.shape[1]].to(x.dtype)
