"""IBMIL, interventional bag MIL with a confounder dictionary, the port of
``acmil_tpu/models/ibmil.py`` (reference: `architecture/ibmil.py:38-110` and
the two-phase protocol of `Step3_WSI_classification_IBMIL.py`).

Phase 1 (no dictionary): DimReduction → AttentionGated → masked softmax →
bag feature → Classifier1fc. Phase 2 (``confounders`` given, the k-means
prototypes of ``ops/kmeans.py``): the bag feature queries the dictionary
through ``W_q``/``W_k``; the softmax over prototypes pools a confounder
feature, merged into the bag feature by ``cat``, ``add`` or ``sub``
(`ibmil.py:90-107`). The dictionary is a registered buffer, or a parameter
with ``confounder_learn``; either way it is ``confounder_feat`` in the
state dict.

The forward returns the JAX module's dict: ``attn`` (raw logits
``[B, 1, N]``), ``bag_feat`` ``[B, L]``, ``logits``, and in phase 2
``deconf_attn`` ``[B, P]``. Parameter names are the reference's
(``dimreduction.fc1``, ``attention``, ``classifier.fc``, ``W_q``, ``W_k``);
``scripts/import_torch_checkpoint.py::convert_ibmil`` reads a phase-1 state
dict. Weights are torch ``nn.Linear``'s default draws from an explicit
``torch.Generator``. The JAX module's classifier dropout, which the
registry leaves at 0, and its learned dictionary drawn from N(0, 1) when no
prototypes are given, which no entry point builds, are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import (AttentionGated, Classifier1fc,
                                           DimReduction, torch_linear_init_)
from acmil_tpu_torch.ops.masked import masked_softmax

MERGES = ("cat", "add", "sub")


class IBMIL(nn.Module):
    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 d_attn: int = 128, confounder_dim: int = 128,
                 confounder_merge: str = "cat",
                 confounders: Optional[np.ndarray] = None,
                 confounder_learn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if confounder_merge not in MERGES:
            raise ValueError(f"confounder_merge must be one of {MERGES}, got "
                             f"{confounder_merge!r}")
        self.confounder_merge = confounder_merge
        self.dimreduction = DimReduction(d_feat, d_inner)
        self.attention = AttentionGated(d_inner, d_attn, 1)
        self.deconfounded = confounders is not None
        c_in = d_inner
        if self.deconfounded:
            self.W_q = nn.Linear(d_inner, confounder_dim)
            self.W_k = nn.Linear(d_inner, confounder_dim)
            proto = torch.as_tensor(np.asarray(confounders, np.float32)
                                    ).reshape(-1, d_inner)
            if confounder_learn:
                self.confounder_feat = nn.Parameter(proto)
            else:
                self.register_buffer("confounder_feat", proto)
            if confounder_merge == "cat":
                c_in = 2 * d_inner
        self.classifier = Classifier1fc(c_in, n_class)
        torch_linear_init_(self, generator)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        x = self.dimreduction(_as_weight_dtype(feats, self))     # [B, N, L]
        a = self.attention(x)                                     # [B, 1, N]
        attn = masked_softmax(a, None if mask is None else mask[:, None, :])
        M = (attn @ x)[:, 0]                                      # [B, L]
        out = {"attn": a, "bag_feat": M}
        if self.deconfounded:
            conf = self.confounder_feat                           # [P, L]
            bag_q, conf_k = self.W_q(M), self.W_k(conf)           # [B, J], [P, J]
            deconf_a = torch.softmax(bag_q @ conf_k.t()
                                     / math.sqrt(bag_q.shape[-1]), dim=-1)
            conf_feat = deconf_a @ conf                           # [B, L]
            if self.confounder_merge == "cat":
                M = torch.cat([M, conf_feat], dim=-1)
            elif self.confounder_merge == "add":
                M = M + conf_feat
            else:
                M = M - conf_feat
            out["deconf_attn"] = deconf_a
        out["logits"] = self.classifier(M)
        return out
