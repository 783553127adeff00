"""DSMIL, dual-stream MIL, the port of ``acmil_tpu/models/dsmil.py``
(reference `architecture/dsmil.py`).

Instance stream: a per-patch linear classifier (``i_classifier``). Bag
stream (``b_classifier``): for each class, the critical (max-score)
instance's query attends over all instance queries; the attention-weighted
values form per-class bag features, fused by a ``Conv1d(C, C, kernel=D)``,
which is a dense map from ``[C, D]`` to ``[C]``.

Parameter names are the reference's (``i_classifier.fc.0``,
``b_classifier.q``, ``b_classifier.v.1``, ``b_classifier.fcc`` as a
``[C, C, D]`` Conv1d weight), so a reference ``state_dict`` loads as it is
and ``scripts/import_torch_checkpoint.py::convert_dsmil`` reads the port's.
The Conv1d is evaluated as that dense product, as the JAX module does.

Masking as in the JAX module: masked rows get NEG_INF instance scores before
the critical-instance argmax, so they are never critical, and the attention
softmax over N gives them 0. The head computes in its weights' dtype (fp16
bags are widened, as the JAX heads promote them to f32), so the
score divisor is sqrt(Q) in f32 whatever the features' dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import dropout
from acmil_tpu_torch.ops.masked import masked_fill, masked_softmax


class FCLayer(nn.Module):
    """The instance classifier (`dsmil.py` ``FCLayer``): one Linear in a
    Sequential, as the reference names it."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(in_size, out_size))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc(feats)


class BClassifier(nn.Module):
    """The bag classifier's parameters (`dsmil.py` ``BClassifier``): the
    query map ``q``, the value map ``v`` (identity unless ``passing_v``) and
    the ``fcc`` Conv1d."""

    def __init__(self, n_class: int, d_feat: int, d_inner: int = 128,
                 d_query: int = 128, nonlinear: bool = True,
                 passing_v: bool = False, dropout_v: float = 0.0):
        super().__init__()
        if nonlinear:
            self.q = nn.Sequential(nn.Linear(d_feat, d_inner), nn.ReLU(),
                                   nn.Linear(d_inner, d_query), nn.Tanh())
        else:
            self.q = nn.Linear(d_feat, d_inner)
        if passing_v:
            self.v = nn.Sequential(nn.Dropout(dropout_v),
                                   nn.Linear(d_feat, d_feat), nn.ReLU())
        else:
            self.v = nn.Identity()
        self.fcc = nn.Conv1d(n_class, n_class, kernel_size=d_feat)


class DSMIL(nn.Module):
    """``model(feats [B,N,D], mask [B,N] | None, deterministic=True)`` →
    ``(inst_logits [B,N,C], bag_logits [B,C], attn_logits [B,C,N])``, the
    attention logits raw (before masking)."""

    def __init__(self, n_class: int, d_feat: int, d_inner: int = 128,
                 d_query: int = 128, nonlinear: bool = True,
                 passing_v: bool = False, dropout_v: float = 0.0):
        super().__init__()
        self.nonlinear = nonlinear
        self.passing_v = passing_v
        self.dropout_v = dropout_v
        self.i_classifier = FCLayer(d_feat, n_class)
        self.b_classifier = BClassifier(n_class, d_feat, d_inner, d_query,
                                        nonlinear, passing_v, dropout_v)

    def forward(self, feats, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = _as_weight_dtype(feats, self)
        b = x.shape[0]
        inst_logits = self.i_classifier(x)                    # [B, N, C]
        q = self.b_classifier.q(x)                            # [B, N, Q]
        if self.passing_v:
            _, lin, _ = self.b_classifier.v
            # torch's default generator draws, through
            # models/common.py::dropout as every head's dropout does
            v = torch.relu(lin(dropout(x, self.dropout_v)
                               if not deterministic and self.dropout_v > 0
                               else x))
        else:
            v = x

        # critical instances: argmax over valid patches per class
        scores = inst_logits
        if mask is not None:
            scores = masked_fill(scores, mask[:, :, None])
        crit = scores.argmax(dim=1)                           # [B, C]
        q_max = torch.gather(q, 1, crit[..., None].expand(-1, -1, q.shape[-1]))

        a = torch.einsum("bnq,bcq->bcn", q, q_max) / math.sqrt(q.shape[-1])
        attn = masked_softmax(a, None if mask is None else mask[:, None, :])
        bag_feat = attn @ v                                   # [B, C, D]

        # Conv1d(C, C, kernel_size=D) == dense [C*D] -> [C]
        fcc = self.b_classifier.fcc
        bag_logits = F.linear(bag_feat.reshape(b, -1),
                              fcc.weight.reshape(fcc.out_channels, -1),
                              fcc.bias)
        return inst_logits, bag_logits, a
