"""CLAM-SB / CLAM-MB, attention MIL with an instance-level clustering loss,
the port of ``acmil_tpu/models/clam.py`` (reference: `architecture/clam.py`,
`CLAM_SB:85`, `CLAM_MB:211`, `inst_eval:128`, `inst_eval_out:147`).

Parameter names are the reference's: ``attention_net.0`` (the fc),
``attention_net.{2|3}`` (the attention net, at 3 when a dropout sits
before it), ``classifiers`` (SB) or ``classifiers.{c}`` (MB) and
``instance_classifiers.{c}``, so a reference checkpoint loads as it is, with
or without dropout, and ``scripts/import_torch_checkpoint.py::convert_clam``
reads the port's. Weights are initialised as the reference's
``initialize_weights``: xavier-normal, zero biases, from an explicit
``torch.Generator``.

The instance loss is the JAX package's fixed-shape form: every class's
in/out-of-class loss over the top- and bottom-``k_sample`` attention rows,
gated by ``one_hot(label)``; gathered slots past a short bag's valid rows
are down-weighted, not an error. Dropout runs only in a training forward
(``deterministic=False`` on a module in train mode), with the draws of the
``generator`` passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from acmil_tpu_torch.models.acmil import _as_weight_dtype
from acmil_tpu_torch.models.common import (Attn_Net, Attn_Net_Gated, dropout,
                                           xavier_normal_init_)
from acmil_tpu_torch.ops.masked import masked_fill, masked_softmax, softmax_one
from acmil_tpu_torch.parallel.mesh import weighted_mean


def _topk_gather(scores, gather_h, mask, k):
    """The rows of h (``gather_h(idx [B, k]) -> [B, k, L]``) at the top-k
    ``scores [B, N]``, masked slots filled with ``NEG_INF`` first so they
    come last. Returns (rows [B, k, L], slot_valid [B, k])."""
    s = masked_fill(scores, mask) if mask is not None else scores
    idx = torch.topk(s, k, dim=-1).indices                     # [B, k]
    if mask is None:
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    else:
        valid = torch.gather(mask, 1, idx)
    return gather_h(idx), valid


def _binary_ce(logits, target: int, slot_valid):
    """Per-bag mean CE of 2-way instance logits ``[B, k, 2]`` against a
    constant target, over the valid gathered slots → ``[B]``."""
    nll = -F.log_softmax(logits, dim=-1)[..., target]
    w = slot_valid.to(nll.dtype)
    return (nll * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)


def _binary_svm(logits, target: int, slot_valid):
    """The smooth top-1 SVM alternative (the reference's optional
    ``SmoothTop1SVM``, `modules/clam.py:5`), per bag → ``[B]``."""
    from acmil_tpu_torch.ops.topk_svm import smooth_top1_svm_loss

    labels = torch.full(logits.shape[:2], target, dtype=torch.long,
                        device=logits.device)
    return torch.stack([smooth_top1_svm_loss(logits[i], labels[i],
                                             valid=slot_valid[i])
                        for i in range(logits.shape[0])])


def _instance_loss(A, gather_h, mask, label, inst_w, inst_b, *, n_class: int,
                  k_sample: int, subtyping: bool, multi_branch: bool,
                  loss_fn=_binary_ce):
    """The fixed-shape instance clustering loss (`clam.py:128-189`).

    ``A [B, Kb, N]`` attention weights; ``gather_h(idx [B, k])`` the rows of
    h at ``idx`` ``[B, k, L]``; ``inst_w [C, L, 2]`` and ``inst_b [C, 2]``
    the instance classifiers. For each class c: top-k rows of A (branch c
    for MB) are positives and bottom-k negatives when c is the label, and
    with ``subtyping`` top-k rows are negatives when it is not. Averaged
    over bags with a valid row."""
    k = k_sample
    onehot = F.one_hot(label.long(), n_class).to(A.dtype)      # [B, C]

    losses_in, losses_out = [], []
    for c in range(n_class):
        ac = A[:, c] if multi_branch else A[:, 0]              # [B, N]
        h_p, v_p = _topk_gather(ac, gather_h, mask, k)
        h_n, v_n = _topk_gather(-ac, gather_h, mask, k)
        logit_p = h_p @ inst_w[c] + inst_b[c]
        logit_n = h_n @ inst_w[c] + inst_b[c]
        losses_in.append(0.5 * (loss_fn(logit_p, 1, v_p)
                                + loss_fn(logit_n, 0, v_n)))
        losses_out.append(loss_fn(logit_p, 0, v_p))
    total = (onehot * torch.stack(losses_in, dim=-1)).sum(dim=-1)
    if subtyping:
        total = (total + ((1 - onehot) * torch.stack(losses_out, dim=-1))
                 .sum(dim=-1)) / n_class
    # average over real bags only: an all-masked row contributes nothing
    return weighted_mean(total, None if mask is None else mask.any(dim=1))


class _CLAMBase(nn.Module):
    multi_branch = False

    def __init__(self, n_class: int, d_feat: int = 384, d_inner: int = 128,
                 d_attn: int = 128, k_sample: int = 8, gate: bool = True,
                 droprate: float = 0.25, subtyping: Optional[bool] = None,
                 inst_loss: str = "ce",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if inst_loss not in ("ce", "svm"):
            raise ValueError(f"inst_loss must be 'ce' or 'svm', got "
                             f"{inst_loss!r}")
        self.n_class, self.k_sample, self.gate = n_class, k_sample, gate
        self.droprate, self.inst_loss = droprate, inst_loss
        self.subtyping = n_class > 2 if subtyping is None else bool(subtyping)
        fc = [nn.Linear(d_feat, d_inner), nn.ReLU()]
        if droprate > 0:
            fc.append(nn.Dropout(droprate))
        n_branch = n_class if self.multi_branch else 1
        attn_cls = Attn_Net_Gated if gate else Attn_Net
        fc.append(attn_cls(d_inner, d_attn, droprate, n_branch))
        self.attention_net = nn.Sequential(*fc)
        if self.multi_branch:
            self.classifiers = nn.ModuleList(nn.Linear(d_inner, 1)
                                             for _ in range(n_class))
        else:
            self.classifiers = nn.Linear(d_inner, n_class)
        self.instance_classifiers = nn.ModuleList(nn.Linear(d_inner, 2)
                                                  for _ in range(n_class))
        xavier_normal_init_(self, generator)

    def bag_logits(self, M: torch.Tensor) -> torch.Tensor:
        """Slide logits ``[B, C]`` from the pooled features ``M [B, Kb, L]``:
        SB's one classifier on its branch; MB's per-class classifier on its
        class's branch."""
        if not self.multi_branch:
            return self.classifiers(M[:, 0])
        w = torch.cat([c.weight for c in self.classifiers])    # [C, L]
        b = torch.cat([c.bias for c in self.classifiers])      # [C]
        return torch.einsum("bcd,cd->bc", M, w) + b

    def instance_weights(self):
        """The instance classifiers stacked: (inst_w [C, L, 2], inst_b
        [C, 2])."""
        return (torch.stack([c.weight.t() for c in self.instance_classifiers]),
                torch.stack([c.bias for c in self.instance_classifiers]))

    def normalize(self, a: torch.Tensor, mask) -> torch.Tensor:
        """Attention weights from logits ``[B, Kb, N]``: softmax-one for MB
        (`clam.py:248`), the masked softmax for SB."""
        m = None if mask is None else mask[:, None, :]
        return softmax_one(a, m) if self.multi_branch else masked_softmax(a, m)

    def forward(self, feats, mask=None, label=None,
                instance_eval: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``{"logits" [B, C], "attn" [B, Kb, N] (raw logits), "bag_feat"
        [B, Kb, L]}``, plus ``"instance_loss"`` with ``instance_eval`` (which
        needs ``label``)."""
        drop = self.droprate > 0 and self.training and not deterministic
        h = torch.relu(self.attention_net[0](_as_weight_dtype(feats, self)))
        if drop:
            h = dropout(h, self.droprate, generator)
        a = self.attention_net[-1](h, drop, generator)         # [B, Kb, N]
        A = self.normalize(a, mask)
        M = A @ h                                               # [B, Kb, L]
        out = {"logits": self.bag_logits(M), "attn": a, "bag_feat": M}
        if instance_eval:
            if label is None:
                raise ValueError("instance_eval needs labels")
            inst_w, inst_b = self.instance_weights()
            rows = torch.arange(h.shape[0], device=h.device)[:, None]
            out["instance_loss"] = _instance_loss(
                A, lambda idx: h[rows, idx], mask, label, inst_w, inst_b,
                n_class=self.n_class, k_sample=self.k_sample,
                subtyping=self.subtyping, multi_branch=self.multi_branch,
                loss_fn=_binary_svm if self.inst_loss == "svm"
                else _binary_ce)
        return out


class CLAM_SB(_CLAMBase):
    """One attention branch and one bag classifier (`clam.py:85`)."""

    multi_branch = False


class CLAM_MB(_CLAMBase):
    """One attention branch and one bag classifier per class, softmax-one
    attention (`clam.py:211-248`)."""

    multi_branch = True
