"""Bag augmentations and split helpers, the port of
``acmil_tpu/utils/augment.py``.

Reference: `utils/utils.py:543-601` (``group_shuffle``, ``patch_shuffle``:
the spatial group shuffles of MHIM-style training; ``five_scores``, binary
metrics at the optimal threshold) and `:616-681` (the balanced
``data_split`` and k-fold helpers). The shuffles take an explicit
``torch.Generator`` (None: torch's default one) where the JAX functions take
a key; the rest is numpy, as there.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from acmil_tpu_torch.engine.metrics import _binary_auroc


def _perm(n: int, generator: Optional[torch.Generator],
          device) -> torch.Tensor:
    return torch.randperm(n, generator=generator,
                          device=generator.device if generator is not None
                          else device)


def group_shuffle(generator: Optional[torch.Generator], x: torch.Tensor,
                  group: int = 0) -> torch.Tensor:
    """Shuffle patches in ``group``-sized contiguous chunks
    (`utils.py:543-555`); ``x: [B, P, D]``. Without a group in (0, P), a
    permutation of all P patches."""
    p = x.shape[1]
    if 0 < group < p:
        pad = (-p) % group
        ids = torch.cat([torch.arange(p), torch.full((pad,), -1)])
        ids = ids.reshape(group, -1)
        ids = ids[_perm(group, generator, x.device).cpu()].reshape(-1)
        idx = ids[ids >= 0]
    else:
        idx = _perm(p, generator, x.device).cpu()
    return x[:, idx.to(x.device)]


def patch_shuffle(generator: Optional[torch.Generator], x: torch.Tensor,
                  group: int = 0, g_idx: Optional[torch.Tensor] = None,
                  return_g_idx: bool = False):
    """2-D block shuffle on the ⌈√P⌉ grid view of the bag
    (`utils.py:557-587`): the grid cut into ``group`` x ``group`` blocks,
    the blocks permuted (by ``g_idx`` when given); a group outside
    (0, ⌈√P⌉] falls back to :func:`group_shuffle`."""
    p = x.shape[1]
    h = w = int(math.ceil(math.sqrt(p)))
    if group > h or group <= 0:
        out = group_shuffle(generator, x, group)
        return (out, None) if return_g_idx else out
    pad_g = (-h) % group
    h, w = h + pad_g, w + pad_g
    ids = torch.cat([torch.arange(p), torch.full((h * w - p,), -1)])
    ids = ids.reshape(group, h // group, group, w // group)
    ids = torch.einsum("hpwq->hwpq", ids).reshape(group ** 2, h // group,
                                                  w // group)
    if g_idx is None:
        g_idx = _perm(group ** 2, generator, x.device)
    ids = ids[g_idx.cpu()]
    ids = ids.reshape(group, group, h // group, w // group)
    ids = torch.einsum("hwpq->hpwq", ids).reshape(h, w).reshape(-1)
    idx = ids[ids >= 0]
    out = x[:, idx.to(x.device)]
    return (out, g_idx) if return_g_idx else out


def optimal_threshold(labels: np.ndarray, scores: np.ndarray) -> float:
    """Youden-style optimal ROC threshold (`optimal_thresh`,
    `utils.py:18-27`)."""
    order = np.argsort(-scores)
    s = scores[order]
    y = labels[order]
    n_pos = max(y.sum(), 1)
    n_neg = max(len(y) - y.sum(), 1)
    tpr = np.cumsum(y) / n_pos
    fpr = np.cumsum(1 - y) / n_neg
    loss = fpr - tpr
    i = int(np.argmin(loss))
    return float(s[i])


def five_scores(bag_labels, bag_predictions
                ) -> Tuple[float, float, float, float, float]:
    """(accuracy, auc, precision, recall, f1) with threshold optimisation
    (`five_scores`, `utils.py:589-601`)."""
    labels = np.asarray(bag_labels).astype(np.int64)
    scores = np.asarray(bag_predictions, np.float64)
    auc = _binary_auroc(scores, labels)
    thr = optimal_threshold(labels, scores)
    preds = (scores >= thr).astype(np.int64)
    tp = int(((preds == 1) & (labels == 1)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    acc = float((preds == labels).mean())
    return acc, auc, precision, recall, f1


def data_split(items: Sequence, ratio: float, shuffle: bool = True,
               labels: Optional[np.ndarray] = None,
               label_balance: bool = True, seed: int = 0):
    """Split into (val, train) with optional per-class balance
    (`data_split`, `utils.py:616-...`)."""
    items = list(items)
    rng = np.random.default_rng(seed)
    if label_balance and labels is not None:
        labels = np.asarray(labels)
        val, train = [], []
        for lab in np.unique(labels):
            sub = [it for it, l in zip(items, labels) if l == lab]
            if shuffle:
                rng.shuffle(sub)
            k = int(len(sub) * ratio)
            val.extend(sub[:k])
            train.extend(sub[k:])
        return val, train
    if shuffle:
        rng.shuffle(items)
    k = int(len(items) * ratio)
    return items[:k], items[k:]


def k_fold_splits(items: Sequence, k: int = 5,
                  seed: int = 0) -> List[Tuple[list, list]]:
    """k-fold (train, test) index splits (`utils.py:616-681` helpers)."""
    items = list(items)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(items))
    folds = np.array_split(order, k)
    out = []
    for i in range(k):
        test = [items[j] for j in folds[i]]
        train = [items[j] for f in folds[:i] + folds[i + 1:] for j in f]
        out.append((train, test))
    return out
