"""Evaluation metrics — AUROC / macro-F1 / accuracy; a numpy copy of
``acmil_tpu/engine/metrics.py``, with its multi-host gather over a process
group (:func:`gather_across_hosts`).

The reference uses torchmetrics AUROC/F1 (`engine.py:210-215`) and timm
``accuracy``. Here: host-side numpy implementations (no sklearn dependency
in the hot path, deterministic, handles the binary and macro-multiclass
cases the reference exercises).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based (Mann-Whitney) AUROC with tie correction."""
    pos = labels == 1
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def auroc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Binary: prob of class 1. Multiclass: macro one-vs-rest
    (torchmetrics ``AUROC(task='multiclass', average='macro')`` semantics)."""
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels)
    n_class = probs.shape[1]
    if n_class == 2:
        return _binary_auroc(probs[:, 1], (labels == 1).astype(np.int64))
    vals = []
    for c in range(n_class):
        if (labels == c).any() and (labels != c).any():
            vals.append(_binary_auroc(probs[:, c], (labels == c).astype(np.int64)))
    return float(np.mean(vals)) if vals else float("nan")


def f1_macro(preds: np.ndarray, labels: np.ndarray, n_class: int) -> float:
    vals = []
    for c in range(n_class):
        tp = int(np.sum((preds == c) & (labels == c)))
        fp = int(np.sum((preds == c) & (labels != c)))
        fn = int(np.sum((preds != c) & (labels == c)))
        denom = 2 * tp + fp + fn
        vals.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(vals))


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(preds == labels)) if len(labels) else float("nan")


def classification_metrics(probs: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """The eval triple the reference logs per epoch (`engine.py:210-218`)."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    preds = probs.argmax(axis=1)
    return {
        "acc": accuracy(preds, labels),
        "auc": auroc(probs, labels),
        "f1": f1_macro(preds, labels, probs.shape[1]),
    }



def gather_across_hosts(probs, labels, valid, group):
    """Every data rank's ``probs [n, C]``, ``labels [n]`` and ``valid [n]``
    (torch tensors of one shape on each rank) concatenated in rank order,
    so that every rank computes the metrics of the whole split: the working
    version of the reference's vestigial ``synchronize_between_processes``
    (`utils/utils.py:92-103`). Returns them unchanged for a group of None."""
    if group is None:
        return probs, labels, valid
    import torch

    from acmil_tpu_torch.parallel.collectives import gather_list

    def whole(t):
        return torch.cat(gather_list(t, group))

    return (whole(probs), whole(labels.long()),
            whole(valid.to(torch.uint8)).bool())
