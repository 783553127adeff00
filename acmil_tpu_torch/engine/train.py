"""Eval engine, the eval half of ``acmil_tpu/engine/train.py``.

``make_eval_step`` binds a model to its family's eval forward;
``evaluate`` scores a loader and computes acc/auc/f1/loss with one host
transfer at the end. The train step, AdamW and the half-cosine schedule
come with the training slice.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict

import numpy as np
import torch

from acmil_tpu_torch.engine.families import Family, get_family
from acmil_tpu_torch.engine.metrics import classification_metrics


def _resolve_family(family) -> Family:
    return get_family(family) if isinstance(family, str) else family


def make_eval_step(model, family="default", fused: bool = True) -> Callable:
    """``step(bag) -> probs [B, C]`` on the bag's device, under
    ``torch.no_grad`` with the model in eval mode. ``fused`` reaches only
    families whose eval forward takes it."""
    fam = _resolve_family(family)
    kw = ({"fused": fused}
          if "fused" in inspect.signature(fam.eval_outputs).parameters else {})

    @torch.no_grad()
    def step(bag):
        model.eval()
        return fam.probs(fam.eval_outputs(model, bag, **kw))

    return step


def _finalize_metrics(probs_h, valid_h, labels_h, n_class: int) -> Dict[str, float]:
    probs_all = [p[v] for p, v in zip(probs_h, valid_h)]
    labels_all = [l[v] for l, v in zip(labels_h, valid_h)]
    probs = np.concatenate(probs_all) if probs_all else np.zeros((0, n_class))
    labels = np.concatenate(labels_all) if labels_all else np.zeros((0,), np.int64)
    m = classification_metrics(probs, labels)
    eps = 1e-12
    m["loss"] = float(-np.mean(np.log(probs[np.arange(len(labels)), labels] + eps))) if len(labels) else float("nan")
    return m


def evaluate(eval_step, loader, n_class: int) -> Dict[str, float]:
    """Returns acc/auc/f1/loss over a split (`Step3_ACMIL:242-287`)."""
    probs_dev, valid_dev, labels_dev = [], [], []
    for bag in loader:
        probs_dev.append(eval_step(bag))       # stays on device (async)
        valid_dev.append(bag.mask.any(dim=1))
        labels_dev.append(bag.label)
    # one bulk host transfer at the end instead of a sync per batch
    to_np = lambda ts: [t.cpu().numpy() for t in ts]
    return _finalize_metrics(to_np(probs_dev), to_np(valid_dev),
                             to_np(labels_dev), n_class)


def is_better(metrics: Dict[str, float], best: Dict[str, float],
              selection_f1: str = "macro") -> bool:
    """Reference selection rule: val F1 + val AUC (`Step3_ACMIL:156-165`).
    NaN metrics (e.g. single-class val split) count as 0 so a best
    checkpoint always gets written. ``selection_f1='micro'`` scores
    ``acc + auc`` (micro-F1 equals accuracy for single-label tasks)."""
    if selection_f1 not in ("macro", "micro"):
        raise ValueError(f"selection_f1 must be macro|micro, "
                         f"got {selection_f1!r}")
    key = "f1" if selection_f1 == "macro" else "acc"

    def score(m):
        f1, auc = m.get(key, -1.0), m.get("auc", -1.0)
        f1 = 0.0 if np.isnan(f1) else f1
        auc = 0.0 if np.isnan(auc) else auc
        return f1 + auc

    return score(metrics) > score(best) or not best
