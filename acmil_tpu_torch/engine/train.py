"""Training and eval engine, the port of ``acmil_tpu/engine/train.py``
(without scan epochs, SAM, custom family steps or meshes).

``create_train_state`` holds the model, AdamW with the reference's
half-cosine schedule, and the step; ``make_train_step`` makes one gradient
step per bag; ``train_one_epoch`` drives a loader and reads its metrics back
once, at the epoch's end. ``make_eval_step`` binds a model to its family's
eval forward; ``evaluate`` scores a loader and computes acc/auc/f1/loss with
one host transfer at the end.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acmil_tpu_torch.engine.families import Family, get_family
from acmil_tpu_torch.engine.metrics import classification_metrics
from acmil_tpu_torch.engine.schedules import half_cosine_schedule


@dataclass
class TrainState:
    """What a training run carries from step to step. ``step`` counts
    optimizer steps from 0; ``generator`` draws STKIM's uniforms on the
    model's device."""

    model: torch.nn.Module
    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    grad_clip: Optional[float] = None
    generator: Optional[torch.Generator] = None


def create_train_state(model, conf, steps_per_epoch: int,
                       grad_clip: Optional[float] = None) -> TrainState:
    """AdamW as ``optax.adamw(half_cosine_schedule(...), weight_decay=wd)``
    (betas 0.9/0.999, eps 1e-8, decay scaled by the learning rate), with
    optax's global-norm clip when ``grad_clip`` or ``conf.grad_clipping``
    is set, over ``model``'s parameters on their device."""
    device = next(model.parameters()).device
    sched = half_cosine_schedule(conf.lr, conf.min_lr, conf.train_epoch,
                                 conf.warmup_epoch, steps_per_epoch)
    opt = torch.optim.AdamW(model.parameters(), lr=sched(0),
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=conf.wd,
                            fused=True if device.type == "cuda" else None)
    if grad_clip is None:
        grad_clip = getattr(conf, "grad_clipping", None)
    gen = torch.Generator(device=device).manual_seed(int(conf.seed))
    return TrainState(model, opt, sched, 0,
                      float(grad_clip) if grad_clip else None, gen)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``grads`` together, on their device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm``, in place: scale by
    ``max_norm / norm`` when ``norm >= max_norm``, else leave as they are
    (torch's ``clip_grad_norm_`` adds 1e-6 to the norm instead)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


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


def make_train_step(model, conf, family="acmil") -> Callable:
    """``step(state, bag, stkim_u=None) -> aux``: one AdamW step on ``bag``,
    ``state`` updated in place. ``aux`` holds the loss, its parts and the
    pre-clip gradient norm as device tensors. STKIM's uniforms are
    ``stkim_u [B, K, N]`` (ACMIL_MHA: ``[B, H, K, N]``) when given, else
    drawn from ``state.generator``.

    The learning rate of step ``t`` (from 0) is ``schedule(t)``, set just
    before ``opt.step()``, as optax evaluates the schedule at the count
    before it increments."""
    fam = _resolve_family(family)
    conf_d = fam.conf_dict(conf)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, bag, stkim_u=None) -> Dict[str, torch.Tensor]:
        model.train()
        valid = bag.mask.any(dim=1)
        outputs = fam.train_outputs(model, bag, conf_d, stkim_u=stkim_u,
                                    generator=state.generator)
        loss, aux = fam.loss(outputs, bag, valid, conf_d)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            # a parameter the loss does not reach (the branch classifier
            # at n_token 1) gets a zero gradient, as in JAX: AdamW skips a
            # parameter whose grad is None, optax still decays it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if state.grad_clip:
            clip_by_global_norm_(grads, state.grad_clip, norm)
        lr = state.schedule(state.step)
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.step()
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        aux["grad_norm"] = norm
        return aux

    return step


def train_one_epoch(state: TrainState, train_step, loader, epoch: int,
                    logger=None, log_every: int = 0
                    ) -> Tuple[TrainState, Dict[str, float]]:
    """Drive one epoch; returns the epoch's mean of every ``aux`` entry.
    Metrics stay on the device and come back in one transfer at the end;
    ``log_every`` > 0 also feeds ``logger`` every that many steps, at one
    host sync each."""
    totals: Dict[str, torch.Tensor] = {}
    n = 0
    for bag in loader:
        aux = train_step(state, bag)
        n += 1
        for k, v in aux.items():
            totals[k] = totals[k] + v if k in totals else v.clone()
        if logger is not None and log_every and n % log_every == 0:
            logger.update(**{k: float(v) for k, v in aux.items()})
    keys = list(totals)
    sums = (torch.stack([totals[k].float() for k in keys]).tolist()
            if keys else [])
    stats = {k: v / max(n, 1) for k, v in zip(keys, sums)}
    if logger is not None and not log_every:
        logger.update(**stats)
    return state, stats


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
