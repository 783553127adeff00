"""Training and eval engine, the port of ``acmil_tpu/engine/train.py``
(without scan epochs or meshes).

``create_train_state`` holds the model, AdamW with the reference's
half-cosine schedule (or the family's own optimizer and per-module clip),
the step and, for a family with a teacher, the EMA teacher;
``make_train_step`` makes one gradient step per bag, a SAM step when
``use_sam`` is set (or the family's own step); ``train_one_epoch`` drives a loader and reads its metrics back
once, at the epoch's end. ``make_eval_step`` binds a model to its family's
eval forward; ``evaluate`` scores a loader and computes acc/auc/f1/loss with
one host transfer at the end.
"""

from __future__ import annotations

import copy
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acmil_tpu_torch.engine.families import Family, get_family
from acmil_tpu_torch.engine.metrics import classification_metrics
from acmil_tpu_torch.engine.schedules import half_cosine_schedule
from acmil_tpu_torch.ops.sam import sam_gradient


@dataclass
class TrainState:
    """What a training run carries from step to step. ``step`` counts
    optimizer steps from 0; ``generator`` draws STKIM's uniforms on the
    model's device; ``teacher`` is the EMA teacher of a family that keeps
    one (the JAX ``EMATrainState``), else None; ``clip_groups`` are
    parameter groups each clipped by its own norm to ``grad_clip`` (the JAX
    ``clip_by_module_norms``), else ``grad_clip`` clips the global norm."""

    model: torch.nn.Module
    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    grad_clip: Optional[float] = None
    generator: Optional[torch.Generator] = None
    teacher: Optional[torch.nn.Module] = None
    clip_groups: Optional[List[List[torch.Tensor]]] = None


def create_train_state(model, conf, steps_per_epoch: int,
                       grad_clip: Optional[float] = None,
                       family=None) -> TrainState:
    """AdamW as ``optax.adamw(half_cosine_schedule(...), weight_decay=wd)``
    (betas 0.9/0.999, eps 1e-8, decay scaled by the learning rate), with
    optax's global-norm clip when ``grad_clip`` or ``conf.grad_clipping``
    is set, over ``model``'s parameters on their device. A ``family`` with
    its own optimizer takes it instead, with the per-module clip its
    ``clip_groups`` names (none when it names none); a family with a
    teacher gets a deep copy of ``model``, frozen, as the teacher."""
    device = next(model.parameters()).device
    sched = half_cosine_schedule(conf.lr, conf.min_lr, conf.train_epoch,
                                 conf.warmup_epoch, steps_per_epoch)
    fam = _resolve_family(family) if family is not None else Family()
    opt = fam.make_optimizer(model.parameters(), conf, sched(0), device)
    groups = None
    if opt is None:
        opt = torch.optim.AdamW(model.parameters(), lr=sched(0),
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=conf.wd,
                                fused=True if device.type == "cuda" else None)
        if grad_clip is None:
            grad_clip = getattr(conf, "grad_clipping", None)
    else:
        grad_clip, groups = fam.clip_groups(model, conf) or (None, None)
    teacher = None
    if fam.teacher:
        teacher = copy.deepcopy(model).eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(int(conf.seed))
    return TrainState(model, opt, sched, 0,
                      float(grad_clip) if grad_clip else None, gen, teacher,
                      groups)


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


def clip_by_module_norms_(groups: List[List[torch.Tensor]],
                          max_norm: float) -> None:
    """torch's per-module ``clip_grad_norm_``, in place: each group's
    gradients scaled by ``min(1, max_norm / (norm + 1e-6))`` of the group's
    own norm, so a spike in one module leaves the others' updates as they
    are (`Step3_DTFD:137-148`)."""
    for group in groups:
        grads = [p.grad for p in group]
        scale = torch.clamp(max_norm / (global_norm(grads) + 1e-6), max=1.0)
        torch._foreach_mul_(grads, scale)


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    params) -> torch.Tensor:
    """Backpropagate ``loss`` into ``params`` and take one optimizer step
    (:func:`step_optimizer`); a parameter the loss does not reach gets a
    zero gradient (as in JAX: torch's optimizers skip a parameter whose grad
    is None, optax still decays it). Returns the pre-clip gradient norm."""
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return step_optimizer(state, params)


def step_optimizer(state: TrainState, params) -> torch.Tensor:
    """One optimizer step from the gradients ``params`` hold: the per-module
    clip when ``state.clip_groups`` is set, else the global-norm clip when
    ``state.grad_clip`` is, the learning rate ``schedule(step)`` (optax
    evaluates the schedule at the count before it increments), then
    ``step += 1``. Returns the pre-clip global gradient norm."""
    grads = [p.grad for p in params]
    gnorm = global_norm(grads)
    if state.clip_groups:
        clip_by_module_norms_(state.clip_groups, state.grad_clip)
    elif state.grad_clip:
        clip_by_global_norm_(grads, state.grad_clip, gnorm)
    lr = state.schedule(state.step)
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.step()
    state.step += 1
    return gnorm


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


def _rng_replay(state: TrainState, device: torch.device) -> Callable[[], None]:
    """A function that sets ``state.generator`` and torch's default
    generator of ``device`` back to where they stand now: SAM's two passes
    then draw the same STKIM uniforms, DTFD grouping and dropout masks, as
    JAX's two passes close over one rng dict."""
    gen = state.generator.get_state() if state.generator is not None else None
    cpu = torch.get_rng_state()
    cuda = torch.cuda.get_rng_state(device) if device.type == "cuda" else None

    def replay():
        if gen is not None:
            state.generator.set_state(gen)
        torch.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda, device)

    return replay


def make_train_step(model, conf, family="acmil") -> Callable:
    """``step(state, bag, stkim_u=None) -> aux``: one optimizer step on
    ``bag`` (:func:`apply_gradients`), ``state`` updated in place; the
    family's own step where it has one. ``aux`` holds the loss, its parts
    and the pre-clip gradient norm as device tensors. STKIM's uniforms are
    ``stkim_u [B, K, N]`` (ACMIL_MHA: ``[B, H, K, N]``; DTFD's grouping:
    ``[B, N]``) when given, else drawn from ``state.generator``.

    With ``use_sam`` the step takes the gradient at the SAM point
    (``ops/sam.py::sam_gradient``, radius ``sam_rho``, 0.05 by default):
    two passes that make the same random draws. ``aux`` then holds the
    first pass's loss and the SAM gradient's norm. A family with its own
    step refuses ``use_sam`` (the JAX package ignores it there)."""
    fam = _resolve_family(family)
    use_sam = bool(getattr(conf, "use_sam", False))
    custom = fam.make_step(model, conf)
    if custom is not None:
        if use_sam:
            raise ValueError(f"use_sam: family {fam.name!r} brings its own "
                             f"train step, which takes no SAM gradient")
        return custom
    conf_d = fam.conf_dict(conf)
    params = [p for p in model.parameters() if p.requires_grad]
    sam_rho = float(getattr(conf, "sam_rho", 0.05))

    def step(state: TrainState, bag, stkim_u=None) -> Dict[str, torch.Tensor]:
        model.train()
        valid = bag.mask.any(dim=1)

        def loss_fn():
            outputs = fam.train_outputs(model, bag, conf_d, stkim_u=stkim_u,
                                        generator=state.generator)
            return fam.loss(outputs, bag, valid, conf_d)

        if use_sam:
            replay = _rng_replay(state, bag.feats.device)

            def replayed():
                replay()
                return loss_fn()

            (loss, aux), grads = sam_gradient(replayed, params, sam_rho)
            for p, g in zip(params, grads):
                p.grad = g
            norm = step_optimizer(state, params)
        else:
            loss, aux = loss_fn()
            norm = apply_gradients(state, loss, params)
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
