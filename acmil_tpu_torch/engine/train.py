"""Training and eval engine, the port of ``acmil_tpu/engine/train.py``.

``create_train_state`` holds the model, AdamW with the reference's
half-cosine schedule (or the family's own optimizer and per-module clip),
the step and, for a family with a teacher, the EMA teacher;
``make_train_step`` makes one gradient step per bag, a SAM step when
``use_sam`` is set (or the family's own step); ``train_one_epoch`` drives a loader and reads its metrics back
once, at the epoch's end. ``make_eval_step`` binds a model to its family's
eval forward; ``evaluate`` scores a loader and computes acc/auc/f1/loss with
one host transfer at the end.

With a ``mesh`` (``parallel/mesh.py``), the steps run on this rank's part
of each batch under the mesh made active: each data rank's loss is its
share of the global loss, ``step_optimizer`` sums the gradients over the
data group, and ``evaluate`` gathers the probabilities of every data rank.

Scanned epochs (``scan_epoch``): ``train_one_epoch_scanned`` and
``evaluate_scanned`` drive the stacked shape groups of
``BagLoader.device_groups`` in the JAX package's visit order, through
``make_scan_train_step`` and ``make_scan_eval_step``. On a card in one
process the step of each group of every arch in ``GRAPH_SCAN_ARCHS`` (the
whole registry, with or without SAM) is captured once as a CUDA graph and
replayed once per bag (``engine/graphs.py``); the CPU and a mesh of several
processes run the same step eagerly, for the reason ``scan_route`` gives.
On a mesh the scanned step is the per-bag mesh step on this rank's part of
each group, and the scanned eval gathers over the data group as
``evaluate`` does.
"""

from __future__ import annotations

import copy
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine.families import Family, get_family
from acmil_tpu_torch.engine.graphs import GraphSteps, take
from acmil_tpu_torch.engine.metrics import (classification_metrics,
                                            gather_across_hosts)
from acmil_tpu_torch.engine.schedules import half_cosine_schedule
from acmil_tpu_torch.ops.sam import sam_gradient
from acmil_tpu_torch.parallel import collectives as C
from acmil_tpu_torch.parallel.mesh import active, current, gather_seq
from acmil_tpu_torch.utils import profiling


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


def apply_gradients(state: TrainState, loss: torch.Tensor, params,
                    sched: Optional["DeviceSchedule"] = None) -> torch.Tensor:
    """Backpropagate ``loss`` into ``params`` and take one optimizer step
    (:func:`step_optimizer`, or with ``sched`` the rate from the device,
    :func:`_device_step_optimizer`); a parameter the loss does not reach
    gets a zero gradient (as in JAX: torch's optimizers skip a parameter
    whose grad is None, optax still decays it). Returns the pre-clip
    gradient norm."""
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if sched is not None:
        return _device_step_optimizer(state, params, sched)
    return step_optimizer(state, params)


def sum_over_data_(grads: List[torch.Tensor]) -> None:
    """Sum ``grads`` in place over the active mesh's data group, in one
    collective: each data rank holds the gradient of its share of the
    loss, and the shares sum to the global loss."""
    mesh = current()
    if mesh is None or mesh.data_group is None or not grads:
        return
    flat = C.all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                         mesh.data_group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def step_optimizer(state: TrainState, params) -> torch.Tensor:
    """One optimizer step from the gradients ``params`` hold: summed over
    the data ranks of the active mesh, then the per-module clip when
    ``state.clip_groups`` is set, else the global-norm clip when
    ``state.grad_clip`` is, the learning rate ``schedule(step)`` (optax
    evaluates the schedule at the count before it increments), then
    ``step += 1``. Returns the pre-clip global gradient norm."""
    grads = [p.grad for p in params]
    sum_over_data_(grads)
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


def make_eval_step(model, family="default", fused: bool = True,
                   mesh=None) -> Callable:
    """``step(bag) -> probs [B, C]`` on the bag's device, under
    ``torch.no_grad`` with the model in eval mode. ``fused`` and ``mesh``
    reach only families whose eval forward takes them. On a ``mesh`` the
    bag is this rank's part: a head with no sequence path of its own gets
    the bag gathered over the seq group."""
    fam = _resolve_family(family)
    params = inspect.signature(fam.eval_outputs).parameters
    kw = {"fused": fused} if "fused" in params else {}
    if mesh is not None and "mesh" in params:
        kw["mesh"] = mesh
    sliced = mesh is not None and fam.takes_seq_slice(model, fused)

    @torch.no_grad()
    def step(bag):
        model.eval()
        with active(mesh):
            if not sliced:
                bag = gather_seq(bag, mesh)
            return fam.probs(fam.eval_outputs(model, bag, **kw))

    return step


def _data_rows(u: Optional[torch.Tensor], mesh, dim: int):
    """This data rank's rows of a global-batch tensor of draws."""
    if u is None or mesh is None or mesh.data == 1:
        return u
    rows = u.shape[dim] // mesh.data
    return u.narrow(dim, mesh.data_index * rows, rows)


def make_train_step(model, conf, family="acmil", mesh=None) -> Callable:
    """``step(state, bag, stkim_u=None) -> aux``: one optimizer step on
    ``bag`` (:func:`apply_gradients`), ``state`` updated in place; the
    family's own step where it has one. ``aux`` holds the loss, its parts
    and the pre-clip gradient norm as device tensors. STKIM's uniforms are
    ``stkim_u [B, K, N]`` (ACMIL_MHA: ``[B, H, K, N]``; DTFD's grouping:
    ``[B, N]``) when given, else drawn from ``state.generator``.

    With ``use_sam`` the step takes the gradient at the SAM point
    (``ops/sam.py::sam_gradient``, radius ``sam_rho``, 0.05 by default):
    two passes, the second taking the first's random draws. ``aux`` then
    holds the first pass's loss and the SAM gradient's norm. A family with its own
    step refuses ``use_sam`` (the JAX package ignores it there).

    On a ``mesh``, ``bag`` is this rank's part of the batch
    (``parallel/mesh.py::shard_bag``) and ``stkim_u`` the whole batch's
    draws, of which the step keeps this rank's rows. The step runs with the
    mesh active: the ACMIL_GA fused route works on this rank's slice of N,
    every other head on the bag gathered over the seq group; the losses are
    shares of the global batch's, and ``aux`` holds their sums over the data
    ranks, the global values."""
    fam = _resolve_family(family)
    return _mesh_step(model, conf, fam, mesh, fam.make_step(model, conf),
                      scanned=False)[0]


def _mesh_step(model, conf, fam: Family, mesh, custom, scanned: bool):
    """``(step(state, bag, stkim_u, sched) -> aux, params)``: the one step
    body of :func:`make_train_step` and of the scanned epochs, with the
    mesh's wiring: the mesh active, the bag gathered over seq for a head
    that takes no seq slice, this rank's rows of ``stkim_u``, the
    gradients summed over the data group (:func:`step_optimizer`,
    :func:`_device_step_optimizer`) and ``aux``'s shares summed
    (:func:`_sum_shares`). ``custom`` is the family's own step (called
    with the gathered bag and ``sched``). ``scanned`` decides STKIM's
    branch on the device; a ``sched`` then gives the rate, and the step
    count a family's own tables read, from the device."""
    use_sam = bool(getattr(conf, "use_sam", False))
    if custom is not None and use_sam:
        raise ValueError(f"use_sam: family {fam.name!r} brings its own "
                         f"train step, which takes no SAM gradient")
    conf_d = fam.conf_dict(conf)
    conf_d["mesh"] = mesh
    if scanned:
        conf_d["stkim_on_device"] = True
    params = [p for p in model.parameters() if p.requires_grad]
    sam_rho = float(getattr(conf, "sam_rho", 0.05))
    sliced = mesh is not None and fam.takes_seq_slice(
        model, conf_d.get("fused", False))

    def body(state: TrainState, bag, full, stkim_u,
             sched: Optional["DeviceSchedule"]) -> Dict[str, torch.Tensor]:
        model.train()
        valid = full.mask.any(dim=1)

        def loss_fn():
            outputs = fam.train_outputs(model, bag, conf_d, stkim_u=stkim_u,
                                        generator=state.generator)
            return fam.loss(outputs, full, valid, conf_d)

        if use_sam:
            (loss, aux), grads = sam_gradient(loss_fn, params, sam_rho,
                                              reduce_grads=sum_over_data_)
            for p, g in zip(params, grads):
                p.grad = g
            norm = (step_optimizer(state, params) if sched is None
                    else _device_step_optimizer(state, params, sched))
        else:
            loss, aux = loss_fn()
            norm = apply_gradients(state, loss, params, sched)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        aux["grad_norm"] = norm
        return aux

    def step(state: TrainState, bag, stkim_u=None,
             sched: Optional["DeviceSchedule"] = None
             ) -> Dict[str, torch.Tensor]:
        with active(mesh):
            full = gather_seq(bag, mesh, feats=not sliced)
            stkim_u = _data_rows(stkim_u, mesh, fam.draws_batch_dim)
            if custom is not None:
                aux = custom(state, full, stkim_u, sched)
            else:
                aux = body(state, bag if sliced else full, full, stkim_u,
                           sched)
            return _sum_shares(aux, mesh)

    return step, params


def _sum_shares(aux: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """``aux``'s loss shares summed over the data ranks, in one collective
    (the gradient norm is already the global one)."""
    if mesh is None or mesh.data_group is None:
        return aux
    keys = [k for k in aux if k != "grad_norm"]
    summed = C.all_reduce_(torch.stack([aux[k].float() for k in keys]),
                           mesh.data_group)
    out = dict(aux)
    out.update({k: v.to(aux[k].dtype) for k, v in zip(keys, summed)})
    return out


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


def evaluate(eval_step, loader, n_class: int, mesh=None) -> Dict[str, float]:
    """Returns acc/auc/f1/loss over a split (`Step3_ACMIL:242-287`). On a
    ``mesh`` each data rank scores its rows of each batch, and the
    probabilities, labels and valid flags of every data rank are gathered
    (``engine/metrics.py::gather_across_hosts``) before the metrics, which
    every rank then computes alike."""
    probs_dev, valid_dev, labels_dev = [], [], []
    for bag in loader:
        probs_dev.append(eval_step(bag))       # stays on device (async)
        valid_dev.append(gather_seq(bag, mesh, feats=False).mask.any(dim=1))
        labels_dev.append(bag.label)
    return _gathered_metrics(probs_dev, valid_dev, labels_dev, n_class, mesh)


def _gathered_metrics(probs_dev, valid_dev, labels_dev, n_class: int,
                      mesh) -> Dict[str, float]:
    """The metrics of every data rank's rows, gathered once, then one bulk
    host transfer instead of a sync per batch."""
    with profiling.span("eval.gather"):
        if mesh is not None and mesh.data_group is not None and probs_dev:
            whole = gather_across_hosts(torch.cat(probs_dev),
                                        torch.cat(labels_dev),
                                        torch.cat(valid_dev), mesh.data_group)
            probs_dev, labels_dev, valid_dev = ([t] for t in whole)
        host = [[t.cpu().numpy() for t in ts]
                for ts in (probs_dev, valid_dev, labels_dev)]
        profiling.settle()
        return _finalize_metrics(*host, n_class)


# ---------------------------------------------------------------------------
# Scanned epochs
# ---------------------------------------------------------------------------

# The archs whose scanned step is captured as one CUDA graph per shape group
# on a card (train and eval), with or without ``use_sam``: every arch of the
# registry (``models/__init__.py``).
GRAPH_SCAN_ARCHS = (
    "ga", "mha", "abmil", "clam_sb", "clam_mb", "dsmil", "dtfd", "pure",
    "mhim", "transmil", "mha_single", "meanmil", "maxmil", "lbmil", "attmil",
    "attmil_gated", "ilra", "ips", "ibmil", "bmil_vis", "bmil_enc",
    "bmil_spvis")

# Why an arch's scanned step runs eagerly on a card in one process, by arch
# (the host read that keeps it out of a graph, by file:line): none does.
EAGER_SCAN_REASONS: Dict[str, str] = {}


def scan_route(conf, device, mesh=None) -> Tuple[str, str]:
    """``("graph" | "eager", why)``: how the scanned step of ``conf.arch``
    runs on ``device`` and ``mesh``, decided from the configuration alone
    and before any capture. A capture that then fails raises. A mesh of
    one process takes the one process's route; across processes the step
    runs eagerly: ``gloo``'s collectives cannot be captured, and NCCL's
    have not been checked under capture across cards."""
    device = torch.device(device)
    if device.type != "cuda":
        return "eager", f"the device is {device.type}, not a card"
    if mesh is not None and mesh.world > 1:
        if mesh.backend == "nccl":
            return "eager", (f"a mesh of {mesh.world} processes: NCCL "
                             f"capture across cards has not been checked "
                             f"on a card")
        return "eager", (f"a mesh of {mesh.world} processes on "
                         f"{mesh.backend}: gloo collectives stage through "
                         f"the host and cannot be captured")
    sam = " with SAM" if bool(getattr(conf, "use_sam", False)) else ""
    if conf.arch in GRAPH_SCAN_ARCHS:
        return "graph", (f"{conf.arch!r}{sam}: one CUDA graph per shape "
                         f"group, replayed once per bag")
    return "eager", f"{conf.arch!r}: " + EAGER_SCAN_REASONS.get(
        conf.arch, "not an arch of the registry")


def family_supports_scan(family) -> bool:
    """True iff :func:`make_scan_train_step` returns a scanned step for this
    family, the JAX rule: a family scans unless it brings its own step
    without a step body (MHIM brings one, ``make_step_body``)."""
    fam = _resolve_family(family)
    return (hasattr(fam, "make_step_body")
            or type(fam).make_step is Family.make_step)


class DeviceSchedule:
    """The learning rate of the scanned steps on the device, where a graph
    reads it: ``table`` holds ``schedule`` at the steps of one dispatch,
    each rounded to float32, ``pos`` the position of the next step in it,
    ``lr`` the rate the optimizer reads as a tensor, and ``step`` ([1]
    int64) the count of optimizer steps taken before the next one, the
    host's ``state.step`` on the device (MHIM's tables read it)."""

    def __init__(self, schedule: Callable[[int], float], size: int,
                 device: torch.device):
        self.schedule, self.size = schedule, max(int(size), 1)
        self.table = torch.zeros(self.size, dtype=torch.float32, device=device)
        self.pos = torch.zeros(1, dtype=torch.int64, device=device)
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)

    def load(self, step: int, n: int) -> None:
        """The rates of steps ``step .. step + n - 1``, from position 0."""
        if n > self.size:
            raise ValueError(f"{n} steps do not fit a table of {self.size}")
        with profiling.span("sched.load"):
            vals = torch.tensor([self.schedule(step + j) for j in range(n)],
                                dtype=torch.float32)
            if self.table.device.type == "cuda":
                vals = vals.pin_memory()
            self.table[:n].copy_(vals, non_blocking=True)
            self.pos.zero_()
            self.step.fill_(int(step))

    def advance(self) -> None:
        """``lr`` <- the next step's rate; the position and the step count
        move on."""
        self.lr.copy_(self.table.index_select(
            0, self.pos.clamp(max=self.size - 1)).squeeze(0))
        self.pos.add_(1)
        self.step.add_(1)


def _device_step_optimizer(state: TrainState, params,
                           sched: DeviceSchedule) -> torch.Tensor:
    """:func:`step_optimizer` for a step a graph can hold: the rate comes
    from ``sched`` on the device, and ``state.step`` is left to the caller,
    which adds a dispatch's steps after it."""
    grads = [p.grad for p in params]
    sum_over_data_(grads)
    gnorm = global_norm(grads)
    if state.clip_groups:
        clip_by_module_norms_(state.clip_groups, state.grad_clip)
    elif state.grad_clip:
        clip_by_global_norm_(grads, state.grad_clip, gnorm)
    sched.advance()
    state.opt.step()
    return gnorm


def _make_scan_body(model, conf, fam: Family, mesh=None):
    """``(step(state, bag, sched=...) -> aux, params)``: the per-bag step of
    the scanned route. It is :func:`make_train_step`'s, on ``mesh`` too
    (:func:`_mesh_step`), with STKIM's branch decided on the device
    (``models/fast.py::_stkim_correct``, ``on_device``) and, when
    ``sched`` is given, the rate and the step count from the device, SAM
    steps and a family's own step body (MHIM) included."""
    custom = (fam.make_step_body(model, conf)
              if hasattr(fam, "make_step_body") else None)
    return _mesh_step(model, conf, fam, mesh, custom, scanned=True)


def _opt_tensors(opt) -> List[torch.Tensor]:
    return [t for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]


class ScanTrainStep:
    """``scan_step(state, stacked, chunk) -> sums``: the steps of the bags
    ``chunk`` (indices into the stacked group, in visit order), ``state``
    updated in place; ``sums`` are the sums of every ``aux`` entry over the
    chunk, on the device.

    ``route`` is ``"graph"`` or ``"eager"`` (:func:`scan_route`), ``reason``
    says why. Both run the same body in the same order with the same draws:
    STKIM's uniforms and dropout from ``state.generator`` and torch's
    default generator, registered with each graph (SAM's second pass takes
    the first's draws from a tape, ``parallel/mesh.py::DrawTape``). On a
    card the rate and the step count are the device's
    (:class:`DeviceSchedule`) on both routes, and the optimizer runs with
    ``capturable`` set; ``state.step`` is brought up to date after each
    chunk. The graph route captures every group of the first epoch after
    one warm-up step each, from which parameters, optimizer state, the EMA
    teacher and generators are put back.

    On a ``mesh`` the stacked groups hold this rank's part of each batch
    (``BagLoader.device_groups``) and the body is the per-bag mesh step's
    (:func:`_mesh_step`): every rank runs the same chunks in the same order
    and steps the same schedule, and the sums are the global batch's."""

    def __init__(self, model, conf, fam: Family, route: Optional[str] = None,
                 mesh=None):
        self.device = next(model.parameters()).device
        self.route, self.reason = scan_route(conf, self.device, mesh)
        if route is not None and route != self.route:
            if route == "graph" and self.device.type != "cuda":
                raise ValueError("the graph route needs a card")
            if route == "graph" and mesh is not None and mesh.world > 1:
                raise ValueError("the graph route runs on a mesh of one "
                                 "process only: " + self.reason)
            self.route, self.reason = route, f"{route} route asked for"
        self.body, self.params = _make_scan_body(model, conf, fam, mesh)
        self.device_lr = self.device.type == "cuda"
        self.keys: Optional[List[str]] = None
        self.acc: Optional[torch.Tensor] = None
        self.sched: Optional[DeviceSchedule] = None
        self.graphs: Optional[GraphSteps] = None
        self._state: Optional[TrainState] = None
        self._idx = torch.zeros(1, dtype=torch.int64, device=self.device)

    # -- the body and its sums -------------------------------------------
    def _run(self, bag) -> Dict[str, torch.Tensor]:
        return self.body(self._state, bag, sched=self.sched)

    def _record(self, stacked, aux, idx) -> None:
        if self.keys is None:
            self.keys = list(aux)
            self.acc = torch.zeros(len(self.keys), dtype=torch.float32,
                                   device=self.device)
        self.acc.add_(torch.stack([aux[k].float() for k in self.keys]))

    # -- set-up on the first call ----------------------------------------
    def _setup(self, state: TrainState, groups: List[Bag]) -> None:
        self._state = state
        if self.device_lr:
            self.sched = DeviceSchedule(
                state.schedule, sum(int(g.label.shape[0]) for g in groups),
                self.device)
            for group in state.opt.param_groups:
                group["lr"] = self.sched.lr
                if "capturable" in group and self.device.type == "cuda":
                    group["capturable"] = True
        if self.route == "graph":
            gens = [state.generator] if state.generator is not None else []
            self.graphs = GraphSteps(self._run, self._record, self.device,
                                     gens, warm=self._warm)
            self.graphs.prepare(groups)

    def _warm(self, groups: List[Bag]) -> None:
        """One step per group, then everything it changed put back."""
        state = self._state
        teacher = (list(state.teacher.state_dict().values())
                   if state.teacher is not None else [])
        with torch.no_grad():
            params = [p.detach().clone() for p in self.params]
            teacher_saved = [t.clone() for t in teacher]
            had = {id(p) for p in state.opt.state}
            opt_saved = [t.clone() for t in _opt_tensors(state.opt)]
        gen = state.generator.get_state() if state.generator else None
        cuda_rng = torch.cuda.get_rng_state(self.device)
        step = state.step
        for stacked in groups:
            self._idx.fill_(0)
            if self.sched is not None:
                self.sched.load(state.step, 1)
            self._record(stacked, self._run(take(stacked, self._idx)),
                         self._idx)
        with torch.no_grad():
            for p, saved in zip(self.params, params):
                p.copy_(saved)
            # the EMA teacher moved with the warm-up's steps
            for t, saved in zip(teacher, teacher_saved):
                t.copy_(saved)
            old = [t for p, st in state.opt.state.items() if id(p) in had
                   for t in st.values() if isinstance(t, torch.Tensor)]
            for t, saved in zip(old, opt_saved):
                t.copy_(saved)
            # state the warm-up created: zeros, as a first step finds it
            for p, st in state.opt.state.items():
                if id(p) not in had:
                    for t in st.values():
                        if isinstance(t, torch.Tensor):
                            t.zero_()
        if gen is not None:
            state.generator.set_state(gen)
        torch.cuda.set_rng_state(cuda_rng, self.device)
        state.step = step
        self.acc.zero_()

    # -- one dispatch ----------------------------------------------------
    def __call__(self, state: TrainState, stacked: Bag, chunk,
                 groups: Optional[List[Bag]] = None) -> Dict[str, torch.Tensor]:
        chunk = [int(i) for i in chunk]
        if self._state is None:
            self._setup(state, groups if groups is not None else [stacked])
        elif self._state is not state:
            raise ValueError("a scanned step serves the one TrainState it "
                             "was first called with")
        if self.sched is not None:
            self.sched.load(state.step, len(chunk))
        if self.acc is not None:
            self.acc.zero_()
        for i in chunk:
            if self.graphs is not None:
                self.graphs.replay(stacked, i)
            else:
                self._idx.fill_(i)
                self._record(stacked, self._run(take(stacked, self._idx)),
                             self._idx)
        if self.device_lr:
            state.step += len(chunk)
        return dict(zip(self.keys, self.acc.clone().unbind()))

    def kernel_launches(self) -> Dict[str, int]:
        """Kernel launches of the graph route's replays (empty eagerly,
        where the wrappers count their own)."""
        return self.graphs.kernel_launches() if self.graphs else {}


def make_scan_train_step(model, conf, family="acmil", mesh=None,
                         route: Optional[str] = None
                         ) -> Optional[ScanTrainStep]:
    """The scanned counterpart of :func:`make_train_step` (the JAX
    ``make_scan_train_step``), or None for a family that brings its own
    step without a step body (none does: every family scans). ``route``
    ("graph" or "eager") overrides :func:`scan_route`'s choice, to compare
    the two. On a ``mesh`` it takes this rank's part of each stacked group,
    as :func:`make_train_step` takes this rank's part of a batch."""
    fam = _resolve_family(family)
    if not family_supports_scan(fam):
        return None
    return ScanTrainStep(model, conf, fam, route, mesh)


class ScanEvalStep:
    """``scan_eval(stacked) -> probs [k, B, C]`` for a whole stacked group,
    with the model in eval mode: :func:`make_eval_step`'s forward per bag,
    eagerly or, on the graph route, as one CUDA graph per group (captured
    on the group's first call after one eager warm-up) replayed per bag
    into a buffer outside the pool. On a ``mesh`` it scores this rank's
    rows of each stacked group under the mesh's eval forward."""

    def __init__(self, model, family, fused: bool, route: str, mesh=None):
        self.step = make_eval_step(model, family, fused=fused, mesh=mesh)
        self.device = next(model.parameters()).device
        self.route = route
        self.out: Dict[int, torch.Tensor] = {}
        self.graphs = (GraphSteps(self.step, self._record, self.device,
                                  warm=self._warm)
                       if route == "graph" else None)
        self._idx = torch.zeros(1, dtype=torch.int64, device=self.device)

    def _warm(self, groups: List[Bag]) -> None:
        for stacked in groups:
            self._idx.fill_(0)
            probs = self.step(take(stacked, self._idx))
            self.out[GraphSteps.key(stacked)] = torch.zeros(
                (int(stacked.label.shape[0]),) + tuple(probs.shape),
                dtype=probs.dtype, device=self.device)

    def _record(self, stacked, probs, idx) -> None:
        self.out[GraphSteps.key(stacked)].index_copy_(0, idx, probs[None])

    def __call__(self, stacked: Bag) -> torch.Tensor:
        k = int(stacked.label.shape[0])
        if self.graphs is None:
            probs = []
            for i in range(k):
                self._idx.fill_(i)
                probs.append(self.step(take(stacked, self._idx)))
            return torch.stack(probs)
        self.graphs.prepare([stacked])
        for i in range(k):
            self.graphs.replay(stacked, i)
        return self.out[GraphSteps.key(stacked)].clone()

    def kernel_launches(self) -> Dict[str, int]:
        return self.graphs.kernel_launches() if self.graphs else {}


def make_scan_eval_step(model, family="default", fused: bool = True,
                        mesh=None, route: str = "eager") -> ScanEvalStep:
    """The scanned counterpart of :func:`make_eval_step`: probabilities for
    a whole stacked shape group, ``[k, B, C]`` (on a ``mesh``, this rank's
    rows), on ``route``: the trainer passes its train step's
    (``ScanTrainStep.route``); "graph" needs a card and, on a mesh, a
    world of one."""
    if route == "graph" and mesh is not None and mesh.world > 1:
        raise ValueError(f"the graph route runs on a mesh of one process "
                         f"only, not of {mesh.world}")
    return ScanEvalStep(model, family, fused, route, mesh)


def train_one_epoch_scanned(state: TrainState, scan_step, loader,
                            epoch: int, logger=None, interleave: int = 1
                            ) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch over ``loader.device_groups()`` in the JAX package's visit
    order: groups in a fresh random order and bags shuffled within their
    group; with ``interleave`` C > 1 each group's order is cut into C chunks
    and the chunks of all groups are shuffled together. ``scan_step`` runs
    one chunk (``(state, stacked, chunk, groups)``). The sums stay on the
    device and are read back once, at the end."""
    with profiling.span("epoch.train"):
        groups = loader.device_groups()
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        dispatches = []
        for gi, stacked in enumerate(groups):
            k = int(stacked.label.shape[0])
            perm = (loader.rng.permutation(k) if loader.shuffle
                    else np.arange(k))
            c = max(1, min(int(interleave), k))
            m = -(-k // c)                       # ceil(k / c)
            for lo in range(0, k, m):
                dispatches.append((gi, perm[lo:lo + m]))
        if loader.shuffle:
            order = loader.rng.permutation(len(dispatches))
        else:
            order = range(len(dispatches))
        for di in order:
            gi, chunk = dispatches[di]
            sums = scan_step(state, groups[gi], chunk, groups)
            n += len(chunk)
            for k, v in sums.items():
                totals[k] = totals[k] + v if k in totals else v.clone()
        keys = list(totals)
        with profiling.span("epoch.sums"):
            vals = (torch.stack([totals[k].float() for k in keys]).tolist()
                    if keys else [])
        profiling.settle()
        stats = {k: v / max(n, 1) for k, v in zip(keys, vals)}
        if logger is not None:
            logger.update(**stats)
        return state, stats


def evaluate_scanned(scan_eval_step, loader, n_class: int,
                     mesh=None) -> Dict[str, float]:
    """:func:`evaluate` over the loader's stacked shape groups, one
    ``scan_eval_step`` call per group; the same probabilities, metrics
    from one host transfer at the end. On a ``mesh`` each rank scores its
    rows of each group, and every data rank's probabilities, labels and
    valid flags are gathered once, at the end, as :func:`evaluate` gathers
    them: every rank then computes the same metrics."""
    with profiling.span("epoch.eval"):
        probs_dev, valid_dev, labels_dev = [], [], []
        for stacked in loader.device_groups():
            probs = scan_eval_step(stacked)                   # [k, B, C]
            rows = Bag(*(t.flatten(0, 1) for t in stacked._fields()))
            probs_dev.append(probs.reshape(-1, probs.shape[-1]))
            # at seq > 1 a rank's mask covers its slice of N only
            valid_dev.append(gather_seq(rows, mesh,
                                        feats=False).mask.any(dim=1))
            labels_dev.append(rows.label)
        return _gathered_metrics(probs_dev, valid_dev, labels_dev, n_class,
                                 mesh)


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
