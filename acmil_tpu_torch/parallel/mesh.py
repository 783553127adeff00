"""The ``(data, seq)`` mesh as ``torch.distributed`` process groups, the port
of ``acmil_tpu/parallel/mesh.py``.

PyTorch has no one-process-many-devices mesh, so the port runs one process
per device, as ``torchrun`` starts them. Rank ``r`` sits at ``(r // seq,
r % seq)``: ``seq`` innermost, as ``make_mesh`` lays it, and the ranks of
one data row consecutive, as ``make_pod_mesh`` groups devices process-major.
Step2's tensor-parallel mesh is ``(data, model)`` instead (``seq`` 1), rank
``r`` at ``(r // model, r % model)``: ``model`` innermost, as
``acmil_tpu/parallel/tp.py::make_tp_mesh`` lays it.

- ``data``: slides of a batch are split over the data ranks. Parameters are
  replicated, each data rank's loss is its share of the global loss, and
  the gradient is summed over the ``data`` group before the optimizer steps
  (``engine/train.py::step_optimizer``).
- ``seq``: the patch axis N of a bag is split over the seq ranks. The heads
  with a sequence path of their own (ACMIL_GA's fused pooling, TransMIL's
  Nystrom core) work on their slice and combine with collectives; every
  other head first gathers the bag over ``seq``.
- ``model``: Step2's ViT trunk is split over the model ranks, attention
  heads and MLP hidden units (``parallel/tp.py``); the ranks of one model
  group encode the same images.

While a step runs, its mesh is *active* (:func:`active`): the losses then
divide by global counts (:func:`batch_total`), and random draws take the
global batch's shape and keep this rank's rows (:func:`draw`), so a run
draws what the one-process run draws whatever the world size.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from acmil_tpu_torch.parallel import collectives as C

LAUNCH_HINT = "torchrun --nproc_per_node"


def init_distributed(device: Optional[torch.device] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> int:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), a group of one
    included; returns the world size. A process that torchrun did not
    start does nothing. The backend is ``nccl`` for a CUDA ``device`` and
    ``gloo`` otherwise, unless ``backend`` names one (``gloo`` puts several
    ranks on one card). ``timeout`` in seconds bounds every collective."""
    if dist.is_initialized():
        return dist.get_world_size()
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT")):
        return 1
    world = int(os.environ["WORLD_SIZE"])
    if backend is None:
        cuda = device is not None and torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]), **kw)
    return world


def local_device(name: Optional[str] = None) -> torch.device:
    """The device of this rank: ``name``, where a bare ``cuda`` means
    ``cuda:LOCAL_RANK``."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, seq, model)`` mesh of ``data * seq *
    model`` processes, ``model`` innermost (Step3 runs ``(data, seq)`` at
    model 1, Step2 ``(data, model)`` at seq 1). ``data_group``,
    ``seq_group`` and ``model_group`` are this rank's groups along each
    axis, None where the axis has size 1. ``backend`` names the process
    group's backend (``nccl``, ``gloo``), None outside a process group."""

    data: int
    seq: int
    rank: int
    device: torch.device
    data_group: object = None
    seq_group: object = None
    model: int = 1
    model_group: object = None
    backend: Optional[str] = None

    @property
    def world(self) -> int:
        return self.data * self.seq * self.model

    @property
    def data_index(self) -> int:
        return self.rank // (self.seq * self.model)

    @property
    def seq_index(self) -> int:
        return self.rank // self.model % self.seq

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def world_group(self):
        """The whole world's group, None in a single process."""
        return dist.group.WORLD if self.world > 1 else None


def make_mesh(data: Optional[int] = None, seq: int = 1,
              device: Optional[torch.device] = None,
              model: int = 1) -> Mesh:
    """The ``(data, seq, model)`` mesh over this process group (the world
    size must be ``data * seq * model``; ``data`` defaults to world //
    (seq * model)). Every rank calls ``new_group`` for every group, in one
    order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    inner = seq * model
    if data is None:
        data = world // inner
    if data < 1 or seq < 1 or model < 1 or data * inner != world:
        shape = (f"(data={data}, seq={seq})" if model == 1 else
                 f"(data={data}, model={model})" if seq == 1 else
                 f"(data={data}, seq={seq}, model={model})")
        raise ValueError(
            f"a {shape} mesh needs {data * inner} processes, one per device; "
            f"this run has {world}. Launch it with "
            f"`{LAUNCH_HINT} {data * inner}`")

    def at(d, s, m):
        return (d * seq + s) * model + m

    def axis_group(members):
        # this rank's group along one axis: one new_group per line of it
        mine = None
        for line in members:
            g = dist.new_group(line)
            if rank in line:
                mine = g
        return mine

    data_group = seq_group = model_group = None
    if data > 1:
        data_group = axis_group([[at(d, s, m) for d in range(data)]
                                 for s in range(seq) for m in range(model)])
    if seq > 1:
        seq_group = axis_group([[at(d, s, m) for s in range(seq)]
                                for d in range(data) for m in range(model)])
    if model > 1:
        model_group = axis_group([[at(d, s, m) for m in range(model)]
                                  for d in range(data) for s in range(seq)])
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(data, seq, rank, torch.device(device or "cpu"), data_group,
                seq_group, model, model_group, backend)


def make_pod_mesh(seq: int = 1, device: Optional[torch.device] = None,
                  backend: Optional[str] = None) -> Mesh:
    """The multi-node mesh: :func:`init_distributed`, then ``data`` over
    every process, ``seq`` consecutive ranks within a node. A single
    process gives the world-1 mesh, as ``make_pod_mesh`` does."""
    init_distributed(device, backend)
    return make_mesh(seq=seq, device=device)


def shard_bag(bag, mesh: Mesh, shard_seq: bool = False):
    """This rank's part of a global ``Bag``: its rows of the batch and, with
    ``shard_seq``, its contiguous slice of N. Refuses a batch the data axis
    does not divide, or a bag length the seq axis does not divide."""
    from acmil_tpu_torch.data.bags import Bag

    b, n = bag.mask.shape
    if b % mesh.data:
        raise ValueError(f"a batch of {b} bags does not split over the "
                         f"data axis of {mesh.data}")
    if shard_seq and n % mesh.seq:
        raise ValueError(f"a bag padded to {n} patches does not split over "
                         f"the seq axis of {mesh.seq}")
    rows = b // mesh.data
    r0 = mesh.data_index * rows
    out = [t[r0:r0 + rows] for t in (bag.feats, bag.mask, bag.coords,
                                     bag.label)]
    if shard_seq and mesh.seq > 1:
        cols = n // mesh.seq
        c0 = mesh.seq_index * cols
        out[:3] = [t[:, c0:c0 + cols] for t in out[:3]]
    return Bag(*out)


def gather_seq(bag, mesh: Optional[Mesh], feats: bool = True):
    """The whole bag of this rank's rows, its seq slices gathered (the
    bag as it is at seq 1). With ``feats`` False only the mask is gathered,
    and ``feats`` and ``coords`` stay this rank's slices."""
    if mesh is None or mesh.seq_group is None:
        return bag
    from acmil_tpu_torch.data.bags import Bag

    def whole(t):
        return torch.cat(C.gather_list(t, mesh.seq_group), dim=1)

    if not feats:
        return Bag(bag.feats, whole(bag.mask), bag.coords, bag.label)
    return Bag(whole(bag.feats), whole(bag.mask), whole(bag.coords),
               bag.label)


def shard_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replicate global rank 0's parameters and buffers on every rank of
    ``mesh``."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            C.broadcast_(t.data, 0, mesh.world_group)
    return module


# -- the active mesh: what the losses and random draws read ---------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh for the duration (a step)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    return _ACTIVE


def _data_split() -> Optional[Mesh]:
    mesh = _ACTIVE
    return mesh if mesh is not None and mesh.data > 1 else None


def batch_total(count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the active mesh's data ranks (no gradient): the
    global denominator of a mean over the batch."""
    mesh = _data_split()
    if mesh is None:
        return count
    return C.all_reduce_(count.detach().clone(), mesh.data_group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` (a tensor over this rank's batch rows) as a share
    of the mean over the global batch: the shares sum to it."""
    mesh = _data_split()
    return x.mean() if mesh is None else x.sum() / (x.numel() * mesh.data)


def weighted_mean(x: torch.Tensor, valid: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """The mean of ``x [B]`` over the rows where ``valid`` holds (all rows
    when None); under an active mesh, this rank's share of the mean over
    the global batch."""
    if valid is None:
        return batch_mean(x)
    w = valid.to(x.dtype)
    return (x * w).sum() / batch_total(w.sum()).clamp_min(1.0)


def replicated_share(x: torch.Tensor) -> torch.Tensor:
    """A loss term every data rank computes whole (one of the parameters
    alone), as this rank's share: the shares sum to it."""
    mesh = _data_split()
    return x if mesh is None else x / mesh.data


def global_rows(make, shape, batch_dim: int = 0) -> torch.Tensor:
    """``make(shape)``, a deterministic function of the shape whose
    ``batch_dim`` runs over this rank's rows of the batch: under an active
    mesh, this rank's rows of ``make`` of the global batch's shape."""
    mesh = _data_split()
    if mesh is None:
        return make(tuple(shape))
    shape = list(shape)
    rows = shape[batch_dim]
    shape[batch_dim] = rows * mesh.data
    full = make(tuple(shape))
    return full.narrow(batch_dim, mesh.data_index * rows, rows).contiguous()


class DrawTape:
    """The draws of one pass, handed back in order to a later pass: SAM's
    two passes (``ops/sam.py::sam_gradient``) then see the same STKIM
    uniforms, DTFD grouping and dropout masks, as JAX's two passes close
    over one rng dict. The generators advance once, in the recording pass,
    and nothing is read or set on the host, so a CUDA graph holds both
    passes as it holds one."""

    def __init__(self):
        self.draws = []
        self._replay: Optional[int] = None

    @contextlib.contextmanager
    def recording(self):
        """Within: every :func:`draw` is kept on the tape."""
        global _TAPE
        prev, _TAPE = _TAPE, self
        self.draws, self._replay = [], None
        try:
            yield self
        finally:
            _TAPE = prev

    @contextlib.contextmanager
    def replaying(self):
        """Within: each :func:`draw` returns the tape's next draw, which
        must have the shape, dtype and kind asked for; every draw on the
        tape must be taken."""
        global _TAPE
        prev, _TAPE = _TAPE, self
        self._replay = 0
        try:
            yield self
            if self._replay != len(self.draws):
                raise RuntimeError(f"the replaying pass took {self._replay} "
                                   f"of the {len(self.draws)} recorded draws")
        finally:
            _TAPE, self._replay = prev, None

    def _take(self, key) -> torch.Tensor:
        if self._replay >= len(self.draws):
            raise RuntimeError(f"the replaying pass draws more than the "
                               f"{len(self.draws)} recorded")
        want, out = self.draws[self._replay]
        if want != key:
            raise RuntimeError(f"draw {self._replay} of the replaying pass "
                               f"is {key}, the recorded one {want}")
        self._replay += 1
        return out


_TAPE: Optional[DrawTape] = None


def draw(shape, generator: Optional[torch.Generator], device,
         dtype: Optional[torch.dtype] = None, normal: bool = False,
         batch_dim: int = 0) -> torch.Tensor:
    """``torch.rand`` (``torch.randn`` when ``normal``) of ``shape``, whose
    ``batch_dim`` runs over this rank's rows of the batch: under an active
    mesh the global batch's draw is made and this rank's rows kept, so the
    values do not depend on the world size. Under a :class:`DrawTape` the
    draw is recorded, or taken from the tape."""
    tape = _TAPE
    key = (tuple(int(s) for s in shape), dtype, normal, batch_dim)
    if tape is not None and tape._replay is not None:
        return tape._take(key)
    fn = torch.randn if normal else torch.rand
    out = global_rows(lambda s: fn(s, generator=generator, device=device,
                                   dtype=dtype), shape, batch_dim)
    if tape is not None:
        tape.draws.append((key, out))
    return out
