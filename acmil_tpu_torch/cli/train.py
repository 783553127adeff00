"""Shared Step3 trainer, the port of ``acmil_tpu/cli/train.py``.

YAML + CLI config, dataset and loader setup, per-epoch train and val/test
eval, JSONL (or wandb) logging, best and last ``.pth`` checkpoints chosen on
val F1 + AUC, ``--resume`` and ``--eval_only``. The features
are the reference's H5 dump or a torch feature file (``data/ptio.py``):
``{data_dir}/patch_feats_pretrain_{pretrain}.h5``, else the same name with
``.pt``.

MHIM's teacher initialisation (``teacher_init``, ``init_stu_type``) loads a
pre-trained 'pure' checkpoint into the EMA teacher, and into the student
as ``init_stu_type`` says. ``use_sam: true`` (with ``sam_rho``) trains
every family but MHIM's with SAM steps (``engine/train.py::make_train_step``).

On a mesh the trainer runs one process per device, as ``torchrun`` starts
them: ``--mesh_data N`` (data N, seq 1), the YAML's ``mesh_shape: {data,
seq}``, or ``--pod`` (data over every process, seq 1; one process is a
world-1 mesh). The layout must equal ``WORLD_SIZE``, or the trainer raises
and names ``torchrun --nproc_per_node``. The backend is ``nccl`` on CUDA and
``gloo`` on the CPU unless the YAML's ``dist_backend`` names one; global rank
0 alone writes checkpoints, logs and prints, and every rank reads a
checkpoint for ``--resume`` and ``--eval_only``.

``--scan_epoch`` (or ``scan_epoch: true``) trains through the scanned epoch
of ``engine/train.py`` when the train bags are cached on the device
(``cache_train``, the JAX gate: B = 1, or a mesh with ``scan_epoch`` and a
family that scans, under ``n_data x 6 GiB`` of padded features): the
stacked shape groups visited in the JAX package's order
(``scan_interleave`` chunks), each group's step a CUDA graph on a card for
every arch of ``GRAPH_SCAN_ARCHS`` (the whole registry), SAM steps too,
eager on the CPU; val and test, and
``--eval_only``, score through ``evaluate_scanned``. On a mesh each rank
stacks its part of every batch; a mesh of several processes runs eagerly
(``gloo`` stages its collectives through the host, and NCCL capture across
cards has not been checked), a world of one as one process. Rank 0 prints
the route once.
"""

from __future__ import annotations

import argparse
import os
from pprint import pprint

import numpy as np
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import BagLoader, build_hdf5_feat_dataset
from acmil_tpu_torch.data.bags import bucket_length
from acmil_tpu_torch.engine import (create_train_state, evaluate,
                                    evaluate_scanned, family_supports_scan,
                                    get_family, make_eval_step,
                                    make_scan_eval_step, make_scan_train_step,
                                    make_train_step, train_one_epoch,
                                    train_one_epoch_scanned)
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.models import build_mil_model, model_family
from acmil_tpu_torch.parallel import shard_params
from acmil_tpu_torch.utils import MetricLogger, MetricsWriter, set_seed
from acmil_tpu_torch.utils.device import entry_device



def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, required=True, help="YAML config")
    p.add_argument("--seed", type=int, default=None)
    # default=None everywhere below: a non-None argparse default would
    # clobber the YAML value in load_conf's merge (Config supplies the
    # real defaults)
    p.add_argument("--wandb_mode", default=None,
                   choices=["offline", "online", "disabled"])
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--min_bucket", type=int, default=None)
    p.add_argument("--max_patches", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--train_epoch", type=int, default=None)
    p.add_argument("--B", type=int, default=None)
    p.add_argument("--n_shot", type=int, default=None)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel over this many processes (launch "
                        "with torchrun --nproc_per_node N)")
    p.add_argument("--pod", action="store_true", default=None,
                   help="data-parallel over every process of a multi-node "
                        "torchrun launch")
    p.add_argument("--scan_epoch", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="scanned epochs over stacked shape groups (CUDA "
                        "graphs on a card in one process; on a mesh each "
                        "rank's part of every group, eagerly across "
                        "processes)")
    p.add_argument("--resume", action="store_true",
                   help="resume from checkpoint-last.pth in ckpt_dir, with "
                        "the optimizer state and the best-so-far record")
    p.add_argument("--eval_only", "--eval-only", action="store_true",
                   help="skip training; evaluate checkpoint-best on val+test")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; without a card, "
                        "raises unless this is cpu)")
    return p


def load_conf(args) -> Config:
    overrides = {k: v for k, v in vars(args).items()
                 if k != "config" and v is not None}
    return Config.from_yaml(args.config, overrides)


def feature_file(conf) -> str:
    """``patch_feats_pretrain_{pretrain}`` in ``conf.data_dir``: the H5
    dump, else a torch feature file of the same name."""
    stem = os.path.join(conf.data_dir, f"patch_feats_pretrain_{conf.pretrain}")
    for path in (stem + ".h5", stem + ".pt"):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no feature file {stem}.h5 or {stem}.pt")


def _refuse_options(conf) -> None:
    family = model_family(conf.arch)
    if conf.extra.get("teacher_init") and not get_family(family).teacher:
        # the JAX trainer ignores it here; a set option that does nothing
        # is refused instead
        raise ValueError(f"'teacher_init' needs an arch with an EMA teacher "
                         f"(mhim); {conf.arch!r} trains with family "
                         f"{family!r}")


def init_teacher_student(state, conf, say=print) -> None:
    """MHIM's teacher initialisation (`Step3_MHIM:340-375`, the JAX
    ``init_teacher_student``): the teacher loads ``checkpoint-best.pth``,
    else ``checkpoint-last.pth``, of the ``teacher_init`` directory (or that
    file itself), a 'pure' run of the port or of the reference; then
    ``init_stu_type`` ``fc`` copies its ``patch_to_emb`` into the student,
    ``all`` every weight, ``none`` nothing. Any other type raises."""
    teacher_init = getattr(conf, "teacher_init", "")
    if not teacher_init:
        return
    stu_type = str(getattr(conf, "init_stu_type", "none"))
    if stu_type not in ("none", "fc", "all"):
        raise ValueError(f"init_stu_type must be none|fc|all, got {stu_type!r}")
    tag = ("best" if os.path.exists(checkpoint.checkpoint_path(
        teacher_init, "best")) else "last")
    weights = checkpoint.load(checkpoint.checkpoint_path(teacher_init,
                                                         tag))["model"]
    state.teacher.load_state_dict(weights)
    if stu_type == "all":
        state.model.load_state_dict(weights)
    elif stu_type == "fc":
        student = state.model.state_dict()
        with torch.no_grad():
            for k, v in weights.items():
                if k.startswith("patch_to_emb."):
                    student[k].copy_(v)
    say(f"teacher initialised from {teacher_init} ({tag}), "
        f"student init: {stu_type}")


def build_mesh(conf, device: torch.device):
    """The run's mesh from ``pod``, ``mesh_data`` or ``mesh_shape`` (the
    JAX trainer's order), or None when none is set. Joins the process
    group ``torchrun`` describes first (``parallel/mesh.py``)."""
    pod = bool(getattr(conf, "pod", False))
    mesh_data = getattr(conf, "mesh_data", None)
    shape = conf.mesh_shape
    if not (pod or mesh_data or shape):
        return None
    from acmil_tpu_torch.parallel import (init_distributed, make_mesh,
                                          make_pod_mesh)

    backend = getattr(conf, "dist_backend", None)
    if pod:
        return make_pod_mesh(seq=1, device=device, backend=backend)
    if mesh_data:
        data, seq = int(mesh_data), 1
    else:
        data, seq = int(shape.get("data", 1)), int(shape.get("seq", 1))
    # make_mesh raises, naming the torchrun launch, unless the world is
    # data x seq processes
    init_distributed(device, backend)
    return make_mesh(data, seq, device)


def run_training(conf: Config, extra_config: dict | None = None) -> dict:
    _refuse_options(conf)
    device = entry_device(conf.extra.get("device"))
    if any(getattr(conf, k, None) for k in ("pod", "mesh_data", "mesh_shape")):
        from acmil_tpu_torch.parallel import local_device

        device = local_device(conf.extra.get("device"))
    mesh = build_mesh(conf, device)
    lead = mesh is None or mesh.rank == 0
    set_seed(conf.seed)
    writer = MetricsWriter(mode=conf.wandb_mode if lead else "disabled",
                           log_dir=conf.log_dir, enabled=lead,
                           config={**conf.to_dict(), **(extra_config or {})})
    say = print if lead else (lambda *a, **k: None)
    say("Used config:")
    if lead:
        pprint(conf.to_dict())

    train_src, val_src, test_src = build_hdf5_feat_dataset(
        feature_file(conf), conf)
    # fp16 on the wire (features are stored fp16 anyway); eval loaders keep
    # their batches resident on the device across epochs
    kw = dict(min_bucket=conf.min_bucket, max_patches=conf.max_patches,
              dtype=np.float16, device=device, mesh=mesh)
    # train bags stay on the device too when they fit: with B = 1 (the
    # reference protocol) replaying cached single-bag batches in a fresh
    # random order is shuffled training; with B > 1 batch composition
    # would freeze. Sized by padded bucket lengths, as cached bags are.
    feat_bytes = sum(bucket_length(n, conf.min_bucket, conf.max_patches)
                     for n in train_src.lengths()) * conf.D_feat * 2
    # the model first: the gate asks whether its family scans
    model, family = (build_mil_model(conf) if mesh is None
                     else build_mil_model(conf, mesh=mesh))
    fam = get_family(family)
    # the JAX package's gate, so the same configuration caches (and may
    # scan) alike: on a mesh the cache is split over the data ranks, so the
    # budget scales with them, and B > 1 (a batch's composition frozen on
    # replay) is taken only where scanned epochs will run
    n_data = mesh.data if mesh is not None else 1
    scan_epoch = bool(getattr(conf, "scan_epoch", False))
    cache_ok = conf.B == 1 or (mesh is not None and scan_epoch
                               and family_supports_scan(fam))
    cache_train = bool(conf.extra.get(
        "cache_train", cache_ok and feat_bytes < n_data * 6 * 2 ** 30))
    train_loader = BagLoader(train_src, conf.B, shuffle=True, drop_last=True,
                             seed=conf.seed, cache_device=cache_train, **kw)
    val_loader = BagLoader(val_src, conf.B, cache_device=True, **kw)
    test_loader = BagLoader(test_src, conf.B, cache_device=True, **kw)

    model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    steps_per_epoch = max(len(train_loader), 1)
    conf.extra.setdefault("steps_per_epoch", steps_per_epoch)
    state = create_train_state(model, conf, steps_per_epoch, family=fam)
    init_teacher_student(state, conf, say)
    train_step = make_train_step(model, conf, fam, mesh=mesh)
    # `fused_train: false` opts eval out of the fused kernel too: the flag
    # exists to bisect a suspected kernel bug, which must cover val/test
    eval_step = make_eval_step(model, fam,
                               fused=bool(conf.extra.get("fused_train", True)),
                               mesh=mesh)

    # scanned epochs: stacked shape groups resident on the device, one CUDA
    # graph per group on a card; a family with a custom step and no step
    # body falls back to the per-bag loop, as in JAX
    scan_train = scan_eval = None
    if scan_epoch:
        if not cache_train:
            say("scan_epoch: train bags are not device-cached (B>1 on one "
                "process, cache_train: false, or features exceed the "
                "n_data x 6 GiB gate); using the per-bag loop")
        else:
            scan_train = make_scan_train_step(model, conf, fam, mesh=mesh)
            if scan_train is not None:
                scan_eval = make_scan_eval_step(
                    model, fam, fused=bool(conf.extra.get("fused_train", True)),
                    mesh=mesh, route=scan_train.route)
                say(f"scan_epoch: {scan_train.route} route "
                    f"({scan_train.reason})")
            else:
                say(f"scan_epoch: family '{family}' has a custom train "
                    "step; using the per-bag loop")

    def run_eval(loader):
        if scan_eval is not None:
            return evaluate_scanned(scan_eval, loader, conf.n_class, mesh=mesh)
        return evaluate(eval_step, loader, conf.n_class, mesh=mesh)

    ckpt_dir = conf.ckpt_dir
    best_path = checkpoint.checkpoint_path(ckpt_dir, "best")
    last_path = checkpoint.checkpoint_path(ckpt_dir, "last")

    if bool(getattr(conf, "eval_only", False)):
        tag, path = (("best", best_path) if os.path.exists(best_path)
                     else ("last", last_path))
        checkpoint.restore(path, state)
        val_m, test_m = run_eval(val_loader), run_eval(test_loader)
        say(f"[eval-only, {tag}] val auc {val_m['auc']:.4f} "
              f"f1 {val_m['f1']:.4f} | test auc {test_m['auc']:.4f} "
              f"f1 {test_m['f1']:.4f}")
        writer.finish()
        out = dict(val_m)
        out.update({f"test_{k}": v for k, v in test_m.items()})
        return out

    best: dict = {}
    start_epoch = 0
    if bool(getattr(conf, "resume", False)) and os.path.exists(last_path):
        start_epoch = int(checkpoint.restore(last_path, state)["epoch"]) + 1
        if os.path.exists(best_path):
            # restore the best-so-far record too, or the first resumed
            # epoch would overwrite checkpoint-best with a worse model
            saved = checkpoint.load(best_path)
            best = dict(saved.get("metrics", {}))
            best["epoch"] = int(saved["epoch"])
        say(f"resumed from epoch {start_epoch - 1} "
              f"(step {state.step}, best so far: {best or 'none'})")

    for epoch in range(start_epoch, conf.train_epoch):
        logger = MetricLogger()
        if scan_train is not None:
            state, stats = train_one_epoch_scanned(
                state, scan_train, train_loader, epoch, logger,
                interleave=int(getattr(conf, "scan_interleave", 1)))
        else:
            state, stats = train_one_epoch(state, train_step, train_loader,
                                           epoch, logger)
        if not np.isfinite(stats.get("loss", 0.0)):
            # surface divergence instead of burning the remaining epochs
            raise RuntimeError(
                f"non-finite training loss at epoch {epoch}: {stats}")
        say(f"Epoch [{epoch}] {logger}")
        writer.log({f"train/{k}": v for k, v in stats.items()}, commit=False)

        val_m, test_m = run_eval(val_loader), run_eval(test_loader)
        say(f"  val  auc {val_m['auc']:.4f} acc {val_m['acc']:.4f} "
              f"f1 {val_m['f1']:.4f} loss {val_m['loss']:.4f}")
        say(f"  test auc {test_m['auc']:.4f} acc {test_m['acc']:.4f} "
              f"f1 {test_m['f1']:.4f} loss {test_m['loss']:.4f}")
        writer.log({f"perf/val_{k}": v for k, v in val_m.items()},
                   commit=False)
        writer.log({f"perf/test_{k}": v for k, v in test_m.items()})

        prev_best_epoch = best.get("epoch")
        best = checkpoint.save_best_and_last(ckpt_dir, state, epoch, conf,
                                             val_m, best, write=lead)
        if best.get("epoch") == epoch and prev_best_epoch != epoch:
            best.update({f"test_{k}": v for k, v in test_m.items()})
    say("Results on best epoch:")
    say(best)
    writer.finish()
    return best


def main(argv=None, description="WSI MIL training (PyTorch)", defaults=None):
    parser = base_parser(description)
    if defaults:
        parser.set_defaults(**defaults)
    args = parser.parse_args(argv)
    return run_training(load_conf(args))


if __name__ == "__main__":
    main()
