"""Shared Step3 trainer, the port of ``acmil_tpu/cli/train.py``.

YAML + CLI config, dataset and loader setup, per-epoch train and val/test
eval, JSONL (or wandb) logging, best and last ``.pth`` checkpoints chosen on
val F1 + AUC, ``--resume`` and ``--eval_only``, on one device. The features
are the reference's H5 dump or a torch feature file (``data/ptio.py``):
``{data_dir}/patch_feats_pretrain_{pretrain}.h5``, else the same name with
``.pt``.

MHIM's teacher initialisation (``teacher_init``, ``init_stu_type``) loads a
pre-trained 'pure' checkpoint into the EMA teacher, and into the student
as ``init_stu_type`` says. The JAX trainer's data-parallel mesh
(``--mesh_data``, ``mesh_shape``), multi-host pods (``--pod``) and
``lax.scan`` epochs (``--scan_epoch``) are not ported; setting any of them
raises. ``use_sam: true`` (with ``sam_rho``) trains every family but MHIM's
with SAM steps (``engine/train.py::make_train_step``).
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
from acmil_tpu_torch.engine import (create_train_state, evaluate, get_family,
                                    make_eval_step, make_train_step,
                                    train_one_epoch)
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.models import build_mil_model, model_family
from acmil_tpu_torch.utils import MetricLogger, MetricsWriter, set_seed
from acmil_tpu_torch.utils.device import entry_device

# options of the JAX trainer this port does not have
NOT_PORTED = ("mesh_data", "mesh_shape", "pod", "scan_epoch")


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
                   help="not ported: raises if set")
    p.add_argument("--pod", action="store_true", default=None,
                   help="not ported: raises if set")
    p.add_argument("--scan_epoch", action=argparse.BooleanOptionalAction,
                   default=None, help="not ported: raises if set")
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


def _refuse_unported(conf) -> None:
    for key in NOT_PORTED:
        if conf.extra.get(key) not in (None, False, 0, "", {}):
            raise ValueError(f"{key!r} is a feature of the JAX package "
                             f"(acmil_tpu) that acmil_tpu_torch has not "
                             f"ported; unset it")
    family = model_family(conf.arch)
    if conf.extra.get("teacher_init") and not get_family(family).teacher:
        # the JAX trainer ignores it here; a set option that does nothing
        # is refused instead
        raise ValueError(f"'teacher_init' needs an arch with an EMA teacher "
                         f"(mhim); {conf.arch!r} trains with family "
                         f"{family!r}")


def init_teacher_student(state, conf) -> None:
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
    print(f"teacher initialised from {teacher_init} ({tag}), "
          f"student init: {stu_type}")


def run_training(conf: Config, extra_config: dict | None = None) -> dict:
    _refuse_unported(conf)
    device = entry_device(conf.extra.get("device"))
    set_seed(conf.seed)
    writer = MetricsWriter(mode=conf.wandb_mode, log_dir=conf.log_dir,
                           config={**conf.to_dict(), **(extra_config or {})})
    print("Used config:")
    pprint(conf.to_dict())

    train_src, val_src, test_src = build_hdf5_feat_dataset(
        feature_file(conf), conf)
    # fp16 on the wire (features are stored fp16 anyway); eval loaders keep
    # their batches resident on the device across epochs
    kw = dict(min_bucket=conf.min_bucket, max_patches=conf.max_patches,
              dtype=np.float16, device=device)
    # train bags stay on the device too when they fit: with B = 1 (the
    # reference protocol) replaying cached single-bag batches in a fresh
    # random order is shuffled training; with B > 1 batch composition
    # would freeze. Sized by padded bucket lengths, as cached bags are.
    feat_bytes = sum(bucket_length(n, conf.min_bucket, conf.max_patches)
                     for n in train_src.lengths()) * conf.D_feat * 2
    cache_train = bool(conf.extra.get(
        "cache_train", conf.B == 1 and feat_bytes < 6 * 2 ** 30))
    train_loader = BagLoader(train_src, conf.B, shuffle=True, drop_last=True,
                             seed=conf.seed, cache_device=cache_train, **kw)
    val_loader = BagLoader(val_src, conf.B, cache_device=True, **kw)
    test_loader = BagLoader(test_src, conf.B, cache_device=True, **kw)

    model, family = build_mil_model(conf)
    model.to(device)
    fam = get_family(family)
    steps_per_epoch = max(len(train_loader), 1)
    conf.extra.setdefault("steps_per_epoch", steps_per_epoch)
    state = create_train_state(model, conf, steps_per_epoch, family=fam)
    init_teacher_student(state, conf)
    train_step = make_train_step(model, conf, fam)
    # `fused_train: false` opts eval out of the fused kernel too: the flag
    # exists to bisect a suspected kernel bug, which must cover val/test
    eval_step = make_eval_step(model, fam,
                               fused=bool(conf.extra.get("fused_train", True)))

    def run_eval(loader):
        return evaluate(eval_step, loader, conf.n_class)

    ckpt_dir = conf.ckpt_dir
    best_path = checkpoint.checkpoint_path(ckpt_dir, "best")
    last_path = checkpoint.checkpoint_path(ckpt_dir, "last")

    if bool(getattr(conf, "eval_only", False)):
        tag, path = (("best", best_path) if os.path.exists(best_path)
                     else ("last", last_path))
        checkpoint.restore(path, state)
        val_m, test_m = run_eval(val_loader), run_eval(test_loader)
        print(f"[eval-only, {tag}] val auc {val_m['auc']:.4f} "
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
        print(f"resumed from epoch {start_epoch - 1} "
              f"(step {state.step}, best so far: {best or 'none'})")

    for epoch in range(start_epoch, conf.train_epoch):
        logger = MetricLogger()
        state, stats = train_one_epoch(state, train_step, train_loader, epoch,
                                       logger)
        if not np.isfinite(stats.get("loss", 0.0)):
            # surface divergence instead of burning the remaining epochs
            raise RuntimeError(
                f"non-finite training loss at epoch {epoch}: {stats}")
        print(f"Epoch [{epoch}] {logger}")
        writer.log({f"train/{k}": v for k, v in stats.items()}, commit=False)

        val_m, test_m = run_eval(val_loader), run_eval(test_loader)
        print(f"  val  auc {val_m['auc']:.4f} acc {val_m['acc']:.4f} "
              f"f1 {val_m['f1']:.4f} loss {val_m['loss']:.4f}")
        print(f"  test auc {test_m['auc']:.4f} acc {test_m['acc']:.4f} "
              f"f1 {test_m['f1']:.4f} loss {test_m['loss']:.4f}")
        writer.log({f"perf/val_{k}": v for k, v in val_m.items()},
                   commit=False)
        writer.log({f"perf/test_{k}": v for k, v in test_m.items()})

        prev_best_epoch = best.get("epoch")
        best = checkpoint.save_best_and_last(ckpt_dir, state, epoch, conf,
                                             val_m, best)
        if best.get("epoch") == epoch and prev_best_epoch != epoch:
            best.update({f"test_{k}": v for k, v in test_m.items()})
    print("Results on best epoch:")
    print(best)
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
