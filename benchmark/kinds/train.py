"""Traffic kind ``train``: Step3's scanned epochs on the graph route.

A cohort of bags whose lengths the mix fixes (the same set of sizes for
every seed; the seed orders them, labels them and draws their features on
the card), padded to power-of-two buckets and stacked per bucket as
``BagLoader.device_groups`` stacks them. One epoch is
``train_one_epoch_scanned`` over the train bags, then ``evaluate_scanned``
over the val and the test bags; the window runs whole epochs, closed loop,
and ``train_epoch_ms`` is its time over the epochs it completed.

What decides ``correct`` (``benchmark/limits/<cell>.json``): set-up builds
the one training step (model, optimizer, graphs) that the window then
drives, and before the window

- scores the val and test bags through the window's eval call at the
  initial weights (``eval_gap``: the largest probability gap);
- takes three steps through the window's own call on three distinct train
  bags (``loss_gap``: each step's loss; ``grad_gap``: the first gradient
  as the optimizer holds it after one step, by the worst leaf;
  ``change_gap``: the parameters' change after the three, by the median
  leaf, and ``leaf_change_off``: the leaves that moved by half again or by
  half less than the reference's, both leaving out leaves whose reference
  gradient is round-off);

and once the window has closed it counts what the window's epochs did:
``step_count_gap``, how far the optimizer's own step count (every
parameter's) is from one step a train bag of every epoch and the three
checked steps, and ``eval_count_gap``, how far the probabilities the eval
calls returned are from one a val or test bag of every epoch.

The plain reference (``benchmark/reference/acmil_ga.py``) computes the same
from the same initial weights, bags and STKIM draws, once the window has
closed and the program's state is freed.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from harness import checks
from harness.common import (Run, drive, phase, process_age_s, sub_seeds,
                            unit_summary)

BETA1 = 0.9                    # AdamW's, as create_train_state sets it
SPLITS = ("train", "val", "test")


# -- the cohort -------------------------------------------------------------

def cohort_lengths(traffic: dict) -> Dict[str, np.ndarray]:
    """The bag lengths of each split, drawn once from the mix's own seed:
    every run's seed gets the same sizes. The lognormal has the mix's
    ``mean`` (its median ``mean * exp(-sigma^2 / 2)``) before the clip."""
    ln = traffic["lengths"]
    total = sum(traffic["bags"][s] for s in SPLITS)
    rs = np.random.RandomState(ln["draw_seed"])
    mu = np.log(ln["mean"]) - ln["sigma"] ** 2 / 2
    lens = np.clip(rs.lognormal(mu, ln["sigma"], total),
                   ln["min"], ln["max"]).astype(np.int64)
    out, lo = {}, 0
    for s in SPLITS:
        k = traffic["bags"][s]
        out[s], lo = lens[lo:lo + k], lo + k
    return out


def bucket(n: int, min_bucket: int, max_patches: int) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_patches)


class Split:
    """What ``train_one_epoch_scanned`` and ``evaluate_scanned`` read of a
    loader: its stacked groups on the card, its generator and whether it
    shuffles."""

    def __init__(self, groups, lengths, rng, shuffle: bool):
        self.groups, self.lengths = groups, lengths   # lengths per group
        self.rng, self.shuffle = rng, shuffle

    def device_groups(self):
        return self.groups

    @property
    def n_bags(self) -> int:
        return sum(len(x) for x in self.lengths)


def make_split(lengths, labels, d_feat: int, traffic: dict, gen, rng,
               device, shuffle: bool) -> Split:
    """The bags of one split stacked per bucket, ``[k, 1, bucket, D]`` fp16
    features drawn on the device (zero at the pad slots), masks, zero
    coords and labels: the layout of ``BagLoader.device_groups`` at B = 1."""
    from acmil_tpu_torch.data.bags import Bag

    dtype = getattr(torch, traffic["feature_dtype"])
    by: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        by.setdefault(bucket(int(n), traffic["min_bucket"],
                             traffic["max_patches"]), []).append(i)
    groups, lens = [], []
    for b in sorted(by):
        idx = np.asarray(by[b])
        k = len(idx)
        n = torch.as_tensor(lengths[idx], device=device)
        mask = (torch.arange(b, device=device)[None, :] < n[:, None])[:, None]
        feats = torch.randn((k, 1, b, d_feat), generator=gen, device=device,
                            dtype=dtype)
        feats.mul_(mask[..., None])
        coords = torch.zeros((k, 1, b, 2), dtype=torch.int32, device=device)
        label = torch.as_tensor(labels[idx], dtype=torch.int64,
                                device=device)[:, None]
        groups.append(Bag(feats, mask, coords, label))
        lens.append([int(x) for x in lengths[idx]])
    return Split(groups, lens, rng, shuffle)


def head_conf(cell, stkim_seed: int):
    from acmil_tpu_torch.config import Config

    h = cell.config["head"]
    keys = ("arch", "n_class", "D_feat", "D_inner", "n_token",
            "n_masked_patch", "mask_drop", "lr", "min_lr", "wd", "B",
            "train_epoch", "warmup_epoch")
    d = {k: h[k] for k in keys}
    d.update(min_bucket=cell.traffic["min_bucket"],
             max_patches=cell.traffic["max_patches"], seed=stkim_seed)
    return Config.from_dict(d)


def init_weights(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """The head's initial weights, drawn on the device in one call: each
    weight and bias uniform in +-1/sqrt(fan_in) of its layer, torch's
    default Linear initialisation. Returns a copy by name, for the
    reference."""
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    lo = 0
    with torch.no_grad():
        for name, p in params.items():
            w = params[name.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / math.sqrt(w.shape[1])
            p.copy_(flat[lo:lo + p.numel()].view_as(p) * bound)
            lo += p.numel()
    return {k: p.detach().clone() for k, p in params.items()}


class Inputs:
    """The harness's inputs of one run, from its seed alone."""

    def __init__(self, cell, seed: int, device):
        s_feat, s_weight, s_stkim, s_order = sub_seeds(seed, 4)
        self.rng = np.random.default_rng(s_order)
        self.stkim_seed, self.weight_seed = s_stkim, s_weight
        gen = torch.Generator(device=device).manual_seed(s_feat)
        lens = cohort_lengths(cell.traffic)
        d_feat = cell.config["head"]["D_feat"]
        self.splits = {}
        for s in SPLITS:
            order = self.rng.permutation(len(lens[s]))
            labels = self.rng.permutation(np.arange(len(order)) % 2)
            self.splits[s] = make_split(lens[s][order], labels, d_feat,
                                        cell.traffic, gen, self.rng, device,
                                        shuffle=(s == "train"))
        # the three bags of the set-up's steps: (group, row), distinct
        train = self.splits["train"]
        flat = [(g, r) for g, ls in enumerate(train.lengths)
                for r in range(len(ls))]
        pick = self.rng.choice(len(flat), cell.traffic["check_steps"],
                               replace=False)
        self.picks = [flat[i] for i in pick]

    def step_bags(self):
        """The picked bags' valid rows, labels and buckets."""
        train = self.splits["train"]
        return [(train.groups[g].feats[r, 0, :train.lengths[g][r]],
                 int(train.groups[g].label[r, 0]),
                 int(train.groups[g].feats.shape[2]))
                for g, r in self.picks]

    def eval_bags(self):
        """The val then the test bags in the order ``evaluate_scanned``
        scores them: groups in order, rows in order."""
        out = []
        for s in ("val", "test"):
            sp = self.splits[s]
            for g, ls in zip(sp.groups, sp.lengths):
                for r, n in enumerate(ls):
                    out.append((g.feats[r, 0, :n], int(g.label[r, 0])))
        return out


def _ref_conf(cell) -> dict:
    h = dict(cell.config["head"])
    h["steps_per_epoch"] = cell.traffic["bags"]["train"]
    return h


# -- the run ------------------------------------------------------------------

def _epoch(state, scan, scan_eval, inputs, n_class: int, epoch: int):
    """One epoch: the train bags, then the val and the test bags; returns
    the epoch's losses as the host reads them back."""
    from acmil_tpu_torch.engine.train import (evaluate_scanned,
                                              train_one_epoch_scanned)

    with record_function("bench.train_epoch"):
        _, stats = train_one_epoch_scanned(state, scan,
                                           inputs.splits["train"], epoch)
    losses = [stats["loss"]]
    for s in ("val", "test"):
        with record_function(f"bench.eval_{s}"):
            losses.append(evaluate_scanned(scan_eval, inputs.splits[s],
                                           n_class)["loss"])
    return losses


def optimizer_steps(state, params) -> List[int]:
    """The optimizer's step count of each parameter, as its state holds it
    (0 where it has none)."""
    out = []
    for p in params:
        step = state.opt.state.get(p, {}).get("step", 0)
        out.append(int(float(step)))
    return out


def program(cell, inputs: Inputs, device, seconds: float, trace: bool):
    """Set-up, the three checked steps, the window. Returns the program's
    outputs to judge, the run's counts and its timings."""
    from acmil_tpu_torch.engine.train import (create_train_state,
                                              evaluate_scanned,
                                              make_scan_eval_step,
                                              make_scan_train_step)
    from acmil_tpu_torch.models import build_mil_model

    phase("cohort on the card")
    conf = head_conf(cell, inputs.stkim_seed)
    n_class = conf.n_class
    model, family = build_mil_model(conf)
    model.to(device)
    init = init_weights(model, inputs.weight_seed, device)
    names = list(init)
    named = dict(model.named_parameters())
    params = [named[k] for k in names]
    state = create_train_state(model, conf, inputs.splits["train"].n_bags,
                               family=family)
    route = "graph" if device.type == "cuda" else None
    scan = make_scan_train_step(model, conf, family, route=route)
    scan_eval = make_scan_eval_step(model, family, route=scan.route)

    phase("model and optimizer")
    # the eval at the initial weights, through the window's eval call
    seen = []

    def recorded(stacked):
        probs = scan_eval(stacked)
        seen.append(probs)
        return probs

    for s in ("val", "test"):
        evaluate_scanned(recorded, inputs.splits[s], n_class)
    probs0 = torch.cat([p.reshape(-1, n_class) for p in seen]).cpu()
    phase("eval at the initial weights (eval graphs captured)")

    # three steps through the window's call; the first captures the graphs
    train = inputs.splits["train"]
    losses, grad1 = [], None
    for j, (g, r) in enumerate(inputs.picks):
        sums = scan(state, train.groups[g], [r], train.groups)
        losses.append(float(sums["loss"]))
        if j == 0:
            grad1 = {}
            for k, p in zip(names, params):
                st = state.opt.state.get(p, {})
                m = st.get("exp_avg")
                grad1[k] = (m / (1 - BETA1) if m is not None
                            else torch.zeros_like(p)).detach().cpu()
    change = {k: (p.detach() - init[k]).cpu() for k, p in zip(names, params)}
    phase("three checked steps (train graphs captured)")

    # the window's eval calls, counted by the probabilities they return
    scored = [0]

    def counted(stacked):
        probs = scan_eval(stacked)
        scored[0] += probs.shape[0] * probs.shape[1]
        return probs

    # one whole epoch warms the host's path and the evals' replays
    _epoch(state, scan, counted, inputs, n_class, 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()

    epochs, failed = 0, 0

    def unit():
        nonlocal epochs, failed
        epochs += 1
        losses_e = _epoch(state, scan, counted, inputs, n_class, epochs)
        failed += not all(map(math.isfinite, losses_e))

    stats = {}
    units, window_s, traced, hosted = drive(
        unit, cell.traffic["trace_seconds"] if trace else seconds, device,
        trace, stats=stats)
    steps = optimizer_steps(state, params)
    n_train = train.n_bags
    n_eval = inputs.splits["val"].n_bags + inputs.splits["test"].n_bags
    want_steps = len(inputs.picks) + n_train * (1 + epochs)
    counts = {"step_count_gap": max(abs(s - want_steps) for s in steps),
              "eval_count_gap": abs(scored[0] - n_eval * (1 + epochs))}
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    graphs = [x.graphs for x in (scan, scan_eval) if x.graphs is not None]
    work = {"epochs": units,
            "train_lengths": [n for ls in train.lengths for n in ls],
            "eval_lengths": [n for s in ("val", "test")
                             for ls in inputs.splits[s].lengths for n in ls],
            "capture_s": (sum(sum(g.capture_s.values()) for g in graphs)
                          if graphs else None)}
    outputs = {"probs0": probs0, "losses": losses, "grad1": grad1,
               "change": change, "init": init, "counts": counts}
    per_epoch = n_train + n_eval
    return outputs, {"epochs": units, "attempted": epochs * per_epoch,
                     "failed": failed * per_epoch,
                     "detail": dict(unit_summary(stats), steps=steps[0],
                                    want_steps=want_steps),
                     "setup_s": setup_s, "window_s": window_s,
                     "memory": memory, "trace": traced, "hosted": hosted,
                     "work": work}


def reference_outputs(cell, inputs: Inputs, init, device, prec: str = "f32"):
    ref = cell.reference("head")
    conf = _ref_conf(cell)
    probs = ref.eval_probs(init, [f for f, _ in inputs.eval_bags()], conf,
                           prec)
    losses, grad1, change = ref.three_steps(init, inputs.step_bags(), conf,
                                            inputs.stkim_seed, device, prec)
    return {"probs0": probs.cpu(), "losses": losses,
            "grad1": {k: v.cpu() for k, v in grad1.items()},
            "change": {k: v.cpu() for k, v in change.items()}}


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers judged against ``benchmark/limits/<cell>.json``. The
    change after three steps is judged by its median leaf (``PERF.md``:
    the worst leaf's gap is Adam's amplified round-off on elements whose
    first gradient is all but zero, and swings from seed to seed), and by
    ``leaf_change_off``, the leaves that moved by half again or by half
    less than the reference's (a leaf left unmoved or moved double)."""
    loss_gap = max(checks.rel_gap(g, w)
                   for g, w in zip(got["losses"], want["losses"]))
    grad_gap, _ = checks.leaf_gap(got["grad1"], want["grad1"])
    moving = checks.moving_leaves(want["grad1"])
    change = checks.leaf_gaps(got["change"], want["change"], moving)
    off = sum(abs(checks.norm(got["change"][k]) - r) >= r / 2
              for k, r in ((k, checks.norm(want["change"][k]))
                           for k in moving))
    diff = (got["probs0"].double() - want["probs0"].double()).abs()
    eval_gap = float(diff.max()) if torch.isfinite(diff).all() else math.inf
    return dict({"loss_gap": loss_gap, "grad_gap": grad_gap,
                 "change_gap": statistics.median(change.values()),
                 "leaf_change_off": off, "eval_gap": eval_gap},
                **got.get("counts", {}))


def leaf_detail(got: dict, want: dict) -> dict:
    """Where the gaps of the gradient and of the change lie: each one's
    worst leaf, the change's worst leaf gap, and at the element of that
    leaf whose change differs most, its reference first gradient over the
    leaf's root mean square (Adam moves each element by about the learning
    rate whatever its gradient's size, so round-off on an element whose
    gradient is all but zero reaches the change whole)."""
    moving = checks.moving_leaves(want["grad1"])
    grad = checks.leaf_gaps(got["grad1"], want["grad1"])
    change = checks.leaf_gaps(got["change"], want["change"], moving)
    at = max(change, key=change.get)
    g1 = want["grad1"][at].double().flatten()
    i = int((got["change"][at].double() - want["change"][at].double())
            .abs().flatten().argmax())
    rms = float(g1.pow(2).mean().sqrt())
    return {"grad_leaf": max(grad, key=grad.get), "change_leaf": at,
            "change_worst_gap": change[at],
            "change_leaf_size": int(g1.numel()),
            "g1_over_rms_at_worst": abs(float(g1[i])) / max(rms, 1e-30)}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device) -> Run:
    inputs = Inputs(cell, seed, device)
    got, info = program(cell, inputs, device, seconds, trace)
    _free(device)                      # the program's state is gone now
    want = reference_outputs(cell, inputs, got["init"], device)
    numbers = compare(got, want)
    ok, checked = checks.judge(numbers, cell.limits)
    e2e = {"train_epoch_ms": 1e3 * info["window_s"] / info["epochs"],
           "setup_s": info["setup_s"]}
    return Run(ok and info["failed"] == 0, info["attempted"], info["failed"],
               e2e, checked, info["memory"], info["trace"], info["work"],
               info["hosted"], dict(info["detail"], **leaf_detail(got, want)))


def control(cell, seed: int, device, prec: str = "tf32") -> Dict[str, float]:
    """The control: the plain reference computed in ``prec`` put in the
    program's place, judged against the reference in f32."""
    inputs = Inputs(cell, seed, device)
    model_init = _control_init(cell, inputs, device)
    got = reference_outputs(cell, inputs, model_init, device, prec)
    want = reference_outputs(cell, inputs, model_init, device, "f32")
    # no window runs: the counts are the program's alone and read nothing
    got["counts"] = {"step_count_gap": 0, "eval_count_gap": 0}
    return compare(got, want)


def _control_init(cell, inputs: Inputs, device):
    from acmil_tpu_torch.models import build_mil_model

    model, _ = build_mil_model(head_conf(cell, inputs.stkim_seed))
    model.to(device)
    return init_weights(model, inputs.weight_seed, device)
