"""Traffic kind ``extract``: Step2's trunk from decoded pixels.

A pool of uint8 patch batches ``[B, H, W, 3]`` in host memory, drawn from
the seed at set-up, goes batch after batch, closed loop, through the
program's Step2 closure (``encoder_feature_fn``: pinned H2D, preprocess,
``vit_encode`` on the trunk's route, fp16 out). The features of a slide's
batches (``batches_per_slide`` of them) come back to host memory together,
as ``cli/step2_extract.py`` copies a slide's. ``extract_patches_per_s`` is
the patches whose features reached the host over the window's time, which
runs whole slides.

What decides ``correct`` (``benchmark/limits/<cell>.json``): once the
window has closed, a sample of the window's answers drawn from the seed
(patches of batches it returned), against the plain reference
(``benchmark/reference/vit.py``) on the same pixels and the same f32
weights: ``feat_gap``, the largest of ``|f - r| / |r|`` over the sampled
patches; and ``answer_count_gap``, how many of the window's patches came
back to the host without their features.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from harness import checks
from harness.common import (Run, drive, phase, process_age_s, sub_seeds,
                            unit_summary)


def trunk_weights(shapes: Dict[str, tuple], seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    """The trunk's f32 weights by timm name, drawn on the device in one
    call: matrices, the patch embed, the cls token and the position
    embedding N(0, 0.02^2) (timm's ViT initialisation), biases
    N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.1^2), layer scales
    0.5 + N(0, 0.1^2) (trained values, not DINOv2's 1e-5 start)."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, lo = {}, 0
    for name, shape in shapes.items():
        z = flat[lo:lo + math.prod(shape)].view(shape)
        lo += z.numel()
        leaf = name.rsplit(".", 1)
        if name.endswith(".gamma"):
            t = 0.5 + 0.1 * z
        elif len(leaf) == 2 and leaf[1] == "weight" and "norm" in leaf[0]:
            t = 1.0 + 0.1 * z
        else:
            t = 0.02 * z
        out[name] = t.clone()
    del flat
    return out


class Inputs:
    """The trunk's weights (drawn on the device) and the pixel pool (in host
    memory, where Step2's reader hands its batches over), from the run's
    seed."""

    def __init__(self, cell, seed: int, device):
        s_weight, s_pix, s_sample = sub_seeds(seed, 3)
        trunk, traffic = cell.config["trunk"], cell.traffic
        self.trunk, self.sample_seed = trunk, s_sample
        self.check_rows = traffic["check_rows"]
        self.model, self.spec = _trunk_module(trunk, device)
        shapes = {k: tuple(v.shape)
                  for k, v in self.model.encoder.state_dict().items()}
        self.weights = trunk_weights(shapes, s_weight, device)
        self.model.encoder.load_state_dict(self.weights, assign=True)
        size = trunk["img_size"]
        self.pool = list(np.random.default_rng(s_pix).integers(
            0, 256, (traffic["pool_batches"], trunk["batch_size"], size, size,
                     3), dtype=np.uint8))

    def sample(self, n_batches: int):
        """(batch, row) of the answers checked, drawn from the seed among
        the window's ``n_batches`` batches."""
        rows = self.trunk["batch_size"]
        k = min(self.check_rows, n_batches * rows)
        rng = np.random.default_rng(self.sample_seed)
        pick = np.sort(rng.choice(n_batches * rows, k, replace=False))
        return [(int(i // rows), int(i % rows)) for i in pick]


def _trunk_module(trunk: dict, device):
    """The program's trunk module for this configuration, built on the
    device (its weights are assigned afterwards), and its spec."""
    from acmil_tpu_torch.models.encoders.build import (CustomModel,
                                                       encoder_spec)

    class _Conf:
        pretrain, backbone = trunk["pretrain"], trunk["backbone"]

    spec = encoder_spec(_Conf)
    with torch.device(device):
        enc = spec.builder(getattr(torch, trunk["dtype"]))
    stated = dict(patch=enc.patch, dim=enc.dim, depth=enc.depth,
                  heads=enc.heads, img_size=enc.img_size,
                  layerscale=enc.layerscale, act=enc.act)
    for key, value in stated.items():
        if trunk[key] != value:
            raise ValueError(f"the configuration says {key}={trunk[key]}, "
                             f"the program's trunk has {value}")
    hidden = enc.blocks[0].mlp.fc1.out_features
    if hidden != trunk["mlp_hidden"]:
        raise ValueError(f"mlp_hidden {trunk['mlp_hidden']} != {hidden}")
    if tuple(spec.mean) != tuple(trunk["mean"]) or \
            tuple(spec.std) != tuple(trunk["std"]):
        raise ValueError("the configuration's normalisation is not the "
                         "program's")
    return CustomModel(enc, 2), spec


def program(cell, inputs: Inputs, device, seconds: float, trace: bool):
    from acmil_tpu_torch.models.encoders.build import encoder_feature_fn

    phase("weights and pixel pool")
    feat_fn = encoder_feature_fn(inputs.model, inputs.spec, device)
    phase("kernel weights cast")
    pool = inputs.pool
    outs = []
    per_slide = cell.traffic["batches_per_slide"]

    def unit(encoded=per_slide):
        # one slide: its batches' features stay on the device and come back
        # to the host together, as cli/step2_extract.py copies a slide's
        with record_function("bench.encode"):
            feats = [feat_fn(pool[(len(outs) + i) % len(pool)])
                     for i in range(encoded)]
        with record_function("bench.copy_back"):
            feats += feats[-1:] * (per_slide - encoded)
            outs.extend(torch.cat(feats).cpu().split(len(feats[0])))

    # the warm-up: a slide's shapes, with a few batches encoded
    unit(min(cell.traffic["warm_batches"], per_slide))
    outs.clear()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()
    stats = {}
    slides, window_s, traced, hosted = drive(
        unit, cell.traffic["trace_seconds"] if trace else seconds, device,
        trace, cell.traffic["hosted_slides"], stats)
    batches = slides * per_slide
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    del feat_fn
    failed = sum(not bool(torch.isfinite(o).all()) for o in outs)
    # every slide the run sent, the hosted ones of a traced run too
    sent = (slides + (cell.traffic["hosted_slides"] if trace else 0)) * \
        per_slide * cell.config["trunk"]["batch_size"]
    return outs, {"batches": batches, "failed": failed, "sent": sent,
                  "returned": sum(len(o) for o in outs),
                  "detail": unit_summary(stats),
                  "setup_s": setup_s, "window_s": window_s,
                  "memory": memory, "trace": traced, "hosted": hosted,
                  "work": {"batches": batches,
                           "batch_size": cell.config["trunk"]["batch_size"]}}


def reference_rows(cell, inputs: Inputs, picks, device, prec: str = "f32"):
    ref = cell.reference("trunk")
    pool = inputs.pool
    pix = np.stack([pool[b % len(pool)][r] for b, r in picks])
    return ref.features(inputs.weights, torch.from_numpy(pix).to(device),
                        inputs.trunk, prec,
                        cell.traffic["reference_block"]).cpu()


def compare(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    got, want = got.double(), want.double()
    gap = (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)
    return {"feat_gap": float(gap.max()) if torch.isfinite(gap).all()
            else math.inf}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device) -> Run:
    inputs = Inputs(cell, seed, device)
    outs, info = program(cell, inputs, device, seconds, trace)
    _free(device)                      # the program's state is gone now
    picks = inputs.sample(len(outs))
    got = torch.stack([outs[b][r] for b, r in picks])
    want = reference_rows(cell, inputs, picks, device)
    numbers = dict(compare(got, want),
                   answer_count_gap=abs(info["sent"] - info["returned"]))
    ok, checked = checks.judge(numbers, cell.limits)
    n = info["batches"] * cell.config["trunk"]["batch_size"]
    e2e = {"extract_patches_per_s": n / info["window_s"],
           "setup_s": info["setup_s"]}
    return Run(ok and info["failed"] == 0, len(outs), info["failed"],
               e2e, checked, info["memory"], info["trace"], info["work"],
               info["hosted"], info["detail"])


def control(cell, seed: int, device, prec: str = "fp8") -> Dict[str, float]:
    """The control: the plain reference computed in ``prec`` put in the
    program's place, on as many sampled answers as a run checks."""
    inputs = Inputs(cell, seed, device)
    picks = inputs.sample(len(inputs.pool))
    got = reference_rows(cell, inputs, picks, device, prec)
    want = reference_rows(cell, inputs, picks, device, "f32")
    # no window runs: the count is the program's alone and reads nothing
    return dict(compare(got, want), answer_count_gap=0)
