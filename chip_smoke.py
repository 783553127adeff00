#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port starts and is right on an
NVIDIA GPU:

    python3 chip_smoke.py

It needs one card, builds every kernel from the sources in the checkout, and
imports nothing of JAX. Phases, in order; any failure raises and the exit
code is non-zero:

1. card: name and power limit (``nvidia-smi``); no CUDA device is an error.
2. build: kernels B1 (``acmil_tpu_torch/csrc/attn_pool.cu``) and B2
   (``acmil_tpu_torch/csrc/attn_pool_bwd.cu``), one ``nvcc`` each, together.
3. kernel B1 against its plain PyTorch version on the card at the serving
   width (Df=384, L=A=128), K in {5, 1}, N in {300, 16384, 65536}, B=1 and
   B=3 with one all-masked bag, fp16 and f32 features; then both timed with
   CUDA events at N=16384 and 65536.
4. kernel B2 against its plain closed form and against torch autograd
   through the plain forward, at the same shapes, with dx off and on and
   cotangents that are nonzero at pad slots too; two launches must agree
   bit for bit. Then B2 and the plain backward timed at N=16384 and 65536.
5. serving: an ACMIL_GA head at the camelyon_medical_ssl widths
   (n_token=5, weights from a seeded ``torch.Generator``) scores 16
   synthetic slides of 1k-50k patches through ``cli/predict.py``'s ``main``
   on ``cuda``. B1 must launch once per slide; the probabilities must be
   finite, sum to 1 and match the plain model route (``fused=False``).
6. training, the slice's main path: ``cli/step3_acmil.py``'s ``main`` trains
   the ACMIL recipe (n_token 5, n_masked_patch 10, mask_drop 0.6) at the
   camelyon_medical_ssl widths for 2 epochs on 24 synthetic slides of
   1k-50k patches, on ``cuda``. B2 must launch once per train step and B1
   once per train step and once per eval bag; every epoch's loss must be
   finite; ``checkpoint-best.pth`` and ``checkpoint-last.pth`` must exist,
   and the best one must score slides through ``cli/predict.py``.
7. fused against plain training on one 50000-patch bag: from the same
   weights with the same STKIM uniforms, one step's loss and every gradient
   of the fused route (B1 + B2) match the plain route (forward and
   autograd), and five AdamW steps give matching losses; then the
   per-step wall time of both routes.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the training path, its worst error against the plain version and
both times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
YML = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")
D_FEAT, D_INNER, D_ATTN, N_TOKEN = 384, 128, 128, 5   # camelyon_medical_ssl, ACMIL
N_MASKED_PATCH, MASK_DROP = 10, 0.6                   # the README's ACMIL recipe
SEED = 0
# kernel vs plain: both f32 with TF32 off; only the order of the sums
# differs, over up to 384-term dots and 65536-term softmax sums
ATOL, RTOL = 1e-4, 1e-4
PROB_ATOL = 1e-5
# B2 vs plain, error relative to each output's largest magnitude: the weight
# gradients are sums over up to 3 x 65536 rows in other orders; an fp16 dx
# is rounded once to fp16 (2**-11 of the value)
BWD_REL, BWD_REL_FP16 = 1e-4, 1e-3
# fused vs plain training route, f32 both, TF32 off: one step's loss, and
# each gradient within STEP_GRAD_REL of its largest magnitude plus
# STEP_GRAD_ATOL; the routes differ in summation order and in how STKIM is
# applied (an O(K k) correction of the pooled bag against a masked softmax
# over N). The atol covers the attention's output bias, whose gradient is 0
# in exact arithmetic (the softmax ignores a shift of the logits), so both
# routes give rounding noise there
STEP_LOSS_RTOL, STEP_GRAD_REL, STEP_GRAD_ATOL = 1e-5, 1e-3, 1e-7
# losses over five AdamW steps: Adam divides by sqrt(v), which magnifies
# rounding in tiny gradient components, so the paths drift apart slowly
ADAM_LOSS_RTOL = 1e-3
F32_PEAK_TFLOPS = 67.0     # H100 SXM, CUDA cores, published
TRAIN_EPOCHS, N_TRAIN, N_VAL, N_TEST = 2, 16, 4, 4


def card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build() -> None:
    from acmil_tpu_torch.ops import _build

    names = ("attn_pool", "attn_pool_bwd")
    t0 = time.perf_counter()
    _build.build(*names)
    for name in names:
        _build.load(name)
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        info = _build.build_info.get(name, {})
        print(f"  {name}: nvcc {info.get('seconds', 0.0):.2f} s")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")


def _weights(gen, k):
    def uni(*shape, fan_in):
        b = fan_in ** -0.5
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * b

    return [uni(D_FEAT, D_INNER, fan_in=D_FEAT), torch.zeros(D_INNER, device="cuda"),
            uni(D_INNER, D_ATTN, fan_in=D_INNER), uni(D_ATTN, fan_in=D_INNER),
            uni(D_INNER, D_ATTN, fan_in=D_INNER), uni(D_ATTN, fan_in=D_INNER),
            uni(D_ATTN, k, fan_in=D_ATTN), uni(k, fan_in=D_ATTN)]


def _time_ms(fn, iters=30):
    """Mean device ms per call, L2 flushed before each call (a new slide
    arrives cold from the host)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def _wall_ms(fn, reps):
    """Median host ms of ``fn`` over ``reps`` calls, each waited on."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _rel_to_max(got, want) -> float:
    """Largest |got - want| relative to want's largest magnitude."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.float().abs().max()), 1e-30)


@torch.no_grad()
def kernel_vs_plain(smi: str) -> dict:
    from acmil_tpu_torch.ops import attn_pool as ap

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for k in (N_TOKEN, 1):
        ws = _weights(gen, k)
        for n in (300, 16384, 65536):
            for b in (1, 3):
                for dtype in (torch.float16, torch.float32):
                    x = torch.randn(b, n, D_FEAT, generator=gen,
                                    device="cuda").to(dtype)
                    m = torch.rand(b, n, generator=gen, device="cuda") < 0.9
                    if b == 3:
                        m[1] = False                  # an all-masked bag
                    bag, lg, mx, s = ap.fused_gated_attn_pool_batched(
                        x, m, *ws, return_stats=True)
                    torch.cuda.synchronize()
                    rbag, rlg = ap._reference_batched(x.float(), m, *ws)
                    rmx, rs = ap._softmax_stats(rlg, m)
                    valid = m[:, None, :].expand_as(lg)
                    for got, want in ((bag, rbag), (lg[valid], rlg[valid]),
                                      (mx, rmx)):
                        torch.testing.assert_close(got, want, atol=ATOL,
                                                   rtol=RTOL)
                    torch.testing.assert_close(s, rs, atol=0, rtol=RTOL)
                    if not bool((lg[~valid] == ap.NEG).all()):
                        raise AssertionError("pad logits are not NEG")
                    if bool(bag.isnan().any()) or (b == 3 and bool(bag[1].any())):
                        raise AssertionError("all-masked bag is not 0")
                    err = max(float((bag - rbag).abs().max()),
                              float((lg[valid] - rlg[valid]).abs().max()),
                              float((mx - rmx).abs().max()))
                    s_rel = float(((s - rs).abs() / rs.abs().clamp_min(1e-30)).max())
                    worst = max(worst, err)
                    print(f"kernel B1 vs plain: K={k} N={n} B={b} "
                          f"{str(dtype)[6:]}: max_abs_err {err:.3e} "
                          f"(bag, logits, m), s rel err {s_rel:.3e}")
    times = {}
    ws = _weights(gen, N_TOKEN)
    for n in (16384, 65536):
        x = torch.randn(1, n, D_FEAT, generator=gen, device="cuda").half()
        m = torch.ones(1, n, dtype=torch.bool, device="cuda")
        t_k = _time_ms(lambda: ap.fused_gated_attn_pool_batched(x, m, *ws))
        t_p = _time_ms(lambda: ap._reference_batched(x.float(), m, *ws))
        flops = 2 * n * (D_FEAT * D_INNER + 2 * D_INNER * D_ATTN
                         + D_ATTN * N_TOKEN + N_TOKEN * D_INNER)
        tflops = flops / (t_k * 1e-3) / 1e12
        print(f"kernel B1 time: N={n} B=1 K={N_TOKEN} fp16: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, kernel {tflops:.1f} TFLOP/s "
              f"({100 * tflops / F32_PEAK_TFLOPS:.0f}% of f32 CUDA-core peak) "
              f"[{smi}]")
        times[n] = (t_k, t_p)
    return {"max_abs_err": worst, "ms": times[65536][0],
            "plain_ms": times[65536][1]}


GRAD_NAMES = ("dx", "dW1", "db1", "dV", "dbv", "dU", "dbu", "dw", "dbw")


def _bwd_inputs(ap, gen, ws, x, m, k):
    """B1's forward on (x, m) and what the backward takes from it: lse, c,
    and random cotangents, d_logits nonzero at pad slots too."""
    b, n, _ = x.shape
    bag, _, mx, s = ap.fused_gated_attn_pool_batched(x, m, *ws,
                                                      return_stats=True)
    lse = mx + torch.log(s.clamp_min(1e-30))
    d_bag = torch.randn(b, k, D_INNER, generator=gen, device="cuda")
    d_logits = torch.randn(b, k, n, generator=gen, device="cuda")
    return lse, (d_bag * bag).sum(dim=2), d_bag, d_logits


def _reference_vjp(ap, x, m, ws, d_bag, d_logits, need_dx):
    """Torch autograd through the plain forward, f32."""
    with torch.enable_grad():
        xr = x.float().requires_grad_(need_dx)
        wr = [w.detach().clone().requires_grad_() for w in ws]
        outs = ap._reference_batched(xr, m, *wr)
        grads = torch.autograd.grad(outs, ([xr] if need_dx else []) + wr,
                                    (d_bag, d_logits))
    return ((grads[0] if need_dx else None),) + tuple(grads[-8:])


@torch.no_grad()
def bwd_kernel_vs_plain(smi: str) -> dict:
    from acmil_tpu_torch.ops import attn_pool as ap

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst_abs = worst_rel = 0.0
    for k in (N_TOKEN, 1):
        ws = _weights(gen, k)
        for n in (300, 16384, 65536):
            for b in (1, 3):
                for dtype in (torch.float16, torch.float32):
                    x = torch.randn(b, n, D_FEAT, generator=gen,
                                    device="cuda").to(dtype)
                    m = torch.rand(b, n, generator=gen, device="cuda") < 0.9
                    if b == 3:
                        m[1] = False                  # an all-masked bag
                    lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, k)
                    for need_dx in (False, True):
                        args = (x, m, *ws, lse, c, d_bag, d_logits)
                        got = ap.fused_gated_attn_pool_bwd(*args, need_dx=need_dx)
                        again = ap.fused_gated_attn_pool_bwd(*args,
                                                             need_dx=need_dx)
                        torch.cuda.synchronize()
                        for name, g, g2 in zip(GRAD_NAMES, got, again):
                            if g is not None and not torch.equal(g, g2):
                                raise AssertionError(
                                    f"B2 {name} differs between two launches")
                        plain = ap._fused_pool_bwd_stats(*args, need_dx=need_dx)
                        auto = _reference_vjp(ap, x, m, ws, d_bag, d_logits,
                                              need_dx)
                        errs = []
                        for name, g, p, a in zip(GRAD_NAMES, got, plain, auto):
                            if g is None:
                                if p is not None or need_dx:
                                    raise AssertionError(f"B2 gave no {name}")
                                continue
                            tol = BWD_REL_FP16 if g.dtype == torch.float16 else BWD_REL
                            rel = max(_rel_to_max(g, p), _rel_to_max(g, a))
                            if not rel <= tol:
                                raise AssertionError(
                                    f"B2 {name} off by {rel:.3e} of its max "
                                    f"(K={k} N={n} B={b} {dtype} dx={need_dx})")
                            errs.append(rel)
                            worst_abs = max(worst_abs, float(
                                (g.float() - p.float()).abs().max()))
                        worst_rel = max(worst_rel, max(errs))
                        if need_dx and bool(got[0][~m].any()):
                            raise AssertionError("B2 dx is nonzero at pad rows")
                        print(f"kernel B2 vs plain: K={k} N={n} B={b} "
                              f"{str(dtype)[6:]} dx={'on' if need_dx else 'off'}: "
                              f"worst error {max(errs):.3e} of max (vs closed "
                              f"form and vs autograd), two launches identical")
    times = {}
    ws = _weights(gen, N_TOKEN)
    for n in (16384, 65536):
        x = torch.randn(1, n, D_FEAT, generator=gen, device="cuda").half()
        m = torch.ones(1, n, dtype=torch.bool, device="cuda")
        lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, N_TOKEN)
        t_k = _time_ms(lambda: ap.fused_gated_attn_pool_bwd(
            x, m, *ws, lse, c, d_bag, d_logits, need_dx=False))
        with torch.enable_grad():
            wr = [w.detach().clone().requires_grad_() for w in ws]
            outs = ap._reference_batched(x.float(), m, *wr)
            t_p = _time_ms(lambda: torch.autograd.grad(
                outs, wr, (d_bag, d_logits), retain_graph=True))
        print(f"kernel B2 time: N={n} B=1 K={N_TOKEN} fp16, weight gradients "
              f"only: kernel {t_k:.4f} ms, plain autograd backward "
              f"{t_p:.4f} ms [{smi}]")
        times[n] = (t_k, t_p)
    return {"max_abs_err": worst_abs, "max_rel_to_max_err": worst_rel,
            "ms": times[65536][0], "plain_ms": times[65536][1]}


def _synthetic_slides(rs, lengths):
    """fp16 bags of the given lengths; odd slides carry a shifted 5% of
    their patches, the class signal."""
    slides = {}
    for i, n in enumerate(lengths):
        feat = rs.standard_normal((n, D_FEAT), dtype=np.float32)
        label = i % 2
        if label:
            feat[rs.choice(n, n // 20, replace=False)] += 1.5
        slides[f"slide_{i:02d}"] = {"feat": feat.astype(np.float16),
                                    "coords": rs.integers(0, 100000, (n, 2)),
                                    "label": label}
    return slides


def _check_predictions(res, n_slides, n_class):
    probs = np.asarray([r[2:2 + n_class] for r in res["rows"]])
    if probs.shape != (n_slides, n_class) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities {probs.shape}")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)


@torch.no_grad()
def slice_run(smi: str) -> int:
    from acmil_tpu_torch.cli import predict
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.engine import checkpoint, make_eval_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.common import torch_linear_init_
    from acmil_tpu_torch.ops.attn_pool import fused_gated_attn_pool_batched

    conf = Config.from_yaml(YML, {"arch": "ga", "n_token": N_TOKEN})
    if (conf.D_feat, conf.D_inner) != (D_FEAT, D_INNER):
        raise AssertionError(f"unexpected widths {conf.D_feat}/{conf.D_inner}")
    model, family = build_mil_model(conf)
    torch_linear_init_(model, torch.Generator().manual_seed(SEED))
    rs = np.random.default_rng(SEED)
    lengths = [1000, 50000] + rs.integers(1000, 50001, 14).tolist()
    slides = _synthetic_slides(rs, lengths)
    with tempfile.TemporaryDirectory() as tmp:
        feats = os.path.join(tmp, "feats.pt")
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        write_feature_pt(feats, slides)
        checkpoint.save(ckpt, model, epoch=0, conf=conf)
        argv = ["--config", YML, "--ckpt", ckpt, "--features", feats,
                "--out_csv", os.path.join(tmp, "preds.csv"), "--device", "cuda"]

        fused_gated_attn_pool_batched.launches = 0
        t0 = time.perf_counter()
        res = predict.main(argv)
        wall = time.perf_counter() - t0
        launches = fused_gated_attn_pool_batched.launches

    if launches != len(slides):
        raise AssertionError(f"B1 launched {launches} times for "
                             f"{len(slides)} slides (one batch each)")
    _check_predictions(res, len(slides), conf.n_class)

    model.cuda().eval()
    steps = {"fused": make_eval_step(model, family, fused=True),
             "plain": make_eval_step(model, family, fused=False)}
    lat = {route: [] for route in steps}
    worst = 0.0
    for row in res["rows"]:
        item = slides[row[0]]
        bag = pad_bag(item["feat"], item["coords"], item["label"],
                      min_bucket=conf.min_bucket,
                      max_patches=conf.max_patches, dtype=np.float16).to("cuda")
        plain = steps["plain"](bag)[0].cpu().numpy()
        worst = max(worst, float(np.abs(plain - row[2:2 + conf.n_class]).max()))
        for route, step in steps.items():
            step(bag)
            lat[route].append(_wall_ms(lambda: step(bag), 5))
    if worst > PROB_ATOL:
        raise AssertionError(f"fused and plain probabilities differ by {worst}")
    print(f"serving: {len(slides)} slides ({min(lengths)}-{max(lengths)} patches) "
          f"scored by cli/predict.py in {wall:.2f} s; B1 launches {launches}; "
          f"probabilities finite, rows sum to 1, max |fused - plain| {worst:.3e}")
    if res["metrics"] is not None:
        print("serving metrics (random weights): " + json.dumps(res["metrics"]))
    big = [r[0] for r in res["rows"]].index("slide_01")     # 50000 patches
    print(f"serving per-slide latency, bag on the device, median over slides: "
          f"fused {statistics.median(lat['fused']):.4f} ms, "
          f"plain {statistics.median(lat['plain']):.4f} ms; at 50000 patches: "
          f"fused {lat['fused'][big]:.4f} ms, plain {lat['plain'][big]:.4f} ms "
          f"[{smi}]")
    return launches


def train_run(smi: str) -> dict:
    """The slice's main path: Step3 ACMIL training through the port's CLI."""
    from acmil_tpu_torch.cli import predict, step3_acmil
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.ops import attn_pool as ap

    rs = np.random.default_rng(SEED + 1)
    n_slides = N_TRAIN + N_VAL + N_TEST
    lengths = [1000, 50000] + rs.integers(1000, 50001, n_slides - 2).tolist()
    slides = _synthetic_slides(rs, lengths)
    names = sorted(slides)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        feats = os.path.join(data_dir, "patch_feats_pretrain_medical_ssl.pt")
        write_feature_pt(feats, slides)
        # Step3's default seed is 4: its frozen split, over these slides
        split_dir = os.path.join(tmp, "splits")
        os.makedirs(os.path.join(split_dir, "camelyon"))
        with open(os.path.join(split_dir, "camelyon", "split_4.json"), "w") as f:
            json.dump({"train_names": names[:N_TRAIN],
                       "val_names": names[N_TRAIN:N_TRAIN + N_VAL],
                       "test_names": names[N_TRAIN + N_VAL:]}, f)
        yml = os.path.join(tmp, "config.yml")
        with open(YML) as src, open(yml, "w") as dst:
            dst.write(src.read() + f"\nsplit_dir: {split_dir}\n")
        ckpt_dir, log_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        argv = ["--config", yml, "--data_dir", data_dir, "--ckpt_dir", ckpt_dir,
                "--log_dir", log_dir, "--train_epoch", str(TRAIN_EPOCHS),
                "--n_token", str(N_TOKEN), "--n_masked_patch",
                str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                "--device", "cuda"]

        ap.fused_gated_attn_pool_batched.launches = 0
        ap.fused_gated_attn_pool_bwd.launches = 0
        t0 = time.perf_counter()
        best = step3_acmil.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": ap.fused_gated_attn_pool_batched.launches,
                    "B2": ap.fused_gated_attn_pool_bwd.launches}

        steps = TRAIN_EPOCHS * N_TRAIN
        evals = TRAIN_EPOCHS * (N_VAL + N_TEST)
        if launches["B2"] != steps or launches["B1"] != steps + evals:
            raise AssertionError(
                f"launches {launches}: want B2 once per train step ({steps}) "
                f"and B1 once per step and eval bag ({steps + evals})")
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "_config" not in r]
        losses = [r["train/loss"] for r in epochs]
        if len(losses) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"epoch losses {losses}")
        for tag in ("best", "last"):
            if not os.path.isfile(os.path.join(ckpt_dir, f"checkpoint-{tag}.pth")):
                raise AssertionError(f"no checkpoint-{tag}.pth")
        res = predict.main(["--config", yml, "--ckpt", ckpt_dir, "--features",
                            feats, "--out_csv", os.path.join(tmp, "preds.csv"),
                            "--device", "cuda"])
        _check_predictions(res, n_slides, 2)
    print(f"training: cli/step3_acmil.py, {TRAIN_EPOCHS} epochs x {N_TRAIN} "
          f"steps on {n_slides} slides ({min(lengths)}-{max(lengths)} patches), "
          f"{wall:.2f} s wall; launches B1 {launches['B1']} (= {steps} steps + "
          f"{evals} eval bags), B2 {launches['B2']}; epoch losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; best epoch "
          f"{best.get('epoch')}; checkpoint-best rescored {n_slides} slides "
          f"through cli/predict.py")
    return launches


def train_routes(smi: str) -> None:
    """Fused (B1 + B2) against plain (forward and autograd) training."""
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import (create_train_state, get_family,
                                        make_train_step)
    from acmil_tpu_torch.models import build_mil_model

    def route_conf(fused, stkim=True):
        return Config.from_yaml(YML, {
            "arch": "ga", "n_token": N_TOKEN, "fused_train": fused,
            "n_masked_patch": N_MASKED_PATCH if stkim else 0,
            "mask_drop": MASK_DROP})

    conf = route_conf(True)
    torch.manual_seed(SEED)
    model0, family = build_mil_model(conf)
    fam = get_family(family)
    rs = np.random.default_rng(SEED + 2)
    lengths = [50000, 20000, 35000]
    bags = [pad_bag(d["feat"], d["coords"], d["label"],
                    min_bucket=conf.min_bucket, max_patches=conf.max_patches,
                    dtype=np.float16).to("cuda")
            for d in _synthetic_slides(rs, lengths).values()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    us = [torch.rand(1, N_TOKEN, b.feats.shape[1], generator=gen,
                     device="cuda") for b in bags]

    one = {}
    for fused in (True, False):
        c = route_conf(fused)
        model = copy.deepcopy(model0).cuda()
        conf_d = fam.conf_dict(c)
        out = fam.train_outputs(model, bags[0], conf_d, stkim_u=us[0])
        loss, _ = fam.loss(out, bags[0], bags[0].mask.any(dim=1), conf_d)
        loss.backward()
        one[fused] = (float(loss.detach()),
                      {n: p.grad for n, p in model.named_parameters()})
    (l_f, g_f), (l_p, g_p) = one[True], one[False]
    if not abs(l_f - l_p) <= STEP_LOSS_RTOL * abs(l_p):
        raise AssertionError(f"one-step loss: fused {l_f} plain {l_p}")
    for n in g_p:
        err = float((g_f[n] - g_p[n]).abs().max())
        if not err <= STEP_GRAD_REL * float(g_p[n].abs().max()) + STEP_GRAD_ATOL:
            raise AssertionError(f"one-step gradient of {n} differs by {err:.3e}")
    worst = max(_rel_to_max(g_f[n], g_p[n]) for n in g_p
                if n != "attention.attention_weights.bias")
    print(f"training routes, one step at {lengths[0]} patches, STKIM on with "
          f"the same uniforms: loss fused {l_f:.7f} plain {l_p:.7f}; worst "
          f"gradient difference {worst:.3e} of its max over the other "
          f"{len(g_p) - 1} tensors, attention output bias "
          f"|fused| {float(g_f['attention.attention_weights.bias'].abs().max()):.3e} "
          f"|plain| {float(g_p['attention.attention_weights.bias'].abs().max()):.3e}")

    losses, per_step = {}, {}
    for name, fused, stkim in (("fused", True, True), ("plain", False, True),
                               ("fused, STKIM off", True, False)):
        c = route_conf(fused, stkim)
        model = copy.deepcopy(model0).cuda()
        state = create_train_state(model, c, steps_per_epoch=len(bags))
        step = make_train_step(model, c, family)
        losses[name] = [float(step(state, bags[i % 3], stkim_u=us[i % 3])["loss"])
                        for i in range(5)]
        per_step[name] = _wall_ms(lambda: step(state, bags[0], stkim_u=us[0]),
                                  20)
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["fused"],
                                                    losses["plain"]))
    if not worst <= ADAM_LOSS_RTOL:
        raise AssertionError(f"AdamW losses: {losses}")
    print(f"training routes, five AdamW steps over 3 bags: losses fused "
          f"{losses['fused']} plain {losses['plain']}, worst relative "
          f"difference {worst:.3e}")
    print(f"training step wall time at {lengths[0]} patches (bucket "
          f"{bags[0].feats.shape[1]}), median of 20, bag on the device: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in per_step.items())
          + f" [{smi}]")


def main() -> None:
    smi = card()
    build()
    b1 = kernel_vs_plain(smi)
    b2 = bwd_kernel_vs_plain(smi)
    serve_launches = slice_run(smi)
    train_launches = train_run(smi)
    train_routes(smi)
    print(json.dumps({"kernels": [{
        "name": "B1 fused gated-attention pooling (forward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:54",
        "launches": train_launches["B1"],
        "launches_serving": serve_launches,
        **b1}, {
        "name": "B2 fused gated-attention pooling (backward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool_bwd.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:240",
        "launches": train_launches["B2"],
        **b2}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
