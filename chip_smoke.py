#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port starts and is right on an
NVIDIA GPU:

    python3 chip_smoke.py

It needs one card, builds every kernel from the sources in the checkout, and
imports nothing of JAX. Phases, in order; any failure raises and the exit
code is non-zero:

1. card: name and power limit (``nvidia-smi``); no CUDA device is an error.
2. build: kernels B1 (``acmil_tpu_torch/csrc/attn_pool.cu``), B2
   (``acmil_tpu_torch/csrc/attn_pool_bwd.cu``), and the ViT GEMM
   (``csrc/vit_gemm.cu``) and packed MHA B5' (``csrc/vit_attn.cu``) from which
   the B3 and B4 chains are built: one ``nvcc`` each, all together.
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
8. ViT kernels against their plain versions, bf16: B5' at the widths of
   ViT-S/16, ViT-S/8, CLIP-L/336 and GigaPath with B in {1, 64}; the B3
   chain at ViT-S/16 with B in {1, 7, 256} and at ViT-S/8's 785 tokens
   (outside the TPU's VMEM model, where the wrapper still launches); the B4
   chain at ViT-B/16, UNI (with layerscale, B=4 and the path's B=32) and
   ViT-S/8. Then each timed with CUDA events at its main path's shape, with
   the matrices in bf16 as the path holds them (B3 at B=256, B4 at UNI and
   B5' at CLIP-L/336, B=32),
   beside its plain version and, for B5', ``F.scaled_dot_product_attention``
   on the same qkv (a yardstick the port never calls).
9. Step2, slice 3's main path: ``cli/step2_extract.py``'s ``main`` extracts
   ViT-S/16 medical_ssl features (full width, depth 12, batch 256, seeded
   random weights) from three synthetic slides of 1135 patches on ``cuda``;
   the B3 chain must launch 12 times per batch; the features must be fp16,
   finite, ``[N, 384]`` and within cosine 0.999 per patch of the plain route
   (``fused=False``); ``cli/predict.py`` then scores the feature file with an
   ACMIL_GA head (B1 once per slide), pixels to probabilities.
10. ``vit_encode`` at UNI ViT-L/16 (B4) and CLIP-L/336 (B5') full width, depth
   2, B=32, against ``fused=False``.

The line before the last but one is ``{"kernels": [...]}`` with each
kernel's launches on its path, its worst error against the plain version,
its time, the plain version's, a library call's where one exists, and the
bound (the larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s); then the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.
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
# bounds: H100 SXM dense bf16/fp16 tensor-core peak and HBM rate, published
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
# ViT kernels vs their plain versions, bf16 both: the same rounding points
# (f32 LN, products, softmax and residuals; bf16 y, qkv, p, o, gelu output),
# so only the order of f32 sums differs, and it can flip a bf16 rounding by
# one step (2**-8 relative). A flipped p moves an output by up to
# 2**-8 * p * |v|, which is small against the largest output, not against an
# output that cancels to near 0: so each check allows TOL * |want| + TOL *
# max|want|, with B5' at one step either side and a chain at two (a flipped
# qkv, p or o element goes on through proj and the residual)
B5_TOL, CHAIN_TOL = 2.0 ** -7, 2.0 ** -6
COS_MIN = 0.999            # features of the fused and plain routes, per patch
# (name, dim, heads) of the trunks whose widths the ViT kernels are checked at
VIT_S16, VIT_S8 = (197, 384, 6), (785, 384, 6)
VIT_B16, UNI, CLIP_L, GIGA = (197, 768, 12), (197, 1024, 16), (577, 1024, 16), \
    (197, 1536, 24)
STEP2_BATCH, STEP2_DEPTH, PATCH_PX = 256, 12, 224
STEP2_SLIDES = ((5600, 3360), (4480, 4480), (6720, 2688))   # 375+400+360 patches
BIG_BATCH, BIG_DEPTH = 32, 2


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

    names = ("attn_pool", "attn_pool_bwd", "vit_gemm", "vit_attn")
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


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the HBM rate."""
    t_ops = flops / PEAK_FLOPS * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def _pool_weight_count(k: int) -> int:
    return (D_FEAT * D_INNER + D_INNER + 2 * (D_INNER * D_ATTN + D_ATTN)
            + D_ATTN * k + k)


def _b1_bound(n: int, k: int) -> dict:
    """B1 on one fp16 bag of n rows: x·W1, both gates, the logits and the
    pooling; reads the features, the mask and the f32 weights once, writes
    the logits, the bag and (m, s)."""
    flops = 2 * n * (D_FEAT * D_INNER + 2 * D_INNER * D_ATTN + D_ATTN * k
                     + k * D_INNER)
    nbytes = (n * D_FEAT * 2 + n + 4 * _pool_weight_count(k)
              + 4 * (k * n + k * D_INNER + 2 * k))
    return _bound(flops, nbytes)


def _b2_bound(n: int, k: int) -> dict:
    """B2 on one fp16 bag, weight gradients only: the forward's recompute
    (x·W1, gates, logits) and the backward's products (d_p, d_g, d_h, dW1,
    dV, dU, dw); reads features, mask, weights, lse, c, d_bag, d_logits,
    writes the weight gradients."""
    flops = 2 * n * (2 * D_FEAT * D_INNER + 6 * D_INNER * D_ATTN
                     + 3 * D_ATTN * k + 2 * D_INNER * k)
    nbytes = (n * D_FEAT * 2 + n + 8 * _pool_weight_count(k)
              + 4 * (2 * k + k * D_INNER + k * n))
    return _bound(flops, nbytes)


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
            "plain_ms": times[65536][1], **_b1_bound(65536, N_TOKEN),
            "library_ms": None}


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
            "ms": times[65536][0], "plain_ms": times[65536][1],
            **_b2_bound(65536, N_TOKEN), "library_ms": None}


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


def _layer_flops(n: int, d: int, hidden: int, mlp: bool) -> int:
    """One image through a ViT layer (mlp) or its attention half: the qkv,
    proj (and fc1, fc2) products and QK^T and PV over all heads."""
    flops = 2 * n * d * 3 * d + 2 * n * d * d + 4 * n * n * d
    return flops + (4 * n * d * hidden if mlp else 0)


def _layer_bytes(b: int, n: int, d: int, hidden: int, mlp: bool,
                 ls: bool) -> int:
    """bf16 x read and out written once; the bf16 matrices (cast once, as
    ``cast_kernel_weights`` gives them to the chain) and the f32 biases and
    LN parameters read once."""
    matrices = d * 3 * d + d * d + (2 * d * hidden if mlp else 0)
    vectors = 3 * d + d + 2 * d + (d if ls else 0)
    if mlp:
        vectors += hidden + d + 2 * d
    return 2 * 2 * b * n * d + 2 * matrices + 4 * vectors


def _vit_weights(gen, d, hidden, ls=False):
    """A layer's weights in the port's layout, seeded: LN near identity,
    Linear U(±scale/sqrt(fan_in)), qkv three times wider so the softmax is
    not flat; layerscale U(0.25, 0.75)."""
    def lin(out, inp, scale=1.0):
        w = (torch.rand(out, inp, generator=gen, device="cuda") * 2 - 1)
        return w * scale / math.sqrt(inp), 0.1 * torch.randn(
            out, generator=gen, device="cuda")

    def vec(base):
        return base + 0.1 * torch.randn(d, generator=gen, device="cuda")

    w = {"norm1.weight": vec(1.0), "norm1.bias": vec(0.0),
         "norm2.weight": vec(1.0), "norm2.bias": vec(0.0)}
    w["attn.qkv.weight"], w["attn.qkv.bias"] = lin(3 * d, d, 3.0)
    w["attn.proj.weight"], w["attn.proj.bias"] = lin(d, d)
    w["mlp.fc1.weight"], w["mlp.fc1.bias"] = lin(hidden, d)
    w["mlp.fc2.weight"], w["mlp.fc2.bias"] = lin(d, hidden)
    if ls:
        w["ls1.gamma"] = 0.25 + 0.5 * torch.rand(d, generator=gen,
                                                 device="cuda")
    return w


def _cast_matrices(w: dict) -> dict:
    """A layer's weights with its four matrices in bf16, the form the main
    path's ``cast_kernel_weights`` hands the chains."""
    return {k: v.bfloat16() if v.dim() == 2 else v for k, v in w.items()}


def _err(got, want, tol) -> float:
    """Worst |got - want|, after checking it is within tol·|want| +
    tol·max|want|."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))
    return float((got - want).abs().max())


@torch.no_grad()
def vit_kernels_vs_plain(smi: str) -> dict:
    """B5', B3 and B4 against their plain versions, bf16, then timed."""
    from acmil_tpu_torch.ops import vit_attn_packed as pk
    from acmil_tpu_torch.ops import vit_layer as vl

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"B3": 0.0, "B4": 0.0, "B5": 0.0}
    for name, (n, d, heads) in (("ViT-S/16", VIT_S16), ("ViT-S/8", VIT_S8),
                                ("CLIP-L/336", CLIP_L), ("GigaPath", GIGA)):
        for b in (1, 64):
            qkv = (2 * torch.randn(b, n, 3 * d, generator=gen,
                                   device="cuda")).bfloat16()
            got = pk.fused_mha_packed(qkv, heads)
            torch.cuda.synchronize()
            err = _err(got, pk._reference_packed(qkv, heads), B5_TOL)
            worst["B5"] = max(worst["B5"], err)
            print(f"kernel B5' vs plain: {name} N={n} D={d} H={heads} B={b} "
                  f"bf16: max_abs_err {err:.3e}")
    # B3 also at ViT-S/8's 785 tokens, outside the TPU's fits_vmem: on the
    # card the wrapper launches there too; B4 also at UNI's path shape
    cases = [("B3", vl.fused_vit_layer, vl._reference_layer, name, shape, b,
              False) for name, shape, b in (("ViT-S/16", VIT_S16, 1),
                                            ("ViT-S/16", VIT_S16, 7),
                                            ("ViT-S/16", VIT_S16, 256),
                                            ("ViT-S/8", VIT_S8, 2))]
    cases += [("B4", vl.fused_vit_attn_half, vl._reference_attn_half, name,
               shape, b, ls) for name, shape, b, ls in
              (("ViT-B/16", VIT_B16, 4, False), ("UNI ViT-L/16", UNI, 4, True),
               ("UNI ViT-L/16", UNI, BIG_BATCH, True),
               ("ViT-S/8", VIT_S8, 4, False))]
    for kern, fused, plain, name, (n, d, heads), b, ls in cases:
        w = _vit_weights(gen, d, 4 * d, ls)
        x = torch.randn(b, n, d, generator=gen, device="cuda").bfloat16()
        got = fused(x, w, heads)
        torch.cuda.synchronize()
        err = _err(got, plain(x, w, heads), CHAIN_TOL)
        worst[kern] = max(worst[kern], err)
        print(f"kernel {kern} chain vs plain: {name} N={n} D={d} H={heads} "
              f"B={b}{' ls1' if ls else ''} bf16: max_abs_err {err:.3e}")

    out = {}
    n, d, heads = VIT_S16
    w = _cast_matrices(_vit_weights(gen, d, 4 * d))
    x = torch.randn(STEP2_BATCH, n, d, generator=gen, device="cuda").bfloat16()
    out["B3"] = {"ms": _time_ms(lambda: vl.fused_vit_layer(x, w, heads), 20),
                 "plain_ms": _time_ms(lambda: vl._reference_layer(x, w, heads),
                                      10),
                 "library_ms": None,
                 **_bound(STEP2_BATCH * _layer_flops(n, d, 4 * d, True),
                          _layer_bytes(STEP2_BATCH, n, d, 4 * d, True, False))}
    n, d, heads = UNI
    w = _cast_matrices(_vit_weights(gen, d, 4 * d, ls=True))
    x = torch.randn(BIG_BATCH, n, d, generator=gen, device="cuda").bfloat16()
    out["B4"] = {"ms": _time_ms(lambda: vl.fused_vit_attn_half(x, w, heads),
                                20),
                 "plain_ms": _time_ms(
                     lambda: vl._reference_attn_half(x, w, heads), 10),
                 "library_ms": None,
                 **_bound(BIG_BATCH * _layer_flops(n, d, 0, False),
                          _layer_bytes(BIG_BATCH, n, d, 0, False, True))}
    n, d, heads = CLIP_L
    qkv = torch.randn(BIG_BATCH, n, 3 * d, generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.view(BIG_BATCH, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    out["B5"] = {"ms": _time_ms(lambda: pk.fused_mha_packed(qkv, heads), 20),
                 "plain_ms": _time_ms(lambda: pk._reference_packed(qkv, heads),
                                      10),
                 "library_ms": _time_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         q, k, v), 20),
                 **_bound(BIG_BATCH * 4 * n * n * d,
                          BIG_BATCH * 2 * (n * 3 * d + n * d))}
    for kern, shape in (("B3", f"ViT-S/16 B={STEP2_BATCH} N=197"),
                        ("B4", f"UNI B={BIG_BATCH} N=197 ls1"),
                        ("B5", f"CLIP-L/336 B={BIG_BATCH} N=577")):
        r = out[kern]
        lib = ("" if r["library_ms"] is None
               else f", scaled_dot_product_attention {r['library_ms']:.4f} ms")
        print(f"kernel {kern} time: {shape} bf16: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of "
              f"bound [{smi}]")
        r["max_abs_err"] = worst[kern]
    return out


def _write_step2_inputs(tmp: str):
    """Three synthetic PNG slides with every 224-px grid patch as Step1
    coords, in the torch coords file (the card's machine has no h5py)."""
    import cv2

    from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image
    from acmil_tpu_torch.wsi.tiling import save_coords_pt

    slide_dir, coords_dir = (os.path.join(tmp, d) for d in ("slides", "coords"))
    os.makedirs(slide_dir)
    labels = os.path.join(tmp, "labels.csv")
    with open(labels, "w") as f:
        f.write("slide_id,label\n")
        for i, (w, h) in enumerate(STEP2_SLIDES):
            name = f"slide_{i}"
            img, _ = make_synthetic_slide_image(w, h, seed=SEED + i,
                                                tumor=bool(i % 2))
            cv2.imwrite(os.path.join(slide_dir, f"{name}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            xs, ys = np.meshgrid(np.arange(0, w - PATCH_PX + 1, PATCH_PX),
                                 np.arange(0, h - PATCH_PX + 1, PATCH_PX),
                                 indexing="ij")
            save_coords_pt(os.path.join(coords_dir, f"{name}.pt"),
                           np.stack([xs.ravel(), ys.ravel()], 1),
                           {"patch_size": PATCH_PX, "patch_level": 0,
                            "downsample": 1.0})
            f.write(f"{name},{i % 2}\n")
    return slide_dir, coords_dir, labels


def _row_cosine(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-12)


def step2_run(smi: str) -> dict:
    """Slice 3's main path: Step2 extraction through the port's CLI, then
    scoring of the features it wrote."""
    import warnings

    from acmil_tpu_torch.cli import predict, step2_extract
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.patch_dataset import SlidePatchBatches
    from acmil_tpu_torch.engine import checkpoint
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.common import torch_linear_init_
    from acmil_tpu_torch.models.encoders.build import (build_encoder,
                                                       encoder_feature_fn,
                                                       preprocess)
    from acmil_tpu_torch.models.encoders.fast import (cast_kernel_weights,
                                                      vit_encode)
    from acmil_tpu_torch.ops import attn_pool, vit_attn_packed, vit_layer
    from acmil_tpu_torch.wsi.slide import open_slide
    from acmil_tpu_torch.wsi.tiling import load_coords_pt

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        slide_dir, coords_dir, labels = _write_step2_inputs(tmp)
        print(f"step2 inputs: {len(STEP2_SLIDES)} synthetic PNG slides "
              f"written in {time.perf_counter() - t0:.2f} s")
        out_dir = os.path.join(tmp, "feats")
        argv = ["--slide_dir", slide_dir, "--coords_dir", coords_dir,
                "--output_dir", out_dir, "--pretrain", "medical_ssl",
                "--backbone", "ViT-S/16", "--batch_size", str(STEP2_BATCH),
                "--label_csv", labels, "--coords_format", "pt",
                "--out_format", "pt", "--device", "cuda"]
        counters = (vit_layer.fused_vit_layer, vit_layer.fused_vit_attn_half,
                    vit_attn_packed.fused_mha_packed)
        for c in counters:
            c.launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")        # no pretrain_weights: seeded
            t0 = time.perf_counter()
            res = step2_extract.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        b3, b4, b5 = (c.launches for c in counters)
        batches = sum(-(-n // STEP2_BATCH) for n in res["slides"].values())
        if b3 != STEP2_DEPTH * batches or b4 or b5:
            raise AssertionError(f"B3/B4/B5 launched {b3}/{b4}/{b5} times: want "
                                 f"B3 {STEP2_DEPTH} x {batches} batches only")
        feats = torch.load(res["out_path"], weights_only=True)
        if res["patches"] < 1100 or len(feats) != len(STEP2_SLIDES):
            raise AssertionError(f"Step2 wrote {res['slides']}")

        # the same encoder (Step2 seeds its random init with 0) on the plain
        # route, over the same patch batches
        conf = Config.from_dict({"pretrain": "medical_ssl",
                                 "backbone": "ViT-S/16"})
        with warnings.catch_warnings(), torch.random.fork_rng(devices=[]):
            warnings.simplefilter("ignore")
            torch.manual_seed(0)
            model, spec, _ = build_encoder(conf)
        dev = torch.device("cuda")
        embed = encoder_feature_fn(model, spec, dev)
        plain = encoder_feature_fn(model, spec, dev, fused=False)
        worst_cos, worst_abs = 1.0, 0.0
        first_batch = None
        for name, item in sorted(feats.items()):
            coords, _, attrs = load_coords_pt(os.path.join(coords_dir,
                                                           f"{name}.pt"))
            f = item["feat"]
            if f.dtype != torch.float16 or tuple(f.shape) != (len(coords), 384) \
                    or not bool(torch.isfinite(f).all()):
                raise AssertionError(f"{name}: features {f.dtype} "
                                     f"{tuple(f.shape)}")
            slide = open_slide(os.path.join(slide_dir, f"{name}.png"))
            src = SlidePatchBatches(slide, coords, PATCH_PX, 0,
                                    target_size=spec.img_size,
                                    batch_size=STEP2_BATCH)
            ref = []
            for imgs, _, n in src:
                first_batch = imgs if first_batch is None else first_batch
                ref.append(plain(imgs)[:n])
            ref = torch.cat(ref)
            got = f.to(dev)
            worst_cos = min(worst_cos, float(_row_cosine(got, ref).min()))
            worst_abs = max(worst_abs, float((got.float() - ref.float())
                                             .abs().max()))
        if not worst_cos >= COS_MIN:
            raise AssertionError(f"fused vs plain features: cosine {worst_cos}")

        # encoder device time per batch of 256, pixels already on the card,
        # parameters as encoder_feature_fn holds them
        enc = model.encoder
        params = cast_kernel_weights(
            {k: v.to(dev) for k, v in enc.state_dict().items()},
            n_tok=(enc.img_size // enc.patch) ** 2 + 1, heads=enc.heads,
            dtype=enc.dtype)
        x = preprocess(torch.from_numpy(first_batch).to(dev), spec)
        kw = dict(patch=enc.patch, depth=enc.depth, heads=enc.heads,
                  dtype=enc.dtype)
        enc_ms = _time_ms(lambda: vit_encode(params, x, **kw), 5)
        plain_ms = _time_ms(lambda: vit_encode(params, x, **kw, fused=False),
                            3)
        embed_ms = _wall_ms(lambda: embed(first_batch), 5)
        # the host side of one batch: opening a slide (decode and pyramid),
        # then reading 256 patches, as SlidePatchBatches' thread does
        name0 = sorted(feats)[0]
        coords0, _, _ = load_coords_pt(os.path.join(coords_dir, f"{name0}.pt"))
        t0 = time.perf_counter()
        slide0 = open_slide(os.path.join(slide_dir, f"{name0}.png"))
        open_ms = (time.perf_counter() - t0) * 1e3
        src0 = SlidePatchBatches(slide0, coords0, PATCH_PX, 0,
                                 target_size=spec.img_size,
                                 batch_size=STEP2_BATCH)
        read_ms = statistics.median(
            _host_ms(lambda: src0._make(np.arange(STEP2_BATCH)))
            for _ in range(3))

        # pixels to probabilities: an ACMIL_GA head scores the feature file
        yml_conf = Config.from_yaml(YML, {"arch": "ga", "n_token": N_TOKEN})
        head, _ = build_mil_model(yml_conf)
        torch_linear_init_(head, torch.Generator().manual_seed(SEED))
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        checkpoint.save(ckpt, head, epoch=0, conf=yml_conf)
        attn_pool.fused_gated_attn_pool_batched.launches = 0
        scored = predict.main(["--config", YML, "--ckpt", ckpt, "--features",
                               res["out_path"], "--out_csv",
                               os.path.join(tmp, "preds.csv"),
                               "--device", "cuda"])
        b1 = attn_pool.fused_gated_attn_pool_batched.launches
        if b1 != len(feats):
            raise AssertionError(f"B1 launched {b1} times for {len(feats)} "
                                 f"slides")
        _check_predictions(scored, len(feats), yml_conf.n_class)
    print(f"step2: cli/step2_extract.py, ViT-S/16 medical_ssl full width, "
          f"depth {STEP2_DEPTH}, batch {STEP2_BATCH}: {res['patches']} patches "
          f"of {len(feats)} slides in {batches} batches; B3 launches {b3} "
          f"(= {STEP2_DEPTH} x {batches}); fp16 [N, 384] finite; fused vs "
          f"plain route worst cosine {worst_cos:.6f}, max_abs_err "
          f"{worst_abs:.3e}")
    print(f"step2 throughput: {res['patches'] / res['seconds']:.1f} patches/s "
          f"(wall of extraction, slide decode and patch reads included; "
          f"{wall:.2f} s for the whole main()); encoder device time per "
          f"batch of {STEP2_BATCH}: fused {enc_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; feature closure wall per batch from host "
          f"pixels {embed_ms:.4f} ms [{smi}]")
    print(f"step2 host side: opening a {STEP2_SLIDES[0][0]}x"
          f"{STEP2_SLIDES[0][1]} PNG slide (decode and pyramid) "
          f"{open_ms:.1f} ms; reading {STEP2_BATCH} patches of {PATCH_PX} px "
          f"{read_ms:.2f} ms (median of 3), against {enc_ms:.2f} ms of "
          f"encoder device time per batch")
    print(f"step2 -> cli/predict.py: {len(feats)} slides scored, B1 launches "
          f"{b1}, probabilities finite and rows sum to 1")
    return {"B3": b3, "B1": b1, "cosine": worst_cos}


@torch.no_grad()
def big_trunk_run(smi: str) -> dict:
    """vit_encode's attention-half route (UNI, B4) and packed route
    (CLIP-L/336, B5') at full width, depth 2, against the plain route."""
    from acmil_tpu_torch.models.encoders.build import (CLIP_MEAN, CLIP_STD,
                                                       IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       EncoderSpec,
                                                       preprocess)
    from acmil_tpu_torch.models.encoders.fast import (cast_kernel_weights,
                                                      vit_encode)
    from acmil_tpu_torch.models.encoders.vit import ViT
    from acmil_tpu_torch.ops import vit_attn_packed, vit_layer

    trunks = (("UNI ViT-L/16", "B4", vit_layer.fused_vit_attn_half,
               dict(patch=16, dim=1024, heads=16, layerscale=True),
               IMAGENET_MEAN, IMAGENET_STD),
              ("CLIP-L/336", "B5", vit_attn_packed.fused_mha_packed,
               dict(patch=14, dim=1024, heads=16, img_size=336, proj_dim=768,
                    pre_norm=True, act="quick_gelu"), CLIP_MEAN, CLIP_STD))
    launches = {}
    for name, kern, counter, kw, mean, std in trunks:
        torch.manual_seed(SEED)
        m = ViT(depth=BIG_DEPTH, **kw)
        gen = torch.Generator().manual_seed(SEED)
        for blk in m.blocks:
            for ls in (blk.ls1, blk.ls2):
                if hasattr(ls, "gamma"):
                    ls.gamma.data = 0.25 + 0.5 * torch.rand(ls.gamma.shape,
                                                            generator=gen)
        params = cast_kernel_weights(
            {k: v.cuda() for k, v in m.state_dict().items()},
            n_tok=(m.img_size // m.patch) ** 2 + 1, heads=m.heads,
            dtype=torch.bfloat16, act=m.act)
        spec = EncoderSpec(None, m.embed_dim, m.img_size, mean, std, "vit")
        u8 = torch.randint(0, 256, (BIG_BATCH, m.img_size, m.img_size, 3),
                           generator=gen, dtype=torch.uint8).cuda()
        x = preprocess(u8, spec)
        enc_kw = dict(patch=m.patch, depth=BIG_DEPTH, heads=m.heads,
                      act=m.act, pre_norm=m.pre_norm, proj_dim=m.proj_dim)
        counter.launches = 0
        got = vit_encode(params, x, **enc_kw)
        torch.cuda.synchronize()
        launches[kern] = counter.launches
        if launches[kern] != BIG_DEPTH:
            raise AssertionError(f"{name}: {kern} launched {launches[kern]} "
                                 f"times for {BIG_DEPTH} layers")
        want = vit_encode(params, x, **enc_kw, fused=False)
        cos = float(_row_cosine(got, want).min())
        if tuple(got.shape) != (BIG_BATCH, m.embed_dim) or cos < COS_MIN \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: {tuple(got.shape)}, cosine {cos}")
        t_f = _time_ms(lambda: vit_encode(params, x, **enc_kw), 5)
        t_p = _time_ms(lambda: vit_encode(params, x, **enc_kw, fused=False), 3)
        print(f"vit_encode {name}: full width, depth {BIG_DEPTH}, B={BIG_BATCH} "
              f"bf16: {kern} launches {launches[kern]}; fused vs plain route "
              f"worst cosine {cos:.6f}; device time fused {t_f:.4f} ms, plain "
              f"{t_p:.4f} ms [{smi}]")
    return launches


def main() -> None:
    smi = card()
    build()
    b1 = kernel_vs_plain(smi)
    b2 = bwd_kernel_vs_plain(smi)
    serve_launches = slice_run(smi)
    train_launches = train_run(smi)
    train_routes(smi)
    vit = vit_kernels_vs_plain(smi)
    step2 = step2_run(smi)
    big = big_trunk_run(smi)
    vit_src = "acmil_tpu_torch/csrc/vit_gemm.cu + acmil_tpu_torch/csrc/vit_attn.cu"
    print(json.dumps({"kernels": [{
        "name": "B1 fused gated-attention pooling (forward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:54",
        "launches": train_launches["B1"],
        "launches_serving": serve_launches,
        "launches_step2_scoring": step2["B1"],
        **b1}, {
        "name": "B2 fused gated-attention pooling (backward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool_bwd.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:240",
        "launches": train_launches["B2"],
        **b2}, {
        "name": "B3 fused ViT layer (chain: 4 GEMM launches + B5')",
        "route": "cuda",
        "source": vit_src,
        "replaces": "acmil_tpu/ops/vit_layer.py:45",
        "launches": step2["B3"],
        **vit["B3"]}, {
        "name": "B4 fused ViT attention half (chain: 2 GEMM launches + B5')",
        "route": "cuda",
        "source": vit_src,
        "replaces": "acmil_tpu/ops/vit_layer.py:239",
        "launches": big["B4"],
        **vit["B4"]}, {
        "name": "B5 packed multi-head attention (B5')",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn.cu",
        "replaces": "acmil_tpu/ops/vit_attn_packed.py:37",
        "launches": big["B5"],
        **vit["B5"]}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
