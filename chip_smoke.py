#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port starts and is right on an
NVIDIA GPU:

    python3 chip_smoke.py

It needs one card, builds every kernel from the sources in the checkout, and
imports nothing of JAX. Phases, in order; any failure raises and the exit
code is non-zero:

1. card: name and power limit (``nvidia-smi``); no CUDA device is an error.
2. build: kernel B1 from ``acmil_tpu_torch/csrc/attn_pool.cu``.
3. kernel B1 against its plain PyTorch version on the card at the serving
   width (Df=384, L=A=128), K in {5, 1}, N in {300, 16384, 65536}, B=1 and
   B=3 with one all-masked bag, fp16 and f32 features; then both timed with
   CUDA events at N=16384 and 65536.
4. the slice: an ACMIL_GA head at the camelyon_medical_ssl widths
   (n_token=5, weights from a seeded ``torch.Generator``) scores 16
   synthetic slides of 1k-50k patches through ``cli/predict.py``'s ``main``
   on ``cuda``. B1 must launch once per slide; the probabilities must be
   finite, sum to 1 and match the plain model route (``fused=False``).

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the slice, its worst error against the plain version and both
times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
D_FEAT, D_INNER, D_ATTN, N_TOKEN = 384, 128, 128, 5   # camelyon_medical_ssl, ACMIL
SEED = 0
# kernel vs plain: both f32 with TF32 off; only the order of the sums
# differs, over up to 384-term dots and 65536-term softmax sums
ATOL, RTOL = 1e-4, 1e-4
PROB_ATOL = 1e-5
F32_PEAK_TFLOPS = 67.0     # H100 SXM, CUDA cores, published


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

    t0 = time.perf_counter()
    _build.load("attn_pool")
    info = _build.build_info.get("attn_pool", {})
    print(f"build: attn_pool in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info.get('seconds', 0.0):.2f} s)")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


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

    yml = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")
    conf = Config.from_yaml(yml, {"arch": "ga", "n_token": N_TOKEN})
    if (conf.D_feat, conf.D_inner) != (D_FEAT, D_INNER):
        raise AssertionError(f"unexpected widths {conf.D_feat}/{conf.D_inner}")
    model, family = build_mil_model(conf)
    torch_linear_init_(model, torch.Generator().manual_seed(SEED))
    rs = np.random.default_rng(SEED)
    lengths = [1000, 50000] + rs.integers(1000, 50001, 14).tolist()
    slides = {}
    for i, n in enumerate(lengths):
        feat = rs.standard_normal((n, D_FEAT), dtype=np.float32)
        label = i % 2
        if label:
            feat[rs.choice(n, n // 20, replace=False)] += 1.5
        slides[f"slide_{i:02d}"] = {"feat": feat.astype(np.float16),
                                    "coords": rs.integers(0, 100000, (n, 2)),
                                    "label": label}
    with tempfile.TemporaryDirectory() as tmp:
        feats = os.path.join(tmp, "feats.pt")
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        write_feature_pt(feats, slides)
        checkpoint.save(ckpt, model, epoch=0, conf=conf)
        argv = ["--config", yml, "--ckpt", ckpt, "--features", feats,
                "--out_csv", os.path.join(tmp, "preds.csv"), "--device", "cuda"]

        fused_gated_attn_pool_batched.launches = 0
        t0 = time.perf_counter()
        res = predict.main(argv)
        wall = time.perf_counter() - t0
        launches = fused_gated_attn_pool_batched.launches

    if launches != len(slides):
        raise AssertionError(f"B1 launched {launches} times for "
                             f"{len(slides)} slides (one batch each)")
    probs = np.asarray([r[2:2 + conf.n_class] for r in res["rows"]])
    if probs.shape != (len(slides), conf.n_class) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities {probs.shape}")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)

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
            reps = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(bag)
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            lat[route].append(statistics.median(reps))
    if worst > PROB_ATOL:
        raise AssertionError(f"fused and plain probabilities differ by {worst}")
    print(f"slice: {len(slides)} slides ({min(lengths)}-{max(lengths)} patches) "
          f"scored by cli/predict.py in {wall:.2f} s; B1 launches {launches}; "
          f"probabilities finite, rows sum to 1, max |fused - plain| {worst:.3e}")
    if res["metrics"] is not None:
        print("slice metrics (random weights): " + json.dumps(res["metrics"]))
    big = [r[0] for r in res["rows"]].index("slide_01")     # 50000 patches
    print(f"slice per-slide latency, bag on the device, median over slides: "
          f"fused {statistics.median(lat['fused']):.4f} ms, "
          f"plain {statistics.median(lat['plain']):.4f} ms; at 50000 patches: "
          f"fused {lat['fused'][big]:.4f} ms, plain {lat['plain'][big]:.4f} ms "
          f"[{smi}]")
    return launches


def main() -> None:
    smi = card()
    build()
    stats = kernel_vs_plain(smi)
    launches = slice_run(smi)
    print(json.dumps({"kernels": [{
        "name": "B1 fused gated-attention pooling (forward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:54",
        "launches": launches,
        **stats}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
