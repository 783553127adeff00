#!/usr/bin/env python3
"""Times variants of kernel B5' (``acmil_tpu_torch/csrc/vit_attn.cu``), of
the GEMM of B3 and B4 (``csrc/vit_gemm.cu``), of the pooling forward B1
(``csrc/attn_pool.cu``), of the pooling backward B2
(``csrc/attn_pool_bwd.cu``) or of the DSMIL pooling B6
(``csrc/dsmil_pool.cu``), on a card, to show what each design choice of the
kernel is worth:

    python3 scripts/attn_variants.py [--kernel attn|gemm|gemm_f32|b1|b2|b6]

Each variant is the source with a few lines replaced, built by ``nvcc``
with the port's flags into ``csrc/build/variants/``. B5' variants are
called through the C entry ``b5_mha_packed`` on one packed qkv at Step2's
shape (ViT-S/16, B=256) and at CLIP-L/336 (B=32), beside one call of
``F.scaled_dot_product_attention`` on the same q, k, v; GEMM variants
through ``vit_gemm`` at the four GEMMs of B3 at Step2's shape (M = 50432
tokens), each with its epilogue and dtypes as the chain runs it, beside one
bf16 ``torch.matmul`` at the same shape; f32 GEMM variants
(``csrc/vit_gemm_f32.cu``: flush depths, one product, stores off) likewise
through ``vit_gemm_f32``, each call's error against a float64 product
beside f32 ``torch.matmul``'s, with f32 and TF32 ``torch.matmul`` timed;
B2 variants through
``fused_gated_attn_pool_bwd`` (weight gradients only, fp16 features, N =
65536, K = 5) at L = 128 and 768, each of its CUDA kernels timed apart; B1
variants likewise through ``fused_gated_attn_pool_batched``, each one's
outputs compared with the kernel as built; B6 variants through
``fused_dsmil_pool`` at N = 65536, fp16, C = 2 at D = 384 and at UNI's D =
1024, C = 128 at D = 384, and C = 4 at D = 512, likewise.
Each line gives the CUDA-event
time of one call and the kernel's device time (``chip_smoke._time_ms`` and
``_device_ms``, L2 flushed before each call). Variants run in turns, then
in reverse order, so that a drift of the card shows. Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from acmil_tpu_torch.ops import _build  # noqa: E402

WG_CALL = "      wg_tile<kRoute == kWgSplit>(\n"
# name -> (what it shows, replacements)
VARIANTS = {
    "as built": ("the kernel in the repository", []),
    "mma.sync only": ("the mma.sync route at every N (two passes, 16-query "
                      "tiles), the warpgroup routes off",
                      [("kWgMinChunks = 10;", "kWgMinChunks = 99;")]),
    "no split": ("N > 208 on the mma.sync route: the split warpgroup route "
                 "off", [("kWgMaxSteps = 3;", "kWgMaxSteps = 1;")]),
    "copies only": ("the warpgroup routes' copies and stores without their "
                    "arithmetic: the floor their memory traffic sets",
                    [(WG_CALL,
                      "      if (t == 0) wait_values();\n"
                      "      float acc[8][4] = {};\n"
                      "      store_o<64>(acc, oh, o.st, "
                      "64 * t + 16 * (warp % 4), n, lane);\n"
                      "      if (0)" + WG_CALL[5:])]),
}


# the epilogue's stores, and the same guard made false at run time
GEMM_STORE = ("          if (row0 + 4 * i < m_rows)\n"
              "            epilogue_quad<T, kEpi>")
GEMM_NO_STORE = [(GEMM_STORE, GEMM_STORE.replace("m_rows)", "m_rows && n < 0)")),
                 ("EpilogueArgs e, int m_rows, int n_cols, int k_depth) {",
                  "EpilogueArgs e, int m_rows, int n_cols, int k_depth) {\n"
                  "  const int n = n_cols;")]
GEMM_VARIANTS = {
    "as built": ("the kernel in the repository", []),
    "stores off": ("the epilogue's arithmetic and stores off (the "
                   "accumulators still staged, the residuals still read): "
                   "what they cost", GEMM_NO_STORE),
    "products off": ("the TMA ring and the residual reads alone, no wgmma "
                     "and no stores: the floor the loads set",
                     GEMM_NO_STORE + [
                         ("          wgmma_m64n128k16<T>(acc, da + 2 * kk, "
                          "dw + 2 * kk, ks > 0 || kk > 0);", "")]),
    "three stages": ("a ring of three stages instead of four",
                     [("kStages = 4;", "kStages = 3;")]),
}


# the f32 GEMM (csrc/vit_gemm_f32.cu): its flush depth, its products, its
# stores
F32_SMALL_TERMS = (
    "#pragma unroll\n"
    "        for (int j = 0; j < 4; ++j) wgmma_tf32(d, ah + 4 * j, dl + 2 * j, 1);\n"
    "      }\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < 4; ++j) wgmma_tf32(d, ah + 4 * j, dh + 2 * j, 1);\n")
F32_LO_LOAD = ("          tma_load(dst + kATileBytes + kTileBytes, &map_lo, "
               "full + 8 * stage,\n                   ks * kBK, n0);\n")
GEMM_F32_VARIANTS = {
    "as built": ("the kernel in the repository (each 32-deep stage's "
                 "products added in f32)", []),
    "flush 64": ("two stages' products summed on the tensor cores before "
                 "they are added in f32",
                 [("kFlushStages = 1;", "kFlushStages = 2;")]),
    "no flush": ("all of K summed on the tensor cores",
                 [("kFlushStages = 1;", "kFlushStages = 0;")]),
    "one product": ("hi hi alone (wrong numbers): what the split's two "
                    "other products cost",
                    [(F32_SMALL_TERMS, "      }\n"),
                     ("wgmma_tf32(d, al + 4 * j, dh + 2 * j,",
                      "wgmma_tf32(d, ah + 4 * j, dh + 2 * j,")]),
    "one product, A and W_hi": ("hi hi alone with W_lo's tiles not "
                                "loaded (wrong numbers): whether the loads "
                                "or the products bound one product",
                                [(F32_SMALL_TERMS, "      }\n"),
                                 ("wgmma_tf32(d, al + 4 * j, dh + 2 * j,",
                                  "wgmma_tf32(d, ah + 4 * j, dh + 2 * j,"),
                                 ("mbar_expect_tx(full + 8 * stage, "
                                  "kStageBytes);",
                                  "mbar_expect_tx(full + 8 * stage, "
                                  "2 * kTileBytes);"),
                                 (F32_LO_LOAD, "")]),
    "stores off": ("the epilogue's arithmetic and stores off (the "
                   "accumulators still staged, the residuals still read)",
                   [("          if (row0 + 4 * i >= m_rows) continue;",
                     "          if (row0 + 4 * i >= m_rows || n_cols > 0) "
                     "continue;")]),
}


def build_variants(source: str = "vit_attn.cu", variants=None,
                   entry: str = "b5_mha_packed", argtypes=None) -> dict:
    src = (_build.CSRC / source).read_text()
    # the shared headers inlined, each once where it is first included, so
    # that a variant may change them too
    inlined = set()
    while (inc := re.search(r'#include "(\w+\.cuh)"[^\n]*\n', src)):
        name = inc.group(1)
        body = "" if name in inlined else (
            (_build.CSRC / name).read_text().replace("#pragma once\n", ""))
        inlined.add(name)
        src = src[:inc.start()] + body + src[inc.end():]
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    variants = VARIANTS if variants is None else variants
    stem = source.split(".")[0]
    procs = {}
    for i, (name, (_, subs)) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {source}")
            text = text.replace(old, new)
        cu, lib = out / f"{stem}{i}.cu", out / f"lib{stem}{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes or ([ctypes.c_void_p, ctypes.c_void_p]
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        entries[name] = fn
    return entries


@torch.no_grad()
def gemm_main(smi: str) -> None:
    from acmil_tpu_torch.ops import vit_layer as vl

    p, i = ctypes.c_void_p, ctypes.c_int
    entries = build_variants("vit_gemm.cu", GEMM_VARIANTS, "vit_gemm",
                             [p, i, p, p, p, p, p, p, p, i, p, i, i, i, i, i,
                              i, p])
    for name, (what, _) in GEMM_VARIANTS.items():
        print(f"variant {name!r}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m = cs.STEP2_BATCH * cs.VIT_S16[0]
    d, hidden = cs.VIT_S16[1], 4 * cs.VIT_S16[1]
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, K, N, epilogue, A's dtype and LayerNorm, residual, output) as
    # the B3 chain calls it
    gemms = (("qkv", d, 3 * d, vl.EPI_BIAS, True, None, bf16),
             ("proj", d, d, vl.EPI_RES_BIAS, False, bf16, f32),
             ("fc1", d, hidden, vl.EPI_BIAS_GELU, True, None, bf16),
             ("fc2", hidden, d, vl.EPI_RES_BIAS, False, f32, bf16))
    for label, k, n, epi, ln, res_dtype, out_dtype in gemms:
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).bfloat16()
        bias = torch.randn(n, generator=gen, device="cuda")
        res = (None if res_dtype is None else torch.randn(
            m, n, generator=gen, device="cuda").to(res_dtype))
        out = torch.empty(m, n, dtype=out_dtype, device="cuda")
        lib = cs._time_ms(lambda: torch.matmul(a, w.t()), 20)
        bound = cs._bound(2 * m * k * n, 2 * (m * k + n * k) + m * n * (
            out.element_size() + (0 if res is None else res.element_size())))
        print(f"{label} M={m} K={k} N={n} (A {'after' if ln else 'without'} "
              f"the prologue): bf16 torch.matmul {lib:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) [{smi}]")
        for name in [*entries, *reversed(entries)]:
            fn = entries[name]

            def call():
                err = fn(a.data_ptr(), 0, None, None, None, w.data_ptr(),
                         bias.data_ptr(), None,
                         None if res is None else res.data_ptr(),
                         int(res_dtype == f32), out.data_ptr(),
                         int(out_dtype == f32), epi, m, n, k, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            ms = cs._time_ms(call, 20)
            dev, _ = cs._device_ms(call, ("gemm_kernel",))
            rate = ("" if dev is None
                    else f" ({2 * m * k * n / (dev * 1e-3) / 1e12:.1f} TFLOP/s)")
            print(f"  {name:14s} call {ms:.4f} ms, device "
                  f"{cs._fmt_ms(dev)}{rate}")
    print(f"card: {smi}")


def _f64_gemm(a, w, bias, epilogue, ln=None, res=None):
    """The f32 GEMM's contract with every step in float64."""
    from acmil_tpu_torch.ops import vit_layer as vl

    af = a.double()
    if ln is not None:
        af = vl._ln_f32(af, *(t.double() for t in ln))
    acc = af @ w.double().t() + bias.double()
    if epilogue == vl.EPI_BIAS_GELU:
        return torch.nn.functional.gelu(acc, approximate="tanh")
    if epilogue == vl.EPI_RES_BIAS:
        return acc + res.double()
    return acc


@torch.no_grad()
def gemm_f32_main(smi: str) -> None:
    from acmil_tpu_torch.ops import vit_layer as vl

    p, i = ctypes.c_void_p, ctypes.c_int
    entries = build_variants("vit_gemm_f32.cu", GEMM_F32_VARIANTS,
                             "vit_gemm_f32", [p] * 10 + [i] * 4 + [p])
    for name, (what, _) in GEMM_F32_VARIANTS.items():
        print(f"variant {name!r}: {what}")
    calls = cs._b3_gemm_calls(
        torch.Generator(device="cuda").manual_seed(cs.SEED), torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    kernels = ("gemm_f32_kernel", "split_w_kernel", "ln_rows_kernel")
    total = {name: [0.0, 0.0] for name in entries}
    lib = tf32 = 0.0
    for label, a, w, bias, epi, _, ln, res in calls:
        m, k = a.shape
        n = w.shape[0]
        out = torch.empty(m, n, device="cuda")
        rows = torch.empty(m, k, device="cuda") if ln is not None else None
        ws = torch.empty(2, n, k, device="cuda")
        exact = _f64_gemm(a, w, bias, epi, ln, res)
        plain = cs._gemm_plain(a, w, bias, epi, torch.float32, ln, res)
        lib_err = float((plain.double() - exact).abs().max())
        top = float(exact.abs().max())
        ms_lib = cs._time_ms(lambda: torch.matmul(a, w.t()), 20)
        torch.backends.cuda.matmul.allow_tf32 = True
        ms_tf32 = cs._time_ms(lambda: torch.matmul(a, w.t()), 20)
        torch.backends.cuda.matmul.allow_tf32 = False
        lib, tf32 = lib + ms_lib, tf32 + ms_tf32
        print(f"{label} M={m} K={k} N={n}: f32 torch.matmul {ms_lib:.4f} ms "
              f"(its error against float64 {lib_err:.3e}, "
              f"{lib_err / top:.3e} of the largest output), TF32 "
              f"torch.matmul {ms_tf32:.4f} ms (one TF32 product: not the "
              f"same function) [{smi}]")
        for name in [*entries, *reversed(entries)]:
            fn = entries[name]

            def call():
                err = fn(a.data_ptr(), ptr(ln and ln[0]), ptr(ln and ln[1]),
                         ptr(rows), w.data_ptr(), ws.data_ptr(),
                         bias.data_ptr(), None, ptr(res), out.data_ptr(), epi,
                         m, n, k, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            call()
            torch.cuda.synchronize()
            err = float((out.double() - exact).abs().max())
            ms = cs._time_ms(call, 20)
            dev = cs._split_ms(kernels, call)
            total[name][0] += ms / 2
            total[name][1] += sum(dev.values()) / 2
            print(f"  {name:12s} call {ms:.4f} ms, device "
                  f"{cs._fmt_split(dev)}; against float64 {err:.3e} "
                  f"({err / max(lib_err, 1e-30):.2f}x f32 torch.matmul's)")
    for name, (ms, dev) in total.items():
        print(f"four calls, {name}: call {ms:.4f} ms, device {dev:.4f} ms")
    print(f"four calls: f32 torch.matmul {lib:.4f} ms, TF32 torch.matmul "
          f"{tf32:.4f} ms")
    print(f"card: {smi}")


# the H stage's near-0 test (csrc/gated_h.cuh); with a tolerance of -1
# nothing is listed or recomputed
RECOMPUTE = "const float tol = kMaskTol * xn[r];"

# the row kernel's GEMMs and its p/d_log step, the mask recompute of K1, the
# per-slice flush of K3
B2_VARIANTS = {
    "as built": ("the kernel in the repository", []),
    "K2 GEMMs off": ("the row kernel without its tensor-core products",
                     [("GemmZ::run(", "if (0) GemmZ::run("),
                      ("GemmDh::run(", "if (0) GemmDh::run(")]),
    "K2 p/d_log off": ("the row kernel without its per-(row, branch) step",
                       [("for (int idx = tid; idx < kTile * k_br; idx += "
                         "kThreads) {", "for (int idx = tid; idx < 0; "
                         "idx += kThreads) {")]),
    "K1 recompute off": ("K1 listing no near-0 pre-activation to recompute",
                         [(RECOMPUTE, "const float tol = -1.f;")]),
    "cvt.rna split": ("hi and lo rounded by cvt.rna.tf32.f32 instead of "
                      "the integer add and mask (the same bits)",
                      [("return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;",
                        "uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : "
                        "\"=r\"(r) : \"f\"(a));\n  return r;")]),
    "K3 no flush": ("K3 without its per-slice sums",
                    [("G::template run<true>", "G::template run<false>")]),
    "K3 two blocks": ("K3 without its per-slice sums, two blocks an SM",
                      [("G::template run<true>", "G::template run<false>"),
                       ("__launch_bounds__(kThreads, 1)\nb2_wgrad_kernel(",
                        "__launch_bounds__(kThreads, 2)\nb2_wgrad_kernel(")]),
}


@torch.no_grad()
def b2_main(smi: str) -> None:
    from acmil_tpu_torch.ops import attn_pool as ap

    _, blocks, tile_rows = ap._bwd_kernel_entry()
    p, i = ctypes.c_void_p, ctypes.c_int
    entries = build_variants("attn_pool_bwd.cu", B2_VARIANTS,
                             "b2_attn_pool_backward",
                             [p, i] + [p] * 25 + [i] * 8 + [p])
    for name, (what, _) in B2_VARIANTS.items():
        print(f"variant {name!r}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m = torch.ones(1, 65536, dtype=torch.bool, device="cuda")
    for df, l in ((cs.D_FEAT, cs.D_INNER), cs.WIDE_DIMS[-1]):
        ws = cs._weights(gen, cs.N_TOKEN, df, l)
        x = torch.randn(1, 65536, df, generator=gen, device="cuda").half()
        lse, c, d_bag, d_logits = cs._bwd_inputs(ap, gen, ws, x, m,
                                                 cs.N_TOKEN)
        print(f"Df={df} L={l} N=65536 K={cs.N_TOKEN} fp16, weight gradients "
              f"only [{smi}]")
        for name in [*entries, *reversed(entries)]:
            ap._bwd_kernel_entry = lambda fn=entries[name]: (fn, blocks,
                                                             tile_rows)
            per = cs._split_ms(ap.B2_KERNELS, lambda: ap.fused_gated_attn_pool_bwd(
                x, m, *ws, lse, c, d_bag, d_logits, need_dx=False))
            print(f"  {name:18s} device {sum(per.values()):.4f} ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in per.items()))
    print(f"card: {smi}")


# The H stage with the norms folded into its tile kernel: each tile sums
# |x| over its 128 rows and |W1| over its 128 columns itself, in the norms
# kernel's orders (the same bits), and the norms kernel is not launched.
FOLD_NORMS = [("""  const float* xn = norms;
  const float* wn = norms + m;
""", """  __shared__ float fold[kBM + kBN];
  __shared__ float fold_sums[kWarps][kBN];
  for (int q = threadIdx.x; q < kBM * 8; q += kThreads) {
    constexpr int kVec = 16 / sizeof(T);
    const T* xr = x + static_cast<size_t>(min(m0 + q / 8, m - 1)) * df;
    float s = 0.f;
    for (int d = (q % 8) * kVec; d < df; d += 8 * kVec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + d));
      const T* v = reinterpret_cast<const T*>(&raw);
      for (int i = 0; i < kVec; ++i) {
        const float f = tf32x3::widen(v[i]);
        s = fmaf(f, f, s);
      }
    }
    for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (q % 8 == 0) fold[q / 8] = sqrtf(s);
  }
  for (int q = threadIdx.x; q < kWarps * kBN; q += kThreads) {
    const int w = q / kBN, c = q % kBN;
    float s = 0.f;
    for (int d = w; d < df; d += kWarps) {
      const float v = w1[static_cast<size_t>(d) * l_dim + n0 + c];
      s = fmaf(v, v, s);
    }
    fold_sums[w][c] = s;
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    float t = 0.f;
    for (int i = 0; i < kWarps; ++i) t += fold_sums[i][threadIdx.x];
    fold[kBM + threadIdx.x] = sqrtf(t);
  }
  __syncthreads();
  const float* xn = fold - m0;
  const float* wn = fold + kBM - n0;
"""), ("""  gated_h_norms_kernel<T><<<norm_rows + l_dim / 32, kThreads, 0, stream>>>(
      x, w1, norms, m, df, l_dim);
""", "")]

# the H stage's recompute and norms, the row kernel's grid and products
B1_VARIANTS = {
    "as built": ("the kernel in the repository", []),
    "recompute off": ("the H stage listing no near-0 pre-activation to "
                      "recompute", [(RECOMPUTE, "const float tol = -1.f;")]),
    "norms folded": ("the norms summed by each H tile from its own rows "
                     "and columns (the same bits), no norms kernel",
                     FOLD_NORMS),
    "persistent grid": ("the row kernel as a persistent grid (the blocks "
                        "an SM holds at K <= 8, times the SMs), not one "
                        "block per 64-row tile",
                        [("  const int blocks = a.batch * ((a.n + kTile - 1) "
                          "/ kTile);   // one a tile\n",
                          "  int dev = 0, sms = 0;\n"
                          "  cudaGetDevice(&dev);\n"
                          "  cudaDeviceGetAttribute(&sms, "
                          "cudaDevAttrMultiProcessorCount, dev);\n"
                          "  const int tiles = a.batch * ((a.n + kTile - 1) "
                          "/ kTile);\n"
                          "  const int cap = (a.k_br <= 8 ? 2 : 1) * sms;\n"
                          "  const int blocks = tiles < cap ? tiles : cap;\n")]),
    "row products off": ("the row kernel without its two tensor-core "
                         "products", [("GemmZ::run(", "if (0) GemmZ::run(")]),
}


@torch.no_grad()
def b1_main(smi: str) -> None:
    from acmil_tpu_torch.ops import attn_pool as ap

    p, i = ctypes.c_void_p, ctypes.c_int
    entries = build_variants("attn_pool.cu", B1_VARIANTS,
                             "b1_attn_pool_forward",
                             [p, i] + [p] * 21 + [i] * 5 + [p])
    for name, (what, _) in B1_VARIANTS.items():
        print(f"variant {name!r}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m = torch.ones(1, 65536, dtype=torch.bool, device="cuda")
    for df, l in ((cs.D_FEAT, cs.D_INNER), cs.WIDE_DIMS[-1]):
        ws = cs._weights(gen, cs.N_TOKEN, df, l)
        x = torch.randn(1, 65536, df, generator=gen, device="cuda").half()
        print(f"Df={df} L={l} N=65536 K={cs.N_TOKEN} fp16 [{smi}]")
        built = None
        for name in [*entries, *reversed(entries)]:
            ap._kernel_entry = lambda fn=entries[name]: fn
            call = lambda: ap.fused_gated_attn_pool_batched(  # noqa: E731
                x, m, *ws, return_stats=True)
            out = call()
            built = out if built is None else built
            diff = max(float((a - b).abs().max()) for a, b in zip(out, built))
            per = cs._split_ms(ap.B1_KERNELS, call)
            print(f"  {name:18s} device {sum(per.values()):.4f} ms "
                  f"(outputs {'identical' if diff == 0 else f'off by {diff:.3e}'}"
                  f" to as built): " + cs._fmt_split(per))
    print(f"card: {smi}")


# the rows kernel's work on a slice, skipped
ROWS_WORK = "    if (warp >= slice) continue;"
# name -> (what it shows, replacements, blocks the ranges aim at or None)
B6_VARIANTS = {
    "as built": ("the kernel in the repository", [], None),
    "ring of 4": ("the rows kernel's ring of 4 stages, not 3",
                  [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
                  None),
    "stages of 24 KB": ("ring stages of at most 24 KB, not 32 (8-row slices "
                        "at D = 1024)", [("constexpr int kStageBytes = 32768;",
                                          "constexpr int kStageBytes = 24576;")],
                        None),
    "half the blocks": ("ranges aimed at half the blocks (132 at C <= 8, one "
                        "an SM; 66 above)", [], 132),
    "twice the blocks": ("ranges aimed at twice the blocks (528 at C <= 8, "
                         "264 above)", [], 528),
    "copies only": ("the rows kernel's copies and barriers without its "
                    "dots, softmax and pooling: the floor its memory traffic "
                    "sets", [(ROWS_WORK, "    continue;")], None),
    "split-TF32 only": ("the split-TF32 route where the rows kernel fits "
                        "too", [("  if (rows_fit(a.n_cls, a.d_feat)) {",
                                 "  if (false) {")], None),
    "logits products off": ("the split-TF32 logits kernel without its "
                            "products (u and x still staged)",
                            [("    Gemm::run(acc, xa, ua, t0, 0, 0, d_feat, smem);",
                              "    if (t0 < 0) Gemm::run(acc, xa, ua, t0, 0, 0, "
                              "d_feat, smem);\n    __syncthreads();")], None),
    "pool products off": ("the split-TF32 pooling kernel without its "
                          "products (x and the logits still staged, p formed)",
                          [("        tf32x3::mma(acc[j], ah, bl);\n"
                            "        tf32x3::mma(acc[j], ah, bh);",
                            "        if (kk < 0) tf32x3::mma(acc[j], ah, bl);")],
                          None),
    "logits copies of 4 B": ("the pooling's logits staged 4 bytes a copy, "
                             "not 16", [("constexpr bool kLogits16 = true;",
                                         "constexpr bool kLogits16 = false;")],
                             None),
    "G=32": ("class groups of 32 on the split-TF32 route, not 64",
             [("constexpr int kMaxG = 64;", "constexpr int kMaxG = 32;")],
             None),
    "logits tile 64": ("the split-TF32 logits in tiles of 64 rows, not 128 "
                       "(u staged twice as often)",
                       [("constexpr int kLTile = 128;",
                         "constexpr int kLTile = 64;")], None),
}


def _split_clean_ms(kernels, fn, reps=10) -> dict:
    """``chip_smoke._split_ms`` with the L2 flushed by reading 128 MB
    instead of writing it: no dirty lines are left for the kernels' first
    reads to write back to HBM."""
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    prof, _ = cs._profiled(fn, reps, before=flush.max)
    per = {}
    for name, us in cs._device_events(prof):
        for k in kernels:
            if k in name:
                per[k] = per.get(k, 0.0) + us / reps / 1e3
    return per


@torch.no_grad()
def b6_main(smi: str) -> None:
    from acmil_tpu_torch.ops import dsmil_pool as dp

    p, i = ctypes.c_void_p, ctypes.c_int
    entries = build_variants(
        "dsmil_pool.cu", {k: v[:2] for k, v in B6_VARIANTS.items()},
        "b6_dsmil_pool", [p, i] + [p] * 11 + [i] * 7 + [ctypes.c_float, p])
    for name, (what, *_) in B6_VARIANTS.items():
        print(f"variant {name!r}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    blocks = dp._B6_BLOCKS
    # C = 4 at D = 512: the rows kernel's widest D at 4 classes
    for d, q, c in ((cs.D_FEAT, cs.D_INNER, 2), (1024, 512, 2),
                    (cs.D_FEAT, cs.D_INNER, 128), (512, 256, 4)):
        x, m, wq, bq, q_max = cs._b6_inputs(gen, 1, 65536, d, q, c,
                                            torch.float16)
        m[:] = True
        print(f"D={d} Q={q} C={c} N=65536 B=1 fp16 [{smi}]")
        # a yardstick of one read of the bag: torch's own reduction over x
        read = lambda: torch.sum(x, dtype=torch.float32)  # noqa: E731
        print(f"  torch.sum over x (one read of the bag, {x.numel() * 2} "
              f"bytes): call {cs._time_ms(read):.4f} ms, device "
              f"{cs._fmt_ms(cs._device_ms(read, ('reduce_kernel',))[0])}")
        built = None
        call = lambda: dp.fused_dsmil_pool(x, m, wq, bq, q_max)  # noqa: E731
        for name in [*entries, *reversed(entries)]:
            dp._kernel_entry = lambda fn=entries[name]: fn
            dp._B6_BLOCKS = B6_VARIANTS[name][2] or blocks
            out = call()
            built = out if built is None else built
            diff = max(float((a - b).abs().max()) for a, b in zip(out, built))
            per = cs._split_ms(dp.B6_KERNELS, call)
            print(f"  {name:16s} device {sum(per.values()):.4f} ms, call "
                  f"{cs._time_ms(call):.4f} ms (outputs "
                  f"{'identical' if diff == 0 else f'off by {diff:.3e}'} to "
                  f"as built): " + cs._fmt_split(per))
        dp._kernel_entry = lambda fn=entries["as built"]: fn
        dp._B6_BLOCKS = blocks
        for _ in range(2):
            per = _split_clean_ms(dp.B6_KERNELS, call)
            print(f"  as built, L2 flushed by a read (no dirty lines): device "
                  f"{sum(per.values()):.4f} ms: " + cs._fmt_split(per))
    dp._B6_BLOCKS = blocks
    print(f"card: {smi}")


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("attn", "gemm", "gemm_f32", "b1",
                                             "b2", "b6"), default="attn")
    kernel = parser.parse_args().kernel
    smi = cs.card()
    if kernel != "attn":
        {"gemm": gemm_main, "gemm_f32": gemm_f32_main, "b1": b1_main,
         "b2": b2_main, "b6": b6_main}[kernel](smi)
        return
    entries = build_variants()
    for name, (what, _) in VARIANTS.items():
        print(f"variant {name!r}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for label, (n, d, heads), b in (("ViT-S/16", cs.VIT_S16, cs.STEP2_BATCH),
                                    ("CLIP-L/336", cs.CLIP_L, cs.BIG_BATCH)):
        qkv = (2 * torch.randn(b, n, 3 * d, generator=gen,
                               device="cuda")).bfloat16()
        o = torch.empty(b, n, d, dtype=torch.bfloat16, device="cuda")
        q, k, v = qkv.view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        sdpa = cs._time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
            20)
        bound = cs._bound(b * 4 * n * n * d, b * 2 * (n * 3 * d + n * d))
        print(f"{label} B={b} N={n} H={heads}: scaled_dot_product_attention "
              f"{sdpa:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{smi}]")
        for name in [*entries, *reversed(entries)]:
            fn = entries[name]

            def call():
                err = fn(qkv.data_ptr(), o.data_ptr(), b, n, d, heads, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            ms = cs._time_ms(call, 20)
            dev, _ = cs._device_ms(call, ("mha_kernel",))
            print(f"  {name:20s} call {ms:.4f} ms, device {cs._fmt_ms(dev)}")
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
