#!/usr/bin/env python3
"""Times variants of kernel B5' (``acmil_tpu_torch/csrc/vit_attn.cu``) on a
card, to show what each design choice of the kernel is worth:

    python3 scripts/attn_variants.py

Each variant is the source with a few lines replaced, built by ``nvcc``
with the port's flags into ``csrc/build/variants/`` and called through its
C entry ``b5_mha_packed`` on one packed qkv at Step2's shape (ViT-S/16,
B=256) and at CLIP-L/336 (B=32). Each line gives the CUDA-event time of
one call and the kernel's device time (``chip_smoke._time_ms`` and
``_device_ms``, L2 flushed before each call), beside one call of
``F.scaled_dot_product_attention`` on the same q, k, v. Variants run in
turns, then in reverse order, so that a drift of the card shows. Needs one
card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
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


def build_variants() -> dict:
    src = (_build.CSRC / "vit_attn.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, subs)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in vit_attn.cu")
            text = text.replace(old, new)
        cu, lib = out / f"variant{i}.cu", out / f"libvariant{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).b5_mha_packed
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        entries[name] = fn
    return entries


@torch.no_grad()
def main() -> None:
    smi = cs.card()
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
                err = fn(qkv.data_ptr(), o.data_ptr(), b, n, d, heads,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            ms = cs._time_ms(call, 20)
            dev, _ = cs._device_ms(call, ("mha_kernel",))
            print(f"  {name:20s} call {ms:.4f} ms, device {cs._fmt_ms(dev)}")
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
