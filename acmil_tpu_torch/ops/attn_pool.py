"""Fused gated-attention pooling: kernel B1 and its plain PyTorch version.

The port of ``acmil_tpu/ops/attn_pool.py``'s forward. For a padded bag of N
patch features it computes

    h  = relu(feats @ W1 + b1)                       (DimReduction)
    a  = (tanh(h V + bv) * sigmoid(h U + bu)) w + bw (gated attention, K branches)
    A  = softmax of a over N, pads excluded
    out[k] = sum_n A[k, n] h[n]                      (branch bag features)

:func:`fused_gated_attn_pool_batched` keeps the JAX function's contract and
layout: ``bag [B, K, L]``, raw logits ``[B, K, N]`` with ``NEG`` at pad
slots, and on request the softmax's max ``m`` and sum ``s`` ``[B, K]``. Its
route is chosen by the device of ``feats`` and nothing else: a CPU tensor
takes the plain version, a CUDA tensor launches the hand-written kernel in
``csrc/attn_pool.cu`` or raises.

The kernel has no backward yet (kernel B2 comes with the training slice), so
the CUDA route refuses to run where autograd would need one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

NEG = -1e30

# the widths csrc/attn_pool.cu is compiled for
KERNEL_L = 128
KERNEL_A = 128
KERNEL_DF_MULTIPLE = 32
KERNEL_MAX_K = 128


def gated_attn_pool_reference(feats, mask, w1, b1, v, bv, u, bu, w, bw):
    """One bag, plain PyTorch: feats [N, Df], mask [N] → (bag [K, L],
    logits [N, K])."""
    bag, logits = _reference_batched(feats[None], mask[None], w1, b1, v, bv,
                                     u, bu, w, bw)
    return bag[0], logits[0].T


def _reference_batched(feats, mask, w1, b1, v, bv, u, bu, w, bw):
    """Plain PyTorch with the kernel's layout: (bag [B, K, L],
    logits [B, K, N])."""
    h = torch.relu(feats @ w1 + b1)                          # [B, N, L]
    logits = (torch.tanh(h @ v + bv) * torch.sigmoid(h @ u + bu)) @ w + bw
    valid = mask[..., None]                                  # [B, N, 1]
    logits = torch.where(valid, logits, NEG)                 # [B, N, K]
    p = torch.softmax(logits, dim=1) * valid
    p = p / p.sum(dim=1, keepdim=True).clamp_min(1e-12)
    bag = p.transpose(1, 2) @ h                              # [B, K, L]
    return bag, logits.transpose(1, 2)


def _softmax_stats(logits, mask):
    """The online softmax's final (max, sum) ``[B, K]`` from logits
    ``[B, K, N]`` that hold ``NEG`` at pad slots."""
    m = logits.amax(dim=-1)
    s = (torch.exp(logits - m[..., None]) * mask[:, None, :]).sum(dim=-1)
    return m, s


def _check_kernel_args(feats, mask, w1, b1, v, bv, u, bu, w, bw) -> None:
    """Raise ValueError for any input kernel B1 does not take."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, N, Df], got {tuple(feats.shape)}")
    b, n, df = feats.shape
    if feats.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"feats must be float16 or float32, got {feats.dtype}")
    if tuple(mask.shape) != (b, n) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{b}, {n}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if b < 1 or n < 1:
        raise ValueError(f"empty batch or bag: B={b}, N={n}")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the kernel's grid limit of 65535")
    if df % KERNEL_DF_MULTIPLE:
        raise ValueError(f"Df={df} is not a multiple of {KERNEL_DF_MULTIPLE}")
    l, a = w1.shape[1], v.shape[1]
    k = w.shape[1]
    if l != KERNEL_L or a != KERNEL_A:
        raise ValueError(f"the kernel takes L = A = 128, got L={l}, A={a}")
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {KERNEL_MAX_K}, got {k}")
    shapes = {"w1": (w1, (df, l)), "b1": (b1, (l,)), "v": (v, (l, a)),
              "bv": (bv, (a,)), "u": (u, (l, a)), "bu": (bu, (a,)),
              "w": (w, (a, k)), "bw": (bw, (k,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


@functools.cache
def _kernel_entry():
    """(the C entry point with its ctypes signature, rows per tile), from
    the library built at first use."""
    from acmil_tpu_torch.ops import _build

    lib = _build.load("attn_pool")
    fn = lib.b1_attn_pool_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.b1_tile_rows.restype = ctypes.c_int
    return fn, lib.b1_tile_rows()


def _launch_kernel(feats, mask, w1, b1, v, bv, u, bu, w, bw):
    _check_kernel_args(feats, mask, w1, b1, v, bv, u, bu, w, bw)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (feats, w1, b1, v, bv, u, bu, w, bw)):
        raise NotImplementedError(
            "kernel B1 has no backward yet (kernel B2 comes with the training "
            "slice): call it under torch.no_grad()")
    dev = feats.device
    ins = [t.contiguous() for t in (feats, mask, w1, b1, v, bv, u, bu, w, bw)]
    for t in ins:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError("kernel B1 needs 16-byte-aligned inputs")
    fn, tile_rows = _kernel_entry()
    b, n, df = feats.shape
    l, k = w1.shape[1], w.shape[1]
    tiles = -(-n // tile_rows)
    f32 = dict(device=dev, dtype=torch.float32)
    logits = torch.empty(b, k, n, **f32)
    bag = torch.empty(b, k, l, **f32)
    m = torch.empty(b, k, **f32)
    s = torch.empty(b, k, **f32)
    part_m = torch.empty(b, tiles, k, **f32)
    part_s = torch.empty(b, tiles, k, **f32)
    part_acc = torch.empty(b, tiles, k, l, **f32)
    outs = (logits, bag, m, s, part_m, part_s, part_acc)
    x, mk, *weights = ins
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.float16), mk.data_ptr(),
                 *(t.data_ptr() for t in weights),
                 *(t.data_ptr() for t in outs), b, n, df, k, stream)
    if err != 0:
        raise RuntimeError(f"kernel B1 launch failed: cudaError_t {err}")
    fused_gated_attn_pool_batched.launches += 1
    return bag, logits, m, s


def fused_gated_attn_pool_batched(
    feats: torch.Tensor,      # [B, N, Df] float16/float32
    mask: torch.Tensor,       # [B, N] bool
    w1: torch.Tensor,         # [Df, L]
    b1: torch.Tensor,         # [L] (zeros for the bias-free DimReduction)
    v: torch.Tensor,          # [L, A]
    bv: torch.Tensor,         # [A]
    u: torch.Tensor,          # [L, A]
    bu: torch.Tensor,         # [A]
    w: torch.Tensor,          # [A, K]
    bw: torch.Tensor,         # [K]
    return_stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Batched fused pooling. Returns (bag_feats [B, K, L],
    attn_logits [B, K, N]); with ``return_stats`` also the softmax's max
    and sum ``[B, K]``, from which shards of one bag combine.

    CPU tensors take the plain version; CUDA tensors launch kernel B1 (and
    add one to ``fused_gated_attn_pool_batched.launches``) or raise. N needs
    no padding to any multiple: rows past N are masked in the kernel.
    """
    if feats.device.type == "cuda":
        bag, logits, m, s = _launch_kernel(feats, mask, w1, b1, v, bv, u, bu,
                                           w, bw)
    elif feats.device.type == "cpu":
        bag, logits = _reference_batched(feats.float(), mask, w1, b1, v, bv,
                                         u, bu, w, bw)
        m, s = _softmax_stats(logits, mask)
    else:
        raise ValueError(f"no kernel B1 route for device {feats.device}")
    if return_stats:
        return bag, logits, m, s
    return bag, logits


fused_gated_attn_pool_batched.launches = 0


def fused_gated_attn_pool(feats, mask, w1, b1, v, bv, u, bu, w, bw):
    """Single-bag wrapper: feats [N, Df], mask [N] →
    (bag_feats [K, L], attn_logits [K, N])."""
    bag, logits = fused_gated_attn_pool_batched(
        feats[None], mask[None], w1, b1, v, bv, u, bu, w, bw)
    return bag[0], logits[0]
