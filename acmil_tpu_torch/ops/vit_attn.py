"""Multi-head attention over separate q, k, v: kernel B7 and its plain
version.

The port of ``acmil_tpu/ops/vit_attn.py``. :func:`fused_vit_attention` takes
q, k, v ``[B, H, N, dh]`` and returns ``softmax(q kᵀ · scale) v`` in q's
dtype, ``scale`` defaulting to ``1/sqrt(dh)``. It is a
``torch.autograd.Function``: the forward launches kernel B7 on CUDA tensors
(``csrc/vit_attn.cu``'s strided entry, the body of kernel B5' reading each
operand through its strides) and takes the plain version
:func:`_reference_attention` on CPU tensors; the backward recomputes through
the plain version, as the JAX ``custom_vjp`` does. The kernel takes bfloat16
and the head widths of B5'; any other CUDA input raises.

No production path calls it: Step2's fused ViT route goes through B5'
(``ops/vit_attn_packed.py``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from acmil_tpu_torch.ops.vit_attn_packed import KERNEL_HEAD_DIMS, _mm


def _reference_attention(q, k, v, scale: Optional[float] = None):
    """Kernel B7's plain version: q, k, v ``[B, H, N, dh]`` → ``[B, H, N,
    dh]`` in q's dtype, with the Pallas kernel's rounding points: scores and
    softmax in f32, p rounded to q's dtype after the normalisation, the
    product with v summed in f32 and rounded once. (JAX's
    ``_reference_attention`` also rounds the scores to q's dtype, through
    its einsum; in f32 the two are the same function.)"""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _mm(p, v)


def _check_kernel_args(q, k, v) -> None:
    """Raise ValueError for any input kernel B7 does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, N, dh] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, dh = q.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must be on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"kernel B7 takes bfloat16 q, k, v, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if b < 1 or h < 1 or n < 1:
        raise ValueError(f"empty input: B={b}, H={h}, N={n}")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} or H={h} exceeds the kernel's grid limit "
                         f"of 65535")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel B7 takes head widths {KERNEL_HEAD_DIMS}, "
                         f"got dh={dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"kernel B7 needs {name}'s rows of dh elements "
                             f"contiguous and 16-byte aligned")


@functools.cache
def _kernel_entry():
    """The C entry point with its ctypes signature, from the library built
    at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_attn").b7_mha_strided
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def _launch(q, k, v, scale: Optional[float]) -> torch.Tensor:
    """One launch of kernel B7 on CUDA tensors; raises on what it does not
    take or a failed launch."""
    _check_kernel_args(q, k, v)
    b, h, n, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    out = torch.empty(b, h, n, dh, dtype=q.dtype, device=q.device)
    args = []
    for t in (q, k, v, out):
        args += [t.data_ptr(), *t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_entry()(*args, b, h, n, dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"kernel B7 launch failed: cudaError_t {err}")
    return out


class _FusedVitAttention(torch.autograd.Function):
    """Forward through B7 (the plain version on the CPU); backward through
    autograd of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cuda":
            out = _launch(q, k, v, scale)
            fused_vit_attention.launches += 1
            return out
        if q.device.type == "cpu":
            return _reference_attention(q, k, v, scale)
        raise ValueError(f"no kernel B7 route for device {q.device}")

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip((q, k, v), need)]
            out = _reference_attention(*ins, ctx.scale)
            grads = torch.autograd.grad(
                out, [t for t, r in zip(ins, need) if r], g)
        it = iter(grads)
        return (*(next(it) if r else None for r in need), None)


def fused_vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v for q, k, v ``[B, H, N, dh]`` → ``[B, H, N,
    dh]`` in q's dtype; ``scale`` defaults to ``1/sqrt(dh)``.

    CPU tensors take the plain version; CUDA tensors launch kernel B7 (and
    add one to ``fused_vit_attention.launches``) or raise: the kernel takes
    bfloat16 only. Differentiable: the backward recomputes through the plain
    version. The kernel streams keys, so any N is taken (the TPU kernel's
    VMEM bound on N does not apply)."""
    return _FusedVitAttention.apply(q, k, v, scale)


fused_vit_attention.launches = 0
