"""Packed-layout multi-head attention: kernel B5' and its plain version.

The port of ``acmil_tpu/ops/vit_attn_packed.py``. :func:`fused_mha_packed`
takes the qkv projection exactly as a ViT's fused qkv Linear emits it,
token-major ``[B, N, 3D]``, splits the heads inside the kernel and returns
the attention output token-major ``[B, N, D]``, ready for the output
projection: no ``[B, H, N, dh]`` copy reaches device memory.

The wrapper picks its route by the device of ``qkv`` and nothing else: a CPU
tensor takes the plain version :func:`_reference_packed`, a CUDA tensor
launches kernel B5' (``csrc/vit_attn.cu``, which replaces the Pallas
``_packed_kernel``) or raises. Kernels B3 and B4 (``ops/vit_layer.py``)
launch B5' as their attention step through :func:`_launch_packed`, which
counts every launch of the kernel (``_launch_packed.launches``), whoever
calls it; ``fused_mha_packed.launches`` counts the public entry's alone.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# head widths csrc/vit_attn.cu is compiled for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _mm(a, b):
    """``a @ b`` as JAX computes a product of these dtypes on the CPU: f32
    products of the upcast values, rounded to the promoted dtype."""
    out = torch.promote_types(a.dtype, b.dtype)
    return (a.float() @ b.float()).to(out)


def _reference_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Kernel B5''s plain version: qkv ``[B, N, 3D]`` → ``[B, N, D]`` in
    qkv's dtype, with the Pallas kernel's rounding points: scores and
    softmax in f32, p rounded to qkv's dtype before the product with v, that
    product summed in f32 and rounded once. (JAX's ``_reference_packed``
    also rounds the scores to qkv's dtype, through its einsum; in f32 the
    two are the same function.)"""
    b, n, three_d = qkv.shape
    d = three_d // 3
    dh = d // heads

    def split(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    q, k, v = (split(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = _mm(p, v)
    return o.transpose(1, 2).reshape(b, n, d)


def _check_kernel_args(qkv: torch.Tensor, heads: int) -> None:
    """Raise ValueError for any input kernel B5' does not take."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3D], got {tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"kernel B5' takes bfloat16 qkv, got {qkv.dtype}")
    b, n, three_d = qkv.shape
    d = three_d // 3
    if b < 1 or n < 1:
        raise ValueError(f"empty batch or sequence: B={b}, N={n}")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the kernel's grid limit of 65535")
    if heads < 1 or d % heads or d // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel B5' takes head widths {KERNEL_HEAD_DIMS}, "
                         f"got D={d} over {heads} heads")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("kernel B5' needs a contiguous, 16-byte-aligned qkv")


@functools.cache
def _kernel_entry():
    """The C entry point with its ctypes signature, from the library built
    at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_attn").b5_mha_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def _launch_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """One launch of kernel B5' on a CUDA tensor (adds one to
    ``_launch_packed.launches``); raises on what it does not take or a
    failed launch."""
    _check_kernel_args(qkv, heads)
    b, n, three_d = qkv.shape
    d = three_d // 3
    out = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _kernel_entry()(qkv.data_ptr(), out.data_ptr(), b, n, d, heads,
                              stream)
    if err != 0:
        raise RuntimeError(f"kernel B5' launch failed: cudaError_t {err}")
    _launch_packed.launches += 1
    return out


_launch_packed.launches = 0


def fused_mha_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv ``[B, N, 3D]`` (token-major, as the fused qkv Linear emits it)
    → attention output ``[B, N, D]`` in qkv's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel B5' (and
    add one to ``fused_mha_packed.launches``) or raise: the kernel takes
    bfloat16 only. Inference only: there is no backward.
    """
    if qkv.device.type == "cuda":
        if torch.is_grad_enabled() and qkv.requires_grad:
            raise NotImplementedError("fused_mha_packed has no backward")
        out = _launch_packed(qkv, heads)
        fused_mha_packed.launches += 1
        return out
    if qkv.device.type == "cpu":
        return _reference_packed(qkv, heads)
    raise ValueError(f"no kernel B5' route for device {qkv.device}")


fused_mha_packed.launches = 0
