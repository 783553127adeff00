"""Multi-head attention over separate q, k, v: kernel B7 and its plain
version.

The port of ``acmil_tpu/ops/vit_attn.py``. :func:`fused_vit_attention` takes
q, k, v ``[B, H, N, dh]`` of one float dtype (float32, float16 or bfloat16)
and any head width up to 256, and returns ``softmax(q kᵀ · scale) v`` in
q's dtype, ``scale`` defaulting to ``1/sqrt(dh)``. It is a
``torch.autograd.Function``: the forward launches kernel B7 on CUDA tensors
and takes the plain version :func:`_reference_attention` on CPU tensors;
the backward recomputes through the plain version, as the JAX
``custom_vjp`` does.

B7 has three routes, chosen by :func:`_route`:

- ``mma``: bfloat16 or float16 at dh in {16, 32, 64, 128} with rows
  16-byte aligned, on the tensor cores (``csrc/vit_attn.cu``'s strided entry, the body of
  kernel B5' reading each operand through its strides);
- ``tf32x3``: float32 at dh in {16, 32, 64, 128} with rows 16-byte aligned,
  on the tensor cores in split-TF32, one pass over the keys
  (``csrc/vit_attn_f32.cu``);
- ``fma``: every other head width and alignment, at any of the three
  dtypes, on the f32 FMA units in two passes over the keys
  (``csrc/vit_attn_generic.cu``).

Each keeps the Pallas kernel's rounding points and reads every operand, the
``out`` buffer included, through its strides. Step2's tensor-parallel block
(``parallel/tp.py::_tp_block``) runs its local heads through it; the
one-process ViT routes go through B5' (``ops/vit_attn_packed.py``), as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from acmil_tpu_torch.ops.vit_attn_packed import (_MMA_DTYPES,
                                                 FLOAT_DTYPES,
                                                 KERNEL_HEAD_DIMS,
                                                 MAX_HEAD_DIM, _launch_fma,
                                                 _launch_tf32x3, _mm)


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


def _check_out(q, out) -> None:
    """Raise ValueError unless ``out`` can take the result for ``q``."""
    if out.shape != q.shape or out.dtype != q.dtype \
            or out.device != q.device:
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")


def _check_kernel_args(q, k, v, out=None) -> None:
    """Raise ValueError for any input kernel B7 does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, N, dh] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, dh = q.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must be on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in FLOAT_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"kernel B7 takes q, k, v of one dtype, float32, "
                         f"float16 or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if b < 1 or h < 1 or n < 1:
        raise ValueError(f"empty input: B={b}, H={h}, N={n}")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} or H={h} exceeds the kernel's grid limit "
                         f"of 65535")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"kernel B7 takes head widths up to {MAX_HEAD_DIM}, "
                         f"got dh={dh}")
    if out is not None:
        _check_out(q, out)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"kernel B7 needs {name}'s rows of dh elements "
                             f"contiguous")


def _route(q, k, v, out) -> str:
    """A tensor-core route where one takes the operands (dh in
    ``KERNEL_HEAD_DIMS``, every row 16-byte aligned: each (batch, head,
    token) stride a whole number of 16-byte units and each base 16-byte
    aligned): ``mma`` at bfloat16 or float16, ``tf32x3`` at float32; else
    ``fma``."""
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        return "fma"
    for t in (q, k, v, out):
        if any(st * t.element_size() % 16 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            return "fma"
    return "tf32x3" if q.dtype == torch.float32 else "mma"


@functools.cache
def _kernel_entry():
    """The tensor-core route's C entry point with its ctypes signature, from
    the library built at first use (the tf32x3 and fma routes' are
    ``vit_attn_packed._tf32x3_entry`` and ``_fma_entry``)."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_attn").b7_mha_strided
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(q, k, v, scale: Optional[float], out=None) -> torch.Tensor:
    """One launch of kernel B7 on CUDA tensors, into ``out`` when given;
    raises on what it does not take or a failed launch."""
    _check_kernel_args(q, k, v, out)
    b, h, n, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if out is None:
        out = torch.empty(b, h, n, dh, dtype=q.dtype, device=q.device)
    route = _route(q, k, v, out)
    if route == "fma":
        _launch_fma(q, k, v, out, scale)
    elif route == "tf32x3":
        _launch_tf32x3(q, k, v, out, scale)
    else:
        args = []
        for t in (q, k, v, out):
            args += [t.data_ptr(), *t.stride()[:3]]
        args += [b, h, n, dh, float(scale), _MMA_DTYPES[q.dtype]]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _kernel_entry()(*args, stream)
        if err != 0:
            raise RuntimeError(f"kernel B7 (mma route) launch failed: "
                               f"cudaError_t {err}")
    fused_vit_attention.launches += 1
    fused_vit_attention.route_launches[route] += 1
    return out


def _forward(q, k, v, scale, out=None) -> torch.Tensor:
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, out)
    if q.device.type == "cpu":
        want = _reference_attention(q, k, v, scale)
        if out is None:
            return want
        _check_out(q, out)
        return out.copy_(want)
    raise ValueError(f"no kernel B7 route for device {q.device}")


class _FusedVitAttention(torch.autograd.Function):
    """Forward through B7 (the plain version on the CPU); backward through
    autograd of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

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
                        scale: Optional[float] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v for q, k, v ``[B, H, N, dh]`` → ``[B, H, N,
    dh]`` in q's dtype; ``scale`` defaults to ``1/sqrt(dh)``.

    CPU tensors take the plain version; CUDA tensors launch kernel B7 (and
    add one to ``fused_vit_attention.launches`` and to its route's count in
    ``fused_vit_attention.route_launches``) or raise: the kernel takes
    float32, float16 and bfloat16 at dh up to 256, any N (keys are
    streamed), rows of dh elements contiguous. Differentiable: the backward
    recomputes through the plain version. ``out``, a ``[B, H, N, dh]``
    tensor of q's dtype with any strides (e.g. a view of a token-major
    ``[B, N, H·dh]`` buffer), takes the result in place; a call with
    ``out`` takes no gradient."""
    if out is None:
        return _FusedVitAttention.apply(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("fused_vit_attention(out=...) takes no gradient: "
                         "call it under torch.no_grad()")
    return _forward(q, k, v, scale, out)


fused_vit_attention.launches = 0
fused_vit_attention.route_launches = {"mma": 0, "tf32x3": 0, "fma": 0}
