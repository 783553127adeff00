"""Packed-layout multi-head attention: kernel B5' and its plain version.

The port of ``acmil_tpu/ops/vit_attn_packed.py``. :func:`fused_mha_packed`
takes the qkv projection exactly as a ViT's fused qkv Linear emits it,
token-major ``[B, N, 3D]``, splits the heads inside the kernel and returns
the attention output token-major ``[B, N, D]``, ready for the output
projection: no ``[B, H, N, dh]`` copy reaches device memory.

The wrapper picks its route by the device of ``qkv``: a CPU tensor takes
the plain version :func:`_reference_packed`, a CUDA tensor launches kernel
B5' (which replaces the Pallas ``_packed_kernel``) or raises. On the card
B5' has three routes, chosen by :func:`_packed_route` from the dtype and the
head width alone:

- ``mma``: bfloat16 or float16 at dh in ``KERNEL_HEAD_DIMS``, on the tensor
  cores (``csrc/vit_attn.cu``'s packed entry);
- ``tf32x3``: float32 at dh in ``KERNEL_HEAD_DIMS``, on the tensor cores in
  split-TF32, one pass over the keys (``csrc/vit_attn_f32.cu``), on
  strided views of the packed qkv and of the output;
- ``fma``: any other head width up to ``MAX_HEAD_DIM``, at any of the three
  dtypes, through B7's fma route (``csrc/vit_attn_generic.cu``, f32 FMA, two
  passes) on the same strided views: no copy.

Kernels B3 and B4 (``ops/vit_layer.py``) launch B5' as their attention step
through :func:`_launch_packed`, which counts every launch of the kernel
(``_launch_packed.launches``, by route and dtype in
``_launch_packed.route_launches``), whoever calls it;
``fused_mha_packed.launches`` counts the public entry's alone.
:func:`fused_mha_packed` is a ``torch.autograd.Function`` whose backward is
autograd of :func:`_reference_packed`, recomputed, as the JAX
``custom_vjp`` differentiates its reference.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# head widths csrc/vit_attn.cu is compiled for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# the widest head B5' and B7 take, on the fma route (the head widths off
# KERNEL_HEAD_DIMS): its query tile [64, dh] of f32 and a key tile of the
# same size stay in shared memory (the Pallas kernel's bound is VMEM
# instead)
MAX_HEAD_DIM = 256
# the dtypes B5' takes, and the tensor-core route's
FLOAT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# each dtype's key in the launch counters (``_launch_packed``, the GEMM's)
DTYPE_KEYS = {torch.float32: "f32", torch.float16: "f16",
              torch.bfloat16: "bf16"}
# the dtype codes of csrc/vit_attn.cu's entries (tensor-core route) and of
# csrc/vit_attn_generic.cu::b7_mha_generic (B7's fma route)
_MMA_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_FMA_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# csrc/vit_attn_f32.cu (the tf32x3 route): its kernel, as the profiler
# names it, and its tile (queries a block, keys a tile)
TF32X3_KERNELS = ("b7_tf32x3_kernel",)
TF32X3_QUERIES, TF32X3_KEYS = 128, 16


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
    if qkv.dtype not in FLOAT_DTYPES:
        raise ValueError(f"kernel B5' takes float32, float16 or bfloat16 "
                         f"qkv, got {qkv.dtype}")
    b, n, three_d = qkv.shape
    d = three_d // 3
    if b < 1 or n < 1:
        raise ValueError(f"empty batch or sequence: B={b}, N={n}")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the kernel's grid limit of 65535")
    if heads < 1 or d % heads or d // heads > MAX_HEAD_DIM:
        raise ValueError(f"kernel B5' takes head widths up to {MAX_HEAD_DIM}"
                         f", got D={d} over {heads} heads")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("kernel B5' needs a contiguous, 16-byte-aligned qkv")


def _packed_route(qkv: torch.Tensor, heads: int) -> str:
    """``mma`` for bfloat16 or float16 at a head width in
    ``KERNEL_HEAD_DIMS``, ``tf32x3`` for float32 at those widths, else
    ``fma``: by dtype and dh alone (the checked qkv is contiguous and
    16-byte aligned, and at those widths every view of it the routes read
    has strides of whole 16-byte units)."""
    dh = qkv.shape[-1] // 3 // heads
    if dh not in KERNEL_HEAD_DIMS:
        return "fma"
    return "tf32x3" if qkv.dtype == torch.float32 else "mma"


@functools.cache
def _kernel_entry():
    """The C entry point with its ctypes signature, from the library built
    at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_attn").b5_mha_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


@functools.cache
def _fma_entry():
    """B7's fma route's C entry point with its ctypes signature, from the
    library built at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_attn_generic").b7_mha_generic
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.cache
def _tf32x3_entry():
    """The tf32x3 route's C entry point with its ctypes signature, from the
    library built at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_attn_f32").b7_mha_tf32x3
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def _launch_strided(entry, lead: list, q, k, v, out, scale: float,
                    what: str) -> torch.Tensor:
    """One launch of a strided C entry (``lead`` arguments, then q, k, v,
    out as pointer and (batch, head, token) strides, then B, H, N, dh,
    scale and the stream) on CUDA tensors ``[B, H, N, dh]``; returns
    ``out``, raises on a failed launch."""
    b, h, n, dh = q.shape
    args = list(lead)
    for t in (q, k, v, out):
        args += [t.data_ptr(), *t.stride()[:3]]
    args += [b, h, n, dh, float(scale)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: launch failed: cudaError_t {err}")
    return out


def _launch_tf32x3(q, k, v, out, scale: float) -> torch.Tensor:
    """One launch of the tf32x3 route (``csrc/vit_attn_f32.cu``) on float32
    CUDA tensors q, k, v, out ``[B, H, N, dh]`` at dh in
    ``KERNEL_HEAD_DIMS`` with 16-byte-aligned rows, each read through its
    strides; returns ``out``. It checks and counts nothing: kernels B7 and
    B5' check their operands and count their own launches (and the C entry
    refuses unaligned rows)."""
    return _launch_strided(_tf32x3_entry(), [], q, k, v, out, scale,
                           "B5'/B7's tf32x3 route")


def _launch_fma(q, k, v, out, scale: float) -> torch.Tensor:
    """One launch of B7's fma route (``csrc/vit_attn_generic.cu``) on CUDA
    tensors q, k, v, out ``[B, H, N, dh]``, each read through its strides;
    returns ``out``. It checks and counts nothing: kernels B7 and B5' check
    their operands and count their own launches."""
    return _launch_strided(_fma_entry(), [_FMA_DTYPES[q.dtype]], q, k, v, out,
                           scale, "B7's fma route")


def _launch_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """One launch of kernel B5' on a CUDA tensor, on the route
    :func:`_packed_route` names (adds one to ``_launch_packed.launches`` and
    to its route's count); raises on what it does not take or a failed
    launch."""
    _check_kernel_args(qkv, heads)
    b, n, three_d = qkv.shape
    d = three_d // 3
    out = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)
    route = _packed_route(qkv, heads)
    if route == "mma":
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            err = _kernel_entry()(qkv.data_ptr(), out.data_ptr(), b, n, d,
                                  heads, _MMA_DTYPES[qkv.dtype], stream)
        if err != 0:
            raise RuntimeError(f"kernel B5' launch failed: cudaError_t {err}")
        key = DTYPE_KEYS[qkv.dtype]
    else:
        # the strided routes on views of the packed layout: q, k, v at
        # offsets 0, D and 2D with strides (N 3D, dh, 3D), o with (N D, dh,
        # D)
        dh = d // heads
        q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        launch = _launch_tf32x3 if route == "tf32x3" else _launch_fma
        launch(q, k, v, out.view(b, n, heads, dh).transpose(1, 2),
               1.0 / math.sqrt(dh))
        key = route
    _launch_packed.launches += 1
    _launch_packed.route_launches[key] += 1
    return out


_launch_packed.launches = 0
_launch_packed.route_launches = {"bf16": 0, "f16": 0, "tf32x3": 0,
                                 "fma": 0}


class _FusedMhaPacked(torch.autograd.Function):
    """Forward through B5' (the plain version on the CPU); backward through
    autograd of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.save_for_backward(qkv)
        ctx.heads = heads
        if qkv.device.type == "cuda":
            out = _launch_packed(qkv, heads)
            fused_mha_packed.launches += 1
            return out
        if qkv.device.type == "cpu":
            return _reference_packed(qkv, heads)
        raise ValueError(f"no kernel B5' route for device {qkv.device}")

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(_reference_packed(x, ctx.heads), x, g)
        return gx, None


def fused_mha_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv ``[B, N, 3D]`` (token-major, as the fused qkv Linear emits it)
    → attention output ``[B, N, D]`` in qkv's dtype.

    CPU tensors take the plain version; CUDA tensors launch kernel B5' (and
    add one to ``fused_mha_packed.launches``) or raise: it takes float32,
    float16 and bfloat16 at head widths up to ``MAX_HEAD_DIM``, on the
    route :func:`_packed_route` names.
    Differentiable: the backward recomputes through the plain version.
    """
    return _FusedMhaPacked.apply(qkv, heads)


fused_mha_packed.launches = 0
