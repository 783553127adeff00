"""Fused ViT encoder layer (kernel B3) and attention half (kernel B4), with
their plain versions.

The port of ``acmil_tpu/ops/vit_layer.py``. Layer weights are a dict with a
timm block's state-dict names: ``norm1.{weight,bias}``,
``attn.qkv.{weight,bias}``, ``attn.proj.{weight,bias}``,
``norm2.{weight,bias}``, ``mlp.fc1.{weight,bias}``, ``mlp.fc2.{weight,bias}``
and, for layerscale trunks, ``ls1.gamma`` and ``ls2.gamma``; Linear weights
are ``[out, in]``.

- :func:`fused_vit_layer`: LN1 → qkv → MHA → proj → +x (f32 residual h) →
  LN2 → fc1 → tanh-approximate gelu → fc2 → +h. On a CUDA tensor it is a
  chain of five launches (``csrc/vit_gemm.cu`` four times and kernel B5'
  once) that replaces the Pallas ``_layer_kernel``; on a CPU tensor it is
  the plain :func:`_reference_layer`.
- :func:`fused_vit_attn_half`: LN1 → qkv → MHA → proj → (+b)·ls1 → +x, three
  launches on CUDA (replacing ``_attn_half_kernel``), plain
  :func:`_reference_attn_half` on the CPU.

Both cast the matrices to x's dtype, as the Pallas kernels do (a no-op for
matrices already in that dtype, see ``fast.cast_kernel_weights``); the plain
versions repeat every rounding point of those kernels. :func:`fits_vmem` and
:func:`attn_half_fits` are the JAX package's VMEM models, copied verbatim:
they describe no limit of this card. ``vit_encode`` uses them to pick each
trunk's route as the JAX package does. On a CUDA tensor the wrappers launch
their chain or raise, whatever the shape; only on a CPU tensor do they
repeat the JAX functions' whole behaviour, which takes
:func:`_unfused_layer` and :func:`_unfused_attn_half` outside those models.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from acmil_tpu_torch.ops.vit_attn_packed import (KERNEL_HEAD_DIMS,
                                                 _launch_packed, _mm,
                                                 _reference_packed)

LN_EPS = 1e-6

# epilogues of csrc/vit_gemm.cu
EPI_BIAS, EPI_BIAS_GELU, EPI_RES_BIAS, EPI_BIAS_LS_RES = range(4)
GEMM_K_MULTIPLE = 32
GEMM_N_MULTIPLE = 8


def _ln_f32(h, scale, bias):
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fits_vmem(dim: int, mlp_hidden: int, n_pad: int, heads: int,
              bytes_per_el: int = 2, budget: int = None,
              g: int = 1) -> bool:
    """The JAX package's scoped-VMEM model of kernel B3 for ``g`` images
    per program, copied verbatim as the route predicate of ``vit_encode``
    (the calibration is the TPU's, see ``acmil_tpu/ops/vit_layer.py``)."""
    if budget is None:
        calibrated = dim <= 448 and n_pad <= 256
        budget = (13 if calibrated else 10) * 2 ** 20
    weights = dim * (3 * dim + dim + 2 * mlp_hidden) * bytes_per_el
    gn = g * n_pad
    acts = (gn * 4 * (max(3 * dim, mlp_hidden) + dim)
            + n_pad * n_pad * 4)
    return weights + acts <= budget


def attn_half_fits(dim: int, n_pad: int, heads: int, g: int = 1,
                   bytes_per_el: int = 2,
                   budget: int = 13 * 2 ** 20) -> bool:
    """The JAX package's VMEM model of kernel B4, copied verbatim as the
    route predicate of ``vit_encode``."""
    weights = dim * 4 * dim * bytes_per_el
    gn = g * n_pad
    acts = gn * 4 * (3 * dim + dim) + n_pad * n_pad * 4
    return weights + acts <= budget


def _dot(a, b):
    """A product with f32 accumulation and an f32 result
    (``preferred_element_type=f32``)."""
    return a.float() @ b.float()


def _heads_attention(qkv, heads, like):
    """The einsum MHA of ``_unfused_layer``: scores in the promoted dtype of
    q and k, softmax in f32, p in ``like``'s dtype."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    dh = d // heads

    def heads_of(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    q, k, v = (heads_of(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    s = _mm(q, k.transpose(-1, -2)).float() / math.sqrt(dh)
    p = torch.softmax(s, dim=-1).to(like.dtype)
    o = _mm(p, v)
    return o.transpose(1, 2).reshape(b, n, d)


def _unfused_layer(x, w, heads, approx_gelu: bool = False):
    """The whole layer outside any kernel, as JAX's ``_unfused_layer``
    computes it with these weights' dtypes (exact gelu unless
    ``approx_gelu``)."""
    f32 = torch.float32
    y = _ln_f32(x.to(f32), w["norm1.weight"], w["norm1.bias"]).to(x.dtype)
    qkv = _mm(y, w["attn.qkv.weight"].t()) + w["attn.qkv.bias"]
    o = _heads_attention(qkv, heads, x)
    h = x.to(f32) + (_mm(o, w["attn.proj.weight"].t())
                     + w["attn.proj.bias"]).to(f32)
    y2 = _ln_f32(h, w["norm2.weight"], w["norm2.bias"]).to(x.dtype)
    m = F.gelu(_mm(y2, w["mlp.fc1.weight"].t()) + w["mlp.fc1.bias"],
               approximate="tanh" if approx_gelu else "none")
    m = _mm(m.to(x.dtype), w["mlp.fc2.weight"].t()) + w["mlp.fc2.bias"]
    return (h + m.to(f32)).to(x.dtype)


def _unfused_attn_half(x, w, heads, mha=None):
    """LN1 → qkv → MHA → proj (·ls1) → +x outside any kernel, as JAX's
    ``_unfused_attn_half``. ``mha``: an optional ``(qkv [B, N, 3D], heads)
    → o [B, N, D]`` in place of the einsum MHA (kernel B5' on the packed
    route)."""
    f32 = torch.float32
    y = _ln_f32(x.to(f32), w["norm1.weight"], w["norm1.bias"]).to(x.dtype)
    qkv = _mm(y, w["attn.qkv.weight"].t()) + w["attn.qkv.bias"]
    if mha is not None:
        o = mha(qkv.to(x.dtype), heads).to(x.dtype)
    else:
        o = _heads_attention(qkv, heads, x)
    attn = (_mm(o, w["attn.proj.weight"].t()) + w["attn.proj.bias"]).to(f32)
    if "ls1.gamma" in w:
        attn = attn * w["ls1.gamma"]
    return (x.to(f32) + attn).to(x.dtype)


def _reference_layer(x, w, heads):
    """Kernel B3's plain version, with every rounding point of the Pallas
    ``_layer_kernel``: matrices cast to x's dtype, LN statistics, products,
    softmax and both residuals in f32; y, qkv, p, o and the gelu output
    rounded to x's dtype; tanh-approximate gelu at every dtype."""
    dt = x.dtype
    xf = x.float()
    y = _ln_f32(xf, w["norm1.weight"], w["norm1.bias"]).to(dt)
    qkv = (_dot(y, w["attn.qkv.weight"].to(dt).t())
           + w["attn.qkv.bias"]).to(dt)
    o = _reference_packed(qkv, heads)
    h = xf + _dot(o, w["attn.proj.weight"].to(dt).t()) + w["attn.proj.bias"]
    y2 = _ln_f32(h, w["norm2.weight"], w["norm2.bias"]).to(dt)
    m = _dot(y2, w["mlp.fc1.weight"].to(dt).t()) + w["mlp.fc1.bias"]
    m = F.gelu(m, approximate="tanh").to(dt)
    m = _dot(m, w["mlp.fc2.weight"].to(dt).t())
    return (h + m + w["mlp.fc2.bias"]).to(dt)


def _reference_attn_half(x, w, heads):
    """Kernel B4's plain version, with the rounding points of the Pallas
    ``_attn_half_kernel``."""
    dt = x.dtype
    xf = x.float()
    y = _ln_f32(xf, w["norm1.weight"], w["norm1.bias"]).to(dt)
    qkv = (_dot(y, w["attn.qkv.weight"].to(dt).t())
           + w["attn.qkv.bias"]).to(dt)
    o = _reference_packed(qkv, heads)
    attn = _dot(o, w["attn.proj.weight"].to(dt).t()) + w["attn.proj.bias"]
    if "ls1.gamma" in w:
        attn = attn * w["ls1.gamma"].float()
    return (xf + attn).to(dt)


# ---------------------------------------------------------------------------
# The CUDA chains
# ---------------------------------------------------------------------------

@functools.cache
def _gemm_entry():
    """The GEMM's C entry point with its ctypes signature, from the library
    built at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("vit_gemm").vit_gemm
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, p, i, p, i, i, i, i, i, p]
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _gemm(a, w, bias, epilogue, *, out_dtype, ln=None, ls=None, res=None):
    """One launch of the GEMM (``csrc/vit_gemm.cu``): ``epilogue(
    prologue(a) · wᵀ)`` with a ``[M, K]`` bf16 or f32, w bf16 ``[N, K]``,
    f32 vectors; raises on what the kernel does not take."""
    m, k = a.shape
    n = w.shape[0]
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"GEMM input must be bfloat16 or float32, got {a.dtype}")
    if w.dtype != torch.bfloat16 or tuple(w.shape) != (n, k):
        raise ValueError(f"GEMM weight must be bfloat16 [{n}, {k}], got "
                         f"{w.dtype} {tuple(w.shape)}")
    if k % GEMM_K_MULTIPLE or n % GEMM_N_MULTIPLE:
        raise ValueError(f"the GEMM takes K % {GEMM_K_MULTIPLE} == 0 and "
                         f"N % {GEMM_N_MULTIPLE} == 0, got K={k}, N={n}")
    vectors = [(bias, n)] + [(t, k) for t in (ln or ())] + [(ls, n)]
    for t, size in vectors:
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (size,)):
            raise ValueError(f"GEMM vectors must be float32 [{size}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if res is not None and (tuple(res.shape) != (m, n) or res.dtype
                            not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"residual must be [{m}, {n}] bfloat16 or float32")
    for t in (a, w, bias, res, ls, *(ln or ())):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"all GEMM inputs must be on {a.device}, got "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the GEMM needs contiguous, 16-byte-aligned "
                             "inputs")
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    scale, shift = ln if ln is not None else (None, None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _gemm_entry()(
            a.data_ptr(), int(a.dtype == torch.float32), _ptr(scale),
            _ptr(shift), w.data_ptr(), bias.data_ptr(), _ptr(ls), _ptr(res),
            int(res is not None and res.dtype == torch.float32),
            out.data_ptr(), int(out_dtype == torch.float32), epilogue, m, n,
            k, stream)
    if err != 0:
        raise RuntimeError(f"GEMM launch failed: cudaError_t {err}")
    return out


def _check_chain_args(x, w, heads, mlp: bool) -> None:
    """Raise ValueError for a layer the CUDA chains do not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA layer kernels take bfloat16 x, got "
                         f"{x.dtype}")
    d = x.shape[-1]
    if heads < 1 or d % heads or d // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel B5' takes head widths {KERNEL_HEAD_DIMS}, "
                         f"got D={d} over {heads} heads")
    if d % GEMM_K_MULTIPLE:
        raise ValueError(f"D={d} is not a multiple of {GEMM_K_MULTIPLE}")
    if mlp and w["mlp.fc1.weight"].shape[0] % GEMM_K_MULTIPLE:
        raise ValueError(f"the MLP width is not a multiple of "
                         f"{GEMM_K_MULTIPLE}")


def _f32(t):
    return t.float().contiguous()


def _bf16(t):
    return t.to(torch.bfloat16).contiguous()


def _launch_layer(x, w, heads):
    """Kernel B3 on CUDA: the chain of five launches."""
    _check_chain_args(x, w, heads, mlp=True)
    b, n, d = x.shape
    x2 = x.contiguous().view(b * n, d)
    qkv = _gemm(x2, _bf16(w["attn.qkv.weight"]), _f32(w["attn.qkv.bias"]),
                EPI_BIAS, out_dtype=torch.bfloat16,
                ln=(_f32(w["norm1.weight"]), _f32(w["norm1.bias"])))
    o = _launch_packed(qkv.view(b, n, 3 * d), heads)
    h = _gemm(o.view(b * n, d), _bf16(w["attn.proj.weight"]),
              _f32(w["attn.proj.bias"]), EPI_RES_BIAS, res=x2,
              out_dtype=torch.float32)
    m = _gemm(h, _bf16(w["mlp.fc1.weight"]), _f32(w["mlp.fc1.bias"]),
              EPI_BIAS_GELU, out_dtype=torch.bfloat16,
              ln=(_f32(w["norm2.weight"]), _f32(w["norm2.bias"])))
    out = _gemm(m, _bf16(w["mlp.fc2.weight"]), _f32(w["mlp.fc2.bias"]),
                EPI_RES_BIAS, res=h, out_dtype=torch.bfloat16)
    return out.view(b, n, d)


def _launch_attn_half(x, w, heads):
    """Kernel B4 on CUDA: the chain of three launches."""
    _check_chain_args(x, w, heads, mlp=False)
    b, n, d = x.shape
    x2 = x.contiguous().view(b * n, d)
    qkv = _gemm(x2, _bf16(w["attn.qkv.weight"]), _f32(w["attn.qkv.bias"]),
                EPI_BIAS, out_dtype=torch.bfloat16,
                ln=(_f32(w["norm1.weight"]), _f32(w["norm1.bias"])))
    o = _launch_packed(qkv.view(b, n, 3 * d), heads)
    ls = _f32(w["ls1.gamma"]) if "ls1.gamma" in w else None
    out = _gemm(o.view(b * n, d), _bf16(w["attn.proj.weight"]),
                _f32(w["attn.proj.bias"]), EPI_BIAS_LS_RES, ls=ls, res=x2,
                out_dtype=torch.bfloat16)
    return out.view(b, n, d)


def _refuse_grad(x, w, name):
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in w.values())):
        raise NotImplementedError(f"{name} has no backward on CUDA")


def fused_vit_layer(x: torch.Tensor, w: dict, heads: int) -> torch.Tensor:
    """x ``[B, N, D]`` → ``[B, N, D]`` through one whole encoder layer
    (kernel B3). CUDA tensors launch the chain (and add one to
    ``fused_vit_layer.launches``) or raise: it takes bfloat16 x at any N.
    CPU tensors take the JAX function's plain version: :func:`_reference_layer`,
    or :func:`_unfused_layer` for a layer outside :func:`fits_vmem`."""
    if x.device.type == "cuda":
        _refuse_grad(x, w, "fused_vit_layer")
        out = _launch_layer(x, w, heads)
        fused_vit_layer.launches += 1
        return out
    if x.device.type == "cpu":
        b, n, d = x.shape
        hidden = w["mlp.fc1.weight"].shape[0]
        if not fits_vmem(d, hidden, _round_up(n, 16), heads):
            return _unfused_layer(x, w, heads)
        return _reference_layer(x, w, heads)
    raise ValueError(f"no kernel B3 route for device {x.device}")


fused_vit_layer.launches = 0


def fused_vit_attn_half(x: torch.Tensor, w: dict, heads: int) -> torch.Tensor:
    """x ``[B, N, D]`` → LN1 → qkv → MHA → proj (·ls1) → +x (kernel B4);
    the MLP half is the caller's. CUDA tensors launch the chain (and add one
    to ``fused_vit_attn_half.launches``) or raise. CPU tensors take the JAX
    function's plain version: :func:`_reference_attn_half`, or
    :func:`_unfused_attn_half` for a shape outside :func:`attn_half_fits`."""
    if x.device.type == "cuda":
        _refuse_grad(x, w, "fused_vit_attn_half")
        out = _launch_attn_half(x, w, heads)
        fused_vit_attn_half.launches += 1
        return out
    if x.device.type == "cpu":
        b, n, d = x.shape
        if not attn_half_fits(d, _round_up(n, 16), heads, g=1,
                              bytes_per_el=x.element_size()):
            return _unfused_attn_half(x, w, heads)
        return _reference_attn_half(x, w, heads)
    raise ValueError(f"no kernel B4 route for device {x.device}")


fused_vit_attn_half.launches = 0
