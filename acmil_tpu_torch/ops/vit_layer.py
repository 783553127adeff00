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
  chain of seven launches that replaces the Pallas ``_layer_kernel``: a
  GEMM four times, two of them after its LayerNorm prologue kernel, and
  kernel B5' once; on a CPU tensor it is the plain
  :func:`_reference_layer`.
- :func:`fused_vit_attn_half`: LN1 → qkv → MHA → proj → (+b)·ls1 → +x, four
  launches on CUDA (replacing ``_attn_half_kernel``), plain
  :func:`_reference_attn_half` on the CPU.

Both take x in float32, float16 or bfloat16, as the Pallas kernels do, and
cast the matrices to x's dtype (a no-op for matrices already in that dtype,
see ``fast.cast_kernel_weights``); the plain versions repeat every rounding
point of those kernels. The GEMM is ``csrc/vit_gemm.cu`` (TMA and wgmma) at
bfloat16 and float16 and ``csrc/vit_gemm_f32.cu`` (TMA and split-TF32
wgmma, f32's accuracy, after :func:`split_w`) at float32; B5' takes its
tensor-core routes at every float dtype (``ops/vit_attn_packed.py``).

Both are ``torch.autograd.Function``s: the backward is autograd of the
function the JAX ``custom_vjp`` differentiates, recomputed from the saved
inputs (:func:`_unfused_layer` with exact gelu for B3,
:func:`_unfused_attn_half` for B4), with gradients for x and for every
weight of the dict. :func:`fits_vmem` and
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

from acmil_tpu_torch.ops.vit_attn_packed import (DTYPE_KEYS, FLOAT_DTYPES,
                                                 MAX_HEAD_DIM,
                                                 _launch_packed, _mm,
                                                 _reference_packed)

LN_EPS = 1e-6

# epilogues of csrc/vit_gemm.cu; the fifth, SwiGLU, is csrc/vit_gemm_f32.cu's
# bf16-A mode's alone
EPI_BIAS, EPI_BIAS_GELU, EPI_RES_BIAS, EPI_BIAS_LS_RES, EPI_BIAS_SWIGLU = \
    range(5)
GEMM_K_MULTIPLE = 32
GEMM_N_MULTIPLE = 8
# the SwiGLU epilogue's N: whole 128-column tiles, each 64 gate and 64 value
# columns of W's gathered rows (swiglu_order)
SWIGLU_TILE = 128
# the f32 GEMM's order of depth in a 32-deep stage (csrc/vit_gemm_f32.cu,
# k_position): position p = 8 j + s (slot s of k8 step j) holds column
# 8 (s % 4) + 2 j + s // 4 of the slice
SPLIT_K_ORDER = tuple(8 * (p % 4) + 2 * (p // 8) + (p % 8) // 4
                      for p in range(32))


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
def _gemm_entry(mode: str):
    """The C entry point of the GEMM with its ctypes signature, from the
    library built at first use: ``"f32"`` (``csrc/vit_gemm_f32.cu``), its
    ``"bf16a"`` mode (bf16 A, f32 W) or ``"half"`` (bfloat16/float16,
    ``csrc/vit_gemm.cu``)."""
    from acmil_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    if mode == "f32":
        fn = _build.load("vit_gemm_f32").vit_gemm_f32
        fn.argtypes = [p] * 10 + [i] * 4 + [p]
    elif mode == "bf16a":
        fn = _build.load("vit_gemm_f32").vit_gemm_f32_bf16a
        fn.argtypes = [p] * 10 + [i] * 5 + [p]
    else:
        fn = _build.load("vit_gemm").vit_gemm
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tf32_bits(bits):
    """int64 holding f32 bit patterns -> the TF32 rounding of each (to
    nearest, ties away from 0: add 0x1000 and clear the low 13 bits, as
    ``csrc/tf32x3.cuh::to_tf32`` does)."""
    return (bits + 0x1000) & 0xffffe000


def _as_f32(bits):
    """int64 holding 32-bit patterns -> float32."""
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def swiglu_order(n: int) -> torch.Tensor:
    """The rows of a SwiGLU-packed fc1's W ``[N, K]`` (gate rows, then value
    rows) in the order the SwiGLU epilogue reads them, as the split kernel
    gathers them: 128-row tile t holds gate rows 64 t .. 64 t + 63, then
    value rows N / 2 + 64 t .. N / 2 + 64 t + 63."""
    half, c = SWIGLU_TILE // 2, torch.arange(n) % SWIGLU_TILE
    return torch.arange(n) // SWIGLU_TILE * half + c % half + (
        c >= half) * (n // 2)


def _swiglu_tiles(acc, bias):
    """The SwiGLU epilogue's plain version: ``acc [M, N]``, the products of
    the gathered W (:func:`swiglu_order`), and fc1's bias as given → ``[M,
    N / 2]`` f32, ``silu(gate + b) · (value + b)`` column by column."""
    m, n = acc.shape
    t = (acc + bias[swiglu_order(n)]).view(m, n // SWIGLU_TILE, 2,
                                           SWIGLU_TILE // 2)
    return (F.silu(t[:, :, 0]) * t[:, :, 1]).reshape(m, n // 2)


def _split_w_reference(w):
    """The split kernel's plain version: ``[2, N, K]`` float32, W's hi =
    tf32(w) then lo = tf32(w - hi) (an infinity or a NaN passes as hi, with
    lo = 0), each row's 32-wide slices in the f32 GEMM's order of depth
    (column ``SPLIT_K_ORDER[p]`` of a slice at position p)."""
    n, k = w.shape
    bits = w.float().contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    finite = (bits & 0x7f800000) != 0x7f800000
    hi_bits = torch.where(finite, _tf32_bits(bits), bits)
    hi = _as_f32(hi_bits)
    rest = (w.float() - hi).view(torch.int32).to(torch.int64) & 0xffffffff
    lo = torch.where(finite, _as_f32(_tf32_bits(rest)), torch.zeros_like(hi))
    order = torch.tensor(SPLIT_K_ORDER)
    both = torch.stack([hi, lo]).view(2, n, k // 32, 32)
    return both[..., order].reshape(2, n, k).contiguous()


def split_w(w):
    """W ``[N, K]`` float32 (K a multiple of 32) → its TF32 halves as the
    f32 GEMM reads them (:func:`_split_w_reference`): the split kernel of
    ``csrc/vit_gemm_f32.cu`` on a CUDA tensor, which adds one to
    ``split_w.launches``; the plain version on a CPU tensor."""
    if w.dtype != torch.float32 or w.dim() != 2 or w.shape[1] % 32:
        raise ValueError(f"split_w takes float32 [N, K] with K % 32 == 0, "
                         f"got {w.dtype} {tuple(w.shape)}")
    w = w.contiguous()
    if w.device.type == "cpu":
        return _split_w_reference(w)
    if w.device.type != "cuda":
        raise ValueError(f"no split_w route for device {w.device}")
    n, k = w.shape
    out = torch.empty(2, n, k, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _split_entry()(w.data_ptr(), out.data_ptr(), n, k,
                             torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_w launch failed: cudaError_t {err}")
    split_w.launches += 1
    return out


split_w.launches = 0


@functools.cache
def _split_entry():
    from acmil_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.load("vit_gemm_f32").vit_gemm_f32_split_w
    fn.argtypes = [p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _gemm(a, w, bias, epilogue, *, out_dtype, ln=None, ls=None, res=None):
    """One call of the GEMM: ``epilogue(prologue(a) · wᵀ)`` with w ``[N,
    K]`` of the chain's dtype and f32 vectors; raises on what the kernel
    does not take. At bfloat16 or float16 (``csrc/vit_gemm.cu``) ``a``, the
    residual and the output are w's dtype or f32; with a LayerNorm or an
    f32 ``a`` the prologue kernel first writes ``a``'s rows in w's dtype to
    a workspace that the product reads. At float32
    (``csrc/vit_gemm_f32.cu``) everything is f32, the prologue runs only
    for a LayerNorm, writing f32 rows, and the split kernel writes w's
    TF32 halves to a ``[2, N, K]`` workspace first (:func:`split_w`). A
    bfloat16 ``a`` with an f32 ``w`` takes that GEMM's bf16-A mode: f32's
    accuracy in two TF32 products (a bf16 value is exact in TF32), the
    prologue writing bf16 rows, the residual bfloat16 and the output
    bfloat16 or f32. That mode alone takes :data:`EPI_BIAS_SWIGLU` (fc1 of
    a SwiGLU-packed MLP: N a multiple of 128, no residual, the output ``[M,
    N / 2]``, ``silu(gate) · value`` of :func:`_swiglu_tiles` on W's rows
    gathered by the split kernel). Adds one to ``_gemm.launches[mode]``
    (``bf16``, ``f16``, ``f32``, ``bf16a``)."""
    f32 = torch.float32
    m, k = a.shape
    n = w.shape[0]
    if epilogue not in range(EPI_BIAS_SWIGLU + 1):
        raise ValueError(f"no GEMM epilogue {epilogue!r}")
    swiglu = epilogue == EPI_BIAS_SWIGLU
    if swiglu and (a.dtype != torch.bfloat16 or w.dtype != f32
                   or n % SWIGLU_TILE or res is not None or ls is not None):
        raise ValueError(f"the SwiGLU epilogue takes bfloat16 A, float32 W "
                         f"with N % {SWIGLU_TILE} == 0 and no residual or "
                         f"layerscale, got {a.dtype} A, {w.dtype} W, N={n}")
    if w.dtype not in FLOAT_DTYPES:
        raise ValueError(f"GEMM weight must be bfloat16, float16 or float32, "
                         f"got {w.dtype}")
    if w.dtype != f32 and a.dtype not in (w.dtype, f32):
        raise ValueError(f"GEMM input must be "
                         f"{str(w.dtype).removeprefix('torch.')} or float32, "
                         f"got {a.dtype}")
    dt = a.dtype if a.dtype != f32 else w.dtype   # the chain's dtype
    name = str(dt).removeprefix("torch.")
    if dt not in FLOAT_DTYPES:
        raise ValueError(f"GEMM input must be bfloat16, float16 or float32, "
                         f"got {a.dtype}")
    bf16a = dt == torch.bfloat16 and w.dtype == f32
    w_dt = f32 if bf16a else dt
    if w.dtype != w_dt or tuple(w.shape) != (n, k):
        raise ValueError(f"GEMM weight must be "
                         f"{str(w_dt).removeprefix('torch.')} [{n}, {k}], got "
                         f"{w.dtype} {tuple(w.shape)}")
    if k % GEMM_K_MULTIPLE or n % GEMM_N_MULTIPLE:
        raise ValueError(f"the GEMM takes K % {GEMM_K_MULTIPLE} == 0 and "
                         f"N % {GEMM_N_MULTIPLE} == 0, got K={k}, N={n}")
    vectors = [(bias, n)] + [(t, k) for t in (ln or ())] + [(ls, n)]
    for t, size in vectors:
        if t is not None and (t.dtype != f32 or tuple(t.shape) != (size,)):
            raise ValueError(f"GEMM vectors must be float32 [{size}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    res_dtypes = (dt,) if bf16a else (dt, f32)
    if res is not None and (tuple(res.shape) != (m, n)
                            or res.dtype not in res_dtypes):
        raise ValueError(f"residual must be [{m}, {n}] "
                         + " or ".join(str(t).removeprefix("torch.")
                                       for t in res_dtypes))
    if out_dtype not in (dt, f32):
        raise ValueError(f"GEMM output must be {name} or float32, got "
                         f"{out_dtype}")
    for t in (a, w, bias, res, ls, *(ln or ())):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"all GEMM inputs must be on {a.device}, got "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the GEMM needs contiguous, 16-byte-aligned "
                             "inputs")
    out = torch.empty(m, n // 2 if swiglu else n, dtype=out_dtype,
                      device=a.device)
    scale, shift = ln if ln is not None else (None, None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if dt == f32:
            rows = (torch.empty(m, k, dtype=f32, device=a.device)
                    if ln is not None else None)
            w_split = torch.empty(2, n, k, dtype=f32, device=a.device)
            err = _gemm_entry("f32")(
                a.data_ptr(), _ptr(scale), _ptr(shift), _ptr(rows),
                w.data_ptr(), w_split.data_ptr(), bias.data_ptr(), _ptr(ls),
                _ptr(res), out.data_ptr(), epilogue, m, n, k, stream)
        elif bf16a:
            rows = (torch.empty(m, k, dtype=dt, device=a.device)
                    if ln is not None else None)
            w_split = torch.empty(2, n, k, dtype=f32, device=a.device)
            err = _gemm_entry("bf16a")(
                a.data_ptr(), _ptr(scale), _ptr(shift), _ptr(rows),
                w.data_ptr(), w_split.data_ptr(), bias.data_ptr(), _ptr(ls),
                _ptr(res), out.data_ptr(), int(out_dtype == f32), epilogue,
                m, n, k, stream)
        else:
            rows = (torch.empty(m, k, dtype=dt, device=a.device)
                    if ln is not None or a.dtype == f32 else None)
            err = _gemm_entry("half")(
                a.data_ptr(), int(a.dtype == f32), _ptr(scale), _ptr(shift),
                _ptr(rows), w.data_ptr(), bias.data_ptr(), _ptr(ls),
                _ptr(res), int(res is not None and res.dtype == f32),
                out.data_ptr(), int(out_dtype == f32), epilogue, m, n, k,
                int(dt == torch.float16), stream)
    if err != 0:
        raise RuntimeError(f"GEMM launch failed: cudaError_t {err}")
    _gemm.launches["bf16a" if bf16a else DTYPE_KEYS[dt]] += 1
    return out


_gemm.launches = {"bf16": 0, "f16": 0, "f32": 0, "bf16a": 0}


def _check_chain_args(x, w, heads, mlp: bool) -> None:
    """Raise ValueError for a layer the CUDA chains do not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    if x.dtype not in FLOAT_DTYPES:
        raise ValueError(f"the CUDA layer kernels take float32, float16 or "
                         f"bfloat16 x, got {x.dtype}")
    d = x.shape[-1]
    if heads < 1 or d % heads or d // heads > MAX_HEAD_DIM:
        raise ValueError(f"kernel B5' takes head widths up to {MAX_HEAD_DIM}"
                         f", got D={d} over {heads} heads")
    if d % GEMM_K_MULTIPLE:
        raise ValueError(f"D={d} is not a multiple of {GEMM_K_MULTIPLE}")
    if mlp and w["mlp.fc1.weight"].shape[0] % GEMM_K_MULTIPLE:
        raise ValueError(f"the MLP width is not a multiple of "
                         f"{GEMM_K_MULTIPLE}")


def _f32(t):
    return t.float().contiguous()


def _mat(t, dtype):
    """A matrix cast to the chain's dtype, as the Pallas kernels cast it."""
    return t.to(dtype).contiguous()


def _launch_layer(x, w, heads):
    """Kernel B3 on CUDA: the chain of seven launches (LN1, qkv, B5', proj,
    LN2, fc1, fc2), the matrices in x's dtype."""
    _check_chain_args(x, w, heads, mlp=True)
    b, n, d = x.shape
    dt, f32 = x.dtype, torch.float32
    x2 = x.contiguous().view(b * n, d)
    qkv = _gemm(x2, _mat(w["attn.qkv.weight"], dt), _f32(w["attn.qkv.bias"]),
                EPI_BIAS, out_dtype=dt,
                ln=(_f32(w["norm1.weight"]), _f32(w["norm1.bias"])))
    o = _launch_packed(qkv.view(b, n, 3 * d), heads)
    h = _gemm(o.view(b * n, d), _mat(w["attn.proj.weight"], dt),
              _f32(w["attn.proj.bias"]), EPI_RES_BIAS, res=x2, out_dtype=f32)
    m = _gemm(h, _mat(w["mlp.fc1.weight"], dt), _f32(w["mlp.fc1.bias"]),
              EPI_BIAS_GELU, out_dtype=dt,
              ln=(_f32(w["norm2.weight"]), _f32(w["norm2.bias"])))
    out = _gemm(m, _mat(w["mlp.fc2.weight"], dt), _f32(w["mlp.fc2.bias"]),
                EPI_RES_BIAS, res=h, out_dtype=dt)
    return out.view(b, n, d)


def _launch_attn_half(x, w, heads, cast: bool = True):
    """Kernel B4 on CUDA: the chain of four launches (LN1, qkv, B5',
    proj), the matrices in x's dtype. ``cast=False`` keeps them f32, as
    they are: at bfloat16 both GEMMs then take the f32 GEMM's bf16-A mode
    (route 3's attention half, ``encoders/fast.py``)."""
    _check_chain_args(x, w, heads, mlp=False)
    b, n, d = x.shape
    dt = x.dtype
    mat = (lambda t: _mat(t, dt)) if cast else _f32
    x2 = x.contiguous().view(b * n, d)
    qkv = _gemm(x2, mat(w["attn.qkv.weight"]), _f32(w["attn.qkv.bias"]),
                EPI_BIAS, out_dtype=dt,
                ln=(_f32(w["norm1.weight"]), _f32(w["norm1.bias"])))
    o = _launch_packed(qkv.view(b, n, 3 * d), heads)
    ls = _f32(w["ls1.gamma"]) if "ls1.gamma" in w else None
    out = _gemm(o.view(b * n, d), mat(w["attn.proj.weight"]),
                _f32(w["attn.proj.bias"]), EPI_BIAS_LS_RES, ls=ls, res=x2,
                out_dtype=dt)
    return out.view(b, n, d)


def _layer_forward(x, w, heads):
    """B3's forward: the chain on CUDA, the JAX function's plain version on
    the CPU (:func:`_reference_layer`, or :func:`_unfused_layer` outside
    :func:`fits_vmem`)."""
    if x.device.type == "cuda":
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


def _attn_half_forward(x, w, heads):
    """B4's forward: the chain on CUDA, the JAX function's plain version on
    the CPU (:func:`_reference_attn_half`, or :func:`_unfused_attn_half`
    outside :func:`attn_half_fits`)."""
    if x.device.type == "cuda":
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


class _FusedBlock(torch.autograd.Function):
    """``forward(x, w, heads)`` (B3's or B4's) on x and the weight dict,
    whose tensors are passed one by one so that their gradients flow; the
    backward is autograd of ``grad_fn(x, w, heads)``, recomputed from the
    saved inputs. A weight that does not reach the output gets a zero
    gradient, as from JAX's vjp."""

    @staticmethod
    def forward(ctx, x, heads, forward, grad_fn, keys, *tensors):
        ctx.save_for_backward(x, *tensors)
        ctx.heads, ctx.grad_fn, ctx.keys = heads, grad_fn, keys
        return forward(x, dict(zip(keys, tensors)), heads)

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        need = [ctx.needs_input_grad[0], *ctx.needs_input_grad[5:]]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r)
                   for t, r in zip([x, *tensors], need)]
            out = ctx.grad_fn(ins[0], dict(zip(ctx.keys, ins[1:])), ctx.heads)
            grads = torch.autograd.grad(
                out, [t for t, r in zip(ins, need) if r], g,
                materialize_grads=True)
        it = iter(grads)
        gx, *gw = (next(it) if r else None for r in need)
        return (gx, None, None, None, None, *gw)


def _apply_block(x, w, heads, forward, grad_fn):
    keys = tuple(w)
    return _FusedBlock.apply(x, heads, forward, grad_fn, keys,
                             *(w[k] for k in keys))


def fused_vit_layer(x: torch.Tensor, w: dict, heads: int) -> torch.Tensor:
    """x ``[B, N, D]`` → ``[B, N, D]`` through one whole encoder layer
    (kernel B3). CUDA tensors launch the chain (and add one to
    ``fused_vit_layer.launches``) or raise: it takes float32, float16 and
    bfloat16 x at any N. CPU tensors take the JAX function's plain version:
    :func:`_reference_layer`, or :func:`_unfused_layer` for a layer outside
    :func:`fits_vmem`. Differentiable in x and every weight: the backward
    is autograd of :func:`_unfused_layer` (exact gelu), recomputed, as the
    JAX ``custom_vjp``'s."""
    return _apply_block(x, w, heads, _layer_forward, _unfused_layer)


fused_vit_layer.launches = 0


def fused_vit_attn_half(x: torch.Tensor, w: dict, heads: int) -> torch.Tensor:
    """x ``[B, N, D]`` → LN1 → qkv → MHA → proj (·ls1) → +x (kernel B4);
    the MLP half is the caller's. CUDA tensors launch the chain (and add one
    to ``fused_vit_attn_half.launches``) or raise. CPU tensors take the JAX
    function's plain version: :func:`_reference_attn_half`, or
    :func:`_unfused_attn_half` for a shape outside :func:`attn_half_fits`.
    Differentiable in x and every weight: the backward is autograd of
    :func:`_unfused_attn_half`, recomputed, as the JAX ``custom_vjp``'s."""
    return _apply_block(x, w, heads, _attn_half_forward, _unfused_attn_half)


fused_vit_attn_half.launches = 0
