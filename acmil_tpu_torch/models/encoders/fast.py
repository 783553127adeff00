"""The inference path of a ViT trunk over kernels B3, B4 and B5', the port
of ``acmil_tpu/models/encoders/fast.py``.

:func:`vit_encode` runs patch embed → ``depth`` encoder layers → final
layernorm over the state dict of :class:`~acmil_tpu_torch.models.encoders.
vit.ViT`, taking per trunk the route the JAX package takes, decided by the
same predicates (``ops/vit_layer.py``):

1. whole layer, kernel B3 (``fused_vit_layer``): plain gelu, no layerscale,
   and :func:`fits_vmem`, which is the ViT-S/16 class;
2. attention half, kernel B4 (``fused_vit_attn_half``), then the MLP half:
   :func:`attn_half_fits` (ViT-B/16, UNI ViT-L/16, ViT-S/8);
3. packed MHA, kernel B5' inside :func:`_xla_attn_half`, then the MLP half
   (CLIP-L/336, GigaPath ViT-G/16).

The MLP half, and route 3's qkv and proj, multiply by the f32 matrices (the
param tree's dtype), as XLA runs them in the JAX package. :func:`mlp_route`
picks, per block, the fused MLP half (:func:`fused_mlp_half`: fc1 and fc2
on the f32 GEMM's bf16-A mode, ``csrc/vit_gemm_f32.cu``, with the LayerNorm
prologue and the gelu, SwiGLU and layerscale-residual epilogues) for a
bf16 trunk with gelu or SwiGLU, and the plain products of :func:`_mlp_half`
for every other trunk. :func:`attn_route` likewise picks route 3's fused
attention half (:func:`fused_packed_attn_half`: qkv and proj on the same
GEMM mode around B5') for a bf16 trunk, and the plain products of
:func:`_unfused_attn_half` otherwise. ``fused=False`` takes every route
through the kernels' plain versions on any device. :func:`vit_route` alone
chooses the route; :func:`cast_kernel_weights` casts the matrices of that
route's kernel once, where a caller keeps the parameters for many batches.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from acmil_tpu_torch.models.encoders.vit import mlp_act
from acmil_tpu_torch.ops.vit_attn_packed import (_mm, _reference_packed,
                                                 fused_mha_packed)
from acmil_tpu_torch.ops.vit_layer import (EPI_BIAS_GELU, EPI_BIAS_LS_RES,
                                           EPI_BIAS_SWIGLU, GEMM_K_MULTIPLE,
                                           SWIGLU_TILE, _apply_block, _f32,
                                           _gemm, _launch_attn_half, _ln_f32,
                                           _reference_attn_half,
                                           _reference_layer,
                                           _unfused_attn_half,
                                           attn_half_fits, fits_vmem,
                                           fused_vit_attn_half,
                                           fused_vit_layer)
from acmil_tpu_torch.utils import profiling

# the block matrices each route's kernel chain reads (and casts to x's dtype)
_KERNEL_MATRICES = {
    "layer": ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"),
    "half": ("attn.qkv", "attn.proj"),
    "packed": (),
}
# the block weights the MLP half and the attention half read
_MLP_HALF_KEYS = ("norm2.", "mlp.", "ls2.")
_ATTN_HALF_KEYS = ("norm1.", "attn.", "ls1.")


def block_weights(params: dict, i: int) -> dict:
    """Block ``i``'s entries of a ViT state dict, without the
    ``blocks.{i}.`` prefix: the layer-weight dict of ``ops/vit_layer.py``."""
    prefix = f"blocks.{i}."
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _mlp_half(x, bp, act: str):
    """LN2 → fc1 → act → fc2 (·ls2) → +x as plain products on the f32
    weights. bf16 callers get tanh-approximate gelu, f32 callers exact
    gelu, as in the JAX package."""
    f32 = torch.float32
    xf = x.to(f32)
    y = _ln_f32(xf, bp["norm2.weight"], bp["norm2.bias"]).to(x.dtype)
    h = _mm(y, bp["mlp.fc1.weight"].t()) + bp["mlp.fc1.bias"]
    h = mlp_act(h, act, approx_gelu=x.dtype == torch.bfloat16).to(x.dtype)
    h = _mm(h, bp["mlp.fc2.weight"].t()) + bp["mlp.fc2.bias"]
    h = h.to(f32)
    if "ls2.gamma" in bp:
        h = h * bp["ls2.gamma"]
    return (xf + h).to(x.dtype)


def mlp_route(bp: dict, dtype: torch.dtype, act: str,
              fused: bool = True) -> str:
    """The route of a block's MLP half: ``"fused"`` (:func:`fused_mlp_half`)
    for a bf16 trunk with gelu (tanh-approximate at bf16, which is the
    GEMM's gelu epilogue) or SwiGLU (its SwiGLU epilogue, at an fc1 width of
    whole 128-column tiles) whose fc1 and fc2 are f32 with widths the GEMM
    takes; ``"plain"`` (:func:`_mlp_half`) for everything else: fp16
    (exact gelu) and f32 trunks, ``quick_gelu``, and ``fused=False``."""
    fc1, fc2 = bp["mlp.fc1.weight"], bp["mlp.fc2.weight"]
    if (fused and dtype == torch.bfloat16
            and (act == "gelu" or (act == "swiglu"
                                   and fc1.shape[0] % SWIGLU_TILE == 0))
            and fc1.dtype == fc2.dtype == torch.float32
            and fc1.shape[1] % GEMM_K_MULTIPLE == 0
            and fc2.shape[1] % GEMM_K_MULTIPLE == 0):
        return "fused"
    return "plain"


def _launch_mlp_half(x, bp, act):
    """The fused MLP half on CUDA, two GEMMs in the bf16-A mode of
    ``csrc/vit_gemm_f32.cu`` on the f32 matrices as they are: LN2 (the
    prologue, bf16 rows) → fc1 → gelu (epilogue 1) or SwiGLU (epilogue 4,
    half width), bf16 out, then fc2 → x + (· + b2)·ls2 (epilogue 3 with or
    without ls, bf16 out): the rounding points of :func:`_mlp_half`."""
    b, n, d = x.shape
    x2 = x.contiguous().view(b * n, d)
    h = _gemm(x2, _f32(bp["mlp.fc1.weight"]), _f32(bp["mlp.fc1.bias"]),
              EPI_BIAS_SWIGLU if act == "swiglu" else EPI_BIAS_GELU,
              out_dtype=x.dtype,
              ln=(_f32(bp["norm2.weight"]), _f32(bp["norm2.bias"])))
    ls = _f32(bp["ls2.gamma"]) if "ls2.gamma" in bp else None
    out = _gemm(h, _f32(bp["mlp.fc2.weight"]), _f32(bp["mlp.fc2.bias"]),
                EPI_BIAS_LS_RES, ls=ls, res=x2, out_dtype=x.dtype)
    return out.view(b, n, d)


def _mlp_half_forward(x, bp, act):
    """The fused MLP half's forward: the GEMMs on CUDA, :func:`_mlp_half`
    with the block's ``act`` on the CPU."""
    if x.device.type == "cuda":
        return _launch_mlp_half(x, bp, act)
    if x.device.type == "cpu":
        return _mlp_half(x, bp, act)
    raise ValueError(f"no fused MLP half route for device {x.device}")


def fused_mlp_half(x: torch.Tensor, bp: dict,
                   act: str = "gelu") -> torch.Tensor:
    """LN2 → fc1 → ``act`` (gelu or swiglu) → fc2 (·ls2) → +x of a bf16
    trunk (:func:`mlp_route`). CUDA tensors launch the two GEMMs (each adds
    one to ``_gemm.launches["bf16a"]``) or raise; CPU tensors take
    :func:`_mlp_half`. Differentiable in x and every weight: the backward is
    autograd of :func:`_mlp_half`, recomputed."""
    w = {k: v for k, v in bp.items() if k.startswith(_MLP_HALF_KEYS)}
    return _apply_block(x, w, 0, lambda x, w, heads: _mlp_half_forward(
        x, w, act), lambda x, w, heads: _mlp_half(x, w, act))


def attn_route(bp: dict, dtype: torch.dtype, fused: bool = True) -> str:
    """The route of route 3's attention half: ``"fused"``
    (:func:`fused_packed_attn_half`) for a bf16 trunk whose qkv and proj
    are f32 at a width the GEMM takes; ``"plain"`` (:func:`_xla_attn_half`'s
    products) for fp16 and f32 trunks, other matrices and ``fused=False``."""
    qkv, proj = bp["attn.qkv.weight"], bp["attn.proj.weight"]
    if (fused and dtype == torch.bfloat16
            and qkv.dtype == proj.dtype == torch.float32
            and qkv.shape[1] % GEMM_K_MULTIPLE == 0):
        return "fused"
    return "plain"


def _xla_attn_half(x, bp, heads: int, fused: bool = True):
    """LN1 → qkv → packed MHA (kernel B5') → proj (·ls1) → +x as plain
    products on the f32 matrices: the route for trunks outside
    :func:`attn_half_fits`."""
    return _unfused_attn_half(x, bp, heads, mha=fused_mha_packed if fused
                              else _reference_packed)


def _packed_attn_half_forward(x, bp, heads):
    """The fused attention half's forward: B4's chain on the f32 matrices
    on CUDA, :func:`_xla_attn_half` on the CPU."""
    if x.device.type == "cuda":
        return _launch_attn_half(x, bp, heads, cast=False)
    if x.device.type == "cpu":
        return _xla_attn_half(x, bp, heads)
    raise ValueError(f"no fused attention half route for device {x.device}")


def fused_packed_attn_half(x: torch.Tensor, bp: dict,
                           heads: int) -> torch.Tensor:
    """Route 3's attention half of a bf16 trunk (:func:`attn_route`): LN1 →
    qkv → B5' → proj (·ls1) → +x. CUDA tensors launch qkv (LN1 prologue,
    bias, bf16 out) and proj (the layerscale residual) on the f32 GEMM's
    bf16-A mode around kernel B5' (each GEMM adds one to
    ``_gemm.launches["bf16a"]``), the rounding points of
    :func:`_xla_attn_half`, or raise; CPU tensors take
    :func:`_xla_attn_half`. Differentiable in x and every weight: the
    backward is autograd of :func:`_xla_attn_half`, recomputed."""
    w = {k: v for k, v in bp.items() if k.startswith(_ATTN_HALF_KEYS)}
    return _apply_block(x, w, heads, _packed_attn_half_forward,
                        lambda x, w, heads: _xla_attn_half(x, w, heads))


def vit_route(params: dict, n_tok: int, heads: int, dtype: torch.dtype,
              act: str = "gelu") -> str:
    """The route ``vit_encode`` takes for a trunk: ``"layer"`` (kernel B3),
    ``"half"`` (B4) or ``"packed"`` (B5'), by the JAX package's predicates
    at ``n_tok`` tokens padded to 16."""
    dim = params["patch_embed.proj.weight"].shape[0]
    n_pad = (n_tok + 15) // 16 * 16
    hidden = params["blocks.0.mlp.fc1.weight"].shape[0]
    if (act == "gelu" and "blocks.0.ls1.gamma" not in params
            and fits_vmem(dim, hidden, n_pad, heads)):
        return "layer"
    bytes_per_el = torch.tensor([], dtype=dtype).element_size()
    if attn_half_fits(dim, n_pad, heads, g=1, bytes_per_el=bytes_per_el):
        return "half"
    return "packed"


def cast_kernel_weights(params: dict, *, n_tok: int, heads: int,
                        dtype: torch.dtype, act: str = "gelu") -> dict:
    """``params`` with the block matrices that the route's kernel chain
    reads cast to ``dtype`` once. The chains and their plain versions cast
    those matrices to x's dtype on every call, so the result of
    :func:`vit_encode` is the same; the casts leave the per-batch path. The
    MLP half of routes 2 and 3 keeps its f32 matrices, which both of its
    routes multiply by (:func:`mlp_route`)."""
    names = _KERNEL_MATRICES[vit_route(params, n_tok, heads, dtype, act)]

    def cast(key):
        parts = key.split(".")
        return (parts[0] == "blocks" and parts[-1] == "weight"
                and ".".join(parts[2:-1]) in names)

    return {k: v.to(dtype) if cast(k) else v for k, v in params.items()}


def conv_precision(dtype: torch.dtype):
    """A context in which a convolution in ``dtype`` keeps that dtype's
    precision on the card: at float32 cuDNN's TF32 is off (by default it
    rounds f32 operands to TF32; the JAX package computes them in f32),
    every other cuDNN setting as it was. A no-op at other dtypes."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


def vit_embed(params: dict, images: torch.Tensor, *, patch: int,
              dtype: torch.dtype, pre_norm: bool = False) -> torch.Tensor:
    """images ``[B, H, W, 3]`` normalised → tokens ``[B, 1 + P, D]`` in
    ``dtype``: the patch embed (a convolution in ``dtype``: on the CPU a
    bf16 convolution is computed in f32 and rounded, on the card an f32 one
    without TF32), the cls token, the position embedding and, with
    ``pre_norm``, ``norm_pre``."""
    b = images.shape[0]
    kernel = params["patch_embed.proj.weight"].to(dtype)      # [D, 3, p, p]
    x = images.to(dtype).permute(0, 3, 1, 2)
    if x.device.type == "cpu":
        x = F.conv2d(x.float(), kernel.float(), stride=patch).to(dtype)
    else:
        with conv_precision(dtype):
            x = F.conv2d(x, kernel, stride=patch)
    x = x + params["patch_embed.proj.bias"].to(dtype)[:, None, None]
    dim = x.shape[1]
    x = x.flatten(2).transpose(1, 2)                          # [B, P, D]
    cls = params["cls_token"].to(dtype).expand(b, 1, dim)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dtype)
    if pre_norm:
        x = _ln_f32(x.float(), params["norm_pre.weight"],
                    params["norm_pre.bias"]).to(dtype)
    return x


def vit_head(params: dict, x: torch.Tensor, proj_dim=None) -> torch.Tensor:
    """Tokens ``[B, 1 + P, D]`` → the cls feature ``[B, D or proj_dim]`` in
    x's dtype: the final layernorm (f32 statistics) and, for CLIP,
    ``proj_out``."""
    xn = _ln_f32(x.float(), params["norm.weight"], params["norm.bias"])
    feat = xn[:, 0].to(x.dtype)
    if proj_dim:
        feat = _mm(feat, params["proj_out.weight"].to(x.dtype).t())
    return feat


def vit_encode(params: dict, images: torch.Tensor, *, patch: int, depth: int,
               heads: int, dtype: torch.dtype = torch.bfloat16,
               act: str = "gelu", pre_norm: bool = False, proj_dim=None,
               fused: bool = True) -> torch.Tensor:
    """images ``[B, H, W, 3]`` normalised → cls features ``[B, D or
    proj_dim]`` in ``dtype``.

    ``params``: a :class:`ViT` state dict (timm names), on the images'
    device.

    Device-timed spans (``utils/profiling.py``) name its parts:
    ``vit.embed``, then per block ``vit.layer`` on the whole-layer route or
    ``vit.attn_half`` and ``vit.mlp_half`` on the others, and ``vit.head``;
    the counters ``vit.mlp_half.fused`` and ``vit.mlp_half.plain`` count
    each MLP half by its route (:func:`mlp_route`), ``vit.mlp_half.swiglu``
    the fused ones with SwiGLU besides, and ``vit.attn_half.fused`` and
    ``vit.attn_half.plain`` each attention half of route 3 by its route
    (:func:`attn_route`).
    """
    with profiling.span("vit.embed", device=True):
        x = vit_embed(params, images, patch=patch, dtype=dtype,
                      pre_norm=pre_norm)
    route = vit_route(params, x.shape[1], heads, dtype, act)
    for i in range(depth):
        bp = block_weights(params, i)
        if route == "layer":
            with profiling.span("vit.layer", device=True):
                x = (fused_vit_layer if fused else _reference_layer)(
                    x, bp, heads)
            continue
        with profiling.span("vit.attn_half", device=True):
            if route == "half":
                x = (fused_vit_attn_half if fused else _reference_attn_half)(
                    x, bp, heads)
            else:
                attn = attn_route(bp, x.dtype, fused)
                profiling.count(f"vit.attn_half.{attn}")
                x = (fused_packed_attn_half(x, bp, heads) if attn == "fused"
                     else _xla_attn_half(x, bp, heads, fused))
        with profiling.span("vit.mlp_half", device=True):
            mlp = mlp_route(bp, x.dtype, act, fused)
            profiling.count(f"vit.mlp_half.{mlp}")
            if mlp == "fused" and act == "swiglu":
                profiling.count("vit.mlp_half.swiglu")
            x = fused_mlp_half(x, bp, act) if mlp == "fused" else _mlp_half(
                x, bp, act)
    with profiling.span("vit.head", device=True):
        return vit_head(params, x, proj_dim)
