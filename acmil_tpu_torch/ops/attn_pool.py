"""Fused gated-attention pooling: kernels B1 (forward) and B2 (backward) and
their plain PyTorch versions.

The port of ``acmil_tpu/ops/attn_pool.py``. For a padded bag of N patch
features the forward computes

    h  = relu(feats @ W1 + b1)                       (DimReduction)
    a  = (tanh(h V + bv) * sigmoid(h U + bu)) w + bw (gated attention, K branches)
    A  = softmax of a over N, pads excluded
    out[k] = sum_n A[k, n] h[n]                      (branch bag features)

:func:`fused_gated_attn_pool_batched` keeps the JAX function's contract and
layout: ``bag [B, K, L]``, raw logits ``[B, K, N]`` with ``NEG`` at pad
slots, and on request the softmax's max ``m`` and sum ``s`` ``[B, K]``.
:func:`fused_gated_attn_pool_bwd` is the one-pass backward given the
softmax couplings ``lse`` and ``c``, and :func:`gated_attn_pool_grad` joins
the two in a ``torch.autograd.Function``. :func:`gated_attn_pool_grad_one`
is the same pooling with CLAM_MB's softmax-one weights (a phantom logit at
0), on the same two kernels.

Every wrapper picks its route by the device of ``feats`` and nothing else: a
CPU tensor takes the plain version, a CUDA tensor launches the hand-written
kernel (``csrc/attn_pool.cu``, ``csrc/attn_pool_bwd.cu``, both on the H
stage of ``csrc/gated_h.cuh``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

NEG = -1e30

# the widths csrc/attn_pool.cu and csrc/attn_pool_bwd.cu are compiled for:
# one instantiation per L, every D_inner of config.PRETRAIN_DIMS
KERNEL_LS = (128, 256, 384, 512, 768)
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
    """Raise ValueError for any input kernels B1 and B2 do not take."""
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
    if l not in KERNEL_LS:
        raise ValueError(f"the kernel takes L a multiple of 128 up to 768, "
                         f"got L={l}")
    if a != KERNEL_A:
        raise ValueError(f"the kernel takes A = {KERNEL_A}, got A={a}")
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {KERNEL_MAX_K}, got {k}")
    shapes = {"w1": (w1, (df, l)), "b1": (b1, (l,)), "v": (v, (l, a)),
              "bv": (bv, (a,)), "u": (u, (l, a)), "bu": (bu, (a,)),
              "w": (w, (a, k)), "bw": (bw, (k,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _device_inputs(dev, tensors, kernel):
    """``tensors`` made contiguous, each checked to lie on ``dev`` and to
    start 16-byte aligned."""
    out = [t.contiguous() for t in tensors]
    for t in out:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"kernel {kernel} needs 16-byte-aligned inputs")
    return out


# the CUDA kernels one B1 call launches: the H stage of csrc/gated_h.cuh,
# which B2 shares (the norms of x's rows and W1's columns, H = relu(X W1 +
# b1), its recompute near 0), then csrc/attn_pool.cu's row kernel (gates,
# logits, each tile's softmax state and p^T H) and the flash merge
H_STAGE_KERNELS = ("gated_h_norms_kernel", "gated_h_kernel",
                   "gated_h_fix_kernel")
B1_KERNELS = H_STAGE_KERNELS + ("b1_row_kernel", "b1_merge_kernel")
# the H stage's output tiles are 128 x 128, and a tile lists at most 512
# near-0 pre-activations; B1's row kernel takes 64-row tiles of one bag
_H_TILE, _H_NEAR, _B1_TILE = 128, 512, 64
# each buffer of B1's workspace starts at a multiple of this many bytes
_ALIGN = 256


def _h_stage_buffers(m, l):
    """(name, dtype, shape) of the H stage's buffers for M rows at width L:
    the norms, H, the near-0 list and its counts per tile."""
    tiles = -(-m // _H_TILE) * (l // _H_TILE)
    return (("norms", torch.float32, (m + l,)),
            ("h", torch.float32, (m, l)),
            ("near", torch.int32, (tiles, _H_NEAR, 2)),
            ("near_counts", torch.int32, (tiles,)))


@functools.lru_cache(maxsize=64)
def _b1_workspace_layout(b, n, l, k):
    """((name, dtype, shape, byte offset), ...) of each buffer of B1's
    device workspace, and its total bytes: the H stage's buffers for the
    B N rows, then each (bag, 64-row tile)'s softmax max and sum [B, T, K]
    and partial bag [B, T, K, L]. Every buffer starts at a multiple of
    ``_ALIGN`` bytes."""
    t = -(-n // _B1_TILE)
    f32 = torch.float32
    buffers = _h_stage_buffers(b * n, l) + (
        ("part_m", f32, (b, t, k)), ("part_s", f32, (b, t, k)),
        ("part_acc", f32, (b, t, k, l)))
    layout, offset = [], 0
    for name, dtype, shape in buffers:
        layout.append((name, dtype, shape, offset))
        offset += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return tuple(layout), offset


@functools.cache
def _kernel_entry():
    """The C entry point with its ctypes signature, from the library built
    at first use."""
    from acmil_tpu_torch.ops import _build

    fn = _build.load("attn_pool").b1_attn_pool_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 21
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return fn


def _launch_kernel(feats, mask, w1, b1, v, bv, u, bu, w, bw, workspace=None):
    _check_kernel_args(feats, mask, w1, b1, v, bv, u, bu, w, bw)
    dev = feats.device
    # W1 transposed, for the H stage's recompute of near-0 pre-activations
    # in the forward's order
    x, mk, w1_, w1t, *weights = _device_inputs(
        dev, (feats, mask, w1, w1.t(), b1, v, bv, u, bu, w, bw), "B1")
    fn = _kernel_entry()
    b, n, df = feats.shape
    l, k = w1.shape[1], w.shape[1]
    layout, nbytes = _b1_workspace_layout(b, n, l, k)
    f32 = dict(device=dev, dtype=torch.float32)
    logits = torch.empty(b, k, n, **f32)
    bag = torch.empty(b, k, l, **f32)
    stats = torch.empty(2, b, k, **f32)
    work = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    base = work.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.float16), mk.data_ptr(),
                 w1_.data_ptr(), w1t.data_ptr(),
                 *(t.data_ptr() for t in weights), logits.data_ptr(),
                 bag.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 *(base + off for *_, off in layout), b, n, df, k, l, stream)
    if err != 0:
        raise RuntimeError(f"kernel B1 launch failed: cudaError_t {err}")
    fused_gated_attn_pool_batched.launches += 1
    if workspace is not None:
        workspace.update(_workspace_views(work, layout))
    return bag, logits, stats[0], stats[1]


def _workspace_views(work, layout):
    """{name: tensor} views of a uint8 workspace with this layout."""
    return {name: work[off:off + math.prod(shape) * dtype.itemsize]
            .view(dtype).view(shape) for name, dtype, shape, off in layout}


def _pool_forward(feats, mask, w1, b1, v, bv, u, bu, w, bw, workspace=None):
    """(bag, logits, m, s) by the route of ``feats``'s device. The plain
    route computes in the weights' dtype."""
    if feats.device.type == "cuda":
        return _launch_kernel(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                              workspace)
    if feats.device.type == "cpu":
        bag, logits = _reference_batched(feats.to(w1.dtype), mask, w1, b1, v,
                                         bv, u, bu, w, bw)
        return (bag, logits, *_softmax_stats(logits, mask))
    raise ValueError(f"no kernel B1 route for device {feats.device}")


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
    *,
    _workspace: dict = None,
) -> Tuple[torch.Tensor, ...]:
    """Batched fused pooling. Returns (bag_feats [B, K, L],
    attn_logits [B, K, N]); with ``return_stats`` also the softmax's max
    and sum ``[B, K]``, from which shards of one bag combine.

    CPU tensors take the plain version; CUDA tensors launch kernel B1 (and
    add one to ``fused_gated_attn_pool_batched.launches``) or raise. N needs
    no padding to any multiple: rows past N are masked in the kernel. This
    bare forward has no backward: differentiate :func:`gated_attn_pool_grad`.
    ``_workspace``, for tests and the smoke run, receives views of the
    kernel's device workspace by name (``"h"``: H [B N, L]); the plain
    route leaves it empty.
    """
    if (feats.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (feats, w1, b1, v, bv, u, bu,
                                              w, bw))):
        raise NotImplementedError(
            "fused_gated_attn_pool_batched has no backward: use "
            "gated_attn_pool_grad, whose backward is kernel B2")
    bag, logits, m, s = _pool_forward(feats, mask, w1, b1, v, bv, u, bu, w,
                                      bw, _workspace)
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


# ---------------------------------------------------------------------------
# Backward: kernel B2 and its plain closed form
# ---------------------------------------------------------------------------

def _fused_pool_bwd_stats(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                          lse, c, d_bag, d_logits, need_dx: bool = True):
    """Kernel B2's plain version: the pooling's backward in closed form, as
    the Pallas ``_bwd_kernel`` computes it, written out (not autograd).

    ``lse`` and ``c`` are per-(bag, branch) scalars ``[B, K]``: the
    softmax's log-normaliser and ``sum_l d_bag * bag``; with them one pass
    over the rows suffices. ``d_bag [B, K, L]``, ``d_logits [B, K, N]``.
    Rows that are masked get p = 0 and ignore their ``d_logits``. Computes
    in the weights' dtype. Returns (d_feats [B, N, Df] or None, dW1, db1,
    dV, dbv, dU, dbu, dw, dbw).
    """
    x = feats.to(w1.dtype)
    h = torch.relu(x @ w1 + b1)                              # [B, N, L]
    gv = torch.tanh(h @ v + bv)
    gu = torch.sigmoid(h @ u + bu)
    g = gv * gu                                              # [B, N, A]
    logits = g @ w + bw                                      # [B, N, K]
    valid = mask[..., None]                                  # [B, N, 1]
    p = torch.where(valid, torch.exp(logits - lse[:, None, :]), 0.0)
    d_p = h @ d_bag.transpose(1, 2)                          # [B, N, K]
    d_log = torch.where(valid, p * (d_p - c[:, None, :])
                        + d_logits.transpose(1, 2), 0.0)
    d_g = d_log @ w.T                                        # [B, N, A]
    d_av = d_g * gu * (1.0 - gv * gv)
    d_au = d_g * gv * gu * (1.0 - gu)
    d_h = p @ d_bag + d_av @ v.T + d_au @ u.T                # [B, N, L]
    r = torch.where(h > 0, d_h, 0.0)
    d_feats = (r @ w1.T).to(feats.dtype) if need_dx else None

    def ct(a, b):                                            # sum_b a_b^T b_b
        return torch.einsum("bni,bnj->ij", a, b)

    return (d_feats, ct(x, r), r.sum(dim=(0, 1)), ct(h, d_av),
            d_av.sum(dim=(0, 1)), ct(h, d_au), d_au.sum(dim=(0, 1)),
            ct(g, d_log), d_log.sum(dim=(0, 1)))


def _check_bwd_args(feats, k, l, lse, c, d_bag, d_logits) -> None:
    b, n, _ = feats.shape
    shapes = {"lse": (lse, (b, k)), "c": (c, (b, k)),
              "d_bag": (d_bag, (b, k, l)),
              "d_logits": (d_logits, (b, k, n))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


# the CUDA kernels one B2 call launches: the H stage (B1's; K1 with its
# panels' parts of H d_bag^T), then csrc/attn_pool_bwd.cu's K2 the row
# kernel, K3 the weight gradients, the ordered reduction and, when dx is
# asked for, K4
B2_KERNELS = H_STAGE_KERNELS + ("b2_row_kernel", "b2_wgrad_kernel",
                                "b2_reduce_kernel", "b2_dx_kernel")
# K3's output tiles are the H stage's, and its row ranges are whole 32-row
# slices
_B2_TILE, _B2_SLICE = _H_TILE, 32


@functools.cache
def _bwd_kernel_entry():
    """(the launch entry with its ctypes signature, the row kernel's
    blocks-per-grid query, its rows-per-tile query of an L), from the
    library built at first use."""
    from acmil_tpu_torch.ops import _build

    lib = _build.load("attn_pool_bwd")
    fn = lib.b2_attn_pool_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 25
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    blocks = lib.b2_max_blocks
    blocks.restype = ctypes.c_int
    blocks.argtypes = [ctypes.c_int] * 2
    lib.b2_tile_rows.restype = ctypes.c_int
    lib.b2_tile_rows.argtypes = [ctypes.c_int]
    return fn, blocks, lib.b2_tile_rows


def _grad_layout(df, l, k):
    """(name, shape) of each gradient in B2's flat buffer, in order: K3's
    sums (dW1, dV, dU), then the row kernel's."""
    a = KERNEL_A
    return (("dW1", (df, l)), ("dV", (l, a)), ("dU", (l, a)), ("db1", (l,)),
            ("dbv", (a,)), ("dbu", (a,)), ("dw", (a, k)), ("dbw", (k,)))


def _wgrad_splits(m, df, l, sms):
    """(S, rows): K3 sums its M rows in S contiguous ranges of ``rows`` rows
    (a multiple of 32; the last range may be shorter), one block per
    (output tile, range). S is the one that best fills the ``sms``
    multiprocessors' waves (the least of equals), with ranges of at least
    512 rows and at most 64 MB of partial sums."""
    tiles = -(-df // _B2_TILE) * (l // _B2_TILE) + 2 * (l // _B2_TILE)

    def fill(s):
        return tiles * s / (-(-tiles * s // sms) * sms)

    most = min(64, m // 512, (64 << 20) // (4 * (df * l + 2 * l * KERNEL_A)))
    s = max(range(1, max(1, most) + 1), key=lambda s: (round(fill(s), 3), -s))
    rows = -(-(-(-m // s)) // _B2_SLICE) * _B2_SLICE
    return -(-m // rows), rows


def _launch_bwd_kernel(feats, mask, w1, b1, v, bv, u, bu, w, bw, lse, c,
                       d_bag, d_logits, need_dx, workspace=None):
    _check_kernel_args(feats, mask, w1, b1, v, bv, u, bu, w, bw)
    b, n, df = feats.shape
    l, k = w1.shape[1], w.shape[1]
    _check_bwd_args(feats, k, l, lse, c, d_bag, d_logits)
    dev = feats.device
    # [V | U] as one [L, 2A] matrix: the row kernel's gate and d_h products
    # read it whole
    # W1 transposed, for K1's recompute of near-0 pre-activations in the
    # forward's order
    x, mk, w1_, w1t, b1_, vu, bv_, bu_, w_, bw_, lse_, c_, d_bag_, \
        d_logits_ = _device_inputs(
            dev, (feats, mask, w1, w1.t(), b1, torch.cat([v, u], dim=1), bv,
                  bu, w, bw, lse, c, d_bag, d_logits), "B2")
    # d_bag^T [B, L, Kp], zero past K: the second operand of the d_h
    # product, whose first is [D_a | p]
    kp = -(-k // 4) * 4
    d_bag_t = torch.zeros(b, l, kp, device=dev, dtype=torch.float32)
    d_bag_t[:, :, :k] = d_bag_.transpose(1, 2)
    fn, max_blocks, tile_rows = _bwd_kernel_entry()
    layout = _grad_layout(df, l, k)
    a = KERNEL_A
    with torch.cuda.device(dev):
        resident = max_blocks(k, l)
        if resident <= 0:
            raise RuntimeError(f"kernel B2 occupancy query failed: "
                               f"cudaError_t {-resident}")
        groups = min(resident, b * -(-n // tile_rows(l)))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, rows = _wgrad_splits(b * n, df, l, sms)
        f32 = dict(device=dev, dtype=torch.float32)
        norms, h, near, near_counts = (
            torch.empty(shape, device=dev, dtype=dtype)
            for _, dtype, shape in _h_stage_buffers(b * n, l))
        dp_part = torch.empty(l // _B2_TILE, b * n, k, **f32)
        r = torch.empty(b * n, l, **f32)
        d_a = torch.empty(b * n, 2 * a + kp, **f32)
        part_w = torch.empty(splits, df * l + 2 * l * a, **f32)
        part_r = torch.empty(groups, l + 2 * a + a * k + k, **f32)
        grads = torch.empty(sum(math.prod(s) for _, s in layout), **f32)
        dx = torch.empty_like(x) if need_dx else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.float16), mk.data_ptr(),
                 *(t.data_ptr() for t in (w1_, w1t, b1_, vu, bv_, bu_, w_,
                                          bw_, lse_, c_, d_bag_, d_bag_t,
                                          d_logits_)),
                 dx.data_ptr() if need_dx else None,
                 *(t.data_ptr() for t in (norms, h, near, near_counts,
                                          dp_part, r, d_a, part_w, part_r,
                                          grads)),
                 b, n, df, k, l, groups, splits, rows, stream)
    if err != 0:
        raise RuntimeError(f"kernel B2 launch failed: cudaError_t {err}")
    fused_gated_attn_pool_bwd.launches += 1
    if workspace is not None:
        workspace["h"] = h
    parts = torch.split(grads, [math.prod(s) for _, s in layout])
    g = {name: p.view(s) for (name, s), p in zip(layout, parts)}
    return (dx, *(g[name] for name in ("dW1", "db1", "dV", "dbv", "dU", "dbu",
                                       "dw", "dbw")))


def fused_gated_attn_pool_bwd(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                              lse, c, d_bag, d_logits, need_dx: bool = True,
                              *, _workspace: dict = None):
    """The pooling's backward given the softmax couplings ``lse`` and ``c``
    ``[B, K]`` (see :func:`_fused_pool_bwd_stats`). Returns (d_feats in
    feats' dtype or None, dW1, db1, dV, dbv, dU, dbu, dw, dbw); the weight
    gradients are float32.

    CPU tensors take the plain closed form; CUDA tensors launch kernel B2
    (and add one to ``fused_gated_attn_pool_bwd.launches``) or raise.
    ``_workspace``, for tests and the smoke run, receives B2's H [B N, L]
    as ``"h"``; the plain route leaves it empty.
    """
    if feats.device.type == "cuda":
        return _launch_bwd_kernel(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                                  lse, c, d_bag, d_logits, need_dx,
                                  _workspace)
    if feats.device.type == "cpu":
        return _fused_pool_bwd_stats(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                                     lse, c, d_bag, d_logits, need_dx)
    raise ValueError(f"no kernel B2 route for device {feats.device}")


fused_gated_attn_pool_bwd.launches = 0


def _fused_pool_bwd(feats, mask, w1, b1, v, bv, u, bu, w, bw, bag, logits,
                    d_bag, d_logits, need_dx: bool = True):
    """The backward from the forward's outputs: forms ``lse`` (one
    logsumexp over ``[B, K, N]``) and ``c = sum_l d_bag * bag``, then runs
    :func:`fused_gated_attn_pool_bwd`."""
    lse = torch.logsumexp(torch.where(mask[:, None, :], logits, NEG), dim=2)
    c = (d_bag * bag).sum(dim=2)
    return fused_gated_attn_pool_bwd(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                                     lse, c, d_bag, d_logits, need_dx)


class _GatedAttnPoolGrad(torch.autograd.Function):
    """Forward through B1 (the plain forward on the CPU), backward through
    B2 (the plain closed form on the CPU)."""

    @staticmethod
    def forward(ctx, feats, mask, w1, b1, v, bv, u, bu, w, bw):
        bag, logits, m, s = _pool_forward(feats, mask, w1, b1, v, bv, u, bu,
                                          w, bw)
        # the log-normaliser from the online softmax's own (m, s), as the
        # JAX sharded path forms it; an all-masked bag has s = 0, and the
        # clamp keeps its lse finite (its rows take p = 0 by a select)
        lse = m + torch.log(torch.clamp_min(s, 1e-30))
        ctx.save_for_backward(feats, mask, w1, b1, v, bv, u, bu, w, bw, lse,
                              bag)
        return bag, logits

    @staticmethod
    def backward(ctx, d_bag, d_logits):
        feats, mask, w1, b1, v, bv, u, bu, w, bw, lse, bag = ctx.saved_tensors
        d_bag = d_bag.to(lse.dtype)
        c = (d_bag * bag).sum(dim=2)
        grads = fused_gated_attn_pool_bwd(
            feats, mask, w1, b1, v, bv, u, bu, w, bw, lse, c, d_bag,
            d_logits.to(lse.dtype), need_dx=ctx.needs_input_grad[0])
        d_feats, *d_weights = grads
        d_weights = [g.to(t.dtype) for g, t in
                     zip(d_weights, (w1, b1, v, bv, u, bu, w, bw))]
        return (None if d_feats is None else d_feats.to(feats.dtype), None,
                *d_weights)


def gated_attn_pool_grad(feats, mask, w1, b1, v, bv, u, bu, w, bw
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused pooling: (bag [B, K, L], logits [B, K, N]) as
    :func:`fused_gated_attn_pool_batched` gives them, with a backward that
    makes one pass over ``feats`` (kernel B2 on CUDA tensors). Gradients
    reach the weights always and ``feats`` only when it requires one."""
    return _GatedAttnPoolGrad.apply(feats, mask, w1, b1, v, bv, u, bu, w, bw)


# ---------------------------------------------------------------------------
# Softmax-one pooling (CLAM_MB) on the same kernels
# ---------------------------------------------------------------------------

def gated_attn_pool_one_reference(feats, mask, w1, b1, v, bv, u, bu, w, bw):
    """Plain PyTorch softmax-one pooling on :func:`_reference_batched`'s H:
    weights ``exp(a_n) / (1 + sum_m exp(a_m))`` over the valid rows (a
    phantom logit pinned at 0, `utils/utils.py:54`). Returns (bag
    [B, K, L], logits [B, K, N] with ``NEG`` at pad slots); differentiable
    by autograd. Computes in the weights' dtype."""
    h = torch.relu(feats.to(w1.dtype) @ w1 + b1)             # [B, N, L]
    logits = (torch.tanh(h @ v + bv) * torch.sigmoid(h @ u + bu)) @ w + bw
    a = torch.where(mask[..., None], logits, NEG).transpose(1, 2)
    # stabilised at m = max(max a, 0), so the phantom logit is in the max
    m = a.amax(dim=-1, keepdim=True).clamp_min(0.0).detach()
    ex = torch.exp(a - m) * mask[:, None, :]
    p = ex / (ex.sum(dim=-1, keepdim=True) + torch.exp(-m))
    return p @ h, a


class _GatedAttnPoolGradOne(torch.autograd.Function):
    """Softmax-one pooling. Forward: B1 with its online-softmax stats, the
    plain softmax's bag rescaled by ``s / (s + exp(-m))`` (on the CPU, the
    plain twin). Backward: B2 (its plain closed form on the CPU) under the
    phantom-augmented log-normaliser ``lse₁ = logaddexp(0, lse)``; the
    softmax-one Jacobian has the softmax's ``p (d_p - c)`` form, with ``c``
    formed on the softmax-one bag."""

    @staticmethod
    def forward(ctx, feats, mask, w1, b1, v, bv, u, bu, w, bw):
        if feats.device.type == "cpu":
            bag, logits = gated_attn_pool_one_reference(
                feats, mask, w1, b1, v, bv, u, bu, w, bw)
        else:
            bag, logits, m, s = _pool_forward(feats, mask, w1, b1, v, bv, u,
                                              bu, w, bw)
            # acc / s is the plain bag; softmax-one divides acc by
            # s + exp(0 - m). An all-masked bag has s = 0: scale 0, not NaN
            bag = bag * (s / torch.clamp_min(s + torch.exp(-m), 1e-30)
                         )[..., None]
        ctx.save_for_backward(feats, mask, w1, b1, v, bv, u, bu, w, bw, bag,
                              logits)
        return bag, logits

    @staticmethod
    def backward(ctx, d_bag, d_logits):
        feats, mask, w1, b1, v, bv, u, bu, w, bw, bag, logits = \
            ctx.saved_tensors
        d_bag = d_bag.to(bag.dtype)
        lse = torch.logsumexp(torch.where(mask[:, None, :], logits, NEG),
                              dim=2)                          # [B, K]
        lse_one = torch.logaddexp(torch.zeros_like(lse), lse)
        c = (d_bag * bag).sum(dim=2)
        d_feats, *d_weights = fused_gated_attn_pool_bwd(
            feats, mask, w1, b1, v, bv, u, bu, w, bw, lse_one, c, d_bag,
            d_logits.to(bag.dtype), need_dx=ctx.needs_input_grad[0])
        d_weights = [g.to(t.dtype) for g, t in
                     zip(d_weights, (w1, b1, v, bv, u, bu, w, bw))]
        return (None if d_feats is None else d_feats.to(feats.dtype), None,
                *d_weights)


def gated_attn_pool_grad_one(feats, mask, w1, b1, v, bv, u, bu, w, bw
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gated_attn_pool_grad` with softmax-one normalisation (CLAM_MB,
    `architecture/clam.py:248`): (bag [B, K, L], logits [B, K, N] with
    ``NEG`` at pad slots). On CUDA tensors the forward is kernel B1 and the
    backward kernel B2, each counted by its wrapper; CPU tensors take
    :func:`gated_attn_pool_one_reference` forward and B2's plain closed form
    backward."""
    return _GatedAttnPoolGradOne.apply(feats, mask, w1, b1, v, bv, u, bu, w,
                                       bw)


# ---------------------------------------------------------------------------
# Sequence-sharded pooling: B1 and B2 on each rank's slice, a flash merge
# ---------------------------------------------------------------------------

def _merge_seq(bag, m, s, group):
    """The flash merge of per-rank (bag, m, s) across ``group``
    (``_sharded_pool_fwd_impl``): ``m* = pmax(m)``, ``w = s e^(m - m*)``,
    bag = psum(bag w) / psum(w), lse = m* + log psum(w). A slice with no
    valid row has s = 0 and bag 0, so it adds w = 0 and nothing else."""
    from acmil_tpu_torch.parallel import collectives as C

    m_star = C.pmax(m, group)
    wgt = s * torch.exp(m - m_star)                         # [B, K]
    # one collective for the weighted bags and the weights together
    acc = C.all_reduce_(torch.cat([bag * wgt[..., None], wgt[..., None]],
                                  dim=-1), group)
    denom = acc[..., -1]
    bag_g = acc[..., :-1] / torch.clamp_min(denom[..., None], 1e-12)
    lse = m_star + torch.log(torch.clamp_min(denom, 1e-30))
    return bag_g, lse


class _ShardedGatedAttnPoolGrad(torch.autograd.Function):
    """Forward: B1 on this rank's slice with its stats, then the merge over
    the seq group. Backward: B2 on the slice under the global ``lse`` and
    ``c``; the weight gradients summed over the seq group, the features'
    gradient local."""

    @staticmethod
    def forward(ctx, feats, mask, group, w1, b1, v, bv, u, bu, w, bw):
        bag, logits, m, s = _pool_forward(feats, mask, w1, b1, v, bv, u, bu,
                                          w, bw)
        bag, lse = _merge_seq(bag, m, s, group)
        ctx.group = group
        ctx.save_for_backward(feats, mask, w1, b1, v, bv, u, bu, w, bw, lse,
                              bag)
        return bag, logits

    @staticmethod
    def backward(ctx, d_bag, d_logits):
        from acmil_tpu_torch.parallel import collectives as C

        feats, mask, w1, b1, v, bv, u, bu, w, bw, lse, bag = ctx.saved_tensors
        d_bag = d_bag.to(lse.dtype)
        c = (d_bag * bag).sum(dim=2)                        # [B, K], global
        d_feats, *d_weights = fused_gated_attn_pool_bwd(
            feats, mask, w1, b1, v, bv, u, bu, w, bw, lse, c, d_bag,
            d_logits.to(lse.dtype), need_dx=ctx.needs_input_grad[0])
        # the weights' gradients of this slice's rows, summed in one
        # collective
        sizes = [g.numel() for g in d_weights]
        flat = C.all_reduce_(torch.cat([g.reshape(-1) for g in d_weights]),
                             ctx.group)
        d_weights = [g.view(t.shape).to(t.dtype) for g, t in
                     zip(flat.split(sizes), (w1, b1, v, bv, u, bu, w, bw))]
        return (None if d_feats is None else d_feats.to(feats.dtype), None,
                None, *d_weights)


def sharded_gated_attn_pool_grad(feats, mask, w1, b1, v, bv, u, bu, w, bw,
                                 group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable pooling of a bag whose patch axis is split over the
    ranks of ``group`` (the mesh's seq group; None for one rank), the port
    of ``sharded_gated_attn_pool_grad``. ``feats [B, n, Df]`` and
    ``mask [B, n]`` are this rank's contiguous slice of N.

    Returns (bag [B, K, L], the same on every rank of the group, the global
    softmax's pooling; logits [B, K, n] of this rank's slice). Each rank
    runs kernel B1 on its slice (its plain version on the CPU) and the
    flash merge joins them; the backward runs kernel B2 on the slice with
    the global log-normaliser, so the result equals the one-process pooling
    up to f32 summation order. Gradients reach the weights (summed over the
    group) always and ``feats`` (local) when it requires one."""
    return _ShardedGatedAttnPoolGrad.apply(feats, mask, group, w1, b1, v,
                                           bv, u, bu, w, bw)


def sharded_gated_attn_pool(feats, mask, w1, b1, v, bv, u, bu, w, bw, group
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of :func:`sharded_gated_attn_pool_grad` alone, for
    inference: (bag [B, K, L], this slice's logits [B, K, n])."""
    with torch.no_grad():
        bag, logits, m, s = _pool_forward(feats, mask, w1, b1, v, bv, u, bu,
                                          w, bw)
        bag, _ = _merge_seq(bag, m, s, group)
    return bag, logits
