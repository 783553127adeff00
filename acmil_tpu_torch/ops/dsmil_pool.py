"""Fused DSMIL bag-stream pooling: kernel B6 and its plain PyTorch version.

The port of ``acmil_tpu/ops/dsmil_pool.py``. DSMIL's bag stream, as the
generic trainer builds it (``nonlinear=False``), is per class c:

    q_n   = x_n @ Wq + bq                      (instance queries)
    a_cn  = q_n · q_max_c / sqrt(Q)            (critical-instance query)
    A     = softmax over n, masked rows excluded
    bag_c = sum_n A_cn x_n                     (values are the RAW features)

:func:`fused_dsmil_pool` keeps the JAX function's contract and layout:
``bag [B, C, D]`` float32 and the logits ``a [B, C, N]`` float32 with
``NEG`` (-1e30) at masked rows. It picks its route by the device of
``feats`` and nothing else: a CPU tensor takes the plain version
:func:`dsmil_pool_reference`, a CUDA tensor launches kernel B6
(``csrc/dsmil_pool.cu``) or raises.

Kernel B6 does not form q. It folds the critical queries into the features'
space first, ``u_c = Wq q_max_c / sqrt(Q)`` and ``beta_c = bq · q_max_c /
sqrt(Q)``, then ``a_cn = x_n · u_c + beta_c``: D·C instead of D·Q
multiply-adds per row, which leaves the kernel bound by reading x. The
logits then differ from the plain version only in the order of f32 sums.
Each bag's rows are split into a few contiguous ranges
(:func:`_b6_ranges`), one block a range, whose partials a merge combines.
Where a block's registers hold a class's accumulators for all of D
(:func:`_b6_rows_route`: up to 4 classes, which every config uses, at
D <= 512, and 2 classes up to D = 1024) each row is read once and the
products are f32 FMA; elsewhere they are split-TF32 tensor-core MMAs. The wrapper lays out the
kernel's scratch in one device allocation (:func:`_b6_workspace_layout`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

NEG = -1e30

# kMaxClasses and kMaxD of csrc/dsmil_pool.cu, whose entry refuses other
# widths too; C <= 128 is the JAX kernel's limit as well
KERNEL_MAX_C = 128
KERNEL_MAX_D = 1536
KERNEL_D_MULTIPLE = 8

# the CUDA kernels of csrc/dsmil_pool.cu: the fold of the queries (u, beta),
# the row kernel (logits, online softmax and p^T x in one read of each row),
# the split-TF32 logits and pooling kernels, the merge. A call launches the
# fold, the row kernel or the two others, and the merge
B6_KERNELS = ("b6_fold_kernel", "b6_rows_kernel", "b6_logits_kernel",
              "b6_pool_kernel", "b6_merge_kernel")
# rows a tile (kTile), ranges a bag the merge takes (kMaxRanges); ranges are
# aimed at _B6_BLOCKS blocks over all bags on the row kernel's route, two
# waves of one block an SM on a 132-SM H100 (two row-kernel blocks share an
# SM), and at one wave on the split-TF32 route, where each range's partial
# is C x D floats (scripts/attn_variants.py --kernel b6 times both)
_B6_TILE, _B6_MAX_RANGES, _B6_BLOCKS = 64, 1024, 264
# the widest D the row kernel takes at each class count: 256 columns times
# its units of 8 columns a lane (rows_fit and rows_units in the source)
_B6_ROWS_MAX_D = {1: 1536, 2: 1024, 3: 512, 4: 512}
# each buffer of B6's workspace starts at a multiple of this many bytes
_ALIGN = 256


def dsmil_pool_reference(feats, mask, wq, bq, q_max
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6's plain version, the model's own formulation: feats
    ``[B, N, D]``, mask ``[B, N]`` bool, wq ``[D, Q]``, bq ``[Q]``, q_max
    ``[B, C, Q]`` → (bag [B, C, D], logits [B, C, N] with NEG at masked
    rows)."""
    q = feats @ wq + bq                                       # [B, N, Q]
    a = torch.einsum("bnq,bcq->bcn", q, q_max) / math.sqrt(wq.shape[1])
    valid = mask[:, None, :]
    a = torch.where(valid, a, NEG)
    p = torch.softmax(a, dim=-1) * valid
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.einsum("bcn,bnd->bcd", p, feats), a


def _check_kernel_args(feats, mask, wq, bq, q_max) -> None:
    """Raise ValueError for any input kernel B6 does not take."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, N, D], got {tuple(feats.shape)}")
    b, n, d = feats.shape
    if feats.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"feats must be float16 or float32, got {feats.dtype}")
    if tuple(mask.shape) != (b, n) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{b}, {n}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if b < 1 or n < 1:
        raise ValueError(f"empty batch or bag: B={b}, N={n}")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the kernel's grid limit of 65535")
    if d % KERNEL_D_MULTIPLE or d > KERNEL_MAX_D:
        raise ValueError(f"kernel B6 takes D a multiple of {KERNEL_D_MULTIPLE} "
                         f"up to {KERNEL_MAX_D}, got D={d}")
    if wq.dim() != 2 or q_max.dim() != 3:
        raise ValueError(f"wq must be [D, Q] and q_max [B, C, Q], got "
                         f"{tuple(wq.shape)} and {tuple(q_max.shape)}")
    q, c = wq.shape[1], q_max.shape[1]
    if not 1 <= c <= KERNEL_MAX_C:
        raise ValueError(f"kernel B6 takes 1 <= C <= {KERNEL_MAX_C} classes, "
                         f"got C={c}")
    shapes = {"wq": (wq, (d, q)), "bq": (bq, (q,)), "q_max": (q_max, (b, c, q))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _b6_rows_route(c, d):
    """Whether kernel B6 takes c classes of d columns on its row kernel,
    whose registers hold each class's accumulators for all of D; the
    split-TF32 route takes the rest, where it is the faster one on an H100
    (``scripts/b6_widths.py``)."""
    return d <= _B6_ROWS_MAX_D.get(c, 0)


def _b6_ranges(b, n, rows_route=True):
    """(ranges a bag, 64-row tiles a range): each bag's tiles split into
    contiguous ranges, about ``_B6_BLOCKS`` over all bags (half of it on
    the split-TF32 route) and at most one a tile, every range non-empty and
    the last one ragged."""
    tiles = -(-n // _B6_TILE)
    blocks = _B6_BLOCKS if rows_route else _B6_BLOCKS // 2
    want = -(-blocks // b)
    per_bag = max(1, min(tiles, want, _B6_MAX_RANGES))
    range_tiles = -(-tiles // per_bag)
    return -(-tiles // range_tiles), range_tiles


@functools.lru_cache(maxsize=256)
def _b6_workspace_layout(b, n, d, c, ranges):
    """((name, dtype, shape, byte offset), ...) of each buffer of B6's
    device workspace, and its total bytes: the folded queries u [B, C, D]
    and beta [B, C], each range's softmax max and sum [B, R, C] and partial
    bag [B, R, C, D]. Every buffer starts at a multiple of ``_ALIGN``
    bytes."""
    f32 = torch.float32
    buffers = (("u", f32, (b, c, d)), ("beta", f32, (b, c)),
               ("part_m", f32, (b, ranges, c)), ("part_s", f32, (b, ranges, c)),
               ("part_acc", f32, (b, ranges, c, d)))
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

    fn = _build.load("dsmil_pool").b6_dsmil_pool
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch_kernel(feats, mask, wq, bq, q_max):
    _check_kernel_args(feats, mask, wq, bq, q_max)
    dev = feats.device
    # the kernel reads Wq as the torch Linear holds it, [Q, D]: the model's
    # ``q.weight.t()`` transposes back without a copy
    tensors = [t.contiguous() for t in (feats, mask, wq.t(), bq, q_max)]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError("kernel B6 needs 16-byte-aligned inputs")
    x, mk, wq_t, bq_c, qm = tensors
    fn = _kernel_entry()
    b, n, d = feats.shape
    q, c = wq.shape[1], q_max.shape[1]
    ranges, range_tiles = _b6_ranges(b, n, _b6_rows_route(c, d))
    layout, nbytes = _b6_workspace_layout(b, n, d, c, ranges)
    f32 = dict(device=dev, dtype=torch.float32)
    logits = torch.empty(b, c, n, **f32)
    bag = torch.empty(b, c, d, **f32)
    work = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    base = work.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.float16), mk.data_ptr(),
                 wq_t.data_ptr(), bq_c.data_ptr(), qm.data_ptr(),
                 logits.data_ptr(), bag.data_ptr(),
                 *(base + off for *_, off in layout), b, n, d, q, c, ranges,
                 range_tiles, 1.0 / math.sqrt(q), stream)
    if err != 0:
        raise RuntimeError(f"kernel B6 launch failed: cudaError_t {err}")
    fused_dsmil_pool.launches += 1
    return bag, logits


def fused_dsmil_pool(
    feats: torch.Tensor,      # [B, N, D] float16/float32
    mask: torch.Tensor,       # [B, N] bool
    wq: torch.Tensor,         # [D, Q]
    bq: torch.Tensor,         # [Q]
    q_max: torch.Tensor,      # [B, C, Q] critical-instance queries
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (bag_feat [B, C, D], attn_logits [B, C, N]): the model's
    pre-softmax ``a`` with NEG at masked rows.

    CPU tensors take the plain version, in the weights' dtype; CUDA tensors
    launch kernel B6 (and add one to ``fused_dsmil_pool.launches``) or raise.
    N needs no padding: rows past N are masked in the kernel. Inference
    only, as in the JAX package: there is no backward.
    """
    if feats.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (feats, wq, bq, q_max)):
            raise NotImplementedError("fused_dsmil_pool has no backward")
        return _launch_kernel(feats, mask, wq, bq, q_max)
    if feats.device.type == "cpu":
        return dsmil_pool_reference(feats.to(wq.dtype), mask, wq, bq, q_max)
    raise ValueError(f"no kernel B6 route for device {feats.device}")


fused_dsmil_pool.launches = 0
