"""Kernels B6 (acmil_tpu_torch/ops/dsmil_pool.py) and B7
(acmil_tpu_torch/ops/vit_attn.py) against their plain versions on the card,
and their wrappers' checks of what the kernels take. The file imports no JAX
or flax, so it runs on a machine that has neither; here, without a card,
the ``gpu`` tests skip. tests/test_torch_dsmil_pool.py and
tests/test_torch_vit_attn_b7.py hold the plain versions against the JAX
package's Pallas kernels."""

import math

import numpy as np
import pytest
import torch

from acmil_tpu_torch.config import PRETRAIN_DIMS
from acmil_tpu_torch.ops import dsmil_pool, vit_attn, vit_attn_packed

# B6 vs plain, f32 both with TF32 off: only the order of the sums differs
# (B6 folds the critical queries into the features' space)
B6_TOL = 1e-4
# B7 vs plain, bf16 both: a flipped bf16 rounding of p can land on an
# output that cancels to near 0, so the bound is one bf16 step of each
# output and of the largest output
BF16_TOL = 2.0 ** -7
# B7's tf32x3 and fma routes vs plain at float32: only the order of the
# f32 sums and exp's rounding differ (split-TF32 products keep about f32's
# accuracy)
F32_TOL = 1e-5
# B5' and B7 on the tensor cores at float16 vs plain: the same rounding
# points as at bf16, one float16 step (2**-10) of each output and of the
# largest output
F16_TOL = 2.0 ** -10
# token counts at the edges of csrc/vit_attn.cu: the ragged 16-key chunk,
# the trunks' 197, 577 and 785, at dh = 64 the warpgroup routes' 208-key
# steps (N in [145, 208], up to 416, up to 624), keys resident in shared
# memory up to 896 (dh = 64) and 448 (dh = 128)
EDGE_N = (1, 15, 16, 17, 63, 64, 65, 144, 145, 197, 208, 209, 416, 417, 448,
          449, 577, 624, 625, 785, 896, 897)


def _b6_inputs(dev, b, n, d, q, c, dtype, seed=0):
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    feats = f(b, n, d).to(dev, dtype)
    mask = torch.from_numpy(rs.rand(b, n) < 0.85).to(dev)
    if b > 1:
        mask[1] = False                        # an all-masked bag
    wq, bq = (f(d, q) / math.sqrt(d)).to(dev), (0.1 * f(q)).to(dev)
    q_max = f(b, c, q).to(dev)
    return feats, mask, wq, bq, q_max


def _b7_inputs(dev, shape, dtype=torch.bfloat16, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(2 * rs.randn(*shape).astype(np.float32)).to(
        dev, dtype) for _ in range(3)]


@pytest.mark.parametrize("shape, dtype, match", [
    ((2, 3, 50, 32), torch.int32, "bfloat16"),
    ((2, 3, 50, 272), torch.bfloat16, "head widths"),
    ((2, 3, 50), torch.bfloat16, r"\[B, H, N, dh\]"),
    ((2, 3, 0, 32), torch.bfloat16, "empty"),
])
def test_b7_arg_check_rejects(shape, dtype, match):
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    with pytest.raises(ValueError, match=match):
        vit_attn._check_kernel_args(q, k, v)


def test_b7_arg_check_takes_strided_rows_not_strided_elements():
    qkv = torch.zeros(2, 50, 3, 6, 64, dtype=torch.bfloat16)
    vit_attn._check_kernel_args(*qkv.permute(2, 0, 3, 1, 4))
    q = torch.zeros(2, 6, 64, 50, dtype=torch.bfloat16).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        vit_attn._check_kernel_args(q, q, q)


def test_b7_arg_check_accepts_every_trunk_width():
    for heads, n, dh in ((6, 197, 64), (12, 197, 64), (16, 577, 64),
                         (24, 197, 64), (6, 785, 64), (2, 50, 16),
                         (2, 50, 128)):
        q = torch.zeros(1, heads, n, dh, dtype=torch.bfloat16)
        vit_attn._check_kernel_args(q, q, q)
        assert vit_attn._route(q, q, q, q) == "mma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("dh", [1, 16, 48, 80, 256])
def test_b7_takes_every_dtype_and_head_width_up_to_256(dtype, dh):
    q = torch.zeros(2, 3, 50, dh, dtype=dtype)
    vit_attn._check_kernel_args(q, q, q, q)
    # the tensor cores' head widths: mma at fp16 and bf16, tf32x3 at f32
    want = ("fma" if dh not in (16, 64) else
            "tf32x3" if dtype == torch.float32 else "mma")
    assert vit_attn._route(q, q, q, q) == want


def test_b7_out_must_match_q():
    q = torch.zeros(2, 3, 50, 32)
    with pytest.raises(ValueError, match="out must be"):
        vit_attn._check_kernel_args(q, q, q, q.bfloat16())
    with pytest.raises(ValueError, match="no gradient"):
        vit_attn.fused_vit_attention(q.requires_grad_(), q, q,
                                     out=torch.empty_like(q))
    # a token-major [B, N, H*dh] buffer takes the result through a view
    buf = torch.empty(2, 50, 3 * 32, dtype=torch.bfloat16)
    view = buf.view(2, 50, 3, 32).transpose(1, 2)
    k = torch.zeros(2, 3, 50, 32, dtype=torch.bfloat16)
    vit_attn._check_kernel_args(k, k, k, view)
    assert vit_attn._route(k, k, k, view) == "mma"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B6 and B7 are CUDA C++ for sm_90a: need an "
                    "NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, q, c, dtype", [
    (1, 300, 384, 128, 2, torch.float16),
    (3, 5000, 384, 128, 4, torch.float32),
    (2, 1000, 1024, 512, 8, torch.float16),
    (1, 70, 1536, 768, 1, torch.float32),
    (3, 5000, 384, 128, 9, torch.float16),
    (2, 1000, 512, 256, 16, torch.float32),
    (1, 3000, 384, 128, 128, torch.float16),
    (2, 300, 1024, 512, 128, torch.float32),
])
def test_b6_matches_plain_on_card(cuda_device, b, n, d, q, c, dtype):
    feats, mask, wq, bq, q_max = _b6_inputs(cuda_device, b, n, d, q, c, dtype)
    before = dsmil_pool.fused_dsmil_pool.launches
    with torch.no_grad():
        bag, logits = dsmil_pool.fused_dsmil_pool(feats, mask, wq, bq, q_max)
        torch.cuda.synchronize()
        rbag, rlogits = dsmil_pool.dsmil_pool_reference(feats.float(), mask,
                                                        wq, bq, q_max)
    assert dsmil_pool.fused_dsmil_pool.launches == before + 1
    torch.testing.assert_close(bag, rbag, atol=B6_TOL, rtol=B6_TOL)
    valid = mask[:, None, :].expand_as(logits)
    torch.testing.assert_close(logits[valid], rlogits[valid], atol=B6_TOL,
                               rtol=B6_TOL)
    assert bool((logits[~valid] == dsmil_pool.NEG).all())
    if b > 1:
        assert not bool(bag[1].any())


def _b6_check(dev, b, n, d, q, c, dtype, seed=0):
    """Kernel B6 against its plain version, twice: the same bits each time,
    NEG at masked rows, an all-masked bag (bag 1 of B > 1) giving 0."""
    feats, mask, wq, bq, q_max = _b6_inputs(dev, b, n, d, q, c, dtype, seed)
    before = dsmil_pool.fused_dsmil_pool.launches
    with torch.no_grad():
        bag, logits = dsmil_pool.fused_dsmil_pool(feats, mask, wq, bq, q_max)
        bag2, logits2 = dsmil_pool.fused_dsmil_pool(feats, mask, wq, bq, q_max)
        torch.cuda.synchronize()
        rbag, rlogits = dsmil_pool.dsmil_pool_reference(feats.float(), mask,
                                                        wq, bq, q_max)
    assert dsmil_pool.fused_dsmil_pool.launches == before + 2
    assert torch.equal(bag, bag2) and torch.equal(logits, logits2)
    torch.testing.assert_close(bag, rbag, atol=B6_TOL, rtol=B6_TOL)
    valid = mask[:, None, :].expand_as(logits)
    torch.testing.assert_close(logits[valid], rlogits[valid], atol=B6_TOL,
                               rtol=B6_TOL)
    assert bool((logits[~valid] == dsmil_pool.NEG).all())
    assert not bool(bag.isnan().any())
    if b > 1:
        assert not bool(bag[1].any())


# every (D_feat, D_inner) of config.PRETRAIN_DIMS, as the DSMIL head takes
# them (D, Q)
_PRETRAIN_DQ = sorted(set(PRETRAIN_DIMS.values()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("c", [2, 3, 4])
@pytest.mark.parametrize("d, q", _PRETRAIN_DQ)
def test_b6_at_every_pretrain_width(cuda_device, d, q, c, dtype):
    # the row kernel up to D = 512 (and at C = 2 up to 1024), the
    # split-TF32 route past it
    _b6_check(cuda_device, 3, 3000, d, q, c, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 9])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 16896, 16897, 16959])
def test_b6_at_range_edges(cuda_device, n, c):
    # N = 1 to 65: ranges of one 64-row tile, the last one ragged; 16896 is
    # 264 tiles (one a range), 16897 and 16959 ranges of two tiles, the last
    # range one row or one tile less a row long
    ranges, tiles = dsmil_pool._b6_ranges(1, n)
    assert n <= 65 or tiles == (1 if n == 16896 else 2)
    _b6_check(cuda_device, 1, n, 384, 128, c, torch.float16, seed=n)
    _b6_check(cuda_device, 3, n, 384, 128, c, torch.float32, seed=n + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("c", [9, 32, 33, 64, 65, 128])
def test_b6_split_tf32_route(cuda_device, c, dtype):
    # C > 4: the split-TF32 logits and pooling kernels, class groups of 64
    _b6_check(cuda_device, 3, 4099, 384, 128, c, dtype, seed=c)


@pytest.mark.gpu
def test_b6_raises_on_what_it_does_not_take(cuda_device):
    feats, mask, wq, bq, q_max = _b6_inputs(cuda_device, 1, 64, 384, 128,
                                            129, torch.float16)
    with pytest.raises(ValueError, match="C <= 128"):
        dsmil_pool.fused_dsmil_pool(feats, mask, wq, bq, q_max)
    with pytest.raises(NotImplementedError, match="no backward"):
        dsmil_pool.fused_dsmil_pool(feats, mask, wq.requires_grad_(), bq,
                                    q_max[:, :2])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 6, 197, 64), (1, 16, 577, 64),
                                   (3, 2, 50, 32)])
def test_b7_matches_plain_on_card(cuda_device, shape):
    q, k, v = _b7_inputs(cuda_device, shape)
    before = vit_attn.fused_vit_attention.launches
    with torch.no_grad():
        got = vit_attn.fused_vit_attention(q, k, v)
        torch.cuda.synchronize()
        want = vit_attn._reference_attention(q, k, v)
    assert vit_attn.fused_vit_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL * float(want.float().abs().max()))


def _b7_check(q, k, v, scale=None):
    before = vit_attn.fused_vit_attention.launches
    with torch.no_grad():
        got = vit_attn.fused_vit_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = vit_attn._reference_attention(q, k, v, scale)
    assert vit_attn.fused_vit_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("n", EDGE_N)
def test_b7_on_strided_views_at_its_edges(cuda_device, n, dh):
    # q, k, v cut from one packed qkv [B, N, 3, H, dh], as B5' reads them;
    # a negative scale flips which score is the row's largest
    rs = np.random.RandomState(n + dh)
    qkv = torch.from_numpy(2 * rs.randn(2, n, 3, 2, dh).astype(np.float32))
    _b7_check(*qkv.to(cuda_device, torch.bfloat16).permute(2, 0, 3, 1, 4),
              scale=-0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 6, 197, 64), (300, 6, 197, 64),
                                   (40, 16, 577, 64), (1, 2, 785, 128)])
def test_b7_from_one_image_to_many_waves(cuda_device, shape):
    _b7_check(*_b7_inputs(cuda_device, shape, seed=shape[0]))


@pytest.mark.gpu
def test_b7_backward_and_float32_on_card(cuda_device):
    ins = [t.requires_grad_() for t in _b7_inputs(cuda_device, (2, 3, 50, 32))]
    out = vit_attn.fused_vit_attention(*ins)
    grads = torch.autograd.grad(out.float().sum(), ins)
    refs = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(
        vit_attn._reference_attention(*refs).float().sum(), refs)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    # float32 takes the tf32x3 route: only the order of f32 sums differs
    f32 = [t.detach().float() for t in ins]
    before = dict(vit_attn.fused_vit_attention.route_launches)
    with torch.no_grad():
        got = vit_attn.fused_vit_attention(*f32)
        torch.cuda.synchronize()
        want = vit_attn._reference_attention(*f32)
    assert vit_attn.fused_vit_attention.route_launches["tf32x3"] == \
        before["tf32x3"] + 1
    torch.testing.assert_close(got, want, rtol=F32_TOL,
                               atol=F32_TOL * float(want.abs().max()))


def _b5_check(qkv, heads, key, tol):
    """B5' on the card against its plain version; ``key`` names the route
    (and dtype) whose count must grow by one."""
    before = dict(vit_attn_packed._launch_packed.route_launches)
    with torch.no_grad():
        got = vit_attn_packed.fused_mha_packed(qkv, heads)
        torch.cuda.synchronize()
        want = vit_attn_packed._reference_packed(qkv, heads)
    after = vit_attn_packed._launch_packed.route_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == key) for k in after}
    assert got.dtype == qkv.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("n", EDGE_N)
def test_b5_float16_on_the_tensor_cores_at_its_edges(cuda_device, n, dh):
    # every route of csrc/vit_attn.cu (wgmma one pass and split, mma.sync
    # resident and streamed) at float16
    rs = np.random.RandomState(n + dh)
    qkv = torch.from_numpy(2 * rs.randn(2, n, 3 * 2 * dh).astype(np.float32))
    _b5_check(qkv.to(cuda_device, torch.float16), 2, "f16", F16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 6, 197, 64), (1, 16, 577, 64),
                                   (2, 2, 785, 128), (3, 2, 50, 32)])
def test_b7_float16_on_the_tensor_core_route(cuda_device, shape):
    q, k, v = _b7_inputs(cuda_device, shape, torch.float16)
    before = dict(vit_attn.fused_vit_attention.route_launches)
    with torch.no_grad():
        got = vit_attn.fused_vit_attention(q, k, v)
        torch.cuda.synchronize()
        want = vit_attn._reference_attention(q, k, v)
    assert vit_attn.fused_vit_attention.route_launches["mma"] == \
        before["mma"] + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=F16_TOL,
                               atol=F16_TOL * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, dtype", [
    (2, 197, 384, 6, torch.float32),       # ViT-S/16 at float32
    (2, 197, 1024, 16, torch.float32),     # UNI: the packed route at f32
    (1, 577, 768, 16, torch.float32),      # CLIP-L/336 (dh 48)
    (2, 50, 96, 2, torch.bfloat16),        # dh 48: no tensor-core route
    (2, 65, 160, 2, torch.float16),        # dh 80
])
def test_b5_fma_route_on_strided_views(cuda_device, b, n, d, heads, dtype):
    # B5' through a strided route, reading q, k, v and writing o in the
    # packed layout: B7's fma route off the tensor cores' head widths (bf16
    # and fp16 there keep their rounding points), the tf32x3 route at f32
    # on them
    rs = np.random.RandomState(n + d)
    qkv = torch.from_numpy(2 * rs.randn(b, n, 3 * d).astype(np.float32))
    tol = {torch.float32: F32_TOL, torch.float16: F16_TOL,
           torch.bfloat16: BF16_TOL}[dtype]
    route = ("tf32x3" if dtype == torch.float32
             and d // heads in vit_attn_packed.KERNEL_HEAD_DIMS else "fma")
    _b5_check(qkv.to(cuda_device, dtype), heads, route, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_b5_backward_on_card_equals_plain_autograd(cuda_device, dtype):
    rs = np.random.RandomState(3)
    qkv = torch.from_numpy(2 * rs.randn(2, 50, 3 * 64).astype(np.float32)).to(
        cuda_device, dtype).requires_grad_()
    g = torch.from_numpy(rs.randn(2, 50, 64).astype(np.float32)).to(
        cuda_device, dtype)
    (got,) = torch.autograd.grad(vit_attn_packed.fused_mha_packed(qkv, 2),
                                 qkv, g)
    ref = qkv.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(vit_attn_packed._reference_packed(ref, 2),
                                  ref, g)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# the tf32x3 route (csrc/vit_attn_f32.cu) at every head width it takes and
# at token counts around its 16-key tiles and 128-query blocks, the trunks'
# 197, 577 and 785, and past them
TF32X3_N = (1, 17, 64, 65, 197, 577, 785, 1025)


def _tf32x3_check(q, k, v, out=None, scale=0.3):
    before = dict(vit_attn.fused_vit_attention.route_launches)
    with torch.no_grad():
        got = vit_attn.fused_vit_attention(q, k, v, scale, out=out)
        torch.cuda.synchronize()
        want = vit_attn._reference_attention(q, k, v, scale)
    after = vit_attn.fused_vit_attention.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == "tf32x3") for r in after}
    torch.testing.assert_close(got, want, rtol=F32_TOL,
                               atol=F32_TOL * float(want.abs().max()))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "packed", "token_major"])
@pytest.mark.parametrize("n", TF32X3_N)
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_b7_tf32x3_route_matches_plain_on_card(cuda_device, dh, n, layout):
    # contiguous q, k, v; strided views of a packed qkv [B, N, 3, H, dh];
    # and those views writing into a token-major [B, N, H dh] buffer that
    # starts as NaN
    rs = np.random.RandomState(dh + n)
    qkv = torch.from_numpy(2 * rs.randn(2, n, 3, 3, dh).astype(
        np.float32)).to(cuda_device)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    out = buf = None
    if layout == "token_major":
        buf = torch.full((2, n, 3 * dh), float("nan"), device=cuda_device)
        out = buf.view(2, n, 3, dh).transpose(1, 2)
    _tf32x3_check(q, k, v, out)
    if buf is not None:
        assert torch.isfinite(buf).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 6, 197, 64), (2, 2, 785, 128),
                                   (3, 2, 65, 16)])
def test_b7_tf32x3_route_gives_the_same_bits_twice(cuda_device, shape):
    q, k, v = _b7_inputs(cuda_device, shape, torch.float32, seed=shape[2])
    a = _tf32x3_check(q, k, v, scale=None)
    b = _tf32x3_check(q, k, v, scale=None)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads", [
    (2, 197, 384, 6),       # ViT-S/16
    (1, 577, 1024, 16),     # CLIP-L/336
    (2, 785, 384, 6),       # ViT-S/8
    (2, 65, 256, 2),        # dh 128
    (3, 17, 64, 4),         # dh 16
])
def test_b5_float32_on_the_tf32x3_route(cuda_device, b, n, d, heads):
    rs = np.random.RandomState(n + d + 1)
    qkv = torch.from_numpy(2 * rs.randn(b, n, 3 * d).astype(np.float32))
    _b5_check(qkv.to(cuda_device), heads, "tf32x3", F32_TOL)
