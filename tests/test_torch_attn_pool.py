"""Kernel B1's port (acmil_tpu_torch/ops/attn_pool.py) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

The same numpy inputs go through both. On CPU tensors the port's wrapper
takes its plain PyTorch version; the CUDA kernel itself is held against that
plain version by the test marked ``gpu``, which runs only on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import attn_pool as jax_pool
from acmil_tpu_torch.config import PRETRAIN_DIMS
from acmil_tpu_torch.ops import attn_pool as port

# every (D_feat, D_inner) pair of the pretrain tags: kernels B1 and B2 take
# each L, with A = 128 (the heads' d_attn)
PRETRAIN_WIDTHS = sorted(set(PRETRAIN_DIMS.values()))

# Both sides compute in float32; only the summation order differs (XLA's
# dots and the interpret-mode chunked online softmax vs torch's matmuls and
# one-shot softmax), so agreement is to f32 rounding over ~32-term sums.
ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, b=2, n=300, df=32, l=16, a=16, k=5, dead_row=True):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, df).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    if dead_row:
        mask[-1] = False                       # one all-masked bag
    weights = [
        (rs.randn(df, l) * 0.2).astype(np.float32),
        (rs.randn(l) * 0.1).astype(np.float32),
        (rs.randn(l, a) * 0.3).astype(np.float32),
        (rs.randn(a) * 0.1).astype(np.float32),
        (rs.randn(l, a) * 0.3).astype(np.float32),
        (rs.randn(a) * 0.1).astype(np.float32),
        (rs.randn(a, k) * 0.5).astype(np.float32),
        (rs.randn(k) * 0.1).astype(np.float32),
    ]
    return feats, mask, weights


def _torch(feats, mask, weights, feats_dtype=torch.float32):
    return (torch.from_numpy(feats).to(feats_dtype), torch.from_numpy(mask),
            [torch.from_numpy(w) for w in weights])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("feats_dtype", [torch.float32, torch.float16])
def test_port_matches_pallas_kernel(k, feats_dtype):
    feats, mask, weights = _inputs(0, k=k)
    want = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *map(jnp.asarray, weights),
        chunk=128, interpret=True, return_stats=True)
    x, m, ws = _torch(feats, mask, weights, feats_dtype)
    got = port.fused_gated_attn_pool_batched(x, m, *ws, return_stats=True)
    bag, logits, mx, s = (t.numpy() for t in got)
    assert bag.shape == (2, k, 16) and logits.shape == (2, k, 300)
    _close(bag, want[0])
    valid = np.broadcast_to(mask[:, None, :], logits.shape)
    _close(logits[valid], np.asarray(want[1])[valid])
    # pad slots carry the kernel's NEG, as the Pallas kernel writes them
    assert np.all(logits[~valid] == port.NEG)
    _close(mx, want[2])
    _close(s, want[3])
    # the all-masked bag pools to zero with no NaN
    assert np.all(bag[-1] == 0.0) and np.all(s[-1] == 0.0)


@pytest.mark.parametrize("k", [1, 5])
def test_reference_batched_matches_jax(k):
    feats, mask, weights = _inputs(1, k=k)
    want = jax_pool._reference_batched(jnp.asarray(feats), jnp.asarray(mask),
                                       *map(jnp.asarray, weights))
    x, m, ws = _torch(feats, mask, weights)
    got = port._reference_batched(x, m, *ws)
    _close(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy() == port.NEG,
                                  np.asarray(want[1]) == jax_pool.NEG)
    valid = np.broadcast_to(mask[:, None, :], got[1].shape)
    _close(got[1].numpy()[valid], np.asarray(want[1])[valid])


def _inputs_at(seed, df, l, k=5, b=2, n=300):
    """A bag batch at a pretrain tag's widths, the weights at torch
    Linear's scale (U(±1/sqrt(fan_in))) so that the gates do not saturate;
    the last bag all masked."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, df).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1] = False
    a = port.KERNEL_A
    weights = [((rs.rand(*s) * 2 - 1) / np.sqrt(fan_in)).astype(np.float32)
               for s, fan_in in [((df, l), df), ((l,), df), ((l, a), l),
                                 ((a,), l), ((l, a), l), ((a,), l),
                                 ((a, k), a), ((k,), a)]]
    return feats, mask, weights


@pytest.mark.parametrize("df, l", PRETRAIN_WIDTHS)
def test_port_matches_pallas_kernel_at_every_pretrain_width(df, l):
    # N = 300 in chunks of 128: the Pallas kernel's online softmax over
    # three chunks, at the widths every config of the repo feeds it
    feats, mask, weights = _inputs_at(5, df, l)
    want = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *map(jnp.asarray, weights),
        chunk=128, interpret=True, return_stats=True)
    x, m, ws = _torch(feats, mask, weights, torch.float16)
    port._check_kernel_args(x, m, *ws)
    bag, logits, mx, s = (t.numpy() for t in port.fused_gated_attn_pool_batched(
        x, m, *ws, return_stats=True))
    assert bag.shape == (2, 5, l) and logits.shape == (2, 5, 300)
    _close(bag, want[0])
    valid = np.broadcast_to(mask[:, None, :], logits.shape)
    _close(logits[valid], np.asarray(want[1])[valid])
    assert np.all(logits[~valid] == port.NEG)
    _close(mx, want[2])
    _close(s, want[3])
    assert np.all(bag[-1] == 0.0)


def test_single_bag_wrappers_match_jax():
    feats, mask, weights = _inputs(2, b=1, dead_row=False)
    x, m, ws = _torch(feats, mask, weights)
    bag, logits = port.fused_gated_attn_pool(x[0], m[0], *ws)
    want_bag, want_logits = jax_pool.fused_gated_attn_pool(
        jnp.asarray(feats[0]), jnp.asarray(mask[0]),
        *map(jnp.asarray, weights), chunk=128, interpret=True)
    _close(bag.numpy(), want_bag)
    _close(logits.numpy()[:, mask[0]], np.asarray(want_logits)[:, mask[0]])
    ref_bag, ref_logits = port.gated_attn_pool_reference(x[0], m[0], *ws)
    want_rb, want_rl = jax_pool.gated_attn_pool_reference(
        jnp.asarray(feats[0]), jnp.asarray(mask[0]),
        *map(jnp.asarray, weights))
    _close(ref_bag.numpy(), want_rb)
    _close(ref_logits.numpy()[mask[0]], np.asarray(want_rl)[mask[0]])


def test_cpu_route_launches_no_kernel():
    feats, mask, weights = _inputs(3)
    before = port.fused_gated_attn_pool_batched.launches
    port.fused_gated_attn_pool_batched(*_torch(feats, mask, weights)[:2],
                                       *_torch(feats, mask, weights)[2])
    assert port.fused_gated_attn_pool_batched.launches == before


def _serving_args(df=384, l=128, a=128, k=5, b=1, n=100):
    z = lambda *s: torch.zeros(*s)
    return [z(b, n, df), torch.ones(b, n, dtype=torch.bool), z(df, l), z(l),
            z(l, a), z(a), z(l, a), z(a), z(a, k), z(k)]


def test_kernel_arg_check_accepts_serving_width():
    port._check_kernel_args(*_serving_args())
    port._check_kernel_args(*_serving_args(k=1, b=3, n=65536 + 7))


def test_kernel_arg_check_accepts_every_pretrain_width():
    for df, l in PRETRAIN_WIDTHS:
        for k in (1, 5, 128):
            port._check_kernel_args(*_serving_args(df=df, l=l, k=k))


@pytest.mark.parametrize("bad, match", [
    (dict(k=129), "K <= 128"),
    (dict(l=64), "L a multiple of 128 up to 768"),
    (dict(l=896), "L a multiple of 128 up to 768"),
    (dict(a=64), "A = 128"),
    (dict(df=40), "multiple of 32"),
    (dict(n=0), "empty"),
])
def test_kernel_arg_check_rejects_untaken_widths(bad, match):
    with pytest.raises(ValueError, match=match):
        port._check_kernel_args(*_serving_args(**bad))


def test_kernel_arg_check_rejects_wrong_dtypes():
    args = _serving_args()
    args[0] = args[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="float16 or float32"):
        port._check_kernel_args(*args)
    args = _serving_args()
    args[1] = args[1].to(torch.uint8)
    with pytest.raises(ValueError, match="mask must be bool"):
        port._check_kernel_args(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA C++ for sm_90a: needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("k", [1, 5])
def test_kernel_matches_plain_on_card(cuda_device, feats_dtype, k):
    # serving width, a ragged N, B=3 with one all-masked bag; f32 on both
    # sides with TF32 off, so only the summation order differs
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(4)
    n, df = 5000, 384
    x = torch.from_numpy(rs.randn(3, n, df).astype(np.float32)).to(
        cuda_device, feats_dtype)
    m = torch.from_numpy(rs.rand(3, n) < 0.9).to(cuda_device)
    m[1] = False
    ws = [torch.from_numpy(((rs.rand(*s) * 2 - 1) * 0.09).astype(np.float32))
          .to(cuda_device) for s in [(df, 128), (128,), (128, 128), (128,),
                                     (128, 128), (128,), (128, k), (k,)]]
    with torch.no_grad():
        before = port.fused_gated_attn_pool_batched.launches
        bag, logits, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True)
        torch.cuda.synchronize()
        assert port.fused_gated_attn_pool_batched.launches == before + 1
        rb, rl = port._reference_batched(x.float(), m, *ws)
        rm, rs_ = port._softmax_stats(rl, m)
    valid = m[:, None, :].expand_as(logits)
    torch.testing.assert_close(bag, rb, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits[valid], rl[valid], atol=1e-4, rtol=1e-4)
    assert bool((logits[~valid] == port.NEG).all())
    torch.testing.assert_close(mx, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs_, atol=1e-4, rtol=1e-4)
    assert not bool(bag.isnan().any()) and bool((bag[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("df, l, k", [(512, 256, 5), (768, 384, 1),
                                      (1024, 512, 5), (1536, 768, 5),
                                      (1536, 768, 128)])
def test_kernel_matches_plain_on_card_at_wider_l(cuda_device, feats_dtype, df,
                                                 l, k):
    # the pretrain tags' widths (32-row tiles), a ragged N, B=3 with one
    # all-masked bag; f32 on both sides with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, mask, weights = _inputs_at(9, df, l, k=k, b=3, n=3001)
    x, m, ws = (t.to(cuda_device) if isinstance(t, torch.Tensor) else
                [w.to(cuda_device) for w in t]
                for t in _torch(feats, mask, weights, feats_dtype))
    with torch.no_grad():
        bag, logits, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True)
        torch.cuda.synchronize()
        rb, rl = port._reference_batched(x.float(), m, *ws)
        rm, rs_ = port._softmax_stats(rl, m)
    valid = m[:, None, :].expand_as(logits)
    torch.testing.assert_close(bag, rb, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits[valid], rl[valid], atol=1e-4, rtol=1e-4)
    assert bool((logits[~valid] == port.NEG).all())
    torch.testing.assert_close(mx, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs_, atol=1e-4, rtol=1e-4)
    assert bool((bag[2] == 0).all())


@pytest.mark.parametrize("b, n, l, k", [(1, 65536, 128, 5), (3, 300, 768, 128),
                                        (2, 4099, 256, 1), (1, 1, 512, 5)])
def test_b1_workspace_layout_is_aligned_and_disjoint(b, n, l, k):
    layout, total = port._b1_workspace_layout(b, n, l, k)
    names = [name for name, *_ in layout]
    assert names == ["norms", "h", "near", "near_counts", "part_m", "part_s",
                     "part_acc"]
    m, tiles = b * n, -(-n // 64)
    h_tiles = -(-m // 128) * (l // 128)
    want = {"norms": (m + l,), "h": (m, l), "near": (h_tiles, 512, 2),
            "near_counts": (h_tiles,), "part_m": (b, tiles, k),
            "part_s": (b, tiles, k), "part_acc": (b, tiles, k, l)}
    end = 0
    for name, dtype, shape, offset in layout:
        assert shape == want[name] and offset % port._ALIGN == 0
        assert offset >= end                     # in order, no overlap
        end = offset + int(np.prod(shape)) * dtype.itemsize
    assert end <= total and total % port._ALIGN == 0
    # the views a test reads the workspace through have the buffers' shapes
    views = port._workspace_views(torch.zeros(total, dtype=torch.uint8),
                                  layout)
    assert {k_: tuple(v.shape) for k_, v in views.items()} == want
    assert views["near"].dtype == torch.int32


def _kernel_names(source):
    """Names of the __global__ functions in a CUDA source."""
    import re

    from acmil_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
    return set(re.findall(rf"__global__ void(?:\s+{bounds})?\s+(\w+)\(",
                          text))


def test_b1_and_b2_kernel_names_are_the_sources_kernels():
    # the smoke run and the variants script profile B1 and B2 by these
    # names; the H stage's kernels are the shared header's
    shared = _kernel_names("gated_h.cuh")
    assert set(port.H_STAGE_KERNELS) == shared
    assert set(port.B1_KERNELS) == shared | _kernel_names("attn_pool.cu")
    assert set(port.B2_KERNELS) == shared | _kernel_names("attn_pool_bwd.cu")
    # a profile matches names by substring: none of B1's is part of a name
    # of B6 or of B1's own other kernels
    others = _kernel_names("dsmil_pool.cu") | _kernel_names("vit_attn.cu")
    for name in port.B1_KERNELS:
        assert not any(name in o for o in others)
        assert [b for b in port.B1_KERNELS if name in b] == [name]


def test_b1_tiles_match_the_sources():
    from acmil_tpu_torch.ops import _build

    b1 = (_build.CSRC / "attn_pool.cu").read_text()
    h = (_build.CSRC / "gated_h.cuh").read_text()
    assert f"constexpr int kTile = {port._B1_TILE};" in b1
    assert f"constexpr int kMaxNear = {port._H_NEAR};" in h
    assert f"kBM = {port._H_TILE}, kBN = {port._H_TILE}," in h
    assert f"constexpr int kMaxK = {port.KERNEL_MAX_K};" in h


def test_cpu_route_leaves_the_workspace_empty():
    feats, mask, weights = _inputs(6)
    work = {}
    port.fused_gated_attn_pool_batched(*_torch(feats, mask, weights)[:2],
                                       *_torch(feats, mask, weights)[2],
                                       _workspace=work)
    assert work == {}


def _stress_inputs(seed, df, l, k=5, b=3, n=4099):
    """A batch whose last-but-one bag is all masked and whose near-0
    pre-activations crowd the H stage's recompute: rows 1-5, 200 and n - 1
    of bag 0 and row 7 of bag 2 copy row 0 of bag 0, and b1 = -(x_0 W1), so
    that every pre-activation of those rows lies within rounding of 0 (six
    rows of one 128-row tile list 768 elements, past a tile's 512)."""
    feats, mask, weights = _inputs_at(seed, df, l, k=k, b=b, n=n)
    mask[1] = False
    mask[-1] = rs_mask = np.random.RandomState(seed + 1).rand(n) < 0.8
    assert rs_mask.any()
    feats[0, [1, 2, 3, 4, 5, 200, n - 1]] = feats[0, 0]
    feats[2, 7] = feats[0, 0]
    mask[0, :6] = True
    weights[1] = -(feats[0, 0] @ weights[0]).astype(np.float32)
    return feats, mask, weights


@pytest.mark.parametrize("df, l", [(384, 128), (1536, 768)])
def test_port_matches_pallas_kernel_on_a_near_zero_bag(df, l):
    # the plain route against the Pallas kernel where relu's argument is 0
    # to rounding across whole rows: relu is continuous there, so the
    # outputs agree to f32 rounding however each side rounds the sign
    feats, mask, weights = _stress_inputs(15, df, l, n=600)
    want = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *map(jnp.asarray, weights),
        chunk=128, interpret=True, return_stats=True)
    x, m, ws = _torch(feats, mask, weights, torch.float16)
    bag, logits, mx, s = (t.numpy() for t in port.fused_gated_attn_pool_batched(
        x, m, *ws, return_stats=True))
    _close(bag, want[0])
    valid = np.broadcast_to(mask[:, None, :], logits.shape)
    _close(logits[valid], np.asarray(want[1])[valid])
    _close(mx, want[2])
    _close(s, want[3])
    assert np.all(bag[1] == 0.0) and np.all(s[1] == 0.0)


def _card_stress(device, feats_dtype, df, l, seed=16):
    """The stress batch on the card, b1 formed there from the card's row 0
    (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, mask, weights = _stress_inputs(seed, df, l)
    x = torch.from_numpy(feats).to(device, feats_dtype)
    m = torch.from_numpy(mask).to(device)
    ws = [torch.from_numpy(w).to(device) for w in weights]
    ws[1] = -(x[0, 0].float() @ ws[0])
    return x, m, ws


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("df, l", [(384, 128), (512, 256), (1536, 768)])
def test_kernel_matches_plain_on_the_stress_bag_on_card(cuda_device,
                                                        feats_dtype, df, l):
    x, m, ws = _card_stress(cuda_device, feats_dtype, df, l)
    work = {}
    with torch.no_grad():
        bag, logits, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True, _workspace=work)
        torch.cuda.synchronize()
        rb, rl = port._reference_batched(x.float(), m, *ws)
        rm, rs_ = port._softmax_stats(rl, m)
    # the rows of near-0 pre-activations were listed for the recompute
    assert int(work["near_counts"].sum()) >= 6 * l
    valid = m[:, None, :].expand_as(logits)
    torch.testing.assert_close(bag, rb, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits[valid], rl[valid], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(mx, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs_, atol=1e-4, rtol=1e-4)
    assert bool((bag[1] == 0).all()) and bool((s[1] == 0).all())
    assert bool((mx[1] == port.NEG).all())


@pytest.mark.gpu
@pytest.mark.parametrize("df, l, k, stress", [(384, 128, 5, False),
                                              (1024, 512, 128, False),
                                              (384, 128, 5, True),
                                              (1536, 768, 5, True)])
def test_two_launches_are_bit_identical_on_card(cuda_device, df, l, k, stress):
    if stress:
        x, m, ws = _card_stress(cuda_device, torch.float16, df, l)
    else:
        feats, mask, weights = _inputs_at(17, df, l, k=k, b=3, n=20001)
        x, m, ws = (t.to(cuda_device) if isinstance(t, torch.Tensor) else
                    [w.to(cuda_device) for w in t]
                    for t in _torch(feats, mask, weights, torch.float16))
    with torch.no_grad():
        first = port.fused_gated_attn_pool_batched(x, m, *ws,
                                                   return_stats=True)
        second = port.fused_gated_attn_pool_batched(x, m, *ws,
                                                    return_stats=True)
        torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("stress", [False, True])
@pytest.mark.parametrize("df, l", [(384, 128), (768, 384), (1536, 768)])
def test_b1_h_equals_b2_h_on_card(cuda_device, feats_dtype, stress, df, l):
    # one H stage for the forward and the backward: the same bits, so the
    # relu masks agree by construction
    if stress:
        x, m, ws = _card_stress(cuda_device, feats_dtype, df, l)
    else:
        feats, mask, weights = _inputs_at(18, df, l, b=2, n=3001)
        x, m, ws = (t.to(cuda_device) if isinstance(t, torch.Tensor) else
                    [w.to(cuda_device) for w in t]
                    for t in _torch(feats, mask, weights, feats_dtype))
    k = ws[6].shape[1]
    fwd, bwd = {}, {}
    with torch.no_grad():
        bag, _, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True, _workspace=fwd)
        lse = mx + torch.log(s.clamp_min(1e-30))
        d_bag = torch.ones(x.shape[0], k, l, device=cuda_device)
        d_logits = torch.zeros(x.shape[0], k, x.shape[1], device=cuda_device)
        port.fused_gated_attn_pool_bwd(x, m, *ws, lse, (d_bag * bag).sum(-1),
                                       d_bag, d_logits, need_dx=False,
                                       _workspace=bwd)
        torch.cuda.synchronize()
    assert fwd["h"].shape == (x.shape[0] * x.shape[1], l)
    assert torch.equal(fwd["h"], bwd["h"])
