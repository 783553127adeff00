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
