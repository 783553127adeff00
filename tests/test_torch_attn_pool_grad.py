"""Kernel B2's port, the backward of acmil_tpu_torch/ops/attn_pool.py,
against the JAX package's Pallas backward run in interpret mode on the CPU.

On CPU tensors the port's wrappers take their plain versions, and
``gated_attn_pool_grad``'s autograd wiring (saved tensors, lse from the
forward's (m, s), c, pad slots, dtype casts) runs as it does on the card.
The CUDA kernel itself is held against its plain version by the test
marked ``gpu``, which runs only on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import attn_pool as jax_pool
from acmil_tpu_torch.config import PRETRAIN_DIMS
from acmil_tpu_torch.ops import attn_pool as port

# float32 on both sides; sums over up to 600 rows are taken in other orders
# (interpret-mode chunks of 128 vs torch's matmuls)
ATOL, RTOL = 2e-5, 1e-4
# the JAX package's own gradient tolerance for the fused pooling
# (tests/test_attn_pool.py: gated_attn_pool_grad against the reference)
GRAD_TOL = 2e-4
GRAD_NAMES = ("d_feats", "dW1", "db1", "dV", "dbv", "dU", "dbu", "dw", "dbw")


def _inputs(seed, b=2, n=300, df=32, l=16, a=16, k=5, all_masked=False):
    """A bag batch whose last bag has a dead tail (or is all masked)."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, df).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, 200:] = False
    if all_masked:
        mask[-1] = False
    weights = [(rs.randn(*s) * sc).astype(np.float32) for s, sc in [
        ((df, l), 0.2), ((l,), 0.1), ((l, a), 0.3), ((a,), 0.1),
        ((l, a), 0.3), ((a,), 0.1), ((a, k), 0.5), ((k,), 0.1)]]
    d_bag = rs.randn(b, k, l).astype(np.float32)
    # nonzero at pad slots too: the backward must ignore them
    d_logits = rs.randn(b, k, n).astype(np.float32)
    return feats, mask, weights, d_bag, d_logits


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _loss_torch(bag, logits):
    return (bag ** 2).sum() + 1e-3 * torch.tanh(logits).sum()


def _loss_jax(bag, logits):
    return (bag ** 2).sum() + 1e-3 * jnp.tanh(logits).sum()


@pytest.mark.parametrize("k, all_masked", [(1, False), (5, False), (5, True)])
def test_bwd_stats_matches_pallas(k, all_masked):
    feats, mask, ws, d_bag, d_logits = _inputs(0, k=k, all_masked=all_masked)
    jws = [jnp.asarray(w) for w in ws]
    bag, _, m, s = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *jws, chunk=128,
        interpret=True, return_stats=True)
    lse = np.asarray(m + jnp.log(jnp.maximum(s, 1e-30)))
    c = np.sum(d_bag * np.asarray(bag), axis=2)
    want = jax_pool._fused_pool_bwd_stats(
        jnp.asarray(feats), jnp.asarray(mask), *jws, jnp.asarray(lse),
        jnp.asarray(c), jnp.asarray(d_bag), jnp.asarray(d_logits), chunk=128,
        interpret=True)
    x, mk, l_, c_, db, dl = _t(feats, mask, lse, c, d_bag, d_logits)
    got = port._fused_pool_bwd_stats(x, mk, *_t(*ws), l_, c_, db, dl)
    for name, g, w in zip(GRAD_NAMES, got, want):
        _close(g.numpy(), w, name=name)
    assert np.all(got[0].numpy()[~mask] == 0.0)      # masked rows get no dx
    for g in got:
        assert np.isfinite(g.numpy()).all()


def _inputs_at(seed, df, l, k=5, b=2, n=300):
    """A bag batch at a pretrain tag's widths (A = 128), the weights at
    torch Linear's scale; the last bag has a dead tail."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, df).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, 200:] = False
    a = port.KERNEL_A
    weights = [((rs.rand(*s) * 2 - 1) / np.sqrt(fan_in)).astype(np.float32)
               for s, fan_in in [((df, l), df), ((l,), df), ((l, a), l),
                                 ((a,), l), ((l, a), l), ((a,), l),
                                 ((a, k), a), ((k,), a)]]
    d_bag = rs.randn(b, k, l).astype(np.float32)
    d_logits = rs.randn(b, k, n).astype(np.float32)
    return feats, mask, weights, d_bag, d_logits


@pytest.mark.parametrize("df, l", sorted(set(PRETRAIN_DIMS.values())))
def test_bwd_stats_matches_pallas_at_every_pretrain_width(df, l):
    feats, mask, ws, d_bag, d_logits = _inputs_at(10, df, l)
    jws = [jnp.asarray(w) for w in ws]
    bag, _, m, s = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *jws, chunk=128,
        interpret=True, return_stats=True)
    lse = np.asarray(m + jnp.log(jnp.maximum(s, 1e-30)))
    c = np.sum(d_bag * np.asarray(bag), axis=2)
    want = jax_pool._fused_pool_bwd_stats(
        jnp.asarray(feats), jnp.asarray(mask), *jws, jnp.asarray(lse),
        jnp.asarray(c), jnp.asarray(d_bag), jnp.asarray(d_logits), chunk=128,
        interpret=True)
    x, mk, l_, c_, db, dl = _t(feats, mask, lse, c, d_bag, d_logits)
    got = port.fused_gated_attn_pool_bwd(x, mk, *_t(*ws), l_, c_, db, dl)
    port._check_bwd_args(x, 5, l, l_, c_, db, dl)
    assert got[1].shape == (df, l) and got[3].shape == (l, port.KERNEL_A)
    for name, g, w in zip(GRAD_NAMES, got, want):
        # sums over up to 1536-term products: the bound scales with each
        # gradient's largest magnitude
        w = np.asarray(w)
        _close(g.numpy(), w, atol=ATOL * max(1.0, np.abs(w).max()),
               name=name)
    assert np.all(got[0].numpy()[~mask] == 0.0)


# B2's tolerance on the card (chip_smoke.py BWD_REL): each gradient within
# 1e-4 of its largest magnitude
BWD_REL = 1e-4


def _tf32(a):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 of the 23 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, exact_a=False):
    """a @ b as B2's tensor-core products form it: hi/lo TF32 parts, the
    small terms first; an fp16 ``a`` is exact in TF32, so its lo is 0 and
    the product takes two terms, not three."""
    b_hi = _tf32(b)
    b_lo = _tf32(b - b_hi)
    if exact_a:
        assert torch.equal(_tf32(a), a)
        return a @ b_lo + a @ b_hi
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _b2_emulated(x, mask, w1, b1, v, bv, u, bu, w, bw, lse, c, d_bag,
                 d_logits, exact_x, splits=3):
    """B2's decomposition in f32 with every product split as on the card:
    H (K1, near-0 pre-activations as the plain route sums them); the
    gates, d_h, R and D_a (K2); X^T R and H^T D_a summed over
    ``splits`` row ranges in order (K3 and the reduce); R W1^T (K4)."""
    b, n, df = x.shape
    l = w1.shape[1]
    xf = x.reshape(b * n, df)
    pre = _split_mm(xf, w1, exact_x) + b1                    # [M, L]
    # within rounding of 0 the mask is the forward's: K1 recomputes those
    # pre-activations as the plain route sums them
    near = pre.abs() <= 2.0 ** -17 * (xf.norm(dim=1)[:, None]
                                      * w1.norm(dim=0)[None, :])
    h = torch.relu(torch.where(near, xf @ w1 + b1, pre))
    z = _split_mm(h, torch.cat([v, u], dim=1))               # [M, 2A]
    a = v.shape[1]
    gv = torch.tanh(z[:, :a] + bv)
    gu = torch.sigmoid(z[:, a:] + bu)
    g = (gv * gu).view(b, n, a)
    hb = h.view(b, n, l)
    valid = mask[..., None]
    p = torch.where(valid, torch.exp(g @ w + bw - lse[:, None, :]), 0.0)
    d_log = torch.where(valid, p * (hb @ d_bag.transpose(1, 2)
                                    - c[:, None, :])
                        + d_logits.transpose(1, 2), 0.0)     # [B, N, K]
    d_g = (d_log @ w.T).reshape(b * n, a)
    d_a = torch.cat([d_g * gu * (1 - gv * gv),
                     d_g * gv * gu * (1 - gu)], dim=1)       # [M, 2A]
    d_h = ((p @ d_bag).reshape(b * n, l)
           + _split_mm(d_a, torch.cat([v, u], dim=1).T))
    r = torch.where(h > 0, d_h, 0.0)                         # [M, L]
    bounds = np.linspace(0, b * n, splits + 1).astype(int)
    dw1 = dvu = 0.0
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        dw1 = dw1 + _split_mm(xf[r0:r1].T.contiguous(), r[r0:r1],
                              exact_x)
        dvu = dvu + _split_mm(h[r0:r1].T.contiguous(), d_a[r0:r1])
    dx = _split_mm(r, w1.T.contiguous()).view(b, n, df)
    return (dx, dw1, r.sum(0), dvu[:, :a], d_a[:, :a].sum(0), dvu[:, a:],
            d_a[:, a:].sum(0), g.reshape(b * n, a).T @ d_log.reshape(b * n, -1),
            d_log.sum(dim=(0, 1)))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(_tf32(a), want)
    # fp16 values pass unchanged (exact in TF32), and a split is nearly
    # exact: hi + lo leaves about 2**-22 of the value
    h = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float16)).float()
    assert torch.equal(_tf32(h), h)
    f = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(
        np.float32))
    hi = _tf32(f)
    rest = (f.double() - hi.double() - _tf32(f - hi).double()).abs()
    assert float((rest / f.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("df, l", sorted(set(PRETRAIN_DIMS.values())))
def test_split_tf32_decomposition_holds_bwd_rel(df, l, feats_dtype):
    # B2's split-TF32 products through its decomposition against the
    # float64 closed form, within BWD_REL of each gradient's max: dots of up
    # to 1536 terms, and 3000-row sums in 5 ranges
    feats, mask, ws, d_bag, d_logits = _inputs_at(12, df, l, b=2, n=1500)
    mask[0, :7] = False
    x = torch.from_numpy(feats).to(feats_dtype)
    m = torch.from_numpy(mask)
    w_t = _t(*ws)
    w64 = [t.double() for t in w_t]
    bag, logits = port._reference_batched(x.double(), m, *w64)
    mx, sm = port._softmax_stats(logits, m)
    lse = mx + torch.log(sm)
    d_bag64 = torch.from_numpy(d_bag).double()
    c = (d_bag64 * bag).sum(dim=2)
    want = port._fused_pool_bwd_stats(x.double(), m, *w64, lse, c, d_bag64,
                                      torch.from_numpy(d_logits).double())
    got = _b2_emulated(x.float(), m, *w_t, lse.float(), c.float(),
                       torch.from_numpy(d_bag), torch.from_numpy(d_logits),
                       exact_x=feats_dtype == torch.float16, splits=5)
    for name, g, w_ in zip(GRAD_NAMES, got, want):
        err = float((g.double() - w_).abs().max())
        assert err <= BWD_REL * float(w_.abs().max()), (name, err)
    assert bool((got[0][~m] == 0).all())


@pytest.mark.parametrize("m, df, l", [(65536, 384, 128), (65536, 512, 256),
                                      (65536, 1536, 768), (12297, 384, 128),
                                      (300, 384, 128), (1, 32, 128),
                                      (5998, 1536, 768)])
def test_wgrad_splits_cover_the_rows_in_whole_slices(m, df, l):
    s, rows = port._wgrad_splits(m, df, l, 132)
    assert s >= 1 and rows % 32 == 0
    assert (s - 1) * rows < m <= s * rows      # no empty range
    if m >= 65536:
        assert s > 1                           # ranges meet in the reduce
    sizes = [int(np.prod(shape)) for _, shape in port._grad_layout(df, l, 5)]
    assert sum(sizes) == df * l + l + 2 * (l * 128 + 128) + 128 * 5 + 5


def test_fused_pool_bwd_forms_lse_and_c_like_jax():
    feats, mask, ws, d_bag, d_logits = _inputs(1)
    jws = [jnp.asarray(w) for w in ws]
    bag, logits = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *jws, chunk=128,
        interpret=True)
    want = jax_pool._fused_pool_bwd(
        jnp.asarray(feats), jnp.asarray(mask), *jws, bag, logits,
        jnp.asarray(d_bag), jnp.asarray(d_logits), chunk=128, interpret=True)
    x, mk, b_, lg, db, dl = _t(feats, mask, bag, logits, d_bag, d_logits)
    got = port._fused_pool_bwd(x, mk, *_t(*ws), b_, lg, db, dl)
    for name, g, w in zip(GRAD_NAMES, got, want):
        _close(g.numpy(), w, name=name)


@pytest.mark.parametrize("k", [1, 5])
def test_grad_matches_jax_value_and_grad(k):
    feats, mask, ws, _, _ = _inputs(2, k=k)
    jmask = jnp.asarray(mask)

    def loss_fused(feats, *ws):
        return _loss_jax(*jax_pool.gated_attn_pool_grad(feats, jmask, *ws,
                                                        128))

    v_j, g_j = jax.value_and_grad(loss_fused, argnums=tuple(range(9)))(
        jnp.asarray(feats), *map(jnp.asarray, ws))
    leaves = [t.requires_grad_() for t in _t(feats, *ws)]
    loss = _loss_torch(*port.gated_attn_pool_grad(leaves[0],
                                                  torch.from_numpy(mask),
                                                  *leaves[1:]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    for name, t, w in zip(GRAD_NAMES, leaves, g_j):
        _close(t.grad.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL, name=name)


@pytest.mark.parametrize("feats_dtype", [torch.float32, torch.float16])
def test_grad_matches_autograd_through_reference(feats_dtype):
    feats, mask, ws, _, _ = _inputs(3)
    m = torch.from_numpy(mask)
    x = torch.from_numpy(feats).to(feats_dtype).requires_grad_()
    w_port = [t.requires_grad_() for t in _t(*ws)]
    w_ref = [t.detach().clone().requires_grad_() for t in w_port]
    x_ref = x.detach().float().requires_grad_()
    _loss_torch(*port.gated_attn_pool_grad(x, m, *w_port)).backward()
    _loss_torch(*port._reference_batched(x_ref, m, *w_ref)).backward()
    assert x.grad.dtype == feats_dtype
    _close(x.grad.float().numpy(), x_ref.grad.to(feats_dtype).float().numpy(),
           atol=GRAD_TOL, rtol=GRAD_TOL, name="d_feats")
    for name, a, b in zip(GRAD_NAMES[1:], w_port, w_ref):
        _close(a.grad.numpy(), b.grad.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
               name=name)


def test_gradcheck_float64():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 7, 4)).requires_grad_()
    m = torch.tensor([[1, 1, 0, 1, 1, 1, 0], [0] * 7], dtype=torch.bool)
    ws = [torch.from_numpy(rs.randn(*s) * 0.5).requires_grad_()
          for s in [(4, 3), (3,), (3, 2), (2,), (3, 2), (2,), (2, 2), (2,)]]
    assert torch.autograd.gradcheck(
        lambda x, *ws: port.gated_attn_pool_grad(x, m, *ws), (x, *ws))


def test_dx_is_skipped_when_feats_need_no_grad(monkeypatch):
    feats, mask, ws, _, _ = _inputs(5)
    asked = []
    real = port.fused_gated_attn_pool_bwd

    def spy(*args, need_dx=True):
        asked.append(need_dx)
        return real(*args, need_dx=need_dx)

    monkeypatch.setattr(port, "fused_gated_attn_pool_bwd", spy)
    x = torch.from_numpy(feats)
    w_t = [t.requires_grad_() for t in _t(*ws)]
    _loss_torch(*port.gated_attn_pool_grad(x, torch.from_numpy(mask),
                                           *w_t)).backward()
    assert asked == [False] and x.grad is None
    assert all(t.grad is not None for t in w_t)
    x.requires_grad_()
    _loss_torch(*port.gated_attn_pool_grad(x, torch.from_numpy(mask),
                                           *w_t)).backward()
    assert asked == [False, True] and x.grad is not None


def test_cpu_route_launches_no_kernel():
    feats, mask, ws, _, _ = _inputs(6)
    before = (port.fused_gated_attn_pool_batched.launches,
              port.fused_gated_attn_pool_bwd.launches)
    w_t = [t.requires_grad_() for t in _t(*ws)]
    _loss_torch(*port.gated_attn_pool_grad(torch.from_numpy(feats),
                                           torch.from_numpy(mask),
                                           *w_t)).backward()
    assert (port.fused_gated_attn_pool_batched.launches,
            port.fused_gated_attn_pool_bwd.launches) == before


@pytest.mark.parametrize("arg, shape, match", [
    ("lse", (1, 5), "lse must be"),
    ("c", (2, 4), "c must be"),
    ("d_bag", (2, 5, 64), "d_bag must be"),
    ("d_logits", (2, 5, 99), "d_logits must be"),
])
def test_bwd_arg_check_rejects_wrong_shapes(arg, shape, match):
    b, n, k = 2, 100, 5
    args = {"lse": torch.zeros(b, k), "c": torch.zeros(b, k),
            "d_bag": torch.zeros(b, k, 128), "d_logits": torch.zeros(b, k, n)}
    port._check_bwd_args(torch.zeros(b, n, 384), k, 128, **args)
    args[arg] = torch.zeros(*shape)
    with pytest.raises(ValueError, match=match):
        port._check_bwd_args(torch.zeros(b, n, 384), k, 128, **args)


def test_bare_forward_cpu_route_is_differentiable():
    # the bare forward's CPU route differentiates through its plain
    # version; its CUDA route refuses, as B1 alone has no backward
    feats, mask, ws, _, _ = _inputs(7)
    w_t = [t.requires_grad_() for t in _t(*ws)]
    bag, _ = port.fused_gated_attn_pool_batched(torch.from_numpy(feats),
                                                torch.from_numpy(mask), *w_t)
    assert bag.requires_grad


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B2 is CUDA C++ for sm_90a: needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("k", [1, 5])
def test_b2_matches_plain_on_card(cuda_device, feats_dtype, k):
    # serving width, a ragged N, B=3 with one all-masked bag; f32 on both
    # sides with TF32 off, so only the summation order differs
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(8)
    b, n, df = 3, 5000, 384
    x = torch.from_numpy(rs.randn(b, n, df).astype(np.float32)).to(
        cuda_device, feats_dtype)
    m = torch.from_numpy(rs.rand(b, n) < 0.9).to(cuda_device)
    m[1] = False
    ws = [torch.from_numpy(((rs.rand(*s) * 2 - 1) * 0.09).astype(np.float32))
          .to(cuda_device) for s in [(df, 128), (128,), (128, 128), (128,),
                                     (128, 128), (128,), (128, k), (k,)]]
    d_bag = torch.from_numpy(rs.randn(b, k, 128).astype(np.float32)).to(
        cuda_device)
    d_logits = torch.from_numpy(rs.randn(b, k, n).astype(np.float32)).to(
        cuda_device)
    with torch.no_grad():
        bag, _, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True)
        lse = mx + torch.log(s.clamp_min(1e-30))
        c = (d_bag * bag).sum(-1)
        before = port.fused_gated_attn_pool_bwd.launches
        got = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                             d_logits)
        again = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                               d_logits)
        torch.cuda.synchronize()
        assert port.fused_gated_attn_pool_bwd.launches == before + 2
        want = port._fused_pool_bwd_stats(x, m, *ws, lse, c, d_bag, d_logits)
    for name, g, w, g2 in zip(GRAD_NAMES, got, want, again):
        assert torch.equal(g, g2), f"{name} differs between two launches"
        # fp16 dx rounds to one fp16 ulp (2**-11 of the value)
        tol = 1e-3 if g.dtype == torch.float16 else 1e-4
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)
    assert bool((got[0][~m] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("df, l, k", [(512, 256, 5), (768, 384, 5),
                                      (1024, 512, 1), (1536, 768, 5),
                                      (1536, 768, 128)])
def test_b2_matches_plain_on_card_at_wider_l(cuda_device, feats_dtype, df, l,
                                             k):
    # the pretrain tags' widths (panels of 128 columns, longer products), a
    # ragged N, B=2 with a dead tail; two launches agree bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, mask, ws, d_bag, d_logits = _inputs_at(11, df, l, k=k, n=2999)
    x = torch.from_numpy(feats).to(cuda_device, feats_dtype)
    m, *rest = (t.to(cuda_device) for t in _t(mask, *ws, d_bag, d_logits))
    ws, d_bag, d_logits = rest[:8], rest[8], rest[9]
    with torch.no_grad():
        bag, _, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True)
        lse = mx + torch.log(s.clamp_min(1e-30))
        c = (d_bag * bag).sum(-1)
        got = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                             d_logits)
        again = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                               d_logits)
        torch.cuda.synchronize()
        want = port._fused_pool_bwd_stats(x, m, *ws, lse, c, d_bag, d_logits)
    for name, g, w, g2 in zip(GRAD_NAMES, got, want, again):
        assert torch.equal(g, g2), f"{name} differs between two launches"
        tol = 1e-3 if g.dtype == torch.float16 else 1e-4
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)
    assert bool((got[0][~m] == 0).all())


def _card_inputs(device, feats_dtype, b, n, df, l, k, seed):
    feats, mask, ws, d_bag, d_logits = _inputs_at(seed, df, l, k=k, b=b, n=n)
    x = torch.from_numpy(feats).to(device, feats_dtype)
    m, *rest = (t.to(device) for t in _t(mask, *ws, d_bag, d_logits))
    ws, d_bag, d_logits = rest[:8], rest[8], rest[9]
    with torch.no_grad():
        bag, _, mx, s = port.fused_gated_attn_pool_batched(
            x, m, *ws, return_stats=True)
    lse = mx + torch.log(s.clamp_min(1e-30))
    c = (d_bag * bag).sum(-1)
    return x, m, ws, lse, c, d_bag, d_logits


def _check_card_grads(got, want):
    for name, g, w in zip(GRAD_NAMES, got, want):
        tol = 1e-3 if g.dtype == torch.float16 else 1e-4
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("df, l", [(384, 128), (1536, 768)])
def test_b2_ragged_rows_and_an_all_masked_bag_on_card(cuda_device,
                                                      feats_dtype, df, l):
    # M = 3 x 4099 rows is a multiple of no tile (64, 32, 128) or slice;
    # one bag is all masked; K = 128; dx on
    torch.backends.cuda.matmul.allow_tf32 = False
    x, m, ws, lse, c, d_bag, d_logits = _card_inputs(
        cuda_device, feats_dtype, 3, 4099, df, l, 128, 13)
    m[1] = False
    with torch.no_grad():
        got = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                             d_logits)
        again = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                               d_logits)
        torch.cuda.synchronize()
        want = port._fused_pool_bwd_stats(x, m, *ws, lse, c, d_bag, d_logits)
    for name, g, g2 in zip(GRAD_NAMES, got, again):
        assert torch.equal(g, g2), f"{name} differs between two launches"
    _check_card_grads(got, want)
    assert bool((got[0][~m] == 0).all()) and bool((got[0][1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("df, l", [(384, 128), (512, 256)])
def test_b2_row_ranges_meet_in_the_reduce_on_card(cuda_device, monkeypatch,
                                                  df, l):
    # the weight gradients summed over S > 1 row ranges agree with one range
    # and with the plain closed form
    torch.backends.cuda.matmul.allow_tf32 = False
    x, m, ws, lse, c, d_bag, d_logits = _card_inputs(
        cuda_device, torch.float16, 2, 20000, df, l, 5, 14)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits, rows = port._wgrad_splits(2 * 20000, df, l, sms)
    assert splits > 1
    with torch.no_grad():
        many = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                              d_logits, need_dx=False)
        monkeypatch.setattr(port, "_wgrad_splits",
                            lambda m_, *a: (1, -(-m_ // 32) * 32))
        one = port.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag,
                                             d_logits, need_dx=False)
        torch.cuda.synchronize()
        want = port._fused_pool_bwd_stats(x, m, *ws, lse, c, d_bag, d_logits,
                                          need_dx=False)
    _check_card_grads(many[1:], want[1:])
    _check_card_grads(one[1:], want[1:])


def _plain_with_relu_mask(x, mask, w1, b1, v, bv, u, bu, w, bw, keep):
    """``port._reference_batched`` with relu's mask given: h = x W1 + b1
    where ``keep`` [B, N, L], else 0. (bag, logits)"""
    h = torch.where(keep, x @ w1 + b1, 0.0)
    logits = (torch.tanh(h @ v + bv) * torch.sigmoid(h @ u + bu)) @ w + bw
    valid = mask[..., None]
    logits = torch.where(valid, logits, port.NEG)
    p = torch.softmax(logits, dim=1) * valid
    p = p / p.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return p.transpose(1, 2) @ h, logits.transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("df, l", [(384, 128), (1536, 768)])
def test_step_on_the_stress_bag_on_card(cuda_device, feats_dtype, df, l):
    # one step through gated_attn_pool_grad, forward B1 and backward B2, on
    # a batch whose rows 0-5, 200 and n - 1 of bag 0 share one row x_0 and
    # b1 = -(x_0 W1): all their pre-activations lie within rounding of 0,
    # where relu's mask is decided by the order of the sum (B1 and B2 share
    # one, the H stage's; cuBLAS has another). So B1's mask may differ from
    # the plain forward's only within the recompute tolerance of 0, and the
    # step's gradients match autograd through the plain forward given B1's
    # mask, each within BWD_REL of its largest magnitude (an fp16 dx: one
    # fp16 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n = 2, 4099
    feats, mask, ws, _, _ = _inputs_at(19, df, l, b=b, n=n)
    feats[0, [1, 2, 3, 4, 5, 200, n - 1]] = feats[0, 0]
    mask[0, :6] = True
    x = torch.from_numpy(feats).to(cuda_device, feats_dtype)
    m = torch.from_numpy(mask).to(cuda_device)
    w_dev = [torch.from_numpy(w).to(cuda_device) for w in ws]
    w_dev[1] = -(x[0, 0].float() @ w_dev[0])
    work = {}
    with torch.no_grad():
        port.fused_gated_attn_pool_batched(x, m, *w_dev, _workspace=work)
        keep = (work["h"] > 0).view(b, n, l)
        xf = x.float()
        pre = xf @ w_dev[0] + w_dev[1]
        tol = 2.0 ** -17 * (xf.norm(dim=2)[..., None]
                            * w_dev[0].norm(dim=0))
        flip = keep != (pre > 0)
        assert bool((pre.abs()[flip] <= tol[flip]).all())
        assert int((pre[0, :6].abs() <= tol[0, :6]).sum()) == 6 * l
    leaves = [x.clone().requires_grad_()] + [w.clone().requires_grad_()
                                             for w in w_dev]
    ref = [xf.clone().requires_grad_()] + [w.clone().requires_grad_()
                                           for w in w_dev]
    before = (port.fused_gated_attn_pool_batched.launches,
              port.fused_gated_attn_pool_bwd.launches)
    _loss_torch(*port.gated_attn_pool_grad(leaves[0], m, *leaves[1:])
                ).backward()
    _loss_torch(*_plain_with_relu_mask(ref[0], m, *ref[1:], keep)).backward()
    torch.cuda.synchronize()
    assert (port.fused_gated_attn_pool_batched.launches,
            port.fused_gated_attn_pool_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    for name, got, want in zip(GRAD_NAMES, leaves, ref):
        g, w_ = got.grad.float(), want.grad
        tol_ = 1e-3 if got.dtype == torch.float16 else BWD_REL
        err = float((g - w_).abs().max())
        assert err <= tol_ * float(w_.abs().max()), (name, err)
    assert bool((leaves[0].grad[~m] == 0).all())


def test_plain_with_relu_mask_is_the_plain_forward_at_its_own_mask():
    # the stress step's reference: given relu's own mask it is the plain
    # forward
    feats, mask, ws, _, _ = _inputs(8)
    x, m, *w_t = _t(feats, mask, *ws)
    keep = (x @ w_t[0] + w_t[1]) > 0
    for got, want in zip(_plain_with_relu_mask(x, m, *w_t, keep),
                         port._reference_batched(x, m, *w_t)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
