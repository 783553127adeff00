"""The port's Nystrom core and positional embeddings (acmil_tpu_torch:
ops/nystrom.py, models/emb_position.py, the PPEG of models/transmil.py)
against the JAX package, on the same numpy inputs and the same weights.

Neither side reaches a Pallas kernel: the JAX Nystrom is plain ``jnp``.
Six Newton–Schulz iterations of [m, m] products amplify the packages'
different f32 summation orders (1e-7 in, ~1e-5 out), so the Nystrom
outputs are held to NY_ATOL/NY_RTOL, the JAX-vs-reference tolerance of
tests/test_reference_parity.py::test_nystrom_core_parity; the convs and the
sin-cos table, which have no inverse, to CONV_ATOL/CONV_RTOL. bf16 inputs
are held to BF16_ATOL/BF16_RTOL, the bf16-vs-f32 tolerance of
tests/test_model_zoo.py::test_transmil_bf16_matches_f32. Outputs are
compared at valid positions only (C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.models import emb_position as jax_emb
from acmil_tpu.models.transmil import PPEG as JaxPPEG
from acmil_tpu.ops import nystrom as jax_ny
from acmil_tpu_torch.models.emb_position import PEG, SINCOS, sincos_2d
from acmil_tpu_torch.models.transmil import PPEG
from acmil_tpu_torch.ops.nystrom import (depthwise_seq_conv,
                                         newton_schulz_pinv, nystrom_attention)

NY_ATOL, NY_RTOL = 5e-4, 5e-4
CONV_ATOL, CONV_RTOL = 1e-5, 1e-5
BF16_ATOL, BF16_RTOL = 0.05, 0.1


def _close(got, want, atol, rtol, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=name)


def _qkv(seed, b=2, h=2, n=64, dh=8):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, h, n, dh) * dh ** -0.5).astype(np.float32)
    k = rs.randn(b, h, n, dh).astype(np.float32)
    v = rs.randn(b, h, n, dh).astype(np.float32)
    return q, k, v


# jitted: eager JAX dispatches every op of the core separately, seconds a call
_jax_core = jax.jit(jax_ny.nystrom_attention, static_argnums=(4,),
                    static_argnames=("return_attn_rows", "attn_row_offset"))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the pseudo-inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [6, 12])
def test_pinv_matches_jax_and_is_a_pseudo_inverse(iters):
    """Diagonally dominant row-stochastic matrices (attn2's regime) and one
    far from it; the scale is per matrix, so a batch mixing the two inverts
    each as it would alone."""
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 16, 16) + 3.0 * np.eye(16)
    logits[2] = rs.randn(16, 16) * 4.0
    x = np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    want = np.asarray(jax_ny.newton_schulz_pinv(jnp.asarray(x), iters))
    got = newton_schulz_pinv(torch.from_numpy(x), iters)
    assert got.dtype == torch.float32
    _close(got, want, NY_ATOL, NY_RTOL)
    alone = newton_schulz_pinv(torch.from_numpy(x[:1]), iters)
    _close(got[:1], alone, 1e-6, 1e-6)
    if iters == 12:
        xzx = x[:2] @ got.numpy()[:2] @ x[:2]
        _close(xzx, x[:2], 5e-3, 5e-3)


def test_pinv_runs_in_f32_for_bf16_input():
    rs = np.random.RandomState(1)
    x = np.array(jax.nn.softmax(jnp.asarray(
        rs.randn(2, 8, 8) + 3 * np.eye(8), jnp.float32), -1))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = newton_schulz_pinv(xb)
    want = jax_ny.newton_schulz_pinv(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, np.asarray(want), NY_ATOL, NY_RTOL)


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------

def _mask(n, valid, b=2):
    mask = np.zeros((b, n), bool)
    for i, v in enumerate(valid):
        mask[i, :v] = True
    return mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows, offset", [(0, 0), (1, 0), (2, 5)])
def test_core_matches_jax(masked, rows, offset):
    q, k, v = _qkv(2, n=96)
    mask = _mask(96, (70, 9)) if masked else None
    want, want_rows = _jax_core(
        *_j(q, k, v), None if mask is None else jnp.asarray(mask), 8,
        return_attn_rows=rows, attn_row_offset=offset)
    got, got_rows = nystrom_attention(
        *_t(q, k, v), None if mask is None else torch.from_numpy(mask), 8,
        return_attn_rows=rows, attn_row_offset=offset)
    valid = np.ones((2, 96), bool) if mask is None else mask
    for i in range(2):
        _close(got[i][:, valid[i]], np.asarray(want)[i][:, valid[i]],
               NY_ATOL, NY_RTOL)
    if rows:
        assert got_rows.shape == (2, rows, 96)
        _close(got_rows, np.asarray(want_rows), NY_ATOL, NY_RTOL)
    else:
        assert got_rows is None and want_rows is None


def test_core_grads_match_jax():
    q, k, v = _qkv(3, n=64)
    mask = _mask(64, (50, 64))
    w = np.random.RandomState(4).randn(2, 2, 64, 8).astype(np.float32)
    wm = w * mask[:, None, :, None]

    def jloss(q, k, v):
        out, rows = jax_ny.nystrom_attention(q, k, v, jnp.asarray(mask), 8,
                                             return_attn_rows=1)
        return jnp.sum(out * wm) + jnp.sum(rows)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out, rows = nystrom_attention(tq, tk, tv, torch.from_numpy(mask), 8,
                                  return_attn_rows=1)
    (torch.sum(out * torch.from_numpy(wm)) + rows.sum()).backward()
    for g, w_ in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, np.asarray(w_), NY_ATOL, NY_RTOL)


def test_core_bf16_matches_jax_bf16():
    q, k, v = _qkv(5, n=64)
    mask = _mask(64, (64, 30))
    bf = [a.astype(jnp.bfloat16) for a in _j(q, k, v)]
    want, _ = _jax_core(*bf, jnp.asarray(mask), 8)
    tb = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    got, _ = nystrom_attention(*tb, torch.from_numpy(mask), 8)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    for i, n in enumerate((64, 30)):
        _close(got[i][:, :n], np.asarray(want)[i][:, :n], BF16_ATOL,
               BF16_RTOL)


def test_masked_slots_are_inert():
    """Garbage in masked slots changes no valid output
    (tests/test_nystrom.py::test_nystrom_mask_correctness)."""
    q, k, v = _qkv(6, b=1, n=64)
    mask = np.arange(64)[None] < 37

    def with_pads(t, val):
        return np.where(mask[:, None, :, None], t, val).astype(np.float32)

    m = torch.from_numpy(mask)
    a, _ = nystrom_attention(*_t(*(with_pads(t, 777.0) for t in (q, k, v))),
                             m, 8)
    b, _ = nystrom_attention(*_t(*(with_pads(t, -3.5) for t in (q, k, v))),
                             m, 8)
    assert torch.isfinite(a).all()
    _close(a[..., :37, :], b[..., :37, :], 1e-5, 1e-4)


def test_fully_masked_landmark_group_stays_finite():
    """Only landmark group 0 of 8 holds a valid row
    (tests/test_nystrom.py::test_nystrom_fully_masked_group); the JAX core
    gives the same finite output."""
    q, k, v = _qkv(7, b=1, n=64)
    mask = np.arange(64)[None] < 8
    got, _ = nystrom_attention(*_t(q, k, v), torch.from_numpy(mask), 8)
    want, _ = _jax_core(*_j(q, k, v), jnp.asarray(mask), 8)
    assert torch.isfinite(got).all()
    _close(got[..., :8, :], np.asarray(want)[..., :8, :], NY_ATOL, NY_RTOL)


def test_attention_rows_sum_to_about_one():
    """(tests/test_nystrom.py::test_nystrom_attn_rows)"""
    q, k, v = _qkv(8, b=1, n=32)
    _, rows = nystrom_attention(*_t(q, k, v), None, 8, return_attn_rows=1)
    assert rows.shape == (1, 1, 32)
    _close(rows.sum(-1), np.ones((1, 1)), 0.2, 0)


# ---------------------------------------------------------------------------
# the value conv and the positional embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ksize", [5, 33])
def test_depthwise_seq_conv_matches_jax(ksize):
    rs = np.random.RandomState(9)
    v = rs.randn(2, 3, 40, 8).astype(np.float32)
    w = rs.randn(3, ksize).astype(np.float32)
    got = depthwise_seq_conv(*_t(v, w))
    _close(got, np.asarray(jax_ny.depthwise_seq_conv(*_j(v, w))),
           CONV_ATOL, CONV_RTOL)
    # each head's output reads only its own head
    v2 = v.copy()
    v2[:, 1:] = 0.0
    _close(depthwise_seq_conv(*_t(v2, w))[:, 0], got[:, 0], 1e-6, 1e-6)


def _conv_params(rs, c, k):
    return ((rs.randn(c, 1, k, k) * 0.2).astype(np.float32),
            (rs.randn(c) * 0.2).astype(np.float32))


def test_ppeg_matches_jax():
    rs = np.random.RandomState(10)
    c, gh, gw = 16, 8, 4
    x = rs.randn(2, 1 + gh * gw, c).astype(np.float32)
    params = {}
    for k in (7, 5, 3):
        params[f"proj{k}"], params[f"proj{k}_b"] = _conv_params(rs, c, k)
    want = JaxPPEG(c).apply({"params": params}, jnp.asarray(x), gh, gw)
    mod = PPEG(c)
    sd = {}
    for name, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
        sd[f"{name}.weight"] = torch.from_numpy(params[f"proj{k}"])
        sd[f"{name}.bias"] = torch.from_numpy(params[f"proj{k}_b"])
    mod.load_state_dict(sd)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), gh, gw)
    _close(got, np.asarray(want), CONV_ATOL, CONV_RTOL)
    assert torch.equal(got[:, 0], torch.from_numpy(x[:, 0]))


def test_peg_matches_jax():
    rs = np.random.RandomState(11)
    c, gh, gw = 8, 4, 4
    x = rs.randn(2, gh * gw, c).astype(np.float32)
    w, b = _conv_params(rs, c, 7)
    want = jax_emb.PEG(c).apply({"params": {"proj": w, "proj_b": b}},
                                jnp.asarray(x), gh, gw)
    mod = PEG(c)
    mod.load_state_dict({"proj.weight": torch.from_numpy(w),
                         "proj.bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x), gh, gw)
    _close(got, np.asarray(want), CONV_ATOL, CONV_RTOL)


@pytest.mark.parametrize("dim, gh, gw", [(8, 4, 4), (32, 16, 8), (64, 7, 7)])
def test_sincos_matches_jax(dim, gh, gw):
    np.testing.assert_array_equal(sincos_2d(dim, gh, gw),
                                  jax_emb.sincos_2d(dim, gh, gw))
    x = np.random.RandomState(12).randn(1, gh * gw, dim).astype(np.float32)
    want = jax_emb.SINCOS(dim).apply({}, jnp.asarray(x), gh, gw)
    got = SINCOS(dim)(torch.from_numpy(x), gh, gw)
    _close(got, np.asarray(want), 0, 0)
    assert not list(SINCOS(dim).parameters())
