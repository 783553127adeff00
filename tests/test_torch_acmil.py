"""The port's ACMIL_GA / ABMIL (acmil_tpu_torch/models) against the flax
models of acmil_tpu, on the same numpy bags and the same weights.

Weights come from ``model.init`` and cross with
``acmil_tpu_torch.models.convert.from_jax_params``; the reverse direction is
the repo's own ``scripts/import_torch_checkpoint.py::convert_acmil_ga``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.models.acmil import ABMIL as JaxABMIL
from acmil_tpu.models.acmil import ACMIL_GA as JaxACMIL_GA
from acmil_tpu.models.fast import abmil_infer as jax_abmil_infer
from acmil_tpu.models.fast import acmil_ga_apply_batched as jax_apply_batched
from acmil_tpu.models.fast import acmil_ga_infer as jax_ga_infer
from acmil_tpu.models.fast import derive_stkim_rng as jax_derive_stkim_rng
from acmil_tpu.ops import masked as jax_masked
from acmil_tpu_torch.models import ABMIL, ACMIL_GA
from acmil_tpu_torch.models.common import torch_linear_init_
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.models.fast import (abmil_infer, acmil_ga_apply_batched,
                                         acmil_ga_infer)
from acmil_tpu_torch.ops import masked
from scripts.import_torch_checkpoint import convert_acmil_ga

# float32 on both sides; XLA and torch sum the ~32-term dot products and
# the softmax in different orders, so agreement is to f32 rounding
ATOL, RTOL = 1e-5, 1e-4
D_FEAT, D_INNER, N_CLASS = 32, 16, 3


def _bag(seed, b=2, n=300):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D_FEAT).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, 200:] = False
    return feats, mask


def _pair(arch, seed=0, n_token=5):
    """A flax model with params from ``init`` and the port's model holding
    the same weights."""
    if arch == "ga":
        jm = JaxACMIL_GA(n_class=N_CLASS, d_inner=D_INNER, n_token=n_token)
        tm = ACMIL_GA(N_CLASS, d_feat=D_FEAT, d_inner=D_INNER,
                      n_token=n_token)
    else:
        jm = JaxABMIL(n_class=N_CLASS, d_inner=D_INNER)
        tm = ABMIL(N_CLASS, d_feat=D_FEAT, d_inner=D_INNER)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8, D_FEAT)), jnp.ones((1, 8), bool))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm.load_state_dict(from_jax_params(params, arch))
    return jm, params, tm.eval()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _valid(mask, logits):
    return np.broadcast_to(mask[:, None, :], logits.shape)


@pytest.mark.parametrize("n_token", [1, 5])
def test_acmil_ga_forward_matches_flax(n_token):
    jm, params, tm = _pair("ga", n_token=n_token)
    feats, mask = _bag(0)
    sub_j, slide_j, a_j = jm.apply({"params": params}, jnp.asarray(feats),
                                   jnp.asarray(mask), deterministic=True)
    with torch.no_grad():
        sub, slide, a = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    _close(sub.numpy(), sub_j)
    _close(slide.numpy(), slide_j)
    v = _valid(mask, a.numpy())
    _close(a.numpy()[v], np.asarray(a_j)[v])


def test_abmil_forward_matches_flax():
    jm, params, tm = _pair("abmil")
    feats, mask = _bag(1)
    logits_j, a_j = jm.apply({"params": params}, jnp.asarray(feats),
                             jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        logits, a = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                       return_attn=True)
    _close(logits.numpy(), logits_j)
    v = _valid(mask, a.numpy())
    _close(a.numpy()[v], np.asarray(a_j)[v])


def test_fp16_bag_matches_f32_bag():
    _, _, tm = _pair("ga")
    feats, mask = _bag(2)
    with torch.no_grad():
        half = tm(torch.from_numpy(feats).half(), torch.from_numpy(mask))
        full = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    for h, f in zip(half, full):
        torch.testing.assert_close(h, f, atol=0, rtol=0)


@pytest.mark.parametrize("n_token", [1, 5])
def test_fused_route_matches_jax_fused_route(n_token):
    _, params, tm = _pair("ga", seed=3, n_token=n_token)
    feats, mask = _bag(3)
    want = jax_apply_batched(jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(feats), jnp.asarray(mask), chunk=128)
    with torch.no_grad():
        got = acmil_ga_apply_batched(tm, torch.from_numpy(feats).half(),
                                     torch.from_numpy(mask))
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    v = _valid(mask, got[2].numpy())
    _close(got[2].numpy()[v], np.asarray(want[2])[v])
    assert np.all(got[2].numpy()[~v] == -1e30)


def test_fused_route_at_natural_supervised_widths_matches_jax():
    # the natural_supervised configs (camelyon, bracs, lct): D_feat 512,
    # D_inner 256, the width whose B1 launch raised on the card before
    from acmil_tpu_torch.config import PRETRAIN_DIMS

    df, l = PRETRAIN_DIMS["natural_supervised"]
    jm = JaxACMIL_GA(n_class=N_CLASS, d_inner=l, n_token=5)
    tm = ACMIL_GA(N_CLASS, d_feat=df, d_inner=l, n_token=5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(6), jnp.zeros((1, 8, df)),
        jnp.ones((1, 8), bool))["params"])
    tm.load_state_dict(from_jax_params(params, "ga"))
    rs = np.random.RandomState(6)
    feats = rs.randn(2, 300, df).astype(np.float16).astype(np.float32)
    mask = rs.rand(2, 300) < 0.8
    mask[-1, 200:] = False
    want = jax_apply_batched(jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(feats), jnp.asarray(mask), chunk=128)
    with torch.no_grad():
        got = acmil_ga_apply_batched(tm.eval(), torch.from_numpy(feats).half(),
                                     torch.from_numpy(mask))
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    v = _valid(mask, got[2].numpy())
    _close(got[2].numpy()[v], np.asarray(want[2])[v])


def test_fused_route_matches_plain_forward():
    _, _, tm = _pair("ga", seed=4)
    feats, mask = _bag(4)
    x, m = torch.from_numpy(feats), torch.from_numpy(mask)
    with torch.no_grad():
        fused = acmil_ga_apply_batched(tm, x, m)
        plain = tm(x, m)
    torch.testing.assert_close(fused[0], plain[0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(fused[1], plain[1], atol=ATOL, rtol=RTOL)


def test_single_bag_infer_matches_jax():
    _, params, tm = _pair("ga", seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    feats, mask = _bag(5, b=1)
    want = jax_ga_infer(jparams, jnp.asarray(feats[0]), jnp.asarray(mask[0]),
                        chunk=128, interpret=True)
    with torch.no_grad():
        got = acmil_ga_infer(tm, torch.from_numpy(feats[0]),
                             torch.from_numpy(mask[0]))
    for g, w in zip(got[:2], want[:2]):
        _close(g.numpy(), w)
    _close(got[2].numpy()[:, mask[0]], np.asarray(want[2])[:, mask[0]])

    _, aparams, am = _pair("abmil", seed=5)
    want = jax_abmil_infer(jax.tree_util.tree_map(jnp.asarray, aparams),
                           jnp.asarray(feats[0]), jnp.asarray(mask[0]),
                           chunk=128, interpret=True)
    with torch.no_grad():
        got = abmil_infer(am, torch.from_numpy(feats[0]),
                          torch.from_numpy(mask[0]))
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy()[:, mask[0]], np.asarray(want[1])[:, mask[0]])


@pytest.mark.parametrize("arch", ["ga", "abmil"])
def test_convert_round_trips_exactly(arch):
    _, params, tm = _pair(arch, seed=6)
    back = convert_acmil_ga(tm.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)


def test_state_dict_uses_reference_names():
    tm = ACMIL_GA(2, d_feat=384, d_inner=128, n_token=2)
    assert set(tm.state_dict()) == {
        "dimreduction.fc1.weight",
        "attention.attention_V.0.weight", "attention.attention_V.0.bias",
        "attention.attention_U.0.weight", "attention.attention_U.0.bias",
        "attention.attention_weights.weight",
        "attention.attention_weights.bias",
        "classifier.0.fc.weight", "classifier.0.fc.bias",
        "classifier.1.fc.weight", "classifier.1.fc.bias",
        "Slide_classifier.fc.weight", "Slide_classifier.fc.bias"}
    assert "classifier.fc.weight" in ABMIL(2).state_dict()


def test_seeded_init_is_torch_default_and_reproducible():
    def make(seed):
        return torch_linear_init_(ACMIL_GA(2, n_token=5),
                                  torch.Generator().manual_seed(seed))

    a, b, c = make(7), make(7), make(8)
    for (name, p), q, r in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(p, q, atol=0, rtol=0)
        assert not torch.equal(p, r), name
    w = a.dimreduction.fc1.weight.detach()
    assert float(w.abs().max()) <= 384 ** -0.5


def test_stkim_training_forward_is_not_ported_yet():
    """The name predates the STKIM training forward; the test now holds
    that forward against flax on the same uniforms, on both routes, and
    checks that a generator draws the uniforms when none are given."""
    jm = JaxACMIL_GA(n_class=N_CLASS, d_inner=D_INNER, n_token=5,
                     n_masked_patch=10, mask_drop=0.6)
    tm = ACMIL_GA(N_CLASS, d_feat=D_FEAT, d_inner=D_INNER, n_token=5,
                  n_masked_patch=10, mask_drop=0.6)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(8), jnp.zeros((1, 8, D_FEAT)),
        jnp.ones((1, 8), bool))["params"])
    tm.load_state_dict(from_jax_params(params, "ga"))
    feats, mask = _bag(8)
    key = jax.random.PRNGKey(9)
    sub_j, slide_j, a_j = jm.apply({"params": params}, jnp.asarray(feats),
                                   jnp.asarray(mask), deterministic=False,
                                   rngs={"stkim": key})
    u = torch.from_numpy(np.array(jax.random.uniform(
        jax_derive_stkim_rng(key), a_j.shape, dtype=jnp.float32)))
    x, m = torch.from_numpy(feats), torch.from_numpy(mask)
    with torch.no_grad():
        plain = tm(x, m, deterministic=False, stkim_u=u)
        fused = acmil_ga_apply_batched(tm, x, m, stkim_u=u, n_masked_patch=10,
                                       mask_drop=0.6)
        eval_ = tm(x, m)
        drawn = tm(x, m, deterministic=False,
                   stkim_generator=torch.Generator().manual_seed(0))
    for got in (plain, fused):
        _close(got[0].numpy(), sub_j)
        _close(got[1].numpy(), slide_j)
    v = _valid(mask, plain[2].numpy())
    for got in (plain, fused):
        _close(got[2].numpy()[v], np.asarray(a_j)[v])
        np.testing.assert_array_equal(got[2].numpy()[v] == masked.NEG_INF,
                                      np.asarray(a_j)[v] == masked.NEG_INF)
    # STKIM filled some top logits: training and eval forwards differ
    assert (plain[2] == masked.NEG_INF).any() and not torch.equal(plain[1],
                                                                  eval_[1])
    assert (drawn[2] == masked.NEG_INF).sum() == (plain[2] == masked.NEG_INF).sum()


@pytest.mark.parametrize("op", ["masked_softmax", "softmax_one",
                                "masked_mean", "masked_max", "masked_fill"])
def test_masked_ops_match_jax(op):
    rs = np.random.RandomState(9)
    x = rs.randn(2, 3, 40).astype(np.float32) * 3
    mask = rs.rand(2, 1, 40) < 0.7
    mask[1] = False                         # a fully masked row
    if op in ("masked_mean", "masked_max"):
        x, mask = x.transpose(0, 2, 1).copy(), mask[:, 0]   # [B, N, D], [B, N]
    want = getattr(jax_masked, op)(jnp.asarray(x), jnp.asarray(mask))
    got = getattr(masked, op)(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got.numpy(), want)
    assert not np.isnan(got.numpy()).any()
