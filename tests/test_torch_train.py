"""The port's training slice (acmil_tpu_torch: STKIM, losses, schedule,
AdamW step, Step3 trainer, checkpoints) against the JAX package, on the same
numpy inputs and the same weights.

STKIM's uniforms cannot be drawn alike in both packages, so the port gets
the very draws the JAX side makes: ``jax.random.uniform`` on the key the
JAX code derives. On the CPU the port's pooling runs the plain versions of
kernels B1 and B2 and the JAX side runs its Pallas kernels in interpret mode.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from acmil_tpu.cli import train as jax_cli
from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine import losses as jax_losses
from acmil_tpu.engine import make_train_step as jax_make_step
from acmil_tpu.engine.schedules import half_cosine_schedule as jax_schedule
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models import fast as jax_fast
from acmil_tpu.ops import attn_pool as jax_pool
from acmil_tpu.ops import masked as jax_masked
from acmil_tpu_torch.cli import step3_acmil
from acmil_tpu_torch.cli import train as port_cli
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import build_hdf5_feat_dataset, write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_train_step)
from acmil_tpu_torch.engine import losses
from acmil_tpu_torch.engine.schedules import half_cosine_schedule
from acmil_tpu_torch.engine.train import clip_by_global_norm_, global_norm
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.models import fast
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops import masked
from tests.conftest import make_synthetic_bags

D, L_DIM, N_CLASS = 32, 16, 2
# float32 on both sides; torch and XLA sum in other orders
ATOL, RTOL = 1e-5, 1e-4
# one step's loss and gradients, fused route: the JAX package's own bounds
# for its fused step against model.apply (tests/test_attn_pool.py)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 3e-3, 3e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bag_arrays(seed, b=2, n=300, dead_tail=True, d=D):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, d).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    if dead_tail:
        mask[-1, 200:] = False
    return feats, mask, rs.randint(0, N_CLASS, b)


def _bags(feats, mask, labels):
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.zeros(feats.shape[:2] + (2,), jnp.int32),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.zeros(feats.shape[:2] + (2,), dtype=torch.int32),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _confs(**kw):
    d = dict(n_class=N_CLASS, D_feat=D, D_inner=L_DIM, arch="ga", n_token=5,
             n_masked_patch=10, mask_drop=0.6, lr=1e-3, train_epoch=2, seed=0)
    d.update(kw)
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _models(jconf, conf, seed=0):
    """The flax model with params from ``init`` and the port's model with
    the same weights."""
    jm, _ = jax_build_model(jconf)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8, conf.D_feat)),
                     jnp.ones((1, 8), bool))["params"]
    tm, _ = build_mil_model(conf)
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "ga"))
    return jm, params, tm


def _stkim_u(key, shape):
    """The uniforms the JAX STKIM draws from ``key``."""
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, dtype=jnp.float32)))


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# STKIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_masked_patch, mask_drop, with_mask", [
    (10, 0.6, True), (4, 1.0, True), (10, 0.6, False), (3, 0.5, True),
    (10, 0.0, True)])
def test_stkim_drop_matches_jax(n_masked_patch, mask_drop, with_mask):
    rs = np.random.RandomState(1)
    b, k, n = 3, 5, 40
    logits = rs.randn(b, k, n).astype(np.float32)
    mask = rs.rand(b, 1, n) < 0.7
    mask[1, 0, 3:] = False              # under k valid: the valid-count clamp
    mask[2] = False                     # all masked
    key = jax.random.PRNGKey(7)
    m_j = jnp.asarray(mask) if with_mask else None
    drop_j, idx_j = jax_masked.stkim_drop(key, jnp.asarray(logits),
                                          n_masked_patch, mask_drop, m_j)
    m_t = torch.from_numpy(mask) if with_mask else None
    drop, idx = masked.stkim_drop(torch.from_numpy(logits), n_masked_patch,
                                  mask_drop, m_t,
                                  u=_stkim_u(key, logits.shape))
    if drop_j is None:
        assert drop is None and idx is None
        return
    np.testing.assert_array_equal(drop.numpy(), np.asarray(drop_j))
    # the top-k agree where they hold valid patches; past those both pick
    # masked slots, whose order among equal fill values is arbitrary
    idx_j = np.asarray(idx_j)
    valid = (np.take_along_axis(np.broadcast_to(mask, logits.shape), idx_j, -1)
             if with_mask else np.ones(idx_j.shape, bool))
    np.testing.assert_array_equal(idx.numpy()[valid], idx_j[valid])
    if with_mask:
        assert not np.take_along_axis(np.broadcast_to(mask, logits.shape),
                                      idx.numpy(), -1)[~valid].any()
    if with_mask:
        # a bag with fewer valid patches than k drops floor(n_valid *
        # mask_drop) of them, not floor(k * mask_drop)
        n_valid = int(mask[1].sum())
        assert n_valid < n_masked_patch
        want = int(np.float32(n_valid) * np.float32(mask_drop))
        assert (drop.numpy()[1].sum(axis=-1) == want).all()
        assert not drop.numpy()[2].any()
    filled = masked.stkim_mask(torch.from_numpy(logits), n_masked_patch,
                               mask_drop, m_t, u=_stkim_u(key, logits.shape))
    want_filled = jax_masked.stkim_mask(key, jnp.asarray(logits),
                                        n_masked_patch, mask_drop, m_j)
    np.testing.assert_array_equal(filled.numpy(), np.asarray(want_filled))


def test_stkim_draws_come_from_the_generator():
    logits = torch.randn(2, 5, 50)
    draw = lambda seed: masked.stkim_drop(
        logits, 10, 0.6, generator=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    with pytest.raises(ValueError, match="u must have"):
        masked.stkim_drop(logits, 10, 0.6, u=torch.rand(2, 5, 49))


def test_masked_topk_mask_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 30).astype(np.float32)
    mask = rs.rand(2, 1, 30) < 0.6
    got = masked.masked_topk_mask(torch.from_numpy(x), 5,
                                  torch.from_numpy(mask))
    want = jax_masked.masked_topk_mask(jnp.asarray(x), 5, jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stkim_case(extreme):
    """tests/test_attn_pool.py's fixtures: peaked logits, or a logit gap
    wide enough that dropping the top-k leaves under 1e-5 of the mass."""
    if extreme:
        rs, (b, n, df, l, a, k) = np.random.RandomState(11), (1, 256, 16, 8, 8, 3)
        scales, nm, md, key = (0.3, 0.0, 1.0, 0.1, 1.0, 0.1, 40.0, 0.1), 4, 1.0, 3
        mask = rs.rand(b, n) < 0.9
    else:
        rs, (b, n, df, l, a, k) = np.random.RandomState(5), (2, 512, 32, 16, 16, 4)
        scales, nm, md, key = (0.3, 0.0, 0.5, 0.1, 0.5, 0.1, 3.0, 0.1), 8, 0.5, 9
        mask = rs.rand(b, n) < 0.8
    feats = rs.randn(b, n, df).astype(np.float32)
    shapes = [(df, l), (l,), (l, a), (a,), (l, a), (a,), (a, k), (k,)]
    ws = [(rs.randn(*s) * sc).astype(np.float32) for s, sc in zip(shapes,
                                                                  scales)]
    return feats, mask, ws, nm, md, jax.random.PRNGKey(key)


@pytest.mark.parametrize("extreme", [False, True])
def test_stkim_correct_matches_jax(extreme, monkeypatch):
    feats, mask, ws, nm, md, key = _stkim_case(extreme)
    jws = [jnp.asarray(w) for w in ws]
    bag, logits = jax_pool.fused_gated_attn_pool_batched(
        jnp.asarray(feats), jnp.asarray(mask), *jws, chunk=128,
        interpret=True)
    want_bag, want_a = jax_fast._stkim_correct(
        bag, logits, jnp.asarray(feats), jnp.asarray(mask), jws[0], key, nm,
        md)
    # which branch the port takes: the exact recompute runs the
    # dim-reduction GEMM over every patch, [B, N, Df] @ [Df, L]
    shapes = []
    real_relu = torch.relu
    monkeypatch.setattr(torch, "relu",
                        lambda t: shapes.append(tuple(t.shape)) or real_relu(t))
    got_bag, got_a = fast._stkim_correct(
        torch.from_numpy(np.array(bag)), torch.from_numpy(np.array(logits)),
        torch.from_numpy(feats), torch.from_numpy(mask),
        torch.from_numpy(ws[0]), nm, md, u=_stkim_u(key, logits.shape))
    exact = feats.shape[:2] + (ws[0].shape[1],) in shapes
    assert exact == extreme
    _close(got_bag.numpy(), want_bag, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("n_token", [1, 5])
def test_plain_stkim_forward_matches_flax(n_token):
    jconf, conf = _confs(n_token=n_token)
    jm, params, tm = _models(jconf, conf, seed=1)
    feats, mask, _ = _bag_arrays(3)
    key = jax.random.PRNGKey(5)
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                    deterministic=False, rngs={"stkim": key})
    u = _stkim_u(jax_fast.derive_stkim_rng(key), (2, n_token, feats.shape[1]))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                 deterministic=False, stkim_u=u)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    v = np.broadcast_to(mask[:, None, :], got[2].shape)
    _close(got[2].numpy()[v], np.asarray(want[2])[v])


# ---------------------------------------------------------------------------
# Losses, schedule, clip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_token", [1, 5])
def test_acmil_loss_matches_jax(n_token):
    rs = np.random.RandomState(4)
    b, n = 3, 50
    sub = rs.randn(b, n_token, N_CLASS).astype(np.float32)
    slide = rs.randn(b, N_CLASS).astype(np.float32)
    attn = (rs.randn(b, n_token, n) * 3).astype(np.float32)
    labels = rs.randint(0, N_CLASS, b)
    mask = rs.rand(b, n) < 0.8
    mask[-1] = False                                 # a padded batch row
    valid = mask.any(axis=1)
    total_j, parts_j = jax_losses.acmil_loss(
        jnp.asarray(sub), jnp.asarray(slide), jnp.asarray(attn),
        jnp.asarray(labels), jnp.asarray(mask), n_token, jnp.asarray(valid))
    total, parts = losses.acmil_loss(
        *map(torch.from_numpy, (sub, slide, attn, labels, mask)), n_token,
        torch.from_numpy(valid))
    _close(total.numpy(), total_j)
    for name in ("sub_loss", "slide_loss", "diff_loss"):
        _close(parts[name].numpy(), parts_j[name], name=name)
    _close(losses.cross_entropy(torch.from_numpy(slide),
                                torch.from_numpy(labels)).numpy(),
           jax_losses.cross_entropy(jnp.asarray(slide), jnp.asarray(labels)))


@pytest.mark.parametrize("warmup", [0, 2])
def test_half_cosine_schedule_matches_jax(warmup):
    args = (1e-4, 1e-6, 10, warmup, 7)
    got = half_cosine_schedule(*args)
    want = jax_schedule(*args)
    steps = np.arange(0, 71)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               np.asarray(want(jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rs = np.random.RandomState(5)
    grads = [rs.randn(*s).astype(np.float32) for s in [(8, 3), (3,), (5, 5)]]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = global_norm(got)
    _close(norm.numpy(), optax.global_norm([jnp.asarray(g) for g in grads]))
    clip_by_global_norm_(got, max_norm, norm)
    for g, w in zip(got, want):
        _close(g.numpy(), w, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# One step, several steps, the Step3 trainer
# ---------------------------------------------------------------------------

def _torch_grads(model):
    """Each parameter's gradient; zeros where the loss does not reach it,
    as JAX gives them."""
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


def _one_step_matches_jax(stkim, n_token, d=D, l=L_DIM):
    """One fused step's loss and every gradient against the JAX package's
    ``value_and_grad`` of its fused step, from the same weights."""
    kw = {} if stkim else dict(n_masked_patch=0, mask_drop=0.0)
    jconf, conf = _confs(n_token=n_token, D_feat=d, D_inner=l, **kw)
    jm, params, tm = _models(jconf, conf, seed=2)
    jb, tb = _bags(*_bag_arrays(6, d=d))
    jfam, fam = jax_get_family("acmil"), get_family("acmil")
    jconf_d, conf_d = jfam.conf_dict(jconf), fam.conf_dict(conf)
    assert jconf_d["fused"] and conf_d["fused"]
    key = jax.random.PRNGKey(8)

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jb, {"stkim": key,
                                                   "dropout": key}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)[0]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    u = (_stkim_u(jax_fast.derive_stkim_rng(key), (2, n_token, 300))
         if stkim else None)
    out = fam.train_outputs(tm, tb, conf_d, stkim_u=u)
    loss, _ = fam.loss(out, tb, tb.mask.any(dim=1), conf_d)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, grads_j), "ga")
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL,
               rtol=GRAD_RTOL, name=name)


@pytest.mark.parametrize("stkim, n_token", [(False, 5), (True, 5), (False, 1)])
def test_one_step_loss_and_grads_match_jax(stkim, n_token):
    # n_token 1 without STKIM is the ABMIL recipe
    _one_step_matches_jax(stkim, n_token)


def test_one_step_at_natural_supervised_widths_matches_jax():
    # the ACMIL recipe (STKIM on) at the natural_supervised configs'
    # widths, D_feat 512 and D_inner 256: kernels B1 and B2 at L = 256 on
    # the card, their plain versions here
    from acmil_tpu_torch.config import PRETRAIN_DIMS

    _one_step_matches_jax(True, 5, *PRETRAIN_DIMS["natural_supervised"])


def test_fused_and_plain_routes_agree_on_a_step():
    jconf, conf = _confs()
    _, _, tm = _models(jconf, conf, seed=3)
    _, tb = _bags(*_bag_arrays(7))
    u = torch.rand(2, 5, 300, generator=torch.Generator().manual_seed(0))
    grads = []
    for fused in (True, False):
        conf.extra["fused_train"] = fused
        fam = get_family("acmil")
        conf_d = fam.conf_dict(conf)
        tm.zero_grad()
        loss, _ = fam.loss(fam.train_outputs(tm, tb, conf_d, stkim_u=u), tb,
                           tb.mask.any(dim=1), conf_d)
        loss.backward()
        grads.append((loss.item(), _torch_grads(tm)))
    (l0, g0), (l1, g1) = grads
    np.testing.assert_allclose(l0, l1, rtol=LOSS_RTOL)
    for name in g0:
        _close(g0[name], g1[name], atol=GRAD_ATOL, rtol=GRAD_RTOL, name=name)


def test_five_adamw_steps_match_jax():
    """Per-step losses and final parameters after five fused steps over
    three bags, STKIM on with the JAX side's draws. Adam divides each
    update by sqrt(v): where a gradient component is tiny, rounding noise
    moves it by up to lr per step, so parameters agree to 5 * lr = 5e-3
    absolute while the losses agree to 1e-4 relative."""
    jconf, conf = _confs(train_epoch=2)
    steps_per_epoch = 3
    jm, _ = jax_build_model(jconf)
    arrays = [_bag_arrays(10 + i, b=1 + i % 2, n=120 + 90 * i,
                          dead_tail=i == 1) for i in range(3)]
    bags = [_bags(*a) for a in arrays]
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], steps_per_epoch)
    tm, _ = build_mil_model(conf)
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), "ga"))
    state = create_train_state(tm, conf, steps_per_epoch)
    jstep = jax_make_step(jm, jconf, "acmil")
    step = make_train_step(tm, conf, "acmil")
    for i in range(5):
        jb, tb = bags[i % 3]
        s_rng, _ = jax.random.split(jax.random.fold_in(rng, i))
        shape = (tb.feats.shape[0], 5, tb.feats.shape[1])
        u = _stkim_u(jax_fast.derive_stkim_rng(s_rng), shape)
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb, stkim_u=u)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(aux["grad_norm"]),
                                   float(jaux["grad_norm"]), rtol=1e-3)
    assert state.step == int(jstate.step) == 5
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                           "ga")
    for name, p in tm.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), atol=5 * conf.lr,
               rtol=0, name=name)


def test_unreached_parameters_decay_as_in_optax():
    # at n_token 1 the loss does not reach the branch classifier; optax
    # still applies weight decay to it (zero moments, update -lr*wd*p)
    _, conf = _confs(n_token=1, n_masked_patch=0, mask_drop=0.0, wd=0.1)
    tm, _ = build_mil_model(conf)
    _, tb = _bags(*_bag_arrays(12))
    head = tm.classifier[0].fc.weight
    before = head.detach().clone()
    state = create_train_state(tm, conf, 4)
    make_train_step(tm, conf, "acmil")(state, tb)
    lr = half_cosine_schedule(conf.lr, conf.min_lr, conf.train_epoch,
                              conf.warmup_epoch, 4)(0)
    torch.testing.assert_close(head.detach(), before * (1 - lr * conf.wd),
                               atol=0, rtol=1e-6)
    assert not torch.equal(head.detach(), before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small H5 dump with a frozen split file, and the same bags as a
    torch feature file."""
    d = tmp_path_factory.mktemp("train")
    slides = make_synthetic_bags(n_slides=12, d=D, seed=3, min_len=40,
                                 max_len=250)
    write_feature_h5(str(d / "patch_feats_pretrain_medical_ssl.h5"), slides)
    write_feature_pt(str(d / "pt" / "patch_feats_pretrain_medical_ssl.pt"),
                     slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:8], "val_names": names[8:10],
                   "test_names": names[10:]}, f)
    return d, slides


def _run_conf(d, tag, **kw):
    out = dict(dataset="camelyon", n_class=N_CLASS, D_feat=D, D_inner=L_DIM,
               arch="ga", n_token=3, n_masked_patch=0, mask_drop=0.0,
               lr=1e-3, train_epoch=2, min_bucket=256, seed=0,
               data_dir=str(d), split_dir=str(d / "splits"),
               ckpt_dir=str(d / tag / "ckpt"), log_dir=str(d / tag / "log"))
    out.update(kw)
    return out


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "_config" not in r]


def test_run_training_matches_jax(corpus, monkeypatch):
    d, _ = corpus
    jconf = JaxConfig.from_dict(_run_conf(d, "jax"))
    conf = Config.from_dict(_run_conf(d, "port", device="cpu"))
    jax_best = jax_cli.run_training(jconf)
    # the port starts from the weights JAX's create_train_state drew
    p_rng, s_rng, d_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    jm, _ = jax_build_model(jconf)
    params = jm.init({"params": p_rng, "stkim": s_rng, "dropout": d_rng},
                     jnp.zeros((1, 256, D)), jnp.ones((1, 256), bool))["params"]
    real_build = port_cli.build_mil_model

    def build_from_jax(c):
        model, family = real_build(c)
        model.load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), "ga"))
        return model, family

    monkeypatch.setattr(port_cli, "build_mil_model", build_from_jax)
    best = port_cli.run_training(conf)
    want, got = _epochs(jconf.log_dir), _epochs(conf.log_dir)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train/loss", "train/slide_loss", "train/sub_loss",
                    "train/diff_loss", "perf/val_loss", "perf/test_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)
        for key in ("perf/val_auc", "perf/val_acc", "perf/val_f1",
                    "perf/test_auc", "perf/test_acc", "perf/test_f1"):
            assert g[key] == w[key], key
    assert best["epoch"] == jax_best["epoch"]
    for tag in ("best", "last"):
        assert os.path.exists(os.path.join(conf.ckpt_dir,
                                           f"checkpoint-{tag}.pth"))


def test_checkpoint_resume_and_eval_only_round_trip(corpus):
    d, _ = corpus
    conf = Config.from_dict(_run_conf(d, "rt", device="cpu"))
    port_cli.run_training(conf)
    last = checkpoint.load(checkpoint.checkpoint_path(conf.ckpt_dir, "last"))
    steps = 2 * 8
    assert last["epoch"] == 1 and last["step"] == steps
    assert {int(s["step"]) for s in last["optimizer"]["state"].values()} == {
        steps}
    # a fresh state restores weights, optimizer moments and the step
    model, _ = build_mil_model(conf)
    state = create_train_state(model, conf, 8)
    checkpoint.restore(checkpoint.checkpoint_path(conf.ckpt_dir, "last"),
                       state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, last["model"][k])
    assert state.step == steps and len(state.opt.state_dict()["state"]) == len(
        last["optimizer"]["state"])

    best = checkpoint.load(checkpoint.checkpoint_path(conf.ckpt_dir, "best"))
    resumed = Config.from_dict(_run_conf(d, "rt", device="cpu",
                                         train_epoch=3, resume=True))
    port_cli.run_training(resumed)
    last = checkpoint.load(checkpoint.checkpoint_path(conf.ckpt_dir, "last"))
    assert last["epoch"] == 2 and last["step"] == 3 * 8
    with open(os.path.join(conf.log_dir, "metrics.jsonl")) as f:
        assert sum("_config" not in line for line in f) == 3

    best_now = checkpoint.load(checkpoint.checkpoint_path(conf.ckpt_dir,
                                                          "best"))
    out = port_cli.run_training(Config.from_dict(
        _run_conf(d, "rt", device="cpu", eval_only=True)))
    for k in ("acc", "auc", "f1", "loss"):
        assert out[k] == pytest.approx(best_now["metrics"][k], nan_ok=True)
    assert best_now["epoch"] >= best["epoch"]


@pytest.mark.parametrize("split_file, n_shot", [(True, -1), (False, -1),
                                                 (True, 2), (False, 3)])
def test_pt_dump_splits_match_h5(corpus, tmp_path, split_file, n_shot):
    d, _ = corpus
    kw = dict(dataset="camelyon", n_class=N_CLASS, n_shot=n_shot, seed=0,
              split_dir=str(d / "splits") if split_file else str(tmp_path))
    h5 = str(d / "patch_feats_pretrain_medical_ssl.h5")
    pt = str(d / "pt" / "patch_feats_pretrain_medical_ssl.pt")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        want = build_hdf5_feat_dataset(h5, Config.from_dict(kw))
        got = build_hdf5_feat_dataset(pt, Config.from_dict(kw))
    # no frozen split file: both take the random split, and say so
    assert sum("frozen split file" in str(w.message) for w in rec) == (
        0 if split_file else 2)
    for g, w in zip(got, want):
        assert type(g).__name__ == "PtBagSource"
        assert g.names == w.names and len(g.names) > 0
        assert [g.label_of(n) for n in g.names] == \
            [w.label_of(n) for n in w.names]
        assert g.lengths() == w.lengths()


def test_step3_finds_a_torch_feature_file(corpus, monkeypatch):
    d, _ = corpus
    seen = {}
    monkeypatch.setattr(step3_acmil, "run_training",
                        lambda conf: seen.setdefault("conf", conf))
    step3_acmil.main(["--config", os.path.join(
        REPO, "config/camelyon_medical_ssl_config.yml"), "--data_dir",
        str(d / "pt"), "--arch", "abmil"])
    conf = seen["conf"]
    assert conf.seed == 4 and conf.arch == "ga"       # the script's defaults
    assert port_cli.feature_file(conf).endswith(".pt")


@pytest.mark.parametrize("argv, match", [
    (["--mesh_data", "2"], "mesh_data"),
    (["--pod"], "pod"),
    # scan_epoch runs on a mesh too (tests/test_torch_scan_mesh.py): in one
    # process it gets as far as the mesh's layout
    (["--scan_epoch", "--mesh_data", "2"], "scan_epoch"),
    # --arch mha trains ACMIL_MHA, on a --pod mesh too
    (["--arch", "mha", "--pod"], "pod"),
])
def test_step3_refuses_what_is_not_ported(argv, match, corpus, tmp_path):
    """``match`` names the option. A mesh of 2 in one process, with or
    without scan_epoch, is refused with the launch it needs; --pod (ported)
    in one process trains on a world-1 mesh."""
    cfg = os.path.join(REPO, "config/camelyon_medical_ssl_config.yml")
    if match != "pod":
        want = "torchrun --nproc_per_node 2"
        with pytest.raises((ValueError, NotImplementedError), match=want):
            step3_acmil.main(["--config", cfg, "--device", "cpu", *argv])
        return
    d, _ = corpus
    os.symlink(d / "pt" / "patch_feats_pretrain_medical_ssl.pt",
               tmp_path / "patch_feats_pretrain_tiny.pt")
    with open(tmp_path / "tiny.yml", "w") as f:
        yaml.safe_dump(dict(dataset="camelyon", n_class=N_CLASS,
                            pretrain="tiny", D_feat=D, D_inner=L_DIM,
                            n_token=3, train_epoch=1, min_bucket=256,
                            split_dir=str(d / "splits")), f)
    best = step3_acmil.main(["--config", str(tmp_path / "tiny.yml"),
                             "--data_dir", str(tmp_path), "--seed", "0",
                             "--ckpt_dir", str(tmp_path / "ckpt"),
                             "--log_dir", str(tmp_path / "log"),
                             "--device", "cpu", *argv])
    assert best["epoch"] == 0 and 0.0 <= best["acc"] <= 1.0
    assert os.path.exists(tmp_path / "ckpt" / "checkpoint-last.pth")


def test_teacher_init_is_refused(tmp_path):
    # teacher_init is ported for MHIM; on an arch without an EMA teacher (the
    # default ga) it would do nothing, so the trainer refuses it
    conf = Config.from_dict({"teacher_init": str(tmp_path)})
    with pytest.raises(ValueError, match="teacher_init"):
        port_cli.run_training(conf)


def test_train_step_draws_stkim_from_the_state_generator():
    _, conf = _confs()
    tm, _ = build_mil_model(conf)
    _, tb = _bags(*_bag_arrays(9))

    def run():
        torch.manual_seed(0)
        model, _ = build_mil_model(conf)
        model.load_state_dict(tm.state_dict())
        state = create_train_state(model, conf, 4)
        step = make_train_step(model, conf, "acmil")
        return [float(step(state, tb)["loss"]) for _ in range(2)]

    assert run() == run()


def test_use_sam_is_refused():
    # SAM is ported; the family with its own step (mhim) takes no SAM
    # gradient (the JAX engine ignores use_sam there), so it is refused
    conf = Config.from_dict({"use_sam": True, "device": "cpu",
                             "arch": "mhim", "n_class": 2, "D_feat": 32,
                             "mlp_dim": 16})
    model, family = build_mil_model(conf)
    with pytest.raises(ValueError, match="use_sam.*'mhim'"):
        make_train_step(model, conf, family)


def test_checkpoint_restores_the_stkim_generator(tmp_path):
    """A run resumed from a checkpoint at step t0 draws at t0 what an
    uninterrupted run draws there: the checkpoint holds the STKIM
    generator's state and ``restore`` sets it."""
    _, conf = _confs()
    _, tb = _bags(*_bag_arrays(9))
    torch.manual_seed(0)
    model, _ = build_mil_model(conf)
    state = create_train_state(model, conf, 4)
    step = make_train_step(model, conf, "acmil")
    for _ in range(2):
        step(state, tb)
    at_save = state.generator.get_state().clone()
    best = checkpoint.save_best_and_last(str(tmp_path), state, 0, conf,
                                         {"f1": 0.5, "auc": 0.5}, {})
    assert best["epoch"] == 0
    uninterrupted = [float(step(state, tb)["loss"]) for _ in range(2)]

    resumed_model, _ = build_mil_model(conf)
    resumed = create_train_state(resumed_model, conf, 4)
    assert not torch.equal(resumed.generator.get_state(), at_save)
    checkpoint.restore(checkpoint.checkpoint_path(str(tmp_path), "last"),
                       resumed)
    assert torch.equal(resumed.generator.get_state(), at_save)
    assert resumed.step == 2
    resumed_step = make_train_step(resumed_model, conf, "acmil")
    assert [float(resumed_step(resumed, tb)["loss"])
            for _ in range(2)] == uninterrupted
