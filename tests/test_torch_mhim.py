"""The port's MHIM (acmil_tpu_torch: models/mhim.py, the ``mhim`` and
``pure`` families and their optimizer and step, the EMA teacher in the train
state and the checkpoint, ``init_teacher_student``, cli/step3_mhim.py, and
cli/predict.py and cli/step4_heatmap.py on MHIM) against the JAX package, on
the same numpy inputs and the same weights.

MHIM reaches no Pallas kernel in the JAX package. The masks are integer
ranks and must equal JAX's exactly, ties included; the uniforms of random
masking are JAX's own draws handed to the port (C2). The DAttention
baseline has no inverse, so its outputs and gradients are held to
ATOL/RTOL and GRAD_ATOL/GRAD_RTOL; SAttention's Nystrom layers to
NY_ATOL/NY_RTOL, the JAX-vs-reference Nystrom tolerance
(tests/test_reference_parity.py::test_nystrom_core_parity). SAttention's
TransLayer dropout 0.1 is fixed, so its gradients come from a loss on the
deterministic forward and the training-step parity runs on the DAttention
baseline with dropout 0, on the deterministic masking path.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from acmil_tpu.cli import train as jax_cli
from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine import losses as JL
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.engine.checkpoint import MODEL_CONFIG_KEYS as JAX_MODEL_KEYS
from acmil_tpu.engine.checkpoint import CheckpointManager
from acmil_tpu.engine.schedules import cosine_array as jax_cosine_array
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models import mhim as jax_mhim
from acmil_tpu_torch.cli import predict, step3_mhim, step4_heatmap
from acmil_tpu_torch.cli import train as port_cli
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_train_step)
from acmil_tpu_torch.engine.families import mhim_script_optimizer
from acmil_tpu_torch.engine.schedules import cosine_array
from acmil_tpu_torch.models import MHIM, build_mil_model
from acmil_tpu_torch.models import mhim as port_mhim
from acmil_tpu_torch.models.convert import from_jax_params
from scripts.import_torch_checkpoint import convert_mhim
from tests.conftest import make_synthetic_bags

D, MLP = 32, 32
ATOL, RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-3
NY_ATOL, NY_RTOL = 5e-4, 5e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=name)


def _kw(baseline="attn", **kw):
    """The keyword arguments both packages' MHIM take at the test widths."""
    out = dict(n_class=3, mlp_dim=MLP, baseline=baseline, act="relu",
               da_act="gelu", droprate=0.0)
    out.update(kw)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(baseline, pad_mode="zero"):
    jm = jax_mhim.MHIM(**_kw(baseline, pad_mode=pad_mode))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, D)), jnp.ones((1, 64), bool))["params"]


def _pair(baseline="attn", seed=0, **kw):
    """The flax MHIM with every parameter from a seeded normal and the
    port's holding the same weights."""
    jm = jax_mhim.MHIM(**_kw(baseline, **kw))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        _shapes(baseline, kw.get("pad_mode", "zero")))
    tm = MHIM(d_feat=D, **_kw(baseline, **kw))
    tm.load_state_dict(from_jax_params(params, "mhim"))
    return jm, params, tm.eval()


@functools.lru_cache(maxsize=None)
def _jit_apply(jm, return_attn=False):
    return jax.jit(functools.partial(jm.apply, deterministic=True,
                                     return_attn=return_attn))


def _bag(seed, n, valid, b=2):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = np.zeros((b, n), bool)
    for i, v in enumerate(valid):
        mask[i, :v] = True
    return feats, mask


def _bags(feats, mask, labels):
    coords = np.zeros(feats.shape[:2] + (2,), np.int32)
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.asarray(coords),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.from_numpy(coords),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


# ---------------------------------------------------------------------------
# The masks
# ---------------------------------------------------------------------------

def _tied_scores(seed, b=2, n=60):
    """Scores on a coarse grid, so many tie; bag 1 half valid."""
    rs = np.random.RandomState(seed)
    scores = np.round(rs.rand(b, n) * 4).astype(np.float32) / 4
    valid = np.ones((b, n), bool)
    valid[1, n // 2:] = False
    return scores, valid


@pytest.mark.parametrize("largest", [True, False])
def test_rank_breaks_ties_by_position_as_jax(largest):
    scores, valid = _tied_scores(0)
    want = np.asarray(jax_mhim._rank(jnp.asarray(scores), jnp.asarray(valid),
                                     largest))
    got = port_mhim._rank(*map(torch.from_numpy, (scores, valid)), largest)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("frac, random_frac", [(0.1, 1.0), (0.3, 1.0),
                                               (0.2, 0.5), (0.5, 0.25)])
def test_select_drop_mask_matches_jax(largest, frac, random_frac):
    """On tied scores; with ``random_frac`` < 1 the port gets the uniforms
    ``jax.random.uniform(rng, shape)`` that the JAX function draws."""
    scores, valid = _tied_scores(1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_mhim.select_drop_mask(
        jnp.asarray(scores), jnp.asarray(valid), frac, largest, rng=key,
        random_frac=random_frac))
    noise = np.array(jax.random.uniform(key, scores.shape))
    got = port_mhim.select_drop_mask(
        torch.from_numpy(scores), torch.from_numpy(valid), frac, largest,
        noise=torch.from_numpy(noise), random_frac=random_frac)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy() & ~valid).any()


@pytest.mark.parametrize("n, frac, want_k", [
    (50, np.float32(0.1), 5),       # a float64 product ceils to 6
    (50000, np.float32(0.1), 5000),
    (50, 0.1, 5), (49, 0.1, 5)])
def test_drop_counts_are_float32_products(n, frac, want_k):
    """``ceil(ps · frac)`` in float32, as JAX: a scheduled ratio is a
    float32 whose float64 product with ps can cross an integer."""
    scores = np.random.RandomState(2).rand(1, n).astype(np.float32)
    valid = np.ones((1, n), bool)
    t_frac = torch.tensor(frac) if isinstance(frac, np.float32) else frac
    got = port_mhim.select_drop_mask(torch.from_numpy(scores),
                                     torch.from_numpy(valid), t_frac, True)
    want = jax_mhim.select_drop_mask(jnp.asarray(scores), jnp.asarray(valid),
                                     jnp.asarray(frac) if isinstance(
                                         frac, np.float32) else frac, True)
    assert int(got.sum()) == int(np.asarray(want).sum()) == want_k


def test_vote_fusion_matches_jax():
    """(tests/test_coverage_extras.py::test_mhim_vote_fusion), then on tied
    random heads against JAX."""
    attn = np.array([[[0.1, 0.2, 0.3, 0.1, 0.1, 0.1, 0.6, 0.9],
                      [0.1, 0.7, 0.1, 0.1, 0.1, 0.1, 0.2, 0.95]]], np.float32)
    votes = port_mhim.fuse_heads_vote(torch.from_numpy(attn),
                                      torch.ones(1, 8, dtype=torch.bool), 0.25)
    assert votes[0, 7] == 2 and votes[0, 6] == 1 and votes[0, 1] == 1
    assert votes[0, 0] == 0
    rs = np.random.RandomState(4)
    attn = (np.round(rs.rand(2, 4, 40) * 3) / 3).astype(np.float32)
    valid = np.ones((2, 40), bool)
    valid[0, 25:] = False
    want = jax_mhim.fuse_heads_vote(jnp.asarray(attn), jnp.asarray(valid), 0.3)
    got = port_mhim.fuse_heads_vote(torch.from_numpy(attn),
                                    torch.from_numpy(valid), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The encoders and the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", ["ppeg", "peg", "sincos", "none"])
def test_sattention_encoder_matches_flax_for_every_pos(pos):
    """(tests/test_parity_utils.py::test_mhim_pos_variants) against flax:
    the cls feature and both layers' cls attention on a padded bag."""
    jm = jax_mhim.SAttentionEncoder(dim=MLP, pos=pos)
    x, mask = _bag(5, 200, (200, 70))
    rs = np.random.RandomState(6)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, MLP)),
                       jnp.ones((1, 64), bool))["params"])
    tm = port_mhim.SAttentionEncoder(MLP, pos)
    sd = from_jax_params({"patch_to_emb": {"kernel": np.zeros((1, 1)),
                                           "bias": np.zeros(1)},
                          "predictor": {"kernel": np.zeros((1, 1)),
                                        "bias": np.zeros(1)},
                          "SAttentionEncoder_0": params}, "mhim")
    tm.load_state_dict({k[len("online_encoder."):]: v for k, v in sd.items()
                        if k.startswith("online_encoder.")})
    want, want_attn = _jit_apply(jm, True)({"params": params}, jnp.asarray(x),
                                          jnp.asarray(mask))
    with torch.no_grad():
        got, attns = tm(torch.from_numpy(x), torch.from_numpy(mask),
                        return_attn=True)
    _close(got, want, NY_ATOL, NY_RTOL, name="cls_feat")
    for g, w in zip(attns, want_attn):
        for i, v in enumerate((200, 70)):
            _close(g[i, :v], np.asarray(w)[i, :v], NY_ATOL, NY_RTOL)


def test_wrap_needs_ppeg_in_both_packages():
    with pytest.raises(ValueError, match="wrap"):
        port_mhim.SAttentionEncoder(MLP, "peg", pad_mode="wrap")
    jm = jax_mhim.SAttentionEncoder(dim=MLP, pos="peg", pad_mode="wrap")
    with pytest.raises(ValueError, match="wrap"):
        jm.init(jax.random.PRNGKey(0), jnp.ones((1, 16, MLP)))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_dattention_encoder_matches_flax(gated, act):
    """flax's gelu is the tanh approximation, and so is the port's."""
    jm = jax_mhim.DAttentionEncoder(dim=MLP, gated=gated, act=act)
    x, mask = _bag(7, 100, (100, 30))
    rs = np.random.RandomState(8)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, MLP)),
                       None)["params"])
    names = (("attention_a.0", "attention_b.0", "attention_c") if gated
             else ("attention.0", "attention.2"))
    tm = port_mhim.DAttentionEncoder(MLP, gated, act)
    tm.load_state_dict({f"attention.{n}.weight": torch.from_numpy(
        params[f"Dense_{i}"]["kernel"].T.copy()) for i, n in enumerate(names)})
    want, want_a = jm.apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        got, a = tm(torch.from_numpy(x), torch.from_numpy(mask),
                    return_attn=True)
    _close(got, want)
    _close(a[0], want_a[0])


@pytest.mark.parametrize("baseline, pad_mode, n, valid, attn_layer", [
    ("attn", "zero", 100, (100, 40), 0),
    ("selfattn", "zero", 200, (200, 66), 0),
    ("selfattn", "zero", 256, (256, 100), 1),
    ("selfattn", "wrap", 30, (30, 30), 0),       # a 6x6 grid, filled to 7x7
    ("selfattn", "wrap", 200, (200, 200), -1),   # the reference's 15x15
])
def test_mhim_matches_flax(baseline, pad_mode, n, valid, attn_layer):
    jm, params, tm = _pair(baseline, seed=9, pad_mode=pad_mode,
                           attn_layer=attn_layer)
    x, mask = _bag(10, n, valid)
    want = _jit_apply(jm, True)({"params": params}, jnp.asarray(x),
                                jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask),
                 return_attn=True)
        plain = tm.forward_teacher(torch.from_numpy(x),
                                   torch.from_numpy(mask))
    atol, rtol = (ATOL, RTOL) if baseline == "attn" else (NY_ATOL, NY_RTOL)
    for key in ("logits", "cls_feat"):
        _close(got[key], want[key], atol, rtol, name=key)
        assert torch.equal(plain[key], got[key])
    for i, v in enumerate(valid):
        _close(got["attn"][i, :v], np.asarray(want["attn"])[i, :v], atol,
               rtol, name="attn")
    assert torch.equal(got["keep"], torch.from_numpy(mask))


def test_wrap_mode_padded_bags_stay_mask_correct():
    """(tests/test_model_zoo.py::
    test_mhim_wrap_mode_padded_bags_stay_mask_correct): garbage in the
    masked slots of a bucket-padded bag changes nothing, and the port's
    logits are JAX's."""
    jm, params, tm = _pair("selfattn", seed=11, pad_mode="wrap")
    x, mask = _bag(12, 256, (200, 200))
    g = x.copy()
    g[~mask] = 37.0
    with torch.no_grad():
        pad = tm(torch.from_numpy(x), torch.from_numpy(mask))["logits"]
        gar = tm(torch.from_numpy(g), torch.from_numpy(mask))["logits"]
    assert torch.equal(pad, gar)
    want = _jit_apply(jm)({"params": params}, jnp.asarray(x),
                          jnp.asarray(mask))["logits"]
    _close(pad, want, NY_ATOL, NY_RTOL)


def test_sattention_grads_match_jax():
    """Every gradient of the MHIM loss on the deterministic SAttention
    forward (the student's encoder without its fixed dropout)."""
    jm, params, tm = _pair("selfattn", seed=13)
    x, mask = _bag(14, 200, (180, 50))
    labels = np.array([0, 2])
    tfeat = np.random.RandomState(15).randn(2, MLP).astype(np.float32)

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                       deterministic=True)
        return (JL.cross_entropy(out["logits"], jnp.asarray(labels))
                + 0.1 * jax_mhim.soft_target_ce(out["cls_feat"],
                                                jnp.asarray(tfeat), 0.1))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = tm(torch.from_numpy(x), torch.from_numpy(mask))
    from acmil_tpu_torch.engine.losses import cross_entropy
    loss = (cross_entropy(out["logits"], torch.from_numpy(labels))
            + 0.1 * port_mhim.soft_target_ce(out["cls_feat"],
                                             torch.from_numpy(tfeat), 0.1))
    loss.backward()
    _close(loss.item(), float(loss_j), NY_ATOL, NY_RTOL)
    want = from_jax_params(_np_tree(grads_j), "mhim")
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        _close(p.grad, want[name].numpy(), NY_ATOL * scale, NY_RTOL,
               name=name)


def _recording_uniform(monkeypatch):
    """Patch ``jax.random.uniform`` to record every concrete draw of a JAX
    forward, in order (MHIM's masks are drawn eagerly; flax traces other
    draws)."""
    drawn, real = [], jax.random.uniform

    def uniform(key, shape=(), *a, **k):
        out = real(key, shape, *a, **k)
        if not isinstance(out, jax.core.Tracer):
            drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "uniform", uniform)
    return drawn


@pytest.mark.parametrize("baseline", ["attn"])
def test_student_masks_match_jax_with_its_uniforms(baseline, monkeypatch):
    """Random, low- and high-attention masking with a random high subset,
    on teacher attention with ties: the port's ``keep`` is JAX's exactly
    when it gets JAX's uniforms, and at dropout 0 the student's logits are
    JAX's too. The masks are drawn before the encoder, so the DAttention
    baseline holds them for both."""
    kw = dict(mask_ratio=0.2, mask_ratio_l=0.1, mask_ratio_h=0.3,
              mask_ratio_hr=0.5)
    jm, params, tm = _pair(baseline, seed=16, **kw)
    x, mask = _bag(17, 128, (128, 75))
    rs = np.random.RandomState(18)
    tattn = (np.round(rs.rand(2, 128) * 5) / 5).astype(np.float32)
    drawn = _recording_uniform(monkeypatch)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                    deterministic=False, teacher_attn=jnp.asarray(tattn),
                    rngs={"stkim": jax.random.PRNGKey(19),
                          "dropout": jax.random.PRNGKey(20)})
    monkeypatch.undo()
    mask_u = [d for d in drawn if d.shape == (2, 128)]
    assert len(mask_u) == 2
    tm.train()
    got = tm(torch.from_numpy(x), torch.from_numpy(mask), deterministic=False,
             teacher_attn=torch.from_numpy(tattn),
             mask_u=torch.from_numpy(np.stack(mask_u)))
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    assert (got["keep"].sum(-1) < torch.from_numpy(mask).sum(-1)).all()
    _close(got["logits"], want["logits"])


# ---------------------------------------------------------------------------
# Training: the step, the optimizer, five steps with the EMA teacher
# ---------------------------------------------------------------------------

def test_cosine_array_matches_jax():
    for args in ((0.9999, 1.0, 3, 5), (0.1, 0.0, 2, 4, 1, 0.02)):
        np.testing.assert_array_equal(cosine_array(*args),
                                      jax_cosine_array(*args))


def test_script_optimizer_is_coupled_adam_without_clipping():
    """One step of the family's Adam against ``optax.add_decayed_weights``
    then ``adam``; ``grad_clipping`` is not applied for mhim or pure, and
    only mhim keeps a teacher."""
    import optax

    rs = np.random.RandomState(21)
    p0 = rs.randn(40).astype(np.float32)
    g = rs.randn(40).astype(np.float32)
    conf = Config.from_dict(dict(wd=0.05, lr=1e-2, grad_clipping=0.5))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = mhim_script_optimizer([p], conf, 1e-2, torch.device("cpu"))
    p.grad = torch.from_numpy(g)
    opt.step()
    tx = optax.chain(optax.add_decayed_weights(0.05), optax.adam(1e-2))
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)),
                       jnp.asarray(p0))
    _close(p.detach(), p0 + np.asarray(upd), 1e-7, 1e-6)
    for family, teacher in (("mhim", True), ("pure", False)):
        model, _ = build_mil_model(Config.from_dict(dict(
            arch=family, n_class=2, D_feat=D, mlp_dim=MLP, baseline="attn")))
        state = create_train_state(model, conf, 1, family=family)
        assert state.grad_clip is None
        assert isinstance(state.opt, torch.optim.Adam)
        assert state.opt.param_groups[0]["weight_decay"] == 0.05
        assert (state.teacher is not None) == teacher


def _step_conf(**kw):
    d = dict(arch="mhim", n_class=3, D_feat=D, mlp_dim=MLP, baseline="attn",
             da_act="gelu", dropout=0.0, lr=1e-3, wd=1e-4, train_epoch=2,
             steps_per_epoch=3, seed=0, mask_ratio_l=0.2)
    d.update(kw)
    return JaxConfig.from_dict(d), Config.from_dict(d)


def test_one_step_loss_and_grads_match_jax():
    """The deterministic masking path (low-attention masking and the
    high-attention set with ``mask_ratio_hr`` 1, dropout 0): the family's
    step against the JAX step's loss function, loss and every gradient."""
    jconf, conf = _step_conf(mask_ratio_h=0.1)
    jm, params, tm = _pair("attn", seed=22, mask_ratio_l=0.2,
                           mask_ratio_h=0.1)
    x, mask = _bag(23, 100, (100, 61))
    labels = np.array([1, 2])
    jb, tb = _bags(x, mask, labels)
    tea = jm.apply({"params": params}, jb.feats, jb.mask, deterministic=True,
                   return_attn=True)

    def loss_fn(p):
        out = jm.apply({"params": p}, jb.feats, jb.mask, deterministic=False,
                       teacher_attn=tea["attn"],
                       rngs={"stkim": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)})
        ce = JL.cross_entropy(out["logits"], jb.label, jb.mask.any(axis=1))
        cl = jax_mhim.soft_target_ce(out["cls_feat"], tea["cls_feat"], 0.1,
                                     1.0)
        return ce + 0.1 * cl, out["keep"]

    (loss_j, keep_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    state = create_train_state(tm, conf, 3, family="mhim")
    aux = make_train_step(tm, conf, "mhim")(state, tb)
    _close(float(aux["loss"]), float(loss_j), name="loss")
    assert int(np.asarray(keep_j).sum()) < int(mask.sum())
    want = from_jax_params(_np_tree(grads_j), "mhim")
    for name, p in tm.named_parameters():
        _close(p.grad, want[name].numpy(), GRAD_ATOL, GRAD_RTOL, name=name)
    assert state.step == 1


def test_five_steps_with_the_ema_teacher_match_jax():
    """Five steps of each package's mhim step from the same weights, the
    coupled Adam with the EMA momentum and the high-attention ratio on
    their cosine schedules (``mm_sche``, ``mrh_sche``): the same losses,
    parameters and teachers."""
    jconf, conf = _step_conf(mask_ratio_l=0.0, mask_ratio_h=0.3,
                             mask_ratio_hr=1.0, mm=0.9, mm_sche=True,
                             mrh_sche=True)
    jm, _, tm = _pair("attn", seed=24, mask_ratio_h=0.3)
    bags = [_bags(*_bag(25 + i, 100, (100, 80 - 10 * i)), [i % 3, 1])
            for i in range(3)]
    jfam = jax_get_family("mhim")
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], 3, family=jfam)
    p0 = from_jax_params(_np_tree(jstate.params), "mhim")
    tm.load_state_dict(p0)
    state = create_train_state(tm, conf, 3, family="mhim")
    jstep = jfam.make_train_step(jm, jconf)
    step = make_train_step(tm, conf, "mhim")
    for i in range(5):
        jb, tb = bags[i % 3]
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb)
        for key in ("loss", "logit_loss", "cls_loss"):
            _close(float(aux[key]), float(jaux[key]), 0, 1e-4,
                   name=f"step {i} {key}")
    want = from_jax_params(_np_tree(jstate.params), "mhim")
    want_t = from_jax_params(_np_tree(jstate.teacher_params), "mhim")
    lr = conf.lr
    for name, p in tm.named_parameters():
        d_want = (want[name] - p0[name]).numpy()
        d_got = p.detach().numpy() - p0[name].numpy()
        # Adam scales each element by its own gradient: an element whose
        # gradient is within the packages' rounding of 0 steps by noise, so
        # each move is held to 2% of the largest five-step move (5 lr)
        _close(d_got, d_want, 0.02 * 5 * lr, 0, name=name)
        _close(state.teacher.get_parameter(name).detach(), want_t[name],
               0.02 * 5 * lr, 0, name="teacher " + name)
    # the teacher moved from the student's start, and lags the student
    t = dict(state.teacher.named_parameters())
    for name, p in tm.named_parameters():
        assert not torch.equal(t[name], p0[name]), name
        assert not torch.equal(t[name], p.detach()), name


def test_ema_is_t_mm_plus_s_one_minus_mm_in_f32():
    """The EMA after one step without a schedule: ``t·mm + s·(1 - mm)``
    with both factors float32, in that order of operations."""
    _, conf = _step_conf(mm=0.99)
    _, _, tm = _pair("attn", seed=26, mask_ratio_l=0.2)
    _, tb = _bags(*_bag(27, 100, (100, 50)), [0, 1])
    state = create_train_state(tm, conf, 3, family="mhim")
    t0 = {n: p.detach().clone() for n, p in state.teacher.named_parameters()}
    make_train_step(tm, conf, "mhim")(state, tb)
    mm, om = np.float32(0.99), np.float32(1.0 - 0.99)
    for name, p in tm.named_parameters():
        want = (t0[name].numpy() * mm) + (p.detach().numpy() * om)
        np.testing.assert_array_equal(
            state.teacher.get_parameter(name).detach().numpy(), want)


def test_resume_restores_the_teacher(tmp_path):
    """A run resumed at step 2 has the uninterrupted run's teacher at every
    later step: the checkpoint holds it under ``teacher``. Without that key
    (a reference checkpoint) the restored state keeps its own teacher."""
    _, conf = _step_conf(mm=0.9, mask_ratio_h=0.2, mask_ratio_hr=0.5,
                         dropout=0.25)
    _, tb = _bags(*_bag(28, 100, (100, 50)), [0, 1])
    model, _ = build_mil_model(conf)
    state = create_train_state(model, conf, 3, family="mhim")
    step = make_train_step(model, conf, "mhim")
    for _ in range(2):
        step(state, tb)
    checkpoint.save_best_and_last(str(tmp_path), state, 0, conf,
                                  {"f1": 0.5, "auc": 0.5}, {})
    for _ in range(2):
        step(state, tb)
    want = {k: v.clone() for k, v in state.teacher.state_dict().items()}

    def resumed(drop_teacher):
        path = checkpoint.checkpoint_path(str(tmp_path), "last")
        if drop_teacher:
            ck = torch.load(path, weights_only=True)
            del ck["teacher"]
            path = str(tmp_path / "reference.pth")
            torch.save(ck, path)
        m, _ = build_mil_model(conf)
        s = create_train_state(m, conf, 3, family="mhim")
        fresh = {k: v.clone() for k, v in s.teacher.state_dict().items()}
        checkpoint.restore(path, s)
        assert s.step == 2
        if drop_teacher:
            for k, v in s.teacher.state_dict().items():
                assert torch.equal(v, fresh[k]), k
        st = make_train_step(m, conf, "mhim")
        for _ in range(2):
            st(s, tb)
        return s.teacher.state_dict()

    got = resumed(False)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(not torch.equal(v, want[k])
               for k, v in resumed(True).items())


# ---------------------------------------------------------------------------
# Teacher initialisation, the CLI, predict and Step4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small H5 dump with a frozen split, the same bags as a torch feature
    file, and a JAX package checkpoint of a 'pure' network with seeded
    normal weights."""
    d = tmp_path_factory.mktemp("mhim")
    slides = make_synthetic_bags(n_slides=10, d=D, seed=29, min_len=10,
                                 max_len=200)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:6], "val_names": names[6:8],
                   "test_names": names[8:]}, f)
    jm, _ = jax_build_model(JaxConfig.from_dict(_run_conf(
        d, "", arch="pure", baseline="attn")))
    rs = np.random.RandomState(31)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, D)),
                       jnp.ones((1, 64), bool))["params"])
    mgr = CheckpointManager(str(d / "jax_pure"))
    mgr.save("best", {"params": params}, epoch=0)
    mgr.wait()
    return d, slides, str(d / "jax_pure")


def _run_conf(d, tag, **kw):
    out = dict(dataset="camelyon", n_class=2, D_feat=D, D_inner=16,
               mlp_dim=MLP, lr=1e-3, train_epoch=1, min_bucket=256, seed=0,
               pretrain="tiny", data_dir=str(d), split_dir=str(d / "splits"),
               ckpt_dir=str(d / tag / "ckpt"), log_dir=str(d / tag / "log"))
    out.update(kw)
    return out


@pytest.mark.parametrize("stu_type", ["none", "fc", "all"])
def test_teacher_init_matches_jax(corpus, tmp_path, stu_type):
    """(tests/test_cli.py::test_mhim_teacher_init and
    test_mhim_student_init_fc) The JAX 'pure' checkpoint's weights, as the
    port's ``.pth``: ``init_teacher_student`` gives JAX's student and
    teacher, exactly."""
    d, _, jax_pure = corpus
    raw = CheckpointManager(jax_pure).restore_raw("best")["params"]
    pure = _np_tree(raw)
    pdir = str(tmp_path / "port_pure")
    pm, _ = build_mil_model(Config.from_dict(_run_conf(d, "", arch="pure",
                                                       baseline="attn")))
    pm.load_state_dict(from_jax_params(pure, "pure"))
    checkpoint.save(checkpoint.checkpoint_path(pdir, "best"), pm)

    keys = _run_conf(d, "", arch="mhim", baseline="attn", mask_ratio_h=0.1,
                     init_stu_type=stu_type)
    jconf = JaxConfig.from_dict(dict(keys, teacher_init=jax_pure))
    jm, jfam = jax_build_model(jconf)
    example = jax_bags.pad_bag(np.zeros((64, D), np.float32),
                               np.zeros((64, 2), np.int32), 0)
    jstate = jax_create_state(jm, jconf, jax.random.PRNGKey(1), example, 1,
                              family=jax_get_family(jfam))
    conf = Config.from_dict(dict(keys, teacher_init=pdir))
    tm, fam = build_mil_model(conf)
    tm.load_state_dict(from_jax_params(_np_tree(jstate.params), "mhim"))
    state = create_train_state(tm, conf, 1, family=fam)
    jstate = jax_cli.init_teacher_student(jstate, jconf)
    port_cli.init_teacher_student(state, conf)
    for got, want in ((tm, jstate.params), (state.teacher,
                                            jstate.teacher_params)):
        want = from_jax_params(_np_tree(want), "mhim")
        got = got.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    fresh = dict(tm.named_parameters())
    assert torch.equal(state.teacher.patch_to_emb[0].weight,
                       torch.from_numpy(pure["patch_to_emb"]["kernel"].T))
    assert (stu_type == "none") != torch.equal(
        fresh["patch_to_emb.0.weight"], state.teacher.patch_to_emb[0].weight)


def test_teacher_init_refuses_an_unknown_type_and_a_teacherless_arch(
        tmp_path):
    model, _ = build_mil_model(Config.from_dict(dict(
        arch="pure", n_class=2, D_feat=D, mlp_dim=MLP)))
    checkpoint.save(checkpoint.checkpoint_path(str(tmp_path), "last"), model)
    conf = Config.from_dict(dict(arch="mhim", n_class=2, D_feat=D,
                                 mlp_dim=MLP, teacher_init=str(tmp_path),
                                 init_stu_type="bogus"))
    m, fam = build_mil_model(conf)
    with pytest.raises(ValueError, match="init_stu_type"):
        port_cli.init_teacher_student(create_train_state(m, conf, 1,
                                                         family=fam), conf)
    # checkpoint-last serves when there is no best
    conf.extra["init_stu_type"] = "all"
    state = create_train_state(m, conf, 1, family=fam)
    port_cli.init_teacher_student(state, conf)
    assert torch.equal(m.predictor.weight, model.predictor.weight)
    with pytest.raises(ValueError, match="teacher_init"):
        port_cli.run_training(Config.from_dict(dict(
            arch="pure", teacher_init=str(tmp_path), device="cpu")))


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "_config" not in r]


@pytest.mark.parametrize("baseline", ["attn", "selfattn"])
def test_two_stage_cli_then_predict_and_step4(corpus, tmp_path, baseline):
    """``cli/step3_mhim.py --model pure``, then ``--model mhim
    --teacher_init <its dir> --init_stu_type fc`` with the head-to-head's
    ratios and schedules, one epoch each on the CPU: finite losses, a
    teacher in the checkpoint that moved off the pure weights and differs
    from the student; ``cli/predict.py`` on the student against the JAX
    eval step on the same weights (through ``convert_mhim``) with a YAML
    that repeats ``mlp_dim`` and ``baseline`` (the checkpoint's model keys
    hold neither, in both packages); Step4 refuses the head."""
    d, slides, _ = corpus
    yml = d / f"cli_{baseline}.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, "unused")))
    pure_dir, mhim_dir = str(tmp_path / "pure"), str(tmp_path / "mhim")
    common = ["--config", str(yml), "--mlp_dim", str(MLP), "--baseline",
              baseline, "--device", "cpu"]
    step3_mhim.main(common + ["--model", "pure", "--ckpt_dir", pure_dir,
                              "--log_dir", str(tmp_path / "log_pure")])
    step3_mhim.main(common + [
        "--model", "mhim", "--teacher_init", pure_dir, "--init_stu_type",
        "fc", "--mask_ratio_h", "0.1", "--mask_ratio_hr", "0.5", "--mm_sche",
        "--mrh_sche", "--ckpt_dir", mhim_dir, "--log_dir",
        str(tmp_path / "log_mhim")])
    for tag in ("pure", "mhim"):
        got = _epochs(str(tmp_path / f"log_{tag}"))
        assert len(got) == 1 and np.isfinite(got[0]["train/loss"]), tag
    pure = checkpoint.load(checkpoint.checkpoint_path(pure_dir, "best"))
    ck = checkpoint.load(checkpoint.checkpoint_path(mhim_dir, "last"))
    assert "teacher" not in pure and ck["config"]["arch"] == "mhim"
    assert ck["config"]["init_stu_type"] == "fc"
    assert any(not torch.equal(ck["teacher"][k], v)
               for k, v in pure["model"].items())
    assert any(not torch.equal(ck["teacher"][k], v)
               for k, v in ck["model"].items())

    best = checkpoint.load(checkpoint.checkpoint_path(mhim_dir, "best"))
    bare = tmp_path / "bare.yml"
    bare.write_text(yaml.safe_dump({"n_class": 2, "D_feat": D}))
    with pytest.raises(RuntimeError, match="size mismatch|Missing key"):
        predict.main(["--config", str(bare), "--ckpt", mhim_dir, "--features",
                      str(d / "feats.pt"), "--device", "cpu"])
    assert not {"mlp_dim", "baseline"} & set(JAX_MODEL_KEYS)
    pyml = tmp_path / "p.yml"
    pyml.write_text(yaml.safe_dump({"n_class": 2, "D_feat": D,
                                    "mlp_dim": MLP, "baseline": baseline}))
    res = predict.main(["--config", str(pyml), "--ckpt", mhim_dir,
                        "--features", str(d / "feats.pt"), "--out_csv",
                        str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert len(res["rows"]) == len(slides)
    jm, family = jax_build_model(JaxConfig.from_dict(_run_conf(
        d, "", arch="mhim", baseline=baseline)))
    jstep = jax_make_eval_step(jm, family)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert_mhim(
        {k: v.numpy() for k, v in best["model"].items()}))
    atol, rtol = (ATOL, RTOL) if baseline == "attn" else (NY_ATOL, NY_RTOL)
    for row in res["rows"]:
        item = slides[row[0]]
        jbag = jax_bags.pad_bag(item["feat"], item["coords"], item["label"],
                                dtype=np.float16)
        _close(row[2:4], np.asarray(jstep(jparams, jbag))[0], atol, rtol,
               name=row[0])

    model, _ = build_mil_model(Config.from_dict(_run_conf(
        d, "", arch="mhim", baseline=baseline)))
    model.load_state_dict(best["model"])
    x = torch.randn(1, 40, D)
    with pytest.raises(ValueError, match="model emits no attention"):
        step4_heatmap.attention_probs(model, Bag(x, torch.ones(
            1, 40, dtype=torch.bool), None, None), "mhim")


@pytest.mark.parametrize("baseline", ["attn", "selfattn"])
def test_convert_round_trip_gives_the_jax_tree(baseline):
    """The port's state_dict → ``convert_mhim`` → the flax tree that
    ``from_jax_params`` started from, exactly; ``pure`` has the same tree."""
    _, params, tm = _pair(baseline, seed=30)
    got = convert_mhim({k: v.numpy() for k, v in tm.state_dict().items()})
    want_leaves, want_def = jax.tree_util.tree_flatten(params)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)
    assert from_jax_params(params, "pure").keys() == tm.state_dict().keys()


@pytest.mark.parametrize("arch", ["mhim", "pure"])
@pytest.mark.parametrize("baseline", ["attn", "selfattn"])
def test_registry_builds_with_the_jax_family_and_defaults(arch, baseline):
    """The script's defaults (act and da_act relu, dropout 0.25, ratios 0,
    hr 1), and registry builds at the script's widths whose tensors have
    their JAX twins' zeros and spreads (xavier-normal Linears, torch-default
    convs, N(0, 1) cls token)."""
    d = dict(arch=arch, n_class=2, D_feat=384, seed=3, baseline=baseline)
    jm, jfam = jax_build_model(JaxConfig.from_dict(d))
    tm, fam = build_mil_model(Config.from_dict(d))
    assert fam == jfam == arch
    assert (tm.act, tm.droprate, tm.mask_ratio, tm.mask_ratio_hr) == (
        jm.act, jm.droprate, jm.mask_ratio, jm.mask_ratio_hr)
    if baseline == "attn":
        assert tm.online_encoder.attention.act == jm.da_act == "relu"
    want = from_jax_params(_np_tree(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 384)),
        jnp.ones((1, 16), bool))["params"]), arch)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if not w.any() or (w == 1).all():
            assert torch.equal(got[k], w), k
        elif w.numel() >= 1000:
            ratio = float(got[k].std() / w.std())
            assert 0.9 < ratio < 1.1, (k, ratio)


@pytest.mark.parametrize("pos", ["peg", "sincos", "none"])
def test_registry_takes_every_pos(pos):
    model, _ = build_mil_model(Config.from_dict(dict(
        arch="mhim", n_class=2, D_feat=D, mlp_dim=MLP, pos=pos)))
    assert model.online_encoder.pos == pos
    out = model(torch.randn(1, 50, D))
    assert out["logits"].shape == (1, 2)
