"""DTFD in the port against the JAX package, on the same numpy inputs and
weights: the eval grouping's uniforms (``ops/prng.py``) bit for bit, the
stable grouping and ``jax.lax.top_k``'s tie order, the module in each
distill mode (with padding, with saturated CAM probabilities that tie),
the kernels' route (``models/fast.py::dtfd_apply_fused``, the plain
versions of B1 and B2 here) against the plain forward, the family's loss
and gradients, one coupled-L2 Adam step with per-module clipping against
``make_tx``, five train steps against JAX's, the CLIs, the checkpoint's
config keys and Step4's refusal.

The training grouping's uniforms cannot be drawn alike in both packages, so
the port gets the very draws the JAX side makes: ``jax.random.uniform`` on
the key flax derives for the module's ``make_rng("stkim")``.
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import acmil_tpu.models.dtfd as jax_dtfd
from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import checkpoint as jax_checkpoint
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.engine import make_train_step as jax_make_step
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models import fast as jax_fast
from acmil_tpu.ops import masked as jax_masked
from acmil_tpu_torch.cli import predict, step3_dtfd, step4_heatmap
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_train_step)
from acmil_tpu_torch.engine.train import step_optimizer
from acmil_tpu_torch.models import build_mil_model, dtfd, fast
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops import prng
from tests.conftest import make_synthetic_bags

D, L_DIM, N_CLASS = 32, 16, 2
# float32 on both sides; torch and XLA sum in other orders
ATOL, RTOL = 1e-5, 1e-4
# gradients through two softmaxes and a reduction GEMM
GRAD_ATOL, GRAD_RTOL = 3e-5, 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _confs(**kw):
    d = dict(n_class=N_CLASS, D_feat=D, D_inner=L_DIM, arch="dtfd",
             numGroup=4, total_instance=8, distill="MaxMinS", lr=1e-3,
             wd=1e-4, train_epoch=2, seed=0)
    d.update(kw)
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _pair(seed=0, **kw):
    """The flax model and params and the port's model with the same
    weights (the JAX family's d_attn is 128, the port's default)."""
    jconf, conf = _confs(**kw)
    jm, _ = jax_build_model(jconf)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, D)),
                     jnp.ones((1, 16), bool))["params"]
    tm, _ = build_mil_model(conf)
    tm.load_state_dict(from_jax_params(_np(params), "dtfd"))
    return jm, params, tm


def _bag_arrays(seed, b=2, n=64, scale=1.0):
    rs = np.random.RandomState(seed)
    feats = (rs.randn(b, n, D) * scale).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, n // 2:] = False                 # a padded tail
    return feats, mask, rs.randint(0, N_CLASS, b)


def _bags(feats, mask, labels):
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.zeros(feats.shape[:2] + (2,), jnp.int32),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.zeros(feats.shape[:2] + (2,), dtype=torch.int32),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _group_u(key, shape):
    """The uniforms the flax module draws from its stkim stream ``key``."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax_fast.derive_stkim_rng(key), shape)))


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# Grouping and selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1000), (2, 4096), (3, 50000)])
def test_eval_uniforms_equal_jax_bit_for_bit(shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))
    got = prng.uniform_key0(shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    cached = prng.eval_uniforms(shape, "cpu")
    assert prng.eval_uniforms(shape, "cpu") is cached
    np.testing.assert_array_equal(cached.numpy(), got)


@pytest.mark.parametrize("b, n, g", [(2, 64, 4), (1, 65536, 4)])
def test_group_permutation_matches_jax(b, n, g):
    # at 65536 f32 uniforms tie a few hundred times: the sort must be stable
    rs = np.random.RandomState(n)
    mask = rs.rand(b, n) < 0.9
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (b, n)))
    if n == 65536:
        assert len(u[0]) - len(np.unique(u[0])) > 50
    jg, jm = jax.jit(jax_dtfd._group_permutation, static_argnums=2)(
        key, jnp.asarray(mask), g)
    tg, tm = dtfd.group_permutation(torch.from_numpy(u), torch.from_numpy(mask),
                                    g)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_num_group_must_divide_the_bag():
    mask = torch.ones(1, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="64 is not a multiple of numGroup 3"):
        dtfd.group_permutation(torch.rand(1, 64), mask, 3)
    with pytest.raises(AssertionError):
        jax_dtfd._group_permutation(jax.random.PRNGKey(0),
                                    jnp.ones((1, 64), bool), 3)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_first_k_breaks_ties_as_lax_top_k(k):
    rs = np.random.RandomState(k)
    score = rs.randint(0, 3, (4, 5, 40)).astype(np.float32)
    score[0, 0] = 1.0                          # one row all tied
    _, want = jax.lax.top_k(jnp.asarray(score), k)
    np.testing.assert_array_equal(dtfd.first_k(torch.from_numpy(score), k),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# The module and the kernels' route
# ---------------------------------------------------------------------------

def _jax_forward(jm, params, feats, mask, key=None):
    if key is None:
        return jax.jit(jm.apply)({"params": params}, feats, mask)
    return jax.jit(partial(jm.apply, deterministic=False))(
        {"params": params}, feats, mask, rngs={"stkim": key})


@pytest.mark.parametrize("bag", ["padded", "ties"])
@pytest.mark.parametrize("distill", ["MaxMinS", "MaxS", "AFS"])
def test_dtfd_matches_flax(distill, bag, monkeypatch):
    jm, params, tm = _pair(seed=1, distill=distill)
    feats, mask, _ = _bag_arrays(2)
    if bag == "ties":
        # a tier-1 weight of -1e3 / +1e3 per class saturates every valid
        # patch's CAM probability to exactly 1 (its features are >= 0), so
        # each group ties throughout and the tie order alone picks the
        # distilled features
        w = np.tile(np.float32([[-1e3, 1e3]]), (L_DIM, 1))
        params = dict(params, tier1_w=jnp.asarray(w))
        tm.classifier.fc.weight.data = torch.from_numpy(w.T.copy())
    scores = []
    real = dtfd.first_k
    monkeypatch.setattr(dtfd, "first_k",
                        lambda s, k: scores.append(s) or real(s, k))
    key = jax.random.PRNGKey(4)
    for train in (True, False):
        want = _jax_forward(jm, params, jnp.asarray(feats), jnp.asarray(mask),
                            key if train else None)
        u = _group_u(key, feats.shape[:2]) if train else None
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                 deterministic=not train, group_u=u)
        assert set(got) == set(want)
        for name in want:
            _close(got[name].detach().numpy(), want[name], name=name)
        np.testing.assert_array_equal(got["group_valid"].numpy(),
                                      np.asarray(want["group_valid"]))
    if bag == "ties" and distill != "AFS":
        top = scores[0]                            # [B, G, S]
        assert int((top == 1.0).sum(-1).min()) > 2


@pytest.mark.parametrize("distill", ["MaxMinS", "AFS"])
def test_fused_route_matches_the_plain_forward(distill):
    # B1/B2's plain versions here; chip_smoke.py phase 20 holds the kernels
    _, _, tm = _pair(seed=2, distill=distill)
    feats, mask, labels = _bag_arrays(3)
    _, tb = _bags(feats, mask, labels)
    u = torch.rand(feats.shape[:2], generator=torch.Generator().manual_seed(0))
    fam = get_family("dtfd")
    conf_d = fam.conf_dict(_confs(distill=distill)[1])
    runs = []
    for route in (fast.dtfd_apply_fused, None):
        tm.zero_grad()
        out = (route(tm, tb.feats, tb.mask, deterministic=False, group_u=u)
               if route else tm(tb.feats, tb.mask, deterministic=False,
                                group_u=u))
        loss, _ = fam.loss(out, tb, tb.mask.any(dim=1), conf_d)
        loss.backward()
        runs.append((out, {n: p.grad.clone() for n, p in tm.named_parameters()}))
    (fo, fg), (po, pg) = runs
    for name in po:
        _close(fo[name].detach(), po[name].detach(), name=name)
    for name in pg:
        _close(fg[name], pg[name], GRAD_ATOL, GRAD_RTOL, name=name)
    with torch.no_grad():
        ev = fast.dtfd_apply_fused(tm, tb.feats, tb.mask)
        pe = tm(tb.feats, tb.mask)
    _close(ev["logits"], pe["logits"], name="eval")


# ---------------------------------------------------------------------------
# The family: loss, gradients, the clipped optimizer, five steps
# ---------------------------------------------------------------------------

def _torch_grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("fuse_min_s", [None, 0])
def test_family_loss_and_grads_match_jax(fuse_min_s, monkeypatch):
    monkeypatch.setattr(fast, "DTFD_FUSE_MIN_S", fuse_min_s)
    jm, params, tm = _pair(seed=3)
    jconf, conf = _confs()
    jb, tb = _bags(*_bag_arrays(5))
    jfam, fam = jax_get_family("dtfd"), get_family("dtfd")
    jconf_d, conf_d = jfam.conf_dict(jconf), fam.conf_dict(conf)
    assert conf_d["instance_per_group"] == jconf_d["instance_per_group"] == 2
    key = jax.random.PRNGKey(6)

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jb, {"stkim": key}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    calls = []
    real = fast.dtfd_apply_fused
    monkeypatch.setattr(fast, "dtfd_apply_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = fam.train_outputs(tm, tb, conf_d, stkim_u=_group_u(key, (2, 64)))
    assert len(calls) == (fuse_min_s is not None)
    loss, aux = fam.loss(out, tb, tb.mask.any(dim=1), conf_d)
    loss.backward()
    for name in ("loss0", "loss1"):
        _close(aux[name].item(), aux_j[name], name=name)
    _close(loss.item(), loss_j)
    want = from_jax_params(_np(grads_j), "dtfd")
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), GRAD_ATOL, GRAD_RTOL, name)


def test_one_clipped_adam_step_matches_make_tx():
    """One step from set gradients: the four modules clipped each by its
    own norm (two above the clip, two below), coupled L2, Adam, against the
    JAX family's ``make_tx`` (`tests/test_training_parity.py`)."""
    jm, params, tm = _pair(seed=4)
    lr, wd, clip = 1e-2, 1e-3, 5.0
    rs = np.random.RandomState(7)
    scales = {"DimReduction_0": 30.0, "AttentionGated_0": 0.01,
              "tier1_w": 90.0, "tier1_b": 90.0, "AttentionGated_1": 20.0,
              "Classifier1fc_0": 0.05}
    grads = {k: jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * s).astype(np.float32), params[k])
        for k, s in scales.items()}
    _, conf = _confs(lr=lr, wd=wd, grad_clipping=clip, warmup_epoch=0)
    state = create_train_state(tm, conf, 1, family="dtfd")
    assert state.grad_clip == clip and len(state.clip_groups) == 4
    tgrads = from_jax_params(grads, "dtfd")
    for n, p in tm.named_parameters():
        p.grad = tgrads[n].clone()
    norms = [float(torch.linalg.vector_norm(torch.cat(
        [p.grad.flatten() for p in g]))) for g in state.clip_groups]
    assert any(n > clip for n in norms) and any(n < clip for n in norms)
    step_optimizer(state, list(tm.parameters()))

    tx = jax_get_family("dtfd").make_tx(JaxConfig.from_dict(
        {"wd": wd, "grad_clipping": clip}), lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                           tx.init(jp), jp)
    want = from_jax_params(_np(optax.apply_updates(jp, updates)), "dtfd")
    for n, p in tm.named_parameters():
        _close(p.detach().numpy(), want[n].numpy(), 1e-6, 2e-5, n)


def test_clip_defaults_to_five_and_zero_turns_it_off():
    _, _, tm = _pair()
    fam = get_family("dtfd")
    assert fam.clip_groups(tm, _confs()[1])[0] == 5.0
    assert fam.clip_groups(tm, _confs(grad_clipping=0)[1]) is None
    state = create_train_state(tm, _confs(grad_clipping=0)[1], 1,
                               family="dtfd")
    assert state.clip_groups is None and state.grad_clip is None
    names = [{n for n, p in tm.named_parameters()
              if any(p is q for q in g)}
             for g in fam.clip_groups(tm, _confs()[1])[1]]
    assert [sorted({n.split(".")[0] for n in g}) for g in names] == [
        ["dimReduction"], ["attention"], ["classifier"], ["UClassifier"]]


def test_five_clipped_steps_match_jax():
    """Per-step losses and final parameters after five steps over two bags
    with the clip engaged (grad_clipping 0.05), the grouping's uniforms the
    JAX side's. Adam divides by sqrt(v), so parameters agree to 5 * lr."""
    jconf, conf = _confs(grad_clipping=0.05, warmup_epoch=0)
    jm, _ = jax_build_model(jconf)
    bags = [_bags(*_bag_arrays(20 + i, b=1 + i, n=64 + 64 * i))
            for i in range(2)]
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], 2, family="dtfd")
    tm, _ = build_mil_model(conf)
    tm.load_state_dict(from_jax_params(_np(jstate.params), "dtfd"))
    state = create_train_state(tm, conf, 2, family="dtfd")
    jstep = jax_make_step(jm, jconf, "dtfd")
    step = make_train_step(tm, conf, "dtfd")
    for i in range(5):
        jb, tb = bags[i % 2]
        s_rng, _ = jax.random.split(jax.random.fold_in(rng, i))
        u = _group_u(s_rng, tuple(tb.mask.shape))
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb, stkim_u=u)
        for k in ("loss", "loss0", "loss1", "grad_norm"):
            _close(float(aux[k]), float(jaux[k]), 0, 1e-4, f"step {i} {k}")
    want = from_jax_params(_np(jstate.params), "dtfd")
    for name, p in tm.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), 5 * conf.lr, 0, name)


# ---------------------------------------------------------------------------
# The CLIs, checkpoints and Step4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dtfd")
    slides = make_synthetic_bags(n_slides=10, d=D, seed=5, min_len=40,
                                 max_len=200)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:6], "val_names": names[6:8],
                   "test_names": names[8:]}, f)
    yml = d / "dtfd.yml"
    yml.write_text(yaml.safe_dump(dict(
        dataset="camelyon", pretrain="tiny", n_class=N_CLASS, D_feat=D,
        D_inner=L_DIM, lr=1e-3, train_epoch=2, min_bucket=64, seed=0,
        data_dir=str(d), split_dir=str(d / "splits"),
        ckpt_dir=str(d / "ckpt"), log_dir=str(d / "log"))))
    return d, slides, yml


def _to_flax(sd):
    """The port's DTFD state dict → the flax tree (``_dtfd``'s inverse)."""
    lin = lambda p, bias=True: {"kernel": sd[f"{p}.weight"].numpy().T,
                                **({"bias": sd[f"{p}.bias"].numpy()}
                                   if bias else {})}
    gated = lambda p: {"Dense_0": lin(f"{p}.attention_V.0"),
                       "Dense_1": lin(f"{p}.attention_U.0"),
                       "Dense_2": lin(f"{p}.attention_weights")}
    return {"DimReduction_0": {"Dense_0": lin("dimReduction.fc1", False)},
            "AttentionGated_0": gated("attention"),
            "tier1_w": sd["classifier.fc.weight"].numpy().T,
            "tier1_b": sd["classifier.fc.bias"].numpy(),
            "AttentionGated_1": gated("UClassifier.attention"),
            "Classifier1fc_0": {"Dense_0": lin("UClassifier.classifier.fc")}}


def test_dtfd_cli_trains_and_its_checkpoint_scores_as_jax(corpus, monkeypatch,
                                                          tmp_path):
    d, slides, yml = corpus
    # the kernels' route (their plain versions here) in training and eval
    monkeypatch.setattr(fast, "DTFD_FUSE_MIN_S", 0)
    best = step3_dtfd.main(["--config", str(yml), "--distill", "MaxS",
                            "--grad_clipping", "2.0", "--device", "cpu"])
    assert np.isfinite(best["auc"]) or np.isnan(best["auc"])
    with open(d / "log" / "metrics.jsonl") as f:
        epochs = [r for r in map(json.loads, f) if "_config" not in r]
    assert len(epochs) == 2
    assert all(np.isfinite(e["train/loss0"]) and np.isfinite(e["train/loss1"])
               for e in epochs)
    ck = checkpoint.load(checkpoint.checkpoint_path(str(d / "ckpt"), "best"))
    assert ck["config"]["arch"] == "dtfd"
    assert ck["config"]["distill"] == "MaxS"
    assert ck["config"]["grad_clipping"] == 2.0

    res = predict.main(["--config", str(yml), "--ckpt", str(d / "ckpt"),
                        "--features", str(d / "feats.pt"), "--out_csv",
                        str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert len(res["rows"]) == len(slides)
    # predict builds the YAML's distill (MaxMinS by default), not the
    # checkpoint's: distill is no key of MODEL_CONFIG_KEYS in either package
    jconf = JaxConfig.from_dict({**yaml.safe_load(yml.read_text()),
                                 "arch": "dtfd"})
    jm, _ = jax_build_model(jconf)
    jstep = jax_make_eval_step(jm, "dtfd")
    params = _to_flax(ck["model"])
    for row in res["rows"]:
        item = slides[row[0]]
        jbag = jax_bags.pad_bag(item["feat"], item["coords"], item["label"],
                                min_bucket=64, dtype=np.float16)
        want = np.asarray(jstep(params, jbag))[0]
        _close(row[2:2 + N_CLASS], want, 2e-5, 1e-4, row[0])

    # --eval_only scores the best checkpoint again
    again = step3_dtfd.main(["--config", str(yml), "--eval_only",
                             "--device", "cpu"])
    assert again["auc"] == best["auc"] or np.isnan(best["auc"])


def test_checkpoints_do_not_keep_the_grouping_keys(corpus, monkeypatch,
                                                   tmp_path):
    # neither package's MODEL_CONFIG_KEYS holds numGroup, total_instance or
    # distill: none changes a weight's shape, so predict builds the YAML's
    # grouping (default 4) for a checkpoint trained with 8 groups
    d, slides, yml = corpus
    for keys in (checkpoint.MODEL_CONFIG_KEYS,
                 jax_checkpoint.MODEL_CONFIG_KEYS):
        assert not {"numGroup", "total_instance", "distill"} & set(keys)
    _, conf = _confs(numGroup=8)
    tm, _ = build_mil_model(conf)
    assert tm.num_group == 8
    checkpoint.save(str(tmp_path / "checkpoint-best.pth"), tm, epoch=0,
                    conf=conf)
    built = []
    real = predict.build_mil_model
    monkeypatch.setattr(predict, "build_mil_model",
                        lambda c: built.append(real(c)) or built[-1])
    predict.main(["--config", str(yml), "--ckpt", str(tmp_path),
                  "--features", str(d / "feats.pt"), "--out_csv",
                  str(tmp_path / "p.csv"), "--device", "cpu"])
    assert built[0][0].num_group == 4


def test_step4_refuses_dtfd_by_name():
    # the JAX script's masked softmax cannot broadcast DTFD's [B, G, N/G]
    # attention against the bag's [B, 1, N] mask
    with pytest.raises((TypeError, ValueError)):
        jax_masked.masked_softmax(jnp.zeros((1, 4, 16)),
                                  jnp.ones((1, 1, 64), bool))
    _, _, tm = _pair()
    _, tb = _bags(*_bag_arrays(1))
    with pytest.raises(ValueError, match="DTFD has no per-patch attention"):
        step4_heatmap.attention_probs(tm, tb, "dtfd")
