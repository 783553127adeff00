"""The port's CLAM slice (acmil_tpu_torch: models/clam.py, ops/topk_svm.py,
the softmax-one pooling ``ops/attn_pool.py::gated_attn_pool_grad_one``,
models/fast.py's CLAM route, CLAMFamily, cli/step3_generic.py and
cli/predict.py on CLAM heads) against the JAX package, on the same numpy
inputs and the same weights.

On the CPU the port's B1/B2 wrappers take their plain versions and the JAX
side runs its Pallas kernels in interpret mode. Everything is float32:
XLA and torch sum in other orders, so values agree within ATOL/RTOL and
gradients within GRAD_ATOL/GRAD_RTOL.
"""

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
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.engine import make_train_step as jax_make_step
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models import fast as jax_fast
from acmil_tpu.models.clam import CLAM_MB as JaxCLAM_MB
from acmil_tpu.models.clam import CLAM_SB as JaxCLAM_SB
from acmil_tpu.ops import attn_pool as jax_ap
from acmil_tpu.ops import topk_svm as jax_svm
from acmil_tpu_torch.cli import predict, step3_generic, step4_heatmap
from acmil_tpu_torch.cli import train as port_cli
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_eval_step,
                                    make_train_step)
from acmil_tpu_torch.models import CLAM_MB, CLAM_SB, build_mil_model, fast
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops import attn_pool, topk_svm
from scripts.import_torch_checkpoint import convert_clam
from tests.conftest import make_synthetic_bags

D, L, A = 32, 16, 16
ATOL, RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"clam_sb": (JaxCLAM_SB, CLAM_SB), "clam_mb": (JaxCLAM_MB, CLAM_MB)}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _pair(arch, n_class=2, seed=0, droprate=0.0, **kw):
    """The flax CLAM with every parameter drawn from a seeded normal (biases
    too, so that they are exercised) and the port's module holding the same
    weights."""
    jcls, tcls = ARCHS[arch]
    kw = dict(n_class=n_class, d_inner=L, d_attn=A, droprate=droprate, **kw)
    jm = jcls(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, D)),
                     jnp.ones((1, 8), bool))["params"]
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32), params)
    tm = tcls(d_feat=D, **kw)
    tm.load_state_dict(from_jax_params(params, arch, droprate))
    return jm, params, tm.eval()


def _bag_arrays(seed, b=3, n=300, n_class=2):
    """Bag 0 mostly valid, bag 1 with 10 valid rows (under 2 k_sample = 16),
    bag 2 all masked."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    if b > 1:
        mask[1] = False
        mask[1, rs.choice(n, 10, replace=False)] = True
    if b > 2:
        mask[2] = False
    return feats, mask, rs.randint(0, n_class, b)


def _bags(feats, mask, labels):
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.zeros(feats.shape[:2] + (2,), jnp.int32),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.zeros(feats.shape[:2] + (2,), dtype=torch.int32),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _check_outputs(got, want, mask, name=""):
    _close(got["logits"].detach().numpy(), want["logits"], name=name + "logits")
    _close(got["bag_feat"].detach().numpy(), want["bag_feat"],
           name=name + "bag_feat")
    valid = np.broadcast_to(mask[:, None, :], got["attn"].shape)
    _close(got["attn"].detach().numpy()[valid], np.asarray(want["attn"])[valid],
           name=name + "attn")
    if "instance_loss" in want:
        _close(got["instance_loss"].item(), float(want["instance_loss"]),
               name=name + "instance_loss")


# ---------------------------------------------------------------------------
# Weights: the converters both ways, names and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
@pytest.mark.parametrize("droprate", [0.0, 0.25])
def test_from_jax_params_inverts_convert_clam(arch, droprate):
    conf = Config.from_dict(dict(arch=arch, n_class=3, D_feat=D, D_inner=L,
                                 droprate=droprate, seed=5))
    tm, family = build_mil_model(conf)
    assert family == "clam"
    sd = tm.state_dict()
    at = 3 if droprate else 2
    assert f"attention_net.{at}.attention_a.0.weight" in sd
    params = convert_clam({k: v.numpy() for k, v in sd.items()})
    assert ("bag_w" in params) == (arch == "clam_mb")
    back = from_jax_params(params, arch, droprate)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the flax model on the converted tree equals the port's forward
    jcls, _ = ARCHS[arch]
    jm = jcls(n_class=3, d_inner=L, droprate=droprate)
    feats, mask, _ = _bag_arrays(1)
    want = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                    jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(feats), torch.from_numpy(mask))
    _check_outputs(got, want, mask)


def test_init_is_xavier_normal_from_the_generator():
    def build(seed):
        return CLAM_MB(n_class=4, d_feat=384, d_inner=128,
                       generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert (p == 0).all(), name
        else:
            assert not torch.equal(p, r), name
    w = a.attention_net[0].weight.detach()
    assert abs(float(w.std()) - (2 / (384 + 128)) ** 0.5) < 2e-3
    inst = torch.stack([m.weight for m in a.instance_classifiers]).detach()
    assert abs(float(inst.std()) - (2 / 130) ** 0.5) < 0.02
    bag = torch.cat([m.weight for m in a.classifiers]).detach()
    assert abs(float(bag.std()) - (2 / 129) ** 0.5) < 0.03


# ---------------------------------------------------------------------------
# The modules against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
@pytest.mark.parametrize("n_class, subtyping", [(2, None), (2, True),
                                                (3, None), (3, False)])
@pytest.mark.parametrize("inst_loss", ["ce", "svm"])
def test_module_matches_flax(arch, n_class, subtyping, inst_loss):
    jm, params, tm = _pair(arch, n_class, seed=2, subtyping=subtyping,
                           inst_loss=inst_loss)
    feats, mask, labels = _bag_arrays(3, n_class=n_class)
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                    label=jnp.asarray(labels), instance_eval=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                 label=torch.from_numpy(labels), instance_eval=True)
    _check_outputs(got, want, mask)
    assert float(got["instance_loss"]) > 0
    # the all-masked bag pools to 0 and scores its classifier's bias
    assert (got["bag_feat"][2] == 0).all()


@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
def test_module_without_mask_matches_flax(arch):
    jm, params, tm = _pair(arch, 3, seed=4)
    feats, _, labels = _bag_arrays(5, b=2, n=40, n_class=3)
    want = jm.apply({"params": params}, jnp.asarray(feats), None,
                    label=jnp.asarray(labels), instance_eval=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), None,
                 label=torch.from_numpy(labels), instance_eval=True)
    _check_outputs(got, want, np.ones(feats.shape[:2], bool))


def test_fp16_features_compute_in_the_weights_dtype():
    _, _, tm = _pair("clam_mb", 3, seed=6)
    feats, mask, _ = _bag_arrays(7)
    feats = feats.astype(np.float16).astype(np.float32)
    with torch.no_grad():
        half = tm(torch.from_numpy(feats).half(), torch.from_numpy(mask))
        full = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    for k in half:
        assert half[k].dtype == torch.float32 and torch.equal(half[k],
                                                              full[k]), k


def test_dropout_runs_only_in_training_with_the_generator():
    _, _, tm = _pair("clam_sb", 2, seed=8, droprate=0.25)
    feats, mask, labels = _bag_arrays(9)
    x, m = torch.from_numpy(feats), torch.from_numpy(mask)

    def run(seed, det):
        g = torch.Generator().manual_seed(seed)
        return tm(x, m, deterministic=det, generator=g)["logits"]

    tm.train()
    assert torch.equal(run(0, False), run(0, False))
    assert not torch.equal(run(0, False), run(1, False))
    assert torch.equal(run(0, True), run(1, True))
    tm.eval()
    assert torch.equal(run(0, False), run(0, True))


def test_instance_eval_needs_labels():
    _, _, tm = _pair("clam_sb")
    with pytest.raises(ValueError, match="labels"):
        tm(torch.zeros(1, 4, D), instance_eval=True)


# ---------------------------------------------------------------------------
# The softmax-one pooling and its plain twin against JAX
# ---------------------------------------------------------------------------

def _pool_inputs(seed, k, b=3, n=300):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1] = False                                  # an all-masked bag
    ws = [(rs.randn(*sh) * 0.3).astype(np.float32)
          for sh in [(D, L), (L,), (L, A), (A,), (L, A), (A,), (A, k), (k,)]]
    # cotangents nonzero at pad slots too
    d_bag = rs.randn(b, k, L).astype(np.float32)
    d_logits = rs.randn(b, k, n).astype(np.float32)
    return feats, mask, ws, d_bag, d_logits


def _jax_pool_vjp(feats, mask, ws, d_bag, d_logits):
    m = jnp.asarray(mask)

    def f(x, *w):
        return jax_ap.gated_attn_pool_grad_one(x, m, *w, 128)

    (bag, logits), vjp = jax.vjp(f, jnp.asarray(feats),
                                 *map(jnp.asarray, ws))
    return bag, logits, vjp((jnp.asarray(d_bag), jnp.asarray(d_logits)))


def _torch_pool_vjp(fn, feats, mask, ws, d_bag, d_logits):
    x = torch.from_numpy(feats).requires_grad_()
    w = [torch.from_numpy(a).requires_grad_() for a in ws]
    bag, logits = fn(x, torch.from_numpy(mask), *w)
    grads = torch.autograd.grad((bag, logits), [x, *w],
                                (torch.from_numpy(d_bag),
                                 torch.from_numpy(d_logits)))
    return bag.detach(), logits.detach(), grads


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("fn", ["gated_attn_pool_one_reference",
                                "gated_attn_pool_grad_one"])
def test_softmax_one_pooling_matches_jax(k, fn):
    """The plain twin (autograd) and the wrapper's CPU route (the twin
    forward, B2's plain closed form under lse₁ backward) against the JAX
    wrapper in interpret mode: value and every gradient."""
    args = _pool_inputs(10 + k, k)
    feats, mask = args[:2]
    bag_j, logits_j, grads_j = _jax_pool_vjp(*args)
    bag, logits, grads = _torch_pool_vjp(getattr(attn_pool, fn), *args)
    _close(bag.numpy(), bag_j, name="bag")
    assert (bag.numpy()[-1] == 0).all() and np.isfinite(bag.numpy()).all()
    valid = np.broadcast_to(mask[:, None, :], logits.shape)
    _close(logits.numpy()[valid], np.asarray(logits_j)[valid], name="logits")
    assert (logits.numpy()[~valid] == attn_pool.NEG).all()
    names = ["dx", "dW1", "db1", "dV", "dbv", "dU", "dbu", "dw", "dbw"]
    for g, w, name in zip(grads, grads_j, names):
        assert np.isfinite(g.numpy()).all(), name
        _close(g.numpy(), w, atol=GRAD_ATOL, rtol=GRAD_RTOL, name=name)


def test_softmax_one_pooling_counts_no_launch_on_the_cpu():
    args = _pool_inputs(20, 2)
    before = (attn_pool.fused_gated_attn_pool_batched.launches,
              attn_pool.fused_gated_attn_pool_bwd.launches)
    _torch_pool_vjp(attn_pool.gated_attn_pool_grad_one, *args)
    assert (attn_pool.fused_gated_attn_pool_batched.launches,
            attn_pool.fused_gated_attn_pool_bwd.launches) == before


# ---------------------------------------------------------------------------
# topk_svm against JAX
# ---------------------------------------------------------------------------

def _svm_inputs(seed, c=5, rows=12):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, c).astype(np.float32) * 2,
            rs.randint(0, c, rows), rs.rand(rows) < 0.7)


@pytest.mark.parametrize("alpha, tau", [(1.0, 1.0), (0.5, 0.3)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_smooth_top1_svm_matches_jax(alpha, tau, with_valid):
    s, y, v = _svm_inputs(0)
    kw = dict(alpha=alpha, tau=tau)
    vj = jnp.asarray(v) if with_valid else None
    vt = torch.from_numpy(v) if with_valid else None
    want, gw = jax.value_and_grad(
        lambda x: jax_svm.smooth_top1_svm_loss(x, jnp.asarray(y), valid=vj,
                                               **kw))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_()
    got = topk_svm.smooth_top1_svm_loss(x, torch.from_numpy(y), valid=vt,
                                        **kw)
    got.backward()
    _close(got.item(), float(want))
    _close(x.grad.numpy(), gw, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_smooth_topk_svm_matches_jax(k):
    s, y, v = _svm_inputs(1)
    want, gw = jax.value_and_grad(
        lambda x: jax_svm.smooth_topk_svm_loss(
            x, jnp.asarray(y), k, alpha=0.8, tau=0.5,
            valid=jnp.asarray(v)))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_()
    got = topk_svm.smooth_topk_svm_loss(x, torch.from_numpy(y), k, alpha=0.8,
                                        tau=0.5, valid=torch.from_numpy(v))
    got.backward()
    _close(got.item(), float(want))
    _close(x.grad.numpy(), gw, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_log_elementary_symmetric_matches_jax():
    s, y, _ = _svm_inputs(2)
    logx = np.where(np.eye(5, dtype=bool)[y], -np.inf, s).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax_svm.log_elementary_symmetric(x, 4),
                        jnp.asarray(logx))
    x = torch.from_numpy(logx).requires_grad_()
    got = topk_svm.log_elementary_symmetric(x, 4)
    ct = np.random.RandomState(3).randn(*got.shape).astype(np.float32)
    ct[~np.isfinite(np.asarray(want))] = 0.0
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    gw = vjp(jnp.asarray(ct))[0]
    assert np.isfinite(x.grad.numpy()).all()
    _close(x.grad.numpy(), gw, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_hard_svm_matches_jax(k):
    s, y, _ = _svm_inputs(4)
    want = jax_svm.topk_hard_svm_loss(jnp.asarray(s), jnp.asarray(y), k, 0.7)
    got = topk_svm.topk_hard_svm_loss(torch.from_numpy(s),
                                      torch.from_numpy(y), k, 0.7)
    _close(got.item(), float(want))


# ---------------------------------------------------------------------------
# The fused route (B1/B2's plain versions here) and the family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
@pytest.mark.parametrize("n_class", [2, 4])
def test_clam_apply_fused_matches_jax(arch, n_class):
    jm, params, tm = _pair(arch, n_class, seed=12)
    feats, mask, labels = _bag_arrays(13, n_class=n_class)
    feats = feats.astype(np.float16).astype(np.float32)     # fp16 on the wire
    kw = dict(n_class=n_class, k_sample=8, subtyping=n_class > 2)
    want = jax_fast.clam_apply_fused(params, jnp.asarray(feats),
                                     jnp.asarray(mask),
                                     label=jnp.asarray(labels),
                                     instance_eval=True, chunk=128, **kw)
    with torch.no_grad():
        got = fast.clam_apply_fused(tm, torch.from_numpy(feats).half(),
                                    torch.from_numpy(mask),
                                    label=torch.from_numpy(labels),
                                    instance_eval=True, **kw)
        plain = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                   label=torch.from_numpy(labels), instance_eval=True)
    _check_outputs(got, want, mask, "fused vs jax: ")
    _check_outputs(got, {k: v.numpy() for k, v in plain.items()}, mask,
                   "fused vs plain: ")
    assert fast.clam_is_fusable(tm)


def test_ungated_clam_is_not_fusable():
    tm = CLAM_SB(n_class=2, d_feat=D, d_inner=L, gate=False, droprate=0)
    assert not fast.clam_is_fusable(tm)
    assert "attention_net.2.module.0.weight" in tm.state_dict()
    out = tm.eval()(torch.randn(1, 20, D), torch.ones(1, 20, dtype=torch.bool))
    assert out["attn"].shape == (1, 1, 20)


@pytest.mark.parametrize("keys, fused", [
    (dict(droprate=0), True), ({}, False), (dict(droprate=0.1), False),
    (dict(droprate=0, inst_loss="svm"), False),
    (dict(droprate=0, fused_train=False), False)])
def test_conf_dict_routes_as_jax(keys, fused):
    d = dict(arch="clam_mb", n_class=3, D_feat=D, D_inner=L, **keys)
    got = get_family("clam").conf_dict(Config.from_dict(d))
    want = jax_get_family("clam").conf_dict(JaxConfig.from_dict(d))
    assert got == want and got["fused"] == fused
    assert got["subtyping"] and got["k_sample"] == 8


@pytest.mark.parametrize("threshold, n, routed", [
    (0, 300, True), (None, 300, False), (256, 256, True), (257, 256, False)])
def test_family_routes_by_fuse_min_n(threshold, n, routed, monkeypatch):
    _, _, tm = _pair("clam_sb", seed=14)
    _, tb = _bags(*_bag_arrays(15, n=n))
    if threshold is not None:
        monkeypatch.setattr(fast, "FUSE_MIN_N", threshold)
    calls = []
    real = fast.clam_apply_fused
    monkeypatch.setattr(fast, "clam_apply_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fam = get_family("clam")
    with torch.no_grad():
        out = fam.eval_outputs(tm, tb)
        plain = fam.eval_outputs(tm, tb, fused=False)
    assert bool(calls) == routed
    _close(fam.probs(out).numpy(), fam.probs(plain).numpy())
    conf_d = fam.conf_dict(Config.from_dict(dict(arch="clam_sb", droprate=0)))
    calls.clear()
    fam.train_outputs(tm.train(), tb, conf_d)
    assert bool(calls) == routed


def _torch_grads(model):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
@pytest.mark.parametrize("n_class, fuse", [(2, True), (4, True), (2, False)])
def test_one_step_loss_and_grads_match_jax(arch, n_class, fuse, monkeypatch):
    """The family's training loss (bag CE mixed with the instance loss) and
    every gradient, at droprate 0, against the JAX family; ``fuse`` pins
    both packages' FUSE_MIN_N to 0, so both take their fused route (JAX's
    Pallas kernels in interpret mode, the port's plain B1/B2 versions)."""
    if fuse:
        monkeypatch.setattr(jax_fast, "FUSE_MIN_N", 0)
        monkeypatch.setattr(fast, "FUSE_MIN_N", 0)
    d = dict(arch=arch, n_class=n_class, D_feat=D, D_inner=L, droprate=0,
             w_loss=0.6)
    jconf, conf = JaxConfig.from_dict(d), Config.from_dict(d)
    jm, params, tm = _pair(arch, n_class, seed=16)
    jb, tb = _bags(*_bag_arrays(17, n_class=n_class))
    jfam, fam = jax_get_family("clam"), get_family("clam")
    jconf_d, conf_d = jfam.conf_dict(jconf), fam.conf_dict(conf)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jb, {"dropout": key}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)

    (loss_j, parts_j), grads_j = jax.value_and_grad(loss_fn,
                                                    has_aux=True)(params)
    tm.train()
    out = fam.train_outputs(tm, tb, conf_d)
    loss, parts = fam.loss(out, tb, tb.mask.any(dim=1), conf_d)
    loss.backward()
    _close(loss.item(), float(loss_j), name="loss")
    for k in ("bag_loss", "instance_loss"):
        _close(parts[k].item(), float(parts_j[k]), name=k)
    want = from_jax_params(_np_tree(grads_j), arch, 0.0)
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
               name=name)


@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
def test_five_adamw_steps_match_jax(arch):
    d = dict(arch=arch, n_class=3, D_feat=D, D_inner=L, droprate=0, lr=1e-3,
             train_epoch=2, seed=0)
    jconf, conf = JaxConfig.from_dict(d), Config.from_dict(d)
    jm, _ = jax_build_model(jconf)
    arrays = [_bag_arrays(30 + i, b=1, n=120 + 90 * i, n_class=3)
              for i in range(3)]
    bags = [_bags(*a) for a in arrays]
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], 3)
    tm, _ = build_mil_model(conf)
    p0 = from_jax_params(_np_tree(jstate.params), arch, 0.0)
    tm.load_state_dict(p0)
    state = create_train_state(tm, conf, 3)
    jstep = jax_make_step(jm, jconf, "clam")
    step = make_train_step(tm, conf, "clam")
    for i in range(5):
        jb, tb = bags[i % 3]
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb)
        for k in ("loss", "bag_loss", "instance_loss"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    want = from_jax_params(_np_tree(jstate.params), arch, 0.0)
    # SB's one attention branch: its output bias shifts every logit alike,
    # which the softmax ignores, so its gradient is 0 in exact arithmetic
    # and both packages step it by AdamW-normalised rounding noise (at most
    # lr a step); MB's softmax-one sees the shift against its phantom logit
    noise = "attention_net.2.attention_c.bias" if arch == "clam_sb" else None
    for name, p in tm.named_parameters():
        d_want = (want[name] - p0[name]).numpy()
        d_got = p.detach().numpy() - p0[name].numpy()
        if name == noise:
            assert np.abs(d_got).max() <= 5 * conf.lr * (1 + 1e-6)
            continue
        assert np.abs(d_want).max() > 0.1 * conf.lr, name
        _close(d_got, d_want, atol=1e-4 * np.abs(d_want).max(), rtol=1e-3,
               name=name)


# ---------------------------------------------------------------------------
# The CLIs: Step3 training, predict, Step4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small H5 dump with a frozen split file, the same bags as a torch
    feature file, and a YAML naming both."""
    d = tmp_path_factory.mktemp("clam")
    slides = make_synthetic_bags(n_slides=12, d=D, seed=5, min_len=10,
                                 max_len=200)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:8], "val_names": names[8:10],
                   "test_names": names[10:]}, f)
    return d, slides


def _run_conf(d, tag, arch, **kw):
    out = dict(dataset="camelyon", n_class=2, D_feat=D, D_inner=L, arch=arch,
               lr=1e-3, train_epoch=2, min_bucket=256, seed=0, droprate=0,
               pretrain="tiny", data_dir=str(d), split_dir=str(d / "splits"),
               ckpt_dir=str(d / tag / "ckpt"), log_dir=str(d / tag / "log"))
    out.update(kw)
    return out


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "_config" not in r]


@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
def test_step3_generic_trains_and_scores_as_jax(corpus, monkeypatch,
                                                tmp_path, arch):
    """Two epochs of ``cli/step3_generic.py --arch ARCH --device cpu``
    against ``acmil_tpu.cli.train.run_training`` from the same weights, then
    ``cli/predict.py`` on the best checkpoint against the JAX eval step."""
    d, slides = corpus
    jconf = JaxConfig.from_dict(_run_conf(d, f"jax_{arch}", arch))
    jax_best = jax_cli.run_training(jconf)
    p_rng, s_rng, d_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    jm, _ = jax_build_model(jconf)
    params = jm.init({"params": p_rng, "stkim": s_rng, "dropout": d_rng},
                     jnp.zeros((1, 256, D)), jnp.ones((1, 256), bool))["params"]
    real_build = port_cli.build_mil_model

    def build_from_jax(c):
        model, family = real_build(c)
        model.load_state_dict(from_jax_params(_np_tree(params), arch, 0.0))
        return model, family

    monkeypatch.setattr(port_cli, "build_mil_model", build_from_jax)
    yml = d / f"port_{arch}.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, f"port_{arch}", arch)))
    best = step3_generic.main(["--config", str(yml), "--device", "cpu"])
    want = _epochs(jconf.log_dir)
    got = _epochs(str(d / f"port_{arch}" / "log"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train/loss", "train/bag_loss", "train/instance_loss",
                    "perf/val_loss", "perf/test_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
        for key in ("perf/val_auc", "perf/test_auc", "perf/test_acc"):
            assert g[key] == w[key], key
    assert best["epoch"] == jax_best["epoch"]

    ckpt_dir = str(d / f"port_{arch}" / "ckpt")
    ck = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "best"))
    assert ck["config"]["arch"] == arch and ck["config"]["droprate"] == 0
    pyml = tmp_path / "predict.yml"
    pyml.write_text(yaml.safe_dump({"n_class": 2, "arch": "ga"}))
    res = predict.main(["--config", str(pyml), "--ckpt", ckpt_dir,
                        "--features", str(d / "feats.pt"), "--out_csv",
                        str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert len(res["rows"]) == len(slides)
    jparams = convert_clam({k: v.numpy() for k, v in ck["model"].items()})
    jstep = jax_make_eval_step(jm, "clam")
    for row in res["rows"]:
        item = slides[row[0]]
        jbag = jax_bags.pad_bag(item["feat"], item["coords"], item["label"],
                                dtype=np.float16)
        want_p = np.asarray(jstep(jax.tree_util.tree_map(jnp.asarray,
                                                         jparams), jbag))[0]
        _close(row[2:4], want_p, name=row[0])
        assert row[-1] == int(np.argmax(row[2:4]))


@pytest.mark.parametrize("arch", ["clam_sb", "clam_mb"])
def test_step4_scores_clam_attention_as_the_jax_formula(corpus, tmp_path,
                                                        arch):
    """``cli/step4_heatmap.py``'s attention on a CLAM head: the output
    dict's ``attn``, a masked softmax per branch, the branch mean, times
    n, as the JAX Step4 computes it."""
    from acmil_tpu.ops.masked import masked_softmax as jax_masked_softmax

    d, slides = corpus
    jm, params, tm = _pair(arch, 2, seed=18)
    name = sorted(slides)[0]
    x = torch.from_numpy(slides[name]["feat"].astype(np.float32))[None]
    m = torch.ones(x.shape[:2], dtype=torch.bool)
    got = step4_heatmap.attention_probs(tm, Bag(x, m, None, None), "clam")
    a = jm.apply({"params": params}, jnp.asarray(x.numpy()), jnp.asarray(
        m.numpy()), deterministic=True)["attn"]
    want = jax_masked_softmax(a, jnp.asarray(m.numpy())[:, None, :]).mean(1)
    _close(got.numpy(), want)
    assert not step4_heatmap.uses_kernel(tm, torch.device("cpu"))
    assert step4_heatmap.uses_kernel(tm, torch.device("cuda"))


def test_step3_generic_needs_a_card_unless_told_cpu(corpus, monkeypatch):
    d, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        step3_generic.main(["--config", os.path.join(
            REPO, "config", "camelyon_medical_ssl_config.yml"), "--arch",
            "clam_sb", "--data_dir", str(d)])
