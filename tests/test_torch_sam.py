"""SAM in the port (``ops/sam.py``, ``use_sam`` in
``engine/train.py::make_train_step``) against the JAX package: the SAM
gradient, plain and adaptive, against ``acmil_tpu.ops.sam.sam_gradient`` on
ACMIL_GA's fused loss; one ``use_sam`` step on ACMIL_GA (STKIM on) and on
DTFD against JAX's ``_make_step_body(use_sam=True)``; the two passes'
random draws (dropout from torch's default generator and from the state's,
DTFD's grouping), which must be the same; the parameters restored bit for
bit; the trainer's CLI with ``use_sam: true``.

STKIM's and DTFD's uniforms come from the JAX side's keys, as in
tests/test_torch_train.py: JAX's two passes close over one rng dict, the
port's get the same tensor twice.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine.train import _conf_dict as jax_conf_dict
from acmil_tpu.engine.train import _make_step_body as jax_step_body
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models import fast as jax_fast
from acmil_tpu.ops.sam import sam_gradient as jax_sam_gradient
from acmil_tpu_torch.cli import step3_acmil
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (create_train_state, families,
                                    get_family, make_train_step)
from acmil_tpu_torch.models import build_mil_model, dtfd
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops.sam import sam_gradient
from tests.conftest import make_synthetic_bags

D, L_DIM, N_CLASS = 32, 16, 2
# the one-step bounds of tests/test_torch_train.py for the fused route; the
# SAM gradient is a gradient at a point that itself carries the first
# gradient's rounding
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 3e-3, 3e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _confs(arch, **kw):
    d = dict(n_class=N_CLASS, D_feat=D, D_inner=L_DIM, arch=arch, n_token=5,
             n_masked_patch=10, mask_drop=0.6, lr=1e-3, wd=1e-4,
             train_epoch=2, seed=0, use_sam=True, sam_rho=0.05)
    d.update(kw)
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _pair(arch, seed=0, **kw):
    jconf, conf = _confs(arch, **kw)
    jm, fam = jax_build_model(jconf)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, D)),
                     jnp.ones((1, 16), bool))["params"]
    tm, _ = build_mil_model(conf)
    tm.load_state_dict(from_jax_params(_np(params), arch))
    return jm, params, tm, jconf, conf, fam


def _bags(seed, b=2, n=64):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, n // 2:] = False
    labels = rs.randint(0, N_CLASS, b)
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.zeros((b, n, 2), jnp.int32),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.zeros((b, n, 2), dtype=torch.int32),
             torch.from_numpy(labels.astype(np.int64)))
    return jb, tb


def _uniforms(arch, key, b, n):
    """What the JAX forward draws from its stkim stream ``key``: STKIM's
    ``[B, K, N]`` (ACMIL_GA) or the grouping's ``[B, N]`` (DTFD)."""
    shape = (b, 5, n) if arch == "ga" else (b, n)
    return torch.from_numpy(np.array(jax.random.uniform(
        jax_fast.derive_stkim_rng(key), shape)))


def _close(got, want, atol, rtol, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=name)


@pytest.mark.parametrize("adaptive", [False, True])
def test_sam_gradient_matches_jax(adaptive):
    jm, params, tm, jconf, conf, _ = _pair("ga", seed=1)
    jb, tb = _bags(3)
    jfam, fam = jax_get_family("acmil"), get_family("acmil")
    jconf_d, conf_d = jfam.conf_dict(jconf), fam.conf_dict(conf)
    key = jax.random.PRNGKey(5)

    def jloss(p):
        out = jfam.train_outputs(jm.apply, p, jb, {"stkim": key,
                                                   "dropout": key}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)

    (loss_j, _), grads_j = jax.jit(lambda p: jax_sam_gradient(
        jloss, p, 0.05, adaptive))(params)
    u = _uniforms("ga", key, 2, 64)
    names = [n for n, _ in tm.named_parameters()]
    ps = [p for _, p in tm.named_parameters()]
    before = [p.detach().clone() for p in ps]

    def loss_fn():
        out = fam.train_outputs(tm, tb, conf_d, stkim_u=u)
        return fam.loss(out, tb, tb.mask.any(dim=1), conf_d)

    (loss, aux), grads = sam_gradient(loss_fn, ps, 0.05, adaptive)
    _close(loss.item(), loss_j, 0, LOSS_RTOL)
    assert not loss.requires_grad
    assert aux and not any(v.requires_grad for v in aux.values())
    want = from_jax_params(_np(grads_j), "ga")
    for n, g, p in zip(names, grads, ps):
        _close(g.numpy(), want[n].numpy(), GRAD_ATOL, GRAD_RTOL, n)
        # each in its parameter's layout (a fused optimizer needs it), also
        # where it comes through a transposed view into the pooling
        assert g.stride() == p.stride(), n
    for p, b in zip(ps, before):                  # restored, bit for bit
        assert torch.equal(p.detach(), b)


@pytest.mark.parametrize("arch", ["ga", "dtfd"])
def test_one_sam_step_matches_jax_step_body(arch):
    jm, params, tm, jconf, conf, fam_name = _pair(arch, seed=2)
    jb, tb = _bags(4)
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, jb, 2, family=fam_name)
    jstate = jstate.replace(params=params)
    jfam = jax_get_family(fam_name)
    body = jax.jit(jax_step_body(jfam, jax_conf_dict(jfam, jconf), True,
                                 0.05))
    jstate, jaux = body(jstate, jb, rng)
    s_rng, _ = jax.random.split(jax.random.fold_in(rng, 0))
    state = create_train_state(tm, conf, 2, family=fam_name)
    step = make_train_step(tm, conf, fam_name)
    aux = step(state, tb, stkim_u=_uniforms(arch, s_rng, 2, 64))
    for k in jaux:
        _close(float(aux[k]), float(jaux[k]), 0, 1e-3, k)
    want = from_jax_params(_np(jstate.params), arch)
    for n, p in tm.named_parameters():
        # Adam's first step is about lr * sign(g): where a gradient is
        # rounding noise (attention biases, shift-invariant under the
        # softmax), the two packages may step it apart by up to lr
        _close(p.detach().numpy(), want[n].numpy(), conf.lr, 0, n)


@pytest.mark.parametrize("arch", ["mha_single", "dtfd"])
def test_both_passes_make_the_same_draws(arch, monkeypatch):
    """Without uniforms given, each pass draws: MHA's dropout from torch's
    default generator, DTFD's grouping and tier-2 dropout from the state's.
    SAM's second pass must see the first pass's draws, and the next step new
    ones."""
    _, conf = _confs(arch, droprate=0.5, dropout=0.5)
    torch.manual_seed(0)
    tm, fam_name = build_mil_model(conf)
    _, tb = _bags(5)
    draws = []
    if arch == "mha_single":
        real = torch.nn.functional.dropout

        def rec(x, p=0.5, training=True, inplace=False):
            out = real(x, p, training, inplace)
            draws.append((out == 0) & (x != 0))
            return out

        monkeypatch.setattr(torch.nn.functional, "dropout", rec)
    else:
        real_u, real_d = dtfd.group_uniforms, dtfd.dropout
        monkeypatch.setattr(dtfd, "group_uniforms", lambda *a: draws.append(
            real_u(*a)) or draws[-1])
        monkeypatch.setattr(dtfd, "dropout", lambda x, p, g: draws.append(
            real_d(x, p, g)) or draws[-1])
    state = create_train_state(tm, conf, 2, family=fam_name)
    step = make_train_step(tm, conf, fam_name)
    step(state, tb)
    half = len(draws) // 2
    assert half >= 1 and len(draws) == 2 * half
    first, second = draws[:half], draws[half:]
    for a, b in zip(first, second):
        if arch == "mha_single":
            assert torch.equal(a, b) and a.any()
        else:
            assert a.shape == b.shape
    if arch == "dtfd":
        # the uniforms equal; the dropped tier-2 features too
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1] == 0, second[1] == 0)
    step(state, tb)
    assert not torch.equal(draws[2 * half], first[0])


def test_use_sam_trains_through_the_acmil_cli(tmp_path, monkeypatch):
    slides = make_synthetic_bags(n_slides=8, d=D, seed=2, min_len=40,
                                 max_len=120)
    write_feature_h5(str(tmp_path / "patch_feats_pretrain_tiny.h5"), slides)
    names = sorted(slides)
    os.makedirs(tmp_path / "splits" / "camelyon")
    with open(tmp_path / "splits" / "camelyon" / "split_4.json", "w") as f:
        json.dump({"train_names": names[:4], "val_names": names[4:6],
                   "test_names": names[6:]}, f)
    yml = tmp_path / "sam.yml"
    yml.write_text(yaml.safe_dump(dict(
        dataset="camelyon", pretrain="tiny", n_class=N_CLASS, D_feat=D,
        D_inner=L_DIM, lr=1e-3, train_epoch=1, min_bucket=128,
        use_sam=True, sam_rho=0.1, data_dir=str(tmp_path),
        split_dir=str(tmp_path / "splits"), ckpt_dir=str(tmp_path / "ckpt"),
        log_dir=str(tmp_path / "log"))))
    calls = []
    real = families.acmil_ga_apply_batched
    monkeypatch.setattr(families, "acmil_ga_apply_batched",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    step3_acmil.main(["--config", str(yml), "--device", "cpu"])
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        epoch = [r for r in map(json.loads, f) if "_config" not in r][0]
    assert np.isfinite(epoch["train/loss"])
    # two fused passes per train step (4 bags), one per val/test bag (4)
    assert len(calls) == 2 * 4 + 4
