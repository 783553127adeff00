"""The port's ACMIL_MHA and MHA heads (acmil_tpu_torch/models/acmil.py)
against the flax modules of acmil_tpu, on the same numpy bags and the same
weights: the modules, the converters both ways, the per-head diversity
loss, one training step, and the CLIs that train and score them.

Weights come from ``model.init`` and cross with
``acmil_tpu_torch.models.convert.from_jax_params``; the reverse direction is
``scripts/import_torch_checkpoint.py::convert_acmil_mha`` /
``convert_mha_single``. STKIM runs inside each branch's logits, under
flax's ``nn.vmap`` with a key per branch: the test reads the uniforms each
branch draws out of a first forward in which ``stkim_mask`` (patched in
``acmil_tpu.models.acmil`` for this test only) returns them in place of the
logits, and hands them to the port. A dropout mask cannot be matched across
frameworks, so training parity runs both sides without dropout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acmil_tpu.models.acmil as jax_acmil
from acmil_tpu.engine import losses as jax_losses
from acmil_tpu_torch.cli import predict, step3_acmil, step3_generic
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import checkpoint, get_family, losses
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.models.acmil import (ACMIL_MHA, MHA, BagAttention,
                                          MultiHeadAttention)
from acmil_tpu_torch.models.convert import from_jax_params
from scripts.import_torch_checkpoint import CONVERTERS
from tests.conftest import make_synthetic_bags

# float32 on both sides; XLA and torch sum in other orders
ATOL, RTOL = 1e-5, 1e-4
# one step's loss and gradients: the bounds tests/test_torch_train.py holds
# ACMIL_GA's step to
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 3e-3, 3e-5
D_FEAT, D_INNER, HEADS, N_CLASS = 32, 16, 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _bag(seed, b=2, n=300, d=D_FEAT):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, d).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, 200:] = False
    return feats, mask


def _valid(mask, a):
    """Valid slots of ``a [..., N]``, broadcast from ``mask [B, N]``."""
    return np.broadcast_to(mask.reshape(mask.shape[:1] + (1,) * (a.ndim - 2)
                                        + mask.shape[1:]), a.shape)


def _pair(arch, seed=0, n_token=5, n_masked_patch=0, mask_drop=0.0,
          droprate=0.1):
    """A flax head with params from ``init`` and the port's head holding the
    same weights (eval mode)."""
    if arch == "mha":
        jm = jax_acmil.ACMIL_MHA(n_class=N_CLASS, d_inner=D_INNER,
                                 n_token=n_token, num_heads=HEADS,
                                 n_masked_patch=n_masked_patch,
                                 mask_drop=mask_drop)
        tm = ACMIL_MHA(N_CLASS, d_feat=D_FEAT, d_inner=D_INNER,
                       n_token=n_token, num_heads=HEADS,
                       n_masked_patch=n_masked_patch, mask_drop=mask_drop,
                       droprate=droprate)
    else:
        jm = jax_acmil.MHA(n_class=N_CLASS, d_inner=D_INNER,
                           num_heads=HEADS)
        tm = MHA(N_CLASS, d_feat=D_FEAT, d_inner=D_INNER, num_heads=HEADS,
                 droprate=droprate)
    params = _np_tree(jm.init({"params": jax.random.PRNGKey(seed),
                               "stkim": jax.random.PRNGKey(1)},
                              jnp.zeros((1, 8, D_FEAT)),
                              jnp.ones((1, 8), bool))["params"])
    # flax draws q at std 1e-6: widen it so the queries shape the attention
    params["q"] = np.random.RandomState(seed).randn(
        *params["q"].shape).astype(np.float32)
    tm.load_state_dict(from_jax_params(params, arch))
    return jm, params, tm.eval()


@pytest.mark.parametrize("n_query, with_mask", [(1, True), (3, True),
                                                (2, False)])
def test_multihead_attention_matches_flax(n_query, with_mask):
    rs = np.random.RandomState(n_query)
    feats, mask = _bag(1, d=D_INNER)
    q = rs.randn(2, n_query, D_INNER).astype(np.float32)
    jm = jax_acmil.MultiHeadAttention(D_INNER, HEADS)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(q),
                              jnp.asarray(feats), jnp.asarray(feats))["params"])
    m = mask if with_mask else None
    out_j, logits_j = jm.apply({"params": params}, jnp.asarray(q),
                               jnp.asarray(feats), jnp.asarray(feats),
                               None if m is None else jnp.asarray(m))
    tm = MultiHeadAttention(D_INNER, HEADS).eval()
    sd = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj", "out_proj")):
        sd[f"{name}.weight"] = torch.tensor(params[f"Dense_{i}"]["kernel"].T)
        sd[f"{name}.bias"] = torch.tensor(params[f"Dense_{i}"]["bias"])
    sd["layer_norm.weight"] = torch.tensor(params["LayerNorm_0"]["scale"])
    sd["layer_norm.bias"] = torch.tensor(params["LayerNorm_0"]["bias"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        out, logits = tm(torch.from_numpy(q), torch.from_numpy(feats),
                         torch.from_numpy(feats),
                         None if m is None else torch.from_numpy(m))
    _close(out.numpy(), out_j)
    assert logits.shape == (2, HEADS, n_query, 300)
    v = np.ones(logits.shape, bool) if m is None else _valid(mask, logits.numpy())
    _close(logits.numpy()[v], np.asarray(logits_j)[v])


def test_bag_attention_matches_flax():
    rs = np.random.RandomState(2)
    feats, mask = _bag(2, d=D_INNER)
    attn = rs.rand(2, HEADS, 1, 300).astype(np.float32) * mask[:, None, None]
    jm = jax_acmil.BagAttention(D_INNER, HEADS)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                              jnp.asarray(attn))["params"])
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(attn))
    tm = BagAttention(D_INNER, HEADS).eval()
    tm.load_state_dict({
        "v_proj.weight": torch.tensor(params["Dense_0"]["kernel"].T),
        "v_proj.bias": torch.tensor(params["Dense_0"]["bias"]),
        "out_proj.weight": torch.tensor(params["Dense_1"]["kernel"].T),
        "out_proj.bias": torch.tensor(params["Dense_1"]["bias"]),
        "layer_norm.weight": torch.tensor(params["LayerNorm_0"]["scale"]),
        "layer_norm.bias": torch.tensor(params["LayerNorm_0"]["bias"])})
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(attn))
    assert got.shape == (2, D_INNER)
    _close(got.numpy(), want)


def test_mha_single_forward_matches_flax():
    jm, params, tm = _pair("mha_single")
    feats, mask = _bag(3)
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    _close(got.numpy(), want)


@pytest.mark.parametrize("n_token", [1, 5])
def test_acmil_mha_forward_matches_flax(n_token):
    jm, params, tm = _pair("mha", n_token=n_token)
    feats, mask = _bag(4)
    sub_j, slide_j, a_j = jm.apply({"params": params}, jnp.asarray(feats),
                                   jnp.asarray(mask), deterministic=True)
    with torch.no_grad():
        sub, slide, a = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    assert a.shape == (2, HEADS, n_token, 300)
    _close(sub.numpy(), sub_j)
    _close(slide.numpy(), slide_j)
    v = _valid(mask, a.numpy())
    _close(a.numpy()[v], np.asarray(a_j)[v])


def _branch_uniforms(jm, params, feats, mask, key, monkeypatch):
    """The uniforms each vmapped branch's STKIM draws from ``key``, as
    ``[B, H, K, N]``: a forward whose ``stkim_mask`` returns them in place
    of the logits emits them as its attention."""
    def uniforms(rng, logits, n_masked_patch, mask_drop, m=None):
        return jax.random.uniform(rng, logits.shape, dtype=jnp.float32)

    with monkeypatch.context() as mp:
        mp.setattr(jax_acmil, "stkim_mask", uniforms)
        _, _, u = jm.apply({"params": params}, jnp.asarray(feats),
                           jnp.asarray(mask), deterministic=True,
                           use_attention_mask=True, rngs={"stkim": key})
    return torch.from_numpy(np.array(u))


def test_acmil_mha_stkim_forward_matches_flax(monkeypatch):
    jm, params, tm = _pair("mha", n_token=5, n_masked_patch=10, mask_drop=0.6)
    feats, mask = _bag(5)
    key = jax.random.PRNGKey(7)
    u = _branch_uniforms(jm, params, feats, mask, key, monkeypatch)
    sub_j, slide_j, a_j = jm.apply({"params": params}, jnp.asarray(feats),
                                   jnp.asarray(mask), deterministic=True,
                                   use_attention_mask=True,
                                   rngs={"stkim": key})
    with torch.no_grad():
        sub, slide, a = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                           use_attention_mask=True, stkim_u=u)
        sub0, _, a0 = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    v = _valid(mask, a.numpy())
    a_j = np.asarray(a_j)
    # each branch drops floor(10 * 0.6) = 6 of its top-10 logits per head
    dropped = (a_j <= -1e8) & v
    assert (dropped.sum(-1) == 6).all()
    assert not torch.allclose(sub, sub0)
    _close(a.numpy()[v], a_j[v])
    _close(sub.numpy(), sub_j)
    _close(slide.numpy(), slide_j)
    # the same branches without uniforms draw from a generator, repeatably
    gen = lambda: torch.Generator().manual_seed(3)
    with torch.no_grad():
        a1 = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                use_attention_mask=True, stkim_generator=gen())[2]
        a2 = tm(torch.from_numpy(feats), torch.from_numpy(mask),
                use_attention_mask=True, stkim_generator=gen())[2]
    assert torch.equal(a1, a2) and ((a1 <= -1e8).numpy() & v).sum(-1).min() == 6


@pytest.mark.parametrize("arch", ["mha", "mha_single"])
def test_converters_invert_from_jax_params(arch):
    """The reference converters read the port's state_dict as it is (the
    reference's torch names) and give back the flax tree."""
    _, params, tm = _pair(arch, n_token=3)
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    back = CONVERTERS[arch](sd)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("with_mask, with_valid", [(True, True),
                                                   (True, False),
                                                   (False, False)])
def test_diversity_loss_per_head_matches_jax(with_mask, with_valid):
    rs = np.random.RandomState(6)
    logits = rs.randn(3, HEADS, 5, 40).astype(np.float32) * 2
    mask = rs.rand(3, 40) < 0.7 if with_mask else None
    valid = np.array([True, False, True]) if with_valid else None
    want = jax_losses.attention_diversity_loss(
        jnp.asarray(logits), None if mask is None else jnp.asarray(mask), 5,
        None if valid is None else jnp.asarray(valid))
    got = losses.attention_diversity_loss(
        torch.from_numpy(logits),
        None if mask is None else torch.from_numpy(mask), 5,
        None if valid is None else torch.from_numpy(valid))
    _close(got.item(), float(want))
    # [B, K, N] stays the one-head case
    three = losses.attention_diversity_loss(
        torch.from_numpy(logits[:, 0]),
        None if mask is None else torch.from_numpy(mask), 5)
    one = losses.attention_diversity_loss(
        torch.from_numpy(logits[:, :1]),
        None if mask is None else torch.from_numpy(mask), 5)
    _close(three.item(), one.item(), atol=0, rtol=0)


def test_acmil_loss_on_mha_outputs_matches_jax():
    jm, params, tm = _pair("mha", n_token=5)
    feats, mask = _bag(7)
    labels = np.array([0, 2])
    sub_j, slide_j, a_j = jm.apply({"params": params}, jnp.asarray(feats),
                                   jnp.asarray(mask))
    valid = jnp.asarray(mask).any(axis=1)
    want, parts_j = jax_losses.acmil_loss(sub_j, slide_j, a_j,
                                          jnp.asarray(labels),
                                          jnp.asarray(mask), 5, valid)
    with torch.no_grad():
        sub, slide, a = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    got, parts = losses.acmil_loss(sub, slide, a, torch.from_numpy(labels),
                                   torch.from_numpy(mask), 5,
                                   torch.from_numpy(mask).any(dim=1))
    _close(got.item(), float(want))
    for k in ("sub_loss", "slide_loss", "diff_loss"):
        _close(parts[k].item(), float(parts_j[k]), name=k)


def _torch_grads(model):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch, stkim", [("mha", True), ("mha", False),
                                         ("mha_single", False)])
def test_one_step_loss_and_grads_match_jax(arch, stkim, monkeypatch):
    """One training step's loss and every gradient through the port's family
    (``train_outputs`` with STKIM from given uniforms, then ``loss``)
    against ``jax.value_and_grad`` of the JAX family's loss, dropout off on
    both sides (flax: ``deterministic=True`` with STKIM asked for; the port:
    ``droprate=0``)."""
    kw = dict(n_masked_patch=10, mask_drop=0.6) if stkim else {}
    jm, params, tm = _pair(arch, seed=2, droprate=0.0, **kw)
    feats, mask = _bag(8)
    labels = np.array([1, 0])
    conf = Config.from_dict(dict(n_class=N_CLASS, n_token=5, **kw))
    family = "acmil" if arch == "mha" else "default"
    from acmil_tpu.engine import get_family as jax_get_family

    jfam, fam = jax_get_family(family), get_family(family)
    key = jax.random.PRNGKey(9)
    jmask = jnp.asarray(mask)
    u = (_branch_uniforms(jm, params, feats, mask, key, monkeypatch)
         if stkim else None)

    def loss_fn(p):
        extra = dict(use_attention_mask=True) if arch == "mha" else {}
        out = jm.apply({"params": p}, jnp.asarray(feats), jmask,
                       deterministic=True, rngs={"stkim": key}, **extra)
        from acmil_tpu.data.bags import Bag as JaxBag

        bag = JaxBag(feats=jnp.asarray(feats), mask=jmask,
                     coords=jnp.zeros((2, 300, 2), jnp.int32),
                     label=jnp.asarray(labels, jnp.int32))
        return jfam.loss(out, bag, jmask.any(axis=1),
                         jfam.conf_dict(conf))[0]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    tm.train()
    bag = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
              torch.zeros((2, 300, 2), dtype=torch.int32),
              torch.from_numpy(labels))
    conf_d = fam.conf_dict(conf)
    out = fam.train_outputs(tm, bag, conf_d, stkim_u=u)
    loss, _ = fam.loss(out, bag, bag.mask.any(dim=1), conf_d)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    want = from_jax_params(_np_tree(grads_j), arch)
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
               name=name)


@pytest.mark.parametrize("arch", ["mha", "mha_single"])
def test_dropout_is_live_in_training(arch):
    """At the heads' default rate of 0.1 a training forward drops (two
    draws differ); eval and ``deterministic=True`` do not."""
    _, _, tm = _pair(arch, n_token=3)
    feats, mask = _bag(9)
    x, m = torch.from_numpy(feats), torch.from_numpy(mask)

    def slide(out):
        return out[1] if isinstance(out, tuple) else out

    with torch.no_grad():
        ref = slide(tm(x, m))
        tm.train()
        torch.manual_seed(0)
        a, b = slide(tm(x, m, deterministic=False)), slide(
            tm(x, m, deterministic=False))
        det = slide(tm(x, m, deterministic=True))
    assert not torch.equal(a, b) and not torch.equal(a, ref)
    assert torch.equal(det, ref)


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small torch feature dump at the camelyon_medical_ssl width with a
    frozen split file for Step3's default seed 4, and a YAML naming it."""
    d = tmp_path_factory.mktemp("mha")
    slides = make_synthetic_bags(n_slides=8, d=384, seed=5, min_len=40,
                                 max_len=120)
    write_feature_pt(str(d / "data" / "patch_feats_pretrain_medical_ssl.pt"),
                     slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_4.json", "w") as f:
        json.dump({"train_names": names[:4], "val_names": names[4:6],
                   "test_names": names[6:]}, f)
    yml = d / "conf.yml"
    with open(YML) as src:
        yml.write_text(src.read() + f"\nsplit_dir: {d / 'splits'}\n")
    return d, yml


def _train_argv(d, yml, tag):
    return ["--config", str(yml), "--data_dir", str(d / "data"),
            "--ckpt_dir", str(d / tag / "ckpt"), "--log_dir",
            str(d / tag / "log"), "--train_epoch", "2", "--device", "cpu"]


def test_step3_acmil_trains_and_predict_scores_mha(corpus, tmp_path):
    d, yml = corpus
    step3_acmil.main(_train_argv(d, yml, "acmil_mha") + [
        "--arch", "mha", "--n_token", "5", "--n_masked_patch", "10",
        "--mask_drop", "0.6"])
    with open(d / "acmil_mha" / "log" / "metrics.jsonl") as f:
        epochs = [r for r in map(json.loads, f) if "_config" not in r]
    assert len(epochs) == 2
    assert all(np.isfinite(r["train/loss"]) and r["train/diff_loss"] > 0
               for r in epochs)
    ckpt = checkpoint.load(str(d / "acmil_mha" / "ckpt" / "checkpoint-best.pth"))
    assert ckpt["config"]["arch"] == "mha"
    assert "sub_attention.4.layer_norm.weight" in ckpt["model"]
    res = predict.main(["--config", YML, "--ckpt",
                        str(d / "acmil_mha" / "ckpt"), "--features",
                        str(d / "data" / "patch_feats_pretrain_medical_ssl.pt"),
                        "--out_csv", str(tmp_path / "p.csv"),
                        "--device", "cpu"])
    probs = np.asarray([r[2:4] for r in res["rows"]])
    assert probs.shape == (8, 2)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-6)
    # predict scores with the plain deterministic forward
    conf = Config.from_yaml(YML)
    checkpoint.adopt_checkpoint_config(conf, ckpt["config"])
    model, _ = build_mil_model(conf)
    model.load_state_dict(ckpt["model"])
    from acmil_tpu_torch.data.ptio import open_feature_source

    src = open_feature_source(str(d / "data" / "patch_feats_pretrain_medical_ssl.pt"))
    item = src[0]
    with torch.no_grad():
        slide = model.eval()(torch.from_numpy(item["input"])[None])[1]
    _close(torch.softmax(slide, -1)[0].numpy(), probs[0])


def test_step3_generic_mha_lands_on_mha_single(corpus):
    d, yml = corpus
    step3_generic.main(_train_argv(d, yml, "generic_mha") + ["--arch", "mha"])
    ckpt = checkpoint.load(str(d / "generic_mha" / "ckpt" /
                               "checkpoint-last.pth"))
    assert ckpt["config"]["arch"] == "mha_single"
    assert "attention.q_proj.weight" in ckpt["model"]
    with open(d / "generic_mha" / "log" / "metrics.jsonl") as f:
        epochs = [r for r in map(json.loads, f) if "_config" not in r]
    assert len(epochs) == 2 and all(np.isfinite(r["train/loss"])
                                    for r in epochs)
