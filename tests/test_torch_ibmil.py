"""The port's IBMIL (acmil_tpu_torch/models/ibmil.py, both phases), its
k-means (acmil_tpu_torch/ops/kmeans.py) and its two entry points
(cli/step3_ibmil.py, cli/ibmil_clustering.py), with cli/predict.py and
cli/step4_heatmap.py on IBMIL checkpoints, against the JAX package on the
same numpy inputs and the same weights.

Module outputs agree within ATOL/RTOL at valid positions (C3), gradients
within GRAD_ATOL/GRAD_RTOL. k-means: ``_lloyd`` from the same initial
centroids gives JAX's assignments exactly and centroids within KMEANS_ATOL;
whitened points are held by their pairwise distances within KMEANS_ATOL
(eigenvector signs are arbitrary); the k-means++ draws come from different
generators in the two packages, so ``kmeans`` is held to JAX's partition
of separable blobs up to a permutation.
"""

import functools
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import write_feature_h5
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data.bags import Bag as JaxBag
from acmil_tpu.engine import create_train_state as jax_create_state
from acmil_tpu.engine import get_family as jax_get_family
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.models import build_mil_model as jax_build_model
from acmil_tpu.models.ibmil import IBMIL as JaxIBMIL
from acmil_tpu.ops.masked import masked_softmax as jax_masked_softmax
from acmil_tpu_torch.cli import (ibmil_clustering, predict, step3_ibmil,
                                 step4_heatmap)
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import (BagLoader, build_hdf5_feat_dataset,
                                  write_feature_pt)
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_train_step)
from acmil_tpu_torch.models import IBMIL, build_mil_model
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops import kmeans
from scripts.import_torch_checkpoint import convert_ibmil
from tests.conftest import make_synthetic_bags

# acmil_tpu.ops exports a `kmeans` function that shadows the module
jax_kmeans = importlib.import_module("acmil_tpu.ops.kmeans")

D, L, A, J, P = 32, 16, 16, 8, 5
ATOL, RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-3
KMEANS_ATOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _protos(seed=0):
    return np.random.RandomState(seed).randn(P, L).astype(np.float32)


def _modules(phase2, merge="cat", learn=False, n_class=3):
    protos = _protos() if phase2 else None
    jm = JaxIBMIL(n_class=n_class, d_inner=L, d_attn=A, confounder_dim=J,
                  confounder_merge=merge, n_confounder=P if phase2 else 0,
                  confounder_learn=learn,
                  confounder_init=(tuple(map(tuple, protos)) if phase2
                                   else None))
    tm = IBMIL(n_class, D, L, A, J, confounder_merge=merge,
               confounders=protos, confounder_learn=learn)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _shapes(phase2, merge, learn):
    jm = _modules(phase2, merge, learn)[0]
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, D)), jnp.ones((1, 8), bool))["params"]


def _load(tm, params, phase2, learn):
    sd = from_jax_params(_np_tree(params), "ibmil")
    if phase2 and not learn:
        sd["confounder_feat"] = torch.from_numpy(_protos())
    tm.load_state_dict(sd)


def _pair(phase2=False, merge="cat", learn=False, seed=0):
    jm, tm = _modules(phase2, merge, learn)
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32),
        _shapes(phase2, merge, learn))
    _load(tm, params, phase2, learn)
    return jm, params, tm.eval()


def _bag_arrays(seed, b=3, n=300, n_class=3):
    """Bag 0 mostly valid, bag 1 with 10 valid rows, bag 2 all masked."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[1] = False
    mask[1, rs.choice(n, 10, replace=False)] = True
    mask[2] = False
    return feats, mask, rs.randint(0, n_class, b)


def _bags(feats, mask, labels):
    coords = np.zeros(feats.shape[:2] + (2,), np.int32)
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.asarray(coords),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.from_numpy(coords),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _check_outputs(got, want, mask):
    assert set(got) == set(want)
    for k in ("logits", "bag_feat", "deconf_attn"):
        if k in want:
            _close(got[k].detach().numpy(), want[k], name=k)
    valid = np.broadcast_to(mask[:, None, :], got["attn"].shape)
    _close(got["attn"].detach().numpy()[valid],
           np.asarray(want["attn"])[valid], name="attn")


def _torch_grads(model):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


PHASES = [(False, "cat", False), (True, "cat", False), (True, "add", False),
          (True, "sub", False), (True, "cat", True)]


# ---------------------------------------------------------------------------
# The module against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase2, merge, learn", PHASES)
def test_module_matches_flax(phase2, merge, learn):
    jm, params, tm = _pair(phase2, merge, learn, seed=1)
    feats, mask, _ = _bag_arrays(2)
    want = jax.jit(functools.partial(jm.apply, deterministic=True))(
        {"params": params}, jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    _check_outputs(got, want, mask)
    if phase2:
        _close(got["deconf_attn"].sum(-1).numpy(), np.ones(3), atol=1e-6)
        assert (("confounder_feat" in dict(tm.named_parameters()))
                == learn != ("confounder_feat" in dict(tm.named_buffers())))


@pytest.mark.parametrize("phase2, merge, learn", PHASES)
def test_one_step_loss_and_grads_match_jax(phase2, merge, learn):
    jm, params, tm = _pair(phase2, merge, learn, seed=3)
    jb, tb = _bags(*_bag_arrays(4))
    conf = dict(arch="ibmil", n_class=3)
    jfam, fam = jax_get_family("default"), get_family("default")
    jconf_d = jfam.conf_dict(JaxConfig.from_dict(conf))
    conf_d = fam.conf_dict(Config.from_dict(conf))

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jb,
                                 {"dropout": jax.random.PRNGKey(0)}, jconf_d)
        return jfam.loss(out, jb, jb.mask.any(axis=1), jconf_d)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm.train()
    loss, _ = fam.loss(fam.train_outputs(tm, tb, conf_d), tb,
                       tb.mask.any(dim=1), conf_d)
    loss.backward()
    _close(loss.item(), float(loss_j), name="loss")
    want = from_jax_params(_np_tree(grads_j), "ibmil")
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
               name=name)


def test_masked_slots_are_inert_and_an_empty_bag_is_finite():
    _, _, tm = _pair(True, seed=5)
    feats, mask, _ = _bag_arrays(6)
    garbage = feats.copy()
    garbage[~mask] = 1e3
    with torch.no_grad():
        a = tm(torch.from_numpy(feats), torch.from_numpy(mask))
        b = tm(torch.from_numpy(garbage), torch.from_numpy(mask))
    for k in ("logits", "bag_feat", "deconf_attn"):
        _close(b[k].numpy(), a[k].numpy(), name=k)
    feats[~mask] = 0.0
    out = tm.train()(torch.from_numpy(feats), torch.from_numpy(mask),
                     deterministic=False)
    assert all(torch.isfinite(v).all() for v in out.values())
    out["logits"].sum().backward()
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name


def test_convert_ibmil_round_trip_gives_the_jax_tree():
    """Phase 1 through the reference converter; a phase-2 state dict, which
    the reference converter refuses, keeps the dictionary under its
    ``confounder_feat`` name."""
    _, params, tm = _pair(False, seed=7)
    got = convert_ibmil({k: v.numpy() for k, v in tm.state_dict().items()})
    want_leaves, want_def = jax.tree_util.tree_flatten(params)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)
    _, _, tm2 = _pair(True, seed=7)
    sd2 = tm2.state_dict()
    np.testing.assert_array_equal(sd2["confounder_feat"].numpy(), _protos())
    with pytest.raises(NotImplementedError):
        convert_ibmil({k: v.numpy() for k, v in sd2.items()})


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _blobs(seed=1, n=60):
    rs = np.random.RandomState(seed)
    centers = rs.randn(4, 6).astype(np.float32) * 8
    return np.concatenate([c + 0.3 * rs.randn(n, 6).astype(np.float32)
                           for c in centers]), n


def test_lloyd_from_the_same_start_matches_jax():
    x = np.random.RandomState(2).randn(400, 8).astype(np.float32)
    init = x[[3, 50, 120, 333, 7]]
    jc, ja = jax_kmeans._lloyd(jnp.asarray(x), jnp.asarray(init), 5, 20)
    tc, ta = kmeans._lloyd(torch.from_numpy(x), torch.from_numpy(init), 5, 20)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tc.numpy(), jc, atol=KMEANS_ATOL, rtol=0)


@pytest.mark.parametrize("dim", [-1, 4])
def test_pca_whiten_keeps_jax_pairwise_distances(dim):
    rs = np.random.RandomState(3)
    x = (rs.randn(80, 8) * np.linspace(1, 6, 8)).astype(np.float32)
    got = kmeans.pca_whiten(torch.from_numpy(x), dim).numpy()
    want = np.asarray(jax_kmeans.pca_whiten(x, dim))
    assert got.shape == want.shape == (80, 8 if dim < 0 else dim)
    pd = lambda a: np.linalg.norm(a[:, None] - a[None], axis=-1)
    _close(pd(got), pd(want), atol=KMEANS_ATOL, rtol=0)
    _close(np.linalg.norm(got, axis=1), np.ones(80), atol=1e-5)


def test_kmeans_gives_the_jax_partition_of_separable_blobs():
    x, n = _blobs()
    ja, jc = jax_kmeans.kmeans(x, k=4, seed=66)
    ta, tc = kmeans.kmeans(x, k=4, seed=66)
    perm = {int(t): int(j) for t, j in zip(ta, ja)}
    assert len(perm) == 4 and sorted(perm.values()) == [0, 1, 2, 3]
    np.testing.assert_array_equal([perm[int(t)] for t in ta], ja)
    order = [k for k, _ in sorted(perm.items(), key=lambda kv: kv[1])]
    _close(tc[order], jc, atol=KMEANS_ATOL, rtol=0)
    # the draws are the seed's: the same seed gives the same clustering
    np.testing.assert_array_equal(kmeans.kmeans(x, k=4, seed=66)[0], ta)
    protos = kmeans.build_confounder_prototypes(x, k=8)
    assert protos.shape == (8, 6) and np.isfinite(protos).all()


# ---------------------------------------------------------------------------
# The two-phase protocol through the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ibmil")
    slides = make_synthetic_bags(n_slides=12, d=D, seed=9, min_len=10,
                                 max_len=120)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_3.json", "w") as f:
        json.dump({"train_names": names[:8], "val_names": names[8:10],
                   "test_names": names[10:]}, f)
    return d, slides


def _run_conf(d, **kw):
    out = dict(dataset="camelyon", n_class=2, D_feat=D, D_inner=L,
               lr=1e-3, train_epoch=1, min_bucket=128, seed=3,
               pretrain="tiny", data_dir=str(d), split_dir=str(d / "splits"))
    out.update(kw)
    return out


def _ibmil_to_jax(sd):
    """A port IBMIL state dict → its flax tree (phase 2 included, which the
    reference converter refuses)."""
    lin = lambda p: {**{"kernel": sd[f"{p}.weight"].numpy().T},
                     **({"bias": sd[f"{p}.bias"].numpy()}
                        if f"{p}.bias" in sd else {})}
    tree = {"DimReduction_0": {"Dense_0": lin("dimreduction.fc1")},
            "AttentionGated_0": {
                "Dense_0": lin("attention.attention_V.0"),
                "Dense_1": lin("attention.attention_U.0"),
                "Dense_2": lin("attention.attention_weights")},
            "Classifier1fc_0": {"Dense_0": lin("classifier.fc")}}
    if "W_q.weight" in sd:
        tree["W_q"], tree["W_k"] = lin("W_q"), lin("W_k")
    return tree


@pytest.fixture(scope="module")
def two_phase(corpus):
    """Phase 1 through cli/step3_ibmil.py, then cli/ibmil_clustering.py
    with the bag features it clusters captured."""
    d, _ = corpus
    yml = d / "p1.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d)))
    step3_ibmil.main(["--config", str(yml), "--ckpt_dir", str(d / "ck1"),
                      "--log_dir", str(d / "log1"), "--device", "cpu"])
    # the clustering YAML names another seed and no widths: the
    # checkpoint's seed (and so its split), D_feat and D_inner win
    cyml = d / "cluster.yml"
    cyml.write_text(yaml.safe_dump({"dataset": "camelyon", "seed": 11,
                                    "pretrain": "tiny", "data_dir": str(d),
                                    "split_dir": str(d / "splits"),
                                    "ckpt_dir": str(d / "ck1")}))
    captured = {}
    real = ibmil_clustering.build_confounder_prototypes

    def capture(feats, **kw):
        captured["feats"] = feats.clone()
        captured["kw"] = kw
        return real(feats, **kw)

    ibmil_clustering.build_confounder_prototypes = capture
    try:
        npy = ibmil_clustering.main(["--config", str(cyml), "--k", "4",
                                     "--out_dir", str(d / "deconf"),
                                     "--device", "cpu"])
    finally:
        ibmil_clustering.build_confounder_prototypes = real
    return npy, captured


def test_clustering_collects_phase_one_bag_features_as_jax(corpus,
                                                            two_phase):
    d, _ = corpus
    npy, captured = two_phase
    assert npy == str(d / "deconf" / "camelyon" /
                      "train_bag_cls_agnostic_feats_proto_4_pretrain_tiny_"
                      "seed_3.npy")
    protos = np.load(npy)
    assert protos.shape == (4, L) and np.isfinite(protos).all()
    assert captured["kw"] == {"k": 4, "seed": 66,
                              "device": torch.device("cpu")}
    # every train bag's bag_feat, in the loader's order, from the JAX module
    # on the phase-1 checkpoint's weights
    ck = checkpoint.load(checkpoint.checkpoint_path(str(d / "ck1"), "best"))
    conf = Config.from_dict(_run_conf(d, arch="ibmil"))
    train_src, _, _ = build_hdf5_feat_dataset(
        str(d / "patch_feats_pretrain_tiny.h5"), conf)
    loader = BagLoader(train_src, conf.B, min_bucket=conf.min_bucket,
                       dtype=np.float16)
    jm, _ = jax_build_model(JaxConfig.from_dict(_run_conf(d, arch="ibmil")))
    jparams = jax.tree_util.tree_map(
        jnp.asarray, convert_ibmil({k: v.numpy()
                                    for k, v in ck["model"].items()}))
    want = np.concatenate([np.asarray(jm.apply(
        {"params": jparams}, jnp.asarray(bag.feats.float().numpy()),
        jnp.asarray(bag.mask.numpy()))["bag_feat"]) for bag in loader])
    _close(captured["feats"].numpy(), want, name="bag_feat")
    assert len(want) == 8


def test_phase_two_step_matches_jax_and_the_cli_trains(corpus, two_phase,
                                                       tmp_path):
    """The same .npy prototypes feed both packages' phase-2 builds: one
    step's loss and gradients agree; then cli/step3_ibmil.py --c_path trains
    a phase-2 epoch with finite losses and a deconf_attn whose rows sum to
    1."""
    d, slides = corpus
    npy, _ = two_phase
    keys = _run_conf(d, arch="ibmil", c_path=[npy])
    jconf, conf = JaxConfig.from_dict(keys), Config.from_dict(keys)
    jm, family = jax_build_model(jconf)
    tm, fam_name = build_mil_model(conf)
    assert family == fam_name == "default"
    names = sorted(slides)[:2]
    jbag = jax_bags.collate_bags([slides[n]["feat"] for n in names],
                                 [slides[n]["coords"] for n in names],
                                 [slides[n]["label"] for n in names],
                                 min_bucket=128)
    tbag = Bag(torch.from_numpy(np.asarray(jbag.feats)),
               torch.from_numpy(np.asarray(jbag.mask)),
               torch.from_numpy(np.asarray(jbag.coords)),
               torch.from_numpy(np.asarray(jbag.label, np.int64)))
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, jbag, 4)
    sd = from_jax_params(_np_tree(jstate.params), "ibmil")
    sd["confounder_feat"] = torch.from_numpy(np.load(npy))
    tm.load_state_dict(sd)
    jfam, fam = jax_get_family(family), get_family(fam_name)
    jconf_d, conf_d = jfam.conf_dict(jconf), fam.conf_dict(conf)

    def loss_fn(p):
        out = jfam.train_outputs(jm.apply, p, jbag, {"dropout": rng}, jconf_d)
        return jfam.loss(out, jbag, jbag.mask.any(axis=1), jconf_d)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    tm.train()
    loss, _ = fam.loss(fam.train_outputs(tm, tbag, conf_d), tbag,
                       tbag.mask.any(dim=1), conf_d)
    loss.backward()
    _close(loss.item(), float(loss_j), name="loss")
    want = from_jax_params(_np_tree(grads_j), "ibmil")
    got = _torch_grads(tm)
    assert got.keys() == want.keys() and "W_q.weight" in got
    for name in got:
        _close(got[name], want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
               name=name)
    # and the trainer takes that step
    state = create_train_state(tm, conf, 4)
    aux = make_train_step(tm, conf, fam_name)(state, tbag)
    _close(float(aux["loss"]), float(loss_j), name="step loss")

    ck2 = str(tmp_path / "ck2")
    yml = tmp_path / "p2.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d)))
    step3_ibmil.main(["--config", str(yml), "--c_path", npy, "--ckpt_dir",
                      ck2, "--log_dir", str(tmp_path / "log2"), "--device",
                      "cpu"])
    with open(tmp_path / "log2" / "metrics.jsonl") as f:
        rows = [r for r in map(json.loads, f) if "_config" not in r]
    assert len(rows) == 1 and np.isfinite(rows[0]["train/loss"])
    ck = checkpoint.load(checkpoint.checkpoint_path(ck2, "best"))
    assert ck["config"]["arch"] == "ibmil" and ck["config"]["c_path"] == [npy]
    p2 = IBMIL(2, D, L, confounders=np.load(npy))
    p2.load_state_dict(ck["model"])
    with torch.no_grad():
        out = p2(tbag.feats, tbag.mask)
    _close(out["deconf_attn"].sum(-1).numpy(), np.ones(2), atol=1e-6)


def test_predict_and_step4_on_ibmil_checkpoints(corpus, two_phase, tmp_path):
    """Phase 1 scores through cli/predict.py as the JAX eval step does and
    gives Step4 its ``attn``. A phase-2 checkpoint loads only when the
    YAML names its ``c_path`` (the checkpoint's model keys do not hold it),
    as the JAX package's scripts/predict.py behaves; then it scores as the
    JAX eval step does."""
    d, slides = corpus
    npy, _ = two_phase
    ck2 = str(tmp_path / "ck2")
    yml = tmp_path / "p2.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d)))
    step3_ibmil.main(["--config", str(yml), "--c_path", npy, "--ckpt_dir",
                      ck2, "--log_dir", str(tmp_path / "log2"), "--device",
                      "cpu"])
    bare = tmp_path / "bare.yml"
    bare.write_text(yaml.safe_dump({"n_class": 2, "min_bucket": 128}))
    named = tmp_path / "named.yml"
    named.write_text(yaml.safe_dump({"n_class": 2, "min_bucket": 128,
                                     "c_path": [npy]}))
    args = ["--features", str(d / "feats.pt"), "--out_csv",
            str(tmp_path / "p.csv"), "--device", "cpu"]
    with pytest.raises(RuntimeError, match="W_q"):
        predict.main(["--config", str(bare), "--ckpt", ck2] + args)
    for ckpt_dir, cfg, c_path in ((str(d / "ck1"), bare, None),
                                  (ck2, named, [npy])):
        res = predict.main(["--config", str(cfg), "--ckpt", ckpt_dir] + args)
        ck = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "best"))
        jm, family = jax_build_model(JaxConfig.from_dict(
            _run_conf(d, arch="ibmil", c_path=c_path)))
        jstep = jax_make_eval_step(jm, family)
        jparams = jax.tree_util.tree_map(jnp.asarray,
                                         _ibmil_to_jax(ck["model"]))
        for row in res["rows"]:
            item = slides[row[0]]
            jbag = jax_bags.pad_bag(item["feat"], item["coords"],
                                    item["label"], min_bucket=128,
                                    dtype=np.float16)
            _close(row[2:4], np.asarray(jstep(jparams, jbag))[0], name=row[0])

    # Step4's scores: the output dict's attn, masked softmax, as JAX's
    for phase2 in (False, True):
        jm, params, tm = _pair(phase2, seed=8)
        name = sorted(slides)[0]
        x = torch.from_numpy(slides[name]["feat"].astype(np.float32))[None]
        m = torch.ones(x.shape[:2], dtype=torch.bool)
        got = step4_heatmap.attention_probs(tm, Bag(x, m, None, None))
        a = jm.apply({"params": params}, jnp.asarray(x.numpy()),
                     jnp.asarray(m.numpy()), deterministic=True)["attn"]
        want = jax_masked_softmax(a, jnp.asarray(m.numpy())[:, None, :])
        _close(got.numpy(), np.asarray(want).mean(1))


def test_jax_predict_refuses_a_phase_two_checkpoint_without_c_path(
        corpus, two_phase, tmp_path, monkeypatch):
    """What the port's predict matches: the JAX package's
    scripts/predict.py adopts only MODEL_CONFIG_KEYS, which lack c_path, so
    it rebuilds a phase-1 IBMIL and its restore of a phase-2 checkpoint
    fails; with c_path in the YAML it scores."""
    import scripts.predict as jax_predict
    from acmil_tpu.cli.train import run_training

    d, _ = corpus
    npy, _ = two_phase
    ck = str(tmp_path / "jck2")
    run_training(JaxConfig.from_dict(_run_conf(
        d, arch="ibmil", c_path=[npy], ckpt_dir=ck,
        log_dir=str(tmp_path / "jlog"))))
    feats = str(d / "patch_feats_pretrain_tiny.h5")
    for name, keys in (("bare", {}), ("named", {"c_path": [npy]})):
        cfg = tmp_path / f"{name}.yml"
        cfg.write_text(yaml.safe_dump(_run_conf(d, arch="ibmil", **keys)))
        monkeypatch.setattr(sys, "argv", [
            "predict.py", "--config", str(cfg), "--ckpt_dir", ck,
            "--features", feats, "--out_csv", str(tmp_path / f"{name}.csv")])
        if name == "bare":
            with pytest.raises(ValueError, match="W_k|W_q"):
                jax_predict.main()
        else:
            jax_predict.main()
            assert os.path.isfile(tmp_path / "named.csv")
