"""The port's DSMIL slice (acmil_tpu_torch: models/dsmil.py, the fused eval
through kernel B6's route, DSMILFamily, the generic Step3 trainer and
cli/predict.py) against the JAX package, on the same numpy inputs and the
same weights.

On the CPU the port's B6 wrapper takes its plain version and the JAX side
runs its Pallas kernel in interpret mode (``dsmil_eval_fused`` off a TPU).
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
from acmil_tpu.models.dsmil import DSMIL as JaxDSMIL
from acmil_tpu.ops import masked as jax_masked
from acmil_tpu_torch.cli import predict, step3_generic
from acmil_tpu_torch.cli import train as port_cli
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag, pad_bag
from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                    get_family, make_eval_step,
                                    make_train_step)
from acmil_tpu_torch.models import DSMIL, build_mil_model, fast
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.ops import dsmil_pool, masked
from scripts.import_torch_checkpoint import convert_dsmil
from tests.conftest import make_synthetic_bags

D, Q, N_CLASS = 32, 16, 2
# float32 on both sides; XLA and torch sum in other orders
ATOL, RTOL = 1e-5, 1e-4
# fused against plain eval: tests/test_attn_pool.py's own bound
EVAL_ATOL, EVAL_RTOL = 2e-5, 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")


def _bag_arrays(seed, b=2, n=300, c=N_CLASS):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, D).astype(np.float16).astype(np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, 200:] = False
    return feats, mask, rs.randint(0, c, b)


def _bags(feats, mask, labels):
    jb = JaxBag(feats=jnp.asarray(feats), mask=jnp.asarray(mask),
                coords=jnp.zeros(feats.shape[:2] + (2,), jnp.int32),
                label=jnp.asarray(labels, jnp.int32))
    tb = Bag(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.zeros(feats.shape[:2] + (2,), dtype=torch.int32),
             torch.from_numpy(np.asarray(labels, np.int64)))
    return jb, tb


def _confs(**kw):
    d = dict(n_class=N_CLASS, D_feat=D, D_inner=Q, arch="dsmil", lr=1e-3,
             train_epoch=2, seed=0)
    d.update(kw)
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(seed=0, n_class=N_CLASS):
    """The registered flax DSMIL with params from ``init`` and the port's
    model holding the same weights."""
    jconf, conf = _confs(n_class=n_class)
    jm, fam = jax_build_model(jconf)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, D)),
                     jnp.ones((1, 8), bool))["params"]
    tm, tfam = build_mil_model(conf)
    assert fam == tfam == "dsmil"
    tm.load_state_dict(from_jax_params(_np_tree(params), "dsmil"))
    return jm, params, tm.eval()


def _close(got, want, atol=ATOL, rtol=RTOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _check_outputs(got, want, mask):
    _close(got[0].detach().numpy(), want[0], name="inst")
    _close(got[1].detach().numpy(), want[1], name="bag")
    valid = np.broadcast_to(mask[:, None, :], got[2].shape)
    _close(got[2].detach().numpy()[valid], np.asarray(want[2])[valid],
           name="attn")


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_class, with_mask", [(2, True), (3, True),
                                                (2, False)])
def test_module_matches_flax(n_class, with_mask):
    jm, params, tm = _pair(seed=1, n_class=n_class)
    feats, mask, _ = _bag_arrays(2)
    m_j = jnp.asarray(mask) if with_mask else None
    want = jm.apply({"params": params}, jnp.asarray(feats), m_j)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats),
                 torch.from_numpy(mask) if with_mask else None)
    if not with_mask:
        mask = np.ones_like(mask)
    _check_outputs(got, want, mask)


def _variant_state_dict(params, nonlinear, passing_v):
    """A nonlinear / passing_v flax tree → the port's names. Flax names the
    Dense layers in the order they are built; the shapes tell them apart."""
    dense = {k: v for k, v in params.items() if k.startswith("Dense_")}
    by_out = {}
    for k, v in dense.items():
        by_out.setdefault(v["kernel"].shape, []).append(k)
    sd = {}

    def lin(prefix, key):
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.asarray(dense[key]["kernel"]).T.copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(dense[key]["bias"]).copy())

    lin("i_classifier.fc.0", by_out[(D, N_CLASS)][0])
    if nonlinear:
        lin("b_classifier.q.0", by_out[(D, Q)][0])
        lin("b_classifier.q.2", by_out[(Q, 8)][0])
    else:
        lin("b_classifier.q", by_out[(D, Q)][0])
    if passing_v:
        lin("b_classifier.v.1", by_out[(D, D)][0])
    w = np.asarray(params["fcc_w"])
    sd["b_classifier.fcc.weight"] = torch.from_numpy(
        w.reshape(N_CLASS, N_CLASS, -1).copy())
    sd["b_classifier.fcc.bias"] = torch.from_numpy(
        np.asarray(params["fcc_b"]).copy())
    return sd


@pytest.mark.parametrize("nonlinear, passing_v", [(True, False),
                                                  (False, True), (True, True)])
def test_module_variants_match_flax(nonlinear, passing_v):
    kw = dict(n_class=N_CLASS, d_feat=D, d_inner=Q, d_query=8,
              nonlinear=nonlinear, passing_v=passing_v)
    jm = JaxDSMIL(**kw)
    params = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, D)),
                              jnp.ones((1, 8), bool))["params"])
    tm = DSMIL(**kw)
    tm.load_state_dict(_variant_state_dict(params, nonlinear, passing_v))
    feats, mask, _ = _bag_arrays(4)
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(feats), torch.from_numpy(mask))
    _check_outputs(got, want, mask)
    assert not fast.dsmil_is_fusable(tm)


def test_fp16_features_compute_in_the_weights_dtype():
    _, _, tm = _pair(seed=2)
    feats, mask, _ = _bag_arrays(5)
    with torch.no_grad():
        half = tm(torch.from_numpy(feats).half(), torch.from_numpy(mask))
        full = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    for a, b in zip(half, full):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_checkpoint_round_trip_through_convert_dsmil():
    # the port's state_dict, as numpy, through the repo's reference-.pth
    # importer into flax: a reference checkpoint loads into the port as is
    _, conf = _confs()
    torch.manual_seed(7)
    tm, _ = build_mil_model(conf)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = convert_dsmil(sd)
    assert set(params) == {"Dense_0", "Dense_1", "fcc_w", "fcc_b"}
    jm, _ = jax_build_model(_confs()[0])
    feats, mask, _ = _bag_arrays(6)
    want = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                    jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(feats), torch.from_numpy(mask))
    _check_outputs(got, want, mask)
    # and back: from_jax_params inverts convert_dsmil
    back = from_jax_params(params, "dsmil")
    assert back.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k


def test_from_jax_params_refuses_other_dsmil_trees():
    params = {"Dense_0": {}, "Dense_1": {}, "Dense_2": {}, "fcc_w": 0,
              "fcc_b": 0}
    with pytest.raises(ValueError, match="nonlinear=False"):
        from_jax_params(params, "dsmil")


def test_masked_max_matches_jax_on_an_all_masked_bag():
    rs = np.random.RandomState(7)
    x = rs.randn(3, 40, N_CLASS).astype(np.float32)
    mask = rs.rand(3, 40) < 0.5
    mask[1] = False
    got = masked.masked_max(torch.from_numpy(x), torch.from_numpy(mask),
                            dim=1)
    want = jax_masked.masked_max(jnp.asarray(x), jnp.asarray(mask), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[1] == masked.NEG_INF).all()


# ---------------------------------------------------------------------------
# Eval: the fused route (B6's plain version here) and the family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_class", [2, 3])
def test_dsmil_eval_fused_matches_jax(n_class, monkeypatch):
    jm, params, tm = _pair(seed=4, n_class=n_class)
    feats, mask, _ = _bag_arrays(8)
    mask[0] = False                            # an all-masked bag too
    monkeypatch.setattr(jax_fast, "FUSE_MIN_N", 0)
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)
    want = jax_fast.dsmil_eval_fused(params, jnp.asarray(feats),
                                     jnp.asarray(mask))
    with torch.no_grad():
        got = fast.dsmil_eval_fused(tm, torch.from_numpy(feats).half(),
                                    torch.from_numpy(mask))
    for g, w, name in zip(got, want, ("max_inst", "bag_logits")):
        _close(g.numpy(), w, atol=EVAL_ATOL, rtol=EVAL_RTOL, name=name)
    # the JAX family's fused and plain routes agree with the port's
    jfam, fam = jax_get_family("dsmil"), get_family("dsmil")
    jb, tb = _bags(feats, mask, np.zeros(2, np.int64))
    for fused in (True, False):
        jout = jfam.eval_outputs(jm.apply, params, jb, fused=fused)
        with torch.no_grad():
            out = fam.eval_outputs(tm, tb, fused=fused)
        _close(fam.probs(out).numpy(), jfam.probs(jout), atol=EVAL_ATOL,
               rtol=EVAL_RTOL, name=f"probs fused={fused}")


@pytest.mark.parametrize("threshold, n, routed", [
    (0, 300, True), (None, 300, False), (256, 256, True), (257, 256, False)])
def test_family_routes_by_fuse_min_n(threshold, n, routed, monkeypatch):
    _, _, tm = _pair(seed=5)
    feats, mask, labels = _bag_arrays(9, n=n)
    _, tb = _bags(feats, mask, labels)
    if threshold is not None:
        monkeypatch.setattr(fast, "FUSE_MIN_N", threshold)
    calls = []
    real = fast.dsmil_eval_fused
    monkeypatch.setattr(fast, "dsmil_eval_fused",
                        lambda *a: calls.append(1) or real(*a))
    fam = get_family("dsmil")
    with torch.no_grad():
        out = fam.eval_outputs(tm, tb)
        plain = fam.eval_outputs(tm, tb, fused=False)
    assert bool(calls) == routed
    _close(fam.probs(out).numpy(), fam.probs(plain).numpy(), atol=EVAL_ATOL,
           rtol=EVAL_RTOL)
    assert fast.FUSE_MIN_N == (49152 if threshold is None else threshold)


# ---------------------------------------------------------------------------
# Training: loss, gradients, AdamW steps, the Step3 trainer
# ---------------------------------------------------------------------------

def _torch_grads(model):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in model.named_parameters()}


@pytest.mark.parametrize("n_token, w_loss", [(1, 0.7), (2, 0.5)])
def test_one_step_loss_and_grads_match_jax(n_token, w_loss):
    # n_token 2 adds w_loss x the diversity of the two classes' attention
    jconf, conf = _confs(n_token=n_token, w_loss=w_loss)
    jm, params, tm = _pair(seed=6)
    jb, tb = _bags(*_bag_arrays(10))
    jfam, fam = jax_get_family("dsmil"), get_family("dsmil")
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
    for k in ("ce_loss", "diff_loss"):
        _close(parts[k].item(), float(parts_j[k]), name=k)
    assert (float(parts["diff_loss"].detach()) != 0.0) == (n_token > 1)
    want = from_jax_params(_np_tree(grads_j), "dsmil")
    got = _torch_grads(tm)
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name].numpy(), atol=3e-5, rtol=3e-3,
               name=name)


def test_five_adamw_steps_match_jax():
    """Per-step losses, and each parameter's change over five steps on
    three bags against optax's change. Every component of this model gets a
    gradient well above rounding, so none is left out; the change is held
    to 1e-3 of itself plus 1e-4 of the tensor's largest change, which a
    missing or wrongly signed update fails."""
    jconf, conf = _confs()
    jm, _ = jax_build_model(jconf)
    arrays = [_bag_arrays(20 + i, b=1 + i % 2, n=120 + 90 * i)
              for i in range(3)]
    bags = [_bags(*a) for a in arrays]
    rng = jax.random.PRNGKey(0)
    jstate = jax_create_state(jm, jconf, rng, bags[0][0], 3)
    tm, _ = build_mil_model(conf)
    p0 = from_jax_params(_np_tree(jstate.params), "dsmil")
    tm.load_state_dict(p0)
    state = create_train_state(tm, conf, 3)
    jstep = jax_make_step(jm, jconf, "dsmil")
    step = make_train_step(tm, conf, "dsmil")
    for i in range(5):
        jb, tb = bags[i % 3]
        jstate, jaux = jstep(jstate, jb, rng)
        aux = step(state, tb)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = from_jax_params(_np_tree(jstate.params), "dsmil")
    for name, p in tm.named_parameters():
        d_want = (want[name] - p0[name]).numpy()
        d_got = p.detach().numpy() - p0[name].numpy()
        assert np.abs(d_want).max() > conf.lr, name
        _close(d_got, d_want, atol=1e-4 * np.abs(d_want).max(), rtol=1e-3,
               name=name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small H5 dump with a frozen split file, the same bags as a torch
    feature file, and a YAML naming both."""
    d = tmp_path_factory.mktemp("dsmil")
    slides = make_synthetic_bags(n_slides=12, d=D, seed=4, min_len=40,
                                 max_len=250)
    write_feature_h5(str(d / "patch_feats_pretrain_medical_ssl.h5"), slides)
    # the same dump under a pretrain tag without preset widths, for a YAML
    # (Config.from_yaml sets D_feat/D_inner from a known tag)
    write_feature_h5(str(d / "patch_feats_pretrain_tiny.h5"), slides)
    write_feature_pt(str(d / "feats.pt"), slides)
    names = sorted(slides)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_0.json", "w") as f:
        json.dump({"train_names": names[:8], "val_names": names[8:10],
                   "test_names": names[10:]}, f)
    return d, slides


def _run_conf(d, tag, **kw):
    out = dict(dataset="camelyon", n_class=N_CLASS, D_feat=D, D_inner=Q,
               arch="dsmil", lr=1e-3, train_epoch=2, min_bucket=256, seed=0,
               data_dir=str(d), split_dir=str(d / "splits"),
               ckpt_dir=str(d / tag / "ckpt"), log_dir=str(d / tag / "log"))
    out.update(kw)
    return out


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "_config" not in r]


@pytest.mark.parametrize("fuse_min_n", [0, None])
def test_step3_generic_matches_jax_run_training(corpus, monkeypatch,
                                                fuse_min_n):
    # fuse_min_n 0: every val/test bag takes the fused route in both
    # packages (the JAX kernel in interpret mode, B6's plain version here)
    d, _ = corpus
    tag = f"fused{fuse_min_n}"
    if fuse_min_n is not None:
        monkeypatch.setattr(jax_fast, "FUSE_MIN_N", fuse_min_n)
        monkeypatch.setattr(fast, "FUSE_MIN_N", fuse_min_n)
    jconf = JaxConfig.from_dict(_run_conf(d, f"jax{tag}"))
    jax_best = jax_cli.run_training(jconf)
    # the port starts from the weights JAX's create_train_state drew
    p_rng, s_rng, d_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    jm, _ = jax_build_model(jconf)
    params = jm.init({"params": p_rng, "stkim": s_rng, "dropout": d_rng},
                     jnp.zeros((1, 256, D)), jnp.ones((1, 256), bool))["params"]
    real_build = port_cli.build_mil_model

    def build_from_jax(c):
        model, family = real_build(c)
        model.load_state_dict(from_jax_params(_np_tree(params), "dsmil"))
        return model, family

    monkeypatch.setattr(port_cli, "build_mil_model", build_from_jax)
    yml = d / f"port{tag}.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, f"port{tag}",
                                            pretrain="tiny")))
    best = step3_generic.main(["--config", str(yml), "--device", "cpu"])
    want = _epochs(jconf.log_dir)
    got = _epochs(str(d / f"port{tag}" / "log"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train/loss", "train/ce_loss", "perf/val_loss",
                    "perf/test_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
        for key in ("perf/val_auc", "perf/val_acc", "perf/val_f1",
                    "perf/test_auc", "perf/test_acc", "perf/test_f1"):
            assert g[key] == w[key], key
    assert best["epoch"] == jax_best["epoch"]
    for t in ("best", "last"):
        ck = checkpoint.load(str(d / f"port{tag}" / "ckpt" /
                                 f"checkpoint-{t}.pth"))
        assert ck["config"]["arch"] == "dsmil"


def test_step3_generic_needs_a_card_unless_told_cpu(corpus, monkeypatch):
    d, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        step3_generic.main(["--config", YML, "--arch", "dsmil",
                            "--data_dir", str(d)])


@pytest.mark.parametrize("arch, want", [("transmil", "transmil"),
                                        ("mha", "mha_single"),
                                        ("dtfd", "dtfd")])
def test_step3_generic_names_the_registered_archs(corpus, tmp_path, arch,
                                                  want):
    # the reference script's `mha` lands on the registered `mha_single` and
    # trains, and so do `transmil` and `dtfd` since they are ported; an arch
    # the registry does not hold is refused, naming those it does
    d, _ = corpus
    yml = tmp_path / "conf.yml"
    yml.write_text(yaml.safe_dump(_run_conf(d, f"arch_{arch}",
                                            pretrain="tiny", train_epoch=1)))
    argv = ["--config", str(yml), "--arch", arch, "--device", "cpu"]
    step3_generic.main(argv)
    last = checkpoint.load(checkpoint.checkpoint_path(
        str(d / f"arch_{arch}" / "ckpt"), "last"))
    assert last["config"]["arch"] == want
    with pytest.raises(ValueError, match=r"unknown arch 'nope'; have "
                       r"\['abmil', 'attmil', 'attmil_gated', 'bmil_enc', "
                       r"'bmil_spvis', 'bmil_vis', 'clam_mb', 'clam_sb', "
                       r"'dsmil', 'dtfd', 'ga', 'ibmil', 'ilra', 'ips', "
                       r"'lbmil', 'maxmil', 'meanmil', 'mha', 'mha_single', "
                       r"'mhim', 'pure', 'transmil'\]"):
        step3_generic.main(["--config", str(yml), "--arch", "nope",
                            "--device", "cpu"])


def test_step3_generic_reads_w_loss(monkeypatch):
    seen = {}
    monkeypatch.setattr(step3_generic, "run_training",
                        lambda conf: seen.setdefault("conf", conf))
    step3_generic.main(["--config", YML, "--arch", "dsmil", "--w_loss",
                        "0.25"])
    conf = seen["conf"]
    assert get_family("dsmil").conf_dict(conf)["w_loss"] == 0.25
    assert conf.arch == "dsmil" and (conf.D_feat, conf.D_inner) == (384, 128)


# ---------------------------------------------------------------------------
# Scoring: cli/predict.py on a DSMIL checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse_min_n", [0, None])
def test_predict_scores_a_dsmil_checkpoint_as_jax(corpus, tmp_path,
                                                  monkeypatch, fuse_min_n):
    d, slides = corpus
    if fuse_min_n is not None:
        monkeypatch.setattr(jax_fast, "FUSE_MIN_N", fuse_min_n)
        monkeypatch.setattr(fast, "FUSE_MIN_N", fuse_min_n)
    jm, params, tm = _pair(seed=9)
    jconf, conf = _confs()
    ckpt = str(tmp_path / "checkpoint-best.pth")
    checkpoint.save(ckpt, tm, epoch=3, conf=conf)
    yml = tmp_path / "predict.yml"
    yml.write_text(yaml.safe_dump({"n_class": N_CLASS, "arch": "ga"}))
    calls = []
    real = fast.dsmil_eval_fused
    monkeypatch.setattr(fast, "dsmil_eval_fused",
                        lambda *a: calls.append(1) or real(*a))
    res = predict.main(["--config", str(yml), "--ckpt", str(tmp_path),
                        "--features", str(d / "feats.pt"), "--out_csv",
                        str(tmp_path / "preds.csv"), "--device", "cpu"])
    # the checkpoint's arch wins over the YAML's
    assert len(res["rows"]) == len(slides)
    assert len(calls) == (len(slides) if fuse_min_n == 0 else 0)
    jstep = jax_make_eval_step(jm, "dsmil")
    for row in res["rows"]:
        item = slides[row[0]]
        jbag = jax_bags.pad_bag(item["feat"], item["coords"], item["label"],
                                dtype=np.float16)
        want = np.asarray(jstep(params, jbag))[0]
        _close(row[2:2 + N_CLASS], want, atol=EVAL_ATOL, rtol=EVAL_RTOL,
               name=row[0])
        assert row[-1] == int(np.argmax(row[2:2 + N_CLASS]))
        tb = pad_bag(item["feat"], item["coords"], item["label"],
                     dtype=np.float16)
        got = make_eval_step(tm, "dsmil")(tb)[0].numpy()
        _close(row[2:2 + N_CLASS], got, atol=1e-7, rtol=1e-6)
    assert res["metrics"] is not None


def test_b6_cpu_route_counts_no_launch_in_scoring(monkeypatch):
    monkeypatch.setattr(fast, "FUSE_MIN_N", 0)
    _, _, tm = _pair(seed=10)
    feats, mask, labels = _bag_arrays(11)
    before = dsmil_pool.fused_dsmil_pool.launches
    with torch.no_grad():
        make_eval_step(tm, "dsmil")(_bags(feats, mask, labels)[1])
    assert dsmil_pool.fused_dsmil_pool.launches == before
