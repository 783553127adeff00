"""The port's serving slice as a whole, against the JAX package: feature
files → padded bags → loader → ACMIL_GA eval (kernel B1's route) →
probabilities and metrics, and the ``cli/predict.py`` entry point.

On the CPU the port's pooling takes kernel B1's plain version and the JAX
side runs its Pallas kernel in interpret mode (``gated_attn_pool_grad`` off
a TPU).
"""

import csv
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.config import Config as JaxConfig
from acmil_tpu.data import BagLoader as JaxBagLoader
from acmil_tpu.data import FeatureBagSource as JaxSource
from acmil_tpu.data import bags as jax_bags
from acmil_tpu.data import write_feature_h5
from acmil_tpu.engine import evaluate as jax_evaluate
from acmil_tpu.engine import is_better as jax_is_better
from acmil_tpu.engine import make_eval_step as jax_make_eval_step
from acmil_tpu.engine.metrics import classification_metrics as jax_metrics
from acmil_tpu.models.acmil import ACMIL_GA as JaxACMIL_GA
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import (BagLoader, FeatureBagSource, PtBagSource,
                                  bags, open_feature_source, write_feature_pt)
from acmil_tpu_torch.engine import (classification_metrics, evaluate,
                                    is_better, make_eval_step)
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.cli import predict
from acmil_tpu_torch.models import ACMIL_GA
from acmil_tpu_torch.models.convert import from_jax_params
from tests.conftest import make_synthetic_bags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, L, K = 32, 16, 3
# probabilities: f32 on both sides, summation order differs (see
# test_torch_attn_pool.py); a softmax over 2 classes keeps the error ~1e-7
PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    slides = make_synthetic_bags(n_slides=10, d=D, seed=11, min_len=40,
                                 max_len=300)
    h5 = str(d / "feats.h5")
    write_feature_h5(h5, slides)
    return d, h5, slides


@pytest.fixture(scope="module")
def ga_pair():
    jm = JaxACMIL_GA(n_class=2, d_inner=L, n_token=K)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, D)),
                     jnp.ones((1, 8), bool))["params"]
    tm = ACMIL_GA(2, d_feat=D, d_inner=L, n_token=K)
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "ga"))
    return jm, params, tm


def _loaders(h5, names, batch_size=2):
    kw = dict(batch_size=batch_size, min_bucket=64, max_patches=256,
              dtype=np.float16)
    return (JaxBagLoader(JaxSource(h5, names), **kw),
            BagLoader(FeatureBagSource(h5, names), **kw))


def test_eval_matches_jax_eval(corpus, ga_pair):
    _, h5, slides = corpus
    jm, params, tm = ga_pair
    names = sorted(slides)
    jl, tl = _loaders(h5, names)
    jstep = jax_make_eval_step(jm, "acmil")
    tstep = make_eval_step(tm, "acmil")
    n = 0
    for jbag, tbag in zip(jl, tl):
        want = np.asarray(jstep(params, jbag))
        got = tstep(tbag).numpy()
        np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
        n += len(got)
    assert n == len(names)
    jm_ = jax_evaluate(params, jstep, jl, 2)
    tm_ = evaluate(tstep, tl, 2)
    for k in ("auc", "acc", "f1"):
        assert tm_[k] == jm_[k], k
    assert tm_["loss"] == pytest.approx(jm_["loss"], abs=1e-5)


def test_fused_and_plain_eval_agree(corpus, ga_pair):
    _, h5, slides = corpus
    _, _, tm = ga_pair
    _, tl = _loaders(h5, sorted(slides))
    fused = evaluate(make_eval_step(tm, "acmil", fused=True), tl, 2)
    plain = evaluate(make_eval_step(tm, "acmil", fused=False), tl, 2)
    for k in ("auc", "acc", "f1"):
        assert fused[k] == plain[k]


def test_predict_cli_scores_every_slide(corpus, ga_pair):
    d, h5, slides = corpus
    jm, params, tm = ga_pair
    conf = Config(arch="ga", n_token=K, D_feat=D, D_inner=L, n_class=2)
    ckpt = str(d / "ckpt" / "checkpoint-best.pth")
    checkpoint.save(ckpt, tm, epoch=3, conf=conf)
    out_csv = str(d / "preds.csv")
    # the YAML's pretrain tag says 384/128; the checkpoint's config wins
    res = predict.main(["--config",
                        os.path.join(REPO, "config/camelyon_medical_ssl_config.yml"),
                        "--ckpt", str(d / "ckpt"), "--features", h5,
                        "--out_csv", out_csv, "--device", "cpu"])
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["slide_id", "label", "prob_0", "prob_1", "pred"]
    assert [r[0] for r in rows[1:]] == list(slides)
    jstep = jax_make_eval_step(jm, "acmil")
    for name, label, p0, p1, pred in res["rows"]:
        item = slides[name]
        bag = jax_bags.pad_bag(item["feat"].astype(np.float16), item["coords"],
                               item["label"], min_bucket=256)
        want = np.asarray(jstep(params, bag))[0]
        np.testing.assert_allclose([p0, p1], want, atol=PROB_ATOL, rtol=0)
        assert label == item["label"] and pred == int(np.argmax([p0, p1]))
    assert set(res["metrics"]) == {"auc", "acc", "f1"}


def test_torch_feature_file_matches_h5(corpus):
    d, h5, slides = corpus
    pt = str(d / "feats.pt")
    write_feature_pt(pt, slides)
    a, b = open_feature_source(h5), open_feature_source(pt)
    assert isinstance(b, PtBagSource) and a.names == b.names == list(slides)
    assert a.lengths() == b.lengths() and a.feat_dim() == b.feat_dim() == D
    for i in range(len(a)):
        x, y = a[i], b[i]
        np.testing.assert_array_equal(x["input"], y["input"])
        np.testing.assert_array_equal(x["coords"], y["coords"])
        assert x["label"] == y["label"] and x["name"] == y["name"]


def test_import_pulls_in_no_jax():
    code = ("import sys, acmil_tpu_torch, acmil_tpu_torch.cli.predict, "
            "acmil_tpu_torch.models.fast, acmil_tpu_torch.models.convert, "
            "acmil_tpu_torch.data, acmil_tpu_torch.engine.checkpoint, "
            "acmil_tpu_torch.parallel, acmil_tpu_torch.cli.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'acmil_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_jax():
    for path in glob.glob(os.path.join(REPO, "acmil_tpu_torch", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    assert words[1].split(".")[0] not in (
                        "jax", "flax", "optax", "acmil_tpu"), (path, line)


@pytest.mark.parametrize("yml", sorted(glob.glob(os.path.join(REPO, "config", "*.yml"))))
def test_config_matches_jax_config(yml):
    want = JaxConfig.from_yaml(yml, {"n_token": 5}).to_dict()
    got = Config.from_yaml(yml, {"n_token": 5}).to_dict()
    want.pop("scan_epoch")                   # the TPU-only field
    assert got == want


@pytest.mark.parametrize("n, min_bucket, max_patches",
                         [(1, 256, 65536), (300, 64, 65536),
                          (70000, 256, 65536), (5000, 256, 4096)])
def test_bucketing_and_padding_match_jax(n, min_bucket, max_patches):
    assert bags.bucket_length(n, min_bucket, max_patches) == \
        jax_bags.bucket_length(n, min_bucket, max_patches)
    rs = np.random.RandomState(n)
    f = rs.randn(min(n, 9000), 8).astype(np.float32)
    c = rs.randint(0, 100, (len(f), 2))
    got = bags.pad_bag(f, c, 1, min_bucket=min_bucket, max_patches=max_patches)
    want = jax_bags.pad_bag(f, c, 1, min_bucket=min_bucket,
                            max_patches=max_patches)
    for g, w in zip((got.feats, got.mask, got.coords, got.label),
                    (want.feats, want.mask, want.coords, want.label)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collate_and_plan_match_jax():
    rs = np.random.RandomState(0)
    lens = [40, 300, 70, 900, 1000, 65, 5]
    feats = [rs.randn(n, 4).astype(np.float32) for n in lens]
    coords = [rs.randint(0, 9, (n, 2)) for n in lens]
    got = bags.collate_bags(feats, coords, list(range(7)), 64, 512)
    want = jax_bags.collate_bags(feats, coords, list(range(7)), 64, 512)
    for g, w in zip((got.feats, got.mask, got.coords, got.label),
                    (want.feats, want.mask, want.coords, want.label)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bags.bucket_plan(lens, 2, 64, 512) == \
        jax_bags.bucket_plan(lens, 2, 64, 512)


@pytest.mark.parametrize("shuffle, cache_device", [(False, False),
                                                   (True, False),
                                                   (True, True)])
def test_loader_batches_match_jax(corpus, shuffle, cache_device):
    _, h5, slides = corpus
    names = sorted(slides)
    kw = dict(batch_size=3, shuffle=shuffle, seed=5, min_bucket=64,
              cache_device=cache_device)
    jl = JaxBagLoader(JaxSource(h5, names), **kw)
    tl = BagLoader(FeatureBagSource(h5, names), **kw)
    assert len(tl) == len(jl)
    for _ in range(2):                      # a second epoch replays/reshuffles
        for jb, tb in zip(jl, tl):
            np.testing.assert_array_equal(tb.feats.numpy(),
                                          np.asarray(jb.feats))
            np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
            np.testing.assert_array_equal(tb.label.numpy(),
                                          np.asarray(jb.label))


@pytest.mark.parametrize("case", ["binary", "ties", "multiclass", "one_class"])
def test_metrics_match_jax(case):
    rs = np.random.RandomState(3)
    n_class = 3 if case == "multiclass" else 2
    probs = rs.dirichlet(np.ones(n_class), size=40)
    if case == "ties":
        probs = np.round(probs, 1)
    labels = rs.randint(0, n_class, 40)
    if case == "one_class":
        labels[:] = 1
    got, want = classification_metrics(probs, labels), jax_metrics(probs, labels)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_equal(got[k], want[k])


def test_is_better_matches_jax():
    cases = [({"f1": 0.5, "auc": 0.9}, {}),
             ({"f1": 0.5, "auc": 0.9}, {"f1": 0.6, "auc": 0.9}),
             ({"f1": float("nan"), "auc": 0.7, "acc": 0.8},
              {"f1": 0.1, "auc": 0.5, "acc": 0.1})]
    for m, best in cases:
        for sel in ("macro", "micro"):
            assert is_better(m, best, sel) == jax_is_better(m, best, sel)


def test_checkpoint_loads_reference_struct_config(tmp_path):
    """A reference ``save_model`` file pickles its config as a
    ``utils.utils.Struct``; it loads without unpickling arbitrary code."""
    import types

    mods = {n: types.ModuleType(n) for n in ("utils", "utils.utils")}

    class Struct:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    Struct.__module__, Struct.__qualname__ = "utils.utils", "Struct"
    mods["utils.utils"].Struct = Struct
    mods["utils"].utils = mods["utils.utils"]
    saved = {n: sys.modules.get(n) for n in mods}
    tm = ACMIL_GA(2, d_feat=D, d_inner=L, n_token=2)
    path = str(tmp_path / "checkpoint-best.pth")
    try:
        sys.modules.update(mods)
        torch.save({"model": tm.state_dict(), "optimizer": {}, "epoch": 7,
                    "config": Struct(arch="ga", n_token=2, lr=1e-4)}, path)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    ck = checkpoint.load(checkpoint.checkpoint_path(str(tmp_path)))
    assert ck["epoch"] == 7 and ck["config"] == {"arch": "ga", "n_token": 2,
                                                 "lr": 1e-4}
    m2 = ACMIL_GA(2, d_feat=D, d_inner=L, n_token=2)
    m2.load_state_dict(ck["model"])
    conf = Config(n_token=5)
    checkpoint.adopt_checkpoint_config(conf, ck["config"])
    assert conf.n_token == 2


@pytest.mark.parametrize("dataset, n_class, n_shot",
                         [("camelyon", 2, -1), ("camelyon", 2, 2),
                          ("lct", 4, -1), ("lct", 2, 1)])
def test_splits_match_jax(corpus, tmp_path, dataset, n_class, n_shot):
    """Both packages split one H5 into the same train/val/test slides (the
    random fallback when no frozen split file exists)."""
    from acmil_tpu.data import build_hdf5_feat_dataset as jax_build
    from acmil_tpu_torch.data import build_hdf5_feat_dataset

    _, h5, _ = corpus
    kw = dict(dataset=dataset, n_class=n_class, n_shot=n_shot, seed=3,
              split_dir=str(tmp_path))
    with pytest.warns(UserWarning, match="frozen split file"):
        want = jax_build(h5, JaxConfig.from_dict(kw))
    with pytest.warns(UserWarning, match="frozen split file"):
        got = build_hdf5_feat_dataset(h5, Config.from_dict(kw))
    for g, w in zip(got, want):
        assert g.names == w.names
        assert [g.label_of(n) for n in g.names] == \
            [w.label_of(n) for n in w.names]
        g.close()
        w.close()
