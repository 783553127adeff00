"""Step2's ResNet trunks and ROI path in the port against the JAX package:
``encoders/resnet.py`` against the flax ResNet-18/50 through both
converters (the flax tree, and a torchvision-layout checkpoint that each
package converts its own way), ``encoder_feature_fn`` on a ResNet, the
``ENCODER_SPECS`` rows, and ``cli/step2_extract.main`` with a ResNet
backbone and with ``--roi_dir`` against ``Step2_feature_extract.main``.
Small images (32-64 px) in float32 on both sides.
"""

import os
import sys
from dataclasses import replace

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import Step2_feature_extract as jax_step2
from acmil_tpu.models.encoders import build as jax_build
from acmil_tpu.models.encoders import convert as jax_convert
from acmil_tpu.models.encoders import resnet as jax_resnet
from acmil_tpu.wsi.synthetic import make_synthetic_slide_image as jax_synth
from acmil_tpu.wsi.tiling import TilingResult, save_coords_h5
from acmil_tpu_torch.cli import step2_extract
from acmil_tpu_torch.models.encoders import build, convert, resnet

# f32 on both sides; XLA's and torch's convolutions sum in other orders
# through 18 or 50 layers
FEAT_ATOL, FEAT_RTOL = 1e-4, 1e-4
# the CLI stores fp16 features: 2**-11 relative on top
FP16_TOL = 2e-3
KEY = ("natural_supervised", "Resnet18")
SIZE = 32
DEPTHS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}


def _random_variables(jmodel, size, seed):
    """flax variables with every batch-norm scale, bias and statistic drawn
    at random, so the frozen norms do work."""
    rs = np.random.RandomState(seed)
    v = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))

    def draw(path, a):
        name = str(path[-1])
        if "scale" in name:
            return (1 + 0.2 * rs.randn(*a.shape)).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (0.1 * rs.randn(*a.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + np.abs(rs.randn(*a.shape))).astype(np.float32)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, v)


def _torchvision_checkpoint(sd):
    """The port's state dict in a torchvision checkpoint's clothes: a
    ``module.`` prefix, a classifier ``fc`` and ``num_batches_tracked``."""
    out = {f"module.{k}": v.clone() for k, v in sd.items()}
    for k in sd:
        if k.endswith("running_var"):
            out[f"module.{k[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(7)
    out["module.fc.weight"] = torch.zeros(10, 4)
    out["module.fc.bias"] = torch.zeros(10)
    return out


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_matches_flax_through_both_converters(name):
    jm = getattr(jax_resnet, name)(jnp.float32)
    v = _random_variables(jm, 64, seed=1)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))

    tm = getattr(resnet, name)().eval()
    tm.load_state_dict(convert.resnet_from_flax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, tm.embed_dim)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=FEAT_RTOL)

    # a torchvision checkpoint: the JAX converter's tree and the port's
    # state dict give the same features
    ckpt = _torchvision_checkpoint(tm.state_dict())
    p2, s2 = jax_convert.convert_resnet(ckpt, stage_sizes=DEPTHS[name])
    want2 = np.asarray(jax.jit(jm.apply)({"params": p2, "batch_stats": s2},
                                         jnp.asarray(x)))
    tm2 = getattr(resnet, name)().eval()
    tm2.load_state_dict(convert.resnet_state_dict(ckpt))
    with torch.no_grad():
        got2 = tm2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got2, want2, atol=FEAT_ATOL, rtol=FEAT_RTOL)
    np.testing.assert_allclose(got2, got, atol=0, rtol=0)


def test_resnet_computes_in_its_dtype_with_f32_norms():
    tm = resnet.resnet18(torch.bfloat16).eval().cast_convs_(torch.bfloat16)
    assert tm.conv1.weight.dtype == torch.bfloat16
    assert tm.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert tm.bn1.weight.dtype == tm.bn1.running_var.dtype == torch.float32
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = tm(x)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 512)


def test_encoder_feature_fn_on_a_resnet_matches_jax():
    spec = replace(build.ENCODER_SPECS[KEY], img_size=SIZE)
    jspec = replace(jax_build.ENCODER_SPECS[KEY], img_size=SIZE)
    jm = jax_build.CustomModel(encoder=jax_resnet.resnet18(jnp.float32),
                               n_class=2)
    jv = _random_variables(jm, SIZE, seed=4)
    u8 = np.random.RandomState(5).randint(0, 256, (3, SIZE, SIZE, 3)
                                          ).astype(np.uint8)
    want = np.asarray(jax_build.encoder_feature_fn(jm, jv, jspec)(u8))

    tm = build.CustomModel(resnet.resnet18(torch.float32), 2)
    tm.encoder.load_state_dict(convert.resnet_from_flax(
        jv["params"]["encoder"], jv["batch_stats"]["encoder"]))
    fn = build.encoder_feature_fn(tm, spec, torch.device("cpu"))
    got = fn(u8).numpy()
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=FP16_TOL, rtol=FP16_TOL)
    f32 = build.encoder_feature_fn(tm, spec, torch.device("cpu"),
                                   out_dtype=torch.float32)(u8)
    assert f32.dtype == torch.float32


@pytest.mark.parametrize("backbone, pretrain", [
    ("Resnet18", "natural_supervised"), ("Resnet50", "medical_ssl")])
def test_build_encoder_loads_a_torchvision_checkpoint(backbone, pretrain,
                                                      tmp_path):
    src = (resnet.resnet18 if backbone == "Resnet18" else resnet.resnet50)()
    path = str(tmp_path / "rn.pth")
    torch.save({"state_dict": _torchvision_checkpoint(src.state_dict())},
               path)

    class C:
        n_class, pretrain_weights = 2, path

    C.backbone, C.pretrain = backbone, pretrain
    model, spec, state = build.build_encoder(C())
    assert spec is build.ENCODER_SPECS[(pretrain, backbone)]
    assert set(state) == set(model.encoder.state_dict())
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.encoder.state_dict()[k], v)
    jmodel, jspec, jvars = jax_build.build_encoder(C())
    assert jspec.embed_dim == spec.embed_dim == model.encoder.embed_dim
    assert set(jvars["batch_stats"]["encoder"]) == set(
        jvars["params"]["encoder"]) - {"conv1"}


# ---------------------------------------------------------------------------
# Step2 through the CLI: ResNet slides and the ROI path
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_resnet_specs(monkeypatch):
    # both packages' natural_supervised/Resnet18 row at 32 px in float32
    monkeypatch.setitem(jax_build.ENCODER_SPECS, KEY, replace(
        jax_build.ENCODER_SPECS[KEY], img_size=SIZE,
        builder=lambda dt: jax_resnet.resnet18(jnp.float32)))
    monkeypatch.setitem(build.ENCODER_SPECS, KEY, replace(
        build.ENCODER_SPECS[KEY], img_size=SIZE,
        builder=lambda dt: resnet.resnet18(torch.float32)))


@pytest.fixture(scope="module")
def resnet_inputs(tmp_path_factory):
    """Two synthetic PNG slides with Step1 coords, a tiny ImageFolder of
    ROI crops (three classes, two crops of other sizes each) and a
    torchvision-layout ResNet-18 checkpoint."""
    d = tmp_path_factory.mktemp("resnet_step2")
    os.makedirs(d / "slides")
    for i, (name, w, h) in enumerate((("s0", 160, 128), ("s1", 128, 96))):
        img, _ = jax_synth(w, h, n_blobs=2, seed=10 + i)
        cv2.imwrite(str(d / "slides" / f"{name}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        xs, ys = np.meshgrid(np.arange(0, w - SIZE + 1, SIZE),
                             np.arange(0, h - SIZE + 1, SIZE), indexing="ij")
        coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.int64)
        attrs = {"patch_size": SIZE, "patch_level": 0, "downsample": 1.0,
                 "downsampled_level_dim": (w, h), "level_dim": (w, h)}
        save_coords_h5(str(d / "coords" / f"{name}.h5"),
                       TilingResult(coords, np.zeros(len(coords), np.int64),
                                    SIZE, 0, attrs), name=name)
    rs = np.random.RandomState(7)
    for c in ("a_normal", "b_tumor", "c_other"):
        os.makedirs(d / "roi" / c)
        for j, px in enumerate((40, 24)):
            crop = rs.randint(0, 256, (px, px + 8, 3)).astype(np.uint8)
            cv2.imwrite(str(d / "roi" / c / f"crop{j}.png"), crop)
    jm = jax_resnet.resnet18(jnp.float32)
    v = _random_variables(jm, SIZE, seed=8)
    weights = str(d / "rn18.pth")
    torch.save(_torchvision_checkpoint(convert.resnet_from_flax(
        v["params"], v["batch_stats"])), weights)
    return d, weights


def _step2_args(d, weights, out):
    return ["--output_dir", str(out), "--pretrain", KEY[0], "--backbone",
            KEY[1], "--pretrain_weights", weights, "--batch_size", "4"]


def test_step2_with_a_resnet_matches_the_jax_script(resnet_inputs,
                                                    tiny_resnet_specs,
                                                    monkeypatch, tmp_path):
    d, weights = resnet_inputs
    slides = ["--slide_dir", str(d / "slides"), "--coords_dir",
              str(d / "coords")]
    monkeypatch.setattr(sys, "argv", ["Step2"] + slides + _step2_args(
        d, weights, tmp_path / "jax"))
    jax_step2.main()
    res = step2_extract.main(slides + _step2_args(d, weights, tmp_path / "port")
                             + ["--device", "cpu"])
    out = {}
    for side, path in (("jax", tmp_path / "jax"), ("port", tmp_path / "port")):
        with h5py.File(path / f"patch_feats_pretrain_{KEY[0]}.h5", "r") as f:
            out[side] = {k: f[k]["feat"][:] for k in f}
    assert set(out["port"]) == set(out["jax"]) == {"s0", "s1"}
    assert res["patches"] == 20 + 12
    for name, want in out["jax"].items():
        got = out["port"][name]
        assert got.dtype == np.float16 and got.shape == want.shape
        assert got.shape[1] == 512 and np.isfinite(got).all()
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=FP16_TOL,
                                   rtol=FP16_TOL)


def test_roi_path_matches_extract_roi_features(resnet_inputs,
                                               tiny_resnet_specs,
                                               monkeypatch, tmp_path):
    d, weights = resnet_inputs
    roi = ["--roi_dir", str(d / "roi")]
    monkeypatch.setattr(sys, "argv", ["Step2"] + roi + _step2_args(
        d, weights, tmp_path / "jax"))
    jax_step2.main()
    want = np.load(tmp_path / "jax" / "roi_feats.npy")
    res = step2_extract.main(roi + _step2_args(d, weights, tmp_path / "port")
                             + ["--device", "cpu"])
    got = np.load(res["out_path"])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (2, 512)    # class 0 skipped
    np.testing.assert_array_equal(got, res["centroids"])
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=FEAT_RTOL)
