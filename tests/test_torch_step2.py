"""The Step2 slice as a whole: ``acmil_tpu_torch.cli.step2_extract.main`` on
the CPU against the JAX package's ``Step2_feature_extract.main``, over two
synthetic PNG slides with Step1-schema coords H5s, one read at the model's
size and one resized. Both packages' ``ENCODER_SPECS`` map the ViT-S/16 key
to the same tiny f32 trunk, and both load the same ``--pretrain_weights``
``.pth``, written from the JAX parameters through the port's converter.
"""

import csv
import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import Step2_feature_extract as jax_step2
from acmil_tpu.models.encoders import build as jax_build
from acmil_tpu.models.encoders.vit import ViT as JaxViT
from acmil_tpu.wsi.synthetic import make_synthetic_slide_image as jax_synth
from acmil_tpu.wsi.tiling import TilingResult, save_coords_h5
from acmil_tpu_torch.cli import predict, step2_extract, step3_acmil
from acmil_tpu_torch.data.ptio import open_feature_source
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.models.encoders import build
from acmil_tpu_torch.models.encoders.vit import ViT
from acmil_tpu_torch.wsi import synthetic, tiling
from acmil_tpu_torch.wsi.slide import open_slide

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUNK = dict(patch=16, dim=64, depth=2, heads=2, img_size=32)
KEY = ("medical_ssl", "ViT-S/16")
# f32 compute on both sides (the tiny trunk ignores the requested dtype),
# stored as fp16: fp16 rounding (2**-11 relative) plus f32 summation order
FEAT_TOL = 2e-3
# (name, width, height, Step1 patch_size at level 0): the second slide's
# 48-px patches are resized to the trunk's 32 px
SLIDES = (("slide_a", 256, 192, 32), ("slide_b", 288, 192, 48))
BATCH = 20


@pytest.fixture(scope="module")
def step2_inputs(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("step2")
    slide_dir, coords_dir = d / "slides", d / "coords"
    os.makedirs(slide_dir)
    for i, (name, w, h, ps) in enumerate(SLIDES):
        img, _ = jax_synth(w, h, n_blobs=2, seed=i)
        cv2.imwrite(str(slide_dir / f"{name}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        xs, ys = np.meshgrid(np.arange(0, w - ps + 1, ps),
                             np.arange(0, h - ps + 1, ps), indexing="ij")
        coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.int64)
        attrs = {"patch_size": ps, "patch_level": 0, "downsample": 1.0,
                 "downsampled_level_dim": (w, h), "level_dim": (w, h)}
        save_coords_h5(str(coords_dir / f"{name}.h5"),
                       TilingResult(coords, np.zeros(len(coords), np.int64),
                                    ps, 0, attrs), name=name)
    with open(d / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([["slide_id", "label"], ["slide_a", 1],
                                 ["slide_b", 0]])
    m = JaxViT(**TRUNK)
    params = m.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"]
    weights = str(d / "vit_tiny.pth")
    torch.save({"model": from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "vit")}, weights)
    return d, weights


@pytest.fixture
def tiny_specs(monkeypatch):
    monkeypatch.setitem(jax_build.ENCODER_SPECS, KEY, jax_build.EncoderSpec(
        lambda dt: JaxViT(**TRUNK, dtype=jnp.float32), 64, 32,
        jax_build.HALF_MEAN, jax_build.HALF_STD, "vit", depth=2))
    monkeypatch.setitem(build.ENCODER_SPECS, KEY, build.EncoderSpec(
        lambda dt: ViT(**TRUNK, dtype=torch.float32), 64, 32,
        build.HALF_MEAN, build.HALF_STD, "vit", depth=2))


def _args(d, weights, out):
    return ["--slide_dir", str(d / "slides"), "--coords_dir",
            str(d / "coords"), "--output_dir", str(out), "--pretrain",
            "medical_ssl", "--backbone", "ViT-S/16", "--pretrain_weights",
            weights, "--batch_size", str(BATCH), "--label_csv",
            str(d / "labels.csv")]


def _read_h5(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k]["feat"][:], f[k]["coords"][:],
                    int(f[k].attrs["label"])) for k in f}


def test_step2_matches_the_jax_script(step2_inputs, tiny_specs, monkeypatch,
                                      tmp_path):
    d, weights = step2_inputs
    monkeypatch.setattr(sys, "argv", ["Step2"] + _args(d, weights,
                                                       tmp_path / "jax"))
    jax_step2.main()
    want = _read_h5(tmp_path / "jax" / "patch_feats_pretrain_medical_ssl.h5")

    res = step2_extract.main(_args(d, weights, tmp_path / "port")
                             + ["--device", "cpu"])
    got = _read_h5(res["out_path"])
    assert set(got) == set(want) == {"slide_a", "slide_b"}
    for name in want:
        (gf, gc, gl), (wf, wc, wl) = got[name], want[name]
        assert gf.dtype == wf.dtype == np.float16 and gf.shape == wf.shape
        assert gf.shape[1] == 64 and len(gf) % BATCH     # a ragged last batch
        np.testing.assert_array_equal(gc, wc)
        assert gl == wl
        np.testing.assert_allclose(gf.astype(np.float32),
                                   wf.astype(np.float32), atol=FEAT_TOL,
                                   rtol=FEAT_TOL)
    assert res["slides"] == {k: len(v[0]) for k, v in want.items()}
    # a second run skips the slides the file already holds
    again = step2_extract.main(_args(d, weights, tmp_path / "port")
                               + ["--device", "cpu"])
    assert again["slides"] == {}


def test_torch_file_adapters_match_the_h5_path(step2_inputs, tiny_specs,
                                               tmp_path):
    """``--coords_format pt`` and ``--out_format pt``: the same features as
    the H5 path, read back through ``open_feature_source``."""
    d, weights = step2_inputs
    h5 = step2_extract.main(_args(d, weights, tmp_path / "h5")
                            + ["--device", "cpu"])
    pt_coords = tmp_path / "coords_pt"
    for name, *_ in SLIDES:
        coords, labels, attrs = tiling.load_coords_h5(
            str(d / "coords" / f"{name}.h5"))
        tiling.save_coords_pt(str(pt_coords / f"{name}.pt"), coords, attrs,
                              labels)
        back = tiling.load_coords_pt(str(pt_coords / f"{name}.pt"))
        np.testing.assert_array_equal(back[0], coords)
        assert back[2]["patch_size"] == attrs["patch_size"]
    argv = _args(d, weights, tmp_path / "pt")
    argv[argv.index("--coords_dir") + 1] = str(pt_coords)
    res = step2_extract.main(argv + ["--device", "cpu", "--coords_format",
                                     "pt", "--out_format", "pt"])
    assert res["out_path"].endswith(".pt")
    want = _read_h5(h5["out_path"])
    src = open_feature_source(res["out_path"])
    assert sorted(src.names) == sorted(want)
    for i, name in enumerate(src.names):
        item = src[i]
        np.testing.assert_array_equal(item["input"],
                                      want[name][0].astype(np.float32))
        np.testing.assert_array_equal(item["coords"], want[name][1])
        assert item["label"] == want[name][2]


def test_step2_on_spy_slides_matches_the_jax_script(step2_inputs, tiny_specs,
                                                   monkeypatch, tmp_path):
    """The same two slides as JPEG SPY pyramids (64-px tiles, so patches
    straddle tiles), read by each package's own native reader."""
    import cv2

    from acmil_tpu_torch.wsi.native import write_spy

    d, weights = step2_inputs
    spy_dir = tmp_path / "spy"
    os.makedirs(spy_dir)
    for name, *_ in SLIDES:
        img = cv2.cvtColor(cv2.imread(str(d / "slides" / f"{name}.png")),
                           cv2.COLOR_BGR2RGB)
        write_spy(str(spy_dir / f"{name}.spy"), [img], tile_size=64)
    argv = _args(d, weights, tmp_path / "jax")
    argv[argv.index("--slide_dir") + 1] = str(spy_dir)
    monkeypatch.setattr(sys, "argv", ["Step2"] + argv)
    jax_step2.main()
    want = _read_h5(tmp_path / "jax" / "patch_feats_pretrain_medical_ssl.h5")
    argv[argv.index("--output_dir") + 1] = str(tmp_path / "port")
    res = step2_extract.main(argv + ["--device", "cpu"])
    got = _read_h5(res["out_path"])
    assert set(got) == set(want) == {"slide_a", "slide_b"}
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name][1])
        np.testing.assert_allclose(got[name][0].astype(np.float32),
                                   want[name][0].astype(np.float32),
                                   atol=FEAT_TOL, rtol=FEAT_TOL)


def test_image_slide_matches_jax(tmp_path):
    # a PNG wider than 1024 px, so both pyramids have a second level; reads
    # at both levels, one of them past the right edge
    import cv2
    from acmil_tpu.wsi.slide import SLIDE_EXTS as JAX_SLIDE_EXTS
    from acmil_tpu.wsi.slide import open_slide as jax_open_slide
    from acmil_tpu_torch.wsi.slide import SLIDE_EXTS

    img, _ = synthetic.make_synthetic_slide_image(1100, 600, seed=5,
                                                  tumor=True)
    path = str(tmp_path / "wide.png")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    got, want = open_slide(path), jax_open_slide(path, cache=False)
    assert got.level_dimensions == want.level_dimensions
    assert got.level_downsamples == want.level_downsamples
    for loc, level, size in (((5, 7), 0, (40, 30)), ((1000, 400), 1, (64, 32))):
        np.testing.assert_array_equal(got.read_region(loc, level, size),
                                      want.read_region(loc, level, size))
    assert SLIDE_EXTS == JAX_SLIDE_EXTS


def test_synthetic_slides_match_jax():
    a, ca = synthetic.make_synthetic_slide_image(96, 64, seed=3, tumor=True)
    b, cb = jax_synth(96, 64, seed=3, tumor=True)
    np.testing.assert_array_equal(a, b)
    assert ca == cb


@pytest.mark.parametrize("flag", ["--mesh_data", "--mesh_model"])
def test_step2_refuses_what_is_not_ported(step2_inputs, flag, tmp_path):
    d, weights = step2_inputs
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step2_extract.main(_args(d, weights, tmp_path) + [flag, "2",
                                                          "--device", "cpu"])


@pytest.mark.parametrize("entry", ["step2", "predict", "step3"])
def test_entry_points_need_a_card_unless_told_cpu(entry, step2_inputs,
                                                  monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, weights = step2_inputs
    yml = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")
    run = {"step2": lambda: step2_extract.main(_args(d, weights, tmp_path)),
           "predict": lambda: predict.main(
               ["--config", yml, "--ckpt", str(tmp_path / "none.pth"),
                "--features", str(tmp_path / "none.pt")]),
           "step3": lambda: step3_acmil.main(["--config", yml, "--data_dir",
                                              str(tmp_path)])}[entry]
    with pytest.raises(RuntimeError, match="--device cpu"):
        run()


def test_port_imports_no_jax_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'acmil_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import pkgutil, importlib, acmil_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    acmil_tpu_torch.__path__, 'acmil_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "import chip_smoke, torch\n"
            "from acmil_tpu_torch.models.encoders.vit import ViT\n"
            "from acmil_tpu_torch.models.encoders.fast import vit_encode\n"
            "m = ViT(16, 64, 1, 2, img_size=32)\n"
            "f = vit_encode(m.state_dict(), torch.zeros(1, 32, 32, 3),\n"
            "               patch=16, depth=1, heads=2)\n"
            "from acmil_tpu_torch.models import DSMIL\n"
            "from acmil_tpu_torch.models.fast import dsmil_eval_fused\n"
            "d = DSMIL(2, 32, 16, nonlinear=False)\n"
            "x, mk = torch.randn(1, 40, 32), torch.ones(1, 40, dtype=torch.bool)\n"
            "inst, bag, a = d(x, mk)\n"
            "mi, bl = dsmil_eval_fused(d, x, mk)\n"
            "torch.testing.assert_close(bl, bag)\n"
            "print(len(names), tuple(f.shape), tuple(bl.shape))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-4:] == ["(1,", "64)", "(1,", "2)"]
