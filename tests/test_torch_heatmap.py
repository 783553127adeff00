"""The port's Step4 slice (acmil_tpu_torch/wsi/heatmap.py, wsi/stitch.py's
``to_percentiles``, cli/step4_heatmap.py) against the JAX package's
functions and the JAX Step4 formula, on the same seeded inputs.

The canvas sums scores in float32 in both packages, in whatever order each
scatter-add takes, so canvases agree within 1e-6; where no two patches share
a cell each cell holds one score and the images are bit-equal; elsewhere a
rounding difference can move a colormap index by one step, so the images
agree within 1 level. The port's ``jet`` is computed without matplotlib and
must equal matplotlib's bit for bit.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops.masked import masked_softmax as jax_masked_softmax
from acmil_tpu.wsi import heatmap as jax_heatmap
from acmil_tpu.wsi import stitch as jax_stitch
from acmil_tpu.wsi.slide import ImageSlide as JaxImageSlide
from acmil_tpu_torch.cli import step4_heatmap
from acmil_tpu_torch.config import Config
from acmil_tpu_torch.data import write_feature_pt
from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.engine import checkpoint
from acmil_tpu_torch.models import build_mil_model
from acmil_tpu_torch.models.common import torch_linear_init_
from acmil_tpu_torch.wsi import heatmap, stitch
from acmil_tpu_torch.wsi.slide import ImageSlide, open_slide
from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image
from scripts.import_torch_checkpoint import CONVERTERS

CANVAS_ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")


@pytest.fixture(scope="module")
def slides():
    # the slide of tests/test_wsi.py
    img, _ = make_synthetic_slide_image(2048, 1536, seed=1, tumor=True)
    return ImageSlide(img), JaxImageSlide(img)


def _grid(w, h, step):
    """Non-overlapping patch origins on a ``step`` grid."""
    xs, ys = np.meshgrid(np.arange(0, w - step + 1, step),
                         np.arange(0, h - step + 1, step), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel()], 1)


def _overlapping(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 1900, (n, 2)), rs.rand(n)


@pytest.mark.parametrize("scores", [np.random.RandomState(0).rand(97),
                                    np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0])])
def test_to_percentiles_matches_jax(scores):
    np.testing.assert_array_equal(stitch.to_percentiles(scores),
                                  jax_stitch.to_percentiles(scores))


@pytest.mark.parametrize("overlap", [False, True])
def test_accumulate_scores_matches_jax(overlap):
    if overlap:
        coords, scores = _overlapping(600, 1)
    else:
        coords = _grid(2048, 1536, 256)
        scores = np.random.RandomState(2).rand(len(coords))
    for scale in (0.25, 1 / 16):
        cw, ch = int(2048 * scale), int(1536 * scale)
        got, got_cover = heatmap.accumulate_scores(scores, coords, 256,
                                                   (cw, ch), scale)
        want, want_cover = jax_heatmap.accumulate_scores(scores, coords, 256,
                                                         (cw, ch), scale)
        assert got.dtype == np.float32 and got.shape == (ch, cw)
        np.testing.assert_allclose(got, want, atol=CANVAS_ATOL, rtol=0)
        if not overlap:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_cover, want_cover)


def test_jet_is_matplotlibs_without_matplotlib(monkeypatch):
    from matplotlib import colormaps

    rs = np.random.RandomState(3)
    x32 = rs.rand(128, 96).astype(np.float32)
    x32[0, :6] = [0.0, 1.0, np.nan, -0.5, 1.5, 255.5 / 256]
    x32[1, :] = np.linspace(0, 1, 96, dtype=np.float32)
    x64 = rs.rand(40, 30)
    want = [(colormaps["jet"](np.clip(x, 0, 1)) * 255)[:, :, :3]
            .astype(np.uint8) for x in (x32, x64)]
    np.testing.assert_array_equal(heatmap.jet_lut(),
                                  colormaps["jet"](np.arange(256))[:, :3])
    # matplotlib blocked from import: jet is computed in numpy
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for x, w in zip((x32, x64), want):
        got = heatmap.apply_colormap(x)
        assert got.dtype == np.uint8 and got.shape == x.shape + (3,)
        np.testing.assert_array_equal(got, w)
    with pytest.raises(ImportError):
        heatmap.apply_colormap(x64, "viridis")


def test_other_colormaps_match_jax():
    x = np.random.RandomState(4).rand(20, 30).astype(np.float32)
    np.testing.assert_array_equal(heatmap.apply_colormap(x, "viridis"),
                                  jax_heatmap.apply_colormap(x, "viridis"))


@pytest.mark.parametrize("blank_canvas", [False, True])
def test_block_blend_matches_jax(slides, blank_canvas):
    lw, lh = slides[0].level_dimensions[1]
    rs = np.random.RandomState(5)
    colored = rs.randint(0, 255, (lh, lw, 3), np.uint8)
    cover = (rs.rand(lh, lw) < 0.5).astype(np.uint8)
    for block in (96, 1024):
        kw = dict(block_size=block, blank_canvas=blank_canvas)
        np.testing.assert_array_equal(
            heatmap.block_blend(slides[0], colored, cover, 1, 0.4, **kw),
            jax_heatmap.block_blend(slides[1], colored, cover, 1, 0.4, **kw))


@pytest.mark.parametrize("kw", [dict(canvas_max=512), {},
                                dict(vis_level=1, block_size=300),
                                dict(vis_level=0, blur=False, alpha=0.7,
                                     convert_to_percentiles=False),
                                dict(canvas_max=512, blank_canvas=True)])
def test_vis_heatmap_matches_jax_without_overlap(slides, kw):
    coords = _grid(2048, 1536, 256)
    scores = np.random.RandomState(6).rand(len(coords))
    got = heatmap.vis_heatmap(slides[0], scores, coords,
                              patch_size=(256, 256), **kw)
    want = jax_heatmap.vis_heatmap(slides[1], scores, coords,
                                   patch_size=(256, 256), **kw)
    level = heatmap.render_level(slides[0], kw.get("vis_level"),
                                 kw.get("canvas_max", 2048))
    lw, lh = slides[0].level_dimensions[level]
    assert got.shape == (lh, lw, 3)
    np.testing.assert_array_equal(got, want)


def test_vis_heatmap_within_one_level_with_overlap(slides):
    coords, scores = _overlapping(900, 7)
    for kw in (dict(canvas_max=512), dict(vis_level=1)):
        got = heatmap.vis_heatmap(slides[0], scores, coords,
                                  patch_size=(256, 256), **kw)
        want = jax_heatmap.vis_heatmap(slides[1], scores, coords,
                                       patch_size=(256, 256), **kw)
        assert np.abs(got.astype(int) - want).max() <= 1


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def step4_inputs(tmp_path_factory):
    """Four synthetic PNG slides with grid coords and fp16 bags at the
    camelyon_medical_ssl width, a frozen split (2 train, 0 val, 2 test) for
    Step3's default seed 4, and a YAML naming both."""
    import cv2

    d = tmp_path_factory.mktemp("step4")
    rs = np.random.RandomState(8)
    bags = {}
    os.makedirs(d / "slides")
    for i in range(4):
        name = f"slide_{i}"
        img, _ = make_synthetic_slide_image(1536, 1024, seed=i, tumor=i % 2)
        cv2.imwrite(str(d / "slides" / f"{name}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        coords = _grid(1536, 1024, 128)
        bags[name] = {"feat": rs.randn(len(coords), 384).astype(np.float16),
                      "coords": coords, "label": i % 2}
    write_feature_pt(str(d / "data" / "patch_feats_pretrain_medical_ssl.pt"),
                     bags)
    names = sorted(bags)
    os.makedirs(d / "splits" / "camelyon")
    with open(d / "splits" / "camelyon" / "split_4.json", "w") as f:
        json.dump({"train_names": names[:2], "val_names": [],
                   "test_names": names[2:]}, f)
    yml = d / "conf.yml"
    with open(YML) as src:
        yml.write_text(src.read() + f"\ndata_dir: {d / 'data'}\n"
                       f"split_dir: {d / 'splits'}\n")
    return d, yml, bags


def _checkpoint(d, arch, seed=0):
    """A seeded head of ``arch`` saved as ``checkpoint-best.pth``."""
    conf = Config.from_yaml(YML, {"arch": arch, "n_token": 3})
    torch.manual_seed(seed)
    model, _ = build_mil_model(conf)
    torch_linear_init_(model, torch.Generator().manual_seed(seed))
    ckpt_dir = d / f"ckpt_{arch}"
    checkpoint.save(str(ckpt_dir / "checkpoint-best.pth"), model, conf=conf)
    return str(ckpt_dir), model, conf


def _jax_step4_scores(arch, model, conf, feats):
    """The JAX Step4 formula (`Step4_visualize_heatmap_camelyon.py:76-118`)
    on the flax head holding the port's weights."""
    from acmil_tpu.config import Config as JaxConfig
    from acmil_tpu.models import build_mil_model as jax_build_model

    jm, _ = jax_build_model(JaxConfig.from_dict(conf.to_dict()))
    params = CONVERTERS[arch]({k: v for k, v in model.state_dict().items()})
    x = jnp.asarray(feats.astype(np.float32))[None]
    mask = jnp.ones(x.shape[:2], bool)
    a = jm.apply({"params": params}, x, mask, deterministic=True)[2]
    if a.ndim == 4:
        a = a.mean(axis=1)
    probs = np.asarray(jax_masked_softmax(a, mask[:, None, :]).mean(axis=1))[0]
    return probs * len(feats)


@pytest.mark.parametrize("arch", ["ga", "mha", "abmil"])
def test_step4_cli_matches_jax_formula(step4_inputs, tmp_path, arch):
    d, yml, bags = step4_inputs
    ckpt_dir, model, conf = _checkpoint(d, arch)
    out = step4_heatmap.main(["--config", str(yml), "--ckpt_dir", ckpt_dir,
                              "--slide_dir", str(d / "slides"),
                              "--output_dir", str(tmp_path), "--patch_size",
                              "128", "--device", "cpu"])
    assert sorted(out["slides"]) == ["slide_2", "slide_3"] and not out["fused"]
    import cv2

    for name, res in out["slides"].items():
        img = cv2.imread(res["path"])
        slide = open_slide(str(d / "slides" / f"{name}.png"))
        lw, lh = slide.level_dimensions[heatmap.render_level(slide)]
        assert img.shape == res["shape"] == (lh, lw, 3) == (512, 768, 3)
        assert img.std() > 10                      # not blank
        scores = res["scores"]
        assert scores.shape == (len(bags[name]["coords"]),)
        np.testing.assert_allclose(scores.mean(), 1.0, rtol=1e-5)
        if arch == "abmil":
            # the JAX script's plain route has no ABMIL attention; the JAX
            # ABMIL's return_attn gives it
            from acmil_tpu.config import Config as JaxConfig
            from acmil_tpu.models import build_mil_model as jax_build_model

            jm, _ = jax_build_model(JaxConfig.from_dict(conf.to_dict()))
            params = CONVERTERS["abmil"](model.state_dict())
            x = jnp.asarray(bags[name]["feat"].astype(np.float32))[None]
            a = jm.apply({"params": params}, x, None, return_attn=True)[1]
            want = np.asarray(jax.nn.softmax(a, axis=-1))[0, 0] * x.shape[1]
        else:
            want = _jax_step4_scores(arch, model, conf, bags[name]["feat"])
        np.testing.assert_allclose(scores, want, rtol=1e-4, atol=1e-5)


def test_step4_on_raw_spy_slides_renders_as_on_pngs(step4_inputs, tmp_path):
    """The test slides as raw SPY pyramids of their ImageSlide levels: every
    read equals the PNG's, so the heatmaps are the same images."""
    import cv2

    from acmil_tpu_torch.wsi.native import write_spy
    from acmil_tpu_torch.wsi.slide import clear_slide_cache

    d, yml, _ = step4_inputs
    ckpt_dir, _, _ = _checkpoint(d, "ga")
    spy_dir = tmp_path / "spy"
    os.makedirs(spy_dir)
    for name in ("slide_2", "slide_3"):
        png = ImageSlide(cv2.cvtColor(
            cv2.imread(str(d / "slides" / f"{name}.png")), cv2.COLOR_BGR2RGB))
        write_spy(str(spy_dir / f"{name}.spy"), png._levels, tile_size=128,
                  codec="raw")
    outs = {}
    for kind, slide_dir in (("png", d / "slides"), ("spy", spy_dir)):
        outs[kind] = step4_heatmap.main([
            "--config", str(yml), "--ckpt_dir", ckpt_dir, "--slide_dir",
            str(slide_dir), "--output_dir", str(tmp_path / kind),
            "--patch_size", "128", "--device", "cpu"])
    clear_slide_cache()
    assert sorted(outs["spy"]["slides"]) == ["slide_2", "slide_3"]
    for name, res in outs["spy"]["slides"].items():
        assert res["path"].startswith(str(tmp_path / "spy"))
        np.testing.assert_array_equal(cv2.imread(res["path"]), cv2.imread(
            outs["png"]["slides"][name]["path"]))


def test_step4_refuses_a_head_without_attention(step4_inputs, tmp_path):
    d, yml, _ = step4_inputs
    ckpt_dir, _, _ = _checkpoint(d, "mha_single")
    with pytest.raises(ValueError, match="emits no attention"):
        step4_heatmap.main(["--config", str(yml), "--ckpt_dir", ckpt_dir,
                            "--slide_dir", str(d / "slides"), "--output_dir",
                            str(tmp_path), "--device", "cpu"])


def test_step4_needs_a_card_unless_told_cpu(step4_inputs, tmp_path,
                                           monkeypatch):
    d, yml, _ = step4_inputs
    ckpt_dir, _, _ = _checkpoint(d, "ga")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        step4_heatmap.main(["--config", str(yml), "--ckpt_dir", ckpt_dir,
                            "--slide_dir", str(d / "slides"), "--output_dir",
                            str(tmp_path)])


def test_attention_probs_of_every_route_sum_to_one():
    conf = Config.from_dict({"arch": "ga", "n_token": 3, "D_feat": 16,
                             "D_inner": 8})
    model, family = build_mil_model(conf)
    x = torch.randn(2, 40, 16)
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, 25:] = False
    for fused in (True, False):
        p = step4_heatmap.attention_probs(model, Bag(x, mask, None, None),
                                          family, fused=fused)
        torch.testing.assert_close(p.sum(-1), torch.ones(2))
        assert (p[1, 25:] == 0).all()
