"""Step2 across processes: ``acmil_tpu_torch.cli.step2_extract.main`` with
``--mesh_data 2`` and ``--mesh_model 2`` on two spawned ``gloo`` ranks,
against the port's one-process run (which tests/test_torch_step2.py holds
against the JAX script) on the same synthetic PNG slides.

The encoders are tiny f32 trunks put under two keys in every process,
their weights numpy-seeded ``.pth`` files: a plain ViT-S/16 (the B3 route)
for the data axis, and a layerscale trunk under UNI's key for the model
axis, whose one-process route (B4, then the plain MLP half) computes the
tensor-parallel block's function at f32 (B3's gelu is tanh-approximate at
every dtype, as the Pallas layer kernel's, while the TP block's is exact at
f32, as in the JAX package). The batch of 7 does not divide the data axis
of 2. Ranks import this module, which imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.torch_ranks import ranks, spawn

# (pretrain, backbone) → the tiny trunk put under it
TRUNKS = {("medical_ssl", "ViT-S/16"): dict(patch=16, dim=64, depth=2,
                                            heads=2, img_size=32),
          ("UNI", "ViT-L/16"): dict(patch=16, dim=64, depth=2, heads=2,
                                    img_size=32, layerscale=True)}
DATA_KEY, MODEL_KEY = TRUNKS
BATCH = 7
# (name, width, height, patch size): 48 and 54 patches, the second slide's
# patches resized to the trunk's 32 px
SLIDES = (("slide_a", 256, 192, 32), ("slide_b", 288, 192, 48))
# --mesh_model against one process: f32 both, only the order of the sums
# differs, then one fp16 rounding of the stored features
MODEL_TOL = 1e-5


def _tiny_spec():
    from acmil_tpu_torch.models.encoders import build
    from acmil_tpu_torch.models.encoders.vit import ViT

    for key, kw in TRUNKS.items():
        build.ENCODER_SPECS[key] = build.EncoderSpec(
            lambda dt, kw=kw: ViT(**kw, dtype=torch.float32), 64, 32,
            build.HALF_MEAN, build.HALF_STD, "vit", depth=2)


def _args(inp, out, *extra, key=DATA_KEY):
    return ["--slide_dir", inp["slides"], "--coords_dir", inp["coords"],
            "--output_dir", out, "--pretrain", key[0], "--backbone",
            key[1], "--pretrain_weights", inp["weights"][key[0]],
            "--batch_size", str(BATCH), "--coords_format", "pt",
            "--device", "cpu", *extra]


def _read(path: str) -> dict:
    if path.endswith(".pt"):
        obj = torch.load(path, weights_only=True)
        return {k: (v["feat"].numpy(), v["coords"].numpy(), int(v["label"]))
                for k, v in obj.items()}
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k]["feat"][:], f[k]["coords"][:],
                    int(f[k].attrs["label"])) for k in f}


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _rank_out(inp, tag):
    # one output directory for the mesh: rank 0 writes it, the others must
    # not create a file there
    return os.path.join(inp["root"], tag)


def _case_data(inp):
    """--mesh_data 2 (H5 out), then the same command again: every slide is
    in the file, so every rank skips every slide."""
    from acmil_tpu_torch.cli import step2_extract

    _tiny_spec()
    out = _rank_out(inp, "data")
    first = step2_extract.main(_args(inp, out, "--mesh_data", "2"))
    again = step2_extract.main(_args(inp, out, "--mesh_data", "2"))
    return {"first": first["slides"], "again": again["slides"],
            "out_path": first["out_path"]}


def _case_model(inp):
    """--mesh_model 2 (torch file out)."""
    from acmil_tpu_torch.cli import step2_extract

    _tiny_spec()
    res = step2_extract.main(_args(inp, _rank_out(inp, "model"),
                                   "--mesh_model", "2", "--out_format", "pt",
                                   key=MODEL_KEY))
    return {"slides": res["slides"], "out_path": res["out_path"]}


def _case_roi(inp):
    """--roi_dir under a world of 2: rank 0 alone extracts and writes."""
    from acmil_tpu_torch.cli import step2_extract

    _tiny_spec()
    res = step2_extract.main(["--roi_dir", inp["roi"], "--output_dir",
                              _rank_out(inp, f"roi{os.environ['RANK']}"),
                              "--pretrain", "medical_ssl", "--backbone",
                              "ViT-S/16", "--pretrain_weights",
                              inp["weights"]["medical_ssl"], "--device",
                              "cpu"])
    return {"centroids": res["centroids"]}


def _case_resnet(inp):
    """A ResNet trunk under --mesh_model: the JAX message."""
    from acmil_tpu_torch.cli import step2_extract

    try:
        step2_extract.main(["--slide_dir", inp["slides"], "--coords_dir",
                            inp["coords"], "--output_dir",
                            _rank_out(inp, "resnet"), "--pretrain",
                            "natural_supervised", "--backbone", "Resnet18",
                            "--coords_format", "pt", "--device", "cpu",
                            "--mesh_model", "2"])
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


@pytest.fixture(scope="module")
def step2_mesh(tmp_path_factory):
    import cv2

    from acmil_tpu_torch.models.encoders.vit import ViT
    from acmil_tpu_torch.wsi import synthetic, tiling

    d = tmp_path_factory.mktemp("step2_mesh")
    slides, coords_dir, roi = d / "slides", d / "coords", d / "roi"
    os.makedirs(slides)
    for i, (name, w, h, ps) in enumerate(SLIDES):
        img, _ = synthetic.make_synthetic_slide_image(w, h, n_blobs=2,
                                                      seed=i)
        cv2.imwrite(str(slides / f"{name}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        xs, ys = np.meshgrid(np.arange(0, w - ps + 1, ps),
                             np.arange(0, h - ps + 1, ps), indexing="ij")
        tiling.save_coords_pt(
            str(coords_dir / f"{name}.pt"),
            np.stack([xs.ravel(), ys.ravel()], 1),
            {"patch_size": ps, "patch_level": 0, "downsample": 1.0})
    rs = np.random.RandomState(4)
    for c in ("c0", "c1", "c2"):
        os.makedirs(roi / c)
        for j in range(3):
            cv2.imwrite(str(roi / c / f"crop{j}.png"),
                        rs.randint(0, 256, (40, 40, 3)).astype(np.uint8))
    weights = {}
    for (pretrain, _), kw in TRUNKS.items():
        sd = {k: torch.from_numpy(
                  (0.1 * rs.randn(*v.shape)).astype(np.float32)
                  + (1.0 if k.endswith(("norm1.weight", "norm2.weight"))
                     or k == "norm.weight" else 0.0))
              for k, v in ViT(**kw).state_dict().items()}
        weights[pretrain] = str(d / f"vit_{pretrain}.pth")
        torch.save({"model": sd}, weights[pretrain])
    inp = {"slides": str(slides), "coords": str(coords_dir),
           "roi": str(roi), "weights": weights, "root": str(d / "mesh")}
    group = spawn(2, [_case_data, _case_model, _case_roi, _case_resnet],
                  inp, str(d / "ranks"))
    return inp, group


@pytest.fixture
def tiny_spec(monkeypatch):
    from acmil_tpu_torch.models.encoders import build

    for key in TRUNKS:
        monkeypatch.setitem(build.ENCODER_SPECS, key,
                            build.ENCODER_SPECS[key])
    _tiny_spec()


def _one_process(inp, out, *extra, key=DATA_KEY):
    from acmil_tpu_torch.cli import step2_extract

    return step2_extract.main(_args(inp, out, *extra, key=key))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_mesh_data_writes_the_one_process_file(step2_mesh, tiny_spec,
                                               tmp_path):
    inp, group = step2_mesh
    want_res = _one_process(inp, str(tmp_path))
    want = _read(want_res["out_path"])
    res = ranks(group, _case_data)
    got = _read(res[0]["out_path"])
    assert set(got) == set(want) == {"slide_a", "slide_b"}
    for name, (wf, wc, wl) in want.items():
        gf, gc, gl = got[name]
        assert gf.dtype == np.float16 and len(gf) % BATCH
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gc, wc)
        assert gl == wl
    for r in res:
        assert r["first"] == want_res["slides"]
        assert r["again"] == {}          # rank 0's file holds every slide
    # one writer: rank 1's result names the same file and wrote no other
    assert res[1]["out_path"] == res[0]["out_path"]
    assert os.listdir(os.path.dirname(res[0]["out_path"])) == [
        os.path.basename(res[0]["out_path"])]


def test_mesh_model_writes_the_one_process_file(step2_mesh, tiny_spec,
                                                tmp_path):
    inp, group = step2_mesh
    want = _read(_one_process(inp, str(tmp_path), "--out_format", "pt",
                              key=MODEL_KEY)["out_path"])
    res = ranks(group, _case_model)
    got = _read(res[0]["out_path"])
    assert set(got) == set(want)
    for name, (wf, wc, wl) in want.items():
        gf, gc, gl = got[name]
        assert gf.shape == wf.shape and gf.dtype == np.float16
        np.testing.assert_array_equal(gc, wc)
        assert gl == wl
        wf32 = wf.astype(np.float32)
        err = np.abs(gf.astype(np.float32) - wf32).max()
        # one fp16 step of the largest feature, plus the f32 reordering
        assert err <= 2.0 ** -11 * np.abs(wf32).max() + MODEL_TOL, err
    assert res[0]["slides"] == res[1]["slides"] == {
        k: len(v[0]) for k, v in want.items()}


def test_roi_dir_runs_on_rank_zero_alone(step2_mesh, tiny_spec, tmp_path):
    inp, group = step2_mesh
    from acmil_tpu_torch.cli import step2_extract

    want = step2_extract.main(["--roi_dir", inp["roi"], "--output_dir",
                               str(tmp_path), "--pretrain", "medical_ssl",
                               "--backbone", "ViT-S/16", "--pretrain_weights",
                               inp["weights"]["medical_ssl"], "--device",
                               "cpu"])
    res = ranks(group, _case_roi)
    np.testing.assert_array_equal(res[0]["centroids"], want["centroids"])
    np.testing.assert_array_equal(
        np.load(os.path.join(inp["root"], "roi0", "roi_feats.npy")),
        want["centroids"])
    assert res[1]["centroids"] is None
    assert not os.path.exists(os.path.join(inp["root"], "roi1"))


def test_mesh_model_refuses_a_resnet(step2_mesh):
    _, group = step2_mesh
    for r in ranks(group, _case_resnet):
        assert r["raised"] and "ViT trunks only" in r["raised"] \
            and "--mesh_data" in r["raised"]


def test_mesh_needs_a_torchrun_world(step2_mesh, tiny_spec, tmp_path):
    # one process asking for two: make_mesh names the launch
    inp, _ = step2_mesh
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        _one_process(inp, str(tmp_path), "--mesh_data", "2")
