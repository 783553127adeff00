"""Megatron tensor parallelism of Step2's ViT trunks
(acmil_tpu_torch/parallel/tp.py) on the CPU, over spawned ``gloo`` ranks.

The trunks are tests/test_tp_encoder.py's three variants (plain gelu,
SwiGLU with layerscale, CLIP's pre-norm, quick gelu and projection). Their
weights are numpy-seeded checkpoints (timm names; open_clip names for
CLIP), converted on each side by its own converter. The slices of
``shard_vit_params_tp`` are held against the JAX ``_slice_block``; the TP
forward at (data 1, model 2), (data 1, model 4) and (data 2, model 2)
against JAX ``make_tp_vit_forward`` on the virtual CPU mesh of
tests/conftest.py and against the port's one-process ``vit_encode``.

Ranks import this module: JAX is imported inside the functions that need
it, never at module level.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_ranks import ranks, spawn

# f32 on every side: only the order of the sums differs (the model group's
# all-reduces add the heads' and hidden slices' partial products)
TOL = 1e-5
VARIANTS = {
    "plain": dict(patch=4, dim=32, depth=2, heads=8, img_size=16),
    "swiglu_ls": dict(patch=4, dim=48, depth=2, heads=8, img_size=16,
                      mlp_ratio=16.0 / 3.0, act="swiglu", layerscale=True),
    "clip": dict(patch=4, dim=32, depth=2, heads=8, img_size=16,
                 proj_dim=24, pre_norm=True, act="quick_gelu"),
}
# (data, model) meshes and the world each runs in
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
BATCH = 5                       # does not divide the data axis of 2
# the feature closures' variant: one whose one-process route (B4's, then
# the plain MLP half) computes the TP block's function at f32
FEATURE_VARIANT = "swiglu_ls"


def _checkpoint(name: str) -> dict:
    """A numpy-seeded checkpoint of the variant: timm names, or open_clip's
    visual tower for CLIP."""
    from acmil_tpu_torch.models.encoders.vit import ViT

    rs = np.random.RandomState(sorted(VARIANTS).index(name))
    kw = VARIANTS[name]

    def r(*shape, scale=0.2, base=0.0):
        return torch.from_numpy(
            (base + scale * rs.randn(*shape)).astype(np.float32))

    if name == "clip":
        dim, p = kw["dim"], kw["patch"]
        n_tok = (kw["img_size"] // p) ** 2 + 1
        sd = {"visual.conv1.weight": r(dim, 3, p, p),
              "visual.class_embedding": r(dim),
              "visual.positional_embedding": r(n_tok, dim),
              "visual.ln_pre.weight": r(dim, base=1.0),
              "visual.ln_pre.bias": r(dim),
              "visual.ln_post.weight": r(dim, base=1.0),
              "visual.ln_post.bias": r(dim),
              "visual.proj": r(dim, kw["proj_dim"])}
        for i in range(kw["depth"]):
            b = f"visual.transformer.resblocks.{i}"
            sd.update({f"{b}.ln_1.weight": r(dim, base=1.0),
                       f"{b}.ln_1.bias": r(dim),
                       f"{b}.ln_2.weight": r(dim, base=1.0),
                       f"{b}.ln_2.bias": r(dim),
                       f"{b}.attn.in_proj_weight": r(3 * dim, dim),
                       f"{b}.attn.in_proj_bias": r(3 * dim),
                       f"{b}.attn.out_proj.weight": r(dim, dim),
                       f"{b}.attn.out_proj.bias": r(dim),
                       f"{b}.mlp.c_fc.weight": r(4 * dim, dim),
                       f"{b}.mlp.c_fc.bias": r(4 * dim),
                       f"{b}.mlp.c_proj.weight": r(dim, 4 * dim),
                       f"{b}.mlp.c_proj.bias": r(dim)})
        return sd
    shapes = ViT(**kw).state_dict()
    return {k: r(*v.shape, base=1.0 if k.endswith(("norm1.weight",
                                                     "norm2.weight",
                                                     "norm.weight"))
                 else 0.0) for k, v in shapes.items()}


def _port_params(name: str) -> dict:
    from acmil_tpu_torch.models.encoders import convert

    sd = _checkpoint(name)
    depth = VARIANTS[name]["depth"]
    if name == "clip":
        return convert.convert_clip_vit(sd, depth=depth)
    return convert.vit_state_dict(sd, depth=depth)


def _images(b=BATCH):
    rs = np.random.RandomState(11)
    x = rs.randn(b, 16, 16, 3).astype(np.float32)
    u8 = rs.randint(0, 256, (b, 16, 16, 3)).astype(np.uint8)
    return x, u8


def split_batch(images: np.ndarray, mesh) -> np.ndarray:
    """This rank's block of a whole batch, picked by the rule the Step2
    reader takes (``patch_dataset.shard_rows``), zero rows past its end."""
    from acmil_tpu_torch.data.patch_dataset import shard_rows

    pick, rows = shard_rows(len(images), mesh.data_index, mesh.data)
    out = np.zeros((rows,) + images.shape[1:], images.dtype)
    part = images[pick]
    out[:len(part)] = part
    return out


def _kw(name: str) -> dict:
    kw = VARIANTS[name]
    return dict(patch=kw["patch"], depth=kw["depth"],
                act=kw.get("act", "gelu"), pre_norm=kw.get("pre_norm", False),
                proj_dim=kw.get("proj_dim"), dtype=torch.float32)


def _tp_model(name: str):
    """The variant as a CustomModel with its spec, for the feature
    closures."""
    from acmil_tpu_torch.models.encoders import build
    from acmil_tpu_torch.models.encoders.vit import ViT

    enc = ViT(**VARIANTS[name], dtype=torch.float32)
    enc.load_state_dict(_port_params(name))
    spec = build.EncoderSpec(lambda dt: enc, enc.embed_dim, 16,
                             build.HALF_MEAN, build.HALF_STD, "vit", depth=2)
    return build.CustomModel(enc, 2), spec


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _case_forward(inp):
    """Every variant's TP forward on each mesh this world holds: this
    rank's block of the batch through ``_tp_vit_local``, gathered."""
    import torch.distributed as dist

    from acmil_tpu_torch.models.encoders.build import gather_rows
    from acmil_tpu_torch.parallel import make_mesh
    from acmil_tpu_torch.parallel.tp import (_tp_vit_local,
                                             shard_vit_params_tp)

    out = {}
    x = inp["x"]
    for data, model in MESHES[dist.get_world_size()]:
        mesh = make_mesh(data, 1, model=model)
        for name in sorted(VARIANTS):
            local = shard_vit_params_tp(
                _port_params(name), heads=VARIANTS[name]["heads"], tp=model,
                index=mesh.model_index, act=VARIANTS[name].get("act", "gelu"))
            with torch.no_grad():
                f = _tp_vit_local(
                    local, torch.from_numpy(split_batch(x, mesh)),
                    heads_local=VARIANTS[name]["heads"] // model,
                    group=mesh.model_group, **_kw(name))
                out[(name, data, model)] = gather_rows(f, mesh)[:len(x)].numpy()
        out[("layout", data, model)] = (mesh.data_index, mesh.model_index,
                                        mesh.world)
    return out


def _case_feature_fn(inp):
    """uint8 → fp16 through ``tp_encoder_feature_fn`` at (data 2, model
    2)."""
    from acmil_tpu_torch.parallel import make_mesh
    from acmil_tpu_torch.parallel.tp import tp_encoder_feature_fn

    mesh = make_mesh(2, 1, model=2)
    model, spec = _tp_model(FEATURE_VARIANT)
    fn = tp_encoder_feature_fn(model, spec, mesh, torch.device("cpu"))
    u8 = inp["u8"]
    return fn(split_batch(u8, mesh))[:len(u8)].numpy()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    x, u8 = _images()
    inputs = {"x": x, "u8": u8}
    return {
        2: spawn(2, [_case_forward], inputs,
                 str(tmp_path_factory.mktemp("tp2"))),
        4: spawn(4, [_case_forward, _case_feature_fn], inputs,
                 str(tmp_path_factory.mktemp("tp4"))),
    }


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _flax_params(name: str):
    from acmil_tpu.models.encoders import convert as jax_convert

    sd = _checkpoint(name)
    depth = VARIANTS[name]["depth"]
    if name == "clip":
        return jax_convert.convert_clip_vit(sd, depth=depth)
    return jax_convert.convert_vit(sd, depth=depth)


def _jax_tp_forward(name: str, data: int, model: int, x: np.ndarray):
    import jax.numpy as jnp

    from acmil_tpu.parallel.tp import (make_tp_mesh, make_tp_vit_forward,
                                       shard_vit_params_tp)

    kw = VARIANTS[name]
    mesh = make_tp_mesh(data=data, model=model)
    stacked, specs = shard_vit_params_tp(
        _flax_params(name), heads=kw["heads"], tp=model,
        act=kw.get("act", "gelu"), mesh=mesh)
    fwd = make_tp_vit_forward(
        mesh, specs, patch=kw["patch"], depth=kw["depth"], heads=kw["heads"],
        act=kw.get("act", "gelu"), pre_norm=kw.get("pre_norm", False),
        proj_dim=kw.get("proj_dim"), dtype=jnp.float32)
    b = len(x)
    pad = np.zeros((-(-b // data) * data - b,) + x.shape[1:], x.dtype)
    return np.asarray(fwd(stacked, jnp.asarray(np.concatenate([x, pad]))))[:b]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_shard_slices_match_the_jax_slice_block(name):
    from acmil_tpu.parallel.tp import _slice_block as jax_slice
    from acmil_tpu_torch.models.encoders.fast import block_weights
    from acmil_tpu_torch.parallel.tp import _slice_block, shard_vit_params_tp

    kw = VARIANTS[name]
    act, heads = kw.get("act", "gelu"), kw["heads"]
    port, flax = _port_params(name), _flax_params(name)
    pairs = {"attn.qkv.weight": ("attn", "qkv", "kernel"),
             "attn.qkv.bias": ("attn", "qkv", "bias"),
             "attn.proj.weight": ("attn", "proj", "kernel"),
             "mlp.fc1.weight": ("mlp", "Dense_0", "kernel"),
             "mlp.fc1.bias": ("mlp", "Dense_0", "bias"),
             "mlp.fc2.weight": ("mlp", "Dense_1", "kernel")}
    for tp in (2, 4, 8):
        for i in range(kw["depth"]):
            want = jax_slice(flax[f"block{i}"], heads, tp, act)
            for m in range(tp):
                got = _slice_block(block_weights(port, i), heads, tp, m, act)
                for key, (a, b, c) in pairs.items():
                    w = np.asarray(want[a][b][c][m])
                    np.testing.assert_array_equal(
                        got[key].numpy(), w.T if w.ndim == 2 else w,
                        err_msg=f"{name} tp={tp} block {i} rank {m} {key}")
                # replicated entries are the whole ones
                for key in ("norm1.weight", "attn.proj.bias",
                            "mlp.fc2.bias"):
                    np.testing.assert_array_equal(
                        got[key].numpy(), block_weights(port, i)[key].numpy())
        local = shard_vit_params_tp(port, heads=heads, tp=tp, index=tp - 1,
                                    act=act)
        assert set(local) == set(port)
        assert local["blocks.1.attn.qkv.weight"].shape == (
            3 * kw["dim"] // tp, kw["dim"])


@pytest.mark.parametrize("data, model", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_tp_forward_matches_jax_and_one_process(worlds, name, data, model):
    from acmil_tpu_torch.models.encoders.fast import vit_encode, vit_route

    x, _ = _images()
    world = data * model
    got = [r[(name, data, model)] for r in ranks(worlds[world],
                                                 _case_forward)]
    kw = VARIANTS[name]
    want = _jax_tp_forward(name, data, model, x)
    model_, _ = _tp_model(name)
    with torch.no_grad():
        module = model_.encoder(torch.from_numpy(x)).numpy()
    assert got[0].shape == want.shape == module.shape
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g, got[0], err_msg=f"rank {r}")
    assert _rel(got[0], want) <= TOL, _rel(got[0], want)
    # the one-process port: its module forward, and vit_encode where its
    # route computes the same function. The plain variant's route is B3's,
    # whose gelu is tanh-approximate at every dtype (as the Pallas layer
    # kernel's), so there vit_encode is another function
    assert _rel(got[0], module) <= TOL, _rel(got[0], module)
    params = _port_params(name)
    n_tok = (kw["img_size"] // kw["patch"]) ** 2 + 1
    if vit_route(params, n_tok, kw["heads"], torch.float32,
                 kw.get("act", "gelu")) != "layer":
        one = vit_encode(params, torch.from_numpy(x), heads=kw["heads"],
                         fused=False, **_kw(name)).numpy()
        assert _rel(got[0], one) <= TOL, _rel(got[0], one)
    else:
        assert name == "plain"


def test_mesh_puts_model_innermost(worlds):
    for world, meshes in MESHES.items():
        res = ranks(worlds[world], _case_forward)
        for data, model in meshes:
            for rank, r in enumerate(res):
                assert r[("layout", data, model)] == (rank // model,
                                                      rank % model, world)


def test_tp_feature_fn_matches_the_one_process_closure(worlds):
    from acmil_tpu_torch.models.encoders.build import encoder_feature_fn

    _, u8 = _images()
    model, spec = _tp_model(FEATURE_VARIANT)
    want = encoder_feature_fn(model, spec, torch.device("cpu"),
                              fused=False)(u8).numpy()
    for got in ranks(worlds[4], _case_feature_fn):
        assert got.dtype == np.float16 and got.shape == want.shape
        # f32 in both, then one fp16 rounding, which a reordered sum can
        # move by one fp16 step
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=2 ** -10,
                                   atol=2 ** -10 * np.abs(want).max())


def test_tp_rejects_indivisible_heads():
    from acmil_tpu_torch.parallel.tp import shard_vit_params_tp

    params = _port_params("plain")
    with pytest.raises(ValueError, match="divisible"):
        shard_vit_params_tp(params, heads=8, tp=3, index=0)


def test_tp_rejects_resnet():
    from acmil_tpu_torch.models.encoders import build
    from acmil_tpu_torch.models.encoders.resnet import resnet18
    from acmil_tpu_torch.parallel import Mesh
    from acmil_tpu_torch.parallel.tp import tp_encoder_feature_fn

    enc = resnet18(torch.float32)
    model = build.CustomModel(enc, 2)
    spec = build.EncoderSpec(lambda dt: enc, 512, 16, build.HALF_MEAN,
                             build.HALF_STD, "resnet")
    mesh = Mesh(1, 1, 0, torch.device("cpu"), model=2)
    with pytest.raises(ValueError, match="ViT trunks only.*--mesh_data"):
        tp_encoder_feature_fn(model, spec, mesh, torch.device("cpu"))
