"""The port's ViT encoders (acmil_tpu_torch/models/encoders) against the JAX
package's: the plain module against flax, ``vit_encode``'s three routes
against JAX's ``vit_encode`` (Pallas kernels in interpret mode), the weight
converters, and the Step2 feature closure. Tiny trunks, CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.models.encoders import build as jax_build
from acmil_tpu.models.encoders import convert as jax_convert
from acmil_tpu.models.encoders.fast import vit_encode as jax_vit_encode
from acmil_tpu.models.encoders.vit import ViT as JaxViT
from acmil_tpu_torch.models.convert import from_jax_params
from acmil_tpu_torch.models.encoders import build
from acmil_tpu_torch.models.encoders import convert
from acmil_tpu_torch.models.encoders.fast import vit_encode
from acmil_tpu_torch.models.encoders.vit import ViT

# f32 on both sides, as in the JAX package's own test of vit_encode against
# the module: sums in another order through two layers of LN, softmax and
# four products, on cls features of magnitude ~1
F32_TOL = 2e-3
# the vit_encode cases at tiny dims (tests/test_vit_fused.py:92-100,
# 201-221): the whole-layer route (B3), and the attention half (B4) with
# layerscale, with CLIP's pre-norm, quick gelu and projection, and with
# SwiGLU and layerscale; at these dims every trunk fits attn_half_fits, so
# the packed route (B5') has its own test below
TRUNKS = {
    "vits": dict(patch=16, dim=64, depth=2, heads=2, img_size=32),
    "uni": dict(patch=16, dim=96, depth=2, heads=4, layerscale=True,
                img_size=32),
    "clip": dict(patch=16, dim=96, depth=2, heads=4, img_size=32,
                 proj_dim=48, pre_norm=True, act="quick_gelu"),
    "giga": dict(patch=16, dim=96, depth=2, heads=4, mlp_ratio=16.0 / 3.0,
                 act="swiglu", layerscale=True, img_size=32),
}


def _flax(case, seed=0, b=2):
    m = JaxViT(**TRUNKS[case])
    rs = np.random.RandomState(seed)
    x = rs.randn(b, m.img_size, m.img_size, 3).astype(np.float32)
    params = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    if "ls1" in params["block0"]:
        # layerscale inits at 1e-5, which would hide the attention and MLP
        # halves from the comparison
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: (jnp.asarray(rs.rand(*v.shape) * 0.5 + 0.25,
                                      jnp.float32)
                          if getattr(p[-1], "key", "").startswith("ls") else v),
            params)
    return m, params, x


def _encode_kw(m, dtype):
    return dict(patch=m.patch, depth=m.depth, heads=m.heads, dtype=dtype,
                act=m.act, pre_norm=m.pre_norm, proj_dim=m.proj_dim)


@pytest.mark.parametrize("case", sorted(TRUNKS))
@pytest.mark.parametrize("attn_impl", ["einsum", "fused"])
def test_module_matches_flax(case, attn_impl):
    m, params, x = _flax(case)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    tm = ViT(**TRUNKS[case], attn_impl=attn_impl)
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "vit"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, tm.embed_dim)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(TRUNKS))
def test_vit_encode_matches_jax(case):
    m, params, x = _flax(case, seed=1)
    want = np.asarray(jax_vit_encode(params, jnp.asarray(x),
                                     **_encode_kw(m, jnp.float32)))
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "vit")
    got = vit_encode(sd, torch.from_numpy(x), **_encode_kw(m, torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    plain = vit_encode(sd, torch.from_numpy(x), **_encode_kw(m, torch.float32),
                       fused=False)
    torch.testing.assert_close(plain, got, atol=0, rtol=0)


def test_vit_encode_packed_route_matches_jax(monkeypatch):
    # at tiny dims every trunk fits attn_half_fits, so the packed route
    # (B5' inside _xla_attn_half) is reached in both packages by turning
    # that predicate off; CLIP's pre-norm, quick gelu and projection
    from acmil_tpu.models.encoders import fast as jax_fast
    from acmil_tpu_torch.models.encoders import fast

    for mod in (jax_fast, fast):
        monkeypatch.setattr(mod, "attn_half_fits", lambda *a, **k: False)
    m, params, x = _flax("clip", seed=3)
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "vit")
    assert fast.vit_route(sd, 5, m.heads, torch.float32, m.act) == "packed"
    want = np.asarray(jax_vit_encode(params, jnp.asarray(x),
                                     **_encode_kw(m, jnp.float32)))
    got = vit_encode(sd, torch.from_numpy(x), **_encode_kw(m, torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case, route, cast", [
    ("vits", "layer", {"attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"}),
    ("uni", "half", {"attn.qkv", "attn.proj"}),
])
def test_cast_kernel_weights_leaves_vit_encode_unchanged(case, route, cast):
    # the chains cast these matrices to x's dtype on every call, so casting
    # them once gives the same bf16 features, bit for bit
    from acmil_tpu_torch.models.encoders.fast import (cast_kernel_weights,
                                                      vit_route)

    m, params, x = _flax(case, seed=4)
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "vit")
    assert vit_route(sd, 5, m.heads, torch.bfloat16, m.act) == route
    cast_sd = cast_kernel_weights(sd, n_tok=5, heads=m.heads,
                                  dtype=torch.bfloat16, act=m.act)
    assert {k for k, v in cast_sd.items() if v.dtype == torch.bfloat16} == {
        f"blocks.{i}.{name}.weight" for i in range(m.depth) for name in cast}
    xb = torch.from_numpy(x).bfloat16()
    kw = _encode_kw(m, torch.bfloat16)
    torch.testing.assert_close(vit_encode(cast_sd, xb, **kw),
                               vit_encode(sd, xb, **kw), atol=0, rtol=0)


def _cosine(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1) + 1e-9)


@pytest.mark.parametrize("case", ["vits", "uni"])
def test_vit_encode_bf16_tracks_the_f32_module(case):
    # as tests/test_vit_fused.py:224-237: the bf16 path (approx gelu in the
    # MLP, bf16 activations) keeps the cls features' direction
    m, params, x = _flax(case, seed=2, b=4)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "vit")
    got = vit_encode(sd, torch.from_numpy(x).bfloat16(),
                     **_encode_kw(m, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    cos = _cosine(want, got.float().numpy())
    assert cos.min() >= 0.999, cos


def test_timm_state_dict_round_trips_through_flax():
    torch.manual_seed(0)
    tm = ViT(**TRUNKS["giga"])
    sd = {f"module.{k}": v for k, v in tm.state_dict().items()}
    sd["head.weight"] = torch.zeros(2, 96)            # dropped
    flax_tree = jax_convert.convert_vit(sd, depth=2)
    back = from_jax_params(flax_tree, "vit")
    mine = convert.vit_state_dict(sd, depth=2)
    assert set(back) == set(mine) == set(tm.state_dict())
    for k in mine:
        torch.testing.assert_close(back[k], mine[k], atol=0, rtol=0)
        torch.testing.assert_close(mine[k], tm.state_dict()[k], atol=0,
                                   rtol=0)


def _clip_state_dict(rs, dim=96, depth=2, n_tok=5, proj=48, patch=16):
    r = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    sd = {"visual.conv1.weight": r(dim, 3, patch, patch),
          "visual.class_embedding": r(dim),
          "visual.positional_embedding": r(n_tok, dim),
          "visual.ln_pre.weight": r(dim), "visual.ln_pre.bias": r(dim),
          "visual.ln_post.weight": r(dim), "visual.ln_post.bias": r(dim),
          "visual.proj": r(dim, proj), "text.token_embedding": r(3, 4)}
    for i in range(depth):
        b = f"visual.transformer.resblocks.{i}"
        sd.update({f"{b}.ln_1.weight": r(dim), f"{b}.ln_1.bias": r(dim),
                   f"{b}.ln_2.weight": r(dim), f"{b}.ln_2.bias": r(dim),
                   f"{b}.attn.in_proj_weight": r(3 * dim, dim),
                   f"{b}.attn.in_proj_bias": r(3 * dim),
                   f"{b}.attn.out_proj.weight": r(dim, dim),
                   f"{b}.attn.out_proj.bias": r(dim),
                   f"{b}.mlp.c_fc.weight": r(4 * dim, dim),
                   f"{b}.mlp.c_fc.bias": r(4 * dim),
                   f"{b}.mlp.c_proj.weight": r(dim, 4 * dim),
                   f"{b}.mlp.c_proj.bias": r(dim)})
    return sd


def test_clip_state_dict_matches_the_jax_converter():
    sd = _clip_state_dict(np.random.RandomState(3))
    want = from_jax_params(jax_convert.convert_clip_vit(sd, depth=2), "vit")
    got = convert.convert_clip_vit(sd, depth=2)
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    tm = ViT(**TRUNKS["clip"])
    tm.load_state_dict(got)                         # every key, no extras


def test_build_encoder_loads_a_timm_checkpoint(tmp_path):
    torch.manual_seed(1)
    src = ViT(16, 384, 12, 6)
    path = str(tmp_path / "vits.pth")
    torch.save({"model": src.state_dict()}, path)

    class C:
        pretrain, backbone, n_class = "tailored_sl", "anything", 2
        pretrain_weights = path

    model, spec, state = build.build_encoder(C())
    assert spec is build.ENCODER_SPECS[("medical_ssl", "ViT-S/16")]
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.encoder.state_dict()[k], v)
    assert model.encoder.blocks[0].attn.attn_impl == "fused"


@pytest.mark.parametrize("backbone", ["Resnet50", "resnet18"])
def test_resnet_rows_are_listed_and_raise(backbone):
    # the ResNet rows build now (the name is kept): the JAX rows' trunk
    # width and the spec's, a seeded random encoder, no state without weights
    class C:
        pretrain, n_class, pretrain_weights = "natural_supervised", 2, ""

    C.backbone = backbone
    assert set(build.ENCODER_SPECS) == set(jax_build.ENCODER_SPECS)
    assert build.PRETRAIN_ONLY == jax_build.PRETRAIN_ONLY
    with pytest.warns(UserWarning, match="random initialisation"):
        model, spec, state = build.build_encoder(C())
    want = jax_build.ENCODER_SPECS[("natural_supervised", backbone)]
    assert spec.embed_dim == want.embed_dim == model.encoder.embed_dim
    assert model.encoder.stage_sizes == want.builder(jnp.float32).stage_sizes
    assert model.encoder.dtype == torch.bfloat16 and state is None


def test_preprocess_matches_jax():
    rs = np.random.RandomState(4)
    u8 = rs.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    for key in (("medical_ssl", "ViT-S/16"), ("path-clip-L-336", "ViT-L/336")):
        want = np.asarray(jax_build.preprocess(
            jnp.asarray(u8), jax_build.ENCODER_SPECS[key], jnp.float32))
        got = build.preprocess(torch.from_numpy(u8), build.ENCODER_SPECS[key],
                               torch.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_encoder_feature_fn_matches_jax():
    """uint8 NHWC on the host → fp16 features, both packages, the same
    weights; f32 compute, so the two agree to fp16 rounding."""
    m, params, _ = _flax("vits", seed=5)
    spec_j = jax_build.EncoderSpec(
        lambda dt: JaxViT(**TRUNKS["vits"], dtype=dt), 64, 32,
        jax_build.HALF_MEAN, jax_build.HALF_STD, "vit", depth=2)
    spec_t = build.EncoderSpec(
        lambda dt: ViT(**TRUNKS["vits"], dtype=dt), 64, 32,
        build.HALF_MEAN, build.HALF_STD, "vit", depth=2)
    jmodel = jax_build.CustomModel(encoder=spec_j.builder(jnp.float32),
                                   n_class=2)
    u8 = np.random.RandomState(6).randint(0, 256, (3, 32, 32, 3)).astype(
        np.uint8)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = {"params": {**variables["params"], "encoder": params}}
    want = np.asarray(jax_build.encoder_feature_fn(jmodel, variables,
                                                   spec_j)(u8))
    tmodel = build.CustomModel(spec_t.builder(torch.float32), 2)
    tmodel.encoder.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), "vit"))
    fn = build.encoder_feature_fn(tmodel, spec_t, torch.device("cpu"))
    got = fn(u8)
    assert got.dtype == torch.float16 and got.shape == (3, 64)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=2e-3, rtol=2e-3)
    plain = build.encoder_feature_fn(tmodel, spec_t, torch.device("cpu"),
                                     fused=False)(u8)
    torch.testing.assert_close(plain, got, atol=0, rtol=0)
