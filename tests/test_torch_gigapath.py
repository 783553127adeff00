"""Prov-GigaPath's tile encoder (DINOv2 ViT-g/16: SwiGLU-packed MLP, layer
scale, 1536 wide) in the port: Step2's closure against the benchmark's
plain reference (``benchmark/reference/vit_swiglu.py``) on seeded random
weights, the SwiGLU epilogue's row interleave as plain torch, the trunk's
published widths, and, on the card (``gpu``), the SwiGLU epilogue and
route 3's attention half on the f32 GEMM's bf16-A mode. The file imports
no JAX, so it runs on the card's machine."""

import importlib.util
import math
import os
import sys

import numpy as np
import pytest
import torch

from acmil_tpu_torch.models.encoders import fast
from acmil_tpu_torch.models.encoders.build import (ENCODER_SPECS,
                                                   CustomModel, EncoderSpec,
                                                   IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   encoder_feature_fn)
from acmil_tpu_torch.models.encoders.vit import ViT, mlp_act
from acmil_tpu_torch.ops import vit_layer as port

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")

# f32 trunk against the f32 reference: the same function, the order of f32
# sums apart (the patch embed a convolution here, a product there); ~1e-6
# of a feature, amplified a little by the LayerNorms' 1/sigma
F32_GAP = 1e-5
# bf16 trunk against the f32 reference: the port rounds LN's rows, qkv, p,
# o, the SwiGLU output and the residual stream to bf16 (2**-9 of each, a
# few times a block, over two blocks, then the final LayerNorm's 1/sigma);
# 2**-5 of a feature, still below what an fp8 reference gives (checked)
BF16_GAP = 2.0 ** -5


def _reference():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    path = os.path.join(BENCH, "reference", "vit_swiglu.py")
    spec = importlib.util.spec_from_file_location("ref_vit_swiglu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded(vit: ViT, seed: int) -> dict:
    """Seeded random f32 weights by timm name: matrices N(0, 1/fan_in),
    LayerNorm scales 1 + N(0, 0.1^2), layer scales 0.5 + N(0, 0.1^2) (a
    trained trunk's, not the 1e-5 start), the rest N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in vit.state_dict().items():
        z = torch.randn(t.shape, generator=gen)
        if name.endswith(".gamma"):
            out[name] = 0.5 + 0.1 * z
        elif name.endswith("weight") and "norm" in name:
            out[name] = 1.0 + 0.1 * z
        elif name.endswith("weight"):
            out[name] = z / math.sqrt(t[0].numel())
        else:
            out[name] = 0.02 * z
    return out


# (dim, heads, mlp_ratio, route): dh 64 both; fc1's packed width 512 and
# 256 (fc2 from 256 and 128: K % 32); 128 wide on route 2 (B4), GigaPath's
# own 1536 on route 3 (outside attn_half_fits, as the trunk is)
TRUNKS = [(128, 2, 4.0, "half"), (1536, 24, 1.0 / 6.0, "packed")]


def _trunk(dim, heads, mlp_ratio, dtype):
    torch.manual_seed(0)
    vit = ViT(patch=16, dim=dim, depth=2, heads=heads, img_size=32,
              mlp_ratio=mlp_ratio, act="swiglu", layerscale=True, dtype=dtype)
    vit.load_state_dict(_seeded(vit, 1))
    return vit


@pytest.mark.parametrize("dim, heads, mlp_ratio, route", TRUNKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_step2_closure_matches_the_plain_reference(dim, heads, mlp_ratio,
                                                   route, dtype):
    # Step2's closure (encoder_feature_fn -> vit_encode, the fused MLP
    # route at bf16) on a small GigaPath-shaped trunk against the
    # benchmark's f32 reference on the same weights and pixels
    vit = _trunk(dim, heads, mlp_ratio, dtype)
    sd = {k: v.detach() for k, v in vit.state_dict().items()}
    assert fast.vit_route(sd, 5, heads, dtype, "swiglu") == route
    assert fast.mlp_route(fast.block_weights(sd, 0), dtype, "swiglu") == (
        "fused" if dtype == torch.bfloat16 else "plain")
    spec = EncoderSpec(None, dim, 32, IMAGENET_MEAN, IMAGENET_STD, "vit",
                       depth=2)
    pix = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3),
                                            dtype=np.uint8)
    got = encoder_feature_fn(CustomModel(vit, 2), spec, torch.device("cpu"),
                             out_dtype=torch.float32)(pix)
    trunk = dict(patch=16, dim=dim, heads=heads, depth=2, ln_eps=1e-6,
                 mean=list(IMAGENET_MEAN), std=list(IMAGENET_STD))
    ref = _reference()
    want = ref.features(sd, torch.from_numpy(pix), trunk, "f32", block=2)
    gap = float(((got - want).norm(dim=1) / want.norm(dim=1)).max())
    bar = BF16_GAP if dtype == torch.bfloat16 else F32_GAP
    assert gap <= bar, gap
    if dtype == torch.bfloat16:
        # the bar refuses the reference one precision below (fp8 products)
        low = ref.features(sd, torch.from_numpy(pix), trunk, "fp8", block=2)
        assert float(((low - want).norm(dim=1)
                      / want.norm(dim=1)).max()) > bar


def _swiglu_weights(n, k, seed=3):
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    return f(n, k) / math.sqrt(k), 0.1 * f(n)


def test_swiglu_order_is_the_tiles_of_gate_then_value_rows():
    order = port.swiglu_order(512)
    assert sorted(order.tolist()) == list(range(512))
    # tile t: gate rows 64 t .. 64 t + 63, then value rows 256 + 64 t ..
    for t in range(4):
        tile = order[128 * t:128 * (t + 1)].tolist()
        assert tile == list(range(64 * t, 64 * t + 64)) + list(
            range(256 + 64 * t, 256 + 64 * t + 64))


def test_interleaved_fc1_gives_the_plain_swiglu_half():
    # fc1's products on the rows as the split kernel gathers them, through
    # the SwiGLU epilogue's plain version, are silu(gate) * value of the
    # products on W as given
    w, b = _swiglu_weights(1024, 96)
    y = torch.from_numpy(np.random.RandomState(4).randn(37, 96).astype(
        np.float32)).bfloat16()
    got = port._swiglu_tiles(port._dot(y, w[port.swiglu_order(1024)].t()), b)
    want = mlp_act(port._dot(y, w.t()) + b, "swiglu")
    assert got.shape == (37, 512)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("change, match", [
    (dict(n=1000), "N % 128 == 0"),
    (dict(a_dtype=torch.float32), "bfloat16 A"),
    (dict(res=True), "no residual"),
    (dict(epilogue=5), "no GEMM epilogue"),
])
def test_gemm_rejects_a_swiglu_call_the_kernel_does_not_take(change, match):
    n = change.get("n", 256)
    a = torch.zeros(16, 64, dtype=change.get("a_dtype", torch.bfloat16))
    res = torch.zeros(16, n, dtype=torch.bfloat16) if "res" in change else None
    with pytest.raises(ValueError, match=match):
        port._gemm(a, torch.zeros(n, 64), torch.zeros(n),
                   change.get("epilogue", port.EPI_BIAS_SWIGLU),
                   out_dtype=torch.bfloat16, res=res)


def test_gigapath_spec_has_the_published_widths():
    # Prov-GigaPath (timm vit_giant_patch14_dinov2 at patch 16): 1536 wide,
    # 40 deep, 24 heads, fc1 to the packed 8192, fc2 from 4096, layer
    # scale, LayerNorm eps 1e-6, 1.13 B parameters
    spec = ENCODER_SPECS[("GigaPath", "ViT-G/16")]
    with torch.device("meta"):
        vit = spec.builder(torch.bfloat16)
    blk = vit.blocks[0]
    assert (vit.patch, vit.dim, vit.depth, vit.heads, vit.img_size) == (
        16, 1536, 40, 24, 224)
    assert len(vit.blocks) == 40 and spec.embed_dim == 1536
    assert (blk.mlp.fc1.in_features, blk.mlp.fc1.out_features) == (1536, 8192)
    assert (blk.mlp.fc2.in_features, blk.mlp.fc2.out_features) == (4096, 1536)
    assert vit.act == "swiglu" and blk.ls1.gamma.shape == (1536,)
    assert blk.norm1.eps == blk.norm2.eps == vit.norm.eps == 1e-6
    params = sum(p.numel() for p in vit.parameters())
    assert abs(params / 1e9 - 1.13) < 0.01, params


def _mlp_weights(d, fc1_out, ls2=True, seed=5):
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    w = {"norm2.weight": 1 + 0.1 * f(d), "norm2.bias": 0.1 * f(d),
         "mlp.fc1.weight": f(fc1_out, d) / math.sqrt(d),
         "mlp.fc1.bias": 0.05 * f(fc1_out),
         "mlp.fc2.weight": f(d, fc1_out // 2) / math.sqrt(fc1_out // 2),
         "mlp.fc2.bias": 0.05 * f(d)}
    if ls2:
        w["ls2.gamma"] = 0.25 + 0.5 * torch.from_numpy(
            rs.rand(d).astype(np.float32))
    return w


def test_fused_mlp_half_on_the_cpu_computes_the_blocks_swiglu():
    # on a CPU tensor a SwiGLU block's fused MLP half is
    # _mlp_half(..., "swiglu"), forward and backward (not gelu's)
    w = _mlp_weights(64, 256)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 9, 64).astype(
        np.float32)).bfloat16()
    want = fast._mlp_half(x, w, "swiglu")
    torch.testing.assert_close(fast.fused_mlp_half(x, w, "swiglu"), want,
                               atol=0, rtol=0)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [{k: v.clone().requires_grad_() for k, v in w.items()}
          for _ in range(2)]
    fast.fused_mlp_half(xs[0], ws[0], "swiglu").float().sum().backward()
    fast._mlp_half(xs[1], ws[1], "swiglu").float().sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, atol=0, rtol=0)
    for k in w:
        torch.testing.assert_close(ws[0][k].grad, ws[1][k].grad, atol=0,
                                   rtol=0, msg=k)


def test_fused_packed_attn_half_on_the_cpu_is_route_3s_plain_half():
    # on a CPU tensor route 3's fused attention half is _xla_attn_half
    # itself, forward and backward
    vit = _trunk(1536, 24, 1.0 / 6.0, torch.bfloat16)
    w = {k: v.detach() for k, v in fast.block_weights(
        vit.state_dict(), 0).items() if k.startswith(("norm1.", "attn.",
                                                      "ls1."))}
    assert fast.attn_route(w, torch.bfloat16) == "fused"
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 5, 1536).astype(
        np.float32)).bfloat16()
    xs = [x.clone().requires_grad_() for _ in range(2)]
    outs = [fast.fused_packed_attn_half(xs[0], w, 24),
            fast._xla_attn_half(xs[1], w, 24)]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    for x_, out in zip(xs, outs):
        out.float().sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, atol=0, rtol=0)


@pytest.mark.parametrize("dtype, mats, fused, route", [
    (torch.bfloat16, torch.float32, True, "fused"),
    (torch.bfloat16, torch.float32, False, "plain"),
    (torch.float16, torch.float32, True, "plain"),
    (torch.float32, torch.float32, True, "plain"),
    (torch.bfloat16, torch.bfloat16, True, "plain"),
])
def test_attn_route_takes_the_bf16a_gemm_only_for_bf16(dtype, mats, fused,
                                                       route):
    w = {"attn.qkv.weight": torch.zeros(3 * 1536, 1536, dtype=mats),
         "attn.proj.weight": torch.zeros(1536, 1536, dtype=mats)}
    assert fast.attn_route(w, dtype, fused) == route


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# bf16 out against the plain half on the same rounding points: only the
# order of the f32 sums differs, which may flip a bf16 rounding (of an LN
# row element, qkv, p, o or the SwiGLU output): two bf16 steps of each
# output and of the largest output
BF16_TOL = 2.0 ** -6
# the f32 GEMM's bar against float64 (tests/test_torch_gpu_gemm.py): twice
# full-f32 torch.matmul's error plus a few f32 steps of the largest output
F32_FLOOR = 2.0 ** -21


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the GEMM and B5' are CUDA C++ for sm_90a: needs an "
                    "NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol=BF16_TOL):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [788, 1000])
def test_swiglu_epilogue_at_gigapaths_fc1_against_float64(cuda_device, m):
    # fc1 at GigaPath's shape (K 1536, N 8192), M ragged, f32 out: the
    # SwiGLU of the kernel's products against SwiGLU of a float64 product,
    # at the f32 bar; the bias read as given at both halves
    w, b = (t.to(cuda_device) for t in _swiglu_weights(8192, 1536))
    a = torch.from_numpy(np.random.RandomState(8).randn(m, 1536).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    before = port._gemm.launches["bf16a"]
    with torch.no_grad():
        got = port._gemm(a, w, b, port.EPI_BIAS_SWIGLU,
                         out_dtype=torch.float32)
        torch.cuda.synchronize()
        lib = mlp_act(a.float() @ w.t() + b, "swiglu")
        exact = mlp_act(a.double() @ w.double().t() + b.double(), "swiglu")
    assert port._gemm.launches["bf16a"] == before + 1
    assert got.shape == (m, 4096)
    err = float((got.double() - exact).abs().max())
    lib_err = float((lib.double() - exact).abs().max())
    assert err <= 2 * lib_err + F32_FLOOR * float(exact.abs().max()), \
        (err, lib_err)
    bits = port._gemm(a, w, b, port.EPI_BIAS_SWIGLU,
                      out_dtype=torch.bfloat16)
    _close(bits, lib.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, ls2", [(2, 197, True), (3, 197, False)])
def test_fused_swiglu_mlp_half_matches_plain_on_card(cuda_device, b, n, ls2):
    # GigaPath's MLP half (fc1 8192 with the SwiGLU epilogue, fc2 from
    # 4096 with the layerscale residual) against _mlp_half(..., "swiglu")
    w = {k: v.to(cuda_device) for k, v in _mlp_weights(1536, 8192,
                                                       ls2).items()}
    x = torch.from_numpy(np.random.RandomState(9).randn(b, n, 1536).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    before = port._gemm.launches["bf16a"]
    with torch.no_grad():
        got = fast.fused_mlp_half(x, w, "swiglu")
        torch.cuda.synchronize()
        want = fast._mlp_half(x, w, "swiglu")
    assert port._gemm.launches["bf16a"] == before + 2
    _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, ls1", [
    (2, 197, 1536, 24, True),        # GigaPath
    (2, 577, 1024, 16, False),       # CLIP-L/336
])
def test_route_3_attention_half_matches_plain_on_card(cuda_device, b, n, d,
                                                      heads, ls1):
    # qkv (LN1 prologue, bf16 out) and proj (the ls1 residual) on the
    # bf16-A GEMM around B5', against route 3's plain products
    rs = np.random.RandomState(10)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        cuda_device)
    w = {"norm1.weight": 1 + 0.1 * f(d), "norm1.bias": 0.1 * f(d),
         "attn.qkv.weight": f(3 * d, d) / math.sqrt(d),
         "attn.qkv.bias": 0.05 * f(3 * d),
         "attn.proj.weight": f(d, d) / math.sqrt(d),
         "attn.proj.bias": 0.05 * f(d)}
    if ls1:
        w["ls1.gamma"] = 0.5 + 0.1 * f(d)
    x = f(b, n, d).to(torch.bfloat16)
    assert not port.attn_half_fits(d, (n + 15) // 16 * 16, heads)
    before = port._gemm.launches["bf16a"]
    with torch.no_grad():
        got = fast.fused_packed_attn_half(x, w, heads)
        torch.cuda.synchronize()
        want = fast._xla_attn_half(x, w, heads)
    assert port._gemm.launches["bf16a"] == before + 2
    _close(got, want)


@pytest.mark.gpu
def test_vit_encode_at_gigapath_widths_runs_every_product_on_the_gemm(
        cuda_device, monkeypatch):
    # GigaPath's widths at depth 2 through vit_encode (route 3): qkv, proj,
    # fc1 and fc2 of each block on the bf16-A GEMM (4 a block), none on a
    # plain product (_mm is not called), against fused=False
    torch.manual_seed(0)
    vit = ViT(patch=16, dim=1536, depth=2, heads=24, mlp_ratio=16 / 3,
              act="swiglu", layerscale=True)
    sd = {k: v.to(cuda_device) for k, v in _seeded(vit, 11).items()}
    n_tok = (vit.img_size // vit.patch) ** 2 + 1
    assert fast.vit_route(sd, n_tok, 24, torch.bfloat16, "swiglu") == \
        "packed"
    x = torch.randn(3, 224, 224, 3, generator=torch.Generator().manual_seed(
        12)).to(cuda_device)
    kw = dict(patch=16, depth=2, heads=24, act="swiglu")

    def no_plain_product(a, b):
        raise AssertionError("the fused route called a plain product")

    before = port._gemm.launches["bf16a"]
    with monkeypatch.context() as m:
        m.setattr(fast, "_mm", no_plain_product)
        m.setattr(port, "_mm", no_plain_product)
        with torch.no_grad():
            got = fast.vit_encode(sd, x, **kw)
            torch.cuda.synchronize()
    assert port._gemm.launches["bf16a"] == before + 4 * 2
    with torch.no_grad():
        want = fast.vit_encode(sd, x, **kw, fused=False)
    assert got.shape == (3, 1536) and bool(torch.isfinite(got).all())
    _close(got, want)
