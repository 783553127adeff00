"""The CUDA chains of kernels B3 and B4 (acmil_tpu_torch/ops/vit_layer.py)
against their plain versions on the card. The file imports no JAX or flax,
so it runs on a machine that has neither; here, without a card, the ``gpu``
tests skip. tests/test_torch_vit_layer.py holds the plain versions against
the JAX package's Pallas kernels."""

import warnings

import numpy as np
import pytest
import torch

from acmil_tpu_torch.config import Config
from acmil_tpu_torch.models.encoders import fast
from acmil_tpu_torch.models.encoders.build import (build_encoder,
                                                   encoder_feature_fn)
from acmil_tpu_torch.ops import vit_layer as port
from acmil_tpu_torch.utils import profiling

# bf16 both: the same rounding points, so only the order of f32 sums differs
# and may flip a bf16 rounding (of y, qkv, p, o or the gelu output); a
# flipped p can land on an output that cancels to near 0, so the bound is
# two bf16 steps (2**-8 each) of each output and of the largest output
BF16_TOL = 2.0 ** -6
# float16 both: the same argument, two float16 steps (2**-10 each)
F16_TOL = 2.0 ** -9
# float32 both (the GEMM in split-TF32, f32's accuracy; the attention on
# B7's fma route): only the order of the f32 sums differs, and the GEMM's
# products keep about 2**-22 of each term; a few f32 steps of K-term sums,
# amplified by the LayerNorms' 1/sigma
F32_TOL = 3e-5
TOLS = {torch.bfloat16: BF16_TOL, torch.float16: F16_TOL,
        torch.float32: F32_TOL}
# an f32 trunk's features on the card against the CPU's plain route,
# relative to the largest feature (chip_smoke.py's CPU_F32_REL): full f32
# differs from the CPU in the order of f32 sums alone (~1e-6); a
# convolution in TF32 keeps 2**-11 of each product and shows at ~1e-3
CPU_F32_REL = 1e-4


def _weights(rs, d, hidden, ls1=False):
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    w = {"norm1.weight": 1 + 0.1 * f(d), "norm1.bias": 0.1 * f(d),
         "norm2.weight": 1 + 0.1 * f(d), "norm2.bias": 0.1 * f(d),
         "attn.qkv.weight": 0.1 * f(3 * d, d), "attn.qkv.bias": 0.05 * f(3 * d),
         "attn.proj.weight": 0.1 * f(d, d), "attn.proj.bias": 0.05 * f(d),
         "mlp.fc1.weight": 0.1 * f(hidden, d), "mlp.fc1.bias": 0.05 * f(hidden),
         "mlp.fc2.weight": 0.1 * f(d, hidden), "mlp.fc2.bias": 0.05 * f(d)}
    if ls1:
        w["ls1.gamma"] = 0.25 + 0.5 * torch.from_numpy(
            rs.rand(d).astype(np.float32))
    return w


def _case(dev, b, n, d, hidden, ls1=False, seed=10, dtype=torch.bfloat16):
    rs = np.random.RandomState(seed)
    w = _weights(rs, d, hidden, ls1)
    x = torch.from_numpy(rs.randn(b, n, d).astype(np.float32))
    return x.to(dev, dtype), {k: v.to(dev) for k, v in w.items()}


@pytest.mark.parametrize("dtype, heads, match", [
    (torch.float64, 6, "bfloat16"),      # no chain takes float64
    (torch.float16, 1, "head widths"),   # dh = 384 > 256
    (torch.bfloat16, 5, "head widths"),
])
def test_chain_arg_check_rejects(dtype, heads, match):
    x, w = _case("cpu", 1, 8, 384, 1536)
    with pytest.raises(ValueError, match=match):
        port._check_chain_args(x.to(dtype), w, heads, mlp=True)


def test_chain_arg_check_accepts_the_trunk_widths():
    for d, heads in ((384, 6), (768, 12), (1024, 16)):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x, w = _case("cpu", 1, 4, d, 4 * d, dtype=dtype)
            port._check_chain_args(x, w, heads, mlp=True)


def _mlp_weights(d, hidden, act="gelu", ls2=True, dtype=torch.float32):
    rs = np.random.RandomState(4)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    out_w = 2 * hidden if act == "swiglu" else hidden
    w = {"norm2.weight": 1 + 0.1 * f(d), "norm2.bias": 0.1 * f(d),
         "mlp.fc1.weight": (0.1 * f(out_w, d)).to(dtype),
         "mlp.fc1.bias": 0.05 * f(out_w),
         "mlp.fc2.weight": (0.1 * f(d, hidden)).to(dtype),
         "mlp.fc2.bias": 0.05 * f(d)}
    if ls2:
        w["ls2.gamma"] = 0.25 + 0.5 * torch.from_numpy(
            rs.rand(d).astype(np.float32))
    return w


@pytest.mark.parametrize("dtype, act, d, hidden, mat_dtype, fused, route", [
    (torch.bfloat16, "gelu", 1024, 4096, torch.float32, True, "fused"),
    (torch.bfloat16, "gelu", 768, 3072, torch.float32, True, "fused"),
    (torch.bfloat16, "gelu", 1024, 4096, torch.float32, False, "plain"),
    (torch.float16, "gelu", 1024, 4096, torch.float32, True, "plain"),
    (torch.float32, "gelu", 1024, 4096, torch.float32, True, "plain"),
    (torch.bfloat16, "quick_gelu", 1024, 4096, torch.float32, True, "plain"),
    (torch.bfloat16, "swiglu", 1536, 4096, torch.float32, True, "fused"),
    (torch.bfloat16, "gelu", 1024, 4096, torch.bfloat16, True, "plain"),
    (torch.bfloat16, "gelu", 1024, 4104, torch.float32, True, "plain"),
    (torch.bfloat16, "swiglu", 1536, 4128, torch.float32, True, "plain"),
    (torch.float32, "swiglu", 1536, 4096, torch.float32, True, "plain"),
])
def test_mlp_route_takes_the_bf16a_gemm_only_for_bf16_gelu(
        dtype, act, d, hidden, mat_dtype, fused, route):
    # the fused MLP half for a bf16 trunk with gelu (the GEMM's tanh gelu
    # epilogue) or swiglu (GigaPath: its SwiGLU epilogue, fc1 in whole
    # 128-column tiles) on f32 matrices of widths the GEMM takes; fp16
    # (exact gelu), f32, quick_gelu (CLIP-L/336), bf16 matrices, a hidden
    # width off K % 32, a SwiGLU fc1 off 128 and fused=False keep _mlp_half
    w = _mlp_weights(d, hidden, act, dtype=mat_dtype)
    assert fast.mlp_route(w, dtype, act, fused) == route


@pytest.mark.parametrize("ls2", [True, False])
def test_fused_mlp_half_on_the_cpu_is_the_plain_half(ls2):
    # on a CPU tensor the fused MLP half is _mlp_half itself, forward and
    # backward
    rs = np.random.RandomState(5)
    w = _mlp_weights(64, 256, ls2=ls2)
    x = torch.from_numpy(rs.randn(2, 9, 64).astype(np.float32)).bfloat16()
    before = port._gemm.launches["bf16a"]
    torch.testing.assert_close(fast.fused_mlp_half(x, w),
                               fast._mlp_half(x, w, "gelu"), atol=0, rtol=0)
    assert port._gemm.launches["bf16a"] == before
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [{k: v.clone().requires_grad_() for k, v in w.items()}
          for _ in range(2)]
    fast.fused_mlp_half(xs[0], ws[0]).float().sum().backward()
    fast._mlp_half(xs[1], ws[1], "gelu").float().sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, atol=0, rtol=0)
    for k in w:
        torch.testing.assert_close(ws[0][k].grad, ws[1][k].grad, atol=0,
                                   rtol=0, msg=k)


@pytest.mark.parametrize("dtype, route", [(torch.bfloat16, "fused"),
                                          (torch.float32, "plain")])
def test_vit_encode_counts_each_mlp_half_by_its_route(dtype, route):
    from acmil_tpu_torch.models.encoders.vit import ViT

    torch.manual_seed(0)
    vit = ViT(patch=16, dim=96, depth=3, heads=4, layerscale=True,
              img_size=32)
    sd = {k: v.detach() for k, v in vit.state_dict().items()}
    assert fast.vit_route(sd, 5, vit.heads, dtype, vit.act) == "half"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    profiling.reset()
    profiling.spans_on(True)
    try:
        fast.vit_encode(sd, x, patch=16, depth=3, heads=4, dtype=dtype,
                        act=vit.act)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.spans_on(False)
        profiling.reset()
    assert counters == {f"vit.mlp_half.{route}": 3}


@pytest.mark.parametrize("dtype, fused, want", [
    (torch.bfloat16, True, {"vit.attn_half.fused": 2, "vit.mlp_half.fused": 2,
                            "vit.mlp_half.swiglu": 2}),
    (torch.bfloat16, False, {"vit.attn_half.plain": 2,
                             "vit.mlp_half.plain": 2}),
    (torch.float32, True, {"vit.attn_half.plain": 2,
                           "vit.mlp_half.plain": 2}),
])
def test_vit_encode_counts_route_3s_halves_by_their_routes(dtype, fused,
                                                           want):
    # GigaPath's width (route 3: outside attn_half_fits) with a small
    # SwiGLU MLP: each attention half counted by attn_route, each MLP half
    # by mlp_route, the fused SwiGLU ones again as vit.mlp_half.swiglu
    from acmil_tpu_torch.models.encoders.vit import ViT

    torch.manual_seed(0)
    vit = ViT(patch=16, dim=1536, depth=2, heads=24, mlp_ratio=1 / 6,
              act="swiglu", layerscale=True, img_size=32)
    sd = {k: v.detach() for k, v in vit.state_dict().items()}
    assert fast.vit_route(sd, 5, vit.heads, dtype, vit.act) == "packed"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    profiling.reset()
    profiling.spans_on(True)
    try:
        fast.vit_encode(sd, x, patch=16, depth=2, heads=24, dtype=dtype,
                        act=vit.act, fused=fused)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.spans_on(False)
        profiling.reset()
    assert counters == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B3 and B4 are CUDA C++ for sm_90a: needs an "
                    "NVIDIA card")
    return torch.device("cuda")


def _check(got, want, tol=BF16_TOL):
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("kind, b, n, d, heads, ls1", [
    ("layer", 3, 197, 384, 6, False),    # ViT-S/16
    ("layer", 2, 50, 64, 2, False),      # dh 32, ragged tiles
    ("layer", 2, 65, 96, 2, False),      # dh 48: B5' on B7's fma route
    ("half", 2, 197, 768, 12, True),     # ViT-B/16 with layerscale
    ("half", 2, 197, 1024, 16, False),   # UNI's widths
])
def test_chains_at_float16_and_float32_match_plain_on_card(
        cuda_device, dtype, kind, b, n, d, heads, ls1):
    # the matrices in f32 as given: the chains cast them to x's dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _case(cuda_device, b, n, d, 4 * d, ls1, dtype=dtype)
    fused, plain = ((port.fused_vit_layer, port._reference_layer)
                    if kind == "layer" else
                    (port.fused_vit_attn_half, port._reference_attn_half))
    key = {torch.float16: "f16", torch.float32: "f32"}[dtype]
    before = fused.launches, port._gemm.launches[key]
    with torch.no_grad():
        got = fused(x, w, heads)
        torch.cuda.synchronize()
        want = plain(x, w, heads)
    assert (fused.launches, port._gemm.launches[key]) == (
        before[0] + 1, before[1] + (4 if kind == "layer" else 2))
    _check(got, want, TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["layer", "half"])
def test_backward_on_card_equals_plain_autograd(cuda_device, kind):
    # the backward recomputes the unfused function JAX differentiates; on
    # the card it is that function's autograd, op for op
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _case(cuda_device, 2, 50, 64, 256, ls1=kind == "half",
                 dtype=torch.float32)
    fused, grad_fn = ((port.fused_vit_layer, port._unfused_layer)
                      if kind == "layer" else
                      (port.fused_vit_attn_half, port._unfused_attn_half))
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda_device)
                    .manual_seed(0), device=cuda_device)
    names = sorted(w)
    ins = [x.requires_grad_()] + [w[k].requires_grad_() for k in names]
    got = torch.autograd.grad(fused(x, w, 2), ins, g, allow_unused=True)
    refs = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(
        grad_fn(refs[0], dict(zip(names, refs[1:])), 2), refs, g,
        allow_unused=True)
    for name, a, b in zip(["x"] + names, got, want):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n", [(3, 197), (2, 50)])
def test_b3_chain_matches_plain_on_card(cuda_device, b, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _case(cuda_device, b, n, 384, 1536)
    before = port.fused_vit_layer.launches
    with torch.no_grad():
        got = port.fused_vit_layer(x, w, 6)
        torch.cuda.synchronize()
        want = port._reference_layer(x, w, 6)
    assert port.fused_vit_layer.launches == before + 1
    _check(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ls1", [True, False])
def test_b4_chain_matches_plain_on_card(cuda_device, ls1):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _case(cuda_device, 2, 197, 768, 3072, ls1)
    before = port.fused_vit_attn_half.launches
    with torch.no_grad():
        got = port.fused_vit_attn_half(x, w, 12)
        torch.cuda.synchronize()
        want = port._reference_attn_half(x, w, 12)
    assert port.fused_vit_attn_half.launches == before + 1
    _check(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind, b, n, d, heads", [
    ("layer", 2, 785, 384, 6),      # ViT-S/8: 785 tokens fail fits_vmem
    ("half", 2, 577, 1024, 16),     # CLIP-L/336: fails attn_half_fits
])
def test_chains_launch_outside_the_tpu_vmem_models(cuda_device, kind, b, n,
                                                   d, heads):
    # the VMEM models pick routes in vit_encode; on the card the wrappers
    # launch at any such width, never the unfused plain path
    torch.backends.cuda.matmul.allow_tf32 = False
    n_pad = (n + 15) // 16 * 16
    if kind == "layer":
        assert not port.fits_vmem(d, 4 * d, n_pad, heads)
        fused, plain = port.fused_vit_layer, port._reference_layer
    else:
        assert not port.attn_half_fits(d, n_pad, heads)
        fused, plain = port.fused_vit_attn_half, port._reference_attn_half
    x, w = _case(cuda_device, b, n, d, 4 * d)
    before = fused.launches
    with torch.no_grad():
        got = fused(x, w, heads)
        torch.cuda.synchronize()
        want = plain(x, w, heads)
    assert fused.launches == before + 1
    _check(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("pretrain, backbone", [("medical_ssl", "ViT-S/16"),
                                                ("natural_supervised",
                                                 "Resnet50")])
def test_f32_trunk_convolutions_keep_f32_with_cudnn_tf32_on(
        cuda_device, monkeypatch, pretrain, backbone):
    """Step2's f32 closure on the card with cuDNN's TF32 allowed, as
    PyTorch's default has it: every f32 convolution (a ViT's patch embed, a
    ResNet's) runs with TF32 off, and the features match the CPU's. (cuDNN
    may run a convolution in f32 even where TF32 is allowed, as it did the
    patch embed's 3 input channels on an H100, so the flag is read at each
    call as well.)"""
    conf = Config.from_dict({"pretrain": pretrain, "backbone": backbone})
    with warnings.catch_warnings(), torch.random.fork_rng(devices=[]):
        warnings.simplefilter("ignore")   # no pretrain_weights: seeded
        torch.manual_seed(0)
        model, spec, _ = build_encoder(conf, dtype=torch.float32)
    imgs = np.random.RandomState(3).randint(
        0, 256, (4, spec.img_size, spec.img_size, 3), dtype=np.uint8)
    want = encoder_feature_fn(model, spec, torch.device("cpu"), fused=False,
                              out_dtype=torch.float32)(imgs)
    card = encoder_feature_fn(model, spec, cuda_device,
                              out_dtype=torch.float32)
    conv, tf32_at_conv = torch.nn.functional.conv2d, []

    def spy(x, *args, **kwargs):
        if x.is_cuda and x.dtype == torch.float32:
            tf32_at_conv.append(torch.backends.cudnn.allow_tf32)
        return conv(x, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    got = card(imgs).cpu()
    rel = float((got - want).abs().max() / want.abs().max())
    assert torch.isfinite(got).all() and rel <= CPU_F32_REL, rel
    assert tf32_at_conv and not any(tf32_at_conv), tf32_at_conv


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, ls2", [(2, 197, True), (3, 197, False),
                                       (1, 50, True)])
def test_fused_mlp_half_matches_plain_on_card(cuda_device, b, n, ls2):
    # UNI's widths, M ragged: two bf16-A GEMMs against _mlp_half's plain
    # products on the same f32 matrices
    torch.backends.cuda.matmul.allow_tf32 = False
    w = {k: v.to(cuda_device) for k, v in
         _mlp_weights(1024, 4096, ls2=ls2).items()}
    x = torch.from_numpy(np.random.RandomState(6).randn(b, n, 1024).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    before = port._gemm.launches["bf16a"]
    with torch.no_grad():
        got = fast.fused_mlp_half(x, w)
        torch.cuda.synchronize()
        want = fast._mlp_half(x, w, "gelu")
    assert port._gemm.launches["bf16a"] == before + 2
    _check(got, want)


@pytest.mark.gpu
def test_vit_encode_at_uni_widths_runs_the_mlp_half_on_the_gemm(
        cuda_device, monkeypatch):
    # vit_encode on UNI's widths (B4, then the fused MLP half), depth 2:
    # each MLP half is two bf16-A GEMMs and no plain product (_mm is not
    # called), against fused=False
    from acmil_tpu_torch.models.encoders.vit import ViT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    vit = ViT(patch=16, dim=1024, depth=2, heads=16, layerscale=True)
    gen = torch.Generator().manual_seed(1)
    for blk in vit.blocks:
        for ls in (blk.ls1, blk.ls2):
            ls.gamma.data = 0.25 + 0.5 * torch.rand(ls.gamma.shape,
                                                    generator=gen)
    n_tok = (vit.img_size // vit.patch) ** 2 + 1
    params = fast.cast_kernel_weights(
        {k: v.to(cuda_device) for k, v in vit.state_dict().items()},
        n_tok=n_tok, heads=vit.heads, dtype=torch.bfloat16, act=vit.act)
    assert fast.vit_route(params, n_tok, vit.heads, torch.bfloat16,
                          vit.act) == "half"
    x = torch.randn(3, vit.img_size, vit.img_size, 3, generator=gen).to(
        cuda_device)
    kw = dict(patch=vit.patch, depth=2, heads=vit.heads, act=vit.act)
    mm = fast._mm

    def no_plain_product(a, b):
        raise AssertionError("the fused route called _mm")

    before = port._gemm.launches["bf16a"]
    monkeypatch.setattr(fast, "_mm", no_plain_product)
    with torch.no_grad():
        got = fast.vit_encode(params, x, **kw)
        torch.cuda.synchronize()
    monkeypatch.setattr(fast, "_mm", mm)
    assert port._gemm.launches["bf16a"] == before + 2 * 2
    with torch.no_grad():
        want = fast.vit_encode(params, x, **kw, fused=False)
    assert got.shape == (3, 1024) and bool(torch.isfinite(got).all())
    _check(got, want)
