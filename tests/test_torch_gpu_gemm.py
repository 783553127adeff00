"""The GEMMs of kernels B3 and B4 (``csrc/vit_gemm.cu`` at bfloat16 and
float16, ``csrc/vit_gemm_f32.cu`` at float32 and in its bf16-A mode, through
``acmil_tpu_torch/ops/vit_layer.py::_gemm``) alone, against a plain
``torch.matmul`` with the same prologue and epilogue, and the float32 one
also against a float64 product. The file imports no JAX, so it runs on the
card's machine; here the ``gpu`` tests skip and the argument checks and the
sources' structure are tested."""

import os

import numpy as np
import pytest
import torch

from acmil_tpu_torch.ops import vit_layer as port

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "acmil_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "vit_gemm.cu")
# the kernel and the plain version both take bf16 operands and f32 sums; the
# order of the sums differs, which can flip the bf16 rounding of an output
# (2**-8 of it) or of a LayerNorm'd input element (whose effect on a
# K-term sum is far smaller): one bf16 step of each output and of the
# largest output
TOL = 2.0 ** -7
# float16: the same argument at one float16 step (2**-10)
F16_TOL = 2.0 ** -10
# the float32 GEMM's error against a float64 product may be at most twice
# that of full-f32 torch.matmul on the same operands, plus a few f32 steps
# of the largest output (2**-21 of it): the kernel's gelu and epilogue
# additions round at other points than torch's
F32_FLOOR = 2.0 ** -21


def _plain(a, w, bias, epilogue, out_dtype, ln=None, ls=None, res=None):
    """The GEMM's contract in plain torch: f32 LayerNorm (or none) of a,
    rounded to w's dtype (a bf16 a with an f32 w, the bf16-A mode: to
    bf16), an f32 product with w, then the epilogue in f32. With float64
    operands every step is float64."""
    acc_dtype = torch.float64 if w.dtype == torch.float64 else torch.float32
    rows = (torch.bfloat16 if (a.dtype, w.dtype) == (torch.bfloat16,
                                                     torch.float32)
            else w.dtype)
    af = a.to(acc_dtype)
    if ln is not None:
        af = port._ln_f32(af, *(t.to(acc_dtype) for t in ln))
    acc = af.to(rows).to(acc_dtype) @ w.to(acc_dtype).t()
    bias = bias.to(acc_dtype)
    if epilogue == port.EPI_BIAS:
        y = acc + bias
    elif epilogue == port.EPI_BIAS_GELU:
        y = torch.nn.functional.gelu(acc + bias, approximate="tanh")
    elif epilogue == port.EPI_RES_BIAS:
        y = (res.to(acc_dtype) + acc) + bias
    else:
        t = acc + bias
        y = res.to(acc_dtype) + (t * ls.to(acc_dtype) if ls is not None
                                 else t)
    return y.to(out_dtype)


def _operands(dev, m, n, k, a_dtype, seed=0, w_dtype=torch.bfloat16):
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dev)
    a = (1.5 * f(m, k) + 0.3).to(a_dtype)
    w = (f(n, k) / np.sqrt(k)).to(w_dtype).contiguous()
    ln = (1 + 0.1 * f(k), 0.1 * f(k))
    return a, w, 0.1 * f(n), ln, 0.25 + 0.5 * f(n).abs(), f(m, n)


def _check(got, want, tol=TOL):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


def test_source_is_tma_and_wgmma():
    # the products are warpgroup MMAs on TMA-filled tiles through an
    # mbarrier ring (the primitives in csrc/hopper.cuh, which it includes);
    # nothing of the old nvcuda::wmma kernel remains
    with open(SOURCE) as f:
        src = f.read()
    assert '#include "hopper.cuh"' in src
    with open(os.path.join(CSRC, "hopper.cuh")) as f:
        src += f.read()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg", "CUtensorMap"):
        assert needle in src, needle
    assert "nvcuda" not in src and "mma.h" not in src
    # both element types, by template, on one design
    for needle in (".f32.\" TY \".\" TY", "CU_TENSOR_MAP_DATA_TYPE_FLOAT16",
                   "run<f16>", "run<bf16>"):
        assert needle in src, needle


def test_f32_source_is_split_tf32_with_the_shared_rows():
    # the f32 GEMM multiplies split-TF32 operands on wgmma .tf32 from
    # TMA-filled f32 tiles (tf32x3.cuh's split, the primitives of
    # hopper.cuh), and shares the prologue and epilogues with the bf16 one;
    # nothing of the mma.sync block product remains
    with open(os.path.join(CSRC, "vit_gemm_f32.cu")) as f:
        src = f.read()
    for needle in ('#include "tf32x3.cuh"', '#include "vit_rows.cuh"',
                   '#include "hopper.cuh"', "m64n128k8.f32.tf32.tf32",
                   "CU_TENSOR_MAP_DATA_TYPE_FLOAT32", "tma_load(",
                   "setmaxnreg", "tf32x3::split<0>",
                   "launch_prologue<float, float, true>",
                   "epilogue_value<kEpi>"):
        assert needle in src, needle
    assert "BlockGemm" not in src and "mma.sync" not in src
    with open(SOURCE) as f:
        assert '#include "vit_rows.cuh"' in f.read()


def test_f32_source_has_the_bf16_a_mode():
    # the bf16-A mode is a template instantiation of the same kernel: A
    # staged by TMA as bf16 through its own unswizzled map, widened in
    # registers (no split of A), the bf16 LayerNorm prologue, its own entry
    with open(os.path.join(CSRC, "vit_gemm_f32.cu")) as f:
        src = f.read()
    for needle in ("template <int kEpi, bool kBf16A>", "if constexpr (kBf16A)",
                   "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16",
                   "CU_TENSOR_MAP_SWIZZLE_NONE", "widen_bf16(",
                   "launch_prologue<bf16, bf16, true>", "run<true>(",
                   "run<false>(", "int vit_gemm_f32_bf16a("):
        assert needle in src, needle
    with open(os.path.join(CSRC, "hopper.cuh")) as f:
        assert "bool make_tiled_map(" in f.read()


@pytest.mark.parametrize("change, match", [
    (dict(k=40), "K % 32 == 0"),
    (dict(n=12), "N % 8 == 0"),
    (dict(a_dtype=torch.float16), "bfloat16 or float32"),
    (dict(w_dtype=torch.float64), "weight must be bfloat16"),
    (dict(bias_len=7), "vectors must be float32"),
    (dict(res_shape=(4, 8)), "residual must be"),
    (dict(strided=True), "contiguous"),
])
def test_gemm_rejects_what_the_kernel_does_not_take(change, match):
    m, n, k = change.get("m", 16), change.get("n", 64), change.get("k", 64)
    a = torch.zeros(m, k * (2 if change.get("strided") else 1),
                    dtype=change.get("a_dtype", torch.bfloat16))
    if change.get("strided"):
        a = a[:, ::2]
    w = torch.zeros(n, k, dtype=change.get("w_dtype", torch.bfloat16))
    bias = torch.zeros(change.get("bias_len", n))
    res = torch.zeros(*change.get("res_shape", (m, n)))
    with pytest.raises(ValueError, match=match):
        port._gemm(a, w, bias, port.EPI_RES_BIAS, out_dtype=torch.bfloat16,
                   res=res)


@pytest.mark.parametrize("a_dtype, res_dtype, out_dtype, match", [
    (torch.float32, torch.bfloat16, torch.float32, "residual must be"),
    (torch.float32, torch.float32, torch.float16, "output must be"),
    (torch.float64, torch.float32, torch.float32, "input must be"),
])
def test_f32_gemm_rejects_what_the_kernel_does_not_take(a_dtype, res_dtype,
                                                        out_dtype, match):
    a = torch.zeros(16, 64, dtype=a_dtype)
    w = torch.zeros(64, 64)
    with pytest.raises(ValueError, match=match):
        port._gemm(a, w, torch.zeros(64), port.EPI_RES_BIAS,
                   out_dtype=out_dtype, res=torch.zeros(16, 64,
                                                        dtype=res_dtype))


@pytest.mark.parametrize("change, match", [
    (dict(k=40), "K % 32 == 0"),
    (dict(n=12), "N % 8 == 0"),
    (dict(w_shape=(64, 96)), "weight must be float32"),
    (dict(bias_dtype=torch.bfloat16), "vectors must be float32"),
    (dict(res_dtype=torch.float16), "residual must be"),
    (dict(res_dtype=torch.float32), "residual must be"),
    (dict(out_dtype=torch.float16), "output must be"),
])
def test_bf16a_gemm_rejects_what_the_kernel_does_not_take(change, match):
    # a bf16 A with an f32 W: the bf16-A mode takes a bf16 residual, bf16 or
    # f32 outputs, f32 vectors, K % 32 and N % 8
    m, n, k = 16, change.get("n", 64), change.get("k", 64)
    a = torch.zeros(m, k, dtype=torch.bfloat16)
    w = torch.zeros(*change.get("w_shape", (n, k)))
    bias = torch.zeros(n, dtype=change.get("bias_dtype", torch.float32))
    res = torch.zeros(m, n, dtype=change.get("res_dtype", torch.bfloat16))
    with pytest.raises(ValueError, match=match):
        port._gemm(a, w, bias, port.EPI_BIAS_LS_RES, res=res,
                   out_dtype=change.get("out_dtype", torch.bfloat16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the GEMM is CUDA C++ for sm_90a: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (M, N, K): a ViT-S/16 image's tokens against the qkv width; a tiny ragged
# N; N and K that are not multiples of the tile (392 = 3 x 128 + 8, K = 96
# is one and a half depth steps); many tiles per block of the persistent
# grid at fc2's shape
SHAPES = [(197, 1152, 384), (300, 8, 32), (1000, 392, 96), (9001, 384, 1536)]


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, k", SHAPES)
@pytest.mark.parametrize("epilogue", [port.EPI_BIAS, port.EPI_BIAS_GELU,
                                      port.EPI_RES_BIAS, port.EPI_BIAS_LS_RES])
@pytest.mark.parametrize("a_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_ln", [True, False])
def test_gemm_matches_plain_on_card(cuda_device, m, n, k, epilogue, a_dtype,
                                    with_ln):
    a, w, bias, ln, ls, res = _operands(cuda_device, m, n, k, a_dtype)
    # the residual and the output in both dtypes, across the cases
    out_dtype = torch.float32 if a_dtype == torch.bfloat16 else torch.bfloat16
    res = res.to(torch.bfloat16 if out_dtype == torch.float32
                 else torch.float32)
    kw = dict(ln=ln if with_ln else None,
              ls=ls if epilogue == port.EPI_BIAS_LS_RES and with_ln else None,
              res=res if epilogue >= port.EPI_RES_BIAS else None)
    with torch.no_grad():
        got = port._gemm(a, w, bias, epilogue, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        want = _plain(a, w, bias, epilogue, out_dtype, **kw)
    assert got.dtype == out_dtype and got.shape == (m, n)
    _check(got, want)


@pytest.mark.gpu
def test_gemm_is_deterministic_and_launches_on_the_current_stream(
        cuda_device):
    a, w, bias, ln, _, _ = _operands(cuda_device, 50432, 384, 384,
                                     torch.bfloat16)
    side = torch.cuda.Stream()
    with torch.no_grad(), torch.cuda.stream(side):
        one = port._gemm(a, w, bias, port.EPI_BIAS, out_dtype=torch.bfloat16,
                         ln=ln)
        two = port._gemm(a, w, bias, port.EPI_BIAS, out_dtype=torch.bfloat16,
                         ln=ln)
    side.synchronize()
    assert torch.equal(one, two)
    _check(one, _plain(a, w, bias, port.EPI_BIAS, torch.bfloat16, ln=ln))


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, k", SHAPES)
@pytest.mark.parametrize("epilogue", [port.EPI_BIAS, port.EPI_BIAS_GELU,
                                      port.EPI_RES_BIAS, port.EPI_BIAS_LS_RES])
@pytest.mark.parametrize("a_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("with_ln", [True, False])
def test_gemm_float16_matches_plain_on_card(cuda_device, m, n, k, epilogue,
                                            a_dtype, with_ln):
    # fp16 operands with f32 sums against fp16 torch.matmul's contract
    a, w, bias, ln, ls, res = _operands(cuda_device, m, n, k, a_dtype,
                                        w_dtype=torch.float16)
    out_dtype = torch.float32 if a_dtype == torch.float16 else torch.float16
    res = res.to(torch.float16 if out_dtype == torch.float32
                 else torch.float32)
    kw = dict(ln=ln if with_ln else None,
              ls=ls if epilogue == port.EPI_BIAS_LS_RES and with_ln else None,
              res=res if epilogue >= port.EPI_RES_BIAS else None)
    before = port._gemm.launches["f16"]
    with torch.no_grad():
        got = port._gemm(a, w, bias, epilogue, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        want = _plain(a, w, bias, epilogue, out_dtype, **kw)
    assert port._gemm.launches["f16"] == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    _check(got, want, F16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, k", SHAPES)
@pytest.mark.parametrize("epilogue", [port.EPI_BIAS, port.EPI_BIAS_GELU,
                                      port.EPI_RES_BIAS, port.EPI_BIAS_LS_RES])
@pytest.mark.parametrize("with_ln", [True, False])
def test_gemm_float32_is_as_accurate_as_float32_matmul(cuda_device, m, n, k,
                                                       epilogue, with_ln):
    # the split-TF32 GEMM against a float64 product: its error at most
    # twice that of full-f32 torch.matmul (TF32 off) on the same operands
    a, w, bias, ln, ls, res = _operands(cuda_device, m, n, k, torch.float32,
                                        w_dtype=torch.float32)
    kw = dict(ln=ln if with_ln else None,
              ls=ls if epilogue == port.EPI_BIAS_LS_RES else None,
              res=res if epilogue >= port.EPI_RES_BIAS else None)
    before = port._gemm.launches["f32"]
    with torch.no_grad():
        got = port._gemm(a, w, bias, epilogue, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        lib = _plain(a, w, bias, epilogue, torch.float32, **kw)
        exact = _plain(a.double(), w.double(), bias, epilogue, torch.float64,
                       **kw)
    assert port._gemm.launches["f32"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = float((got.double() - exact).abs().max())
    lib_err = float((lib.double() - exact).abs().max())
    assert err <= 2 * lib_err + F32_FLOOR * float(exact.abs().max()), \
        (err, lib_err)


# B3's four calls at float32 as the chain makes them at ViT-S/16, B = 256
# (M = 50432 tokens): (label, N, K, epilogue, LayerNorm)
VIT_S16_CALLS = [("qkv", 1152, 384, port.EPI_BIAS, True),
                 ("proj", 384, 384, port.EPI_RES_BIAS, False),
                 ("fc1", 1536, 384, port.EPI_BIAS_GELU, True),
                 ("fc2", 384, 1536, port.EPI_RES_BIAS, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("label, n, k, epilogue, with_ln", VIT_S16_CALLS)
def test_gemm_float32_at_the_vit_s16_calls(cuda_device, label, n, k,
                                           epilogue, with_ln):
    # the bar of test_gemm_float32_is_as_accurate_as_float32_matmul at the
    # shapes of Step2's f32 path, many tiles a block of the persistent grid
    m = 256 * 197
    a, w, bias, ln, _, res = _operands(cuda_device, m, n, k, torch.float32,
                                       w_dtype=torch.float32)
    kw = dict(ln=ln if with_ln else None,
              res=res if epilogue >= port.EPI_RES_BIAS else None)
    with torch.no_grad():
        got = port._gemm(a, w, bias, epilogue, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        lib = _plain(a, w, bias, epilogue, torch.float32, **kw)
        exact = _plain(a.double(), w.double(), bias, epilogue, torch.float64,
                       **kw)
    err = float((got.double() - exact).abs().max())
    lib_err = float((lib.double() - exact).abs().max())
    assert err <= 2 * lib_err + F32_FLOOR * float(exact.abs().max()), \
        (label, err, lib_err)


@pytest.mark.gpu
@pytest.mark.parametrize("n, k", [(1152, 384), (384, 1536), (8, 32)])
def test_split_w_is_bit_exact_on_card(cuda_device, n, k):
    # the split kernel against its plain version, with ties, subnormals,
    # infinities and NaNs among the weights
    rs = np.random.RandomState(n + k)
    w = rs.randn(n, k).astype(np.float32)
    special = np.array([0x3f801000, 0xbf803000, 0x00001000, 0x7f7fffff,
                        0x7f800000, 0xff800000, 0x7fc00000, 0x7f800001],
                       np.uint32).view(np.float32)
    w.reshape(-1)[:len(special)] = special
    w = torch.from_numpy(w)
    before = port.split_w.launches
    got = port.split_w(w.to(cuda_device))
    torch.cuda.synchronize()
    assert port.split_w.launches == before + 1
    want = port._split_w_reference(w)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_gemm_float32_is_deterministic_and_launches_on_the_current_stream(
        cuda_device):
    a, w, bias, ln, _, res = _operands(cuda_device, 50432, 384, 1536,
                                       torch.float32, w_dtype=torch.float32)
    side = torch.cuda.Stream()
    with torch.no_grad(), torch.cuda.stream(side):
        one = port._gemm(a, w, bias, port.EPI_RES_BIAS,
                         out_dtype=torch.float32, res=res)
        two = port._gemm(a, w, bias, port.EPI_RES_BIAS,
                         out_dtype=torch.float32, res=res)
    side.synchronize()
    assert torch.equal(one, two)
    exact = _plain(a.double(), w.double(), bias, port.EPI_RES_BIAS,
                   torch.float64, res=res)
    lib = _plain(a, w, bias, port.EPI_RES_BIAS, torch.float32, res=res)
    err = float((one.double() - exact).abs().max())
    lib_err = float((lib.double() - exact).abs().max())
    assert err <= 2 * lib_err + F32_FLOOR * float(exact.abs().max())


# the bf16-A mode at UNI's MLP half (D 1024, hidden 4096) with M ragged
# (32 images of 197 tokens: 49.25 row tiles), and small ragged shapes
# (N = 392 is three tiles and 8 columns, K = 96 one and a half stages)
BF16A_SHAPES = [(32 * 197, 4096, 1024), (32 * 197, 1024, 4096),
                (300, 8, 32), (1000, 392, 96)]


def _bf16a_operands(dev, m, n, k, seed=0):
    """bf16 A and residual, f32 W and vectors (the MLP half's operands)."""
    a, w, bias, ln, ls, res = _operands(dev, m, n, k, torch.bfloat16, seed,
                                        w_dtype=torch.float32)
    return a, w, bias, ln, ls, res.to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, k", BF16A_SHAPES)
@pytest.mark.parametrize("epilogue, with_ls", [
    (port.EPI_BIAS, False), (port.EPI_BIAS_GELU, False),
    (port.EPI_RES_BIAS, False), (port.EPI_BIAS_LS_RES, True),
    (port.EPI_BIAS_LS_RES, False)])
def test_gemm_bf16a_is_as_accurate_as_float32_matmul(cuda_device, m, n, k,
                                                     epilogue, with_ls):
    # the f32 mode's bar: against a float64 product of the same bf16 A and
    # f32 W, the error at most twice that of full-f32 torch.matmul plus a
    # few f32 steps of the largest output; f32 out, a bf16 residual
    a, w, bias, _, ls, res = _bf16a_operands(cuda_device, m, n, k)
    kw = dict(ls=ls if with_ls else None,
              res=res if epilogue >= port.EPI_RES_BIAS else None)
    before = port._gemm.launches["bf16a"]
    with torch.no_grad():
        got = port._gemm(a, w, bias, epilogue, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        lib = _plain(a, w, bias, epilogue, torch.float32, **kw)
        exact = _plain(a.double(), w.double(), bias, epilogue, torch.float64,
                       **kw)
    assert port._gemm.launches["bf16a"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = float((got.double() - exact).abs().max())
    lib_err = float((lib.double() - exact).abs().max())
    assert err <= 2 * lib_err + F32_FLOOR * float(exact.abs().max()), \
        (err, lib_err)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, k", BF16A_SHAPES)
@pytest.mark.parametrize("epilogue, with_ls", [
    (port.EPI_BIAS_GELU, False), (port.EPI_BIAS_LS_RES, True),
    (port.EPI_BIAS_LS_RES, False)])
@pytest.mark.parametrize("with_ln", [True, False])
def test_gemm_bf16a_matches_plain_on_card(cuda_device, m, n, k, epilogue,
                                          with_ls, with_ln):
    # the MLP half's two calls as the chain makes them: bf16 out, a bf16
    # residual, the bf16 LayerNorm prologue on or off. The products carry
    # f32's accuracy (the bar above), so only a bf16 rounding may flip
    # (of an output or of a LayerNorm'd row element): TOL
    a, w, bias, ln, ls, res = _bf16a_operands(cuda_device, m, n, k)
    kw = dict(ln=ln if with_ln else None, ls=ls if with_ls else None,
              res=res if epilogue >= port.EPI_RES_BIAS else None)
    with torch.no_grad():
        got = port._gemm(a, w, bias, epilogue, out_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        want = _plain(a, w, bias, epilogue, torch.bfloat16, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _check(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, k", BF16A_SHAPES)
def test_gemm_bf16a_equals_the_f32_mode_bit_for_bit(cuda_device, m, n, k):
    # a bf16 value is exact in TF32, so the f32 mode's lo hi products add
    # exact zeros: its two products give the bits of the f32 mode's three
    # on a.float() (epilogue 0, f32 out)
    a, w, bias, _, _, _ = _bf16a_operands(cuda_device, m, n, k)
    with torch.no_grad():
        got = port._gemm(a, w, bias, port.EPI_BIAS, out_dtype=torch.float32)
        want = port._gemm(a.float(), w, bias, port.EPI_BIAS,
                          out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
