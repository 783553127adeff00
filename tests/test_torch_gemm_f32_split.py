"""The float32 GEMM of kernels B3 and B4 (``csrc/vit_gemm_f32.cu``: TMA and
wgmma ``.tf32``, split-TF32) on the CPU: the plain version of its W split
against an independent numpy rounding to TF32, the order of depth that the
split and the kernel share, and the kernel's arithmetic, emulated in numpy,
against float64 and against the JAX package's f32 B3. The kernel itself
runs only on a card: tests/test_torch_gpu_gemm.py holds it against float64
and its plain version there.

The emulation follows the kernel's products: hi = tf32(a) and lo = tf32(a -
hi) of A and W by the kernel's integer add and mask; each product as lo hi +
hi lo + hi hi; the products of ``kFlushStages`` 32-deep stages (all of K
for 0) summed apart and added to the running sums in f32. Sums inside such
a group are exact (float64), rounded once to f32: the tensor cores' own
accumulation inside a group is held to float64 by the GPU tests.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import vit_layer as jax_layer
from acmil_tpu_torch.ops import _build
from acmil_tpu_torch.ops import vit_layer as port
from acmil_tpu_torch.ops.vit_attn_packed import _reference_packed

SRC = _build.CSRC / "vit_gemm_f32.cu"
STAGE = 32          # the depth of a stage: one 128-byte row of f32
# the emulated GEMM against float64, as tests/test_torch_gpu_gemm.py holds
# the kernel: its error at most twice that of an f32 product (numpy's, on
# the same operands) plus a few f32 steps of the largest output
F32_FLOOR = 2.0 ** -21
# the emulated B3 layer against the JAX package's f32 B3 (the Pallas kernel
# in interpret mode): two f32 orders of the sums through two LayerNorms,
# four products and a softmax of 50 keys, as tests/test_torch_vit_layer.py
# holds the plain version (F32_TOL)
LAYER_TOL = 2e-5


def _flush_stages() -> int:
    return int(re.search(r"constexpr int kFlushStages = (\d+);",
                         SRC.read_text()).group(1))


def _tf32_reference(a):
    """float32 -> float32 rounded to TF32 (10 fraction bits), to nearest
    with ties away from 0, in float64 arithmetic: the quantum of |a| is
    2**(e - 10) for 2**e <= |a| (2**-136 below the normal range); an
    infinity or a NaN passes."""
    a = np.asarray(a, np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        x = np.abs(a.astype(np.float64))
        finite = np.isfinite(x) & (x > 0)
        _, e = np.frexp(np.where(finite, x, 1.0))
        q = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
        r = np.floor(x / q + 0.5) * q
        out = np.copysign(r, a).astype(np.float32)
    return np.where(finite, out, a)


def _split_reference(w):
    """hi, lo of every element (natural order), numpy only."""
    hi = _tf32_reference(w)
    finite = np.isfinite(w)
    with np.errstate(invalid="ignore"):
        lo = np.where(finite, _tf32_reference(w - hi), np.float32(0))
    return hi, lo


def _unorder(split):
    """The kernel's order of depth undone: [2, N, K] -> [2, N, K] natural."""
    s = np.asarray(split)
    n, k = s.shape[1:]
    out = np.empty_like(s).reshape(2, n, k // STAGE, STAGE)
    out[..., list(port.SPLIT_K_ORDER)] = s.reshape(2, n, k // STAGE, STAGE)
    return out.reshape(2, n, k)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _special_values():
    """Ties (the low 13 bits exactly 0x1000, both signs, with an even and an
    odd kept bit), values just either side of a tie, subnormals (a tie at
    2**-136 among them, and one that rounds up into the normal range), the
    largest finite (rounds to inf), 0 and -0, +-inf and NaNs (quiet, and
    one whose payload lies in the low 13 bits only)."""
    u = [0x3f801000, 0x3f803000, 0xbf801000, 0xbf803000, 0x3f800fff,
         0x3f801001, 0x00001000, 0x00003000, 0x807ff000, 0x00000001,
         0x007fffff, 0x7f7fffff, 0xff7fffff, 0x00000000, 0x80000000,
         0x7f800000, 0xff800000, 0x7fc00000, 0x7f800001, 0xffc00001,
         0x4b7ff000, 0x33801000]
    return np.array(u + [0] * (-len(u) % STAGE), np.uint32).view(np.float32)


def test_tf32_reference_rounds_ties_away_and_passes_non_finite():
    v = _special_values()
    hi = _bits(_tf32_reference(v))
    want = {0x3f801000: 0x3f802000, 0x3f803000: 0x3f804000,
            0xbf801000: 0xbf802000, 0x3f800fff: 0x3f800000,
            0x3f801001: 0x3f802000, 0x00001000: 0x00002000,
            0x807ff000: 0x80800000, 0x00000001: 0x00000000,
            0x7f7fffff: 0x7f800000, 0x80000000: 0x80000000,
            0x7f800000: 0x7f800000, 0x7fc00000: 0x7fc00000,
            0x7f800001: 0x7f800001}
    for src, dst in want.items():
        assert hi[list(_bits(v)).index(src)] == dst, hex(src)


@pytest.mark.parametrize("case", ["special", "randn", "wide", "subnormal"])
def test_split_plain_is_bit_exact_against_numpy_tf32(case):
    rs = np.random.RandomState(7)
    if case == "special":
        w = np.tile(_special_values(), (3, 2))
    elif case == "randn":
        w = rs.randn(24, 96).astype(np.float32)
    elif case == "wide":
        w = (rs.randn(8, 64) * 10.0 ** rs.randint(-30, 30, (8, 64))).astype(
            np.float32)
    else:
        w = (rs.randn(8, 64) * 1e-39).astype(np.float32)
    got = _unorder(port.split_w(torch.from_numpy(w)).numpy())
    hi, lo = _split_reference(w)
    np.testing.assert_array_equal(_bits(got[0]), _bits(hi))
    np.testing.assert_array_equal(_bits(got[1]), _bits(lo))
    # both halves are TF32 values: their low 13 bits are 0 (NaN payloads
    # of the input aside)
    finite = np.isfinite(w)
    assert not (_bits(got[:, finite]) & 0x1fff).any()


def test_split_halves_sum_to_a_where_representable():
    # a with at most 22 significant bits is hi + lo exactly: hi keeps 11,
    # and a - hi (at most half of hi's quantum) fits lo's 11
    rs = np.random.RandomState(3)
    u = (rs.randint(0x3e800000, 0x41000000, (16, 64)).astype(np.uint32)
         & np.uint32(0xfffffffc))
    u[::2] |= np.uint32(0x80000000)
    w = u.view(np.float32)
    hi, lo = _unorder(port.split_w(torch.from_numpy(w)).numpy())
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, w)
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()


def test_order_of_depth_matches_the_source():
    # the Python order is a permutation of a stage's 32 columns, its
    # inverse is the source's k_position, and k8 step j's slots t and
    # t + 4 hold columns 8t + 2j and 8t + 2j + 1 (a thread's A values of a
    # row over the stage: columns 8t .. 8t + 7)
    order = port.SPLIT_K_ORDER
    assert sorted(order) == list(range(STAGE))
    body = re.search(r"constexpr int k_position\(int c\) \{\s*return (.*?);",
                     SRC.read_text(), re.S).group(1)
    k_position = eval("lambda c: " + body.replace("/", "//"))
    assert all(order[k_position(c)] == c for c in range(STAGE))
    for j in range(4):
        for t in range(4):
            assert order[8 * j + t] == 8 * t + 2 * j
            assert order[8 * j + t + 4] == 8 * t + 2 * j + 1


def test_split_w_checks_its_argument():
    with pytest.raises(ValueError, match="K % 32 == 0"):
        port.split_w(torch.zeros(8, 48))
    with pytest.raises(ValueError, match="float32"):
        port.split_w(torch.zeros(8, 64, dtype=torch.float16))


def _emulated_product(a, w, flush=None):
    """a [M, K] · w [N, K]ᵀ as the kernel sums it, float32 out."""
    flush = _flush_stages() if flush is None else flush
    k = a.shape[1]
    ah, al = (t.astype(np.float64) for t in _split_reference(a))
    wh, wl = (t.astype(np.float64) for t in _split_reference(w))
    group = STAGE * flush if flush else k
    acc = np.zeros((a.shape[0], w.shape[0]), np.float32)
    for k0 in range(0, k, group):
        s = slice(k0, min(k0 + group, k))
        part = (al[:, s] @ wh[:, s].T + ah[:, s] @ wl[:, s].T) \
            + ah[:, s] @ wh[:, s].T
        acc += part.astype(np.float32)
    return acc


def _gelu_tanh(x):
    x = x.astype(np.float32)
    u = np.float32(0.7978845608028654) * (x + np.float32(0.044715) * x ** 3)
    return x * (np.float32(0.5) * (np.float32(1) + np.tanh(u)))


def _emulated_gemm(a, w, bias, epilogue, ln=None, res=None):
    """The kernel's contract with its products emulated: the f32
    LayerNorm prologue, then the epilogue in f32."""
    if ln is not None:
        a = port._ln_f32(torch.from_numpy(a), *(torch.from_numpy(t)
                                                for t in ln)).numpy()
    acc = _emulated_product(a, w)
    if epilogue == port.EPI_BIAS_GELU:
        return _gelu_tanh(acc + bias)
    if epilogue == port.EPI_RES_BIAS:
        return (res + acc) + bias
    return acc + bias


@pytest.mark.parametrize("k", [32, 384, 1536])
@pytest.mark.parametrize("flush", [None, 2, 0])
def test_emulated_product_is_as_accurate_as_an_f32_product(k, flush):
    # the split's dropped lo lo and the rounding of lo (~2**-22 of a term)
    # against f32's rounding of the running sums; each flush depth the
    # variants script measures on the card (as built, 64, none)
    rs = np.random.RandomState(k)
    a = (1.5 * rs.randn(64, k) + 0.3).astype(np.float32)
    w = (rs.randn(48, k) / np.sqrt(k)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64).T
    got = _emulated_product(a, w, flush)
    err = np.abs(got - exact).max()
    lib_err = np.abs((a @ w.T).astype(np.float64) - exact).max()
    assert err <= 2 * lib_err + F32_FLOOR * np.abs(exact).max(), \
        (err, lib_err)


def test_emulated_b3_layer_matches_jax_fused_vit_layer():
    # B3 at float32 as the chain runs it: LN1 -> qkv -> B5' -> proj (+x)
    # -> LN2 -> fc1 (gelu) -> fc2 (+h), each GEMM emulated, the attention
    # the port's plain packed MHA; against the Pallas kernel in interpret
    # mode at a small shape
    rs = np.random.RandomState(21)
    b, n, d, hidden, heads = 2, 50, 64, 256, 2
    lin = lambda i, o: {"kernel": (rs.randn(i, o) * 0.1).astype(np.float32),
                        "bias": (rs.randn(o) * 0.05).astype(np.float32)}
    ln = lambda: {"scale": (1 + 0.1 * rs.randn(d)).astype(np.float32),
                  "bias": (0.1 * rs.randn(d)).astype(np.float32)}
    w = {"ln1": ln(), "ln2": ln(), "qkv": lin(d, 3 * d), "proj": lin(d, d),
         "fc1": lin(d, hidden), "fc2": lin(hidden, d)}
    x = rs.randn(b, n, d).astype(np.float32)
    want = np.asarray(jax_layer.fused_vit_layer(
        jnp.asarray(x), {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                         for k, v in w.items()}, heads))

    mat = lambda name: np.ascontiguousarray(w[name]["kernel"].T)
    lnp = lambda name: (w[name]["scale"], w[name]["bias"])
    x2 = x.reshape(b * n, d)
    qkv = _emulated_gemm(x2, mat("qkv"), w["qkv"]["bias"], port.EPI_BIAS,
                         ln=lnp("ln1"))
    o = _reference_packed(torch.from_numpy(qkv.reshape(b, n, 3 * d)),
                          heads).numpy().reshape(b * n, d)
    h = _emulated_gemm(o, mat("proj"), w["proj"]["bias"], port.EPI_RES_BIAS,
                       res=x2)
    m = _emulated_gemm(h, mat("fc1"), w["fc1"]["bias"], port.EPI_BIAS_GELU,
                       ln=lnp("ln2"))
    got = _emulated_gemm(m, mat("fc2"), w["fc2"]["bias"], port.EPI_RES_BIAS,
                         res=h).reshape(b, n, d)
    np.testing.assert_allclose(got, want, atol=LAYER_TOL, rtol=LAYER_TOL)
