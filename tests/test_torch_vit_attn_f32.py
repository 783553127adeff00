"""The float32 route of kernels B5' and B7 (``csrc/vit_attn_f32.cu``, route
``tf32x3``) on the CPU: its arithmetic, emulated in numpy, against the JAX
package's Pallas kernels at float32; the route choice of the port's
wrappers; and the source's kernel names and constants against the Python
ones. The kernel itself runs only on a card: tests/test_torch_gpu_b6_b7.py
and tests/test_torch_gpu_step2_mesh.py hold it against the plain version
there.

The emulation follows the kernel step by step: hi = tf32(a) and lo =
tf32(a - hi) of q, k, p and v by the kernel's integer add and mask; each
product as lo hi + hi lo + hi hi; keys in tiles of ``TF32X3_KEYS`` with the
online rescaling (exp2 of the scores times scale log2 e, less the running
max); each 8-deep step of a product (8 terms of a score's d, 8 keys of p
v) summed apart and added in f32; one division at the end. Sums inside a
step are exact (float64), rounded once to f32: the card's own accumulation
is held to the plain version by the GPU tests.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import vit_attn as jax_va
from acmil_tpu.ops import vit_attn_packed as jax_packed
from acmil_tpu_torch.ops import _build
from acmil_tpu_torch.ops import vit_attn as port
from acmil_tpu_torch.ops import vit_attn_packed as port_packed

# the kernel against the JAX kernels, relative to the largest output: the
# tolerance the card's route is held to (chip_smoke.py's B7_F32_TOL)
B7_F32_TOL = 1e-5
HEAD_DIMS = (16, 32, 64, 128)
TOKENS = (1, 63, 64, 65, 197, 577, 785)
# the depth of one mma.sync.m16n8k8 step: the kernel sums each step's
# product apart
STEP = 8
LOG2E = np.float32(1.4426950408889634)
SRC = _build.CSRC / "vit_attn_f32.cu"


def _tf32(a):
    """a rounded to TF32 as the kernel does it: add 0x1000 to the bits and
    clear the low 13 (to nearest, ties away from 0)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _split(a):
    hi = _tf32(a)
    return hi.astype(np.float64), _tf32(a - hi).astype(np.float64)


def _x3(a, b):
    """a @ b from the (hi, lo) splits of a and b: lo hi + hi lo + hi hi,
    summed exactly and rounded once to f32."""
    (ah, al), (bh, bl) = a, b
    return ((al @ bh + ah @ bl) + ah @ bh).astype(np.float32)


def _tf32x3_attention(q, k, v, scale, keys=port_packed.TF32X3_KEYS):
    """The kernel's arithmetic on float32 q, k, v ``[..., N, dh]``."""
    n, dh = q.shape[-2:]
    c = np.float32(scale) * LOG2E
    qs = _split(q)
    kts = [t.swapaxes(-1, -2) for t in _split(k)]
    vs = _split(v)
    lead = q.shape[:-2]
    m = np.full(lead + (n, 1), -np.inf, np.float32)
    l = np.zeros(lead + (n, 1), np.float32)
    acc = np.zeros(q.shape, np.float32)
    for k0 in range(0, n, keys):
        k1 = min(k0 + keys, n)
        s = np.zeros(lead + (n, k1 - k0), np.float32)
        for d0 in range(0, dh, STEP):
            d = slice(d0, d0 + STEP)
            s += _x3([t[..., d] for t in qs],
                     [t[..., d, k0:k1] for t in kts])
        mn = np.maximum(m, (s * c).max(-1, keepdims=True))
        alpha = np.exp2(m - mn)
        # exp2 of fma(s, c, -m): the product is exact in float64
        p = np.exp2((s.astype(np.float64) * np.float64(c)
                     - mn).astype(np.float32))
        l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        m = mn
        acc = acc * alpha
        ps = _split(p)
        for j0 in range(k0, k1, STEP):
            j = slice(j0 - k0, j0 - k0 + STEP)
            acc += _x3([t[..., j] for t in ps],
                       [t[..., j0:j0 + STEP, :] for t in vs])
    return acc / l


def _inputs(seed, shape):
    rs = np.random.RandomState(seed)
    return [(2 * rs.randn(*shape)).astype(np.float32) for _ in range(3)]


def _f64_attention(q, k, v, scale):
    """softmax(q k^T scale) v in float64: the function itself."""
    s = (q.astype(np.float64) @ k.astype(np.float64).swapaxes(-1, -2)) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v.astype(np.float64)


def _within(got, want, tol=B7_F32_TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err
    return err


@pytest.mark.parametrize("n", TOKENS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_emulated_route_matches_jax_fused_vit_attention(dh, n):
    # B7's call: separate q, k, v, scale 0.3 on 2 randn (scores up to ~100).
    # JAX's side is its reference, XLA's f32 dot: the Pallas kernel in
    # interpret mode sums each score in f32 in order, as far as 9.3e-6 of
    # the largest output from float64 at dh 128, N 785 (the route's
    # arithmetic: 4e-6), so two f32 orders there differ by ~1e-5
    q, k, v = _inputs(dh + n, (1, 2, n, dh))
    got = _tf32x3_attention(q, k, v, 0.3)
    _within(got, _f64_attention(q, k, v, 0.3))
    _within(got, np.asarray(jax_va._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3)))


@pytest.mark.parametrize("n", TOKENS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_emulated_route_matches_jax_fused_mha_packed(dh, n):
    # B5''s call: views of a packed qkv [B, N, 3D], scale 1/sqrt(dh), against
    # the Pallas kernel in interpret mode
    heads = 2
    rs = np.random.RandomState(100 + dh + n)
    qkv = (2 * rs.randn(1, n, 3 * heads * dh)).astype(np.float32)
    want = np.asarray(jax_packed.fused_mha_packed(jnp.asarray(qkv), heads))
    q, k, v = qkv.reshape(1, n, 3, heads, dh).transpose(2, 0, 3, 1, 4)
    got = _tf32x3_attention(q, k, v, 1.0 / math.sqrt(dh))
    _within(got, _f64_attention(q, k, v, 1.0 / math.sqrt(dh)))
    _within(got.transpose(0, 2, 1, 3).reshape(1, n, heads * dh), want)


def test_emulated_route_at_large_scores_is_nearer_float64_than_plain():
    # |s| up to ~300 (chip_smoke.py's inputs at dh 256, here at dh 128):
    # exp2 of s c - m, with s c exact in the fma, stays within the
    # tolerance of float64, where the plain f32 version (s scale rounded,
    # then exp) is further off than the route is
    q, k, v = _inputs(7, (1, 2, 197, 128))
    q *= 3.0
    truth = _f64_attention(q, k, v, 0.3)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    assert np.abs(s).max() > 150
    got = _within(_tf32x3_attention(q, k, v, 0.3), truth)
    plain = port._reference_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), 0.3).numpy()
    assert float(np.abs(plain - truth).max()) > got


def test_one_tf32_product_misses_the_tolerance():
    # the split has teeth: hi hi alone (plain TF32) is off by ~1e-3
    q, k, v = _inputs(3, (1, 2, 197, 64))
    want = np.asarray(jax_va._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3))
    s = (_tf32(q).astype(np.float64)
         @ _tf32(k).astype(np.float64).swapaxes(-1, -2)) * 0.3
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    got = _tf32(p.astype(np.float32)).astype(np.float64) @ _tf32(v)
    err = float(np.abs(got - want).max())
    assert err > 10 * B7_F32_TOL * float(np.abs(want).max()), err


def test_tf32_rounding_is_to_nearest_ties_away():
    a = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                     -(1.0 + 2.0 ** -10), 1.0], np.float32)
    np.testing.assert_array_equal(_tf32(a), want)
    f = np.random.RandomState(1).randn(1000).astype(np.float32)
    hi, lo = _split(f)
    rest = np.abs(f.astype(np.float64) - hi - lo) / np.abs(f)
    assert rest.max() <= 2.0 ** -21


def _views(dtype, dh, n=50, heads=3):
    qkv = torch.zeros(2, n, 3, heads, dh, dtype=dtype)
    return qkv.permute(2, 0, 3, 1, 4)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_route_f32_at_the_kernel_widths_aligned_is_tf32x3(dh):
    q = torch.zeros(2, 3, 50, dh)
    assert port._route(q, q, q, q) == "tf32x3"
    q, k, v = _views(torch.float32, dh)
    out = torch.empty(2, 50, 3 * dh).view(2, 50, 3, dh).transpose(1, 2)
    assert port._route(q, k, v, out) == "tf32x3"
    qkv = torch.zeros(2, 50, 3 * 3 * dh)
    assert port_packed._packed_route(qkv, 3) == "tf32x3"


@pytest.mark.parametrize("dh", [48, 80])
def test_route_f32_off_the_kernel_widths_is_fma(dh):
    q = torch.zeros(2, 3, 50, dh)
    assert port._route(q, q, q, q) == "fma"
    assert port._route(*_views(torch.float32, dh), q) == "fma"
    assert port_packed._packed_route(torch.zeros(2, 50, 3 * 2 * dh), 2) \
        == "fma"


def test_route_f32_unaligned_view_is_fma():
    # a token stride of 66 floats: rows not on 16-byte boundaries
    wide = torch.zeros(2, 3, 50, 66)[..., :64]
    q = torch.zeros(2, 3, 50, 64)
    assert port._route(wide, q, q, q) == "fma"
    assert port._route(q, q, q, wide) == "fma"
    # a base 4 bytes past a 16-byte boundary
    flat = torch.zeros(1 + 2 * 3 * 50 * 64)
    off = flat[1:].view(2, 3, 50, 64)
    assert off.data_ptr() % 16 and port._route(q, off, q, q) == "fma"


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_route_half_dtypes_at_dh_64_is_mma(dtype):
    q = torch.zeros(2, 3, 50, 64, dtype=dtype)
    assert port._route(q, q, q, q) == "mma"
    assert port_packed._packed_route(torch.zeros(2, 50, 3 * 128,
                                                 dtype=dtype), 2) == "mma"


def test_route_float16_at_dh_80_is_fma():
    q = torch.zeros(2, 3, 50, 80, dtype=torch.float16)
    assert port._route(q, q, q, q) == "fma"
    assert port_packed._packed_route(torch.zeros(2, 50, 3 * 160,
                                                 dtype=torch.float16), 2) \
        == "fma"


def test_route_counters_name_the_route():
    assert set(port.fused_vit_attention.route_launches) == {
        "mma", "tf32x3", "fma"}
    assert "tf32x3" in port_packed._launch_packed.route_launches


def test_kernel_names_and_constants_match_the_source():
    src = SRC.read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", src)
    assert tuple(names) == port_packed.TF32X3_KERNELS
    assert f"constexpr int kQ = {port_packed.TF32X3_QUERIES};" in src
    assert f"constexpr int kK = {port_packed.TF32X3_KEYS};" in src
    # each step's product: lo hi + hi lo + hi hi, the small terms first
    assert re.search(r"tf32x3::mma\(d, al, bh\);\s*tf32x3::mma\(d, ah, bl\);"
                     r"\s*tf32x3::mma\(d, ah, bh\);", src)
    assert f"constexpr float kLog2e = {float(LOG2E)!r}" in src \
        or "constexpr float kLog2e = 1.4426950408889634f;" in src
    # the head widths the entry launches are the tensor-core widths
    entry = src[src.index("int b7_mha_tf32x3("):]
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", entry))
    assert cases == port_packed.KERNEL_HEAD_DIMS
    # the entry's arguments in the order the wrapper passes them
    sig = re.search(r"int b7_mha_tf32x3\(([^)]*)\)", src).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    ops = [[f"{x}", f"{x}_sb", f"{x}_sh", f"{x}_st"] for x in "qkv"]
    assert params == [*ops[0], *ops[1], *ops[2], "out", "o_sb", "o_sh",
                      "o_st", "batch", "heads", "n", "dh", "scale", "stream"]
