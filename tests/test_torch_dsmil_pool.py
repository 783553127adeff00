"""Kernel B6's port (acmil_tpu_torch/ops/dsmil_pool.py) against the JAX
package's DSMIL pooling: its Pallas kernel in interpret mode and its plain
reference, on the same numpy inputs.

On CPU tensors the port's wrapper takes its plain version; the CUDA kernel
is held against that plain version on the card (tests/test_torch_gpu_b6_b7.py
and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmil_tpu.ops import dsmil_pool as jax_dp
from acmil_tpu_torch.ops import dsmil_pool as port

# f32 on both sides; the interpret-mode kernel sums over its N chunks and
# torch over the whole bag, in other orders: the JAX package's own bound for
# its kernel against its reference (tests/test_attn_pool.py)
ATOL, RTOL = 1e-4, 1e-4


def _inputs(seed, b=2, n=512, d=48, q=16, c=3, fp16=False, dead_bag=False):
    rs = np.random.RandomState(seed)
    feats = rs.randn(b, n, d).astype(np.float16 if fp16 else np.float32)
    mask = rs.rand(b, n) < 0.8
    mask[-1, n // 2:] = False                  # a padded tail
    if dead_bag:
        mask[0] = False                        # an all-masked bag
    wq = (rs.randn(d, q) * 0.3).astype(np.float32)
    bq = (rs.randn(q) * 0.1).astype(np.float32)
    q_max = rs.randn(b, c, q).astype(np.float32)
    return feats, mask, wq, bq, q_max


def _jax(feats, mask, wq, bq, q_max, chunk=128):
    # the JAX caller (dsmil_eval_fused) casts fp16 features to f32: exact
    args = (jnp.asarray(feats.astype(np.float32)), jnp.asarray(mask),
            jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(q_max))
    kern = jax_dp.fused_dsmil_pool(*args, chunk=chunk, interpret=True)
    ref = jax_dp.dsmil_pool_reference(*args)
    return [tuple(np.asarray(t) for t in out) for out in (kern, ref)]


def _check(got, want, mask):
    bag, logits = (t.numpy() for t in got)
    np.testing.assert_allclose(bag, want[0], atol=ATOL, rtol=RTOL)
    valid = np.broadcast_to(mask[:, None, :], logits.shape)
    np.testing.assert_allclose(logits[valid], want[1][valid], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("c, fp16, dead_bag", [
    (3, False, False), (1, False, True), (3, True, True), (1, True, False)])
def test_port_matches_jax_kernel_and_reference(c, fp16, dead_bag):
    # N = 512 in chunks of 128: the Pallas kernel's online softmax runs over
    # four chunks
    feats, mask, wq, bq, q_max = _inputs(0, c=c, fp16=fp16, dead_bag=dead_bag)
    kern, ref = _jax(feats, mask, wq, bq, q_max)
    t = [torch.from_numpy(a) for a in (feats, mask, wq, bq, q_max)]
    routed = port.fused_dsmil_pool(*t)
    plain = port.dsmil_pool_reference(t[0].float(), *t[1:])
    for got in (routed, plain):
        assert got[0].dtype == got[1].dtype == torch.float32
        assert got[0].shape == (2, c, 48) and got[1].shape == (2, c, 512)
        _check(got, kern, mask)
        _check(got, ref, mask)
        # masked rows hold NEG in the logits, as the Pallas kernel's do
        valid = np.broadcast_to(mask[:, None, :], got[1].shape)
        assert (got[1].numpy()[~valid] == port.NEG).all()
    if dead_bag:
        assert not routed[0][0].any() and not routed[0].isnan().any()


def test_ragged_n_matches_jax():
    # N not a multiple of the JAX chunk: its wrapper pads, the port does not
    feats, mask, wq, bq, q_max = _inputs(1, b=1, n=300, d=32, q=8, c=2)
    kern, _ = _jax(feats, mask, wq, bq, q_max, chunk=128)
    got = port.fused_dsmil_pool(*(torch.from_numpy(a) for a in
                                  (feats, mask, wq, bq, q_max)))
    _check(got, kern, mask)


@pytest.mark.parametrize("c", [1, 8, 9, 16, 128])
def test_port_matches_jax_kernel_at_many_classes(c):
    # kernel B6 takes classes in groups of 8 a block: one group, a full
    # group, a group and a remainder, two groups, sixteen groups
    feats, mask, wq, bq, q_max = _inputs(4, n=300, c=c, fp16=True)
    kern, ref = _jax(feats, mask, wq, bq, q_max)
    args = [torch.from_numpy(a) for a in (feats, mask, wq, bq, q_max)]
    port._check_kernel_args(*args)
    got = port.fused_dsmil_pool(*args)
    assert got[0].shape == (2, c, 48) and got[1].shape == (2, c, 300)
    _check(got, kern, mask)
    _check(got, ref, mask)


def test_cpu_route_launches_no_kernel():
    before = port.fused_dsmil_pool.launches
    port.fused_dsmil_pool(*(torch.from_numpy(a) for a in _inputs(2, n=64)))
    assert port.fused_dsmil_pool.launches == before


def _torch_inputs(**kw):
    return [torch.from_numpy(a) for a in _inputs(3, **kw)]


@pytest.mark.parametrize("change, match", [
    (dict(c=129), "C <= 128"),
    (dict(d=44), "multiple of 8"),
    (dict(d=1544), "up to 1536"),
])
def test_kernel_arg_check_rejects_widths(change, match):
    kw = dict(n=16, q=8)
    kw.update(change)
    with pytest.raises(ValueError, match=match):
        port._check_kernel_args(*_torch_inputs(**kw))


def test_kernel_arg_check_rejects_types():
    feats, mask, wq, bq, q_max = _torch_inputs(n=16)
    with pytest.raises(ValueError, match="float16 or float32"):
        port._check_kernel_args(feats.double(), mask, wq, bq, q_max)
    with pytest.raises(ValueError, match="mask must be bool"):
        port._check_kernel_args(feats, mask.int(), wq, bq, q_max)
    with pytest.raises(ValueError, match="wq must be float32"):
        port._check_kernel_args(feats, mask, wq.half(), bq, q_max)
    with pytest.raises(ValueError, match="q_max must be float32"):
        port._check_kernel_args(feats, mask, wq, bq, q_max[:1])


def test_kernel_arg_check_accepts_every_pretrain_width():
    # every (D_feat, D_inner) pair of config.PRETRAIN_DIMS, C up to 128
    from acmil_tpu_torch.config import PRETRAIN_DIMS

    for d, q in sorted(set(PRETRAIN_DIMS.values())):
        for c in (2, 4, 8, 9, 128):
            feats = torch.zeros(1, 8, d, dtype=torch.float16)
            port._check_kernel_args(feats, torch.ones(1, 8, dtype=torch.bool),
                                    torch.zeros(d, q), torch.zeros(q),
                                    torch.zeros(1, c, q))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 65536])
def test_b6_ranges_cover_each_bag_once_in_order(n, b):
    # at C <= 8; tests of the split-TF32 route's ranges below
    ranges, range_tiles = port._b6_ranges(b, n)
    assert 1 <= ranges <= port._B6_MAX_RANGES and range_tiles >= 1
    rows = range_tiles * port._B6_TILE
    spans = [(r * rows, min(n, (r + 1) * rows)) for r in range(ranges)]
    # every range holds rows, each follows the last, and together they are
    # [0, N): the C entry's condition on (ranges, range_tiles)
    assert all(lo < hi for lo, hi in spans)
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    assert ranges * rows >= n > (ranges - 1) * rows
    # about two waves of blocks over all bags, never more ranges than tiles
    assert ranges <= -(-n // port._B6_TILE)
    assert b * ranges <= port._B6_BLOCKS + b * range_tiles


@pytest.mark.parametrize("b, n, d, c", [(1, 65536, 384, 2), (3, 300, 1024, 9),
                                        (2, 65, 1536, 128), (1, 1, 8, 1)])
def test_b6_workspace_layout(b, n, d, c):
    ranges, _ = port._b6_ranges(b, n)
    layout, total = port._b6_workspace_layout(b, n, d, c, ranges)
    want = {"u": (b, c, d), "beta": (b, c), "part_m": (b, ranges, c),
            "part_s": (b, ranges, c), "part_acc": (b, ranges, c, d)}
    assert [name for name, *_ in layout] == list(want)
    end = 0
    for name, dtype, shape, offset in layout:
        assert shape == want[name]
        assert dtype == torch.float32
        # every buffer 16-byte aligned (the kernels' vector and bulk copies),
        # in order, none overlapping the last
        assert offset % 16 == 0 and offset % port._ALIGN == 0
        assert offset >= end
        end = offset + int(np.prod(shape)) * dtype.itemsize
    assert end <= total and total % port._ALIGN == 0


def _kernel_names(source):
    """Names of the __global__ functions in a CUDA source."""
    import re

    from acmil_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
    return set(re.findall(rf"__global__ void(?:\s+{bounds})?\s+(\w+)\(",
                          text))


def test_b6_kernel_names_are_the_sources_kernels():
    # chip_smoke.py and the variants script profile B6 by these names, and a
    # profile matches names by substring: no B6 name is part of another
    # kernel's name, in B6 or in any other source, nor the other way round
    from acmil_tpu_torch.ops import _build

    assert set(port.B6_KERNELS) == _kernel_names("dsmil_pool.cu")
    others = set()
    for src in sorted(_build.CSRC.glob("*.cu*")):
        if src.name != "dsmil_pool.cu":
            others |= _kernel_names(src.name)
    assert others
    for name in port.B6_KERNELS:
        assert [k for k in port.B6_KERNELS if name in k] == [name]
        assert not any(name in o or o in name for o in others)


def test_b6_constants_and_entry_match_the_source():
    import re

    from acmil_tpu_torch.ops import _build

    src = (_build.CSRC / "dsmil_pool.cu").read_text()
    assert f"constexpr int kTile = {port._B6_TILE};" in src
    assert f"constexpr int kMaxRanges = {port._B6_MAX_RANGES};" in src
    assert f"constexpr int kMaxClasses = {port.KERNEL_MAX_C};" in src
    assert f"constexpr int kMaxD = {port.KERNEL_MAX_D};" in src
    # the row kernel's widest D at each class count: 256 columns times
    # rows_units(rows_nc(C))
    assert f"constexpr int kRowsMaxC = {max(port._B6_ROWS_MAX_D)};" in src
    assert "return nc == 1 ? 6 : 8 / nc;" in src
    assert "return c == 1 ? 1 : c == 2 ? 2 : 4;" in src
    assert "return c <= kRowsMaxC && d <= 256 * rows_units(rows_nc(c));" in src
    for c, d in port._B6_ROWS_MAX_D.items():
        nc = 1 if c == 1 else 2 if c == 2 else 4
        assert d == 256 * (6 if nc == 1 else 8 // nc)
    # the entry takes the workspace's buffers in the layout's order, between
    # the outputs and the widths
    sig = re.search(r"int b6_dsmil_pool\(([^)]*)\)", src).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    layout, _ = port._b6_workspace_layout(1, 64, 8, 1, 1)
    i = params.index("bag") + 1
    assert params[i:i + len(layout)] == [name for name, *_ in layout]
    assert params[i + len(layout)] == "batch"


@pytest.mark.parametrize("n", [65, 16896, 65536])
def test_b6_ranges_of_the_split_tf32_route_aim_at_one_wave(n):
    two, _ = port._b6_ranges(1, n)
    one, tiles1 = port._b6_ranges(1, n, rows_route=False)
    assert one * tiles1 * port._B6_TILE >= n > (one - 1) * tiles1 * port._B6_TILE
    assert one <= port._B6_BLOCKS // 2 and one <= two


@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1536])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8, 9, 128])
def test_b6_rows_route(c, d):
    # the row kernel where its registers hold all of D: the configs' 2-4
    # classes up to D = 512, 2 classes up to UNI's 1024, 1 class at any D
    want = c == 1 or (c == 2 and d <= 1024) or (c <= 4 and d <= 512)
    assert port._b6_rows_route(c, d) == want
