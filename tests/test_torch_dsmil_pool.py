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
