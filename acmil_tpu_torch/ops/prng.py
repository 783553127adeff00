"""JAX's ``jax.random.uniform(jax.random.PRNGKey(0), (B, N))`` in numpy,
bit for bit.

DTFD's eval forward groups a bag's patches into pseudo-bags by an argsort of
these uniforms (``acmil_tpu/models/dtfd.py``: with no rng, the model draws
them from ``PRNGKey(0)``), so every eval, predict and ``--eval_only`` score
depends on them. The port reproduces them here: the threefry2x32 block
cipher (20 rounds) under key (0, 0), with JAX's partitionable counters (the
flattened index split into its high and low 32 bits; JAX 0.9 sets
``jax_threefry_partitionable``), the two output words XORed, and the top 23
bits made a float in [1, 2), minus 1.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` (uint32 arrays)
    under ``key``; arithmetic wraps modulo 2^32."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform_key0(shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(0), shape)`` as float32."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32((0, 0), hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


def eval_uniforms(shape: Tuple[int, int], device) -> torch.Tensor:
    """:func:`uniform_key0` of ``shape`` as a float32 tensor on ``device``,
    computed once per (shape, device) and kept (for a few dozen pairs: the
    pad buckets of one run). Callers only read it."""
    return _eval_uniforms(tuple(int(s) for s in shape),
                          str(torch.device(device)))


@functools.lru_cache(maxsize=32)
def _eval_uniforms(shape: Tuple[int, ...], device: str) -> torch.Tensor:
    return torch.from_numpy(uniform_key0(shape)).to(device)
