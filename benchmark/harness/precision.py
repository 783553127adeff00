"""Rounding of a product's operands to a lower precision, by the same rule
on the CPU and on the card: the controls of the comparisons (the plain
reference computed one precision below what the configuration states) and
the references themselves (``f32``: no rounding)."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10-bit mantissa, to nearest, ties to even:
    what the tensor cores take of an f32 operand with TF32 on."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at the format's largest finite value), as an fp8
    product takes a per-tensor scaled operand."""
    x = x.float()
    scale = (x.abs().amax() / FP8_MAX).clamp_min(1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"f32": lambda x: x.float(), "tf32": tf32, "fp8": fp8}


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in f32 on operands rounded to ``prec``."""
    r = ROUND[prec]
    return r(a) @ r(b)


@contextlib.contextmanager
def exact_f32():
    """f32 products without TF32 on the card (and cuDNN without it), the
    settings put back afterwards."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32, torch.get_float32_matmul_precision())
    m.allow_tf32 = c.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved[0], saved[1]
        torch.set_float32_matmul_precision(saved[2])
