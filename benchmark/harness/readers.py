"""Arithmetic the per-layer readers share (``benchmark/metrics/``)."""

from __future__ import annotations

from typing import Optional

from harness.common import share_pct


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced window in which no kernel, copy or set ran on
    the card."""
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def head_dims(ctx):
    h = ctx.cell.config["head"]
    return h["D_feat"], h["D_inner"], h["D_attn"], h["n_token"], h["n_class"]


def trunk_dims(ctx):
    t = ctx.cell.config["trunk"]
    return t["img_size"], t["patch"], t["dim"], t["depth"], t["mlp_hidden"]


def images(ctx) -> int:
    return ctx.work["batches"] * ctx.work["batch_size"]


def trunk_bound_pct(ctx, family: str, work) -> Optional[float]:
    """A trunk kernel family's roofline share: the least time of ``work``
    (operations, bytes) at the trunk's stated peak and the memory's rate,
    over the family's device time."""
    peaks = ctx.peaks()
    ops, nbytes = work
    bound = max(ops / peaks[ctx.cell.config["trunk"]["peak"]],
                nbytes / peaks["hbm_bytes_per_s"])
    return share_pct(bound, ctx.family_seconds(family))
