"""What the per-layer readers share: a layer's roofline share from the
profile, the whole step's share of the peak, the device's idle share."""

from __future__ import annotations

from typing import Optional, Tuple

from port_bench.benchlib import flops


def roofline(ctx, kernels: str, scope: Optional[str], cost: Tuple[int, int]) -> Optional[float]:
    """The layer's least time a step (``cost``: its FLOPs and bytes a step,
    :func:`..flops.least_seconds`) over the device time of its kernels
    (names matching ``kernels``, under host ops matching ``scope``) a step,
    in percent; None where the profile holds none of them."""
    seconds, count = ctx.trace.kernels(kernels, scope)
    if count == 0 or seconds <= 0:
        return None
    least = flops.least_seconds(cost, ctx.peak_flops, ctx.peak_bytes)
    return 100.0 * least * ctx.trace.steps / seconds


def mfu(ctx, step_flops: int) -> float:
    """The window's model FLOPs over the window at the peak, in percent."""
    return 100.0 * step_flops * ctx.steps / (ctx.window_s * ctx.peak_flops)


def idle_share(ctx) -> Optional[float]:
    """The share of the traced window in which no device operation ran, in
    percent; None where none ran."""
    span, busy = ctx.trace.span_s(), ctx.trace.busy_s()
    return None if span <= 0 or busy <= 0 else 100.0 * (1.0 - busy / span)
