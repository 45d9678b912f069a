"""Small building blocks (master_thesis_tpu/models/nn_ext.py).

Counterparts: ``leaky_relu``, ``_uniform`` (here :func:`uniform_`),
``Conv`` (here a ``nn.Conv2d`` that computes in a chosen dtype; the JAX
space-to-depth regrouping of strided convs is a TPU layout trick and is not
ported), ``ConvTranspose2dTorch`` (a ``nn.ConvTranspose2d`` likewise; its
JAX 4-phase rewrite is a TPU layout trick too),
``fused_upsample_conv_kernel``, ``pixel_shuffle_2x`` and
``conv_phase_s2d`` (the hybrid DFPN routes' regrouping of a stride-1 conv,
one ``F.conv2d``).

Inside the port, activations are NCHW; kernels of the JAX package's
``fused_upsample_conv_kernel`` are HWIO, and that layout is kept here.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    """Fills ``t`` in place with uniform(-bound, bound) drawn from ``generator``
    on the CPU (so one seed gives the same weights on every device)."""
    with torch.no_grad():
        vals = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_((vals * 2 - 1) * bound)
    return t


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters that computes in ``dtype``.

    Mirrors ``nn_ext.Conv``: operands are cast to the compute dtype and the
    bias is added in it. ``generator`` draws the kaiming-uniform init
    (bound ``sqrt(3 / fan_in)``, the torch default the JAX module copies).
    """

    def __init__(
        self, in_c: int, out_c: int, k: int, stride: int = 1, padding: int = 0,
        dilation: int = 1, *, generator: torch.Generator, dtype: torch.dtype = torch.float32,
    ):
        super().__init__(in_c, out_c, k, stride=stride, padding=padding, dilation=dilation,
                         device="meta")
        self.weight = nn.Parameter(torch.empty(out_c, in_c, k, k))
        self.bias = nn.Parameter(torch.empty(out_c))
        bound = (3.0 / (in_c * k * k)) ** 0.5
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
            self.padding, self.dilation,
        )


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with f32 parameters that computes in ``dtype``
    (``nn_ext.ConvTranspose2dTorch``): operands and bias cast to the
    compute dtype. Its weight ``(I, O, k, k)`` is the JAX HWIO kernel
    ``(k, k, I, O)`` permuted by ``(2, 3, 0, 1)``, not flipped. The init
    bound is ``sqrt(3 / (O * k * k))``: torch takes the fan from
    ``weight.size(1)``, which is O for a transposed conv.
    """

    def __init__(
        self, in_c: int, out_c: int, k: int, stride: int = 2, padding: int = 1,
        output_padding: int = 1, *, generator: torch.Generator, dtype: torch.dtype = torch.float32,
    ):
        super().__init__(in_c, out_c, k, stride=stride, padding=padding,
                         output_padding=output_padding, device="meta")
        self.weight = nn.Parameter(torch.empty(in_c, out_c, k, k))
        self.bias = nn.Parameter(torch.empty(out_c))
        bound = (3.0 / (out_c * k * k)) ** 0.5
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding,
            self.output_padding,
        )


def fused_upsample_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 HWIO kernel applied after nearest-2x upsampling, rewritten as
    one low-resolution 4-phase kernel ``(3, 3, C, 4*O)``, phases packed in
    output channels as ``(a, b, o)`` (nn_ext.py:76).

    ``conv3x3(pad1(up2x(y)))[2i+a, 2j+b] = sum W[ki,kj] *
    y[i + floor((a+ki-1)/2), j + floor((b+kj-1)/2)]``.
    """
    c, o = w.shape[2], w.shape[3]
    out = torch.zeros((3, 3, c, 2, 2, o), dtype=w.dtype, device=w.device)
    for a in (0, 1):
        for b in (0, 1):
            for ki in range(3):
                for kj in range(3):
                    di = (a + ki - 1) // 2
                    dj = (b + kj - 1) // 2
                    out[di + 1, dj + 1, :, a, b, :] += w[ki, kj]
    return out.reshape(3, 3, c, 4 * o)


def pixel_shuffle_2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``(N, 4*O, h, w)`` with ``(a, b, o)`` channel packing ->
    ``(N, O, 2h, 2w)`` (nn_ext.py:100).

    Written out because ``F.pixel_shuffle`` expects the ``(o, a, b)``
    packing.
    """
    n, c4, h, w = x.shape
    o = c4 // 4
    x = x.reshape(n, 2, 2, o, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, o, 2 * h, 2 * w)


@functools.lru_cache(maxsize=None)
def _phase_taps(kh: int, kw: int, s: int, pad_h: int, pad_w: int,
                device: torch.device) -> Tuple[torch.Tensor, int, int, int, int]:
    """The regrouped kernel of :func:`conv_phase_s2d` as tap indices:
    ``(A_y, A_x, q_y, q_x, p_y, p_x)`` -> the original tap ``ky * kw + kx``
    that low-resolution tap ``(a_y, a_x)`` reads from input phase ``(q_y,
    q_x)`` for output phase ``(p_y, p_x)``, or ``kh * kw`` (a zero tap)
    where none does; and the low-resolution window ``lo_y, hi_y, lo_x,
    hi_x`` (JAX ``nn_ext.py:180-193``). Made once per geometry and device,
    so a call on the card copies no index from the host."""
    lo_y, hi_y = (0 - pad_h) // s, (s - 1 + kh - 1 - pad_h) // s
    lo_x, hi_x = (0 - pad_w) // s, (s - 1 + kw - 1 - pad_w) // s
    idx = torch.full((hi_y - lo_y + 1, hi_x - lo_x + 1, s, s, s, s), kh * kw, dtype=torch.long)
    for py in range(s):
        for ky in range(kh):
            a_y, q_y = divmod(py + ky - pad_h, s)
            for px in range(s):
                for kx in range(kw):
                    a_x, q_x = divmod(px + kx - pad_w, s)
                    idx[a_y - lo_y, a_x - lo_x, q_y, q_x, py, px] = ky * kw + kx
    return idx.to(device), lo_y, hi_y, lo_x, hi_x


def conv_phase_s2d(x: torch.Tensor, weight: torch.Tensor, s: int, pad_h: int, pad_w: int,
                   dtype: torch.dtype, shuffle_out: bool = True) -> torch.Tensor:
    """A stride-1 ``k x k`` conv of NHWC ``x (N, H, W, C)`` (H and W
    multiples of ``s``) with the OIHW ``weight (O, C, kh, kw)`` and zero
    padding ``pad_h, pad_w``, as space-to-depth by ``s``, one dense
    low-resolution ``F.conv2d`` in ``dtype``, then a pixel shuffle
    (``nn_ext.conv_phase_s2d``): the same products, regrouped. Input
    channels are packed ``(q_y, q_x, c)``, output channels ``(p_y, p_x,
    o)``. No bias. Returns NHWC ``(N, H, W, O)``, or with ``shuffle_out=False``
    the phase-packed ``(N, H/s, W/s, s*s*O)`` map (a following 2x2 max-pool
    is then a max over the phase groups)."""
    b, hh, ww, c = x.shape
    o, _, kh, kw = weight.shape
    idx, lo_y, hi_y, lo_x, hi_x = _phase_taps(kh, kw, s, pad_h, pad_w, weight.device)
    ay, ax = idx.shape[:2]
    taps = weight.permute(2, 3, 1, 0).reshape(kh * kw, c, o)
    taps = torch.cat([taps, taps.new_zeros(1, c, o)])
    # (A_y, A_x, q_y, q_x, p_y, p_x, C, O) -> (A_y, A_x, q_y, q_x, C, p_y, p_x, O):
    # rows (q, c), columns (p, o), then OIHW.
    w4 = taps[idx].permute(0, 1, 2, 3, 6, 4, 5, 7)
    w4 = w4.reshape(ay, ax, s * s * c, s * s * o).permute(3, 2, 0, 1)
    x4 = x.reshape(b, hh // s, s, ww // s, s, c).permute(0, 1, 3, 2, 4, 5)
    x4 = x4.reshape(b, hh // s, ww // s, s * s * c).permute(0, 3, 1, 2)
    x4, w4 = x4.to(dtype), w4.to(dtype)
    if (-lo_y, -lo_x) == (hi_y, hi_x):
        y4 = F.conv2d(x4, w4, padding=(hi_y, hi_x))
    else:
        y4 = F.conv2d(F.pad(x4, (-lo_x, hi_x, -lo_y, hi_y)), w4)
    y4 = y4.permute(0, 2, 3, 1)
    if not shuffle_out:
        return y4
    n, h4, w4_, _ = y4.shape
    y4 = y4.reshape(n, h4, w4_, s, s, o).permute(0, 1, 3, 2, 4, 5)
    return y4.reshape(n, h4 * s, w4_ * s, o)
