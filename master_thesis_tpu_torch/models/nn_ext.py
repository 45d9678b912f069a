"""Small building blocks (master_thesis_tpu/models/nn_ext.py).

Counterparts: ``leaky_relu``, ``_uniform`` (here :func:`uniform_`),
``Conv`` (here a ``nn.Conv2d`` that computes in a chosen dtype; the JAX
space-to-depth regrouping of strided convs is a TPU layout trick and is not
ported), ``ConvTranspose2dTorch`` (a ``nn.ConvTranspose2d`` likewise; its
JAX 4-phase rewrite is a TPU layout trick too),
``fused_upsample_conv_kernel`` and ``pixel_shuffle_2x``.

Inside the port, activations are NCHW; kernels of the JAX package's
``fused_upsample_conv_kernel`` are HWIO, and that layout is kept here.
"""

from __future__ import annotations

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
        *, generator: torch.Generator, dtype: torch.dtype = torch.float32,
    ):
        super().__init__(in_c, out_c, k, stride=stride, padding=padding, device="meta")
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
            self.padding,
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
