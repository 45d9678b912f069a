"""LPIPS perceptual metric (master_thesis_tpu/models/lpips.py:
AlexNetFeatures, LPIPS, lpips_distance; the ``lpips`` package the
reference evaluates with, utils.py:450-463).

AlexNet variant: the five post-ReLU maps of torchvision's ``alexnet``
``features`` tower, each unit-normalised over its channels, squared
differences, a learned 1x1 head, the spatial mean, summed over the five.
Images are NHWC in [0, 1]; :func:`lpips_distance` feeds ``2 y - 1`` as the
reference does.

Module names give the keys of the JAX package's single-file export
(``net.features.{0,3,6,8,10}.weight/bias``, ``lin{i}.model.1.weight``, the
lpips package's head names), so such a file loads with ``load_state_dict``.
The metric's weights (``alex.pth`` and the AlexNet trunk) are not in the
repository; :func:`..train.build.build_lpips` returns None without them.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from master_thesis_tpu_torch.device import constant, resolve_device
from master_thesis_tpu_torch.models.nn_ext import Conv, uniform_

# lpips.ScalingLayer constants (inputs in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# (out channels, kernel, stride, padding) of AlexNet's five convs, and
# their positions in torchvision's ``features``.
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_ALEX_IDX = (0, 3, 6, 8, 10)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``features``: NCHW in, the 5 post-ReLU maps out."""

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        layers: List[nn.Module] = []
        in_c = 3
        for i, (c, k, s, p) in enumerate(_ALEX_CONVS):
            if i in (1, 2):
                layers.append(nn.MaxPool2d(3, 2))
            layers += [Conv(in_c, c, k, s, p, generator=generator, dtype=dtype), nn.ReLU()]
            in_c = c
        self.features = nn.Sequential(*layers)
        assert [i for i, m in enumerate(self.features) if isinstance(m, Conv)] == list(_ALEX_IDX)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                feats.append(x)
        return feats


class NetLinLayer(nn.Module):
    """A 1x1 head without bias, at the lpips package's ``model.1``."""

    def __init__(self, in_c: int, *, generator: torch.Generator):
        super().__init__()
        conv = nn.Conv2d(in_c, 1, 1, bias=False)
        uniform_(conv.weight, (3.0 / in_c) ** 0.5, generator)
        self.model = nn.Sequential(nn.Identity(), conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.float())


class LPIPS(nn.Module):
    """Learned perceptual distance of two NHWC batches in [-1, 1] -> ``(N,)``.
    Parameters f32 from ``generator`` (seed 0 by default); ``dtype`` is the
    trunk's compute dtype; the heads compute in f32."""

    def __init__(self, *, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.net = AlexNetFeatures(generator=gen, dtype=dtype)
        for i, (c, *_) in enumerate(_ALEX_CONVS):
            setattr(self, f"lin{i}", NetLinLayer(c, generator=gen))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = constant(_SHIFT, x.dtype, x.device)
        scale = constant(_SCALE, x.dtype, x.device)
        fx = self.net(((x - shift) / scale).permute(0, 3, 1, 2))
        fy = self.net(((y - shift) / scale).permute(0, 3, 1, 2))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a.float(), dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b.float(), dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


def lpips_distance(lpips: LPIPS, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean LPIPS over a batch of [0, 1] images (reference utils.py:450-463)."""
    return lpips(2 * y_hat - 1, 2 * y - 1).mean()
