"""VGG-16 pool-feature extractor (master_thesis_tpu/models/vgg.py:
VGGFeatures, normalize_imagenet) and the ImageNet constants.

:class:`VGGFeatures` returns the five post-pool maps the CHN perceptual
loss reads. Its convs sit at torchvision's ``features.{idx}`` positions, so
a torchvision ``vgg16`` state dict loads as it is. They are plain convs
(cuDNN on the card): the JAX package computes them outside Pallas on the
serving and training paths.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from master_thesis_tpu_torch.device import constant, resolve_device
from master_thesis_tpu_torch.models.nn_ext import Conv

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision cfg 'D': conv widths with 'M' max-pool separators.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the trailing RGB channel axis."""
    mean = constant(IMAGENET_MEAN, x.dtype, x.device)
    std = constant(IMAGENET_STD, x.dtype, x.device)
    return (x - mean) / std


class VGGFeatures(nn.Module):
    """VGG-16 tower: NHWC ``(N, H, W, 3)`` -> the five post-pool maps, NHWC,
    in the compute dtype. Parameters f32, drawn from ``generator``."""

    def __init__(
        self, *, dtype: torch.dtype = torch.float32, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        layers: List[nn.Module] = []
        in_c = 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv(in_c, v, 3, 1, 1, generator=gen, dtype=dtype), nn.ReLU()]
                in_c = v
        self.features = nn.Sequential(*layers)
        self.dtype = dtype
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, normalize_input: bool = True) -> List[torch.Tensor]:
        if normalize_input:
            x = normalize_imagenet(x)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                feats.append(x.permute(0, 2, 3, 1))
        return feats
