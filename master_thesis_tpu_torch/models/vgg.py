"""VGG-16 pool-feature extractor (master_thesis_tpu/models/vgg.py:
VGGFeatures, normalize_imagenet, vgg_pool4_pallas, vgg_pool4_hybrid) and
the ImageNet constants.

:class:`VGGFeatures` returns the five post-pool maps the CHN perceptual
loss reads, and :meth:`VGGFeatures.pool4` the pool-4 map alone, which DFPN's
correlation reads (without computing block 5). Its convs sit at
torchvision's ``features.{idx}`` positions, so a torchvision ``vgg16``
state dict loads as it is. They are plain convs (cuDNN on the card), as
the JAX package computes them outside Pallas on the serving and training
paths; :func:`vgg_pool4_pallas` runs the pool-4 tower on the banded
conv-stack kernel K8 instead, and :func:`vgg_pool4_hybrid` block 1 as one
phase-packed conv whose 2x2 pool is a max over the phase groups (no
kernel: the JAX package computes it outside Pallas too).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from master_thesis_tpu_torch.device import constant, resolve_device
from master_thesis_tpu_torch.models.nn_ext import Conv, conv_phase_s2d
from master_thesis_tpu_torch.ops.conv_stack import StackCache, conv_stack_banded, refuse_grad_path

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision cfg 'D': conv widths with 'M' max-pool separators.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# ``features`` positions of the convs of blocks 1-4, and of the 4th pool.
_POOL4_BLOCKS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21))
_POOL4_END = 24


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
        self.stacks = StackCache()
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

    def pool4(self, x: torch.Tensor) -> torch.Tensor:
        """The pool-4 map ``(N, H/16, W/16, 512)`` of NHWC ``x``, which is
        already ImageNet-normalised (``forward(x, False)[3]``, block 5 not
        computed)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return self.features[:_POOL4_END](x).permute(0, 2, 3, 1)


def vgg_pool4_pallas(vgg: VGGFeatures, x: torch.Tensor) -> torch.Tensor:
    """:meth:`VGGFeatures.pool4` with each block's convs as one banded
    conv stack (K8, :func:`..ops.conv_stack.conv_stack_banded`) and the
    max-pools between them (``vgg_pool4_pallas``). ``x`` NHWC, already
    ImageNet-normalised. Forward only: under grad mode with a VGG parameter
    requiring grad it raises ``ValueError``."""
    refuse_grad_path(vgg, "vgg_pool4_pallas")
    x = x.to(vgg.dtype).contiguous()
    for i, block in enumerate(_POOL4_BLOCKS):
        convs = [vgg.features[j] for j in block]
        p = vgg.stacks.get(f"block{i + 1}", convs, [True] * len(convs), vgg.dtype)
        x = conv_stack_banded(x, p)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()
    return x


def vgg_pool4_hybrid(vgg: VGGFeatures, x: torch.Tensor) -> torch.Tensor:
    """:meth:`VGGFeatures.pool4` with block 1's second conv as one
    phase-packed conv (``vgg_pool4_hybrid``): conv_0 through its module;
    conv_1 as :func:`..nn_ext.conv_phase_s2d` unshuffled (``(py, px, o)``
    channels at half resolution) plus its f32 bias tiled four times, ReLU,
    and the 2x2 max-pool as the max over the four phase groups; blocks 2-4
    through their modules. ``x`` NHWC, already ImageNet-normalised. The
    product runs in the compute dtype, the bias and the max in f32, as in
    JAX."""
    conv_0, conv_1 = vgg.features[0], vgg.features[2]
    x = F.relu(conv_0(x.to(vgg.dtype).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    y4 = conv_phase_s2d(x, conv_1.weight, 2, 1, 1, vgg.dtype, shuffle_out=False)
    y4 = F.relu(y4 + conv_1.bias.repeat(4))
    n, h4, w4, _ = y4.shape
    x = y4.reshape(n, h4, w4, 4, -1).amax(dim=3)
    return vgg.features[5:_POOL4_END](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
