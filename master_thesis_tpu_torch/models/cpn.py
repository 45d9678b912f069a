"""Copy-and-Paste Network affine aligner (master_thesis_tpu/models/cpn.py:
AEncoder, ARegressor, CPN.align).

Only ``align`` is on the inpainting path. Kept from the JAX version:

- the encoder normalizes, concatenates the mask, then resizes to 224²
  (cpn.py:46-47);
- the regressor applies conv5a/conv5b twice and never uses conv6a/conv6b
  (cpn.py:82-87); those dead weights have no parameters here;
- frames and visibility are warped together as one 4-channel ``[x, 1-m]``
  image with ``align_corners=False`` (cpn.py:134,150-154);
- ``v_aligned > 0.5`` (cpn.py:157) and ``v_maps`` (cpn.py:158).

Attribute names give the reference keys ``A_Encoder.<name>.conv.0`` and
``A_Regressor.fc``, read by ``master_thesis_tpu.models.convert.cpn_from_torch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from master_thesis_tpu_torch.device import constant, resolve_device
from master_thesis_tpu_torch.models.nn_ext import Conv, uniform_
from master_thesis_tpu_torch.models.vgg import IMAGENET_MEAN, IMAGENET_STD
from master_thesis_tpu_torch.ops.grid_sample import affine_grid, grid_sample
from master_thesis_tpu_torch.ops.interp import resize_hw


class _ConvBlock(nn.Module):
    """The reference's conv wrapper: the conv sits at ``conv.0``."""

    def __init__(self, in_c, out_c, k, stride, padding, *, generator, dtype):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(in_c, out_c, k, stride, padding, generator=generator, dtype=dtype)
        )

    def forward(self, x):
        return self.conv(x)


class AEncoder(nn.Module):
    """Alignment encoder: NHWC frame + mask -> NCHW ``(N, 256, 28, 28)``
    (reference model_cpn.py:121-150)."""

    _LAYERS = (
        ("conv12", 4, 64, 5, 2, 2), ("conv2", 64, 64, 3, 1, 1),
        ("conv23", 64, 128, 3, 2, 1), ("conv3", 128, 128, 3, 1, 1),
        ("conv34", 128, 256, 3, 2, 1), ("conv4a", 256, 256, 3, 1, 1),
        ("conv4b", 256, 256, 3, 1, 1),
    )

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        for name, ci, co, k, s, p in self._LAYERS:
            setattr(self, name, _ConvBlock(ci, co, k, s, p, generator=generator, dtype=dtype))

    def forward(self, in_f: torch.Tensor, in_v: torch.Tensor) -> torch.Tensor:
        mean = constant(IMAGENET_MEAN, in_f.dtype, in_f.device)
        std = constant(IMAGENET_STD, in_f.dtype, in_f.device)
        x = torch.cat([(in_f - mean) / std, in_v], dim=-1)
        x = resize_hw(x, (224, 224), align_corners=False)
        x = x.permute(0, 3, 1, 2)
        for name, *_ in self._LAYERS:
            x = F.relu(getattr(self, name)(x))
        return x


class ARegressor(nn.Module):
    """Affine regressor: two encodings -> ``(N, 2, 3)`` theta
    (reference model_cpn.py:153-174, conv5a/5b reuse included)."""

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        conv = lambda s: _ConvBlock(512, 512, 3, s, 1, generator=generator, dtype=dtype)
        self.conv45 = conv(2)
        self.conv5a = conv(1)
        self.conv5b = conv(1)
        self.conv56 = conv(2)
        self.fc = nn.Linear(512, 6, device="meta")
        self.fc.weight = nn.Parameter(uniform_(torch.empty(6, 512), 512 ** -0.5, generator))
        self.fc.bias = nn.Parameter(uniform_(torch.empty(6), 512 ** -0.5, generator))
        self.dtype = dtype

    def forward(self, feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([feat1, feat2], dim=1)
        for layer in (self.conv45, self.conv5a, self.conv5b, self.conv56, self.conv5a, self.conv5b):
            x = F.relu(layer(x))
        x = x.mean(dim=(2, 3))
        theta = F.linear(x, self.fc.weight.to(self.dtype), self.fc.bias.to(self.dtype))
        return theta.reshape(-1, 2, 3)


class CPN(nn.Module):
    """Affine alignment of reference frames onto a target frame.

    Parameters are f32 and drawn from ``generator`` (default seed 0);
    ``dtype`` is the compute dtype. ``device=None`` means ``cuda`` and
    raises without a card.
    """

    def __init__(
        self, *, dtype: torch.dtype = torch.float32, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.A_Encoder = AEncoder(generator=gen, dtype=dtype)
        self.A_Regressor = ARegressor(generator=gen, dtype=dtype)
        self.to(dev)

    def forward(self, x_target, m_target, x_refs, m_refs):
        return self.align(x_target, m_target, x_refs, m_refs)

    def align(
        self,
        x_target: torch.Tensor,
        m_target: torch.Tensor,
        x_refs: torch.Tensor,
        m_refs: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x_target (B, H, W, 3)``, ``m_target (B, H, W, 1)``,
        ``x_refs (B, F, H, W, 3)``, ``m_refs (B, F, H, W, 1)`` ->
        ``(x_aligned, v_aligned, v_maps)`` shaped like the refs."""
        b, f, h, w, c = x_refs.shape
        x_refs_flat = x_refs.reshape(b * f, h, w, c)
        m_refs_flat = m_refs.reshape(b * f, h, w, 1)

        feat_t = self.A_Encoder(x_target, m_target)
        feat_r = self.A_Encoder(x_refs_flat, m_refs_flat)
        feat_t_rep = feat_t[:, None].expand(b, f, *feat_t.shape[1:]).reshape(feat_r.shape)

        theta = self.A_Regressor(feat_t_rep, feat_r)
        grid = affine_grid(theta, (h, w), align_corners=False)
        warped = grid_sample(
            torch.cat([x_refs_flat, 1.0 - m_refs_flat], dim=-1), grid,
            align_corners=False,
        )
        x_aligned = warped[..., :c].reshape(b, f, h, w, c)
        v_aligned = warped[..., c:].reshape(b, f, h, w, 1)
        v_aligned = (v_aligned > 0.5).to(x_refs.dtype)
        v_maps = torch.clamp(v_aligned - (1.0 - m_target[:, None]), 0.0, 1.0)
        return x_aligned, v_aligned, v_maps
