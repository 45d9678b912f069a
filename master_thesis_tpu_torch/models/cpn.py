"""Copy-and-Paste Network affine aligner (master_thesis_tpu/models/cpn.py:
AEncoder, ARegressor, CPN.align) and its context-matching modules
(Encoder, cm_module, _masked_softmax, Decoder).

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

The context-matching modules, which the reference loads but never calls
(model_cpn.py:177-296), live in :class:`CPNContext`, apart from
:class:`CPN`: its state dict holds the reference keys ``Encoder.<name>.
conv.0`` and ``Decoder.<name>.conv.0`` (``convert.cpn_aux_from_torch``), its
weights come from a generator of its own, and :class:`CPN`'s seeded weights
and state dict stay as they were.
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

    def __init__(self, in_c, out_c, k, stride, padding, dilation=1, *, generator, dtype):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(in_c, out_c, k, stride, padding, dilation, generator=generator, dtype=dtype)
        )

    def forward(self, x):
        return self.conv(x)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - constant(IMAGENET_MEAN, x.dtype, x.device)) / constant(IMAGENET_STD, x.dtype, x.device)


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
        x = torch.cat([_normalize(in_f), in_v], dim=-1)
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


class Encoder(nn.Module):
    """Context encoder: NHWC frame + mask ``(N, H, W, 3 + 1)`` -> NHWC
    ``(N, H/4, W/4, 128)`` features (reference model_cpn.py:177-199); no
    resize, no ReLU after ``value3``."""

    _LAYERS = (
        ("conv12", 4, 64, 5, 2, 2), ("conv2", 64, 64, 3, 1, 1),
        ("conv23", 64, 128, 3, 2, 1), ("conv3", 128, 128, 3, 1, 1),
        ("value3", 128, 128, 3, 1, 1),
    )

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        for name, ci, co, k, s, p in self._LAYERS:
            setattr(self, name, _ConvBlock(ci, co, k, s, p, generator=generator, dtype=dtype))

    def forward(self, in_f: torch.Tensor, in_v: torch.Tensor) -> torch.Tensor:
        x = torch.cat([_normalize(in_f), in_v], dim=-1).permute(0, 3, 1, 2)
        for name, *_ in self._LAYERS[:-1]:
            x = F.relu(getattr(self, name)(x))
        return self.value3(x).permute(0, 2, 3, 1)


def _masked_softmax(vec: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax of ``vec * mask`` over ``dim`` counting only the masked-in
    entries; an all-masked slice gives zeros (reference model_cpn.py:246-254)."""
    masked = vec * mask
    exps = torch.exp(masked - masked.amax(dim=dim, keepdim=True)) * mask
    sums = exps.sum(dim=dim, keepdim=True)
    return exps / (sums + (sums < 1e-4).to(sums.dtype))


def cm_module(c_feats: torch.Tensor, v_t: torch.Tensor, v_aligned: torch.Tensor):
    """Context matching over the visible overlap (reference
    model_cpn.py:202-244). ``c_feats (B, F, h, w, C)``, frame 0 the target's;
    ``v_t (B, H, W, 1)`` and ``v_aligned (B, F-1, H, W, 1)`` visibility, each
    resized bilinearly (``align_corners=False``) to ``h x w`` and thresholded
    at 0.5. Each reference's weight is its masked mean product with the
    target's features (0 where the overlap is empty), softmaxed over the
    references where visible. Returns ``(cat([target feats, matched feats,
    c_mask]) (B, h, w, 2C + 1), c_mask (B, h, w, 1))``."""
    b, f, h, w, cc = c_feats.shape
    dt = c_feats.dtype
    v_t_r = (resize_hw(v_t, (h, w), "bilinear", align_corners=False) > 0.5).to(dt)
    v_r = (resize_hw(v_aligned, (h, w), "bilinear", align_corners=False) > 0.5).to(dt)
    vmap = v_t_r[:, None] * v_r
    v_sum = vmap[..., 0].sum(dim=(-2, -1))
    zeros = v_sum < 1e-4
    v_sum = v_sum + zeros.to(v_sum.dtype)
    gs = (vmap * c_feats[:, :1] * c_feats[:, 1:]).sum(dim=(-3, -2, -1)) / (v_sum * cc)
    gs = torch.where(zeros, torch.zeros_like(gs), gs)
    cos_sim = gs[:, :, None, None, None].expand(b, f - 1, h, w, cc)
    c_match = _masked_softmax(cos_sim, v_r, dim=1)
    c_out = (c_feats[:, 1:] * c_match).sum(dim=1)
    c_mask = 1 - (c_match * v_r).sum(dim=1).mean(dim=-1, keepdim=True)
    return torch.cat([c_feats[:, 0], c_out, c_mask], dim=-1), c_mask


class Decoder(nn.Module):
    """Dilated-conv decoder: NHWC ``(N, h, w, 257)`` -> the de-normalised
    NHWC frame ``(N, 4h, 4w, 3)`` (reference model_cpn.py:257-296): two
    nearest 2x upsamples, dilations 2 / 4 / 8 / 16 at the low resolution."""

    # (name, Cin, Cout, kernel, padding, dilation); "up" marks a nearest 2x.
    _LAYERS = (
        ("conv4", 257, 257, 3, 1, 1), ("conv5_1", 257, 257, 3, 1, 1),
        ("conv5_2", 257, 257, 3, 1, 1), ("convA4_1", 257, 257, 3, 2, 2),
        ("convA4_2", 257, 257, 3, 4, 4), ("convA4_3", 257, 257, 3, 8, 8),
        ("convA4_4", 257, 257, 3, 16, 16), ("conv3c", 257, 257, 3, 1, 1),
        ("conv3b", 257, 128, 3, 1, 1), ("conv3a", 128, 128, 3, 1, 1), "up",
        ("conv32", 128, 64, 3, 1, 1), ("conv2", 64, 64, 3, 1, 1), "up",
        ("conv21", 64, 3, 5, 2, 1),
    )

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        for layer in self._LAYERS:
            if layer != "up":
                name, ci, co, k, p, d = layer
                setattr(self, name, _ConvBlock(ci, co, k, 1, p, d, generator=generator, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for layer in self._LAYERS:
            if layer == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif layer[0] == "conv21":
                x = self.conv21(x)
            else:
                x = F.relu(getattr(self, layer[0])(x))
        x = x.permute(0, 2, 3, 1)
        return x * constant(IMAGENET_STD, x.dtype, x.device) + constant(IMAGENET_MEAN, x.dtype, x.device)


class CPNContext(nn.Module):
    """The CPN's context-matching modules, :class:`Encoder` and
    :class:`Decoder`, apart from :class:`CPN` (the inpainting path never
    calls them). Parameters f32 from ``generator`` (default seed 0),
    ``dtype`` the compute dtype; ``device=None`` means ``cuda``."""

    def __init__(
        self, *, dtype: torch.dtype = torch.float32, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.Encoder = Encoder(generator=gen, dtype=dtype)
        self.Decoder = Decoder(generator=gen, dtype=dtype)
        self.to(resolve_device(device))

    def forward(self, x_t, m_t, x_aligned, v_aligned):
        """Encoder -> :func:`cm_module` -> Decoder over a target ``x_t (B, H,
        W, 3)`` with its hole mask ``m_t (B, H, W, 1)`` and aligned
        references ``x_aligned (B, F, H, W, 3)`` with their visibility
        ``v_aligned (B, F, H, W, 1)`` (``CPN.align``'s first two outputs).
        Returns ``(frame (B, H, W, 3), c_mask (B, H/4, W/4, 1))``."""
        b, f, h, w, c = x_aligned.shape
        v_t = 1 - m_t
        frames = torch.cat([x_t[:, None], x_aligned], dim=1).reshape(b * (f + 1), h, w, c)
        vis = torch.cat([v_t[:, None], v_aligned], dim=1).reshape(b * (f + 1), h, w, 1)
        feats = self.Encoder(frames, vis)
        feats = feats.reshape(b, f + 1, *feats.shape[1:])
        x, c_mask = cm_module(feats, v_t, v_aligned)
        return self.Decoder(x), c_mask
