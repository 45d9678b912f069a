"""Copy-and-Hallucinate Network forward (master_thesis_tpu/models/chn.py:
ResidualDenseBlock5C, RRDB, RRDBNet, rrdbnet_tail_forward,
rrdbnet_infer_apply, chn_infer_apply, CHN).

Public tensors are channel-last like the JAX package's: images
``(B, H, W, C)``, sequences ``(B, F, H, W, C)``. Inside, the frame axis is
folded into the batch and activations are ``(N, C, H, W)`` in the compute
dtype: NCHW on the CPU; on the card channels-last from the trunk on (the
trunk's and the tail's kernels take it), so the tail's output is already
the NHWC the caller returns.

Module attribute names give the reference torch state-dict keys
(``nn.conv_first.{i}``, ``nn.rrdb_trunk.{i}.rdb{j}.conv{k}``,
``nn.trunk_conv``, ``nn.upconv1/2``, ``nn.hr_conv``, ``nn.conv_last``), so
``master_thesis_tpu.models.convert.chn_from_torch`` reads a
``CHN.state_dict()``.

The head is the reference's nested five bare convs (strides
``_HEAD_STRIDES``, no activations). The JAX package composes them into one
15x15 conv and evaluates it per source group (``chn_head_grouped``); that is
a TPU layout trick, not ported. The trunk and the tail run through the
CUDA kernels of :mod:`..ops.rrdb` and :mod:`..ops.tail` on the card, and
in training through their autograd Functions (:mod:`..ops.rrdb_bwd`,
:mod:`..ops.tail_bwd`), whose backward passes are kernels too.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from master_thesis_tpu_torch.device import constant, resolve_device
from master_thesis_tpu_torch.models.nn_ext import Conv, leaky_relu
from master_thesis_tpu_torch.models.vgg import IMAGENET_MEAN, IMAGENET_STD
from master_thesis_tpu_torch.ops import rrdb as rrdb_ops
from master_thesis_tpu_torch.ops import tail as tail_ops
from master_thesis_tpu_torch.ops.rrdb_bwd import TrunkFunction
from master_thesis_tpu_torch.ops.tail_bwd import TailFunction

_HEAD_STRIDES = (1, 1, 2, 1, 2)


def kernel_routes(h: int, w: int, nf: int = 64, gc: int = 32, itemsize: int = 2) -> Tuple[bool, bool]:
    """``(trunk banded, tail banded)`` for a trunk grid of ``h x w`` pixels:
    the decomposition the JAX package's serving path takes at that shape in
    a working dtype of ``itemsize`` bytes (2 bf16, 4 f32), so both packages
    band the same frames.

    - The trunk is banded (K2) past ``pallas_trunk_fits_big``: a 72 MiB
      budget at ``_trunk_bytes_per_lane`` = 2 432 B a pixel for nf 64, gc
      32 in bf16 (3 840 in f32), i.e. past 31 043 pixels (19 660 in f32;
      ``make_hybrid_trunk``). Where ``banded_trunk_fits`` fails too (grids
      wider than 287 columns in bf16) the JAX package falls back to XLA;
      the port keeps K2.
    - The tail is banded (K5) past ``tail_pallas_fits``: 60 nf-row planes
      of ``itemsize`` bytes a pixel plus 4 MiB within 88 MiB, i.e. past
      11 469 pixels in bf16, 5 734 in f32 (``make_hybrid_tail``;
      ``_tail_band_rows`` >= 8 keeps it on the band kernel there, as the
      port does everywhere).

    These are the TPU's VMEM budgets, kept as the route rule so that the
    two packages decompose the same shapes alike; they say nothing of the
    card."""
    trunk_px_bytes = 9 * nf * itemsize + nf * 4 + (nf + 4 * gc) * 4 + 2 * nf * itemsize
    trunk_banded = trunk_px_bytes * h * w > 72 << 20
    tail_banded = 60 * nf * itemsize * h * w + (4 << 20) > 88 << 20
    return trunk_banded, tail_banded


class ResidualDenseBlock5C(nn.Module):
    """Five dense 3x3 convs (reference model_chn.py:588-623); holds the
    parameters, the packed kernels compute it (:mod:`..ops.rrdb`), and
    :meth:`forward` is the module route."""

    def __init__(self, nf: int, gc: int, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        for k in range(5):
            cin = nf + k * gc
            cout = gc if k < 4 else nf
            setattr(self, f"conv{k + 1}", Conv(cin, cout, 3, padding=1, generator=generator, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(leaky_relu(getattr(self, f"conv{k}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    """Three RDBs (reference model_chn.py:558-585)."""

    def __init__(self, nf: int, gc: int, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.rdb1 = ResidualDenseBlock5C(nf, gc, generator=generator, dtype=dtype)
        self.rdb2 = ResidualDenseBlock5C(nf, gc, generator=generator, dtype=dtype)
        self.rdb3 = ResidualDenseBlock5C(nf, gc, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """RRDB generator (reference model_chn.py:506-555) on NCHW input."""

    def __init__(
        self, in_nc: int = 9, out_nc: int = 3, nb: int = 20, nf: int = 64,
        gc: int = 32, *, generator: torch.Generator, dtype: torch.dtype,
    ):
        super().__init__()
        self.nb, self.nf, self.gc, self.dtype = nb, nf, gc, dtype
        conv = lambda ci, co, s=1: Conv(ci, co, 3, s, 1, generator=generator, dtype=dtype)
        self.conv_first = nn.Sequential(
            *[conv(in_nc if i == 0 else nf, nf, s) for i, s in enumerate(_HEAD_STRIDES)]
        )
        self.rrdb_trunk = nn.Sequential(
            *[RRDB(nf, gc, generator=generator, dtype=dtype) for _ in range(nb)]
        )
        self.trunk_conv = conv(nf, nf)
        self.upconv1 = conv(nf, nf)
        self.upconv2 = conv(nf, nf)
        self.hr_conv = conv(nf, nf)
        self.conv_last = conv(nf, out_nc)
        self.repack()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.repack())

    def repack(self) -> None:
        """Drops the kernels' packed weights; the next serving forward packs
        them from the parameters. Loading a state dict calls it, and the
        train step after every optimizer step; call it after replacing a
        parameter object or moving the module to another device."""
        self._packed = None
        self._packed_key = None
        self._kernel_params = None

    def packed(self):
        """(trunk, tail) weights packed for the kernels. Made on first use and
        made again whenever a parameter changed since: the key holds each
        parameter's storage and version counter, which every in-place update
        (an optimizer step included) advances, so packed weights are never
        older than the parameters."""
        if self._kernel_params is None:
            tail = (self.upconv1, self.upconv2, self.hr_conv, self.conv_last)
            self._kernel_params = [p for m in (self.rrdb_trunk, *tail) for p in m.parameters()]
        key = tuple((p.data_ptr(), p._version) for p in self._kernel_params)
        if self._packed is None or key != self._packed_key:
            wb = lambda m: (m.weight, m.bias)
            self._packed = (
                rrdb_ops.pack_rrdb_trunk(self.rrdb_trunk, self.dtype),
                tail_ops.pack_tail(
                    wb(self.upconv1), wb(self.upconv2), wb(self.hr_conv),
                    wb(self.conv_last), self.dtype,
                ),
            )
            self._packed_key = key
        return self._packed

    def forward(
        self, x: torch.Tensor, trunk_band_rows: Optional[int] = None,
        tail_band_rows: Optional[int] = None,
    ) -> torch.Tensor:
        """``(N, in_nc, H, W)`` -> ``(N, out_nc, H, W)`` in the compute dtype
        (``rrdbnet_infer_apply``). With grad enabled on trainable
        parameters this is the training forward (:meth:`forward_train`).

        The trunk and the tail take the full-frame or the banded kernels as
        :func:`kernel_routes` picks for the trunk grid; a band height given
        for either forces its banded route with that height."""
        if torch.is_grad_enabled() and self.conv_last.weight.requires_grad:
            return self.forward_train(x)
        trunk_w, tail_w = self.packed()
        y = self.conv_first(x)
        # The trunk's kernels take channels-last on the card (trunk_conv, a
        # cuDNN conv, takes it as it is); the CPU path keeps NCHW.
        y = y.contiguous(memory_format=torch.channels_last if y.is_cuda else torch.contiguous_format)
        trunk_banded, tail_banded = kernel_routes(y.shape[2], y.shape[3], self.nf, self.gc,
                                                  self.dtype.itemsize)
        if trunk_band_rows is not None or trunk_banded:
            trunk = rrdb_ops.rrdb_trunk_banded(y, trunk_w, trunk_band_rows or 0)
        else:
            trunk = rrdb_ops.rrdb_trunk(y, trunk_w)
        # The sum of two channels-last tensors is channels-last: the tail
        # takes it as it is on the card (no copy here), NCHW on the CPU.
        layout = torch.channels_last if y.is_cuda else torch.contiguous_format
        y = (y + self.trunk_conv(trunk)).contiguous(memory_format=layout)
        if tail_band_rows is not None or tail_banded:
            return tail_ops.tail_banded(y, tail_w, tail_band_rows or 0)
        return tail_ops.tail(y, tail_w)

    def forward_modules(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """The module route: the reference's forward (model_chn.py:536-555)
        through the modules, autograd through every conv (cuDNN on the
        card) and no kernel; with ``remat`` each RRDB is computed again in
        the backward instead of keeping its activations."""
        y = self.conv_first(x)
        trunk = y
        for blk in self.rrdb_trunk:
            trunk = checkpoint(blk, trunk, use_reentrant=False) if remat else blk(trunk)
        y = y + self.trunk_conv(trunk)
        y = leaky_relu(self.upconv1(F.interpolate(y, scale_factor=2, mode="nearest")))
        y = leaky_relu(self.upconv2(F.interpolate(y, scale_factor=2, mode="nearest")))
        return self.conv_last(leaky_relu(self.hr_conv(y)))

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable forward: the head and ``trunk_conv`` through
        autograd (cuDNN on the card), the trunk and the tail as autograd
        Functions whose forward and backward are the kernels (K1 / K3,
        K4 / K6). Both pack from the current parameters on every call. On
        the card the activations stay channels-last, as in the serving
        forward: the kernels take them, and their cotangents come back, with
        no layout copy; the CPU path keeps NCHW."""
        layout = torch.channels_last if x.is_cuda else torch.contiguous_format
        y = self.conv_first(x).contiguous(memory_format=layout)
        trunk_params = [p for blk in self.rrdb_trunk for p in blk.parameters()]
        trunk = TrunkFunction.apply(y, self.dtype, *trunk_params)
        y = (y + self.trunk_conv(trunk)).contiguous(memory_format=layout)
        tail_params = [
            p for m in (self.upconv1, self.upconv2, self.hr_conv, self.conv_last)
            for p in (m.weight, m.bias)
        ]
        return TailFunction.apply(y, self.dtype, *tail_params)


def chn_infer_apply(
    chn: "CHN",
    x_target: torch.Tensor,
    v_target: torch.Tensor,
    x_refs_aligned: torch.Tensor,
    v_refs_aligned: torch.Tensor,
    v_maps: torch.Tensor,
    trunk_band_rows: Optional[int] = None,
    tail_band_rows: Optional[int] = None,
    net: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CHN forward (models/chn.py:430): returns ``(y_hat, y_hat_comp)``,
    both ``(B, F, H, W, 3)``. ``net`` replaces the RRDBNet's kernel route,
    as :meth:`RRDBNet.forward_modules` does for the module route.

    Network input channels are ``[x_t, x_ref, v_t, v_ref, v_map]``
    (chn.py:494-503); the output is de-normalized, clipped to [0, 1] and
    composited with the visible target pixels (chn.py:510-512). The trunk
    and the tail route by shape (:func:`kernel_routes`); a band height for
    either forces its banded route, as the JAX functions' ``band_rows=``
    do.
    """
    b, f, h, w, c = x_refs_aligned.shape
    mean = constant(IMAGENET_MEAN, x_target.dtype, x_target.device)
    std = constant(IMAGENET_STD, x_target.dtype, x_target.device)
    x_t = x_target[:, None].expand(b, f, h, w, c)
    v_t = v_target[:, None].expand(b, f, h, w, 1)
    nn_input = torch.cat(
        [(x_t - mean) / std, (x_refs_aligned - mean) / std, v_t, v_refs_aligned, v_maps],
        dim=-1,
    ).reshape(b * f, h, w, 9)
    nn_input = nn_input.permute(0, 3, 1, 2).to(chn.dtype).contiguous()
    if net is None:
        nn_output = chn.nn(nn_input, trunk_band_rows, tail_band_rows)
    else:
        nn_output = net(nn_input)
    # The tail's output on the card is channels-last: an NHWC view, no copy.
    nn_output = nn_output.permute(0, 2, 3, 1).reshape(b, f, h, w, 3)
    out_dtype = torch.promote_types(x_target.dtype, torch.float32)
    y_hat = torch.clamp(nn_output.to(out_dtype) * std + mean, 0.0, 1.0)
    y_hat_comp = v_t * x_t + (1 - v_t) * y_hat
    return y_hat, y_hat_comp


class CHN(nn.Module):
    """Copy-and-Hallucinate forward (reference model_chn.py:44-85).

    Parameters are f32 and drawn from ``generator`` (default seed 0);
    ``dtype`` is the compute dtype (bf16 when serving). ``device=None``
    means ``cuda`` and raises without a card.
    """

    def __init__(
        self, nb: int = 20, nf: int = 64, gc: int = 32, *,
        dtype: torch.dtype = torch.float32, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.nn = RRDBNet(9, 3, nb, nf, gc, generator=gen, dtype=dtype)
        self.to(dev)

    def forward(self, x_target, v_target, x_refs_aligned, v_refs_aligned, v_maps):
        return chn_infer_apply(self, x_target, v_target, x_refs_aligned, v_refs_aligned, v_maps)
