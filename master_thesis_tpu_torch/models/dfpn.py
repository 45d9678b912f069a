"""Dense Flow Prediction Network (master_thesis_tpu/models/dfpn.py:
correlation_masked_4d, softmax_3d, SeparableConv4d,
AlignmentCorrelationMixer, FlowEstimator, DFPN, flow_estimator_apply_pallas,
_conv_im2col, flow_estimator_apply_hybrid, dfpn_infer_apply,
prepare_vgg_input, dfpn_align).

Public tensors are channel-last like the JAX package's: images ``(B, H, W,
C)``, sequences ``(B, F, H, W, C)``, the cost volume ``(B, F, H, W, H,
W)`` = (b, f, p-space, q-space). Inside, frames fold into the batch and
the module route is NCHW in the compute dtype.

Module attribute names give the reference torch state-dict keys
(``corr.conv.conv_1.{0,2,4}``, ``corr.conv.conv_2.{0,2,4}``,
``corr_mixer.mixer.{0,2,..,22,23,24}``, ``flow_64.nn.{0..40}``,
``flow_256.nn.{0..40}``), so ``master_thesis_tpu.models.convert.
dfpn_from_torch`` reads a ``DFPN.state_dict()``.

:func:`dfpn_infer_apply` routes each stage as the JAX serving forward
does, with the same flags and defaults: the separable 4-D conv through the
modules (cuDNN on the card) or, with ``pallas_sep4d``, on the tile
conv-stack kernel K7; the mixer on K7 (``pallas_mixer``, default on); the
flow estimators through the modules or, with ``pallas_flow``, their
fixed-resolution segments on the banded conv-stack kernel K8
(:mod:`..ops.conv_stack`), or with ``hybrid_flow`` the JAX package's
hybrid schedule: c0 on K8, as one phase-packed conv or as one im2col
product, and the 64² / 32² mid segments on K8, the rest through the
modules (:func:`flow_estimator_apply_hybrid`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from master_thesis_tpu_torch.device import constant, resolve_device
from master_thesis_tpu_torch.models.nn_ext import Conv, ConvTranspose2dTorch, conv_phase_s2d
from master_thesis_tpu_torch.models.vgg import IMAGENET_MEAN, IMAGENET_STD
from master_thesis_tpu_torch.ops import conv_stack
from master_thesis_tpu_torch.ops.flows import align_set, resize_flow
from master_thesis_tpu_torch.ops.interp import resize_hw
from master_thesis_tpu_torch.ops.transforms import resize_set_bis


def correlation_masked_4d(
    x_target_feats: torch.Tensor,
    v_target: Optional[torch.Tensor],
    x_ref_feats: torch.Tensor,
    v_ref: Optional[torch.Tensor],
) -> torch.Tensor:
    """Masked cosine-similarity cost volume in f32: ``(B, H, W, C)`` target
    features and ``(B, F, H, W, C)`` reference features (each times its
    optional visibility) -> ``(B, F, H, W, H, W)``; position ``(p, q)``
    holds the similarity of target pixel p's feature with ref pixel q's.
    One batched f32 matmul (TF32 off, torch's default for matmuls)."""
    b, f, h, w, c = x_ref_feats.shape
    if v_target is not None:
        x_target_feats = x_target_feats * v_target
    if v_ref is not None:
        x_ref_feats = x_ref_feats * v_ref
    t = x_target_feats.reshape(b, 1, h * w, c).float()
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-9)
    r = x_ref_feats.reshape(b, f, h * w, c).float()
    r = r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True) + 1e-9)
    return torch.matmul(t, r.transpose(-1, -2)).reshape(b, f, h, w, h, w)


def softmax_3d(x: torch.Tensor) -> torch.Tensor:
    """Softmax over (q-space x frames) per target pixel of a ``(B, F, H, W,
    H, W)`` volume."""
    b, f, h, w, _, _ = x.shape
    xt = torch.softmax(x.permute(0, 2, 3, 4, 5, 1).reshape(b, h, w, -1), dim=-1)
    return xt.reshape(b, h, w, h, w, f).permute(0, 5, 1, 2, 3, 4)


def _conv_seq(specs, *, generator, dtype) -> nn.Sequential:
    """Same-padded convs ``(cin, cout, k, relu)``, each followed by a ReLU
    where asked: the reference's Sequential indices."""
    layers = []
    for ci, co, k, relu in specs:
        layers.append(Conv(ci, co, k, 1, k // 2, generator=generator, dtype=dtype))
        if relu:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def _convs(seq: nn.Sequential):
    """The convs of a Sequential and the ReLU flag after each."""
    mods = list(seq)
    convs = [m for m in mods if not isinstance(m, nn.ReLU)]
    relus = [i + 1 < len(mods) and isinstance(mods[i + 1], nn.ReLU)
             for i, m in enumerate(mods) if not isinstance(m, nn.ReLU)]
    return convs, relus


class SeparableConv4d(nn.Module):
    """4-D conv as two 3x3 stacks over the cost volume's two sub-spaces:
    1 -> 128 -> 256 -> 256 over q-space per (b, f, p), the p <-> q swap,
    256 -> 256 -> 128 -> 1 over p-space per (b, f, q)."""

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.conv_1 = _conv_seq([(1, 128, 3, True), (128, 256, 3, True), (256, 256, 3, False)],
                                generator=generator, dtype=dtype)
        self.conv_2 = _conv_seq([(256, 256, 3, True), (256, 128, 3, True), (128, 1, 3, False)],
                                generator=generator, dtype=dtype)
        self.dtype = dtype
        self.stacks = conv_stack.StackCache()

    def packed(self):
        """Both stacks packed for K7."""
        return tuple(self.stacks.get(name, *_convs(getattr(self, name)), self.dtype)
                     for name in ("conv_1", "conv_2"))

    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        """``(B, F, h, w, h, w)`` -> the same shape in the compute dtype."""
        b, f, h, w = corr.shape[:4]
        hw = h * w
        x = self.conv_1(corr.reshape(b * f * hw, 1, h, w).to(self.dtype))  # (bfp, 256, q)
        c1 = x.shape[1]
        x = x.reshape(b * f, hw, c1, hw).permute(0, 3, 2, 1).reshape(b * f * hw, c1, h, w)
        x = self.conv_2(x)  # (bfq, 1, p)
        return x.reshape(b * f, hw, hw).transpose(1, 2).reshape(b, f, h, w, h, w)


class CorrelationVGG(nn.Module):
    """Holds the separable 4-D conv at the reference's ``corr.conv`` (the
    reference's VGG lives outside DFPN here, as in the JAX package)."""

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.conv = SeparableConv4d(generator=generator, dtype=dtype)


def _mixer_schedule(cs: int):
    """(features, kernel, relu) of the 14 mixer convs; the last three output
    2 (the flow), written as a literal as in the JAX module."""
    return [
        (cs ** 2, 5, True), (cs ** 2, 3, True), (cs, 3, True),
        (cs, 5, True), (cs, 3, True), (cs // 2, 3, True),
        (cs // 2, 5, True), (cs // 2, 3, True), (cs // 4, 3, True),
        (cs // 4, 5, True), (cs // 4, 3, True), (2, 3, False),
        (2, 5, False), (2, 3, False),
    ]


class AlignmentCorrelationMixer(nn.Module):
    """Cost volume -> coarse ``cs x cs`` flow; the flattened p-space is the
    channel axis and the convs run over q-space."""

    def __init__(self, corr_size: int = 16, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        sched = _mixer_schedule(corr_size)
        cins = [corr_size ** 2] + [feats for feats, _, _ in sched[:-1]]
        self.mixer = _conv_seq([(ci, *s) for ci, s in zip(cins, sched)],
                               generator=generator, dtype=dtype)
        self.corr_size = corr_size
        self.dtype = dtype
        self.stacks = conv_stack.StackCache()

    def packed(self) -> conv_stack.PackedStack:
        """The 14 convs packed for K7."""
        return self.stacks.get("mixer", *_convs(self.mixer), self.dtype)

    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        """``(B, F, cs, cs, cs, cs)`` -> ``(B, F, cs, cs, 2)``."""
        b, f = corr.shape[:2]
        cs = self.corr_size
        x = self.mixer(corr.reshape(b * f, cs * cs, cs, cs).to(self.dtype))
        return x.reshape(b, f, 2, cs, cs).permute(0, 1, 3, 4, 2)


# (name, kernel, stride or the transposed conv's padding) of the 21 layers;
# "t*" are the stride-2 transposed convs (output padding 1).
_FLOW_LAYERS = (
    ("c0", 5, 1), ("c1", 3, 1), ("c2", 5, 2), ("c3", 5, 1), ("c4", 3, 1), ("c5", 3, 2),
    ("c6", 5, 1), ("c7", 3, 1), ("c8", 3, 2), ("c9", 5, 1), ("c10", 3, 1), ("t0", 3, 1),
    ("c11", 5, 1), ("c12", 3, 1), ("t1", 3, 1), ("c13", 5, 1), ("c14", 3, 1), ("t2", 5, 2),
    ("c15", 5, 1), ("c16", 3, 1), ("c17", 3, 1),
)
# The fixed-resolution segments (on K8) and, after each but the last, the
# layer that changes resolution.
_FLOW_SEGMENTS = (
    (("c0", "c1"), "c2"), (("c3", "c4"), "c5"), (("c6", "c7"), "c8"), (("c9", "c10"), "t0"),
    (("c11", "c12"), "t1"), (("c13", "c14"), "t2"), (("c15", "c16", "c17"), None),
)


class FlowEstimator(nn.Module):
    """The 21-layer flow refiner. Input channels: ref frame (3) + target
    frame (3) + ref mask (1) + target mask (1) + prior flow (2) = 10;
    output the 2-channel flow. ``nn`` is the reference's Sequential: each
    layer at an even index, a ReLU after every layer but the last."""

    def __init__(self, *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        layers = []
        for i, (name, k, s) in enumerate(_FLOW_LAYERS):
            cin, cout = (10 if i == 0 else 128), (2 if name == "c17" else 128)
            if name.startswith("t"):
                layers.append(ConvTranspose2dTorch(cin, cout, k, 2, s, 1, generator=generator,
                                                   dtype=dtype))
            else:
                layers.append(Conv(cin, cout, k, s, k // 2, generator=generator, dtype=dtype))
            if name != "c17":
                layers.append(nn.ReLU())
        self.nn = nn.Sequential(*layers)
        self.dtype = dtype
        self.stacks = conv_stack.StackCache()

    def layer(self, name: str) -> nn.Module:
        return self.nn[2 * [n for n, _, _ in _FLOW_LAYERS].index(name)]

    @staticmethod
    def inputs(x_target, m_target, x_refs, m_refs, flow_pre, dtype) -> torch.Tensor:
        """``[x_refs, x_t, m_refs, m_t, flow_pre]`` as ``(B*F, H, W, 10)``."""
        b, f, h, w, c = x_refs.shape
        x_t = x_target[:, None].expand(b, f, h, w, c)
        m_t = m_target[:, None].expand(b, f, h, w, 1)
        x = torch.cat([x_refs, x_t, m_refs, m_t, flow_pre.to(x_refs.dtype)], dim=-1)
        return x.reshape(b * f, h, w, 10).to(dtype)

    def forward(self, x_target, m_target, x_refs, m_refs, flow_pre) -> torch.Tensor:
        """The module route: ``(B, F, H, W, 2)`` in the compute dtype."""
        b, f, h, w, _ = x_refs.shape
        x = self.inputs(x_target, m_target, x_refs, m_refs, flow_pre, self.dtype)
        y = self.nn(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(b, f, h, w, 2)


def flow_estimator_apply_pallas(est: FlowEstimator, x_target, m_target, x_refs, m_refs,
                                flow_pre) -> torch.Tensor:
    """:class:`FlowEstimator` with its fixed-resolution segments as banded
    conv stacks (K8) and the stride-2 downs and transposed ups through
    their modules (cuDNN on the card), as the JAX package computes those
    outside Pallas. NHWC between the layers; the modules see the
    channels-last view."""
    b, f, h, w, _ = x_refs.shape
    x = est.inputs(x_target, m_target, x_refs, m_refs, flow_pre, est.dtype).contiguous()
    for names, step in _FLOW_SEGMENTS:
        convs = [est.layer(n) for n in names]
        relus = [n != "c17" for n in names]
        x = conv_stack.conv_stack_banded(x, est.stacks.get(names, convs, relus, est.dtype))
        if step is not None:
            y = F.relu(est.layer(step)(x.permute(0, 3, 1, 2)))
            x = y.permute(0, 2, 3, 1).contiguous()
    return x.reshape(b, f, h, w, 2)


def _conv_im2col(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A same-padded ``k x k`` conv of NHWC ``x (N, H, W, Cin)`` with the OIHW
    ``weight`` as one product (JAX ``_conv_im2col``): the k² shifted slices
    of the zero-padded frame concatenated in ``(dy, dx, ci)`` order, times
    the ``(k² Cin, Cout)`` kernel matrix in ``x``'s dtype, plus ``bias`` in
    its own (an f32 bias makes the result f32, as in JAX)."""
    cout, cin, kh, kw = weight.shape
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(kh) for dx in range(kw)], dim=-1)
    return torch.matmul(cols, weight.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)) + bias


# The hybrid estimator's mid segments, on K8 where their frames hold at least
# HYBRID_MIN_PIXELS pixels (JAX ``flow_estimator_apply_hybrid``).
_HYBRID_MIDS = (("c6", "c7"), ("c9", "c10"), ("c11", "c12"))
HYBRID_MIN_PIXELS = 1024


def flow_estimator_apply_hybrid(est: FlowEstimator, x_target, m_target, x_refs, m_refs, flow_pre, *,
                                fuse_mids: bool = True, c0_mode: str = "pallas") -> torch.Tensor:
    """:class:`FlowEstimator` on the JAX package's hybrid schedule
    (``flow_estimator_apply_hybrid``), the same products regrouped:

    - c0 by ``c0_mode``: ``"pallas"`` one K8 launch where the frame holds
      at least ``HYBRID_MIN_PIXELS``, ``"s2d"`` one phase-packed conv
      (:func:`..nn_ext.conv_phase_s2d`) where H and W are even,
      ``"im2col"`` one product (:func:`_conv_im2col`); otherwise, or for
      any other mode, its module. The s2d and im2col forms add the f32 bias
      to the compute-dtype product and pass f32 on, as JAX does;
    - with ``fuse_mids``, each of c6-c7, c9-c10 and c11-c12 as one K8 stack
      where its frames hold at least ``HYBRID_MIN_PIXELS``;
    - every other conv, the strided downs and the transposed ups through
      their modules (cuDNN on the card), which see the channels-last view
      of the NHWC activations.

    Returns ``(B, F, H, W, 2)`` in the compute dtype."""
    b, f, h, w, _ = x_refs.shape
    dt = est.dtype
    x = est.inputs(x_target, m_target, x_refs, m_refs, flow_pre, dt).contiguous()

    def module(x, name, relu=True):
        y = est.layer(name)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(y) if relu else y

    def banded(x, names):
        p = est.stacks.get(names, [est.layer(n) for n in names], [True] * len(names), dt)
        return conv_stack.conv_stack_banded(x.contiguous(), p)

    c0 = est.layer("c0")
    if c0_mode == "im2col":
        x = F.relu(_conv_im2col(x, c0.weight.to(dt), c0.bias))
    elif c0_mode == "s2d" and h % 2 == 0 and w % 2 == 0:
        x = F.relu(conv_phase_s2d(x, c0.weight, 2, 2, 2, dt) + c0.bias)
    elif c0_mode == "pallas" and h * w >= HYBRID_MIN_PIXELS:
        x = banded(x, ("c0",))
    else:
        x = module(x, "c0")
    for names, step in _FLOW_SEGMENTS:
        if names[0] == "c0":
            names = names[1:]
        if fuse_mids and names in _HYBRID_MIDS and x.shape[1] * x.shape[2] >= HYBRID_MIN_PIXELS:
            x = banded(x, names)
        else:
            for name in names:
                x = module(x, name, relu=name != "c17")
        if step is not None:
            x = module(x, step)
    return x.reshape(b, f, h, w, 2)


class DFPN(nn.Module):
    """Dense Flow Prediction Network. Parameters are f32 and drawn from
    ``generator`` (default seed 0); ``dtype`` is the compute dtype;
    ``base_size`` the cascade's working resolution (256 in the reference;
    the correlation is ``base_size / 16`` square). ``device=None`` means
    ``cuda`` and raises without a card."""

    def __init__(
        self, *, base_size: int = 256, use_softmax: bool = False,
        dtype: torch.dtype = torch.float32, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.base_size, self.use_softmax, self.dtype = base_size, use_softmax, dtype
        self.corr = CorrelationVGG(generator=gen, dtype=dtype)
        self.corr_mixer = AlignmentCorrelationMixer(base_size // 16, generator=gen, dtype=dtype)
        self.flow_64 = FlowEstimator(generator=gen, dtype=dtype)
        self.flow_256 = FlowEstimator(generator=gen, dtype=dtype)
        self.to(dev)

    def forward(self, *inputs):
        return dfpn_infer_apply(self, *inputs)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = constant(IMAGENET_MEAN, x.dtype, x.device)
    std = constant(IMAGENET_STD, x.dtype, x.device)
    return (x - mean) / std


def dfpn_infer_apply(
    dfpn: DFPN,
    x_target: torch.Tensor,
    m_target: torch.Tensor,
    x_refs: torch.Tensor,
    m_refs: torch.Tensor,
    vgg_feats_target: torch.Tensor,
    vgg_feats_refs: torch.Tensor,
    *,
    pallas_sep4d: bool = False,
    pallas_mixer: bool = True,
    pallas_flow: bool = False,
    hybrid_flow: bool = False,
    hybrid_fuse_mids: bool = True,
    hybrid_c0_mode: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The DFPN serving forward. ``x_target (B, H, W, 3)`` and ``m_target (B,
    H, W, 1)`` (masked target and its mask), ``x_refs (B, F, H, W, 3)``,
    ``m_refs (B, F, H, W, 1)``, and the pool-4 VGG features ``(B, cs, cs,
    512)`` / ``(B, F, cs, cs, 512)`` of the normalised, ``base_size``-resized
    frames (:func:`prepare_vgg_input`). Returns ``(corr, flow_16, flow_64,
    flow_full)``: the cost volume after the 4-D conv, the flows of the
    cascade 16 -> 64 -> 256 (at base 256), and the last at the input size.
    The flags route the stages as the module docstring says
    (``pallas_flow`` takes precedence over ``hybrid_flow``, whose
    ``hybrid_fuse_mids`` and ``hybrid_c0_mode`` are those of
    :func:`flow_estimator_apply_hybrid`); on a grad path (grad mode on, a
    DFPN parameter requiring grad) any of the four raises ``ValueError``,
    since K7 and K8 have no backward: train with all four ``False``."""
    flags = {"pallas_sep4d": pallas_sep4d, "pallas_mixer": pallas_mixer, "pallas_flow": pallas_flow,
             "hybrid_flow": hybrid_flow}
    on = [name for name, value in flags.items() if value]
    if on:
        conv_stack.refuse_grad_path(dfpn, "dfpn_infer_apply with " + ", ".join(f"{n}=True" for n in on))
    b, f, h, w, _ = x_refs.shape
    x_target, x_refs = _normalize(x_target), _normalize(x_refs)
    s256, s64 = dfpn.base_size, dfpn.base_size // 4
    x_t_256, m_t_256, x_r_256, m_r_256 = resize_set_bis(x_target, m_target, x_refs, m_refs, (s256, s256))
    x_t_64, m_t_64, x_r_64, m_r_64 = resize_set_bis(x_target, m_target, x_refs, m_refs, (s64, s64))

    fh, fw = vgg_feats_target.shape[1:3]
    v_target = resize_hw(1 - m_t_256, (fh, fw), "nearest")
    v_ref = resize_hw(1 - m_r_256, (fh, fw), "nearest")
    corr = correlation_masked_4d(vgg_feats_target, v_target, vgg_feats_refs, v_ref)
    sep = dfpn.corr.conv
    if pallas_sep4d:
        corr = conv_stack.sep4d_apply(*sep.packed(), corr, dfpn.dtype)
    else:
        corr = sep(corr)
    if dfpn.use_softmax:
        corr = softmax_3d(corr)

    mixer = dfpn.corr_mixer
    if pallas_mixer:
        flow_16 = conv_stack.mixer_apply(mixer.packed(), corr, mixer.corr_size, dfpn.dtype)
    else:
        flow_16 = mixer(corr)

    def flow_est(est: FlowEstimator, *args):
        if pallas_flow:
            return flow_estimator_apply_pallas(est, *args)
        if hybrid_flow:
            return flow_estimator_apply_hybrid(est, *args, fuse_mids=hybrid_fuse_mids,
                                               c0_mode=hybrid_c0_mode)
        return est(*args)

    flow_64_pre = resize_flow(flow_16, (s64, s64), mode="bilinear")
    flow_64 = flow_est(dfpn.flow_64, x_t_64, m_t_64, x_r_64, m_r_64, flow_64_pre)
    flow_256_pre = resize_flow(flow_64, (s256, s256), mode="bilinear")
    flow_256 = flow_est(dfpn.flow_256, x_t_256, m_t_256, x_r_256, m_r_256, flow_256_pre)
    return corr, flow_16, flow_64, resize_flow(flow_256, (h, w), mode="bilinear")


def prepare_vgg_input(x: torch.Tensor, size: int = 256) -> torch.Tensor:
    """ImageNet-normalises, then bilinearly resizes to ``size`` square (the
    model's ``base_size``), for the VGG features DFPN reads."""
    x = _normalize(x)
    if x.shape[-3] != size or x.shape[-2] != size:
        x = resize_hw(x, (size, size), "bilinear")
    return x


def dfpn_align(
    dfpn_apply: Callable,
    x_target: torch.Tensor,
    m_target: torch.Tensor,
    x_refs: torch.Tensor,
    m_refs: torch.Tensor,
    vgg_feats_target: torch.Tensor,
    vgg_feats_refs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The aligner interface shared with ``CPN.align``: the flow of
    ``dfpn_apply`` (a :func:`dfpn_infer_apply` closure, run without grad),
    then the refs and their visibility warped by it (:func:`..ops.flows.
    align_set`). Returns ``(x_aligned, v_aligned, v_map)`` shaped like the
    refs, ``v_map = clip(v_aligned - (1 - m_target), 0, 1)``."""
    with torch.no_grad():
        flow_full = dfpn_apply(x_target, m_target, x_refs, m_refs, vgg_feats_target,
                               vgg_feats_refs)[3]
    x_aligned, v_aligned = align_set(x_refs, 1.0 - m_refs, flow_full)
    v_map = torch.clamp(v_aligned - (1.0 - m_target[:, None]), 0.0, 1.0)
    return x_aligned, v_aligned, v_map
