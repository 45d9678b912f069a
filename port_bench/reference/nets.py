"""The plain reference of the networks the cells run: CHN (RRDBNet), the
CPN affine aligner, VGG-16's pool features and DFPN, as functions of a
state dict whose keys are the reference torch keys
(``davidalvarezdlt/master_thesis``: model_chn.py, model_cpn.py,
model_vgg.py, model_dfpn.py).

Plain PyTorch in float32 with TF32 off; it imports nothing of the program
under test. Images are channel-last as the program's public tensors are:
``(B, H, W, C)``, sequences ``(B, F, H, W, C)``.

Every product (conv, transposed conv, linear, matmul) reads its operands
and returns its result through ``q``: the identity for the reference, a
rounding to a lower precision for the control (:mod:`.precision`), whose
tensors between the products are then held in that precision, as the
program's are in its own.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]
SD = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HEAD_STRIDES = (1, 1, 2, 1, 2)


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


def _mean_std(like: torch.Tensor):
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=like.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=like.device)
    return mean, std


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean, std = _mean_std(x)
    return (x - mean) / std


def conv(x, sd: SD, name: str, q: Q, stride=1, padding=1, dilation=1):
    return q(F.conv2d(q(x), q(sd[f"{name}.weight"]), sd[f"{name}.bias"], stride, padding, dilation))


def lrelu(x):
    return F.leaky_relu(x, 0.2)


# ---------------------------------------------------------------- resizing


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """torch's legacy nearest source index ``floor(dst * in / out)``, in
    float64."""
    idx = torch.floor(torch.arange(n_out, dtype=torch.float64) * (n_in / n_out)).long()
    return idx.clamp(0, n_in - 1).to(device)


def resize(x: torch.Tensor, size: Sequence[int], mode: str = "bilinear", align_corners=False):
    """Resizes axes (-3, -2) of a channel-last tensor: bilinear without
    antialiasing, or nearest by index."""
    h, w = int(size[0]), int(size[1])
    if mode == "nearest":
        if x.shape[-3] != h:
            x = x.index_select(x.ndim - 3, _nearest_index(x.shape[-3], h, x.device))
        if x.shape[-2] != w:
            x = x.index_select(x.ndim - 2, _nearest_index(x.shape[-2], w, x.device))
        return x
    lead = x.shape[:-3]
    hh, ww, c = x.shape[-3:]
    y = F.interpolate(x.reshape(-1, hh, ww, c).permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=align_corners, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


# ---------------------------------------------------------------- CHN


def rdb(x, sd: SD, prefix: str, q: Q):
    feats = [x]
    for k in range(1, 5):
        feats.append(lrelu(conv(torch.cat(feats, 1), sd, f"{prefix}.conv{k}", q)))
    return conv(torch.cat(feats, 1), sd, f"{prefix}.conv5", q) * 0.2 + x


def rrdbnet(x, sd: SD, nb: int, q: Q = ident):
    """RRDBNet (model_chn.py:506-555) on NCHW ``x``: the five bare head
    convs, ``nb`` RRDBs, trunk_conv, two nearest 2x upsamples each with a
    conv and a leaky ReLU, hr_conv, conv_last."""
    y = x
    for i, s in enumerate(HEAD_STRIDES):
        y = conv(y, sd, f"nn.conv_first.{i}", q, stride=s)
    t = y
    for b in range(nb):
        r = t
        for j in (1, 2, 3):
            r = rdb(r, sd, f"nn.rrdb_trunk.{b}.rdb{j}", q)
        t = r * 0.2 + t
    y = y + conv(t, sd, "nn.trunk_conv", q)
    y = lrelu(conv(F.interpolate(y, scale_factor=2, mode="nearest"), sd, "nn.upconv1", q))
    y = lrelu(conv(F.interpolate(y, scale_factor=2, mode="nearest"), sd, "nn.upconv2", q))
    return conv(lrelu(conv(y, sd, "nn.hr_conv", q)), sd, "nn.conv_last", q)


def chn_input(x_t, v_t, xa, va, vm):
    """The nine input channels ``[x_t, x_ref, v_t, v_ref, v_map]``
    (ImageNet-normalised frames), ``(B*F, 9, H, W)``."""
    b, f, h, w, c = xa.shape
    x_tt = x_t[:, None].expand(b, f, h, w, c)
    v_tt = v_t[:, None].expand(b, f, h, w, 1)
    inp = torch.cat([normalize(x_tt), normalize(xa), v_tt, va, vm], dim=-1)
    return inp.reshape(b * f, h, w, 9).permute(0, 3, 1, 2)


def chn_output(out, x_t, v_t, shape):
    """``(y_hat, y_hat_comp)`` from the network's ``(B*F, 3, H, W)`` output:
    de-normalised, clipped to [0, 1], composited with the visible target."""
    b, f, h, w, _ = shape
    mean, std = _mean_std(out)
    y_hat = torch.clamp(out.permute(0, 2, 3, 1).reshape(b, f, h, w, 3) * std + mean, 0.0, 1.0)
    x_tt = x_t[:, None].expand(b, f, h, w, 3)
    v_tt = v_t[:, None].expand(b, f, h, w, 1)
    return y_hat, v_tt * x_tt + (1 - v_tt) * y_hat


def chn(sd: SD, nb: int, x_t, v_t, xa, va, vm, q: Q = ident, block: int = 0):
    """CHN forward (model_chn.py:44-85): ``(y_hat, y_hat_comp)``, both
    ``(B, F, H, W, 3)``. ``block`` > 0 runs the network that many frames
    at a time (to bound memory; no grad)."""
    inp = chn_input(x_t, v_t, xa, va, vm)
    if block:
        out = torch.cat([rrdbnet(inp[i:i + block], sd, nb, q) for i in range(0, inp.shape[0], block)])
    else:
        out = rrdbnet(inp, sd, nb, q)
    return chn_output(out, x_t, v_t, xa.shape)


# ---------------------------------------------------------------- CPN

_ENC = (("conv12", 5, 2, 2), ("conv2", 3, 1, 1), ("conv23", 3, 2, 1), ("conv3", 3, 1, 1),
        ("conv34", 3, 2, 1), ("conv4a", 3, 1, 1), ("conv4b", 3, 1, 1))
_REG = (("conv45", 2), ("conv5a", 1), ("conv5b", 1), ("conv56", 2), ("conv5a", 1), ("conv5b", 1))


def cpn_encoder(sd: SD, f, m, q: Q):
    """A_Encoder (model_cpn.py:121-150): normalised frame and mask, resized
    to 224², seven convs with ReLU -> ``(N, 256, 28, 28)``."""
    x = resize(torch.cat([normalize(f), m], dim=-1), (224, 224), "bilinear").permute(0, 3, 1, 2)
    for name, _, s, p in _ENC:
        x = F.relu(conv(x, sd, f"A_Encoder.{name}.conv.0", q, stride=s, padding=p))
    return x


def cpn_regressor(sd: SD, f1, f2, q: Q):
    """A_Regressor (model_cpn.py:153-174): conv5a / conv5b applied twice,
    conv6a / conv6b unused; the mean over space, then fc -> ``(N, 2, 3)``."""
    x = torch.cat([f1, f2], dim=1)
    for name, s in _REG:
        x = F.relu(conv(x, sd, f"A_Regressor.{name}.conv.0", q, stride=s))
    x = x.mean(dim=(2, 3))
    return q(F.linear(q(x), q(sd["A_Regressor.fc.weight"]), sd["A_Regressor.fc.bias"])).reshape(-1, 2, 3)


def cpn_align(sd: SD, x_t, m_t, x_r, m_r, q: Q = ident):
    """CPN.align (model_cpn.py): ``(x_aligned, v_aligned, v_map)``. The
    refs and their visibility ``1 - m`` are warped together by the
    regressed affine map (bilinear, zeros outside, align_corners False);
    ``v_aligned > 0.5``; ``v_map = clip(v_aligned - (1 - m_t), 0, 1)``."""
    b, f, h, w, c = x_r.shape
    xr, mr = x_r.reshape(b * f, h, w, c), m_r.reshape(b * f, h, w, 1)
    feat_t = cpn_encoder(sd, x_t, m_t, q)
    feat_r = cpn_encoder(sd, xr, mr, q)
    feat_t = feat_t[:, None].expand(b, f, *feat_t.shape[1:]).reshape(feat_r.shape)
    theta = cpn_regressor(sd, feat_t, feat_r, q)
    grid = F.affine_grid(theta, [b * f, 1, h, w], align_corners=False)
    warped = F.grid_sample(torch.cat([xr, 1.0 - mr], dim=-1).permute(0, 3, 1, 2), grid, mode="bilinear",
                           padding_mode="zeros", align_corners=False).permute(0, 2, 3, 1)
    xa = warped[..., :c].reshape(b, f, h, w, c)
    va = (warped[..., c:].reshape(b, f, h, w, 1) > 0.5).float()
    vm = torch.clamp(va - (1.0 - m_t[:, None]), 0.0, 1.0)
    return xa, va, vm


# ---------------------------------------------------------------- VGG-16

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]


def vgg_features(sd: SD, x, q: Q = ident, normalize_input: bool = True, pools: int = 5) -> List[torch.Tensor]:
    """torchvision's VGG-16 ``features`` (convs at their ``features.{i}``
    positions) on NHWC ``x``: the first ``pools`` post-pool maps, NHWC."""
    if normalize_input:
        x = normalize(x)
    x = x.permute(0, 3, 1, 2)
    out, idx = [], 0
    for v in VGG16_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            out.append(x.permute(0, 2, 3, 1))
            idx += 1
            if len(out) == pools:
                break
        else:
            x = F.relu(conv(x, sd, f"features.{idx}", q))
            idx += 2
    return out


def vgg_pool4(sd: SD, x, q: Q = ident):
    """The pool-4 map of already-normalised NHWC ``x``."""
    return vgg_features(sd, x, q, normalize_input=False, pools=4)[3]


# ---------------------------------------------------------------- DFPN


def correlation(ft, vt, fr, vr, q: Q = ident):
    """Masked cosine-similarity volume ``(B, F, h, w, h, w)`` in f32."""
    b, f, h, w, c = fr.shape
    ft, fr = ft * vt, fr * vr
    t = ft.reshape(b, 1, h * w, c).float()
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-9)
    r = fr.reshape(b, f, h * w, c).float()
    r = r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True) + 1e-9)
    return q(torch.matmul(q(t), q(r.transpose(-1, -2)))).reshape(b, f, h, w, h, w)


def _seq(x, sd: SD, prefix: str, specs, q: Q):
    """Same-padded convs at Sequential indices: ``specs`` (index, kernel,
    relu)."""
    for i, k, relu in specs:
        x = conv(x, sd, f"{prefix}.{i}", q, padding=k // 2)
        if relu:
            x = F.relu(x)
    return x


_SEP = ((0, 3, True), (2, 3, True), (4, 3, False))


def sep4d(sd: SD, corr, q: Q = ident):
    """SeparableConv4d: 1 -> 128 -> 256 -> 256 over q-space per (b, f, p),
    the p <-> q swap, 256 -> 256 -> 128 -> 1 over p-space per (b, f, q)."""
    b, f, h, w = corr.shape[:4]
    hw = h * w
    x = _seq(corr.reshape(b * f * hw, 1, h, w), sd, "corr.conv.conv_1", _SEP, q)
    c1 = x.shape[1]
    x = x.reshape(b * f, hw, c1, hw).permute(0, 3, 2, 1).reshape(b * f * hw, c1, h, w)
    x = _seq(x, sd, "corr.conv.conv_2", _SEP, q)
    return x.reshape(b * f, hw, hw).transpose(1, 2).reshape(b, f, h, w, h, w)


# kernel, relu of the mixer's 14 convs; the Sequential index of each.
_MIXER_K = (5, 3, 3, 5, 3, 3, 5, 3, 3, 5, 3, 3, 5, 3)
_MIXER = tuple(zip((0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 23, 24), _MIXER_K, [True] * 11 + [False] * 3))


def mixer(sd: SD, corr, q: Q = ident):
    """AlignmentCorrelationMixer: ``(B, F, cs, cs, cs, cs)`` -> the coarse
    flow ``(B, F, cs, cs, 2)``, p-space as channels."""
    b, f, cs = corr.shape[0], corr.shape[1], corr.shape[2]
    x = _seq(corr.reshape(b * f, cs * cs, cs, cs), sd, "corr_mixer.mixer", _MIXER, q)
    return x.reshape(b, f, 2, cs, cs).permute(0, 1, 3, 4, 2)


# (kernel, stride or the transposed conv's padding, transposed) of the 21
# flow-estimator layers, at Sequential index 2 i.
_FLOW = ((5, 1, 0), (3, 1, 0), (5, 2, 0), (5, 1, 0), (3, 1, 0), (3, 2, 0), (5, 1, 0), (3, 1, 0),
         (3, 2, 0), (5, 1, 0), (3, 1, 0), (3, 1, 1), (5, 1, 0), (3, 1, 0), (3, 1, 1), (5, 1, 0),
         (3, 1, 0), (5, 2, 1), (5, 1, 0), (3, 1, 0), (3, 1, 0))


def flow_estimator(sd: SD, prefix: str, x_t, m_t, x_r, m_r, flow_pre, q: Q = ident):
    """FlowEstimator: ``[x_r, x_t, m_r, m_t, flow_pre]`` (10 channels) through
    21 layers, a ReLU after each but the last -> ``(B, F, H, W, 2)``."""
    b, f, h, w, c = x_r.shape
    x = torch.cat([x_r, x_t[:, None].expand(b, f, h, w, c), m_r, m_t[:, None].expand(b, f, h, w, 1),
                   flow_pre], dim=-1).reshape(b * f, h, w, 10).permute(0, 3, 1, 2)
    for i, (k, s, transposed) in enumerate(_FLOW):
        name = f"{prefix}.nn.{2 * i}"
        if transposed:
            x = q(F.conv_transpose2d(q(x), q(sd[f"{name}.weight"]), sd[f"{name}.bias"], 2, s, 1))
        else:
            x = conv(x, sd, name, q, stride=s, padding=k // 2)
        if i < len(_FLOW) - 1:
            x = F.relu(x)
    return x.permute(0, 2, 3, 1).reshape(b, f, h, w, 2)


def resize_flow(flow, size):
    if tuple(flow.shape[-3:-1]) == (int(size[0]), int(size[1])):
        return flow
    return resize(flow, size)


def resize_set_bis(x_t, m_t, x_r, m_r, size):
    if x_r.shape[-3] == size[0] and x_r.shape[-2] == size[1]:
        return x_t, m_t, x_r, m_r
    return (resize(x_t, size), resize(m_t, size, "nearest"), resize(x_r, size),
            resize(m_r, size, "nearest"))


def dfpn(sd: SD, base: int, x_t, m_t, x_r, m_r, feats_t, feats_r, q: Q = ident):
    """DFPN's forward (model_dfpn.py): ``(corr, flow_16, flow_64,
    flow_full)``: the masked correlation of the pool-4 features after the
    separable 4-D conv, the mixer's coarse flow, the 64² and the base-size
    estimators, and the last resized to the input size."""
    b, f, h, w, _ = x_r.shape
    x_t, x_r = normalize(x_t), normalize(x_r)
    s256, s64 = base, base // 4
    x_t256, m_t256, x_r256, m_r256 = resize_set_bis(x_t, m_t, x_r, m_r, (s256, s256))
    x_t64, m_t64, x_r64, m_r64 = resize_set_bis(x_t, m_t, x_r, m_r, (s64, s64))
    fh, fw = feats_t.shape[1:3]
    v_t = resize(1 - m_t256, (fh, fw), "nearest")
    v_r = resize(1 - m_r256, (fh, fw), "nearest")
    corr = sep4d(sd, correlation(feats_t, v_t, feats_r, v_r, q), q)
    flow_16 = mixer(sd, corr, q)
    flow_64 = flow_estimator(sd, "flow_64", x_t64, m_t64, x_r64, m_r64,
                             resize_flow(flow_16, (s64, s64)), q)
    flow_256 = flow_estimator(sd, "flow_256", x_t256, m_t256, x_r256, m_r256,
                              resize_flow(flow_64, (s256, s256)), q)
    return corr, flow_16, flow_64, resize_flow(flow_256, (h, w))


def align_set(x, v, flow):
    """Frames warped bilinearly, visibility by nearest, by the absolute
    ``flow``, align_corners True, zeros outside."""
    b, f, h, w, c = x.shape
    grid = flow.reshape(b * f, h, w, 2).float()
    xa = F.grid_sample(x.reshape(b * f, h, w, c).permute(0, 3, 1, 2), grid, mode="bilinear",
                       padding_mode="zeros", align_corners=True)
    va = F.grid_sample(v.reshape(b * f, h, w, v.shape[-1]).permute(0, 3, 1, 2), grid, mode="nearest",
                       padding_mode="zeros", align_corners=True)
    return xa.permute(0, 2, 3, 1).reshape(x.shape), va.permute(0, 2, 3, 1).reshape(v.shape)


def dfpn_align(sd_dfpn: SD, sd_vgg: SD, base: int, x_t, m_t, x_r, m_r, q: Q = ident):
    """The DFPN aligner (``CPN.align``'s interface): VGG pool-4 features of
    the normalised, ``base``-resized frames, DFPN's flow, the refs and
    their visibility warped by it. Returns ``(x_aligned, v_aligned,
    v_map)``."""
    b, f, h, w, _ = x_r.shape

    def prep(x):
        x = normalize(x)
        return x if x.shape[-3:-1] == (base, base) else resize(x, (base, base))

    feats_t = vgg_pool4(sd_vgg, prep(x_t), q)
    feats_r = vgg_pool4(sd_vgg, prep(x_r.reshape(b * f, h, w, 3)), q)
    feats_r = feats_r.reshape(b, f, *feats_r.shape[1:])
    flow = dfpn(sd_dfpn, base, x_t, m_t, x_r, m_r, feats_t, feats_r, q)[3]
    xa, va = align_set(x_r, 1.0 - m_r, flow)
    return xa, va, torch.clamp(va - (1.0 - m_t[:, None]), 0.0, 1.0)
