"""The RRDBNet tail's backward: plain version, the CUDA kernel K6 and the
autograd Function (master_thesis_tpu/ops/pallas_tail.py: tail_bwd_pallas,
_tail_bwd_kernel, fused_upsample_conv_kernel_adjoint, make_hybrid_tail).

:class:`TailFunction`'s forward runs the tail (K4, ``csrc/tail.cu``) from
the f32 parameters it is given and keeps its input; its backward (K6)
recomputes h1 = up1(x), h2 = up2(h1) and h3 = lrelu(hr_conv(h2)), then
runs the adjoints and weight grads of conv_last, hr_conv, upconv2 and
upconv1 with the lrelu masks from the post-activation signs.

On the card (:func:`tail_bwd_cuda`, ``csrc/tail_bwd.cu:tail_backward`` +
``csrc/tail_bwd_wgmma.cuh``) that is one ctypes call of
:data:`TAIL_BWD_KERNELS` launches, channels-last in and out, in the TPU
kernel's 4-phase form: the upsample-convs' adjoints run at the low
resolution over the phase-major cotangent planes, their weight grads per
phase, folded back to the 3x3 kernels as ``fused_upsample_conv_kernel_
adjoint`` does. The plain version (:func:`tail_bwd_plain`) takes the
upsample-convs' grads at the high resolution instead, where a nearest-2x
upsample followed by a 3x3 conv is a plain 3x3 conv of the upsampled
input: the same function. Rounding as ``_tail_bwd_kernel``: every
cotangent is rounded to the working dtype before a product, sums and
grads are f32, dx is in the working dtype. A CUDA tensor goes through the
kernels, a CPU tensor through :func:`tail_bwd_plain`; nothing falls back.

The first design (``csrc/conv_bwd.cuh``, 17 mma.sync launches, NCHW)
stays as :func:`tail_bwd_first_cuda`, which no path of the port calls:
the card's checks time the new design against it.

In f32 (:func:`tail_bwd_f32`) the backward follows :func:`tail_bwd_plain`
with the f32 route's two kernels: the recompute (:func:`..tail.tail_f32`'s
first three launches), then per conv from conv_last down one
:func:`.conv_f32.conv_f32_wgrad` (through x2 for the upsample-convs) and
one :func:`.conv_f32.conv_f32_fwd` of the adjoint (flipped, transposed
kernel) with the leaky mask of the kept activation in its epilogue, the
upsample-convs' adjoints at the high resolution with their 2x2 sums
(the adjoint of nearest x2) taken in the same launch. All in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.models.nn_ext import leaky_relu, pixel_shuffle_2x
from master_thesis_tpu_torch.ops import conv_bwd, fragments
from master_thesis_tpu_torch.ops import rrdb as rrdb_ops
from master_thesis_tpu_torch.ops.conv_f32 import (
    WGRAD_KERNELS,
    adjoint_hwio,
    conv_f32_fwd,
    conv_f32_wgrad,
    kernel_route,
    nhwc,
)
from master_thesis_tpu_torch.ops.tail import (
    _FIRST_NUMEL,
    _WG_NUMEL,
    KERNEL_NF,
    Conv,
    _check_packed,
    pack_tail,
    _check_f32,
    tail,
    tail_f32_stages,
    tail_flops,
)

# The tail's parameters in the order the Function takes them and returns
# their grads.
PARAM_NAMES = ("up1_w", "up1_b", "up2_w", "up2_b", "hr_w", "hr_b", "last_w", "last_b")


def _up2x(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _pool2x(t: torch.Tensor) -> torch.Tensor:
    n, c, h, w = t.shape
    return t.reshape(n, c, h // 2, 2, w // 2, 2).sum(dim=(3, 5))


def _mask(sign: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.where(sign >= 0, d, 0.2 * d)


def tail_bwd_plain(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], hidden=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tail's backward written out with ``F.conv2d`` and flipped kernels
    (the adjoints) and ``torch.nn.grad.conv2d_weight`` (the weight grads):
    ``x`` the tail input ``(N, nf, h, w)``, ``g`` the output cotangent
    ``(N, 3, 4h, 4w)``, both in the working dtype; ``p`` from ``pack_tail``.
    Returns ``dx`` and the f32 grads keyed by :data:`PARAM_NAMES` (f64 for
    f64 inputs: the sums are taken in ``promote_types(dtype, float32)``).
    ``hidden``, if given, is ``(h1, h2, h3)`` (N, nf, ., .) to take the
    masks from instead of the recompute (a check that shares a kernel's
    recompute, whose masks then match)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)

    def adjoint(dp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return F.conv2d(dp, k.to(acc).transpose(0, 1).flip(2, 3), padding=1)

    def wgrad(src: torch.Tensor, k: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
        return torch.nn.grad.conv2d_weight(src.to(acc), k.shape, dp, padding=1)

    def up(inp, name):  # the recompute in the 4-phase form, as K6 runs it
        y = F.conv2d(inp.to(acc), p[f"{name}_fused"].to(acc), padding=1)
        return leaky_relu(pixel_shuffle_2x(y) + p[f"{name}_b"].to(acc).view(1, -1, 1, 1)).to(dt)

    if hidden is not None:
        h1, h2, h3 = (t.to(dt) for t in hidden)
    else:
        h1 = up(x, "up1")
        h2 = up(h1, "up2")
        h3 = leaky_relu(F.conv2d(h2.to(acc), p["hr_oihw"].to(acc), p["hr_b"].to(acc), padding=1)).to(dt)
    grads: Dict[str, torch.Tensor] = {}

    dp = g.to(acc)
    grads["last_b"] = dp.sum(dim=(0, 2, 3))
    grads["last_w"] = wgrad(h3, p["last_oihw"], dp)
    d = adjoint(dp, p["last_oihw"])

    v = _mask(h3, d)
    grads["hr_b"], dp = v.sum(dim=(0, 2, 3)), v.to(dt).to(acc)
    grads["hr_w"] = wgrad(h2, p["hr_oihw"], dp)
    d = adjoint(dp, p["hr_oihw"])

    v = _mask(h2, d)
    grads["up2_b"], dp = v.sum(dim=(0, 2, 3)), v.to(dt).to(acc)
    grads["up2_w"] = wgrad(_up2x(h1), p["up2_oihw"], dp)
    d = _pool2x(adjoint(dp, p["up2_oihw"]))

    v = _mask(h1, d)
    grads["up1_b"], dp = v.sum(dim=(0, 2, 3)), v.to(dt).to(acc)
    grads["up1_w"] = wgrad(_up2x(x), p["up1_oihw"], dp)
    dx = _pool2x(adjoint(dp, p["up1_oihw"])).to(dt)
    return dx, grads


def pack_tail_adjoint(convs: Sequence[Conv], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The first design's adjoint B matrices of upconv1, upconv2, hr_conv and
    conv_last (``conv_bwd.pack_adjoint``; conv_last's 3 cotangent channels
    padded to 32, the narrowest adjoint that design takes)."""
    names = ("up1", "up2", "hr", "last")
    return {
        f"{name}_adj": conv_bwd.pack_adjoint(w, dtype, o_pad=32 if name == "last" else None)
        for name, (w, _) in zip(names, convs)
    }


def pack_tail_bwd(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The B operands of K6's adjoints, from ``pack_tail``'s ``p`` (so from
    the same rounded weights the forward and the plain version read):

    - ``hr_adj``: hr_conv's kernel transposed and flipped (the adjoint conv)
      in the layout of ``fragments.wgmma_conv_matrix``;
    - ``up{1,2}_adj``: the 4-phase kernel's 16 blocks transposed
      (``fragments.wgmma_phase_adjoint_matrix``);
    - ``last_adj``: conv_last's kernel transposed and flipped, its 3 input
      channels zero-padded to 16 (one k16 step a tap): per tap a block
      ``(half, c // 8, c % 8, o % 8)``, ``o = 8 half + o % 8``.

    The B operands keep ``p``'s dtype (bf16 on the card)."""
    dt = p["hr_oihw"].dtype
    out = {"hr_adj": fragments.wgmma_conv_matrix(
        p["hr_oihw"].float().transpose(0, 1).flip(2, 3)).to(dt).contiguous()}
    for name in ("up1", "up2"):
        fused = p[f"{name}_fused"].float().permute(2, 3, 1, 0)  # HWIO (3, 3, C, 4 O)
        out[f"{name}_adj"] = fragments.wgmma_phase_adjoint_matrix(fused).to(dt).contiguous()
    last = F.pad(p["last_oihw"].float().transpose(0, 1).flip(2, 3), (0, 0, 0, 0, 0, 13))  # (C, 16, 3, 3)
    blocks = last.permute(2, 3, 1, 0).reshape(9, 2, 8, KERNEL_NF // 8, 8)  # (tap, half, o%8, c8, c%8)
    out["last_adj"] = blocks.permute(0, 1, 3, 4, 2).reshape(-1).to(dt).contiguous()
    return out


_CONVS = (("last", 3), ("hr", KERNEL_NF), ("up2", KERNEL_NF), ("up1", KERNEL_NF))
_W_OFF: Dict[str, int] = {}
_B_OFF: Dict[str, int] = {}
_off = 0
for _name, _cout in _CONVS:
    _W_OFF[_name] = _off
    _off += 9 * KERNEL_NF * _cout
for _name, _cout in _CONVS:
    _B_OFF[_name] = _off
    _off += _cout
_ROW = _off
_KS_MAX = 128  # the first design's K-splits of the weight-grad sums over pixels

# Kernel launches of one tail_backward call: the recompute (3), conv_last
# (1), an adjoint and a weight grad for each of hr_conv, upconv2 and
# upconv1 (6), the reduce (1).
TAIL_BWD_KERNELS = 11
# Its grads, f32, kernels OIHW, in the order of PARAM_NAMES.
GRAD_SHAPES = {"up1_w": (KERNEL_NF, KERNEL_NF, 3, 3), "up1_b": (KERNEL_NF,),
               "up2_w": (KERNEL_NF, KERNEL_NF, 3, 3), "up2_b": (KERNEL_NF,),
               "hr_w": (KERNEL_NF, KERNEL_NF, 3, 3), "hr_b": (KERNEL_NF,),
               "last_w": (3, KERNEL_NF, 3, 3), "last_b": (3,)}
GRAD_NUMEL = sum(math.prod(s) for s in GRAD_SHAPES.values())
_ADJ_NUMEL = {"hr_adj": 9 * KERNEL_NF**2, "up1_adj": 16 * KERNEL_NF**2, "up2_adj": 16 * KERNEL_NF**2,
              "last_adj": 9 * 16 * KERNEL_NF}


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines`` selects a variant (a planted fault,
    ``-DBWD_PLANT``, for the checks on the card)."""
    lib = _build.load("tail_bwd", defines)
    if not hasattr(lib, "_bound"):
        conv_bwd.bind(lib)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tail_upconv.argtypes = [vp] * 4 + [ci] * 3 + [vp]
        lib.tail_upconv.restype = ci
        lib.tail_backward.argtypes = [vp] * 15 + [ci] * 3 + [vp]
        lib.tail_backward.restype = ci
        lib.tail_backward_scratch.argtypes = [ci] * 3
        lib.tail_backward_scratch.restype = ctypes.c_longlong
        for fn in (lib.tail_backward_launches, lib.tail_backward_grads):
            fn.argtypes = []
            fn.restype = ci
        if (lib.tail_backward_launches(), lib.tail_backward_grads()) != (TAIL_BWD_KERNELS, GRAD_NUMEL):
            raise RuntimeError("csrc/tail_bwd.cu disagrees with ops/tail_bwd.py on launches or grads")
        lib._bound = True
    return lib


def split_grads(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K6's flat f32 grads as views keyed by :data:`PARAM_NAMES`."""
    out, off = {}, 0
    for name in PARAM_NAMES:
        size = math.prod(GRAD_SHAPES[name])
        out[name] = flat[off: off + size].view(GRAD_SHAPES[name])
        off += size
    return out


def tail_bwd_cuda(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tail's backward through K6 (``csrc/tail_bwd.cu:tail_backward``,
    one ctypes call of :data:`TAIL_BWD_KERNELS` launches) on bf16
    channels-last ``x`` ``(N, 64, h, w)`` and ``g`` ``(N, 3, 4h, 4w)`` (an
    NCHW tensor is refused); ``p`` from ``pack_tail``, ``adj`` from
    :func:`pack_tail_bwd`. Returns channels-last ``dx`` and the f32 grads
    keyed by :data:`PARAM_NAMES`."""
    rrdb_ops._check_activation(x, "x", torch.channels_last)
    n, c, h, w = x.shape
    if (g.shape != (n, 3, 4 * h, 4 * w) or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"g must be a channels-last bf16 ({n}, 3, {4 * h}, {4 * w}) tensor on x's device")
    _check_packed(p, x, _WG_NUMEL)
    for key, numel in _ADJ_NUMEL.items():
        t = adj.get(key)
        if t is None or (t.dtype, t.numel(), t.device) != (torch.bfloat16, numel, x.device) \
                or not t.is_contiguous():
            raise ValueError(f"{key} must be packed bf16 (pack_tail_bwd) on x's device")
    lib = _lib()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    flat = torch.empty(GRAD_NUMEL, dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.tail_backward_scratch(n, h, w), dtype=torch.uint8, device=x.device)
    ptrs = [p[k].data_ptr() for k in ("up1_wg", "up1_b", "up2_wg", "up2_b", "hr_wg", "hr_b")]
    ptrs += [adj[k].data_ptr() for k in ("hr_adj", "up2_adj", "up1_adj", "last_adj")]
    rc = lib.tail_backward(x.data_ptr(), g.data_ptr(), *ptrs, dx.data_ptr(), flat.data_ptr(),
                           scratch.data_ptr(), n, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "tail_backward")
    tail_bwd_cuda.launches += TAIL_BWD_KERNELS
    return dx, split_grads(flat)


tail_bwd_cuda.launches = 0


def _check_first_inputs(x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor]) -> None:
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.dim() != 4:
        raise ValueError("x must be a contiguous bfloat16 CUDA tensor")
    n, c, h, w = x.shape
    if c != KERNEL_NF:
        raise ValueError(f"x must be (N, {KERNEL_NF}, h, w), got {tuple(x.shape)}")
    if g.shape != (n, 3, 4 * h, 4 * w) or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous bf16 ({n}, 3, {4 * h}, {4 * w}) tensor on x's device")
    _check_packed(p, x, _FIRST_NUMEL)  # the recompute runs the first design's upsample-conv


def _upconv(lib, owner, x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """K4's first-design upsample-conv (``tail_upconv``): ``(N, 64, h, w)``
    -> ``(N, 64, 2h, 2w)``, lrelu applied, in x's dtype."""
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = lib.tail_upconv(x.data_ptr(), p[f"{name}_phase"].data_ptr(), p[f"{name}_b"].data_ptr(),
                         out.data_ptr(), n, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    conv_bwd._launched(lib, rc, "tail_upconv", owner)
    return out


def tail_bwd_first_cuda(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The first design (``csrc/conv_bwd.cuh``, 17 launches): bf16 NCHW
    ``x`` ``(N, 64, h, w)`` and ``g`` ``(N, 3, 4h, 4w)``; ``p`` from
    ``pack_tail``, ``adj`` from :func:`pack_tail_adjoint`. Kept to time and
    check :func:`tail_bwd_cuda` against on the card; no path of the port
    calls it."""
    _check_first_inputs(x, g, p)
    lib = _lib()
    me = tail_bwd_first_cuda
    n, c, h, w = x.shape
    bf = dict(dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    h2, w2, h4, w4 = 2 * h, 2 * w, 4 * h, 4 * w

    h1 = _upconv(lib, me, x, p, "up1")
    h2_ = _upconv(lib, me, h1, p, "up2")
    h3 = torch.empty((n, c, h4, w4), **bf)
    conv_bwd.conv(lib, me, h2_, c, c, p["hr_w"], c, conv_bwd.OUT_BF16_LRELU, bias=p["hr_b"],
                  out_bf16=h3)

    ks = min(_KS_MAX, n * -(-h4 // 8) * -(-w4 // 16))
    partial = torch.empty((ks, _ROW), **f32)
    d = torch.empty((n, c, h4, w4), **f32)
    dp = torch.empty((n, c, h4, w4), **bf)
    # conv_last: dP = g.
    conv_bwd.prep(lib, me, g, 0, 3, partial=partial, poff=_B_OFF["last"], ks=ks)
    conv_bwd.wgrad(lib, me, h3, None, c, g, 16, 3, partial, _W_OFF["last"], ks)
    conv_bwd.conv(lib, me, g, 32, 3, adj["last_adj"], c, conv_bwd.OUT_F32, acc_f32=d)
    # hr_conv.
    conv_bwd.prep(lib, me, d, 0, c, sign=h3, out=dp, partial=partial, poff=_B_OFF["hr"], ks=ks)
    conv_bwd.wgrad(lib, me, h2_, None, c, dp, c, c, partial, _W_OFF["hr"], ks)
    conv_bwd.conv(lib, me, dp, c, c, adj["hr_adj"], c, conv_bwd.OUT_F32, acc_f32=d)
    # upconv2, at the high resolution.
    conv_bwd.prep(lib, me, d, 0, c, sign=h2_, out=dp, partial=partial, poff=_B_OFF["up2"], ks=ks)
    conv_bwd.wgrad(lib, me, h1, None, c, dp, c, c, partial, _W_OFF["up2"], ks, up=True)
    conv_bwd.conv(lib, me, dp, c, c, adj["up2_adj"], c, conv_bwd.OUT_F32, acc_f32=d)
    # upconv1: its cotangent is the 2x2 sums of upconv2's adjoint.
    dp1 = torch.empty((n, c, h2, w2), **bf)
    conv_bwd.prep(lib, me, d, 0, c, sign=h1, out=dp1, partial=partial, poff=_B_OFF["up1"],
                  pool=True, ks=ks)
    conv_bwd.wgrad(lib, me, x, None, c, dp1, c, c, partial, _W_OFF["up1"], ks, up=True)
    d1 = torch.empty((n, c, h2, w2), **f32)
    conv_bwd.conv(lib, me, dp1, c, c, adj["up1_adj"], c, conv_bwd.OUT_F32, acc_f32=d1)
    dx = torch.empty_like(x)
    conv_bwd.prep(lib, me, d1, 0, c, out=dx, pool=True, ks=ks)
    flat = conv_bwd.reduce(lib, me, partial)

    grads: Dict[str, torch.Tensor] = {}
    for name, cout in _CONVS:
        (grads[f"{name}_w"],) = conv_bwd.split_weight_grads(
            flat[_W_OFF[name]: _W_OFF[name] + 9 * c * cout], [(c, cout)])
        grads[f"{name}_b"] = flat[_B_OFF[name]: _B_OFF[name] + cout]
    return dx, grads


tail_bwd_first_cuda.launches = 0


def pack_tail_bwd_f32(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The HWIO kernels of K6's f32 route's adjoints (``conv_f32.adjoint_hwio``
    of each conv's own kernel, from ``pack_tail``'s f32 ``p``)."""
    return {f"{name}_adj": adjoint_hwio(p[f"{name}_oihw"]) for name in ("up1", "up2", "hr", "last")}


def tail_bwd_f32(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tail's backward on K6's f32 route (``tail_bwd_pallas`` with f32
    weights): the recompute (3 launches), then for conv_last, hr_conv,
    upconv2, upconv1 a weight grad and an adjoint (module docstring). ``x``
    f32 ``(N, nf, h, w)`` and ``g`` ``(N, 3, 4h, 4w)``, any layout; ``p``
    from ``pack_tail`` in f32, ``adj`` from :func:`pack_tail_bwd_f32`.
    Returns a channels-last ``dx`` and the f32 grads keyed by
    :data:`PARAM_NAMES`. The kernels for CUDA tensors, their plain versions
    for CPU ones; launches count in ``tail_bwd_f32.launches``."""
    _check_f32(x, p)
    n, nf, h, w = x.shape
    if g.shape != (n, 3, 4 * h, 4 * w) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be an f32 ({n}, 3, {4 * h}, {4 * w}) tensor on x's device")
    xv, gv = nhwc(x), nhwc(g)
    h1, h2, h3 = tail_f32_stages(xv, p, keep=3)
    grads = {k: torch.empty(p[f"{k[:-2]}_oihw"].shape if k.endswith("_w") else p[k].shape,
                            dtype=torch.float32, device=x.device) for k in PARAM_NAMES}
    f32 = dict(dtype=torch.float32, device=x.device)

    def step(name, src, up, dy, sign, pool):
        conv_f32_wgrad(src, dy, grads[f"{name}_w"], grads[f"{name}_b"], up=up)
        out = torch.empty((n, sign.shape[1], sign.shape[2], nf), **f32)
        return conv_f32_fwd(dy, adj[f"{name}_adj"], out, pool=pool, epi="mask_leaky", m=sign)

    d = step("last", h3, False, gv, h3, False)
    d = step("hr", h2, False, d, h2, False)
    d = step("up2", h1, True, d, h1, True)
    conv_f32_wgrad(xv, d, grads["up1_w"], grads["up1_b"], up=True)
    dx = conv_f32_fwd(d, adj["up1_adj"], torch.empty((n, h, w, nf), **f32), pool=True)
    if x.is_cuda:
        tail_bwd_f32.launches += TAIL_BWD_F32_KERNELS
    return dx.permute(0, 3, 1, 2), grads


tail_bwd_f32.launches = 0
# Kernel launches of one tail_bwd_f32 call: the recompute (3), four
# adjoints, four weight grads.
TAIL_BWD_F32_KERNELS = 3 + 4 + 4 * WGRAD_KERNELS


def tail_bwd(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K6 for a CUDA tensor (channels-last ``x`` and ``g``; in f32 its f32
    route, :func:`tail_bwd_f32`), the plain version for a CPU tensor."""
    if x.is_cuda:
        if kernel_route(x.dtype) == "f32":
            return tail_bwd_f32(x, g, p, pack_tail_bwd_f32(p))
        return tail_bwd_cuda(x, g, p, pack_tail_bwd(p))
    if x.device.type != "cpu":
        raise ValueError(f"no tail backward for device {x.device}")
    return tail_bwd_plain(x, g, p)


class TailFunction(torch.autograd.Function):
    """The tail with the forward and backward kernels. ``apply(x, dtype,
    *params)``: ``x`` ``(N, nf, h, w)`` in the working ``dtype``, channels-last
    on the card (an NCHW ``x`` is converted once there), NCHW on the CPU;
    ``params`` the f32 tensors of :data:`PARAM_NAMES`. The forward packs
    them afresh, so it always runs the current weights, and keeps the
    input it ran. On the card the output is channels-last, and the backward
    makes its cotangent channels-last (no copy where it arrives so, as
    the train step's does) and returns a channels-last ``dx``."""

    @staticmethod
    def forward(ctx, x, dtype, *params):
        convs = [tuple(params[i: i + 2]) for i in range(0, 8, 2)]
        p = pack_tail(*convs, dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        ctx.x, ctx.p = x, p
        return tail(x, p)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous(memory_format=torch.channels_last) if g.is_cuda else g.contiguous()
        dx, grads = tail_bwd(ctx.x, g, ctx.p)
        ctx.x = ctx.p = None
        return (dx, None, *(grads[k] for k in PARAM_NAMES))


def tail_bwd_flops(n: int, h: int, w: int, nf: int = KERNEL_NF) -> int:
    """Operations the tail's backward needs from a ``(n, nf, h, w)`` input:
    the adjoint convs and the weight grads, each one forward's operations
    (the upsample-convs in their 4-phase form, as :func:`..tail.tail_flops`
    counts them), plus the recompute of h1..h3."""
    px2, px4 = 4 * h * w, 16 * h * w
    recompute = 2 * n * nf * (4 * px2 * nf + 4 * px4 * nf + 9 * px4 * nf)
    return 2 * tail_flops(n, h, w, nf) + recompute
