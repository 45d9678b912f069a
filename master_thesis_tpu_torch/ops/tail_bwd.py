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

In f32 (:func:`tail_bwd_f32`) at nf 64 on the card the backward is one
ctypes call on the 3xTF32 ``wgmma`` kernel
(``csrc/conv_frame_tf32.cu:tail_backward_tf32``, design in
``csrc/conv_bwd_tf32_wgmma.cuh``, :data:`TAIL_BWD_F32_KERNELS` launches):
the recompute (K4's stages), conv_last's weight grad and masked adjoint
(two thin kernels: 3 cotangent channels), hr_conv's masked adjoint, the
upsample-convs' adjoints over the phase planes of their cotangent (the
4-phase kernel's 3x3 adjoint, s2d), the weight grads of hr_conv and, per
phase, of the upsample-convs in one launch, and a reduce that folds the
phases back (``fused_upsample_conv_kernel_adjoint``).
:func:`tail_bwd_tf32_plan` is that sequence with each launch pluggable
(their plain versions on the CPU). At other widths the first design runs
(:func:`tail_bwd_f32_first`: per conv a :func:`.conv_f32.conv_f32_wgrad`
and a :func:`.conv_f32.conv_f32_fwd` of the adjoint, the SIMT kernels,
the upsample-convs at the high resolution). All in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.models.nn_ext import leaky_relu, pixel_shuffle_2x
from master_thesis_tpu_torch.ops import conv_bwd, conv_stack, fragments, rrdb_bwd
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
    tail_f32_plan,
    tail_f32_stages,
    tail_flops,
    tail_stage_tf32_plain,
)
from master_thesis_tpu_torch.runtime.spans import span

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


def tail_bwd_f32_first(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K6's first f32 design, on the SIMT kernels (the route at widths other
    than nf 64, and on the card beside :func:`tail_bwd_f32` in
    chip_smoke.py): the
    recompute (3 launches), then for conv_last, hr_conv, upconv2, upconv1 a
    weight grad and an adjoint on the SIMT kernels (module docstring). ``x``
    f32 ``(N, nf, h, w)`` and ``g`` ``(N, 3, 4h, 4w)``, any layout; ``p``
    from ``pack_tail`` in f32, ``adj`` from :func:`pack_tail_bwd_f32`.
    Returns a channels-last ``dx`` and the f32 grads keyed by
    :data:`PARAM_NAMES`. The kernels for CUDA tensors, their plain versions
    for CPU ones; launches count in ``tail_bwd_f32_first.launches``."""
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
        tail_bwd_f32_first.launches += TAIL_BWD_F32_FIRST_KERNELS
    return dx.permute(0, 3, 1, 2), grads


tail_bwd_f32_first.launches = 0
# Kernel launches of one tail_bwd_f32_first call: the recompute (3), four
# adjoints, four weight grads.
TAIL_BWD_F32_FIRST_KERNELS = 3 + 4 + 4 * WGRAD_KERNELS
# Kernel launches of one K6 call on the 3xTF32 kernel: the recompute (3),
# conv_last's weight grad and adjoint (2), three adjoints, the weight
# grads, the reduce.
TAIL_BWD_F32_KERNELS = 3 + 2 + 3 + 1 + 1
_ADJ_TF32_NUMEL = {"hr_adj_tf32": 2 * 9 * 128 * KERNEL_NF, "up2_adj_tf32": 2 * 9 * 128 * 4 * KERNEL_NF,
                   "up1_adj_tf32": 2 * 9 * 128 * 4 * KERNEL_NF}


def _adjoint_oihw(p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """The adjoint conv's OIHW kernel (transposed, flipped): hr_conv's
    (64, 64, 3, 3); an upsample-conv's over its cotangent's phase planes,
    the 4-phase kernel's, (64, 256, 3, 3), input channels (a, b, o)."""
    w = p["hr_oihw"] if name == "hr" else p[f"{name}_fused"]
    return w.float().transpose(0, 1).flip(2, 3)


def pack_tail_bwd_tf32(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The operands of K6's adjoints on the 3xTF32 kernel (conv mode,
    ``fragments.wgmma_tf32_matrix`` of :func:`_adjoint_oihw`), from
    ``pack_tail``'s f32 ``p`` at nf 64: ``hr_adj_tf32``, ``up2_adj_tf32``,
    ``up1_adj_tf32``."""
    return {f"{name}_adj_tf32": fragments.wgmma_tf32_matrix(_adjoint_oihw(p, name)).contiguous()
            for name in ("hr", "up2", "up1")}


def k6_config(n: int, h: int, w: int, sms: int = rrdb_bwd.DEFAULT_SMS) -> Tuple[int, ...]:
    """One K6 call's tiles (``ft::K6Cfg``: upconv1 and upconv2 in phase
    mode, hr_conv (and its adjoint) at 4h x 4w, upconv2's and upconv1's
    adjoints at 2h x 2w and h x w, each ``(frames, rows, cols, halves)`` of
    ``conv_stack.tf32_tile``) and its weight grads' K-splits (hr_conv,
    upconv2, upconv1)."""
    tiles = [conv_stack.tf32_tile("phase", n, h, w, 3, 4 * KERNEL_NF, 0, h, 0),
             conv_stack.tf32_tile("phase", n, 2 * h, 2 * w, 3, 4 * KERNEL_NF, 0, 2 * h, 0)]
    tiles += [conv_stack.tf32_tile("conv", n, s * h, s * w, 3, KERNEL_NF, 0, s * h, 0) for s in (4, 2, 1)]
    ks = rrdb_bwd.wgrad_splits([(2, n * 4 * h * -(-4 * w // 32), 3), (8, n * 2 * h * -(-2 * w // 32), 2),
                                (8, n * h * -(-w // 32), 2)], sms)
    return tuple(v for t in tiles for v in t) + tuple(ks)


def _phase_planes(t: torch.Tensor) -> torch.Tensor:
    """NHWC ``(N, 2h, 2w, C)`` -> its phase planes as NCHW ``(N, 4 C, h,
    w)``, channels ``(a, b, c)``: pixel (2y + a, 2x + b)."""
    n, h2, w2, c = t.shape
    return t.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 2, 4, 5, 1, 3).reshape(n, 4 * c, h2 // 2, w2 // 2)


def fold_phase_grads(v: torch.Tensor) -> torch.Tensor:
    """The fold-back of K6's reduce: ``v[a, b, ti, tj]`` (each ``(O, C)``),
    the 4-phase kernel's grad at phase (a, b)'s taps (a + ti, b + tj) of its
    3x3 window, -> the grad of the 3x3 kernel applied after nearest x2,
    OIHW: ``dW[:, :, ki, kj] = sum_(a, b) v[a, b, ti, tj]`` with ``ti =
    (a + ki + 1) // 2 - a``, ``tj`` likewise (the adjoint of
    ``fused_upsample_conv_kernel``)."""
    o, c = v.shape[-2:]
    out = torch.zeros((o, c, 3, 3), dtype=v.dtype, device=v.device)
    for ki in range(3):
        for kj in range(3):
            for a in range(2):
                for b in range(2):
                    out[:, :, ki, kj] += v[a, b, (a + ki + 1) // 2 - a, (b + kj + 1) // 2 - b]
    return out


class K6Launches:
    """The launches of :func:`tail_bwd_tf32_plan`, their plain versions
    (any device); the CPU tests substitute emulations of the kernel.

    - ``stage(k, x, p, out)``: K4's stage k (the recompute);
    - ``last_wgrad(g, h3)``: conv_last's weight and bias grad sum rows
      ``(rows, 27 x 64 + 3)`` (OIHW, then the bias);
    - ``last_adj(g, w, h3)``: conv_last's adjoint masked by h3, in place
      over h3; the bias sum rows ``(rows, 64)``;
    - ``adj(mat, w, x, out, m=None, s2d=False)``: a conv of NHWC ``x`` (with
      ``s2d`` its phase planes) into ``out`` with ``mat`` / its exact OIHW
      kernel ``w``, masked by ``m``; the bias sum rows (or None);
    - ``wgrad(jobs)``: each job's item slots ``(ks, 9, 64, 32)``.
    """

    def stage(self, k, x, p, out):
        return tail_stage_tf32_plain(k, x, p, out)

    def last_wgrad(self, g, h3):
        dw = torch.nn.grad.conv2d_weight(h3.permute(0, 3, 1, 2), (3, KERNEL_NF, 3, 3), g.permute(0, 3, 1, 2),
                                         padding=1)
        return torch.cat([dw.reshape(-1), g.sum(dim=(0, 1, 2))]).view(1, -1)

    def last_adj(self, g, w, h3):
        d = F.conv2d(g.permute(0, 3, 1, 2), w.transpose(0, 1).flip(2, 3), padding=1).permute(0, 2, 3, 1)
        v = _mask(h3, d)
        h3.copy_(v)
        return v.sum(dim=(0, 1, 2)).view(1, -1)

    def adj(self, mat, w, x, out, m=None, s2d=False):
        xin = _phase_planes(x) if s2d else x.permute(0, 3, 1, 2)
        v = F.conv2d(xin, w, padding=1).permute(0, 2, 3, 1)
        if m is not None:
            v = _mask(m, v)
        out.copy_(v)
        return None if m is None else v.sum(dim=(0, 1, 2)).view(1, -1)

    def wgrad(self, jobs):
        return [rrdb_bwd.wgrad_job_plain(j).unsqueeze(0) for j in jobs]


def k6_reduce(slots, brows, lrows, out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K6's reduce: hr_conv's jobs' slots (``slots[0:2]``, the source's
    channel halves) added in order into hr_conv's weight grad, the
    upsample-convs' (``slots[2:10]`` upconv2, ``slots[10:18]`` upconv1;
    phase-major, halves inner) per phase then folded
    (:func:`fold_phase_grads`); the bias rows (hr_b, up2_b, up1_b) and
    conv_last's rows summed in order. ``out`` flat, :data:`PARAM_NAMES`
    order; returns :func:`split_grads` of it."""
    grads = split_grads(out)

    def whole(js):  # a (ks, 9, 64, 32) slot per source half -> (9, 64, 64)
        return torch.cat([rrdb_bwd.slot_sums(s) for s in js], dim=2)

    grads["hr_w"].copy_(whole(slots[0:2]).view(3, 3, 64, 64).permute(2, 3, 0, 1))
    for name, off in (("up2", 2), ("up1", 10)):
        v = torch.stack([whole(slots[off + 2 * ph: off + 2 * ph + 2]).view(3, 3, 64, 64)[:2, :2]
                         for ph in range(4)]).view(2, 2, 2, 2, 64, 64)
        grads[f"{name}_w"].copy_(fold_phase_grads(v))

    def rows_sum(rows):
        acc = torch.zeros_like(rows[0])
        for row in rows:
            acc = acc + row
        return acc

    for key, rows in zip(("hr_b", "up2_b", "up1_b"), brows):
        grads[key].copy_(rows_sum(rows)[:64])
    last = rows_sum(lrows)
    grads["last_w"].copy_(last[:27 * 64].view(3, 64, 3, 3))
    grads["last_b"].copy_(last[27 * 64: 27 * 64 + 3])
    return grads


def tail_bwd_tf32_plan(x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor],
                       out: torch.Tensor, launches: K6Launches, ks=(1, 1, 1)):
    """K6's f32 route on the 3xTF32 kernel as the launches
    ``csrc/conv_bwd_tf32_wgmma.cuh:tail_backward_tf32`` issues (its note),
    each through ``launches``: NHWC f32 ``x`` (N, h, w, 64) and ``g`` (N,
    4h, 4w, 3), ``p`` from ``pack_tail`` (f32), ``adj`` from
    :func:`pack_tail_bwd_tf32`, the grads into ``out`` (flat,
    :data:`PARAM_NAMES` order). Returns ``(dx NHWC, grads)``."""
    n, h, w, c = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    hs = []
    src = x
    for k, s in enumerate((2, 4, 4)):
        o = torch.empty((n, s * h, s * w, c), **f32)
        src = launches.stage(k, src.contiguous(), p, o)
        hs.append(src)
    h1, h2, h3 = hs
    lrows = launches.last_wgrad(g, h3)
    brows = [launches.last_adj(g, p["last_oihw"].float(), h3)]  # h3 now hr_conv's dP
    dp2 = torch.empty_like(h2)
    brows.append(launches.adj(adj["hr_adj_tf32"], _adjoint_oihw(p, "hr"), h3, dp2, m=h2))
    dp1 = torch.empty_like(h1)
    brows.append(launches.adj(adj["up2_adj_tf32"], _adjoint_oihw(p, "up2"), dp2, dp1, m=h1, s2d=True))
    dx = torch.empty_like(x)
    launches.adj(adj["up1_adj_tf32"], _adjoint_oihw(p, "up1"), dp1, dx, s2d=True)
    jobs = [rrdb_bwd.WgJob(h3, h2, 0, 32 * half, ks[0]) for half in range(2)]
    for k, (cot, s) in enumerate(((dp2, h1), (dp1, x)), start=1):
        jobs += [rrdb_bwd.WgJob(cot, s, 0, 32 * half, ks[k], (ph >> 1, ph & 1)) for ph in range(4)
                 for half in range(2)]
    return dx, k6_reduce(launches.wgrad(jobs), brows, lrows, out)


def _k6_lib():
    lib = conv_stack._tf32_lib()
    if not hasattr(lib, "_k6_bound"):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tail_backward_tf32.argtypes = [vp] * 9 + [ci] * 3 + [vp]
        lib.tail_backward_tf32.restype = ci
        lib.tail_backward_tf32_scratch.argtypes = [vp] + [ci] * 3
        lib.tail_backward_tf32_scratch.restype = ctypes.c_longlong
        for fn in (lib.tail_backward_tf32_launches, lib.tail_backward_tf32_grads):
            fn.argtypes = []
            fn.restype = ci
        if (lib.tail_backward_tf32_launches(), lib.tail_backward_tf32_grads()) != (TAIL_BWD_F32_KERNELS, GRAD_NUMEL):
            raise RuntimeError("csrc/conv_bwd_tf32_wgmma.cuh disagrees with ops/tail_bwd.py on K6's f32 call")
        lib._k6_bound = True
    return lib


def tail_bwd_tf32_cuda(x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor],
                       adj: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's f32 backward through K6's 3xTF32 call
    (``csrc/conv_frame_tf32.cu:tail_backward_tf32``, one ctypes call,
    :data:`TAIL_BWD_F32_KERNELS` launches) on CUDA tensors: ``x`` NHWC f32
    (N, h, w, 64) and ``g`` NHWC (N, 4h, 4w, 3), both contiguous; ``p``
    from ``pack_tail`` (f32, nf 64), ``adj`` from :func:`pack_tail_bwd_tf32`.
    Returns ``(dx NHWC, flat grads)`` (:data:`PARAM_NAMES` order)."""
    n, h, w, c = x.shape
    dev = x.device
    if (not x.is_cuda or x.dtype != torch.float32 or c != KERNEL_NF or not x.is_contiguous()
            or g.shape != (n, 4 * h, 4 * w, 3) or g.dtype != torch.float32 or g.device != dev
            or not g.is_contiguous()):
        raise ValueError(f"x must be contiguous NHWC f32 (N, h, w, {KERNEL_NF}) on the card and g contiguous "
                         "NHWC f32 (N, 4h, 4w, 3) on its device")
    mats = [p.get(k) for k in ("up1_tf32", "up1_b", "up2_tf32", "up2_b", "hr_tf32", "hr_b")]
    adjs = [adj.get(f"{k}_adj_tf32") for k in ("hr", "up2", "up1")]
    if any(t is None or t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() for t in mats + adjs) \
            or any(adjs[i].numel() != _ADJ_TF32_NUMEL[f"{k}_adj_tf32"] for i, k in enumerate(("hr", "up2", "up1"))):
        raise ValueError("p must be packed in f32 at nf 64 (pack_tail) and adj by pack_tail_bwd_tf32, on x's device")
    last_w = p["last_oihw"].float().contiguous()
    lib = _k6_lib()
    cfg = (ctypes.c_int * 23)(*k6_config(n, h, w, rrdb_bwd._sms()))
    scratch = torch.empty(lib.tail_backward_tf32_scratch(cfg, n, h, w), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    flat = torch.empty(GRAD_NUMEL, dtype=torch.float32, device=dev)
    rc = lib.tail_backward_tf32(x.data_ptr(), g.data_ptr(), (ctypes.c_void_p * 6)(*(t.data_ptr() for t in mats)),
                                (ctypes.c_void_p * 3)(*(t.data_ptr() for t in adjs)), last_w.data_ptr(), dx.data_ptr(),
                                flat.data_ptr(), scratch.data_ptr(), cfg, n, h, w,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "tail_backward_tf32")
    tail_bwd_tf32_cuda.launches += 1
    return dx, flat


tail_bwd_tf32_cuda.launches = 0


def tail_bwd_f32(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tail's backward on K6's f32 route (``tail_bwd_pallas`` with f32
    weights): at nf 64 on the 3xTF32 kernel (``adj`` from
    :func:`pack_tail_bwd_tf32`; one :func:`tail_bwd_tf32_cuda` call on the
    card, :func:`tail_bwd_tf32_plan` with the plain launches on the CPU),
    at other widths the first design (:func:`tail_bwd_f32_first`, ``adj``
    from :func:`pack_tail_bwd_f32`). ``x`` f32 ``(N, nf, h, w)`` and ``g``
    ``(N, 3, 4h, 4w)``, any layout; ``p`` from ``pack_tail`` in f32.
    Returns a channels-last ``dx`` and the f32 grads keyed by
    :data:`PARAM_NAMES`; kernel launches count in
    ``tail_bwd_f32.launches``."""
    if tail_f32_plan(p) != "tf32":
        return tail_bwd_f32_first(x, g, p, adj)
    _check_f32(x, p)
    n, nf, h, w = x.shape
    if g.shape != (n, 3, 4 * h, 4 * w) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be an f32 ({n}, 3, {4 * h}, {4 * w}) tensor on x's device")
    xv, gv = nhwc(x), nhwc(g)
    if x.is_cuda:
        dx, flat = tail_bwd_tf32_cuda(xv.contiguous(), gv.contiguous(), p, adj)
        tail_bwd_f32.launches += TAIL_BWD_F32_KERNELS
        return dx.permute(0, 3, 1, 2), split_grads(flat)
    if x.device.type != "cpu":
        raise ValueError(f"no tail backward for device {x.device}")
    flat = torch.empty(GRAD_NUMEL, dtype=torch.float32)
    dx, grads = tail_bwd_tf32_plan(xv, gv, p, adj, flat, K6Launches())
    return dx.permute(0, 3, 1, 2), grads


tail_bwd_f32.launches = 0


def tail_bwd(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K6 for a CUDA tensor (channels-last ``x`` and ``g``; in f32 its f32
    route, :func:`tail_bwd_f32`), the plain version for a CPU tensor."""
    if x.is_cuda:
        if kernel_route(x.dtype) == "f32":
            return tail_bwd_f32(x, g, p, pack_tail_bwd_tf32(p) if tail_f32_plan(p) == "tf32"
                                else pack_tail_bwd_f32(p))
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
        with span("chn.pack"):
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
