"""The RRDBNet tail's backward: plain version, the CUDA kernel K6 and the
autograd Function (master_thesis_tpu/ops/pallas_tail.py: tail_bwd_pallas,
_tail_bwd_kernel, fused_upsample_conv_kernel_adjoint, make_hybrid_tail).

:class:`TailFunction`'s forward runs the tail (K4, ``csrc/tail.cu``) from
the f32 parameters it is given and keeps the NCHW tail input; its backward
(K6, ``csrc/tail_bwd.cu``) recomputes h1 = up1(x), h2 = up2(h1) and h3 =
lrelu(hr_conv(h2)), then runs the adjoints of conv_last, hr_conv, upconv2
and upconv1 with the lrelu masks from the post-activation signs.

The upsample-convs' grads are taken at the high resolution, where a
nearest-2x upsample followed by a 3x3 conv is a plain 3x3 conv of the
upsampled input: the weight grad is the original kernel's directly (equal
to the TPU kernel's 4-phase grads folded back through
``fused_upsample_conv_kernel_adjoint``), the bias grad sums all output
pixels (the 4 phases), and the input cotangent sums each 2x2 block of the
adjoint conv's output (the adjoint of the upsample). Rounding as
``_tail_bwd_kernel``: every cotangent is rounded to the working dtype
before a product, sums and grads are f32, dx is in the working dtype. A
CUDA tensor goes through the kernels, a CPU tensor through
:func:`tail_bwd_plain`; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.models.nn_ext import leaky_relu, pixel_shuffle_2x
from master_thesis_tpu_torch.ops import conv_bwd
from master_thesis_tpu_torch.ops.tail import (
    _FIRST_NUMEL,
    KERNEL_NF,
    Conv,
    _check_packed,
    pack_tail,
    tail,
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
    return torch.where(sign.float() >= 0, d, 0.2 * d)


def tail_bwd_plain(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tail's backward written out with ``F.conv2d`` and flipped kernels
    (the adjoints) and ``torch.nn.grad.conv2d_weight`` (the weight grads):
    ``x`` the tail input ``(N, nf, h, w)``, ``g`` the output cotangent
    ``(N, 3, 4h, 4w)``, both in the working dtype; ``p`` from ``pack_tail``.
    Returns ``dx`` and the f32 grads keyed by :data:`PARAM_NAMES`."""
    dt = x.dtype

    def adjoint(dp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return F.conv2d(dp, k.float().transpose(0, 1).flip(2, 3), padding=1)

    def wgrad(src: torch.Tensor, k: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
        return torch.nn.grad.conv2d_weight(src.float(), k.shape, dp, padding=1)

    def up(inp, name):  # the recompute in the 4-phase form, as K6 runs it
        y = F.conv2d(inp.float(), p[f"{name}_fused"].float(), padding=1)
        return leaky_relu(pixel_shuffle_2x(y) + p[f"{name}_b"].view(1, -1, 1, 1)).to(dt)

    h1 = up(x, "up1")
    h2 = up(h1, "up2")
    h3 = leaky_relu(F.conv2d(h2.float(), p["hr_oihw"].float(), p["hr_b"], padding=1)).to(dt)
    grads: Dict[str, torch.Tensor] = {}

    dp = g.float()
    grads["last_b"] = dp.sum(dim=(0, 2, 3))
    grads["last_w"] = wgrad(h3, p["last_oihw"], dp)
    d = adjoint(dp, p["last_oihw"])

    v = _mask(h3, d)
    grads["hr_b"], dp = v.sum(dim=(0, 2, 3)), v.to(dt).float()
    grads["hr_w"] = wgrad(h2, p["hr_oihw"], dp)
    d = adjoint(dp, p["hr_oihw"])

    v = _mask(h2, d)
    grads["up2_b"], dp = v.sum(dim=(0, 2, 3)), v.to(dt).float()
    grads["up2_w"] = wgrad(_up2x(h1), p["up2_oihw"], dp)
    d = _pool2x(adjoint(dp, p["up2_oihw"]))

    v = _mask(h1, d)
    grads["up1_b"], dp = v.sum(dim=(0, 2, 3)), v.to(dt).float()
    grads["up1_w"] = wgrad(_up2x(x), p["up1_oihw"], dp)
    dx = _pool2x(adjoint(dp, p["up1_oihw"])).to(dt)
    return dx, grads


def pack_tail_adjoint(convs: Sequence[Conv], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The adjoint B matrices of upconv1, upconv2, hr_conv and conv_last
    (``conv_bwd.pack_adjoint``; conv_last's 3 cotangent channels padded to
    32, the narrowest adjoint the kernel takes)."""
    names = ("up1", "up2", "hr", "last")
    return {
        f"{name}_adj": conv_bwd.pack_adjoint(w, dtype, o_pad=32 if name == "last" else None)
        for name, (w, _) in zip(names, convs)
    }


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
_KS_MAX = 128  # K-splits of the weight-grad sums over pixels


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines`` selects a variant (a planted fault
    of ``csrc/conv_bwd.cuh`` for the checks on the card)."""
    lib = _build.load("tail_bwd", defines)
    if not hasattr(lib, "_bound"):
        conv_bwd.bind(lib)
        lib.tail_upconv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.tail_upconv.restype = ctypes.c_int
        lib._bound = True
    return lib


def _check_inputs(x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor]) -> None:
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.dim() != 4:
        raise ValueError("x must be a contiguous bfloat16 CUDA tensor")
    n, c, h, w = x.shape
    if c != KERNEL_NF:
        raise ValueError(f"x must be (N, {KERNEL_NF}, h, w), got {tuple(x.shape)}")
    if g.shape != (n, 3, 4 * h, 4 * w) or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous bf16 ({n}, 3, {4 * h}, {4 * w}) tensor on x's device")
    _check_packed(p, x, _FIRST_NUMEL)  # the recompute runs the first design's upsample-conv


def _upconv(lib, owner, x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """K4's upsample-conv (``tail_upconv``): ``(N, 64, h, w)`` -> ``(N, 64,
    2h, 2w)``, lrelu applied, in x's dtype."""
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = lib.tail_upconv(x.data_ptr(), p[f"{name}_phase"].data_ptr(), p[f"{name}_b"].data_ptr(),
                         out.data_ptr(), n, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    conv_bwd._launched(lib, rc, "tail_upconv", owner)
    return out


def tail_bwd_cuda(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], adj: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tail's backward through the CUDA kernels (``csrc/tail_bwd.cu``, 17
    launches): bf16 NCHW ``x`` ``(N, 64, h, w)`` and ``g`` ``(N, 3, 4h,
    4w)``; ``p`` from ``pack_tail``, ``adj`` from :func:`pack_tail_adjoint`."""
    _check_inputs(x, g, p)
    lib = _lib()
    me = tail_bwd_cuda
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


tail_bwd_cuda.launches = 0


def tail_bwd(
    x: torch.Tensor, g: torch.Tensor, p: Dict[str, torch.Tensor], convs: Sequence[Conv]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The kernels for a CUDA tensor, the plain version for a CPU tensor.
    ``convs``: the f32 ``(weight, bias)`` of upconv1, upconv2, hr_conv,
    conv_last, from which the kernels' adjoint matrices are packed."""
    if x.is_cuda:
        return tail_bwd_cuda(x, g, p, pack_tail_adjoint(convs, x.dtype))
    if x.device.type != "cpu":
        raise ValueError(f"no tail backward for device {x.device}")
    return tail_bwd_plain(x, g, p)


class TailFunction(torch.autograd.Function):
    """The tail with the forward and backward kernels. ``apply(x, dtype,
    *params)``: ``x`` NCHW ``(N, nf, h, w)`` in the working ``dtype``;
    ``params`` the f32 tensors of :data:`PARAM_NAMES`. The forward packs
    them afresh, so it always runs the current weights. On the card it
    hands the forward kernel a channels-last copy of ``x`` (the backward
    keeps the NCHW ``x`` it reads) and returns its channels-last output."""

    @staticmethod
    def forward(ctx, x, dtype, *params):
        convs = [tuple(params[i: i + 2]) for i in range(0, 8, 2)]
        p = pack_tail(*convs, dtype)
        ctx.x, ctx.p, ctx.convs = x, p, convs
        return tail(x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x, p)

    @staticmethod
    def backward(ctx, g):
        dx, grads = tail_bwd(ctx.x, g.contiguous(), ctx.p, ctx.convs)
        ctx.x = ctx.p = ctx.convs = None
        return (dx, None, *(grads[k] for k in PARAM_NAMES))


def tail_bwd_flops(n: int, h: int, w: int, nf: int = KERNEL_NF) -> int:
    """Operations the tail's backward needs from a ``(n, nf, h, w)`` input:
    the adjoint convs and the weight grads, each one forward's operations
    (the upsample-convs in their 4-phase form, as :func:`..tail.tail_flops`
    counts them), plus the recompute of h1..h3."""
    px2, px4 = 4 * h * w, 16 * h * w
    recompute = 2 * n * nf * (4 * px2 * nf + 4 * px4 * nf + 9 * px4 * nf)
    return 2 * tail_flops(n, h, w, nf) + recompute

