"""The RRDB trunk's backward: plain version, the CUDA kernel K3 and the
autograd Function (master_thesis_tpu/ops/pallas_rrdb.py: rrdb_bwd_pallas,
_rdb_bwd_block, _rrdb_bwd_kernel, make_hybrid_trunk).

:class:`TrunkFunction` pairs the forward (K1, ``csrc/rrdb.cu``) with the
backward (K3, ``csrc/rrdb_bwd.cu``) as ``make_hybrid_trunk``'s
``custom_vjp`` does: the forward packs the f32 parameters it is given,
runs the trunk and keeps each RRDB's input; the backward sweeps the RRDBs
in reverse. Per RRDB it recomputes the inputs of rdb2 / rdb3 and every
RDB's hidden x1..x4, then per RDB walks conv5 .. conv1:

- ``dP_t = 0.2 * g_out`` for conv5, else the source cotangent of x_t times
  the lrelu slope from the sign of x_t; ``db_t = sum(dP_t)`` (f32);
- ``dP_t`` is rounded to the working dtype before every product;
- ``dW_t = sum_p cat(x, x1..)[c, p + tap] * dP_t[o, p]`` (f32);
- the inputs' cotangents gain the adjoint conv of ``dP_t`` (f32);

and ends with ``dx = g_out + dsrc[x]`` (f32 between the RDBs of an RRDB);
the RRDB's ``dx = (d + g)`` is rounded to the working dtype
(``_rrdb_bwd_kernel``). A CUDA tensor goes through the kernels, a CPU
tensor through :func:`rrdb_bwd_plain`; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import conv_bwd
from master_thesis_tpu_torch.ops.rrdb import (
    _RDB_B_NUMEL,
    _RDB_W_NUMEL,
    KERNEL_GC,
    KERNEL_NF,
    PackedRDB,
    _check_activation,
    _widths,
    pack_rdb_adjoints,
    pack_rdbs,
    rdb_flops,
    rdb_plain,
    rrdb_trunk,
)

Grads = Tuple[List[torch.Tensor], List[torch.Tensor]]  # one RDB's (dW OIHW, db)


def rdb_bwd_plain(
    x: torch.Tensor, hidden: Sequence[torch.Tensor], g_out: torch.Tensor, p: PackedRDB
) -> Tuple[torch.Tensor, Grads]:
    """One RDB's backward, written out with ``F.conv2d`` and flipped
    kernels (the adjoint) and ``torch.nn.grad.conv2d_weight`` (the weight
    grads). ``x`` and ``hidden`` in the working dtype, ``g_out`` f32.
    Returns the f32 input cotangent and the f32 grads."""
    dt = x.dtype
    outs = [k.shape[0] for k in p.kernels]
    nf, gc = outs[4], outs[0]
    src = torch.cat([x, *hidden], dim=1).float()
    dsrc = None
    dws: List[torch.Tensor] = [None] * 5
    dbs: List[torch.Tensor] = [None] * 5
    for t in range(5, 0, -1):
        k = p.kernels[t - 1]
        cin = k.shape[1]
        if t == 5:
            v = 0.2 * g_out
        else:
            d = dsrc[:, nf + (t - 1) * gc: nf + t * gc]
            v = torch.where(hidden[t - 1].float() >= 0, d, 0.2 * d)
        dbs[t - 1] = v.sum(dim=(0, 2, 3))
        dp = v.to(dt).float()
        dws[t - 1] = torch.nn.grad.conv2d_weight(src[:, :cin], k.shape, dp, padding=1)
        z = F.conv2d(dp, k.float().transpose(0, 1).flip(2, 3), padding=1)
        dsrc = z if t == 5 else torch.cat([dsrc[:, :cin] + z, dsrc[:, cin:]], dim=1)
    return g_out + dsrc[:, :nf], (dws, dbs)


def rrdb_bwd_plain(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB]
) -> Tuple[torch.Tensor, List[Grads]]:
    """One RRDB's backward: ``x`` its input, ``g`` its output cotangent, both
    in the working dtype. Returns ``(dx, [grads of rdb1, rdb2, rdb3])``."""
    y1, h1 = rdb_plain(x, rdbs[0], keep_hidden=True)
    y2, h2 = rdb_plain(y1, rdbs[1], keep_hidden=True)
    _, h3 = rdb_plain(y2, rdbs[2], res=x, keep_hidden=True)
    gf = g.float()
    d = 0.2 * gf
    grads: List[Grads] = [None] * 3
    for j, (xin, hid) in reversed(list(enumerate(((x, h1), (y1, h2), (y2, h3))))):
        d, grads[j] = rdb_bwd_plain(xin, hid, d, rdbs[j])
    return (d + gf).to(x.dtype), grads


_W_OFF = [0]
for _cin, _cout in _widths(KERNEL_NF, KERNEL_GC):
    _W_OFF.append(_W_OFF[-1] + 9 * _cin * _cout)
assert _W_OFF[-1] == _RDB_W_NUMEL
_DB_OFF = [0, 32, 64, 96, 128]  # conv t's bias grads after the weight grads
_ROW = _RDB_W_NUMEL + _RDB_B_NUMEL
_KS_MAX = 64  # K-splits of the weight-grad sums over pixels


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines`` selects a variant (a planted fault
    of ``csrc/conv_bwd.cuh`` for the checks on the card)."""
    lib = _build.load("rrdb_bwd", defines)
    if not hasattr(lib, "_bound"):
        conv_bwd.bind(lib)
        lib.rdb_forward_hidden.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.rdb_forward_hidden.restype = ctypes.c_int
        lib._bound = True
    return lib


def _rdb_hidden(lib, owner, x: torch.Tensor, p: PackedRDB, res=None):
    """K1 writing x1..x4 as well (``rdb_forward_hidden``): ``(out, hidden)``
    with hidden ``(N, 4 * gc, H, W)`` in x's dtype."""
    n, _, h, w = x.shape
    out = torch.empty_like(x)
    hidden = torch.empty((n, 4 * KERNEL_GC, h, w), dtype=x.dtype, device=x.device)
    rc = lib.rdb_forward_hidden(
        x.data_ptr(), None if res is None else res.data_ptr(), p.w.data_ptr(), p.b.data_ptr(),
        out.data_ptr(), hidden.data_ptr(), n, h, w, torch.cuda.current_stream(x.device).cuda_stream,
    )
    conv_bwd._launched(lib, rc, "rdb_forward_hidden", owner)
    return out, hidden


def _ksplits(n: int, h: int, w: int) -> int:
    return min(_KS_MAX, n * -(-h // 8) * -(-w // 16))


def rrdb_bwd_cuda(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB],
    adjs: Sequence[Sequence[torch.Tensor]],
) -> Tuple[torch.Tensor, List[Grads]]:
    """One RRDB's backward through the CUDA kernels (``csrc/rrdb_bwd.cu``,
    51 launches): bf16 NCHW ``x`` and ``g`` with nf=64, gc=32; ``rdbs`` the
    packed forward weights (``pack_rdb``), ``adjs`` the packed adjoints
    (``pack_rdb_adjoints``) of the three RDBs."""
    _check_activation(x, "x")
    _check_activation(g, "g")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError("g must match x in shape and device")
    if len(rdbs) != 3 or len(adjs) != 3 or any(len(a) != 5 for a in adjs):
        raise ValueError("an RRDB has three RDBs of five convs")
    for p in rdbs:
        if (p.w.dtype, p.w.numel(), p.w.device) != (torch.bfloat16, _RDB_W_NUMEL, x.device):
            raise ValueError("rdbs must be bf16 RDBs packed (pack_rdb) for nf=64, gc=32 on x's device")
        if (p.b.dtype, p.b.numel(), p.b.device) != (torch.float32, _RDB_B_NUMEL, x.device):
            raise ValueError("rdbs must hold f32 biases on x's device")
    lib = _lib()
    me = rrdb_bwd_cuda
    n, nf, h, w = x.shape
    ins, hid = [x], []
    for j in range(3):
        out, hj = _rdb_hidden(lib, me, ins[j], rdbs[j], x if j == 2 else None)
        ins.append(out)
        hid.append(hj)

    ks = _ksplits(n, h, w)
    f32 = dict(dtype=torch.float32, device=x.device)
    widths = _widths(KERNEL_NF, KERNEL_GC)
    dsrc = torch.empty((n, KERNEL_NF + 4 * KERNEL_GC, h, w), **f32)
    dp = torch.empty_like(x)  # dP_t in channels [0, out_t)
    partial = torch.empty((ks, _ROW), **f32)
    dx = torch.empty_like(x)
    g_out = 0.2 * g.float()
    grads: List[Grads] = [None] * 3
    for j in (2, 1, 0):
        g_next = None if j == 0 else torch.empty((n, nf, h, w), **f32)
        for t in range(5, 0, -1):
            cin, cout = widths[t - 1]
            poff = _RDB_W_NUMEL + _DB_OFF[t - 1]
            if t == 5:
                conv_bwd.prep(lib, me, g_out, 0, cout, scale=0.2, out=dp, partial=partial,
                              poff=poff, ks=ks)
            else:
                # x_t's cotangent sits at its channels of cat(x, x1..x4).
                conv_bwd.prep(lib, me, dsrc, KERNEL_NF + (t - 1) * KERNEL_GC, cout, sign=hid[j],
                              cs0=(t - 1) * KERNEL_GC, out=dp, partial=partial, poff=poff, ks=ks)
            conv_bwd.wgrad(lib, me, ins[j], hid[j], cin, dp, cout, cout, partial, _W_OFF[t - 1], ks)
            if t > 1:
                conv_bwd.conv(lib, me, dp, cout, cout, adjs[j][t - 1], cin, conv_bwd.OUT_F32,
                              acc_f32=dsrc, accumulate=t < 5)
            else:
                conv_bwd.conv(lib, me, dp, cout, cout, adjs[j][0], cin, conv_bwd.OUT_RRDB_DX,
                              acc_f32=dsrc, out_f32=g_next, out_bf16=dx if j == 0 else None,
                              gout=g_out, gres=g if j == 0 else None)
        flat = conv_bwd.reduce(lib, me, partial)
        dws = conv_bwd.split_weight_grads(flat[:_RDB_W_NUMEL], widths)
        grads[j] = (dws, list(flat[_RDB_W_NUMEL:].split([c for _, c in widths])))
        g_out = g_next
    return dx, grads


rrdb_bwd_cuda.launches = 0


def rrdb_bwd(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB],
    adjs: Optional[Sequence[Sequence[torch.Tensor]]],
) -> Tuple[torch.Tensor, List[Grads]]:
    """The kernels for a CUDA tensor (``adjs``: the three RDBs' packed
    adjoints), the plain version for a CPU tensor."""
    if x.is_cuda:
        return rrdb_bwd_cuda(x, g, rdbs, adjs)
    if x.device.type != "cpu":
        raise ValueError(f"no RRDB backward for device {x.device}")
    return rrdb_bwd_plain(x, g, rdbs)


class TrunkFunction(torch.autograd.Function):
    """The trunk of RRDBs with the fused forward and backward kernels.

    ``apply(x, dtype, *params)``: ``x`` (N, C, H, W) in the working
    ``dtype``; ``params`` the f32 ``(weight OIHW, bias)`` of every RRDB's
    rdb1..rdb3 conv1..conv5, flattened in that order. The forward packs
    them afresh, so it always runs the current weights.

    On the card the forward runs K1 on a channels-last copy of ``x`` (one
    conversion; the output is channels-last), and the backward converts
    each kept RRDB input back to NCHW for K3 (one conversion an RRDB)."""

    @staticmethod
    def forward(ctx, x, dtype, *params):
        convs = [[(params[10 * r + 2 * k], params[10 * r + 2 * k + 1]) for k in range(5)]
                 for r in range(len(params) // 10)]
        flat = pack_rdbs(convs, dtype)
        packed = [flat[i: i + 3] for i in range(0, len(flat), 3)]
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        inters = []
        for rdbs in packed:
            inters.append(x)
            x = rrdb_trunk(x, [rdbs])
        ctx.inters, ctx.packed, ctx.convs, ctx.dtype = inters, packed, convs, dtype
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        adjs = None
        if g.is_cuda:
            flat = pack_rdb_adjoints(ctx.convs, ctx.dtype)
            adjs = [flat[i: i + 3] for i in range(0, len(flat), 3)]
        grads = []
        for i in reversed(range(len(ctx.inters))):
            x = ctx.inters[i].contiguous()  # K3 takes NCHW
            g, per_rdb = rrdb_bwd(x, g, ctx.packed[i], None if adjs is None else adjs[i])
            flat = [t for dws, dbs in per_rdb for k in range(5) for t in (dws[k], dbs[k])]
            grads = flat + grads
        ctx.inters = ctx.packed = ctx.convs = None
        return (g, None, *grads)


def rrdb_bwd_flops(n: int, h: int, w: int) -> int:
    """Operations one RRDB's backward needs: for each RDB the adjoint convs
    and the weight grads (each one forward's dense 3x3 convs) and the
    forward recompute, since only the RRDB's input is kept."""
    return 3 * 3 * rdb_flops(n, h, w)
