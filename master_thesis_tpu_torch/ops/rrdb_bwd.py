"""The RRDB trunk's backward: plain version, the CUDA kernel K3 and the
autograd Function (master_thesis_tpu/ops/pallas_rrdb.py: rrdb_bwd_pallas,
_rdb_bwd_block, _rrdb_bwd_kernel, make_hybrid_trunk).

:class:`TrunkFunction` pairs the forward (K1, ``csrc/rrdb.cu``) with the
backward (K3, ``csrc/rrdb_bwd.cu``) as ``make_hybrid_trunk``'s
``custom_vjp`` does: the forward packs the f32 parameters it is given and
runs the trunk one RDB call at a time, keeping each RDB's input and its
hidden x1..x4; the backward sweeps the RRDBs in reverse over those kept
activations, recomputing nothing. (The TPU kernel keeps only each RRDB's
input and recomputes the rest in VMEM; K1 rounds x1..x4 as the plain
forward does, so the kept values are the recomputed ones.) Per RDB it
walks conv5 .. conv1:

- ``dP_t = 0.2 * g_out`` for conv5, else the source cotangent of x_t times
  the lrelu slope from the sign of x_t; ``db_t = sum(dP_t)`` (f32);
- ``dP_t`` is rounded to the working dtype before every product;
- ``dW_t = sum_p cat(x, x1..)[c, p + tap] * dP_t[o, p]`` (f32);
- the inputs' cotangents gain the adjoint conv of ``dP_t`` (f32);

and ends with ``dx = g_out + dsrc[x]`` (f32 between the RDBs of an RRDB);
the RRDB's ``dx = (d + g)`` is rounded to the working dtype
(``_rrdb_bwd_kernel``). On the card one ctypes call runs an RRDB's
backward (:data:`RRDB_BWD_KERNELS` launches; the design is in
``csrc/conv_bwd_wgmma.cuh``), channels-last. A CUDA tensor goes through
the kernels, a CPU tensor through :func:`rrdb_bwd_plain`; nothing falls
back.

In f32 (:func:`rrdb_bwd_f32`) the forward keeps each RDB's dense-concat
buffer (x and x1..x4, NHWC, :func:`.rrdb.rdb_f32`), and an RDB's backward
is, in the pull form: v5 = 0.2 g_out, then for each source x4 .. x1 one
:func:`.conv_f32.conv_f32_fwd` from the cotangents of every conv the
source feeds (stored in conv order in one NHWC buffer) to the source's
channels, with the leaky mask of the kept x_t in its epilogue (v_t); the
same from all five into x's channels, plus g_out (and, in the RRDB's first
RDB, g) in the epilogue (dx); then one :func:`.conv_f32.conv_f32_wgrad`
per conv. Everything in f32. It holds to the JAX package run in f32 under
``jax.default_matmul_precision("highest")``: the JAX kernel takes its two
products at default precision even in f32 (ROADMAP C).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import conv_bwd
from master_thesis_tpu_torch.ops.conv_f32 import (
    WGRAD_KERNELS,
    conv_f32_fwd,
    conv_f32_wgrad,
    kernel_route,
    nhwc,
)
from master_thesis_tpu_torch.ops.rrdb import (
    _RDB_B_NUMEL,
    _RDB_W_NUMEL,
    KERNEL_GC,
    KERNEL_NF,
    PackedRDB,
    _check_activation,
    _gather,
    _sources,
    _widths,
    pack_rdb_pulls,
    pack_rdbs,
    rdb_flops,
    rdb_cuda,
    rdb_f32,
    rdb_plain,
)

Grads = Tuple[List[torch.Tensor], List[torch.Tensor]]  # one RDB's (dW OIHW, db)


def rdb_bwd_plain(
    x: torch.Tensor, hidden: Sequence[torch.Tensor], g_out: torch.Tensor, p: PackedRDB
) -> Tuple[torch.Tensor, Grads]:
    """One RDB's backward, written out with ``F.conv2d`` and flipped
    kernels (the adjoint) and ``torch.nn.grad.conv2d_weight`` (the weight
    grads). ``x`` and ``hidden`` in the working dtype, ``g_out`` f32.
    Returns the f32 input cotangent and the f32 grads (f64 for f64 inputs:
    the sums are taken in ``promote_types(dtype, float32)``)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    outs = [k.shape[0] for k in p.kernels]
    nf, gc = outs[4], outs[0]
    src = torch.cat([x, *hidden], dim=1).to(acc)
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
            v = torch.where(hidden[t - 1] >= 0, d, 0.2 * d)
        dbs[t - 1] = v.sum(dim=(0, 2, 3))
        dp = v.to(dt).to(acc)
        dws[t - 1] = torch.nn.grad.conv2d_weight(src[:, :cin], k.shape, dp, padding=1)
        z = F.conv2d(dp, k.to(acc).transpose(0, 1).flip(2, 3), padding=1)
        dsrc = z if t == 5 else torch.cat([dsrc[:, :cin] + z, dsrc[:, cin:]], dim=1)
    return g_out + dsrc[:, :nf], (dws, dbs)


def rrdb_bwd_plain(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB], kept=None,
) -> Tuple[torch.Tensor, List[Grads]]:
    """One RRDB's backward: ``x`` its input, ``g`` its output cotangent, both
    in the working dtype. ``kept`` is ``(ins, hids)`` as the forward kept
    them: each RDB's input and its x1..x4 as one (N, 4 gc, H, W) tensor
    (any memory format); without it the RDBs are recomputed from ``x``.
    Returns ``(dx, [grads of rdb1, rdb2, rdb3])``."""
    if kept is None:
        y1, h1 = rdb_plain(x, rdbs[0], keep_hidden=True)
        y2, h2 = rdb_plain(y1, rdbs[1], keep_hidden=True)
        _, h3 = rdb_plain(y2, rdbs[2], res=x, keep_hidden=True)
        ins, hids = (x, y1, y2), (h1, h2, h3)
    else:
        ins = kept[0]
        gc = rdbs[0].kernels[0].shape[0]
        hids = [list(h.split(gc, dim=1)) for h in kept[1]]
    gf = g.to(torch.promote_types(g.dtype, torch.float32))
    d = 0.2 * gf
    grads: List[Grads] = [None] * 3
    for j in (2, 1, 0):
        d, grads[j] = rdb_bwd_plain(ins[j], hids[j], d, rdbs[j])
    return (d + gf).to(x.dtype), grads


def flat_grads(grads: Sequence[Grads], out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An RRDB's grads as K3 writes them: per RDB conv1..conv5, each dW
    (OIHW) then db, flattened (into ``out`` if given)."""
    parts = [t.reshape(-1) for dws, dbs in grads for k in range(5) for t in (dws[k], dbs[k])]
    if out is None:
        return torch.cat(parts)
    return torch.cat(parts, out=out)


def rdb_grads(flat: torch.Tensor, nf: int = KERNEL_NF, gc: int = KERNEL_GC) -> List[Grads]:
    """Inverse of :func:`flat_grads`: views of ``flat`` per RDB (dW OIHW,
    db) at widths nf, gc."""
    out, off = [], 0
    for _ in range(3):
        dws, dbs = [], []
        for cin, cout in _widths(nf, gc):
            dws.append(flat[off: off + 9 * cin * cout].view(cout, cin, 3, 3))
            off += 9 * cin * cout
            dbs.append(flat[off: off + cout])
            off += cout
        out.append((dws, dbs))
    return out


# The first design's partial-sum row: each conv's weight grads, then the
# bias grads.
_W_OFF = [0]
for _cin, _cout in _widths(KERNEL_NF, KERNEL_GC):
    _W_OFF.append(_W_OFF[-1] + 9 * _cin * _cout)
assert _W_OFF[-1] == _RDB_W_NUMEL
_DB_OFF = [0, 32, 64, 96, 128]  # conv t's bias grads after the weight grads
_ROW = _RDB_W_NUMEL + _RDB_B_NUMEL
_KS_MAX = 64  # K-splits of the weight-grad sums over pixels


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines`` selects a variant (a planted fault,
    ``-DBWD_PLANT``, for the checks on the card, or a tuning flag)."""
    lib = _build.load("rrdb_bwd", defines)
    if not hasattr(lib, "_bound"):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        conv_bwd.bind(lib)
        lib.rdb_forward_hidden.argtypes = [vp] * 6 + [ci] * 3 + [vp]
        lib.rdb_forward_hidden.restype = ci
        lib.rrdb_backward.argtypes = [vp] * 11 + [ci] * 3 + [vp]
        lib.rrdb_backward.restype = ci
        lib.rrdb_backward_scratch.argtypes = [ci] * 3
        lib.rrdb_backward_scratch.restype = ctypes.c_longlong
        lib.rrdb_backward_launches.restype = ci
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


def rrdb_bwd_first(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB],
    adjs: Sequence[Sequence[torch.Tensor]],
) -> Tuple[torch.Tensor, List[Grads]]:
    """The first K3 design (``csrc/rrdb_bwd.cu``: ``rdb_forward_hidden`` and
    the ``bwd_*`` entries over ``conv_bwd.cuh``, 51 launches), kept to time
    the current one against on the card; no path of the port calls it.
    bf16 NCHW ``x`` and ``g`` with nf=64, gc=32; ``rdbs`` the packed forward
    weights (``pack_rdb``), ``adjs`` the packed adjoints
    (``pack_rdb_adjoints``) of the three RDBs. It recomputes the RDBs
    from ``x`` and counts its launches in ``rrdb_bwd_first.launches``."""
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
    me = rrdb_bwd_first
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


rrdb_bwd_first.launches = 0

# An RDB's grads as K3 writes them (:func:`flat_grads`), and its five pull
# matrices (``rrdb.pack_rdb_pulls``).
RDB_GRAD_NUMEL = sum(9 * cin * cout + cout for cin, cout in _widths(KERNEL_NF, KERNEL_GC))
PULL_NUMEL = sum(9 * cin * cout for cin, cout in _widths(KERNEL_NF, KERNEL_GC))
# Kernel launches of one K3 call (csrc/conv_bwd_wgmma.cuh: prep, 3 x (5
# pulls + wgrad), reduce).
RRDB_BWD_KERNELS = 20


def scratch_bytes(n: int, h: int, w: int) -> int:
    """Bytes of the scratch one K3 call needs for n frames of h x w."""
    return _lib().rrdb_backward_scratch(n, h, w)


def _check_kept(kept, x: torch.Tensor) -> None:
    ins, hids = kept
    if len(ins) != 3 or len(hids) != 3:
        raise ValueError("kept must hold the three RDBs' inputs and hidden activations")
    for i, t in enumerate(ins):
        _check_activation(t, f"kept input {i}", torch.channels_last)
        if t.shape != x.shape or t.device != x.device:
            raise ValueError("kept inputs must match x in shape and device")
    n, _, h, w = x.shape
    for t in hids:
        if (not t.is_cuda or t.dtype != torch.bfloat16 or t.shape != (n, 4 * KERNEL_GC, h, w)
                or not t.is_contiguous(memory_format=torch.channels_last) or t.device != x.device):
            raise ValueError(f"kept x1..x4 must be channels-last bf16 ({n}, {4 * KERNEL_GC}, {h}, {w}) "
                             "on x's device")


def rrdb_bwd_cuda(
    x: torch.Tensor, g: torch.Tensor, pulls: torch.Tensor, kept,
    out: Optional[torch.Tensor] = None, scratch: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RRDB's backward through K3 (``csrc/rrdb_bwd.cu:rrdb_backward``,
    one ctypes call, :data:`RRDB_BWD_KERNELS` launches), nf=64, gc=32, bf16.

    ``x`` and ``g`` channels-last (N, 64, H, W); ``pulls`` the three RDBs'
    pull matrices, (3, PULL_NUMEL) contiguous (rows of
    ``rrdb.pack_rdb_pulls``); ``kept`` = ``(ins, hids)`` from the forward:
    the RDBs' inputs (x and rdb1's and rdb2's outputs, channels-last) and
    their x1..x4, channels-last (N, 128, H, W) (``rdb_cuda``'s NHWC
    scratch, permuted). ``out`` (3 * RDB_GRAD_NUMEL f32) receives the grads
    (:func:`flat_grads` order) and ``scratch`` (uint8,
    :func:`scratch_bytes`) is the launches' workspace; each is allocated
    here when not given. Returns ``(dx, out)``, dx channels-last."""
    _check_activation(x, "x", torch.channels_last)
    _check_activation(g, "g", torch.channels_last)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError("g must match x in shape and device")
    _check_kept(kept, x)
    if (pulls.dtype, pulls.shape, pulls.device) != (torch.bfloat16, (3, PULL_NUMEL), x.device) \
            or not pulls.is_contiguous():
        raise ValueError("pulls must be three RDBs' bf16 pull matrices (pack_rdb_pulls) on x's device")
    n, _, h, w = x.shape
    lib = _lib()
    if out is None:
        out = torch.empty(3 * RDB_GRAD_NUMEL, dtype=torch.float32, device=x.device)
    if scratch is None:
        scratch = torch.empty(lib.rrdb_backward_scratch(n, h, w), dtype=torch.uint8, device=x.device)
    if (out.dtype, out.numel(), out.device) != (torch.float32, 3 * RDB_GRAD_NUMEL, x.device) \
            or not out.is_contiguous():
        raise ValueError("out must be a contiguous f32 tensor of 3 * RDB_GRAD_NUMEL on x's device")
    if scratch.device != x.device or scratch.nbytes < lib.rrdb_backward_scratch(n, h, w):
        raise ValueError("scratch is smaller than rrdb_backward_scratch(n, h, w)")
    ins, hids = kept
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    rc = lib.rrdb_backward(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in hids), g.data_ptr(),
        pulls.data_ptr(), dx.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, h, w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "rrdb_backward")
    rrdb_bwd_cuda.launches += 1
    return dx, out


rrdb_bwd_cuda.launches = 0


def rrdb_bwd(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB], pulls: Optional[torch.Tensor],
    kept=None, out: Optional[torch.Tensor] = None, scratch: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 for a CUDA tensor (``pulls``, ``kept``: see :func:`rrdb_bwd_cuda`;
    in f32 its f32 route, :func:`rrdb_bwd_f32`), the plain version for a CPU
    tensor (``rdbs``, ``kept`` optional).
    Returns ``(dx, grads)``, grads flat as :func:`flat_grads` (in ``out``
    if given)."""
    if x.is_cuda:
        if kernel_route(x.dtype) == "f32":
            return rrdb_bwd_f32(x, g, rdbs, pulls, kept, out)
        return rrdb_bwd_cuda(x, g, pulls, kept, out, scratch)
    if x.device.type != "cpu":
        raise ValueError(f"no RRDB backward for device {x.device}")
    dx, grads = rrdb_bwd_plain(x, g, rdbs, kept)
    return dx, flat_grads(grads, out)


def pack_rdb_pulls_f32(convs_list: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
                       sources=None) -> torch.Tensor:
    """Each RDB's five pull kernels of K3's f32 route (``rrdb._f32_index``:
    sources x, x1..x4, each an HWIO kernel) in f32, with one gather for
    all: row r is RDB r's. ``sources`` as for ``rrdb.pack_rdbs`` (f32)."""
    src, shapes = _sources(convs_list, torch.float32) if sources is None else sources
    return src[:, _gather("pull_f32", shapes, src.device)]


def _pull_kernels(row: torch.Tensor, nf: int, gc: int) -> List[torch.Tensor]:
    """One RDB's five pull kernels of :func:`pack_rdb_pulls_f32`, HWIO:
    source s reads the cotangents of convs s+1..5 (channels ``[gc s, 4 gc
    + nf)`` of the cotangent buffer) into its own nf or gc channels."""
    shapes = [(3, 3, 4 * gc + nf - gc * s, nf if s == 0 else gc) for s in range(5)]
    return [t.view(s) for t, s in zip(row.split([math.prod(s) for s in shapes]), shapes)]


def rrdb_bwd_f32(
    x: torch.Tensor, g: torch.Tensor, rdbs: Sequence[PackedRDB], pulls: torch.Tensor, kept,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RRDB's backward on K3's f32 route (``rrdb_bwd_pallas`` with f32
    weights): per RDB, 5 pull launches of :func:`.conv_f32.conv_f32_fwd`
    and 5 :func:`.conv_f32.conv_f32_wgrad` calls (module docstring). ``x``
    and ``g`` f32 (N, nf, H, W); ``rdbs`` the packed RDBs (their shapes),
    ``pulls`` their rows of :func:`pack_rdb_pulls_f32`; ``kept`` = ``(ins,
    cats)`` from :func:`rrdb_forward_kept_f32`. Returns ``(dx, grads)``:
    dx channels-last f32, grads flat as :func:`flat_grads` (in ``out`` if
    given). The kernels for CUDA tensors, their plain versions for CPU
    ones; launches count in ``rrdb_bwd_f32.launches``."""
    _, cats = kept
    n, nf, h, w = x.shape
    gc = rdbs[0].kernels[0].shape[0]
    if g.shape != x.shape or g.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("x and g must be f32 tensors of one shape")
    if len(cats) != 3 or any(c.shape != (n, h, w, nf + 4 * gc) or c.dtype != torch.float32
                             for c in cats):
        raise ValueError(f"kept must hold three ({n}, {h}, {w}, {nf + 4 * gc}) f32 buffers")
    size = sum(9 * ci * co + co for ci, co in _widths(nf, gc))
    if out is None:
        out = torch.empty(3 * size, dtype=torch.float32, device=x.device)
    grads = rdb_grads(out, nf, gc)
    gv = nhwc(g)
    dp = torch.empty((n, h, w, 4 * gc + nf), dtype=torch.float32, device=x.device)
    d = 0.2 * gv
    launches = 0
    for j in (2, 1, 0):
        cat, pull = cats[j], _pull_kernels(pulls[j], nf, gc)
        dp[..., 4 * gc:] = 0.2 * d
        for s in (4, 3, 2, 1):
            conv_f32_fwd(dp[..., gc * s:], pull[s], dp[..., gc * (s - 1): gc * s], epi="mask_leaky",
                         m=cat[..., nf + gc * (s - 1): nf + gc * s])
        dx = torch.empty((n, h, w, nf), dtype=torch.float32, device=x.device)
        conv_f32_fwd(dp, pull[0], dx, epi="resid", r=d, r2=gv if j == 0 else None)
        for u, (cin, cout) in enumerate(_widths(nf, gc)):
            conv_f32_wgrad(cat[..., :cin], dp[..., gc * u: gc * u + cout], *(t[u] for t in grads[j]))
        launches += 5 + 5 * WGRAD_KERNELS
        d = dx
    if x.is_cuda:
        rrdb_bwd_f32.launches += launches
    return d.permute(0, 3, 1, 2), out


rrdb_bwd_f32.launches = 0
# Kernel launches of one RRDB's backward on the f32 route.
RRDB_BWD_F32_KERNELS = 3 * (5 + 5 * WGRAD_KERNELS)


def rrdb_forward_kept_f32(x: torch.Tensor, rdbs: Sequence[PackedRDB]):
    """One RRDB's forward on K1's f32 route, keeping what
    :func:`rrdb_bwd_f32` reads: ``(y, (ins, cats))``, ins the three RDBs'
    inputs, cats their dense-concat buffers (NHWC, x and x1..x4)."""
    ins, cats, y = [], [], x
    for j, p in enumerate(rdbs):
        ins.append(y)
        y, cat = rdb_f32(y, p, x if j == 2 else None, keep_hidden=True)
        cats.append(cat)
    return y, (ins, cats)


def _rdb_keep(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor]):
    """One RDB of the trunk's forward, keeping x1..x4 as (N, 4 gc, H, W):
    K1's NHWC scratch viewed channels-last on the card, the plain
    version's on the CPU."""
    if x.is_cuda:
        y, hid = rdb_cuda(x, p, res, keep_hidden=True)
        return y, hid.permute(0, 3, 1, 2)
    if x.device.type != "cpu":
        raise ValueError(f"no RDB implementation for device {x.device}")
    y, hidden = rdb_plain(x, p, res, keep_hidden=True)
    return y, torch.cat(hidden, dim=1)


def rrdb_forward_kept(x: torch.Tensor, rdbs: Sequence[PackedRDB]):
    """One RRDB's forward, one RDB call at a time as ``rrdb_trunk`` runs
    it, keeping what its backward reads: returns ``(y, (ins, hids))``, ins
    the three RDBs' inputs, hids their x1..x4 as (N, 4 gc, H, W); for an f32
    CUDA tensor :func:`rrdb_forward_kept_f32`'s."""
    if x.is_cuda and kernel_route(x.dtype) == "f32":
        return rrdb_forward_kept_f32(x, rdbs)
    ins, hids, y = [], [], x
    for j, p in enumerate(rdbs):
        ins.append(y)
        y, hid = _rdb_keep(y, p, x if j == 2 else None)
        hids.append(hid)
    return y, (ins, hids)


class TrunkFunction(torch.autograd.Function):
    """The trunk of RRDBs with the RDB forward and the RRDB backward kernels.

    ``apply(x, dtype, *params)``: ``x`` (N, C, H, W) in the working
    ``dtype``; ``params`` the f32 ``(weight OIHW, bias)`` of every RRDB's
    rdb1..rdb3 conv1..conv5, flattened in that order. The forward packs
    them afresh, so it always runs the current weights, and keeps every
    RDB's input and x1..x4 for the backward.

    On the card the forward runs K1 on a channels-last copy of ``x`` (one
    conversion; the output is channels-last), and the backward takes the
    output cotangent channels-last (converted once if it is not) and runs
    K3 once an RRDB into one grad buffer for the whole trunk; in f32 both
    take their f32 routes (:func:`.rrdb.rdb_f32`, :func:`rrdb_bwd_f32`)."""

    @staticmethod
    def forward(ctx, x, dtype, *params):
        convs = [[(params[10 * r + 2 * k], params[10 * r + 2 * k + 1]) for k in range(5)]
                 for r in range(len(params) // 10)]
        sources = _sources(convs, dtype)
        flat = pack_rdbs(convs, dtype, sources)
        packed = [flat[i: i + 3] for i in range(0, len(flat), 3)]
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        kept = []
        for rdbs in packed:
            x, k = rrdb_forward_kept(x, rdbs)
            kept.append(k)
        ctx.kept, ctx.packed, ctx.convs, ctx.dtype = kept, packed, convs, dtype
        ctx.sources, ctx.params = sources, params  # the backward's pulls, its grads' shapes
        return x

    @staticmethod
    def backward(ctx, g):
        nb = len(ctx.packed)
        size = sum(p.numel() for p in ctx.params) // nb  # one RRDB's grads
        flat = torch.empty(nb * size, dtype=torch.float32, device=g.device)
        pulls = scratch = None
        if g.is_cuda and kernel_route(g.dtype) == "f32":
            g = g.contiguous(memory_format=torch.channels_last)
            pulls = pack_rdb_pulls_f32(ctx.convs, ctx.sources)
        elif g.is_cuda:
            g = g.contiguous(memory_format=torch.channels_last)
            pulls = pack_rdb_pulls(ctx.convs, ctx.dtype, ctx.sources)
            n, _, h, w = g.shape
            scratch = torch.empty(scratch_bytes(n, h, w), dtype=torch.uint8, device=g.device)
        else:
            g = g.contiguous()
        for i in reversed(range(nb)):
            g, _ = rrdb_bwd(ctx.kept[i][0][0], g, ctx.packed[i],
                            None if pulls is None else pulls[3 * i: 3 * i + 3], ctx.kept[i],
                            flat[i * size: (i + 1) * size], scratch)
        grads = torch._utils._unflatten_dense_tensors(flat, ctx.params)
        ctx.kept = ctx.packed = ctx.convs = ctx.sources = ctx.params = None
        return (g, None, *grads)


def rrdb_bwd_flops(n: int, h: int, w: int) -> int:
    """Operations one RRDB's backward needs over the kept activations: for
    each RDB the adjoint convs and the weight grads, each one forward's
    dense 3x3 convs."""
    return 2 * 3 * rdb_flops(n, h, w)


def rrdb_bwd_first_flops(n: int, h: int, w: int) -> int:
    """Operations of :func:`rrdb_bwd_first`: :func:`rrdb_bwd_flops` and the
    forward recompute, since it keeps only the RRDB's input."""
    return 3 * 3 * rdb_flops(n, h, w)
