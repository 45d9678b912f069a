"""The f32 convolutions every kernel site's f32 route issues: the CUDA
kernels ``conv_f32_fwd`` and ``conv_f32_wgrad`` (``csrc/conv_f32.cu``,
which holds the design note and the bound) and their plain versions.

The JAX package's Pallas kernels take f32 as well as bf16 (with
``Precision.HIGHEST`` dots and f32 sums in f32: ``pallas_rrdb.py``,
``pallas_tail.py``, ``pallas_sep4d.py``). The port's ``wgmma`` kernels take
bf16 alone, so each site has an f32 route beside its bf16 one, in its own
module (:mod:`.rrdb` K1 / K2, :mod:`.rrdb_bwd` K3, :mod:`.tail` K4 / K5,
:mod:`.tail_bwd` K6, :mod:`.conv_stack` K7 / K8): the sequence of these
convolutions that the TPU kernel's function takes. :func:`kernel_route`
picks the route by the working dtype.

Every buffer is NHWC, a view whose channels are contiguous (stride 1) and
whose pixel stride may exceed its channels: a channel slice of a wider
buffer (the RDB's dense concat). A conv reads its input through the frame's
coordinates: the buffer's row 0 is frame row ``x_row0`` and the frame has
``hin`` rows, so a band of rows with its halo is read in place and the zero
padding is the frame's own border. The output rows ``[r0, r1)`` of the frame
are written at buffer rows ``r - out_row0``; the residuals and the mask are
read at the output's rows.

:func:`conv_f32_fwd` and :func:`conv_f32_wgrad` launch the kernel for a
CUDA tensor and run the plain version (:func:`conv_f32_fwd_plain`,
:func:`conv_f32_wgrad_plain`, the same arguments, ``F.conv2d`` and
``conv2d_weight`` inside) for a CPU tensor; nothing falls back. The plain
versions check and use the same row and channel addressing as the kernels,
so the CPU tests run each route's own slices, windows and packing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build

EPILOGUES = {"none": 0, "leaky": 1, "relu": 2, "resid": 3, "mask_leaky": 4, "mask_relu": 5}
# Kernel launches of one conv_f32_wgrad call: the partial sums and the reduce.
WGRAD_KERNELS = 2


def kernel_route(dtype: torch.dtype) -> str:
    """The hand-written kernels' route for a CUDA tensor of ``dtype``:
    ``"wgmma"`` for bf16 (K1-K8's ``wgmma`` kernels), ``"f32"`` for f32
    (this module's kernels). Any other dtype raises: the kernels have no
    route for it, and a run in that dtype takes the modules."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "f32"
    raise ValueError(f"the hand-written kernels take bfloat16 or float32, not {dtype}: "
                     "run with --use_pallas false to take the modules in that dtype")


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class _Fwd(ctypes.Structure):
    """``cf::Fwd`` of csrc/conv_f32.cu, field for field."""

    _fields_ = ([("x", _P)] + [(f, _L) for f in ("x_sn", "x_sy", "x_sx")]
                + [(f, _I) for f in ("x_row0", "hin", "win", "cin")]
                + [("w", _P), ("bias", _P), ("y", _P)] + [(f, _L) for f in ("y_sn", "y_sy", "y_sx")]
                + [(f, _I) for f in ("y_row0", "cout", "n", "hout", "wout", "r0", "r1", "k", "up",
                                     "pool", "epi")]
                + [("alpha", _F), ("beta", _F)]
                + [f for t in ("r", "r2", "m")
                   for f in [(t, _P), (f"{t}_sn", _L), (f"{t}_sy", _L), (f"{t}_sx", _L)]])


class _Wgrad(ctypes.Structure):
    """``cf::Wgrad`` of csrc/conv_f32.cu, field for field."""

    _fields_ = ([("x", _P)] + [(f, _L) for f in ("x_sn", "x_sy", "x_sx")]
                + [(f, _I) for f in ("hin", "win", "cin")]
                + [("dy", _P)] + [(f, _L) for f in ("d_sn", "d_sy", "d_sx")]
                + [(f, _I) for f in ("cout", "n", "hout", "wout", "k", "up", "splits")]
                + [("part", _P), ("dw", _P), ("db", _P)])


_bound = {}


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines`` selects a variant (a planted fault,
    ``-DF32_PLANT``, for the checks on the card)."""
    lib = _build.load("conv_f32", defines)
    if defines not in _bound:
        lib.conv_f32_fwd.argtypes = [ctypes.POINTER(_Fwd), _P]
        lib.conv_f32_fwd.restype = _I
        lib.conv_f32_wgrad.argtypes = [ctypes.POINTER(_Wgrad), _P]
        lib.conv_f32_wgrad.restype = _I
        lib.conv_f32_wgrad_scratch.argtypes = [ctypes.POINTER(_Wgrad)]
        lib.conv_f32_wgrad_scratch.restype = _L
        lib.conv_f32_wgrad_splits.argtypes = [_I] * 6
        lib.conv_f32_wgrad_splits.restype = _I
        _bound[defines] = lib
    return lib


class Geometry(NamedTuple):
    """One conv_f32_fwd call's shapes: output frame ``hout x wout``, output
    rows ``[r0, r1)``, the pool factor ``so`` (2 with ``pool``) and the
    padding."""

    hin: int
    win: int
    hout: int
    wout: int
    r0: int
    r1: int
    so: int
    pad: int


def _nhwc(t: torch.Tensor, what: str, device) -> None:
    if t.dim() != 4 or t.dtype != torch.float32 or (t.stride(3) != 1 and t.shape[3] > 1) or t.device != device:
        raise ValueError(f"{what} must be an f32 NHWC view (N, rows, W, C) with contiguous channels "
                         f"on {device}; got {tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}")


def geometry(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *, k: int, up: bool, pool: bool,
             hin: Optional[int], rows: Optional[Tuple[int, int]], x_row0: int, out_row0: int,
             bias: Optional[torch.Tensor] = None, extra=()) -> Geometry:
    """Checks one conv_f32_fwd call's arguments (the kernel reads and
    writes where they say, and nothing past a buffer) and returns its
    :class:`Geometry`."""
    dev = out.device
    _nhwc(x, "x", dev)
    _nhwc(out, "out", dev)
    if k not in (3, 5):
        raise ValueError(f"k must be 3 or 5, got {k}")
    if up and pool:
        raise ValueError("up and pool do not combine")
    n, xr, win, cin = x.shape
    hin = x_row0 + xr if hin is None else hin
    cout = out.shape[3]
    if (w.dtype, tuple(w.shape), w.device) != (torch.float32, (k, k, cin, cout), dev) or not w.is_contiguous():
        raise ValueError(f"w must be the contiguous f32 HWIO kernel ({k}, {k}, {cin}, {cout}) on {dev}; "
                         f"got {tuple(w.shape)} {w.dtype}")
    if bias is not None and ((bias.dtype, bias.numel(), bias.device) != (torch.float32, cout, dev)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be {cout} contiguous f32 values on {dev}")
    he, we = (2 * hin, 2 * win) if up else (hin, win)
    so = 2 if pool else 1
    if pool and (he % 2 or we % 2):
        raise ValueError(f"pool needs an even frame, got {he} x {we}")
    hout, wout = he // so, we // so
    r0, r1 = rows if rows is not None else (0, hout)
    if not 0 <= r0 < r1 <= hout:
        raise ValueError(f"output rows [{r0}, {r1}) outside the frame's {hout}")
    if out.shape[0] != n or out.shape[2] != wout or not (0 <= r0 - out_row0 and r1 - out_row0 <= out.shape[1]):
        raise ValueError(f"out {tuple(out.shape)} from row {out_row0} does not hold rows [{r0}, {r1}) "
                         f"of {n} frames {wout} wide")
    p = k // 2
    lo, hi = max(r0 * so - p, 0), min((r1 - 1) * so + so - 1 + p, he - 1)
    lo, hi = (lo >> 1, hi >> 1) if up else (lo, hi)
    if lo < x_row0 or hi >= x_row0 + xr:
        raise ValueError(f"x holds frame rows [{x_row0}, {x_row0 + xr}); rows [{r0}, {r1}) read "
                         f"[{lo}, {hi}]")
    for t, what in extra:
        if t is None:
            continue
        _nhwc(t, what, dev)
        if t.shape[0] != n or t.shape[2] != wout or t.shape[3] != cout or r1 - out_row0 > t.shape[1]:
            raise ValueError(f"{what} {tuple(t.shape)} does not match the output's rows and channels")
    return Geometry(hin, win, hout, wout, r0, r1, so, p)


def conv_f32_fwd_plain(x, w, out, *, bias=None, k=3, up=False, pool=False, hin=None, rows=None,
                       x_row0=0, out_row0=0, epi="none", alpha=1.0, beta=1.0, r=None, r2=None,
                       m=None) -> torch.Tensor:
    """The plain version of :func:`conv_f32_fwd`, on any device: the input
    rows the kernel reads gathered from the buffer (zero outside the
    frame), upsampled with ``up``, one ``F.conv2d``, the 2x2 sums with
    ``pool``, the bias and the epilogue; written into ``out``'s rows."""
    g = geometry(x, w, out, k=k, up=up, pool=pool, hin=hin, rows=rows, x_row0=x_row0,
                 out_row0=out_row0, bias=bias, extra=((r, "r"), (r2, "r2"), (m, "m")))
    he = 2 * g.hin if up else g.hin
    ys = torch.arange(g.r0 * g.so - g.pad, (g.r1 - 1) * g.so + g.so + g.pad, device=x.device)
    valid = (ys >= 0) & (ys < he)
    src = ((ys.clamp(0, he - 1) >> int(up)) - x_row0).clamp(0, x.shape[1] - 1)
    xin = torch.where(valid.view(1, -1, 1, 1), x[:, src], 0.0)
    if up:
        xin = xin.repeat_interleave(2, dim=2)
    xin = F.pad(xin.permute(0, 3, 1, 2), (g.pad, g.pad))
    y = F.conv2d(xin, w.permute(3, 2, 0, 1))
    n, cout = y.shape[:2]
    if pool:
        y = y.view(n, cout, g.r1 - g.r0, 2, g.wout, 2).sum(dim=(3, 5))
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    sl = slice(g.r0 - out_row0, g.r1 - out_row0)
    if epi == "leaky":
        y = torch.where(y >= 0, y, 0.2 * y)
    elif epi == "relu":
        y = torch.relu(y)
    elif epi == "resid":
        y = alpha * y + r[:, sl]
        if r2 is not None:
            y = beta * y + r2[:, sl]
    elif epi == "mask_leaky":
        y = torch.where(m[:, sl] >= 0, y, 0.2 * y)
    elif epi == "mask_relu":
        y = torch.where(m[:, sl] > 0, y, torch.zeros_like(y))
    elif epi != "none":
        raise ValueError(f"unknown epilogue {epi!r}")
    out[:, sl] = y
    return out


def _strides(t: Optional[torch.Tensor]):
    return (None, 0, 0, 0) if t is None else (t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def conv_f32_fwd_cuda(x, w, out, *, bias=None, k=3, up=False, pool=False, hin=None, rows=None,
                      x_row0=0, out_row0=0, epi="none", alpha=1.0, beta=1.0, r=None, r2=None,
                      m=None) -> torch.Tensor:
    """One launch of ``csrc/conv_f32.cu:conv_f32_fwd`` (arguments as
    :func:`conv_f32_fwd`) on CUDA tensors; counts it in
    ``conv_f32_fwd_cuda.launches``."""
    if not out.is_cuda:
        raise ValueError("conv_f32_fwd_cuda takes CUDA tensors")
    if epi not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epi!r}")
    if (epi == "resid") != (r is not None) or (epi.startswith("mask") != (m is not None)):
        raise ValueError(f"epilogue {epi!r}: r with 'resid', m with a mask, and not otherwise")
    g = geometry(x, w, out, k=k, up=up, pool=pool, hin=hin, rows=rows, x_row0=x_row0,
                 out_row0=out_row0, bias=bias, extra=((r, "r"), (r2, "r2"), (m, "m")))
    d = _Fwd(x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), x_row0, g.hin, g.win, x.shape[3],
             w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), out.stride(0),
             out.stride(1), out.stride(2), out_row0, out.shape[3], x.shape[0], g.hout, g.wout, g.r0,
             g.r1, k, int(up), int(pool), EPILOGUES[epi], alpha, beta, *_strides(r), *_strides(r2),
             *_strides(m))
    lib = _lib()
    _build.check(lib, lib.conv_f32_fwd(ctypes.byref(d), torch.cuda.current_stream(out.device).cuda_stream),
                 "conv_f32_fwd")
    conv_f32_fwd_cuda.launches += 1
    return out


conv_f32_fwd_cuda.launches = 0


def conv_f32_fwd(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, **kw) -> torch.Tensor:
    """One k x k conv (k = 3 or 5, stride 1, zero padding at the frame's
    border) of NHWC ``x`` into ``out``'s rows, both f32 views with
    contiguous channels: ``w`` the contiguous HWIO kernel ``(k, k, Cin,
    Cout)``, ``bias`` f32 or None. ``up`` reads ``x`` through nearest x2
    upsampling; ``pool`` writes the 2x2 sums of the outputs (the adjoint of
    ``up``). ``hin`` is the input frame's rows (``x_row0 + rows of x`` by
    default), ``rows = (r0, r1)`` the output rows (all by default). ``epi``:
    ``"none"``, ``"leaky"`` (0.2), ``"relu"``, ``"resid"`` (``alpha * acc +
    r``, then ``beta * . + r2`` where ``r2`` is given) or ``"mask_leaky"`` /
    ``"mask_relu"`` (the slope of the activation whose output is ``m``).
    The kernel for a CUDA tensor, the plain version for a CPU tensor.
    Returns ``out``."""
    if out.is_cuda:
        return conv_f32_fwd_cuda(x, w, out, **kw)
    if out.device.type != "cpu":
        raise ValueError(f"no f32 conv for device {out.device}")
    return conv_f32_fwd_plain(x, w, out, **kw)


def _wgrad_args(x, dy, dw, db, k, up):
    dev = dy.device
    _nhwc(x, "x", dev)
    _nhwc(dy, "dy", dev)
    n, hin, win, cin = x.shape
    he, we = (2 * hin, 2 * win) if up else (hin, win)
    cout = dy.shape[3]
    if k not in (3, 5) or dy.shape[:3] != (n, he, we):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of a {k}x{k} conv of x {tuple(x.shape)}"
                         + (" read through x2" if up else ""))
    for t, shape, what in ((dw, (cout, cin, k, k), "dw"), (db, (cout,), "db")):
        if (t.dtype, tuple(t.shape), t.device) != (torch.float32, shape, dev) or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous f32 {shape} on {dev}")
    return n, hin, win, cin, he, we, cout


def conv_f32_wgrad_plain(x, dy, dw, db, *, k=3, up=False):
    """The plain version of :func:`conv_f32_wgrad` on any device:
    ``conv2d_weight`` of the (upsampled) input and ``dy``'s sums."""
    _wgrad_args(x, dy, dw, db, k, up)
    xe = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) if up else x
    dw.copy_(torch.nn.grad.conv2d_weight(xe.permute(0, 3, 1, 2), dw.shape, dy.permute(0, 3, 1, 2),
                                         padding=k // 2))
    db.copy_(dy.sum(dim=(0, 1, 2)))
    return dw, db


def conv_f32_wgrad_cuda(x, dy, dw, db, *, k=3, up=False):
    """One ``csrc/conv_f32.cu:conv_f32_wgrad`` call (its partial sums and
    their reduce, :data:`WGRAD_KERNELS` launches, counted in
    ``conv_f32_wgrad_cuda.launches``) on CUDA tensors; the partial sums in
    scratch made here."""
    if not dy.is_cuda:
        raise ValueError("conv_f32_wgrad_cuda takes CUDA tensors")
    n, hin, win, cin, he, we, cout = _wgrad_args(x, dy, dw, db, k, up)
    lib = _lib()
    splits = lib.conv_f32_wgrad_splits(n, he, we, k, cin, cout)
    d = _Wgrad(x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), hin, win, cin, dy.data_ptr(),
               dy.stride(0), dy.stride(1), dy.stride(2), cout, n, he, we, k, int(up), splits,
               None, dw.data_ptr(), db.data_ptr())
    part = torch.empty(lib.conv_f32_wgrad_scratch(ctypes.byref(d)), dtype=torch.float32, device=dy.device)
    d.part = part.data_ptr()
    _build.check(lib, lib.conv_f32_wgrad(ctypes.byref(d), torch.cuda.current_stream(dy.device).cuda_stream),
                 "conv_f32_wgrad")
    conv_f32_wgrad_cuda.launches += WGRAD_KERNELS
    return dw, db


conv_f32_wgrad_cuda.launches = 0


def conv_f32_wgrad(x: torch.Tensor, dy: torch.Tensor, dw: torch.Tensor, db: torch.Tensor, *,
                   k: int = 3, up: bool = False):
    """One k x k conv's weight and bias grads: ``x`` the conv's NHWC input
    (read through x2 with ``up``), ``dy`` the cotangent of its output (both
    f32 views with contiguous channels, whole frames); writes ``dw`` (OIHW
    ``(Cout, Cin, k, k)``) and ``db`` (``Cout``). The kernel for a CUDA
    tensor, the plain version for a CPU tensor. Returns ``(dw, db)``."""
    if dy.is_cuda:
        return conv_f32_wgrad_cuda(x, dy, dw, db, k=k, up=up)
    if dy.device.type != "cpu":
        raise ValueError(f"no f32 conv for device {dy.device}")
    return conv_f32_wgrad_plain(x, dy, dw, db, k=k, up=up)


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW kernel -> the contiguous f32 HWIO kernel conv_f32_fwd reads."""
    return w.detach().float().permute(2, 3, 1, 0).contiguous()


def adjoint_hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW kernel -> the HWIO kernel of its adjoint conv (transposed,
    flipped): ``[ky, kx, o, c] = w[o, c, k - 1 - ky, k - 1 - kx]``."""
    return w.detach().float().flip(2, 3).permute(2, 3, 0, 1).contiguous()


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """The NHWC view of a channels-last ``(N, C, H, W)`` tensor (a copy
    where it is not channels-last)."""
    return t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
