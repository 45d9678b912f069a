"""The RRDB trunk: weight packing, plain versions and the CUDA RDB kernel
(master_thesis_tpu/ops/pallas_rrdb.py: rrdb_pallas, rrdb_trunk_pallas,
rrdb_trunk_pallas_banded, _split_rdb_weights, rrdb_trunk_xla).

An RRDB is three residual dense blocks (RDBs) and a residual:
``rrdb(x) = 0.2 * rdb3(rdb2(rdb1(x))) + x``. Each RDB runs five dense 3x3
convs, ``x_k = lrelu(conv_k(cat(x, x1..x_{k-1})))`` for k < 5, and returns
``0.2 * conv5(cat(x, x1..x4)) + x``.

The CUDA kernel (``csrc/rrdb.cu``, ``csrc/conv3x3_wgmma.cuh``) runs one RDB
per ctypes call as five implicit-GEMM convs on wgmma, so an RRDB is three
calls and the third adds the RRDB residual in its epilogue. Layout on the
card: the trunk's activations are channels-last (``torch.channels_last``
tensors of shape (N, 64, H, W)), and each call keeps x1..x4 in one NHWC
scratch tensor of 128 channels. The banded trunk (K2,
:func:`rrdb_trunk_banded`) runs the same convs once per row band of every
frame, each conv over the band's rows widened by the halo the later convs
read, x read in place from the frame.

Rounding, shared by the kernel and :func:`rdb_plain`: conv operands and
x1..x4 in the working dtype, sums, bias and lrelu in f32, the RDB output
rounded to the working dtype before the RRDB residual.

In f32 (:func:`rdb_f32`, :func:`rdb_banded_f32`) an RDB is five launches
of :func:`.conv_f32.conv_f32_fwd` over one NHWC buffer of ``nf + 4 gc``
channels, the dense concat: x copied into its first nf channels, conv k
reading the first ``nf + (k - 1) gc`` and writing its own gc, conv5 adding
the residuals in its epilogue. Sums, operands and the kept activations are
f32, as the TPU kernel takes them under ``Precision.HIGHEST``. :func:`rdb`
and :func:`rrdb_trunk_banded` pick the route by the working dtype
(:func:`.conv_f32.kernel_route`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import fragments
from master_thesis_tpu_torch.ops.conv_f32 import conv_f32_fwd, kernel_route, nhwc
from master_thesis_tpu_torch.models.nn_ext import leaky_relu

# Channel widths the CUDA kernel is compiled for (the production RRDBNet).
KERNEL_NF, KERNEL_GC = 64, 32


class PackedRDB(NamedTuple):
    """One RDB's weights in the layouts both versions read, made once per
    weight set by :func:`pack_rdb`."""

    w: torch.Tensor  # mma.sync B fragments (the first K1 / K3 designs; working dtype)
    b: torch.Tensor  # the five biases, concatenated (f32)
    kernels: Tuple[torch.Tensor, ...]  # conv1..conv5 OIHW (working dtype)
    wg: Optional[torch.Tensor] = None  # K1 / K2's wgmma B blocks (working dtype)
    hwio: Optional[torch.Tensor] = None  # the f32 route's five HWIO kernels (f32 only)


def _widths(nf: int, gc: int):
    """(input width, output width) of conv1..conv5."""
    return [(nf + k * gc, gc) for k in range(4)] + [(nf + 4 * gc, nf)]


def pack_rdb(
    convs: Sequence[Tuple[torch.Tensor, torch.Tensor]], dtype: torch.dtype
) -> PackedRDB:
    """Five ``(weight OIHW, bias)`` pairs -> :class:`PackedRDB`.

    ``wg`` concatenates each conv's kernel in the block order of
    :func:`.fragments.wgmma_conv_matrix`: the B operand of K1 / K2's
    implicit GEMMs (made where every conv's input width is a multiple of
    32, else None). ``w`` concatenates each as a ``(9 * Cin_k, out_k)``
    matrix, rows ordered ``(ky, kx, c)`` (HWIO flattened), in the mma.sync
    fragment order of :mod:`.fragments`, which the first K1 and K3 designs read.
    ``kernels`` keeps the OIHW weights for :func:`rdb_plain`.

    The TPU kernel regroups the convs per *source* tensor
    (``_split_rdb_weights``) because it holds whole frames, where every
    source's contributions exist at once. The CUDA kernel runs each conv as
    one GEMM over its concatenated input instead; :func:`rdb_plain` keeps
    the per-source regrouping.
    """
    return pack_rdbs([convs], dtype)[0]


@functools.lru_cache(maxsize=None)
def _gather(kind: str, shapes: Tuple[Tuple[int, ...], ...], device) -> torch.Tensor:
    """The gather index that packs one RDB of conv ``shapes``
    (``fragments.gather_index``), made once per layout and device."""
    with torch.inference_mode(False):  # usable in training after serving
        if kind == "pull":  # one layout over all five convs
            sizes = [math.prod(s) for s in shapes]
            pos = torch.arange(sum(sizes)).split(sizes)
            return fragments.wgmma_pull_matrix([p.view(s) for p, s in zip(pos, shapes)]).to(device)
        if kind in ("hwio", "pull_f32"):
            return _f32_index(kind, shapes).to(device)
        layout = {"conv": fragments.conv_matrix, "wgmma": fragments.wgmma_conv_matrix,
                  "adjoint": lambda w, fill: fragments.adjoint_matrix(w, fill=fill)}[kind]
        return fragments.gather_index([layout] * len(shapes), shapes).to(device)


def _f32_index(kind: str, shapes) -> torch.Tensor:
    """Positions in one RDB's flat OIHW kernels (``_sources``) of the f32
    route's operands: ``"hwio"`` each conv's HWIO kernel, conv1..conv5;
    ``"pull_f32"`` each source's pull kernel (x, then x1..x4), the HWIO
    kernel of one adjoint conv from the cotangents of every conv the source
    feeds (their pre-activation cotangents in conv order, as K3's f32
    route stores them) to the source's channels:
    ``[ky, kx, (u, o), c] = conv_u[o, lo + c, 2 - ky, 2 - kx]``."""
    sizes = [math.prod(s) for s in shapes]
    views = [p.view(s) for p, s in zip(torch.arange(sum(sizes)).split(sizes), shapes)]
    if kind == "hwio":
        return torch.cat([v.permute(2, 3, 1, 0).reshape(-1) for v in views])
    nf, gc = shapes[4][0], shapes[0][0]
    parts = []
    for s in range(5):
        lo, width = (0, nf) if s == 0 else (nf + (s - 1) * gc, gc)
        m = torch.cat([views[u][:, lo:lo + width] for u in range(s, 5)])
        parts.append(m.flip(2, 3).permute(2, 3, 0, 1).reshape(-1))
    return torch.cat(parts)


def hwio_kernels(p: PackedRDB) -> List[torch.Tensor]:
    """The five HWIO kernels of ``p.hwio``, conv1..conv5."""
    shapes = [tuple(k.shape) for k in p.kernels]
    parts = p.hwio.split([math.prod(s) for s in shapes])
    return [t.view(s[2], s[3], s[1], s[0]) for t, s in zip(parts, shapes)]


def _sources(convs_list, dtype: torch.dtype):
    """The weights of many RDBs in ``dtype``, one row per RDB (its convs'
    OIHW kernels flattened, then a zero), and their conv shapes."""
    shapes = tuple(tuple(w.shape) for w, _ in convs_list[0])
    flat = torch.cat([w.detach().reshape(-1) for convs in convs_list for w, _ in convs])
    src = F.pad(flat.to(dtype).view(len(convs_list), -1), (0, 1))
    return src, shapes


def pack_rdbs(convs_list: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
              dtype: torch.dtype, sources=None) -> List[PackedRDB]:
    """:func:`pack_rdb` for many RDBs of the same widths, with one gather
    per layout for all their kernel matrices (the training forward packs
    the whole trunk on every step). ``sources``: ``_sources(convs_list,
    dtype)`` if the caller has it already."""
    src, shapes = _sources(convs_list, dtype) if sources is None else sources
    w = src[:, _gather("conv", shapes, src.device)]
    wgmma = all(s[1] % 32 == 0 and s[0] % 8 == 0 for s in shapes)
    wg = src[:, _gather("wgmma", shapes, src.device)] if wgmma else None
    f32 = src[:, _gather("hwio", shapes, src.device)] if dtype == torch.float32 else None
    b = torch.cat([bias.detach().reshape(-1) for convs in convs_list for _, bias in convs])
    b = b.float().view(len(convs_list), -1)
    sizes = [math.prod(s) for s in shapes]
    return [
        PackedRDB(w[r], b[r], tuple(k.view(s) for k, s in zip(src[r, :-1].split(sizes), shapes)),
                  None if wg is None else wg[r], None if f32 is None else f32[r])
        for r in range(len(convs_list))
    ]


def pack_rdb_adjoints(convs_list: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
                      dtype: torch.dtype) -> List[List[torch.Tensor]]:
    """Each RDB's five adjoint B matrices (``fragments.adjoint_matrix``) in
    ``dtype``, as ``_rrdb_adj_weights`` rounds them, with one gather for
    all: ``out[r][k]`` is RDB r's conv k+1."""
    src, shapes = _sources(convs_list, dtype)
    adj = src[:, _gather("adjoint", shapes, src.device)]
    sizes = [fragments.numel(9 * s[0], s[1]) for s in shapes]
    return [list(adj[r].split(sizes)) for r in range(len(convs_list))]


def pack_rdb_pulls(convs_list: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
                   dtype: torch.dtype, sources=None) -> torch.Tensor:
    """Each RDB's five pull matrices (``fragments.wgmma_pull_matrix``, the
    B operands of K3's adjoint convs) in ``dtype``, as ``_rrdb_adj_weights``
    rounds them, with one gather for all: row r is RDB r's, sources 0..4.
    ``sources`` as for :func:`pack_rdbs`."""
    src, shapes = _sources(convs_list, dtype) if sources is None else sources
    return src[:, _gather("pull", shapes, src.device)]


def rdb_plain(
    x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None,
    keep_hidden: bool = False,
):
    """Plain PyTorch RDB on NCHW ``x`` in its dtype, after ``rrdb_trunk_xla``:
    one conv per source tensor into every conv it feeds. With ``res``
    returns ``0.2 * rdb(x) + res`` (the RRDB residual). With
    ``keep_hidden`` returns ``(y, [x1, .., x4])``, the hidden activations in
    x's dtype (the backward's recompute, ``_rdb_fwd_block(keep_hidden)``)."""
    dt = x.dtype
    outs = [k.shape[0] for k in p.kernels]
    nf, gc = outs[4], outs[0]
    bs = p.b.split(outs)

    def conv_from(src: torch.Tensor, s: int) -> torch.Tensor:
        lo = 0 if s == 0 else nf + (s - 1) * gc
        hi = nf if s == 0 else lo + gc
        wcat = torch.cat([p.kernels[t][:, lo:hi] for t in range(s, 5)])
        return F.conv2d(src.float(), wcat.float(), padding=1)

    acc = list(conv_from(x, 0).split(outs, dim=1))
    hidden = []
    for k in range(4):
        xk = leaky_relu(acc[k] + bs[k].view(1, -1, 1, 1)).to(dt)
        hidden.append(xk)
        pieces = conv_from(xk, k + 1).split(outs[k + 1:], dim=1)
        for idx, piece in enumerate(pieces):
            acc[k + 1 + idx] = acc[k + 1 + idx] + piece
    y = (0.2 * (acc[4] + bs[4].view(1, -1, 1, 1)) + x.float()).to(dt)
    if res is not None:
        y = (0.2 * y.float() + res.float()).to(dt)
    return (y, hidden) if keep_hidden else y


def _check_activation(t: torch.Tensor, what: str,
                      memory_format: torch.memory_format = torch.contiguous_format) -> None:
    """A bf16 CUDA activation of shape (N, 64, H, W), dense in
    ``memory_format`` (the trunk's kernels take channels-last, K3 NCHW)."""
    layout = "channels-last" if memory_format == torch.channels_last else "contiguous NCHW"
    if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous(memory_format=memory_format):
        raise ValueError(f"{what} must be a {layout} bfloat16 CUDA tensor")
    if t.dim() != 4 or t.shape[1] != KERNEL_NF:
        raise ValueError(f"{what} must be (N, {KERNEL_NF}, H, W), got {tuple(t.shape)}")


_RDB_W_NUMEL = sum(fragments.numel(9 * cin, cout) for cin, cout in _widths(KERNEL_NF, KERNEL_GC))
_RDB_B_NUMEL = sum(cout for _, cout in _widths(KERNEL_NF, KERNEL_GC))


def _rdb_lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("rrdb", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rdb_forward.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    lib.rdb_forward.restype = ci
    lib.rdb_forward_rows.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.rdb_forward_rows.restype = ci
    lib.rdb_conv.argtypes = [ci] + [vp] * 6 + [ci] * 3 + [vp]
    lib.rdb_conv.restype = ci
    return lib


def _check_rdb_args(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor]) -> None:
    _check_activation(x, "x", torch.channels_last)
    if res is not None:
        _check_activation(res, "res", torch.channels_last)
        if res.shape != x.shape or res.device != x.device:
            raise ValueError("res must match x in shape and device")
    w, b = p.wg, p.b
    if (w is None or (w.dtype, w.numel(), w.device) != (torch.bfloat16, _RDB_W_NUMEL, x.device)
            or not w.is_contiguous() or w.data_ptr() % 16):
        raise ValueError(
            f"wg must be a bf16 RDB packed (pack_rdb) for nf={KERNEL_NF}, gc={KERNEL_GC} on x's device"
        )
    if (b.dtype, b.numel(), b.device) != (torch.float32, _RDB_B_NUMEL, x.device) or not b.is_contiguous():
        raise ValueError("b must be the packed f32 RDB biases on x's device")


def _hidden(n: int, rows: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """Scratch for x1..x4: (n, rows, w, 4 gc), NHWC."""
    return torch.empty((n, rows, w, 4 * KERNEL_GC), dtype=like.dtype, device=like.device)


def rdb_cuda(
    x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None, keep_hidden: bool = False,
):
    """One RDB through the CUDA kernel (``csrc/rrdb.cu``: five wgmma convs,
    one ctypes call), nf=64, gc=32, bf16.

    ``x`` (and ``res``) must be channels-last: shape (N, 64, H, W) with
    ``x.is_contiguous(memory_format=torch.channels_last)``; a contiguous
    NCHW tensor is refused. The output is channels-last too. With ``res``
    the epilogue adds the RRDB residual. With ``keep_hidden`` returns
    ``(out, h)``, h the x1..x4 scratch, (N, H, W, 128) NHWC."""
    _check_rdb_args(x, p, res)
    n, _, h, wd = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    hid = _hidden(n, h, wd, x)
    lib = _rdb_lib()
    rc = lib.rdb_forward(
        x.data_ptr(), None if res is None else res.data_ptr(), p.wg.data_ptr(),
        p.b.data_ptr(), out.data_ptr(), hid.data_ptr(), n, h, wd,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "rdb_forward")
    rdb_cuda.launches += 1
    return (out, hid) if keep_hidden else out


rdb_cuda.launches = 0
# Kernel launches a K1 call makes (one per conv).
RDB_CONVS = 5


def rdb_conv_cuda(k: int, x: torch.Tensor, p: PackedRDB, out: torch.Tensor,
                  hid: torch.Tensor) -> None:
    """Conv k (1..5) of :func:`rdb_cuda` alone (``csrc/rrdb.cu:rdb_conv``),
    to time each conv against its floor; no path of the port calls it.
    x1..x_{k-1} are read from ``hid`` (as :func:`rdb_cuda` with
    ``keep_hidden`` returns it); conv1-4 write x_k into ``hid``, conv5
    writes ``out``. Adds to no launch count."""
    _check_rdb_args(x, p, None)
    n, _, h, wd = x.shape
    if out.shape != x.shape or hid.shape != (n, h, wd, 4 * KERNEL_GC):
        raise ValueError("out must match x and hid be (N, H, W, 128)")
    lib = _rdb_lib()
    rc = lib.rdb_conv(k, x.data_ptr(), None, p.wg.data_ptr(), p.b.data_ptr(), out.data_ptr(),
                      hid.data_ptr(), n, h, wd, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rdb_conv")

# Rows of halo a band of one RDB needs: one per conv (_BAND_HALO).
BAND_HALO = 5
# The banded trunk's default band height on the card (the TPU kernel's
# band height, _band_rows, came from its VMEM budget).
TRUNK_BAND_ROWS = 32


def bands(h: int, band_rows: int) -> List[Tuple[int, int]]:
    """The row bands ``[r0, r1)`` of a frame of ``h`` rows, ``band_rows``
    each (the last one shorter when it does not divide ``h``)."""
    if band_rows <= 0:
        raise ValueError(f"band_rows must be positive, got {band_rows}")
    return [(r0, min(r0 + band_rows, h)) for r0 in range(0, h, band_rows)]


def band_windows(h: int, r0: int, r1: int) -> List[Tuple[int, int]]:
    """The frame rows ``[lo, hi)`` conv1..conv5 compute for the band
    ``[r0, r1)`` of a frame of ``h`` rows (``csrc/rrdb.cu:
    rdb_forward_rows``): conv k widens the band by the ``5 - k`` convs
    after it, clipped at the frame. Conv1's window is the band scratch's."""
    return [(max(r0 - (BAND_HALO - k), 0), min(r1 + (BAND_HALO - k), h))
            for k in range(1, BAND_HALO + 1)]


def rdb_banded_cuda(
    x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None,
    band_rows: int = TRUNK_BAND_ROWS,
) -> torch.Tensor:
    """One RDB through the CUDA kernel in row bands (K2): one ctypes call
    (five conv launches) per band of every frame, x1..x4 in band-sized
    scratch reused by every band. Channels-last like :func:`rdb_cuda`,
    whose output it equals."""
    _check_rdb_args(x, p, res)
    n, _, h, wd = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    spans = bands(h, band_rows)
    rows = max(hi - lo for lo, hi in (band_windows(h, r0, r1)[0] for r0, r1 in spans))
    hid = _hidden(n, rows, wd, x)
    lib = _rdb_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0, r1 in spans:
        rc = lib.rdb_forward_rows(
            x.data_ptr(), None if res is None else res.data_ptr(), p.wg.data_ptr(),
            p.b.data_ptr(), out.data_ptr(), hid.data_ptr(), n, h, wd, r0, r1, stream,
        )
        _build.check(lib, rc, "rdb_forward_rows")
        rdb_banded_cuda.launches += 1
    return out


rdb_banded_cuda.launches = 0


def rdb_banded_plain(
    x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None,
    band_rows: int = TRUNK_BAND_ROWS,
) -> torch.Tensor:
    """:func:`rdb_plain` in the TPU kernel's band decomposition
    (``rrdb_trunk_pallas_banded``): each band of rows with a
    :data:`BAND_HALO`-row halo, clipped at the frame so the conv's zero
    padding there is the frame's own border, through :func:`rdb_plain`;
    only the band's own rows are kept."""
    h = x.shape[2]
    outs = []
    for r0, r1 in bands(h, band_rows):
        lo, hi = max(r0 - BAND_HALO, 0), min(r1 + BAND_HALO, h)
        y = rdb_plain(x[:, :, lo:hi], p, None if res is None else res[:, :, lo:hi])
        outs.append(y[:, :, r0 - lo: r1 - lo])
    return torch.cat(outs, dim=2)


def _check_f32(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor]) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or x.shape[1] != p.kernels[4].shape[0]:
        raise ValueError(f"x must be an f32 (N, {p.kernels[4].shape[0]}, H, W) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype or res.device != x.device):
        raise ValueError("res must match x in shape, dtype and device")
    if p.hwio is None or p.hwio.device != x.device or p.b.device != x.device:
        raise ValueError("the RDB must be packed in float32 (pack_rdb) on x's device")


def _rdb_convs_f32(cat: torch.Tensor, p: PackedRDB, out: torch.Tensor, res_x: torch.Tensor,
                   res: Optional[torch.Tensor], windows=None, x_row0: int = 0, hin=None) -> None:
    """The five convs of an RDB over the dense-concat buffer ``cat`` (NHWC,
    x in its first nf channels): conv1..conv4 into ``cat``, conv5 into
    ``out`` with ``0.2 * (0.2 * acc + res_x) + res`` (``0.2 * acc + res_x``
    without ``res``). ``windows``: each conv's output rows (a band's, with
    ``cat`` holding frame rows from ``x_row0`` and ``out`` / ``res_x`` /
    ``res`` whole frames), else whole frames."""
    ks = hwio_kernels(p)
    outs = [k.shape[0] for k in p.kernels]
    nf, gc = outs[4], outs[0]
    bs = p.b.split(outs)
    rows = lambda k: {} if windows is None else dict(rows=windows[k], hin=hin, x_row0=x_row0,
                                                      out_row0=x_row0)
    for k in range(4):
        cin = nf + k * gc
        conv_f32_fwd(cat[..., :cin], ks[k], cat[..., cin:cin + gc], bias=bs[k], epi="leaky", **rows(k))
    last = {} if windows is None else dict(rows=windows[4], hin=hin, x_row0=x_row0)
    conv_f32_fwd(cat, ks[4], out, bias=bs[4], epi="resid", alpha=0.2, r=res_x, beta=0.2, r2=res, **last)


def rdb_f32(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None,
            keep_hidden: bool = False):
    """One RDB's f32 route (K1 in f32, ``rrdb_pallas`` with f32 weights):
    five :func:`.conv_f32.conv_f32_fwd` launches over one NHWC buffer of
    ``nf + 4 gc`` channels (x copied into the first nf). ``x`` (and
    ``res``) f32 ``(N, nf, H, W)``, any layout; the output is channels-last.
    With ``res`` conv5's epilogue adds the RRDB residual. With
    ``keep_hidden`` returns ``(out, cat)``, cat the NHWC buffer (x and
    x1..x4, K3's f32 route reads it). The kernels for a CUDA tensor, their
    plain versions for a CPU one; launches count in ``rdb_f32.launches``."""
    _check_f32(x, p, res)
    n, nf, h, w = x.shape
    cat = torch.empty((n, h, w, nf + 4 * p.kernels[0].shape[0]), dtype=x.dtype, device=x.device)
    cat[..., :nf] = nhwc(x)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    _rdb_convs_f32(cat, p, nhwc(out), cat[..., :nf], None if res is None else nhwc(res))
    if x.is_cuda:
        rdb_f32.launches += RDB_CONVS
    return (out, cat) if keep_hidden else out


rdb_f32.launches = 0


def rdb_banded_f32(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None,
                   band_rows: int = TRUNK_BAND_ROWS) -> torch.Tensor:
    """One RDB's f32 route in row bands (K2 in f32,
    ``rrdb_trunk_pallas_banded``): per band the frame rows
    ``[r0 - 5, r1 + 5)`` of x copied into a band-sized dense-concat buffer
    (made once, reused by every band), conv k computing the rows of
    :func:`band_windows`, conv5 writing the band's own rows into the output
    with x and ``res`` read in place from their frames. Equals
    :func:`rdb_f32` (the same sums in the same order); launches count in
    ``rdb_banded_f32.launches``."""
    _check_f32(x, p, res)
    n, nf, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    xv, ov, rv = nhwc(x), nhwc(out), None if res is None else nhwc(res)
    spans = bands(h, band_rows)
    halo = [(max(r0 - BAND_HALO, 0), min(r1 + BAND_HALO, h)) for r0, r1 in spans]
    cat = torch.empty((n, max(hi - lo for lo, hi in halo), w, nf + 4 * p.kernels[0].shape[0]),
                      dtype=x.dtype, device=x.device)
    for (r0, r1), (lo, hi) in zip(spans, halo):
        band = cat[:, :hi - lo]
        band[..., :nf] = xv[:, lo:hi]
        _rdb_convs_f32(band, p, ov, xv, rv, band_windows(h, r0, r1), lo, h)
        if x.is_cuda:
            rdb_banded_f32.launches += RDB_CONVS
    return out


rdb_banded_f32.launches = 0


def rdb(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels for a CUDA tensor (the wgmma kernel in bf16, the f32
    route in f32; :func:`.conv_f32.kernel_route`), the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return (rdb_f32 if kernel_route(x.dtype) == "f32" else rdb_cuda)(x, p, res)
    if x.device.type != "cpu":
        raise ValueError(f"no RDB implementation for device {x.device}")
    return rdb_plain(x, p, res)


def rrdb_trunk(
    x: torch.Tensor, packed: Sequence[Sequence[PackedRDB]], rdb_fn=rdb
) -> torch.Tensor:
    """The trunk of ``len(packed)`` RRDBs on ``x`` (N, 64, H, W), working
    dtype: channels-last for the kernel on the card, any layout on the CPU
    and for ``rdb_fn=rdb_plain``, which runs the plain version on any device
    (the comparison on the card). ``packed[i]`` holds RRDB i's three packed
    RDBs."""
    for rdbs in packed:
        y = x
        for j, p in enumerate(rdbs):
            y = rdb_fn(y, p, res=x if j == 2 else None)
        x = y
    return x


def rrdb_trunk_banded(
    x: torch.Tensor, packed: Sequence[Sequence[PackedRDB]], band_rows: int = 0
) -> torch.Tensor:
    """The trunk with every RDB in row bands of ``band_rows`` rows
    (:data:`TRUNK_BAND_ROWS` for 0): K2 for a CUDA tensor (in bf16 or, on
    its f32 route, f32), the plain band decomposition for a CPU tensor."""
    br = band_rows or TRUNK_BAND_ROWS
    if x.is_cuda:
        fn = rdb_banded_f32 if kernel_route(x.dtype) == "f32" else rdb_banded_cuda
        return rrdb_trunk(x, packed, rdb_fn=functools.partial(fn, band_rows=br))
    if x.device.type != "cpu":
        raise ValueError(f"no RDB implementation for device {x.device}")
    return rrdb_trunk_banded_plain(x, packed, br)


def rrdb_trunk_banded_plain(
    x: torch.Tensor, packed: Sequence[Sequence[PackedRDB]], band_rows: int = 0
) -> torch.Tensor:
    """The plain banded trunk (:func:`rdb_banded_plain` for every RDB) on
    any device."""
    br = band_rows or TRUNK_BAND_ROWS
    return rrdb_trunk(x, packed, rdb_fn=functools.partial(rdb_banded_plain, band_rows=br))


def rdb_flops(n: int, h: int, w: int, nf: int = KERNEL_NF, gc: int = KERNEL_GC) -> int:
    """Multiply-adds x2 of one RDB at the reference's 3x3 convs."""
    return 2 * n * h * w * 9 * sum(cin * cout for cin, cout in _widths(nf, gc))


def rdb_conv_cost(k: int, n: int, h: int, w: int, nf: int = KERNEL_NF,
                  gc: int = KERNEL_GC) -> Tuple[int, int]:
    """(FLOPs, bytes) of conv k (1..5) of an RDB run on its own: its dense
    3x3 products, and its input and output read or written once."""
    cin, cout = _widths(nf, gc)[k - 1]
    return 2 * n * h * w * 9 * cin * cout, 2 * n * h * w * (cin + cout)


def rrdb_convs(blk) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """An RRDB module's ``(weight, bias)`` pairs: rdb1..rdb3, conv1..conv5."""
    return [[(getattr(r, f"conv{k}").weight, getattr(r, f"conv{k}").bias) for k in range(1, 6)]
            for r in (blk.rdb1, blk.rdb2, blk.rdb3)]


def pack_rrdb_trunk(rrdbs, dtype: torch.dtype) -> List[List[PackedRDB]]:
    """Packs modules with ``rdb1..rdb3`` each holding ``conv1..conv5``."""
    flat = pack_rdbs([c for blk in rrdbs for c in rrdb_convs(blk)], dtype)
    return [flat[3 * i: 3 * i + 3] for i in range(len(flat) // 3)]
