"""The RRDB trunk: weight packing, plain versions and the CUDA RDB kernel
(master_thesis_tpu/ops/pallas_rrdb.py: rrdb_pallas, rrdb_trunk_pallas,
rrdb_trunk_pallas_banded, _split_rdb_weights, rrdb_trunk_xla).

An RRDB is three residual dense blocks (RDBs) and a residual:
``rrdb(x) = 0.2 * rdb3(rdb2(rdb1(x))) + x``. Each RDB runs five dense 3x3
convs, ``x_k = lrelu(conv_k(cat(x, x1..x_{k-1})))`` for k < 5, and returns
``0.2 * conv5(cat(x, x1..x4)) + x``.

The CUDA kernel (``csrc/rrdb.cu``) computes one whole RDB per launch over
(frame, spatial tile), so an RRDB is three launches and the third adds the
RRDB residual in its epilogue. Layout inside: NCHW in the working dtype.
The banded trunk (K2, :func:`rrdb_trunk_banded`) launches the same kernel
once per row band of every frame, each band's tiles reading their 5-row
halo in place from the frame.

Rounding, shared by the kernel and :func:`rdb_plain`: conv operands and
x1..x4 in the working dtype, sums, bias and lrelu in f32, the RDB output
rounded to the working dtype before the RRDB residual.
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
from master_thesis_tpu_torch.models.nn_ext import leaky_relu

# Channel widths the CUDA kernel is compiled for (the production RRDBNet).
KERNEL_NF, KERNEL_GC = 64, 32


class PackedRDB(NamedTuple):
    """One RDB's weights in the layouts both versions read, made once per
    weight set by :func:`pack_rdb`."""

    w: torch.Tensor  # the kernel's B operands (working dtype)
    b: torch.Tensor  # the five biases, concatenated (f32)
    kernels: Tuple[torch.Tensor, ...]  # conv1..conv5 OIHW (working dtype)


def _widths(nf: int, gc: int):
    """(input width, output width) of conv1..conv5."""
    return [(nf + k * gc, gc) for k in range(4)] + [(nf + 4 * gc, nf)]


def pack_rdb(
    convs: Sequence[Tuple[torch.Tensor, torch.Tensor]], dtype: torch.dtype
) -> PackedRDB:
    """Five ``(weight OIHW, bias)`` pairs -> :class:`PackedRDB`.

    ``w`` concatenates each conv's kernel as a ``(9 * Cin_k, out_k)``
    matrix, rows ordered ``(ky, kx, c)`` (HWIO flattened), in the
    tensor-core fragment order of :mod:`.fragments`: the B operand of the
    kernel's implicit GEMM. ``kernels`` keeps the OIHW weights for
    :func:`rdb_plain`.

    The TPU kernel regroups the convs per *source* tensor
    (``_split_rdb_weights``) because it holds whole frames, where every
    source's contributions exist at once. The CUDA kernel holds halo tiles
    that shrink by one pixel per conv, so each conv reads its concatenated
    input in one GEMM instead; :func:`rdb_plain` keeps the per-source
    regrouping.
    """
    return pack_rdbs([convs], dtype)[0]


@functools.lru_cache(maxsize=None)
def _gather(kind: str, shapes: Tuple[Tuple[int, ...], ...], device) -> torch.Tensor:
    """The gather index that packs one RDB of conv ``shapes``
    (``fragments.gather_index``), made once per layout and device."""
    layout = fragments.conv_matrix if kind == "conv" else (
        lambda w, fill: fragments.adjoint_matrix(w, fill=fill))
    with torch.inference_mode(False):  # usable in training after serving
        return fragments.gather_index([layout] * len(shapes), shapes).to(device)


def _sources(convs_list, dtype: torch.dtype):
    """The weights of many RDBs in ``dtype``, one row per RDB (its convs'
    OIHW kernels flattened, then a zero), and their conv shapes."""
    shapes = tuple(tuple(w.shape) for w, _ in convs_list[0])
    flat = torch.cat([w.detach().reshape(-1) for convs in convs_list for w, _ in convs])
    src = F.pad(flat.to(dtype).view(len(convs_list), -1), (0, 1))
    return src, shapes


def pack_rdbs(convs_list: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
              dtype: torch.dtype) -> List[PackedRDB]:
    """:func:`pack_rdb` for many RDBs of the same widths, with one gather
    for all their kernel matrices (the training forward packs the whole
    trunk on every step)."""
    src, shapes = _sources(convs_list, dtype)
    w = src[:, _gather("conv", shapes, src.device)]
    b = torch.cat([bias.detach().reshape(-1) for convs in convs_list for _, bias in convs])
    b = b.float().view(len(convs_list), -1)
    sizes = [math.prod(s) for s in shapes]
    return [
        PackedRDB(w[r], b[r], tuple(k.view(s) for k, s in zip(src[r, :-1].split(sizes), shapes)))
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


def _check_activation(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous bfloat16 CUDA tensor")
    if t.dim() != 4 or t.shape[1] != KERNEL_NF:
        raise ValueError(f"{what} must be (N, {KERNEL_NF}, H, W), got {tuple(t.shape)}")


_RDB_W_NUMEL = sum(fragments.numel(9 * cin, cout) for cin, cout in _widths(KERNEL_NF, KERNEL_GC))
_RDB_B_NUMEL = sum(cout for _, cout in _widths(KERNEL_NF, KERNEL_GC))


def _rdb_lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("rrdb", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rdb_forward.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    lib.rdb_forward.restype = ci
    lib.rdb_forward_rows.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.rdb_forward_rows.restype = ci
    return lib


def _check_rdb_args(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor]) -> None:
    _check_activation(x, "x")
    if res is not None:
        _check_activation(res, "res")
        if res.shape != x.shape or res.device != x.device:
            raise ValueError("res must match x in shape and device")
    w, b = p.w, p.b
    if (w.dtype, w.numel(), w.device) != (torch.bfloat16, _RDB_W_NUMEL, x.device) or not w.is_contiguous():
        raise ValueError(
            f"w must be a bf16 RDB packed (pack_rdb) for nf={KERNEL_NF}, gc={KERNEL_GC} on x's device"
        )
    if (b.dtype, b.numel(), b.device) != (torch.float32, _RDB_B_NUMEL, x.device) or not b.is_contiguous():
        raise ValueError("b must be the packed f32 RDB biases on x's device")


def rdb_cuda(
    x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """One RDB through the CUDA kernel (``csrc/rrdb.cu``); bf16 NCHW with
    nf=64, gc=32. With ``res`` the epilogue adds the RRDB residual."""
    _check_rdb_args(x, p, res)
    n, _, h, wd = x.shape
    out = torch.empty_like(x)
    lib = _rdb_lib()
    rc = lib.rdb_forward(
        x.data_ptr(), None if res is None else res.data_ptr(), p.w.data_ptr(),
        p.b.data_ptr(), out.data_ptr(), n, h, wd,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "rdb_forward")
    rdb_cuda.launches += 1
    return out


rdb_cuda.launches = 0

# Rows of halo a band of one RDB needs: one per conv (_BAND_HALO).
BAND_HALO = 5
# The banded trunk's default band height on the card: four 8-row tile rows
# of the kernel, so no tile row straddles two bands (the TPU kernel's band
# height, _band_rows, came from its VMEM budget).
TRUNK_BAND_ROWS = 32


def bands(h: int, band_rows: int) -> List[Tuple[int, int]]:
    """The row bands ``[r0, r1)`` of a frame of ``h`` rows, ``band_rows``
    each (the last one shorter when it does not divide ``h``)."""
    if band_rows <= 0:
        raise ValueError(f"band_rows must be positive, got {band_rows}")
    return [(r0, min(r0 + band_rows, h)) for r0 in range(0, h, band_rows)]


def rdb_banded_cuda(
    x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None,
    band_rows: int = TRUNK_BAND_ROWS,
) -> torch.Tensor:
    """One RDB through the CUDA kernel in row bands (K2): one launch per
    band of every frame, over that band's tiles only. The output equals
    :func:`rdb_cuda`'s."""
    _check_rdb_args(x, p, res)
    n, _, h, wd = x.shape
    out = torch.empty_like(x)
    lib = _rdb_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0, r1 in bands(h, band_rows):
        rc = lib.rdb_forward_rows(
            x.data_ptr(), None if res is None else res.data_ptr(), p.w.data_ptr(),
            p.b.data_ptr(), out.data_ptr(), n, h, wd, r0, r1, stream,
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


def rdb(x: torch.Tensor, p: PackedRDB, res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return rdb_cuda(x, p, res)
    if x.device.type != "cpu":
        raise ValueError(f"no RDB implementation for device {x.device}")
    return rdb_plain(x, p, res)


def rrdb_trunk(
    x: torch.Tensor, packed: Sequence[Sequence[PackedRDB]], rdb_fn=rdb
) -> torch.Tensor:
    """The trunk of ``len(packed)`` RRDBs on NCHW ``x`` (working dtype);
    ``packed[i]`` holds RRDB i's three packed RDBs. ``rdb_fn=rdb_plain``
    runs the plain version on any device (the comparison on the card)."""
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
    (:data:`TRUNK_BAND_ROWS` for 0): K2 for a CUDA tensor, the plain band
    decomposition for a CPU tensor."""
    br = band_rows or TRUNK_BAND_ROWS
    if x.is_cuda:
        return rrdb_trunk(x, packed, rdb_fn=functools.partial(rdb_banded_cuda, band_rows=br))
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


def rrdb_convs(blk) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """An RRDB module's ``(weight, bias)`` pairs: rdb1..rdb3, conv1..conv5."""
    return [[(getattr(r, f"conv{k}").weight, getattr(r, f"conv{k}").bias) for k in range(1, 6)]
            for r in (blk.rdb1, blk.rdb2, blk.rdb3)]


def pack_rrdb_trunk(rrdbs, dtype: torch.dtype) -> List[List[PackedRDB]]:
    """Packs modules with ``rdb1..rdb3`` each holding ``conv1..conv5``."""
    flat = pack_rdbs([c for blk in rrdbs for c in rrdb_convs(blk)], dtype)
    return [flat[3 * i: 3 * i + 3] for i in range(len(flat) // 3)]
