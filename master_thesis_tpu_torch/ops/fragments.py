"""Weight layout of the CUDA kernels' tensor-core B operands
(``csrc/conv_tile.cuh``; :func:`wgmma_conv_matrix` for
``csrc/conv3x3_wgmma.cuh`` and ``csrc/tail_wgmma.cuh``,
:func:`wgmma_phase_matrix` for the latter's upsample-convs,
:func:`wgmma_phase_adjoint_matrix` for ``csrc/tail_bwd_wgmma.cuh``,
:func:`wgmma_pull_matrix` for ``csrc/conv_bwd_wgmma.cuh``,
:func:`wgmma_wide_matrix` for ``csrc/conv3x3_wide_wgmma.cuh`` and
``csrc/conv_frame_wgmma.cuh``, :func:`wgmma_tf32_matrix`,
:func:`wgmma_tf32_phase_matrix`, :func:`wgmma_tf32_last_matrix` and
:func:`wgmma_tf32_gc_matrix` for ``csrc/conv_frame_tf32_wgmma.cuh``).

A conv's weights form a row-major ``(K, N)`` matrix, rows ordered
``(tap, input channel)``. It is zero-padded to multiples of 16 and stored
as 16x16 blocks, block ``(kb, nb)`` at position ``kb * N/16 + nb``, each
block 32 lanes x 8 bf16: lane ``l = 4 g + t`` holds, for columns
``16 nb + g`` and then ``16 nb + 8 + g``, the row pairs ``(16 kb + 2t, +1)``
and ``(16 kb + 2t + 8, +1)`` — the B fragments of two ``m16n8k16`` MMAs,
one 16-byte load per lane. (The kernels' widths need no padding; narrow
test widths do.)
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch


def padded(size: int) -> int:
    return -(-size // 16) * 16


def numel(k: int, n: int) -> int:
    """Length of a packed ``(k, n)`` matrix."""
    return padded(k) * padded(n)


@functools.lru_cache(maxsize=None)
def _lane_index(device: torch.device):
    """Made once per device: indexing a tensor on the card with host
    indices copies them over, which waits for the card's queue."""
    lane = torch.arange(32).view(32, 1, 1)
    reg = torch.arange(4).view(1, 4, 1)
    elem = torch.arange(2).view(1, 1, 2)
    rows = 2 * (lane % 4) + elem + 8 * (reg % 2)
    cols = lane // 4 + 8 * (reg // 2) + 0 * elem
    with torch.inference_mode(False):  # usable in training after serving
        return rows.to(device), cols.to(device)  # (32, 4, 2) each


def pack(mat: torch.Tensor, fill=0) -> torch.Tensor:
    """``(K, N)`` -> 1-D in the kernels' fragment order; padding holds
    ``fill`` (0; for a matrix of source positions, the zero's position)."""
    k, n = mat.shape
    kp, np_ = padded(k), padded(n)
    mat = torch.nn.functional.pad(mat, (0, np_ - n, 0, kp - k), value=fill)
    blocks = mat.reshape(kp // 16, 16, np_ // 16, 16).permute(0, 2, 1, 3)
    rows, cols = _lane_index(mat.device)
    return blocks[:, :, rows, cols].reshape(-1)


def conv_matrix(w: torch.Tensor, fill=0) -> torch.Tensor:
    """A conv's OIHW kernel as the kernels' packed ``(9 * C, O)`` B matrix,
    rows ``(ky, kx, c)``."""
    return pack(w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]), fill)


def adjoint_matrix(w: torch.Tensor, o_pad: Optional[int] = None, fill=0) -> torch.Tensor:
    """The adjoint of the 3x3 conv with OIHW kernel ``w`` (the conv with
    ``w`` transposed and flipped) as the packed ``(9 * O, C)`` B matrix,
    rows ``(ky, kx, o)``; with ``o_pad`` each tap's O rows are padded to
    ``o_pad`` with ``fill``."""
    o, c = w.shape[0], w.shape[1]
    adj = w.transpose(0, 1).flip(2, 3)  # (C, O, 3, 3)
    if o_pad is not None and o_pad > o:
        adj = torch.nn.functional.pad(adj, (0, 0, 0, 0, 0, o_pad - o), value=fill)
    return pack(adj.permute(2, 3, 1, 0).reshape(-1, c), fill)


def wgmma_conv_matrix(w: torch.Tensor, fill=0) -> torch.Tensor:
    """A 3x3 conv's OIHW kernel as the B operand of ``csrc/conv3x3_wgmma.cuh``
    (``fill`` is unused: the layout has no padding). Input channels run in
    chunks of 32; each chunk is one block the kernel copies whole, its nine
    taps in turn, each tap two k16 steps of 16 channels; a step is two
    8-channel halves, each ``O / 8`` core matrices of 8 outputs x 8
    channels (16 bytes an output): index order ``(chunk, tap, step, half,
    o // 8, o % 8, c % 8)``."""
    o, c = w.shape[0], w.shape[1]
    if c % 32 or o % 8:
        raise ValueError(f"the wgmma layout needs Cin % 32 == 0 and Cout % 8 == 0, got {c}, {o}")
    blocks = w.reshape(o // 8, 8, c // 32, 2, 2, 8, 9)  # (o8, o%8, chunk, step, half, c%8, tap)
    return blocks.permute(2, 6, 3, 4, 0, 1, 5).reshape(-1)


def wgmma_wide_matrix(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 or 5x5 conv's OIHW kernel as the A operand of
    ``csrc/conv3x3_wide_wgmma.cuh`` and ``csrc/conv_frame_wgmma.cuh`` (the
    swapped GEMM: M = outputs, K = (tap, input channel)). Outputs are
    zero-padded to a multiple of 128; index order ``(c // 64, tap, o, 64
    channels)``: per (chunk, tap) block one 128-byte row an output, K-major,
    its 16-byte chunks in the 128-byte swizzle of a 1024-byte-aligned stage
    (chunk ``j`` of row ``o`` at position ``j ^ o % 8``), so a block of
    consecutive outputs is one bulk copy that the descriptors read as
    written. Tap ``k ky + kx``."""
    o, c, k = w.shape[0], w.shape[1], w.shape[-1]
    if c % 64 or o % 64 or k not in (3, 5) or w.shape[2] != k:
        raise ValueError("the wide layout needs a 3x3 or 5x5 kernel with Cin, Cout % 64 == 0, "
                         f"got {tuple(w.shape)}")
    op = -(-o // 128) * 128
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, 0, 0, op - o))
    blocks = w.reshape(op, c // 64, 8, 8, k * k).permute(1, 4, 0, 2, 3)  # (chunk, tap, o, j, c % 8)
    rows = torch.arange(op, device=w.device).view(op, 1)
    pos = torch.arange(8, device=w.device).view(1, 8)
    return blocks[:, :, rows, pos ^ (rows % 8)].reshape(-1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``), as f32 with the low 13 bits zero:
    ``csrc/conv_frame_tf32_wgmma.cuh:tf32_rna``, bit for bit."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of the 3xTF32 product: ``hi = tf32(x)``, ``lo = tf32(x -
    hi)`` (``x - hi`` is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_order(m: torch.Tensor) -> torch.Tensor:
    """``(O, C, taps)`` (O a multiple of 8, C of 32; any dtype: values, or
    their positions for a gather) -> 1-D in the 3xTF32 operands' order:
    ``(c // 32, tap, o, 32 channels)``, 16-byte chunk ``j`` of row ``o`` at
    position ``j ^ o % 8``. A permutation, so it commutes with
    :func:`tf32_split`."""
    o, c, taps = m.shape
    rows = torch.arange(o, device=m.device).view(o, 1)
    pos = torch.arange(8, device=m.device).view(1, 8)
    blocks = m.reshape(o, c // 32, 8, 4, taps).permute(1, 4, 0, 2, 3)  # (chunk, tap, o, j, c % 4)
    return blocks[:, :, rows, pos ^ (rows % 8)].reshape(-1)


def _tf32_layout(m: torch.Tensor) -> torch.Tensor:
    """``(O, C, taps)`` f32 -> its hi matrix, then its lo matrix
    (:func:`tf32_split`), each in :func:`tf32_order`."""
    return torch.cat(tf32_split(tf32_order(m)))


def wgmma_tf32_matrix(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 or 5x5 conv's OIHW kernel as the A operands of
    ``csrc/conv_frame_tf32_wgmma.cuh`` (the swapped GEMM in 3xTF32: M =
    outputs, K = (tap, input channel)): its hi matrix, then its lo matrix
    (:func:`tf32_split`), each in the layout of :func:`wgmma_wide_matrix`
    with 32 f32 channels a 128-byte row: outputs zero-padded to a multiple of
    128, index order ``(c // 32, tap, o, 32 channels)``, 16-byte chunk ``j``
    of row ``o`` at position ``j ^ o % 8``. The lo matrix starts at half the
    length."""
    o, c, k = w.shape[0], w.shape[1], w.shape[-1]
    if c % 32 or o % 64 or k not in (3, 5) or w.shape[2] != k:
        raise ValueError("the tf32 layout needs a 3x3 or 5x5 kernel with Cin % 32 == 0 and "
                         f"Cout % 64 == 0, got {tuple(w.shape)}")
    return torch.cat(tf32_split(tf32_conv_order(w.float())))


def tf32_conv_order(w: torch.Tensor, fill=0) -> torch.Tensor:
    """One matrix of :func:`wgmma_tf32_matrix` (hi or lo) before the split:
    OIHW ``w`` (any dtype) in :func:`tf32_order`, outputs padded to a
    multiple of 128 with ``fill``."""
    o, c, k = w.shape[0], w.shape[1], w.shape[-1]
    op = -(-o // 128) * 128
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, 0, 0, op - o), value=fill)
    return tf32_order(w.reshape(op, c, k * k))


def tf32_gc_order(w: torch.Tensor) -> torch.Tensor:
    """One matrix of :func:`wgmma_tf32_gc_matrix` (hi or lo) before the
    split: OIHW ``w`` (any dtype) as 96 rows ``32 kx + o`` a row of taps
    ``ky``, in :func:`tf32_order`."""
    o, c = w.shape[0], w.shape[1]
    return tf32_order(w.permute(3, 0, 1, 2).reshape(3 * o, c, 3))


def wgmma_tf32_gc_matrix(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv to 32 outputs (an RDB's dense-concat conv1..conv4) as the
    B operand of ``csrc/conv_frame_tf32_wgmma.cuh``'s gc mode (the
    unswapped GEMM, an n96 product a row of taps): per row of taps ``ky`` 96
    rows ``32 kx + o`` of the weight ``w[o, c, ky, kx]``, hi then lo, in
    :func:`wgmma_tf32_matrix`'s layout with the rows of taps as its taps:
    index order ``(c // 32, ky, 32 kx + o, 32 channels)``, swizzled likewise;
    one 12 KB block a (chunk, ky), which the kernel streams."""
    o, c = w.shape[0], w.shape[1]
    if c % 32 or o != 32 or w.shape[2:] != (3, 3):
        raise ValueError(f"the tf32 gc-mode layout needs a 3x3 kernel, Cin % 32 == 0, Cout == 32, "
                         f"got {tuple(w.shape)}")
    return torch.cat(tf32_split(tf32_gc_order(w.float())))


def wgmma_tf32_last_matrix(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv to at most 3 outputs (the tail's conv_last) as the B operand
    of ``csrc/conv_frame_tf32_wgmma.cuh``'s last mode (the unswapped GEMM, an
    n24 product a row of taps): per row of taps ``ky`` 24 rows ``8 kx + o``
    (outputs zero-padded to 8) of the weight ``w[o, c, ky, kx]``, hi then lo,
    in :func:`wgmma_tf32_matrix`'s layout with the rows of taps as its taps:
    index order ``(c // 32, ky, 8 kx + o, 32 channels)``, swizzled likewise."""
    o, c = w.shape[0], w.shape[1]
    if c % 32 or o > 3 or w.shape[2:] != (3, 3):
        raise ValueError(f"the tf32 last-mode layout needs a 3x3 kernel, Cin % 32 == 0, Cout <= 3, "
                         f"got {tuple(w.shape)}")
    w = torch.nn.functional.pad(w.float(), (0, 0, 0, 0, 0, 0, 0, 8 - o))  # (8, c, ky, kx)
    return _tf32_layout(w.permute(3, 0, 1, 2).reshape(24, c, 3))


def wgmma_tf32_phase_matrix(fused: torch.Tensor) -> torch.Tensor:
    """A nearest-2x upsample-conv in its 4-phase form as the A operand of
    ``csrc/conv_frame_tf32_wgmma.cuh``'s phase mode: ``fused`` the ``(3, 3,
    C, 4 * O)`` HWIO kernel of ``models.nn_ext.fused_upsample_conv_kernel``
    (phases packed ``(a, b, o)``), O = 64. Its 4 phases x O outputs are the M
    rows, phase-major (row ``64 (2 a + b) + o``), its 4 taps ``(ti, tj)``
    (tap ``2 ti + tj``, input offset ``(a - 1 + ti, b - 1 + tj)``: the
    kernel's ``fused[a + ti, b + tj, :, phase]``) the taps of
    :func:`wgmma_tf32_matrix`'s layout: hi then lo, index order ``(c // 32,
    tap, row, 32 channels)``, swizzled likewise."""
    c, o = fused.shape[2], fused.shape[3] // 4
    if c % 32 or o != 64 or fused.shape[:2] != (3, 3):
        raise ValueError(f"the tf32 phase layout needs Cin % 32 == 0 and Cout == 64, got {c}, {o}")
    f6 = fused.float().reshape(3, 3, c, 2, 2, o)
    taps = torch.stack([torch.stack([f6[a + ti, b + tj, :, a, b, :] for ti in (0, 1) for tj in (0, 1)], dim=-1)
                        for a in (0, 1) for b in (0, 1)])  # (phase, c, o, tap)
    return _tf32_layout(taps.permute(0, 2, 1, 3).reshape(4 * o, c, 4))


def wgmma_phase_matrix(fused: torch.Tensor) -> torch.Tensor:
    """A nearest-2x upsample-conv in its 4-phase form as the B operand of
    ``csrc/tail_wgmma.cuh``'s upsample-conv stages. ``fused`` is the
    ``(3, 3, C, 4 * O)`` HWIO kernel of
    ``models.nn_ext.fused_upsample_conv_kernel``, phases packed ``(a, b, o)``
    in its outputs. Phase ``(a, b)`` has four taps ``(ti, tj)``, tap ``(ti,
    tj)`` reading input offset ``(a - 1 + ti, b - 1 + tj)``: the kernel's
    ``fused[a + ti, b + tj, :, phase]``. Each phase is one block the kernel
    keeps whole, laid out as :func:`wgmma_conv_matrix` lays out a conv with
    four taps: index order ``(phase, chunk, tap, step, half, o // 8, o % 8,
    c % 8)``, phase ``2 a + b``, tap ``2 ti + tj``, channel ``32 chunk + 16
    step + 8 half + c % 8``."""
    c, o = fused.shape[2], fused.shape[3] // 4
    if c % 32 or o % 8:
        raise ValueError(f"the wgmma layout needs Cin % 32 == 0 and Cout % 8 == 0, got {c}, {o}")
    f6 = fused.reshape(3, 3, c, 2, 2, o)
    taps = torch.stack([f6[a + ti, b + tj, :, a, b, :]
                        for a in (0, 1) for b in (0, 1) for ti in (0, 1) for tj in (0, 1)])
    blocks = taps.reshape(4, 4, c // 32, 2, 2, 8, o // 8, 8)  # (ph, tap, chunk, step, half, c%8, o8, o%8)
    return blocks.permute(0, 2, 1, 3, 4, 6, 7, 5).reshape(-1)


def wgmma_phase_adjoint_matrix(fused: torch.Tensor) -> torch.Tensor:
    """The adjoint of a nearest-2x upsample-conv in its 4-phase form as the B
    operand of ``csrc/tail_bwd_wgmma.cuh``'s upsample-conv adjoints: per
    phase ``(a, b)`` and tap ``(ti, tj)`` the block of
    :func:`wgmma_phase_matrix` transposed, ``K = O`` (the cotangent's
    channels) by ``N = C`` (the input's): index order ``(phase, chunk, tap,
    step, half, c // 8, c % 8, o % 8)``, phase ``2 a + b``, tap ``2 ti +
    tj``, output channel ``32 chunk + 16 step + 8 half + o % 8``."""
    c, o = fused.shape[2], fused.shape[3] // 4
    if c % 8 or o % 32:
        raise ValueError(f"the adjoint layout needs C % 8 == 0 and O % 32 == 0, got {c}, {o}")
    f6 = fused.reshape(3, 3, c, 2, 2, o)
    taps = torch.stack([f6[a + ti, b + tj, :, a, b, :].T
                        for a in (0, 1) for b in (0, 1) for ti in (0, 1) for tj in (0, 1)])
    blocks = taps.reshape(4, 4, o // 32, 2, 2, 8, c // 8, 8)  # (ph, tap, chunk, step, half, o%8, c8, c%8)
    return blocks.permute(0, 2, 1, 3, 4, 6, 7, 5).reshape(-1)


def pull_kernels(ws: Sequence[torch.Tensor]) -> list:
    """The adjoint of an RDB in pull form (``csrc/conv_bwd_wgmma.cuh``):
    from conv1..conv5's OIHW kernels ``ws`` (conv t reads cat(x, x1..x_{t-1})),
    for each source s (x, then x1..x4) the OIHW kernel of the one 3x3 conv
    that maps cat(dP_{s+1}..dP_5) to the source's cotangent: each conv's
    slice of the source's channels, transposed and flipped, stacked on the
    input axis."""
    gc, nf = ws[0].shape[0], ws[4].shape[0]
    out = []
    for s in range(5):
        lo = 0 if s == 0 else nf + (s - 1) * gc
        hi = nf if s == 0 else lo + gc
        out.append(torch.cat([ws[t][:, lo:hi].transpose(0, 1).flip(2, 3) for t in range(s, 5)], dim=1))
    return out


def wgmma_pull_matrix(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The B operands of an RDB's five pulls (:func:`pull_kernels`, sources
    0..4) in the layout of :func:`wgmma_conv_matrix`, concatenated."""
    return torch.cat([wgmma_conv_matrix(k) for k in pull_kernels(ws)])


def wgmma_unpack(buf: torch.Tensor, o: int, c: int) -> torch.Tensor:
    """Inverse of :func:`wgmma_conv_matrix`: 1-D ``buf`` -> OIHW ``(o, c, 3, 3)``."""
    blocks = buf.reshape(c // 32, 9, 2, 2, o // 8, 8, 8)
    return blocks.permute(4, 5, 0, 2, 3, 6, 1).reshape(o, c, 3, 3)


def gather_index(layouts: Sequence[Callable], shapes: Sequence[Tuple[int, ...]]) -> torch.Tensor:
    """Where each element of ``cat(layout_i(w_i))`` comes from in
    ``cat(w_i.reshape(-1) ..., [0])``: the layouts applied to position
    tensors. Padding points at the trailing zero. Packing many weights is
    then one gather (``src[index]``) instead of a few ops per weight."""
    sizes = [math.prod(s) for s in shapes]
    zero = sum(sizes)
    out, off = [], 0
    for layout, shape, size in zip(layouts, shapes, sizes):
        out.append(layout(torch.arange(off, off + size).view(shape), zero))
        off += size
    return torch.cat(out)


def unpack(buf: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack`: 1-D ``buf`` -> ``(K, N)``."""
    kp, np_ = padded(k), padded(n)
    rows, cols = _lane_index(buf.device)
    blocks = torch.empty((kp // 16, np_ // 16, 16, 16), dtype=buf.dtype, device=buf.device)
    blocks[:, :, rows, cols] = buf.reshape(kp // 16, np_ // 16, 32, 4, 2)
    return blocks.permute(0, 2, 1, 3).reshape(kp, np_)[:k, :n]
