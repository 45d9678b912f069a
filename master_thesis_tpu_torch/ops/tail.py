"""The RRDBNet tail: weight packing, plain version and the CUDA tail
kernels (master_thesis_tpu/ops/pallas_tail.py: rrdbnet_tail_pallas,
_tail_tap_weights; plain math of models/chn.py:rrdbnet_tail_forward).

The tail maps the trunk grid ``(N, nf, h, w)`` to ``(N, 3, 4h, 4w)``:
``upconv1`` and ``upconv2`` (nearest-2x upsample then 3x3 conv, + lrelu),
``hr_conv`` (3x3 + lrelu) and ``conv_last`` (3x3 to 3 channels).

Each upsample-conv runs at the low resolution as a 4-phase conv
(``fused_upsample_conv_kernel``): output phase ``(a, b)`` of pixel
``(i, j)`` reads a 2x2 window of the input, so the upsampled input is never
formed. The CUDA route (``csrc/tail.cu``) is three launches: one per
upsample-conv, and ``hr_conv`` fused with ``conv_last`` over halo tiles so
the full-resolution ``hr_conv`` output never reaches device memory.
Intermediates are stored in the working dtype; sums, bias and lrelu run in
f32. The banded tail (K5, :func:`tail_banded`) runs the same three kernels
per row band with row windows, on band-sized scratch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import fragments
from master_thesis_tpu_torch.ops import rrdb as rrdb_ops
from master_thesis_tpu_torch.models.nn_ext import (
    fused_upsample_conv_kernel,
    leaky_relu,
    pixel_shuffle_2x,
)

KERNEL_NF = 64  # channel width the CUDA kernels are compiled for

Conv = Tuple[torch.Tensor, torch.Tensor]  # (weight OIHW, bias)


def pack_tail(
    upconv1: Conv, upconv2: Conv, hr_conv: Conv, conv_last: Conv,
    dtype: torch.dtype,
) -> Dict[str, torch.Tensor]:
    """All tail weights in the layouts both versions read, in ``dtype``
    (biases f32). Done once per weight set.

    - ``up{1,2}_fused``: the 4-phase 3x3 kernel as OIHW ``(4*O, C, 3, 3)``,
      phases packed ``(a, b, o)`` (the plain version);
    - ``up{1,2}_oihw``: the upsample-conv's own 3x3 kernel (the
      backward's plain version, :mod:`.tail_bwd`);
    - ``up{1,2}_phase``: the same taps as 4 phases of ``(4 taps * C, O)``
      matrices, tap ``(ti, tj)`` reading input offset
      ``(a - 1 + ti, b - 1 + tj)`` (the kernel);
    - ``hr_oihw`` / ``hr_w``: hr_conv as OIHW and as a ``(9 * C, O)``
      matrix;
    - ``last_oihw`` / ``last_w``: conv_last as OIHW and as a ``(9 * C, 3)``
      matrix (its outputs zero-padded to one 16-wide tile).

    The kernels' matrices are in the tensor-core fragment order of
    :mod:`.fragments`, rows ``(tap, channel)``.
    """
    p: Dict[str, torch.Tensor] = {}
    for name, (w, b) in (("up1", upconv1), ("up2", upconv2)):
        o, c = w.shape[0], w.shape[1]
        fused = fused_upsample_conv_kernel(w.detach().float().permute(2, 3, 1, 0))
        f6 = fused.reshape(3, 3, c, 2, 2, o)
        phase = torch.cat([
            fragments.pack(torch.cat([f6[a + ti, bb + tj, :, a, bb, :] for ti in (0, 1) for tj in (0, 1)]))
            for a in (0, 1) for bb in (0, 1)
        ])
        p[f"{name}_fused"] = fused.permute(3, 2, 0, 1).to(dtype).contiguous()
        p[f"{name}_phase"] = phase.to(dtype).contiguous()
        p[f"{name}_oihw"] = w.detach().to(dtype).contiguous()
        p[f"{name}_b"] = b.detach().float().contiguous()
    w, b = hr_conv
    p["hr_oihw"] = w.detach().to(dtype).contiguous()
    p["hr_w"] = fragments.conv_matrix(w.detach()).to(dtype)
    p["hr_b"] = b.detach().float().contiguous()
    w, b = conv_last
    p["last_oihw"] = w.detach().to(dtype).contiguous()
    p["last_w"] = fragments.conv_matrix(w.detach()).to(dtype)
    p["last_b"] = b.detach().float().contiguous()
    return p


def tail_plain(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch tail on NCHW ``x`` in its dtype -> ``(N, 3, 4h, 4w)``."""
    dt = x.dtype

    def up(inp, name):
        y = F.conv2d(inp.float(), p[f"{name}_fused"].float(), padding=1)
        y = pixel_shuffle_2x(y) + p[f"{name}_b"].view(1, -1, 1, 1)
        return leaky_relu(y).to(dt)

    h = up(up(x, "up1"), "up2")
    h = leaky_relu(F.conv2d(h.float(), p["hr_oihw"].float(), p["hr_b"], padding=1)).to(dt)
    return F.conv2d(h.float(), p["last_oihw"].float(), p["last_b"], padding=1).to(dt)


def _tail_lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("tail", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.upconv_forward.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.upconv_forward.restype = ci
    lib.hr_last_forward.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    lib.hr_last_forward.restype = ci
    return lib


def _check_packed(p: Dict[str, torch.Tensor], x: torch.Tensor) -> None:
    nf = KERNEL_NF
    want = {
        "up1_phase": 16 * nf * nf, "up2_phase": 16 * nf * nf,
        "hr_w": 9 * nf * nf, "last_w": fragments.numel(9 * nf, 3),
    }
    for key, numel in want.items():
        t = p[key]
        if (t.dtype, t.numel(), t.device) != (torch.bfloat16, numel, x.device) or not t.is_contiguous():
            raise ValueError(f"{key} must be packed bf16 (pack_tail) on x's device")
    for key, numel in (("up1_b", nf), ("up2_b", nf), ("hr_b", nf), ("last_b", 3)):
        t = p[key]
        if (t.dtype, t.numel(), t.device) != (torch.float32, numel, x.device) or not t.is_contiguous():
            raise ValueError(f"{key} must be f32 biases on x's device")


def _check_input(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> None:
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous bfloat16 CUDA tensor")
    if x.dim() != 4 or x.shape[1] != KERNEL_NF:
        raise ValueError(f"x must be (N, {KERNEL_NF}, h, w), got {tuple(x.shape)}")
    _check_packed(p, x)


def _upconv(lib, x, p, name, out, r0, rows, stream) -> None:
    """Upsample-conv ``name`` of the input rows ``[r0, r0 + rows)`` of ``x``
    into ``out``, ``(n, 64, 2 * rows, 2w)``."""
    n, _, h, w = x.shape
    rc = lib.upconv_forward(
        x.data_ptr(), p[f"{name}_phase"].data_ptr(), p[f"{name}_b"].data_ptr(),
        out.data_ptr(), n, h, w, r0, rows, stream,
    )
    _build.check(lib, rc, "upconv_forward")


def _hr_last(lib, x, p, out, q0, nq, o0, stream) -> None:
    """hr_conv + conv_last of the input rows ``[q0, q0 + nq)`` of ``x``,
    written at row ``o0`` of ``out``, ``(n, 3, OH, w)``."""
    n, _, h, w = x.shape
    rc = lib.hr_last_forward(
        x.data_ptr(), p["hr_w"].data_ptr(), p["hr_b"].data_ptr(),
        p["last_w"].data_ptr(), p["last_b"].data_ptr(), out.data_ptr(), n, h, w,
        q0, nq, o0, out.shape[2], stream,
    )
    _build.check(lib, rc, "hr_last_forward")


def tail_cuda(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tail through the CUDA kernels (``csrc/tail.cu``): three launches
    on bf16 NCHW ``(N, 64, h, w)``."""
    _check_input(x, p)
    n, c, h, w = x.shape
    lib = _tail_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for name in ("up1", "up2"):
        out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
        _upconv(lib, x, p, name, out, 0, h, stream)
        tail_cuda.launches += 1
        x, h, w = out, 2 * h, 2 * w
    out = torch.empty((n, 3, h, w), dtype=x.dtype, device=x.device)
    _hr_last(lib, x, p, out, 0, h, 0, stream)
    tail_cuda.launches += 1
    return out


tail_cuda.launches = 0

# Low-resolution rows of halo a band of the tail needs: one per conv stage
# (pallas_tail.py:_TAIL_HALO).
TAIL_HALO = 4
# The banded tail's default band height on the card (the TPU kernel's,
# _tail_band_rows, came from its VMEM budget): halo work 1.25x, and the
# band-sized scratch a quarter of a 128-row frame's.
TAIL_BAND_ROWS = 32


def _tail_bands(h: int, band_rows: int):
    """``(r0, r1, lo, hi)`` per band: its rows ``[r0, r1)`` and the rows
    ``[lo, hi)`` it reads, ``TAIL_HALO`` each side clipped to the frame."""
    return [(r0, r1, max(r0 - TAIL_HALO, 0), min(r1 + TAIL_HALO, h))
            for r0, r1 in rrdb_ops.bands(h, band_rows)]


def tail_banded_cuda(
    x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = TAIL_BAND_ROWS
) -> torch.Tensor:
    """The tail in row bands through the CUDA kernels (K5): per band of
    low-resolution rows with its halo, upconv1 reads its rows in place from
    ``x``, upconv2 and hr_conv + conv_last run on band-sized scratch made
    once and reused by every band, and the last launch writes the band's own
    rows (x4) into the ``(N, 3, 4h, 4w)`` output. Three launches per band;
    the output equals :func:`tail_cuda`'s."""
    _check_input(x, p)
    n, c, h, w = x.shape
    lib = _tail_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    spans = _tail_bands(h, band_rows)
    most = max(hi - lo for _, _, lo, hi in spans)
    h1 = torch.empty(n * c * 2 * most * 2 * w, dtype=x.dtype, device=x.device)
    h2 = torch.empty(n * c * 4 * most * 4 * w, dtype=x.dtype, device=x.device)
    out = torch.empty((n, 3, 4 * h, 4 * w), dtype=x.dtype, device=x.device)
    for r0, r1, lo, hi in spans:
        rows = hi - lo
        b1 = h1[: n * c * 2 * rows * 2 * w].view(n, c, 2 * rows, 2 * w)
        b2 = h2[: n * c * 4 * rows * 4 * w].view(n, c, 4 * rows, 4 * w)
        _upconv(lib, x, p, "up1", b1, lo, rows, stream)
        _upconv(lib, b1, p, "up2", b2, 0, 2 * rows, stream)
        _hr_last(lib, b2, p, out, 4 * (r0 - lo), 4 * (r1 - r0), 4 * r0, stream)
        tail_banded_cuda.launches += 3
    return out


tail_banded_cuda.launches = 0


def tail_banded_plain(
    x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = TAIL_BAND_ROWS
) -> torch.Tensor:
    """:func:`tail_plain` in the TPU kernel's band decomposition (the banded
    branch of ``rrdbnet_tail_pallas``): each band of rows with a
    ``TAIL_HALO``-row halo, clipped at the frame, through :func:`tail_plain`;
    only the band's own rows (x4) are kept."""
    outs = [tail_plain(x[:, :, lo:hi], p)[:, :, 4 * (r0 - lo): 4 * (r1 - lo)]
            for r0, r1, lo, hi in _tail_bands(x.shape[2], band_rows)]
    return torch.cat(outs, dim=2)


def tail(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return tail_cuda(x, p)
    if x.device.type != "cpu":
        raise ValueError(f"no tail implementation for device {x.device}")
    return tail_plain(x, p)


def tail_banded(x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = 0) -> torch.Tensor:
    """The tail in row bands of ``band_rows`` rows (:data:`TAIL_BAND_ROWS`
    for 0): K5 for a CUDA tensor, the plain band decomposition for a CPU
    tensor."""
    br = band_rows or TAIL_BAND_ROWS
    if x.is_cuda:
        return tail_banded_cuda(x, p, br)
    if x.device.type != "cpu":
        raise ValueError(f"no tail implementation for device {x.device}")
    return tail_banded_plain(x, p, br)


def tail_flops(n: int, h: int, w: int, nf: int = KERNEL_NF) -> int:
    """Multiply-adds x2 the tail needs from a ``(n, nf, h, w)`` input: each
    upsample-conv in its 4-phase form (4 taps per output pixel, as both
    the TPU kernel and ``csrc/tail.cu`` run it), hr_conv and conv_last at
    9 taps."""
    px2, px4 = 4 * h * w, 16 * h * w
    return 2 * n * nf * (4 * px2 * nf + 4 * px4 * nf + 9 * px4 * nf + 9 * px4 * 3)
