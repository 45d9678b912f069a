"""The RRDBNet tail: weight packing, plain version and the CUDA tail
kernels (master_thesis_tpu/ops/pallas_tail.py: rrdbnet_tail_pallas,
_tail_tap_weights; plain math of models/chn.py:rrdbnet_tail_forward).

The tail maps the trunk grid ``(N, nf, h, w)`` to ``(N, 3, 4h, 4w)``:
``upconv1`` and ``upconv2`` (nearest-2x upsample then 3x3 conv, + lrelu),
``hr_conv`` (3x3 + lrelu) and ``conv_last`` (3x3 to 3 channels).

Each upsample-conv runs at the low resolution as a 4-phase conv
(``fused_upsample_conv_kernel``): output phase ``(a, b)`` of pixel
``(i, j)`` reads a 2x2 window of the input, so the upsampled input is never
formed. The CUDA route (``csrc/tail.cu`` with ``csrc/tail_wgmma.cuh``) is
four implicit-GEMM launches on wgmma, one per stage, in one ctypes call,
channels-last throughout: it takes the trunk's channels-last output as it
is and returns ``(N, 3, 4h, 4w)`` with channels-last strides (an NHWC
buffer), which the caller's NHWC view of the result reads without a copy.
Intermediates are stored in the working dtype; sums, bias and lrelu run in
f32. The banded tail (K5, :func:`tail_banded`) runs the same four launches
per row band with row windows, on band-sized scratch.

The first design (``csrc/tail_fwd.cuh``: three mma.sync launches, NCHW,
hr_conv fused with conv_last over halo tiles) stays as
:func:`tail_first_cuda` / :func:`tail_banded_first_cuda`, which no path of
the port calls: the card's checks time the new design against it. Its
upsample-conv also recomputes h1 and h2 for the first design of the tail's
backward (:func:`.tail_bwd.tail_bwd_first_cuda`); K6 recomputes with this
module's stages.

In f32 (:func:`tail_f32`, :func:`tail_banded_f32`) the tail is four
launches of the 3xTF32 kernel (``csrc/conv_frame_tf32.cu``,
:func:`tail_stage_tf32_cuda`), NHWC, with f32 accuracy as the TPU kernel
takes it under ``Precision.HIGHEST``: each upsample-conv in its 4-phase
form at the low resolution (phase mode), hr_conv in conv mode, conv_last as
n24 products of its 3 outputs by a row's 3 taps (last mode); in bands,
each stage computes the rows the next one reads, over band-sized buffers,
and the first reads the frame in place. At a width other than the kernel's
(nf != 64) each stage is one :func:`.conv_f32.conv_f32_fwd` (the SIMT
kernel) instead (:func:`tail_f32_plan`).
On the CPU each stage is :func:`.conv_f32.conv_f32_fwd_plain` (the
upsample-convs through x2). The f32 first design, four
:func:`.conv_f32.conv_f32_fwd` launches (the SIMT kernel, the
upsample-convs at the high resolution), stays as :func:`tail_f32_first` /
:func:`tail_banded_f32_first` for chip_smoke.py alone. :func:`tail` and
:func:`tail_banded` pick the route by the working dtype.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import conv_stack, fragments
from master_thesis_tpu_torch.ops import rrdb as rrdb_ops
from master_thesis_tpu_torch.ops.conv_f32 import conv_f32_fwd, conv_f32_fwd_plain, hwio, kernel_route, nhwc
from master_thesis_tpu_torch.models.nn_ext import (
    fused_upsample_conv_kernel,
    leaky_relu,
    pixel_shuffle_2x,
)

KERNEL_NF = 64  # channel width the CUDA kernels are compiled for

Conv = Tuple[torch.Tensor, torch.Tensor]  # (weight OIHW, bias)
# The tail's stages (upconv1, upconv2, hr_conv, conv_last): the kernel
# launches a tail call makes.
TAIL_KERNELS = 4


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
    - ``up{1,2}_wg``: the 4-phase form as the wgmma B operand
      (``fragments.wgmma_phase_matrix``: 16 phase-taps, the kernel);
    - ``up{1,2}_phase``: the same taps as 4 phases of ``(4 taps * C, O)``
      matrices in mma.sync fragment order, tap ``(ti, tj)`` reading input
      offset ``(a - 1 + ti, b - 1 + tj)`` (the first designs of the tail
      and of its backward);
    - ``hr_oihw`` / ``hr_wg`` / ``hr_w``: hr_conv as OIHW, as the wgmma B
      operand (``fragments.wgmma_conv_matrix``) and as a ``(9 * C, O)``
      matrix in fragment order (the first design);
    - ``last_oihw`` / ``last_wg`` / ``last_w``: conv_last likewise, its 3
      outputs zero-padded to the wgmma's 8 and to one 16-wide mma.sync tile.

    - ``{up1,up2,hr,last}_hwio``: each conv's own kernel as the SIMT f32
      kernel's HWIO operand (f32 only; the f32 first design, and the f32
      route's plain version);
    - ``{up1,up2,hr,last}_tf32``: the 3xTF32 kernel's operands, hi then lo
      (f32 only, at the kernel's widths: C = O = 64): the upsample-convs'
      4 phases (``fragments.wgmma_tf32_phase_matrix``), hr_conv as a conv
      (``fragments.wgmma_tf32_matrix``) and conv_last as the B operand of
      an n24 product a row of taps (``fragments.wgmma_tf32_last_matrix``).

    The wgmma operands (``*_wg``) are made where the widths are the
    kernel's multiples (C % 32 == 0, O % 8 == 0), as for the trunk.
    """
    p: Dict[str, torch.Tensor] = {}
    wgmma = all(w.shape[1] % 32 == 0 and w.shape[0] % 8 == 0 for w, _ in (upconv1, upconv2, hr_conv))
    tf32 = (dtype == torch.float32 and conv_last[0].shape[:2] == (3, KERNEL_NF)
            and all(w.shape[:2] == (KERNEL_NF, KERNEL_NF) for w, _ in (upconv1, upconv2, hr_conv)))
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
        if wgmma:
            p[f"{name}_wg"] = fragments.wgmma_phase_matrix(fused).to(dtype).contiguous()
        if tf32:
            p[f"{name}_tf32"] = fragments.wgmma_tf32_phase_matrix(fused).contiguous()
        p[f"{name}_oihw"] = w.detach().to(dtype).contiguous()
        p[f"{name}_b"] = b.detach().float().contiguous()
    for name, (w, b) in (("hr", hr_conv), ("last", conv_last)):
        w = w.detach()
        p[f"{name}_oihw"] = w.to(dtype).contiguous()
        p[f"{name}_w"] = fragments.conv_matrix(w).to(dtype)
        if wgmma:
            pad = -w.shape[0] % 8
            p[f"{name}_wg"] = fragments.wgmma_conv_matrix(
                F.pad(w.float(), (0, 0, 0, 0, 0, 0, 0, pad))).to(dtype).contiguous()
        p[f"{name}_b"] = b.detach().float().contiguous()
    if dtype == torch.float32:
        for name, (w, _) in zip(("up1", "up2", "hr", "last"), (upconv1, upconv2, hr_conv, conv_last)):
            p[f"{name}_hwio"] = hwio(w)
    if tf32:
        p["hr_tf32"] = fragments.wgmma_tf32_matrix(hr_conv[0].detach()).contiguous()
        p["last_tf32"] = fragments.wgmma_tf32_last_matrix(conv_last[0].detach()).contiguous()
    return p


def tail_stage_plain(k: int, x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stage ``k`` of :func:`tail_plain` (0 upconv1, 1 upconv2, 2 hr_conv, 3
    conv_last) on NCHW ``x`` in its dtype: f32 sums, bias and lrelu, the
    result rounded to x's dtype."""
    dt = x.dtype
    if k < 2:
        name = ("up1", "up2")[k]
        y = F.conv2d(x.float(), p[f"{name}_fused"].float(), padding=1)
        return leaky_relu(pixel_shuffle_2x(y) + p[f"{name}_b"].view(1, -1, 1, 1)).to(dt)
    if k == 2:
        return leaky_relu(F.conv2d(x.float(), p["hr_oihw"].float(), p["hr_b"], padding=1)).to(dt)
    return F.conv2d(x.float(), p["last_oihw"].float(), p["last_b"], padding=1).to(dt)


def tail_plain(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch tail on ``x`` ``(N, C, h, w)`` in its dtype, NCHW or
    channels-last (it computes on an NCHW copy, so both give the same
    bits) -> NCHW ``(N, 3, 4h, 4w)``."""
    x = x.contiguous()
    for k in range(TAIL_KERNELS):
        x = tail_stage_plain(k, x, p)
    return x


# The stages' packed B operands and biases, in order.
_STAGE_KEYS = (("up1_wg", "up1_b"), ("up2_wg", "up2_b"), ("hr_wg", "hr_b"), ("last_wg", "last_b"))


def _tail_lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("tail", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tail_forward.argtypes = [vp] * 12 + [ci] * 8 + [vp]
    lib.tail_forward.restype = ci
    lib.tail_stage.argtypes = [ci] + [vp] * 4 + [ci] * 7 + [vp]
    lib.tail_stage.restype = ci
    lib.upconv_forward.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.upconv_forward.restype = ci
    lib.hr_last_forward.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    lib.hr_last_forward.restype = ci
    return lib


# The packed B operands each design reads, with their element counts.
_WG_NUMEL = {"up1_wg": 16 * KERNEL_NF**2, "up2_wg": 16 * KERNEL_NF**2, "hr_wg": 9 * KERNEL_NF**2,
             "last_wg": 9 * KERNEL_NF * 8}
_FIRST_NUMEL = {"up1_phase": 16 * KERNEL_NF**2, "up2_phase": 16 * KERNEL_NF**2, "hr_w": 9 * KERNEL_NF**2,
                "last_w": fragments.numel(9 * KERNEL_NF, 3)}


def _check_packed(p: Dict[str, torch.Tensor], x: torch.Tensor, want: Dict[str, int]) -> None:
    for key, numel in want.items():
        t = p.get(key)
        if (t is None or (t.dtype, t.numel(), t.device) != (torch.bfloat16, numel, x.device)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{key} must be packed bf16 (pack_tail) on x's device")
    for key, numel in (("up1_b", KERNEL_NF), ("up2_b", KERNEL_NF), ("hr_b", KERNEL_NF), ("last_b", 3)):
        t = p.get(key)
        if t is None or (t.dtype, t.numel(), t.device) != (torch.float32, numel, x.device) or not t.is_contiguous():
            raise ValueError(f"{key} must be f32 biases on x's device")


def _scratch(n: int, rows: int, w: int, like: torch.Tensor):
    """Scratch for ``rows`` input rows: h13 holds h1 (n, 2 rows, 2w, 64) and
    then h3 (n, 4 rows, 4w, 64), which hr_conv writes once upconv2 has read
    h1; h2 (n, 4 rows, 4w, 64). NHWC, as flat buffers."""
    size = n * 16 * rows * w * KERNEL_NF
    return (torch.empty(size, dtype=like.dtype, device=like.device),
            torch.empty(size, dtype=like.dtype, device=like.device))


def _forward(lib, x, p, h13, h2, out, lo, hi, q0, nq, o0, stream) -> None:
    """One ``tail_forward`` call: the four stages over the input rows
    ``[lo, hi)`` of channels-last ``x``, conv_last over h3's rows ``[q0, q0
    + nq)`` into ``out`` (N, 4h, 4w, 3) at row ``o0``."""
    n, _, h, w = x.shape
    ptrs = [p[k].data_ptr() for pair in _STAGE_KEYS for k in pair]
    rc = lib.tail_forward(x.data_ptr(), *ptrs, h13.data_ptr(), h2.data_ptr(), out.data_ptr(),
                          n, h, w, lo, hi, q0, nq, o0, stream)
    _build.check(lib, rc, "tail_forward")


def tail_cuda(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tail through the CUDA kernels (``csrc/tail.cu``: four wgmma
    launches, one ctypes call) on bf16 ``(N, 64, h, w)``.

    ``x`` must be channels-last (``x.is_contiguous(memory_format=
    torch.channels_last)``); a contiguous NCHW tensor is refused. Returns
    ``(N, 3, 4h, 4w)`` with channels-last strides: ``out.permute(0, 2, 3,
    1)`` is a contiguous NHWC tensor."""
    rrdb_ops._check_activation(x, "x", torch.channels_last)
    _check_packed(p, x, _WG_NUMEL)
    n, _, h, w = x.shape
    h13, h2 = _scratch(n, h, w, x)
    out = torch.empty((n, 4 * h, 4 * w, 3), dtype=x.dtype, device=x.device)
    _forward(_tail_lib(), x, p, h13, h2, out, 0, h, 0, 4 * h, 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    tail_cuda.launches += TAIL_KERNELS
    return out.permute(0, 3, 1, 2)


tail_cuda.launches = 0


def tail_stage_cuda(k: int, src: torch.Tensor, p: Dict[str, torch.Tensor], out: torch.Tensor) -> None:
    """Stage ``k`` of :func:`tail_cuda` alone (0 upconv1, 1 upconv2, 2
    hr_conv, 3 conv_last; ``csrc/tail.cu:tail_stage``) over every row of
    ``src`` (n, H, W, 64) NHWC bf16 into ``out``: (n, 2H, 2W, 64) for the
    upsample-convs, (n, H, W, 64) for hr_conv, (n, H, W, 3) for conv_last.
    To time each launch against its floor; no path of the port calls it.
    Adds to no launch count."""
    n, hh, ww, c = src.shape
    scale = 2 if k < 2 else 1
    want = (n, scale * hh, scale * ww, 3 if k == 3 else c)
    if (not src.is_cuda or src.dtype != torch.bfloat16 or not src.is_contiguous() or c != KERNEL_NF
            or tuple(out.shape) != want or out.dtype != src.dtype or not out.is_contiguous()):
        raise ValueError(f"src must be (n, H, W, {KERNEL_NF}) bf16 NHWC on the card and out {want}")
    _check_packed(p, src, _WG_NUMEL)
    wk, bk = _STAGE_KEYS[k]
    lib = _tail_lib()
    rc = lib.tail_stage(k, src.data_ptr(), p[wk].data_ptr(), p[bk].data_ptr(), out.data_ptr(), n, hh,
                        ww, 0, hh, out.shape[1], 0, torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(lib, rc, "tail_stage")


def tail_stage_cost(k: int, n: int, h: int, w: int, nf: int = KERNEL_NF,
                    itemsize: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of stage ``k`` of the tail of a ``(n, nf, h, w)``
    input run on its own: its products (the upsample-convs in their 4-phase
    form), its input read and its output written once, ``itemsize`` bytes
    an element (bf16 by default)."""
    px = [h * w, 4 * h * w, 16 * h * w, 16 * h * w][k]  # the stage's input pixels
    cout = 3 if k == 3 else nf
    if k < 2:
        return 2 * n * 4 * px * 4 * nf * nf, itemsize * n * nf * 5 * px
    return 2 * n * px * 9 * nf * cout, itemsize * n * px * (nf + cout)


def _upconv_first(lib, x, p, name, out, r0, rows, stream) -> None:
    """The first design's upsample-conv ``name`` of the input rows ``[r0,
    r0 + rows)`` of NCHW ``x`` into ``out``, ``(n, 64, 2 * rows, 2w)``."""
    n, _, h, w = x.shape
    rc = lib.upconv_forward(
        x.data_ptr(), p[f"{name}_phase"].data_ptr(), p[f"{name}_b"].data_ptr(),
        out.data_ptr(), n, h, w, r0, rows, stream,
    )
    _build.check(lib, rc, "upconv_forward")


def _hr_last_first(lib, x, p, out, q0, nq, o0, stream) -> None:
    """The first design's hr_conv + conv_last of the input rows ``[q0, q0 +
    nq)`` of NCHW ``x``, written at row ``o0`` of ``out``, ``(n, 3, OH, w)``."""
    n, _, h, w = x.shape
    rc = lib.hr_last_forward(
        x.data_ptr(), p["hr_w"].data_ptr(), p["hr_b"].data_ptr(),
        p["last_w"].data_ptr(), p["last_b"].data_ptr(), out.data_ptr(), n, h, w,
        q0, nq, o0, out.shape[2], stream,
    )
    _build.check(lib, rc, "hr_last_forward")


def tail_first_cuda(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The first design (``csrc/tail_fwd.cuh``): three mma.sync launches on
    bf16 contiguous NCHW ``(N, 64, h, w)`` -> NCHW ``(N, 3, 4h, 4w)``. Kept
    to time and check :func:`tail_cuda` against on the card; no path of the
    port calls it."""
    rrdb_ops._check_activation(x, "x")
    _check_packed(p, x, _FIRST_NUMEL)
    n, c, h, w = x.shape
    lib = _tail_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for name in ("up1", "up2"):
        out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
        _upconv_first(lib, x, p, name, out, 0, h, stream)
        x, h, w = out, 2 * h, 2 * w
    out = torch.empty((n, 3, h, w), dtype=x.dtype, device=x.device)
    _hr_last_first(lib, x, p, out, 0, h, 0, stream)
    return out

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
    low-resolution rows with its halo, one ``tail_forward`` call of four
    launches: upconv1 reads its rows in place from ``x``, upconv2, hr_conv
    and conv_last run on band-sized scratch made once and reused by every
    band, and conv_last writes the band's own rows (x4) into the output.
    Channels-last in and out like :func:`tail_cuda`, whose output it equals
    bit for bit."""
    rrdb_ops._check_activation(x, "x", torch.channels_last)
    _check_packed(p, x, _WG_NUMEL)
    n, _, h, w = x.shape
    lib = _tail_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    spans = _tail_bands(h, band_rows)
    h13, h2 = _scratch(n, max(hi - lo for _, _, lo, hi in spans), w, x)
    out = torch.empty((n, 4 * h, 4 * w, 3), dtype=x.dtype, device=x.device)
    for r0, r1, lo, hi in spans:
        _forward(lib, x, p, h13, h2, out, lo, hi, 4 * (r0 - lo), 4 * (r1 - r0), 4 * r0, stream)
        tail_banded_cuda.launches += TAIL_KERNELS
    return out.permute(0, 3, 1, 2)


tail_banded_cuda.launches = 0


def tail_banded_first_cuda(
    x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = TAIL_BAND_ROWS
) -> torch.Tensor:
    """The first design in row bands (three launches per band, NCHW: the
    2x and 4x intermediates in band-sized scratch, hr_conv + conv_last
    writing the band's rows into the output); equals
    :func:`tail_first_cuda`. Kept to time :func:`tail_banded_cuda`
    against; no path of the port calls it."""
    rrdb_ops._check_activation(x, "x")
    _check_packed(p, x, _FIRST_NUMEL)
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
        _upconv_first(lib, x, p, "up1", b1, lo, rows, stream)
        _upconv_first(lib, b1, p, "up2", b2, 0, 2 * rows, stream)
        _hr_last_first(lib, b2, p, out, 4 * (r0 - lo), 4 * (r1 - r0), 4 * r0, stream)
    return out


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


# The f32 route's stages: (packed kernel, read through x2, epilogue), and
# the 3xTF32 kernel's mode for each.
F32_STAGES = (("up1", True, "leaky"), ("up2", True, "leaky"), ("hr", False, "leaky"),
              ("last", False, "none"))
TF32_MODES = ("phase", "phase", "conv", "last")
# The 3xTF32 operands' lengths (f32 elements, hi and lo) at the kernel's width.
_TF32_NUMEL = {"up1_tf32": 2 * 4 * 4 * KERNEL_NF**2, "up2_tf32": 2 * 4 * 4 * KERNEL_NF**2,
               "hr_tf32": 2 * 9 * 128 * KERNEL_NF, "last_tf32": 2 * 3 * 24 * KERNEL_NF}


def _check_f32(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> None:
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be an f32 (N, nf, h, w) tensor, got {tuple(x.shape)} {x.dtype}")
    for name, _, _ in F32_STAGES:
        t = p.get(f"{name}_hwio")
        if t is None or t.device != x.device or p[f"{name}_b"].device != x.device:
            raise ValueError(f"{name}_hwio must be packed in float32 (pack_tail) on x's device")


def _simt_stage(k: int, x: torch.Tensor, p: Dict[str, torch.Tensor], out: torch.Tensor, **window) -> torch.Tensor:
    """Stage ``k`` as the f32 first design runs it: one
    :func:`.conv_f32.conv_f32_fwd` (the SIMT kernel), the upsample-convs at
    the high resolution reading their input through x2."""
    name, up, epi = F32_STAGES[k]
    return conv_f32_fwd(x, p[f"{name}_hwio"], out, bias=p[f"{name}_b"], up=up, epi=epi, **window)


def tail_stage_tf32_cuda(k: int, x: torch.Tensor, p: Dict[str, torch.Tensor], out: torch.Tensor, *,
                         hin: Optional[int] = None, rows: Optional[Tuple[int, int]] = None, x_row0: int = 0,
                         out_row0: int = 0) -> torch.Tensor:
    """Stage ``k`` of the f32 tail (0 upconv1, 1 upconv2, 2 hr_conv, 3
    conv_last) as one launch of the 3xTF32 kernel (``csrc/conv_frame_tf32.cu``:
    phase mode for the upsample-convs at the low resolution, conv mode for
    hr_conv, last mode (n24 products) for conv_last; ``conv_stack.tf32_launch``, counted in
    ``conv_stack.conv_frame_tf32_cuda.launches``). ``x`` contiguous NHWC f32
    ``(N, rows held, w, 64)`` on the card, ``out`` contiguous NHWC ``(N, rows,
    w', 64 or 3)``; the row window as :func:`.conv_f32.conv_f32_fwd`'s:
    ``x``'s row 0 is the frame's row ``x_row0`` of ``hin``, the output rows
    ``rows = (r0, r1)`` (2x the input's for an upsample-conv) are written at
    ``r - out_row0``. ``p`` from :func:`pack_tail` in f32 at the kernel's
    width (``*_tf32``); anything else is refused. Returns ``out``."""
    name, up, epi = F32_STAGES[k]
    key = f"{name}_tf32"
    mat = p.get(key)
    if mat is None or mat.numel() != _TF32_NUMEL[key]:
        raise ValueError(f"{key} must be packed in float32 at the kernel's width {KERNEL_NF} (pack_tail)")
    if x.dim() != 4 or x.shape[3] != KERNEL_NF or out.dim() != 4 or not out.is_contiguous():
        raise ValueError(f"x must be NHWC (N, H, W, {KERNEL_NF}) and out contiguous NHWC")
    s = 2 if up else 1
    want = (x.shape[0], s * x.shape[2], 3 if k == 3 else KERNEL_NF)
    if (out.shape[0], out.shape[2], out.shape[3]) != want:
        raise ValueError(f"out {tuple(out.shape)} is not stage {k}'s output of x {tuple(x.shape)}")
    conv_stack.tf32_launch(x, mat, p[f"{name}_b"], out, mode=TF32_MODES[k], k=3,
                           cout=4 * KERNEL_NF if up else want[2], epi=epi, hin=hin, rows=rows, x_row0=x_row0,
                           out_row0=out_row0)
    return out


def tail_stage_tf32_plain(k: int, x: torch.Tensor, p: Dict[str, torch.Tensor], out: torch.Tensor,
                          **window) -> torch.Tensor:
    """The plain version of :func:`tail_stage_tf32_cuda` on any device, the
    same arguments: the stage in f32 (:func:`.conv_f32.conv_f32_fwd_plain`,
    the upsample-convs through x2, the same function as their 4-phase form)
    over the same rows."""
    name, up, epi = F32_STAGES[k]
    return conv_f32_fwd_plain(x, p[f"{name}_hwio"], out, bias=p[f"{name}_b"], up=up, epi=epi, **window)


def tail_f32_plan(p: Dict[str, torch.Tensor]) -> str:
    """The kernel of the f32 tail ``p`` on the card: ``"tf32"``
    (:func:`tail_stage_tf32_cuda`) where :func:`pack_tail` made the 3xTF32
    operands (nf 64, the kernel's width), ``"simt"`` (:func:`_simt_stage`) at
    any other width, as K7 / K8 send their thin convs."""
    return "tf32" if all(f"{name}_tf32" in p for name, _, _ in F32_STAGES) else "simt"


def tail_stage_f32(k: int, x: torch.Tensor, p: Dict[str, torch.Tensor], out: torch.Tensor,
                   **window) -> torch.Tensor:
    """Stage ``k`` of the f32 route: off the CPU the kernel of
    :func:`tail_f32_plan` (each takes a CUDA tensor and refuses any other),
    its plain version for a CPU tensor; nothing falls back."""
    if out.device.type == "cpu":
        return tail_stage_tf32_plain(k, x, p, out, **window)
    if tail_f32_plan(p) == "tf32":
        return tail_stage_tf32_cuda(k, x, p, out, **window)
    return _simt_stage(k, x, p, out, **window)


def tail_f32_stages(x: torch.Tensor, p: Dict[str, torch.Tensor], keep: int = 4, stage=tail_stage_f32):
    """The first ``keep`` stages of :func:`tail_f32` on NHWC ``x`` (one
    ``stage`` each, :func:`tail_stage_f32` by default): their NHWC outputs, in
    order (the backward's recompute keeps 3)."""
    outs = []
    for k, (name, up, _) in enumerate(F32_STAGES[:keep]):
        n, h, w, _ = x.shape
        s = 2 if up else 1
        y = torch.empty((n, s * h, s * w, p[f"{name}_hwio"].shape[3]), dtype=x.dtype, device=x.device)
        x = stage(k, x.contiguous(), p, y)
        outs.append(x)
    return outs


def tail_f32(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tail's f32 route (K4 in f32, ``rrdbnet_tail_pallas`` with f32
    weights): four launches of the 3xTF32 kernel (:func:`tail_stage_f32`;
    the SIMT kernel at nf != 64), NHWC, the upsample-convs in their 4-phase
    form. ``x`` f32 ``(N, nf, h,
    w)``, any layout; returns ``(N, 3, 4h, 4w)`` with channels-last strides,
    like :func:`tail_cuda`. Launches count in ``tail_f32.launches``."""
    _check_f32(x, p)
    out = tail_f32_stages(nhwc(x), p)[-1]
    if x.is_cuda:
        tail_f32.launches += TAIL_KERNELS
    return out.permute(0, 3, 1, 2)


tail_f32.launches = 0


def tail_f32_first(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The f32 first design of :func:`tail_f32`: four
    :func:`.conv_f32.conv_f32_fwd` launches (the SIMT kernel), the
    upsample-convs at the high resolution. Kept to time the route against on
    the card; no path of the port calls it."""
    _check_f32(x, p)
    return tail_f32_stages(nhwc(x), p, stage=_simt_stage)[-1].permute(0, 3, 1, 2)


def _reads(lo: int, hi: int, up: bool, h: int) -> Tuple[int, int]:
    """The input rows ``[a, b)`` (of an ``h``-row input) a 3x3 conv's output
    rows ``[lo, hi)`` read, through x2 with ``up``."""
    a, b = lo - 1, hi
    if up:
        a, b = a >> 1, b >> 1
    return max(a, 0), min(b + 1, h)


def f32_band_plans(h: int, band_rows: int):
    """Per band of an ``h``-row tail input, the rows of x, upconv1's,
    upconv2's, hr_conv's and conv_last's outputs that the band computes:
    conv_last the band's own (x4), each stage before it the rows the next
    one reads."""
    plans = []
    for r0, r1 in rrdb_ops.bands(h, band_rows):
        win = [(4 * r0, 4 * r1)]  # conv_last, hr_conv, upconv2, upconv1, x
        for (_, up, _), hh in zip(F32_STAGES[::-1], (4 * h, 4 * h, 2 * h, h)):
            win.append(_reads(*win[-1], up, hh))
        plans.append(win[::-1])  # x, upconv1, upconv2, hr_conv, conv_last
    return plans


def _banded_f32(x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int, stage,
                counter=None) -> torch.Tensor:
    """The f32 tail in row bands, each stage one ``stage`` call per band
    (:func:`tail_banded_f32`), its launches counted in ``counter.launches``
    where a ``counter`` is given."""
    _check_f32(x, p)
    n, _, h, w = x.shape
    xv = nhwc(x)
    plans = f32_band_plans(h, band_rows)
    most = [max(pl[i][1] - pl[i][0] for pl in plans) for i in (1, 2, 3)]
    bufs = [torch.empty((n, rows, s * w, p[f"{name}_hwio"].shape[3]), dtype=x.dtype, device=x.device)
            for rows, s, name in zip(most, (2, 4, 4), ("up1", "up2", "hr"))]
    out = torch.empty((n, 4 * h, 4 * w, 3), dtype=x.dtype, device=x.device)
    for win in plans:
        src, src_h = xv, h
        for i, (_, up, _) in enumerate(F32_STAGES):
            dst = bufs[i] if i < 3 else out
            rows_out = win[i + 1]
            stage(i, src, p, dst, hin=src_h, rows=rows_out, x_row0=win[i][0] if i else 0,
                  out_row0=rows_out[0] if i < 3 else 0)
            src, src_h = dst, (2 if up else 1) * src_h
        if x.is_cuda and counter is not None:
            counter.launches += TAIL_KERNELS
    return out.permute(0, 3, 1, 2)


def tail_banded_f32(
    x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = TAIL_BAND_ROWS
) -> torch.Tensor:
    """The tail's f32 route in row bands (K5 in f32, the banded branch of
    ``rrdbnet_tail_pallas``): per band of low-resolution rows ``[r0, r1)``
    four launches of the 3xTF32 kernel (:func:`tail_stage_f32`), conv_last
    computing the band's own output rows ``[4 r0, 4 r1)`` and each stage
    before it the rows the next one reads, into band-sized buffers made once
    and reused by every band; upconv1 reads x in place. Equals
    :func:`tail_f32` bit for bit (the same sums in the same order);
    launches count in ``tail_banded_f32.launches``."""
    return _banded_f32(x, p, band_rows, tail_stage_f32, tail_banded_f32)


tail_banded_f32.launches = 0


def tail_banded_f32_first(
    x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = TAIL_BAND_ROWS
) -> torch.Tensor:
    """The f32 first design of :func:`tail_banded_f32`, every stage one
    :func:`.conv_f32.conv_f32_fwd` per band; only chip_smoke.py calls it."""
    return _banded_f32(x, p, band_rows, _simt_stage)


def tail(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernels for a CUDA tensor (the wgmma kernels in bf16, the f32
    route in f32; :func:`.conv_f32.kernel_route`), the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return (tail_f32 if kernel_route(x.dtype) == "f32" else tail_cuda)(x, p)
    if x.device.type != "cpu":
        raise ValueError(f"no tail implementation for device {x.device}")
    return tail_plain(x, p)


def tail_banded(x: torch.Tensor, p: Dict[str, torch.Tensor], band_rows: int = 0) -> torch.Tensor:
    """The tail in row bands of ``band_rows`` rows (:data:`TAIL_BAND_ROWS`
    for 0): K5 for a CUDA tensor, the plain band decomposition for a CPU
    tensor."""
    br = band_rows or TAIL_BAND_ROWS
    if x.is_cuda:
        return (tail_banded_f32 if kernel_route(x.dtype) == "f32" else tail_banded_cuda)(x, p, br)
    if x.device.type != "cpu":
        raise ValueError(f"no tail implementation for device {x.device}")
    return tail_banded_plain(x, p, br)


def tail_flops(n: int, h: int, w: int, nf: int = KERNEL_NF) -> int:
    """Multiply-adds x2 the tail needs from a ``(n, nf, h, w)`` input: each
    upsample-conv in its 4-phase form (4 taps per output pixel, as the TPU
    kernel and both CUDA designs run it), hr_conv and conv_last at 9 taps."""
    px2, px4 = 4 * h * w, 16 * h * w
    return 2 * n * nf * (4 * px2 * nf + 4 * px4 * nf + 9 * px4 * nf + 9 * px4 * 3)
