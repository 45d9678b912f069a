"""The port's tail plain versions against the JAX phase-space tail kernel
(``rrdbnet_tail_pallas`` in interpret mode, full frame and in row bands),
f32; the packed layouts the CUDA tail kernels read; and the wgmma tail
(``csrc/tail_wgmma.cuh``) emulated on the CPU through its descriptors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops.pallas_tail import rrdbnet_tail_pallas
from master_thesis_tpu_torch.models.nn_ext import leaky_relu, pixel_shuffle_2x
from master_thesis_tpu_torch.ops import fragments
from master_thesis_tpu_torch.ops import tail as ttail


def _tail_params(rng, nf):
    p = {}
    for name, cout in (("upconv1", nf), ("upconv2", nf), ("hr_conv", nf), ("conv_last", 3)):
        p[f"{name}_kernel"] = (rng.randn(3, 3, nf, cout) * 0.2).astype(np.float32)
        p[f"{name}_bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
    return p


def _pack(p, dtype=torch.float32):
    conv = lambda n: (
        torch.from_numpy(p[f"{n}_kernel"]).permute(3, 2, 0, 1),
        torch.from_numpy(p[f"{n}_bias"]),
    )
    return ttail.pack_tail(conv("upconv1"), conv("upconv2"), conv("hr_conv"), conv("conv_last"), dtype)


@pytest.mark.parametrize("h,w,n", [(8, 8, 2), (6, 10, 1)])
def test_tail_plain_matches_pallas(rng, h, w, n):
    """Square, and the 6x10 grid that a 24x40 frame gives (the reference's
    240x480 is 60x120)."""
    nf = 16
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    want = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y), jnp.float32, interpret=True)
    got = ttail.tail(torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(), _pack(p))
    assert got.shape == (n, 3, 4 * h, 4 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("band_rows", [2, 4])
def test_tail_banded_plain_matches_pallas_banded(rng, band_rows):
    """A 10x6 input in row bands with the 4-row halo: 2 gives 5 bands, 4
    gives 4, 4 and a last band of 2; only the first and last are clipped by
    the frame at both band heights. Tolerance as the full-frame tail's."""
    nf, h, w, n = 16, 10, 6, 2
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    want = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y), jnp.float32,
                               interpret=True, band_rows=band_rows)
    x = torch.from_numpy(y).permute(0, 3, 1, 2).contiguous()
    packed = _pack(p)
    got = ttail.tail_banded_plain(x, packed, band_rows)
    assert got.shape == (n, 3, 4 * h, 4 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)
    torch.testing.assert_close(ttail.tail_banded(x, packed, band_rows), got, atol=0, rtol=0)
    torch.testing.assert_close(got, ttail.tail_plain(x, packed), atol=1e-5, rtol=0)


def test_tail_kernel_layouts(rng):
    """The kernel-side layouts compute what the plain-side ones do: the
    phase form of each upsample-conv (phase ``(a, b)``, tap ``(ti, tj)``
    reads input offset ``(a-1+ti, b-1+tj)``, rows ``(ti, tj, c)``), and
    hr_conv / conv_last as ``(9*C, O)`` matrices, all in the fragment order
    of ``ops/fragments.py``."""
    nf, h, w = 16, 5, 7
    p = _pack(_tail_params(rng, nf))
    x = torch.from_numpy(rng.randn(2, nf, h, w).astype(np.float32))
    xp = F.pad(x, (1, 1, 1, 1))
    for name in ("up1", "up2"):
        want = pixel_shuffle_2x(F.conv2d(x, p[f"{name}_fused"], padding=1))
        phases = p[f"{name}_phase"].reshape(4, -1)
        got = torch.empty_like(want)
        for a in (0, 1):
            for b in (0, 1):
                mat = fragments.unpack(phases[a * 2 + b], 4 * nf, nf).reshape(4, nf, nf)
                acc = 0
                for ti in (0, 1):
                    for tj in (0, 1):
                        win = xp[:, :, a + ti: a + ti + h, b + tj: b + tj + w]
                        acc = acc + torch.einsum("nchw,co->nohw", win, mat[ti * 2 + tj])
                got[:, :, a::2, b::2] = acc
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for key, cout in (("hr", nf), ("last", 3)):
        mat = fragments.unpack(p[f"{key}_w"], 9 * nf, cout).reshape(3, 3, nf, cout)
        torch.testing.assert_close(mat.permute(3, 2, 0, 1), p[f"{key}_oihw"], atol=0, rtol=0)
    assert p["last_w"].numel() == 9 * nf * 16


def test_tail_flops_counts_reference_convs():
    """619 GFLOP for the production step's tail (80 frames at 64x64): the
    upsample-convs in their 4-phase form (4/9 of the 888 GFLOP the nearest
    upsample then 3x3 convs would take), hr_conv and conv_last at 9 taps."""
    assert round(ttail.tail_flops(80, 64, 64) / 1e9) == 619
    nine_tap = 2 * 80 * 9 * 64 * (128**2 * 64 + 2 * 256**2 * 64 + 256**2 * 3)
    upconv_per_tap = 2 * 80 * 64 * 64 * (128**2 + 256**2)
    assert ttail.tail_flops(80, 64, 64) == nine_tap - 5 * upconv_per_tap


def _wide_params(rng, nf=ttail.KERNEL_NF):
    """Tail weights at the kernel's width, scaled to keep activations O(1)."""
    p = {}
    for name, cout in (("upconv1", nf), ("upconv2", nf), ("hr_conv", nf), ("conv_last", 3)):
        p[f"{name}_kernel"] = (rng.randn(3, 3, nf, cout) * (1.0 / (9 * nf)) ** 0.5).astype(np.float32)
        p[f"{name}_bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
    return p


# The wgmma tail's shared-memory geometry (csrc/tail_wgmma.cuh): a CTA
# computes `rows` input rows x 64 pixels from a (rows + 2) x 66 pixel tile,
# 128 bytes a pixel, 128-byte swizzled; the default rows a tile
# (TAIL_*_ROWS x TAIL_*_WG) of each stage.
_TW = 66
_TILE_ROWS = (2, 2, 4, 8)


def _emulate_stage(k, src, p, rows=None):
    """Stage k of the wgmma tail (0 upconv1, 1 upconv2, 2 hr_conv, 3
    conv_last) read through its descriptors: ``src`` (n, H, W, 64) f32
    NHWC, ``p`` from ``pack_tail``. Per tile the TMA box fills a flat
    shared-memory image (zeros outside the frame), 128-byte swizzled: pixel
    P's 16-byte chunk j at P * 128 + (j ^ P % 8) * 16. Each k16 step reads
    A (64 pixels x 16 channels) from the phase-tap's shifted start address
    (one pixel = 128 bytes, one k16 step = 32 bytes), row m's bytes at
    start + 128 m, each address swizzled by its own bits (chunk bits 4-6
    XOR row bits 7-9: the 128-byte mode with base offset 0), and B (16 x N)
    from the stage's resident block, no swizzle, SBO 128 bytes and LBO N / 8
    core matrices; f32 sums, bias, lrelu (not for conv_last); phase (a, b)
    of input pixel (y, x) lands at output pixel (2y + a, 2x + b)."""
    n, h, w, c = src.shape
    up = k < 2
    wk, bk = ttail._STAGE_KEYS[k]
    wg, bias = p[wk], p[bk]
    nout = 3 if k == 3 else c
    nmma = 8 if k == 3 else c
    phases, taps, scale = (4, 4, 2) if up else (1, 9, 1)
    rows = rows or _TILE_ROWS[k]
    tr = rows + 2
    runs = -(-w // 64)
    pad = torch.zeros(n, h + rows + 2, runs * 64 + 2, c)
    pad[:, 1: h + 1, 1: w + 1] = src
    m, kk = torch.arange(64).view(64, 1), torch.arange(16).view(1, 16)
    kb, o = torch.arange(16).view(16, 1), torch.arange(nmma).view(1, nmma)
    a_off = m * 128 + (kk // 8) * 16 + (kk % 8) * 2
    pix = torch.arange(tr * _TW).view(-1, 1, 1)
    dst = (pix * 128 + ((torch.arange(8).view(1, 8, 1) ^ pix % 8) * 16)) // 2 + torch.arange(8)
    b_off = (o // 8) * 128 + (o % 8) * 16 + (kb // 8) * (nmma // 8 * 128) + (kb % 8) * 2
    phase_b = taps * c * nmma * 2
    out = torch.zeros(n, scale * h, scale * w, nout)
    for f in range(n):
        for y0 in range(0, h, rows):
            for x0 in range(0, runs * 64, 64):
                tile = pad[f, y0: y0 + tr, x0: x0 + _TW]  # (tr, 66, 64)
                smem = torch.zeros(tr * _TW * 64)
                smem[dst] = tile.reshape(-1, 8, 8)
                for ph in range(phases):
                    acc = torch.zeros(rows, 64, nmma)
                    for cc in range(2):
                        for tap in range(taps):
                            ky, kx = ((ph >> 1) + (tap >> 1), (ph & 1) + (tap & 1)) if up else divmod(tap, 3)
                            for st in range(2):
                                b_start = ph * phase_b + ((cc * taps + tap) * 2 + st) * 2 * (nmma // 8) * 128
                                b_mat = wg[(b_start + b_off) // 2]
                                for r in range(rows):
                                    addr = ((r + ky) * _TW + kx) * 128 + 32 * (2 * cc + st) + a_off
                                    addr = addr ^ (((addr >> 7) & 7) << 4)  # the 128-byte swizzle
                                    acc[r] += smem[addr // 2] @ b_mat
                    a, b = (ph >> 1, ph & 1) if up else (0, 0)
                    for r in range(min(rows, h - y0)):
                        cols = min(64, w - x0)
                        v = acc[r, :cols, :nout] + bias
                        v = v if k == 3 else leaky_relu(v)
                        out[f, scale * (y0 + r) + a, scale * x0 + b: scale * (x0 + cols): scale] = v
    return out


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("k,h,w", [(0, 3, 70), (1, 5, 20), (2, 3, 70), (3, 5, 72)])
def test_wgmma_tail_stage_emulation_matches_plain(rng, k, h, w):
    """Each stage of the wgmma tail, emulated through its descriptors
    (``_emulate_stage``: the (rows + 2) x 66 channels-last tile, the 16
    phase-taps or 9 taps as shifted reads, the resident B blocks of
    ``fragments.wgmma_phase_matrix`` / ``wgmma_conv_matrix``), equals the
    plain stage (``tail_stage_plain``) in f32: ragged row counts (a tile
    past the last row) and widths over one 64-pixel run. Tolerance: f32
    sums in two orders."""
    p = _pack(_wide_params(rng))
    x = torch.from_numpy(rng.randn(1, ttail.KERNEL_NF, h, w).astype(np.float32))
    want = ttail.tail_stage_plain(k, x, p)
    got = _emulate_stage(k, _nhwc(x), p)
    torch.testing.assert_close(got, _nhwc(want), atol=1e-5, rtol=0)


def test_wgmma_tail_emulation_matches_plain_and_pallas(rng):
    """The four emulated stages chained (a 3x18 grid: h2 and h3 are 72
    wide, two row runs) against ``tail_plain`` (atol 1e-5) and, as
    ``test_tail_plain_matches_pallas``, against ``rrdbnet_tail_pallas`` in
    interpret mode (atol 5e-5), at the kernel's width."""
    raw = _wide_params(rng)
    p = _pack(raw)
    y = rng.randn(1, 3, 18, ttail.KERNEL_NF).astype(np.float32)
    t = torch.from_numpy(y)
    for k in range(4):
        t = _emulate_stage(k, t, p)
    want = ttail.tail_plain(torch.from_numpy(y).permute(0, 3, 1, 2), p)
    torch.testing.assert_close(t, _nhwc(want), atol=1e-5, rtol=0)
    jax_out = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(y), jnp.float32,
                                  interpret=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(jax_out), atol=5e-5)


def test_wgmma_tail_packing(rng):
    """``pack_tail``'s wgmma operands: each upsample-conv's 16 phase-taps
    (``fragments.wgmma_phase_matrix``, index order (phase, chunk, tap,
    step, half, o // 8, o % 8, c % 8)) hold the 4-phase kernel's taps;
    hr_conv and conv_last (outputs padded to 8) unpack to their OIHW
    kernels; narrow widths get none."""
    nf = ttail.KERNEL_NF
    raw = _wide_params(rng)
    p = _pack(raw)
    for key, numel in ttail._WG_NUMEL.items():
        assert p[key].numel() == numel
    fused = p["up1_fused"]  # (4 * O, C, 3, 3), phases (a, b, o)
    # phase (a, b) = (1, 0), chunk 1, tap (ti, tj) = (0, 1), step 1, half 0,
    # output 8 * 2 + 3, channel 32 + 16 + 0 + 5: fused[(2a + b) O + o, c,
    # a + ti, b + tj].
    idx = ((((1 * 4 + 1) * 2 + 1) * 2 + 0) * (nf // 8) + 2) * 64 + 3 * 8 + 5
    idx += 2 * 4 * nf * nf  # phase 2
    assert p["up1_wg"][idx].item() == fused[2 * nf + 19, 53, 1, 1].item()
    torch.testing.assert_close(fragments.wgmma_unpack(p["hr_wg"], nf, nf), p["hr_oihw"], atol=0, rtol=0)
    last = fragments.wgmma_unpack(p["last_wg"], 8, nf)
    torch.testing.assert_close(last[:3], p["last_oihw"], atol=0, rtol=0)
    assert not last[3:].any()
    assert "up1_wg" not in _pack(_tail_params(rng, 16))


def test_tail_plain_channels_last_matches_nchw(rng):
    """``tail_plain`` takes either memory format and gives the same bits."""
    p = _pack(_tail_params(rng, 16))
    x = torch.from_numpy(rng.randn(2, 16, 5, 7).astype(np.float32))
    xc = x.contiguous(memory_format=torch.channels_last)
    assert xc.is_contiguous(memory_format=torch.channels_last) and not xc.is_contiguous()
    assert torch.equal(ttail.tail_plain(xc, p), ttail.tail_plain(x, p))


def test_tail_stage_costs_sum_to_the_tail():
    """The four stages' FLOPs (``tail_stage_cost``) sum to ``tail_flops``;
    each stage's bytes are its input and output once (80 frames at 64x64:
    upconv1 42 MB in, 168 MB out)."""
    assert sum(ttail.tail_stage_cost(k, 80, 64, 64)[0] for k in range(4)) == ttail.tail_flops(80, 64, 64)
    assert ttail.tail_stage_cost(0, 80, 64, 64)[1] == 2 * 80 * 64 * 64 * 64 * 5
    assert ttail.tail_stage_cost(3, 80, 64, 64)[1] == 2 * 80 * 256 * 256 * (64 + 3)
