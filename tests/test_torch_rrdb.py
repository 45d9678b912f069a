"""The port's RRDB plain versions against the JAX fused RRDB kernels
(``rrdb_pallas`` / ``rrdb_trunk_pallas`` / ``rrdb_trunk_pallas_banded`` in
interpret mode), f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops.pallas_rrdb import (
    rrdb_pallas,
    rrdb_trunk_pallas,
    rrdb_trunk_pallas_banded,
)
from master_thesis_tpu_torch.ops import fragments
from master_thesis_tpu_torch.ops import rrdb as trrdb


def _rrdb_params(rng, nf, gc):
    """One RRDB's JAX params (HWIO kernels), numpy f32."""
    p = {}
    for j in (1, 2, 3):
        rdb = {}
        for k in range(5):
            cin, cout = nf + k * gc, (gc if k < 4 else nf)
            rdb[f"conv{k + 1}_kernel"] = (rng.randn(3, 3, cin, cout) * (1.0 / (9 * cin)) ** 0.5).astype(np.float32)
            rdb[f"conv{k + 1}_bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
        p[f"rdb{j}"] = rdb
    return p


def _pack(p):
    """JAX RRDB params -> the port's three packed RDBs (f32)."""
    out = []
    for j in (1, 2, 3):
        rdb = p[f"rdb{j}"]
        convs = [
            (torch.from_numpy(rdb[f"conv{k}_kernel"]).permute(3, 2, 0, 1),
             torch.from_numpy(rdb[f"conv{k}_bias"]))
            for k in range(1, 6)
        ]
        out.append(trrdb.pack_rdb(convs, torch.float32))
    return out


def _to_jax(p):
    return {j: {k: jnp.asarray(v) for k, v in d.items()} for j, d in p.items()}


@pytest.mark.parametrize("nf,gc,h,w,n", [(16, 8, 8, 16, 2), (64, 32, 8, 8, 1)])
def test_rrdb_plain_matches_pallas(rng, nf, gc, h, w, n):
    """One RRDB; the second case is the production nf=64, gc=32."""
    p = _rrdb_params(rng, nf, gc)
    x = rng.rand(n, nf, h, w).astype(np.float32)
    want = rrdb_pallas(
        jnp.asarray(x.reshape(n, nf, h * w)), _to_jax(p), nf, gc, w, interpret=True
    )
    got = trrdb.rrdb_trunk(torch.from_numpy(x), [_pack(p)])
    np.testing.assert_allclose(got.numpy().reshape(n, nf, h * w), np.asarray(want), atol=5e-5)


def test_rrdb_plain_chain_matches_trunk(rng):
    """Two chained RRDBs against ``rrdb_trunk_pallas``."""
    nf, gc, h, w, n = 16, 8, 8, 8, 1
    p1, p2 = _rrdb_params(rng, nf, gc), _rrdb_params(rng, nf, gc)
    x = rng.rand(n, h, w, nf).astype(np.float32)
    want = rrdb_trunk_pallas(
        jnp.asarray(x), {"rrdb_0": _to_jax(p1), "rrdb_1": _to_jax(p2)}, nb=2,
        nf=nf, gc=gc, interpret=True,
    )
    got = trrdb.rrdb_trunk(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
        [_pack(p1), _pack(p2)],
    )
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("band_rows", [3, 4, 12])
def test_rrdb_trunk_banded_plain_matches_pallas_banded(rng, band_rows):
    """Two RRDBs at nf 16, gc 8 on a 14x8 frame in row bands: 3 and 4 give
    5 and 4 bands whose last one is 2 rows, 12 a band of 12 and one of 2;
    the first and last bands are clipped by the frame, the halos of the
    others read their neighbours. Tolerance as the full-frame trunk's."""
    nf, gc, h, w, n = 16, 8, 14, 8, 2
    p1, p2 = _rrdb_params(rng, nf, gc), _rrdb_params(rng, nf, gc)
    x = rng.rand(n, h, w, nf).astype(np.float32)
    want = rrdb_trunk_pallas_banded(
        jnp.asarray(x), {"rrdb_0": _to_jax(p1), "rrdb_1": _to_jax(p2)}, nb=2,
        nf=nf, gc=gc, interpret=True, band_rows=band_rows,
    )
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    packed = [_pack(p1), _pack(p2)]
    got = trrdb.rrdb_trunk_banded_plain(xt, packed, band_rows)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)
    # The CPU dispatch takes the plain version; the bands change nothing.
    torch.testing.assert_close(trrdb.rrdb_trunk_banded(xt, packed, band_rows), got, atol=0, rtol=0)
    torch.testing.assert_close(got, trrdb.rrdb_trunk(xt, packed), atol=1e-5, rtol=0)


def test_bands_cover_the_frame():
    assert trrdb.bands(14, 4) == [(0, 4), (4, 8), (8, 12), (12, 14)]
    assert trrdb.bands(128, trrdb.TRUNK_BAND_ROWS) == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert trrdb.bands(5, 8) == [(0, 5)]
    with pytest.raises(ValueError, match="positive"):
        trrdb.bands(5, 0)


def test_pack_rdb_layout(rng):
    """The packed buffer holds each conv as a ``(9*Cin, out)`` matrix, rows
    ``(ky, kx, c)``, in the tensor-core fragment order ``csrc/rrdb.cu``
    reads (``ops/fragments.py``), at the sizes the kernel is compiled for;
    unpacking gives the kernels back, which the plain version reads as
    OIHW."""
    nf, gc = trrdb.KERNEL_NF, trrdb.KERNEL_GC
    p = _rrdb_params(rng, nf, gc)
    packed = _pack(p)[0]
    w, b = packed.w, packed.b
    assert w.numel() == trrdb._RDB_W_NUMEL == 239616 and b.numel() == 192
    offset = 0
    for k, (cin, cout) in enumerate(trrdb._widths(nf, gc)):
        size = fragments.numel(9 * cin, cout)
        mat = fragments.unpack(w[offset: offset + size], 9 * cin, cout)
        want = p["rdb1"][f"conv{k + 1}_kernel"]
        np.testing.assert_array_equal(mat.reshape(3, 3, cin, cout).numpy(), want)
        np.testing.assert_array_equal(packed.kernels[k].permute(2, 3, 1, 0).numpy(), want)
        offset += size
    # conv1's (576, 32) matrix, block (kb=3, nb=1), lane 4*g+t = 4*5+1,
    # register 3 (second n8 tile, rows +8), element 1.
    mat = p["rdb1"]["conv1_kernel"].reshape(-1, gc)
    row, col = 16 * 3 + 2 * 1 + 1 + 8, 16 * 1 + 5 + 8
    idx = ((3 * (gc // 16) + 1) * 32 + 4 * 5 + 1) * 8 + 3 * 2 + 1
    assert w[idx].item() == mat[row, col]


def test_rdb_dispatch_rejects_unknown_device():
    x = torch.zeros(1, 16, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no RDB implementation"):
        trrdb.rdb(x, trrdb.PackedRDB(torch.zeros(1), torch.zeros(1), ()))


def test_pack_rdbs_matches_pack_per_conv(rng):
    """Packing many RDBs with one gather per layout gives, for each, what
    packing each conv on its own gives (``fragments.conv_matrix``,
    ``wgmma_conv_matrix``, ``adjoint_matrix``), padded widths included
    (nf=16, gc=8: 8 outputs pad to 16)."""
    for nf, gc in ((16, 8), (64, 32)):
        rdbs = [_rrdb_params(rng, nf, gc) for _ in range(2)]
        convs = [
            [(torch.from_numpy(p[f"rdb{j}"][f"conv{k}_kernel"]).permute(3, 2, 0, 1),
              torch.from_numpy(p[f"rdb{j}"][f"conv{k}_bias"])) for k in range(1, 6)]
            for p in rdbs for j in (1, 2, 3)
        ]
        packed = trrdb.pack_rdbs(convs, torch.float32)
        adjs = trrdb.pack_rdb_adjoints(convs, torch.float32)
        for c, p, adj in zip(convs, packed, adjs):
            assert torch.equal(p.w, torch.cat([fragments.conv_matrix(w) for w, _ in c]))
            if nf == trrdb.KERNEL_NF:
                assert torch.equal(p.wg, torch.cat([fragments.wgmma_conv_matrix(w) for w, _ in c]))
            assert torch.equal(p.b, torch.cat([b for _, b in c]))
            assert all(torch.equal(k, w) for k, (w, _) in zip(p.kernels, c))
            assert all(torch.equal(a, fragments.adjoint_matrix(w)) for a, (w, _) in zip(adj, c))


def _conv_params(rng, cin, cout):
    w = (rng.randn(cout, cin, 3, 3) * (1.0 / (9 * cin)) ** 0.5).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))


def test_wgmma_packing_unpacks_to_the_kernels(rng):
    """K1's B blocks (``PackedRDB.wg``, ``fragments.wgmma_conv_matrix``)
    unpack exactly to each of the five OIHW kernels at the production
    widths; widths the kernel does not take get none."""
    nf, gc = trrdb.KERNEL_NF, trrdb.KERNEL_GC
    convs = [_conv_params(rng, cin, cout) for cin, cout in trrdb._widths(nf, gc)]
    packed = trrdb.pack_rdb(convs, torch.float32)
    assert packed.wg.numel() == trrdb._RDB_W_NUMEL
    offset = 0
    for (w, _), (cin, cout) in zip(convs, trrdb._widths(nf, gc)):
        size = 9 * cin * cout
        assert torch.equal(fragments.wgmma_unpack(packed.wg[offset: offset + size], cout, cin), w)
        offset += size
    # conv1, chunk 1 (channels 32..63), tap 4 (ky=1, kx=1), k16 step 1,
    # half 0, output 8 * 2 + 3, channel 32 + 16 + 0 + 5.
    idx = ((((1 * 9 + 4) * 2 + 1) * 2 + 0) * (gc // 8) + 2) * 64 + 3 * 8 + 5
    assert packed.wg[idx].item() == convs[0][0][19, 53, 1, 1].item()
    small = trrdb.pack_rdb([_conv_params(rng, cin, cout) for cin, cout in trrdb._widths(16, 8)],
                           torch.float32)
    assert small.wg is None


# The wgmma kernel's shared-memory geometry (csrc/conv3x3_wgmma.cuh): a CTA
# computes ROWS rows x 64 pixels from a (ROWS + 2) x 66 pixel tile, each
# 8-channel group of a 32-channel K-chunk one plane of 16-byte pixels.
_RUN, _TW = 64, 66


def _emulate_conv(src, wg, cout, rows=2):
    """One 3x3 conv (no bias) as the kernel's packed per-tap GEMM, read
    through its descriptors: ``src`` (n, H, W, cin) f32 NHWC, ``wg`` the
    conv's B blocks. For each CTA tile and 32-channel chunk the four TMA
    boxes fill a flat shared-memory image (zeros outside the frame); each
    k16 step reads A (64 pixels x 16 channels) at the tap's shifted start
    address with SBO 128 bytes and LBO one plane, and B (16 x cout) with
    SBO 128 bytes and LBO cout / 8 core matrices. f32 sums."""
    n, h, w, cin = src.shape
    tr = rows + 2
    plane = -(-tr * _TW * 16 // 128) * 128  # bytes
    runs = -(-w // _RUN)
    pad = torch.zeros(n, h + rows + 2, runs * _RUN + 2, cin)
    pad[:, 1: h + 1, 1: w + 1] = src
    m = torch.arange(64).view(64, 1)
    k = torch.arange(16).view(1, 16)
    kb = torch.arange(16).view(16, 1)
    o = torch.arange(cout).view(1, cout)
    b_addr = (o // 8) * 128 + (o % 8) * 16 + (kb // 8) * (cout // 8 * 128) + (kb % 8) * 2
    out = torch.zeros(n, h, w, cout)
    for f in range(n):
        for y0 in range(0, h, rows):
            for x0 in range(0, runs * _RUN, _RUN):
                acc = torch.zeros(rows, _RUN, cout)
                for c in range(cin // 32):
                    tile = pad[f, y0: y0 + tr, x0: x0 + _TW, 32 * c: 32 * c + 32]  # (tr, 66, 32)
                    smem = torch.zeros(4 * plane // 2)
                    for g in range(4):
                        flat = tile[:, :, 8 * g: 8 * g + 8].reshape(-1)
                        smem[g * plane // 2: g * plane // 2 + flat.numel()] = flat
                    block = wg[c * 9 * 32 * cout: (c + 1) * 9 * 32 * cout]
                    for t in range(9):
                        for s in range(2):
                            b_mat = block[(((t * 2 + s) * 2 * (cout // 8) * 128) + b_addr) // 2]
                            for r in range(rows):
                                start = 2 * s * plane + ((r + t // 3) * _TW + t % 3) * 16
                                a_addr = start + (m // 8) * 128 + (m % 8) * 16 + (k // 8) * plane + (k % 8) * 2
                                acc[r] += smem[a_addr // 2] @ b_mat
                for r in range(min(rows, h - y0)):
                    cols = min(_RUN, w - x0)
                    out[f, y0 + r, x0: x0 + cols] = acc[r, :cols]
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_wgmma_packed_gemm_emulation_matches_conv2d(rng, k):
    """The packed per-tap GEMM, emulated through the kernel's descriptor
    addressing (``_emulate_conv``: im2col by the nine shifts, 32-channel
    chunks, f32), equals ``F.conv2d`` with zero padding for each of the five
    convs, at a ragged shape (3 rows: a CTA past the last row; 70 columns:
    a second row run 6 pixels wide). Tolerance: f32 sums in two orders."""
    cin, cout = trrdb._widths(trrdb.KERNEL_NF, trrdb.KERNEL_GC)[k - 1]
    w, _ = _conv_params(rng, cin, cout)
    src = torch.from_numpy(rng.randn(1, 3, 70, cin).astype(np.float32))
    want = torch.nn.functional.conv2d(src.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    got = _emulate_conv(src, fragments.wgmma_conv_matrix(w), cout)
    torch.testing.assert_close(got, want, atol=2e-5 * want.abs().max().item(), rtol=0)


def test_rrdb_channels_last_matches_pallas(rng):
    """A channels-last trunk input (the layout the kernels take on the card)
    through ``rrdb_trunk`` on the CPU against ``rrdb_pallas`` in interpret
    mode, at the production widths; equal to the NCHW input's output."""
    nf, gc, h, w, n = 64, 32, 8, 8, 1
    p = _rrdb_params(rng, nf, gc)
    x = rng.rand(n, nf, h, w).astype(np.float32)
    want = rrdb_pallas(jnp.asarray(x.reshape(n, nf, h * w)), _to_jax(p), nf, gc, w, interpret=True)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    assert xt.is_contiguous(memory_format=torch.channels_last) and not xt.is_contiguous()
    got = trrdb.rrdb_trunk(xt, [_pack(p)])
    np.testing.assert_allclose(got.numpy().reshape(n, nf, h * w), np.asarray(want), atol=5e-5)
    torch.testing.assert_close(got, trrdb.rrdb_trunk(torch.from_numpy(x), [_pack(p)]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("h,band_rows", [(14, 4), (128, trrdb.TRUNK_BAND_ROWS), (5, 8), (20, 3)])
def test_band_windows_cover_each_band_and_clip(h, band_rows):
    """K2's row windows (``band_windows``, as ``csrc/rrdb.cu`` computes them):
    conv k of band [r0, r1) covers [r0 - (5 - k), r1 + (5 - k)) clipped to
    the frame, so each conv computes every row the next conv reads and
    conv5 exactly the band; conv1's window is the band scratch."""
    spans = trrdb.bands(h, band_rows)
    covered = []
    for r0, r1 in spans:
        wins = trrdb.band_windows(h, r0, r1)
        assert len(wins) == 5 and wins[4] == (r0, r1)
        for k, (lo, hi) in enumerate(wins, start=1):
            assert (lo, hi) == (max(r0 - (5 - k), 0), min(r1 + (5 - k), h))
            assert 0 <= lo < hi <= h
        for (lo_a, hi_a), (lo_b, hi_b) in zip(wins, wins[1:]):
            # conv k+1 reads rows [lo_b - 1, hi_b + 1) of x_k within the frame
            assert lo_a <= max(lo_b - 1, 0) and hi_a >= min(hi_b + 1, h)
        covered.extend(range(r0, r1))
    assert covered == list(range(h))
