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
    """Packing many RDBs with one gather gives, for each, what packing each
    conv on its own gives (``fragments.conv_matrix``, ``adjoint_matrix``),
    padded widths included (nf=16, gc=8: 8 outputs pad to 16)."""
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
            assert torch.equal(p.b, torch.cat([b for _, b in c]))
            assert all(torch.equal(k, w) for k, (w, _) in zip(p.kernels, c))
            assert all(torch.equal(a, fragments.adjoint_matrix(w)) for a, (w, _) in zip(adj, c))
