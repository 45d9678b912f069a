"""The port's trunk backward (``TrunkFunction`` on the CPU, i.e. the plain
backward ``rrdb_bwd_plain`` over the activations the forward kept) against
``jax.grad`` through the JAX ``make_hybrid_trunk``, whose backward is the
fused ``rrdb_bwd_pallas`` in interpret mode; the plain backward against
``torch.autograd`` through ``rdb_plain``; and emulations of K3's pull-form
adjoint and its MN-major weight-grad operands (``csrc/conv_bwd_wgmma.cuh``)
against the plain backward and ``conv2d_weight``. f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops.pallas_rrdb import make_hybrid_trunk
from master_thesis_tpu_torch.ops import rrdb as trrdb
from master_thesis_tpu_torch.ops import rrdb_bwd
from master_thesis_tpu_torch.ops import fragments
from tests.test_torch_rrdb import _RUN, _TW, _emulate_conv, _rrdb_params, _to_jax


def _flat_params(ps):
    """JAX RRDB params (list over RRDBs) -> the Function's flat OIHW list."""
    out = []
    for p in ps:
        for j in (1, 2, 3):
            for k in range(1, 6):
                out.append(torch.from_numpy(p[f"rdb{j}"][f"conv{k}_kernel"]).permute(3, 2, 0, 1).contiguous())
                out.append(torch.from_numpy(p[f"rdb{j}"][f"conv{k}_bias"]).clone())
    return [t.requires_grad_() for t in out]


@pytest.mark.parametrize(
    "nf,gc,nb,n,h,w",
    [(16, 8, 2, 2, 8, 8), (64, 32, 1, 1, 8, 8), (16, 8, 1, 1, 6, 10)],
    ids=["nf16-nb2", "production-channels", "ragged"],
)
def test_trunk_function_grads_match_jax(rng, nf, gc, nb, n, h, w):
    """dx and every conv's weight and bias grad. The second case is the
    production nf=64, gc=32 (the dense-concat channel splits nf=16 misses,
    as tests/test_pallas_rrdb.py:193); the third a ragged H != W grid.
    Tolerance 2e-4 absolute, the JAX tests' own for this backward."""
    ps = [_rrdb_params(rng, nf, gc) for _ in range(nb)]
    x = rng.rand(n, h, w, nf).astype(np.float32)
    cot = rng.randn(n, h, w, nf).astype(np.float32)

    trunk = make_hybrid_trunk(nb=nb, nf=nf, gc=gc, dtype=jnp.float32, interpret=True)
    jparams = {f"rrdb_{i}": _to_jax(p) for i, p in enumerate(ps)}
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(
            lambda a, p: jnp.vdot(trunk(a, p), jnp.asarray(cot)), argnums=(0, 1)
        )(jnp.asarray(x), jparams)

    params = _flat_params(ps)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    y = rrdb_bwd.TrunkFunction.apply(xt, torch.float32, *params)
    y.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), atol=2e-4)
    idx = 0
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                wk = np.asarray(want_p[f"rrdb_{i}"][f"rdb{j}"][f"conv{k}_kernel"]).transpose(3, 2, 0, 1)
                wb = np.asarray(want_p[f"rrdb_{i}"][f"rdb{j}"][f"conv{k}_bias"])
                np.testing.assert_allclose(params[idx].grad.numpy(), wk, atol=2e-4, err_msg=f"{i}/{j}/{k}")
                np.testing.assert_allclose(params[idx + 1].grad.numpy(), wb, atol=2e-4, err_msg=f"{i}/{j}/{k}")
                idx += 2


def test_trunk_function_forward_is_the_trunk(rng):
    nf, gc = 16, 8
    ps = [_rrdb_params(rng, nf, gc)]
    x = torch.from_numpy(rng.rand(1, nf, 6, 6).astype(np.float32))
    params = _flat_params(ps)
    got = rrdb_bwd.TrunkFunction.apply(x, torch.float32, *params)
    packed = [[trrdb.pack_rdb([(params[j * 10 + 2 * k], params[j * 10 + 2 * k + 1]) for k in range(5)],
                              torch.float32) for j in range(3)]]
    assert torch.equal(got, trrdb.rrdb_trunk(x, packed))


@pytest.mark.parametrize("nf,gc", [(16, 8), (64, 32)])
def test_rdb_bwd_plain_matches_autograd(rng, nf, gc):
    """``rdb_bwd_plain`` (explicit adjoints and weight grads) against
    ``torch.autograd`` through ``rdb_plain``, f32; tolerance 1e-5 relative
    to each grad's scale."""
    p = _rrdb_params(rng, nf, gc)["rdb1"]
    ws = [torch.from_numpy(p[f"conv{k}_kernel"]).permute(3, 2, 0, 1).contiguous().requires_grad_() for k in range(1, 6)]
    bs = [torch.from_numpy(p[f"conv{k}_bias"]).clone().requires_grad_() for k in range(1, 6)]
    packed = trrdb.PackedRDB(None, torch.cat(bs), tuple(ws))  # differentiable view for autograd
    x = torch.from_numpy(rng.randn(2, nf, 7, 9).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, nf, 7, 9).astype(np.float32))
    want = torch.autograd.grad((trrdb.rdb_plain(x, packed) * g).sum(), [x, *ws, *bs])

    with torch.no_grad():
        _, hidden = trrdb.rdb_plain(x, packed, keep_hidden=True)
        dx, (dws, dbs) = rrdb_bwd.rdb_bwd_plain(x.detach(), hidden, g, packed)
    for got, ref in zip([dx, *dws, *dbs], want):
        scale = ref.abs().max().item()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 * max(scale, 1.0))


def test_rrdb_bwd_flops_counts_recompute_adjoint_and_weight_grads():
    """94 GFLOP for one RRDB's backward at the train step (8 frames at
    64x64) over the kept activations: the adjoints and the weight grads,
    twice the forward's 47. The first design also recomputed the forward:
    141, three times."""
    assert round(rrdb_bwd.rrdb_bwd_flops(8, 64, 64) / 1e9) == 94
    assert rrdb_bwd.rrdb_bwd_flops(8, 64, 64) == 2 * 3 * trrdb.rdb_flops(8, 64, 64)
    assert round(rrdb_bwd.rrdb_bwd_first_flops(8, 64, 64) / 1e9) == 141
    assert rrdb_bwd.rrdb_bwd_first_flops(8, 64, 64) == 3 * 3 * trrdb.rdb_flops(8, 64, 64)


def test_rrdb_bwd_dispatch_rejects_unknown_device():
    x = torch.zeros(1, 64, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no RRDB backward"):
        rrdb_bwd.rrdb_bwd(x, x, [], [])


# ---------------------------------------------------------------------------
# K3's data flow on the CPU (csrc/conv_bwd_wgmma.cuh), at the kernel's widths.

_NF, _GC = trrdb.KERNEL_NF, trrdb.KERNEL_GC
_DC = _NF + 4 * _GC  # D: dP_1..dP_5 in channels [0, 32), .., [128, 192)
# The wgrad's units (source s, 64-channel block mb of D, first source
# channel), in the kernel's order (unit_info).
_UNITS = ([(0, mb, 32 * half) for mb in range(3) for half in range(2)]
          + [(1, mb, 0) for mb in range(3)] + [(2, mb, 32) for mb in (1, 2)]
          + [(3, mb, 64) for mb in (1, 2)] + [(4, 2, 96)])


def _rdb_convs(rng):
    """One RDB's five (weight OIHW, bias), f32, at the kernel's widths."""
    out = []
    for cin, cout in trrdb._widths(_NF, _GC):
        w = torch.from_numpy((rng.randn(cout, cin, 3, 3) * (1.0 / (9 * cin)) ** 0.5).astype(np.float32))
        out.append((w, torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))))
    return out


def _emulate_wgrad(d, src, mb, ch0, rows=2):
    """One wgrad unit as the kernel addresses it: for each tile of ``rows``
    x 64 pixels, D's 64 channels [64 mb, 64 mb + 64) as 8 planes of 16-byte
    pixels and the source's 32 channels [ch0, ch0 + 32) with a one-pixel
    halo as 4 planes of (rows + 2) x 66 pixels (zeros outside the frame);
    per (row, k16 step, tap) one product of A (64 D channels x 16 pixels)
    and B (16 pixels x 32 source channels), both read MN-major through the
    no-swizzle descriptor: element (mn, k) at start + (k % 8) 16 + (mn % 8)
    2 + (k // 8) LBO + (mn // 8) SBO bytes, LBO = 128 (8 pixels), SBO one
    plane, the tap a shifted start address. Returns (9, 64, 32):
    ``[tap][m][n] = sum_p D[p, 64 mb + m] src[p + tap, ch0 + n]``."""
    n, h, w, _ = d.shape
    runs, groups = -(-w // _RUN), -(-h // rows)
    dplane, splane = rows * _RUN * 16, -(-(rows + 2) * _TW * 16 // 128) * 128
    dpad = torch.zeros(n, groups * rows, runs * _RUN, 64)
    dpad[:, :h, :w] = d[..., 64 * mb: 64 * mb + 64]
    spad = torch.zeros(n, groups * rows + 2, runs * _RUN + 2, 32)
    spad[:, 1: h + 1, 1: w + 1] = src[..., ch0: ch0 + 32]
    mn = torch.arange(64).view(64, 1)
    k = torch.arange(16).view(1, 16)
    a_idx = ((k % 8) * 16 + (mn % 8) * 2 + (k // 8) * 128 + (mn // 8) * dplane) // 2  # (m, k)
    b_idx = (((k % 8) * 16 + (k // 8) * 128).T + (mn[:32].T % 8) * 2 + (mn[:32].T // 8) * splane) // 2  # (k, n)
    acc = torch.zeros(9, 64, 32)
    for f in range(n):
        for y0 in range(0, groups * rows, rows):
            for x0 in range(0, runs * _RUN, _RUN):
                dsm = torch.zeros(8 * dplane // 2)
                for g in range(8):
                    flat = dpad[f, y0: y0 + rows, x0: x0 + _RUN, 8 * g: 8 * g + 8].reshape(-1)
                    dsm[g * dplane // 2: g * dplane // 2 + flat.numel()] = flat
                ssm = torch.zeros(4 * splane // 2)
                for g in range(4):
                    flat = spad[f, y0: y0 + rows + 2, x0: x0 + _TW, 8 * g: 8 * g + 8].reshape(-1)
                    ssm[g * splane // 2: g * splane // 2 + flat.numel()] = flat
                for r in range(rows):
                    for kk in range(_RUN // 16):
                        a = dsm[(r * _RUN + 16 * kk) * 8 + a_idx]
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            acc[tap] += a @ ssm[((r + dy) * _TW + dx + 16 * kk) * 8 + b_idx]
    return acc


def _reduce_index():
    """Where each weight grad of an RDB (conv1..conv5, OIHW, flattened in
    turn) sits in the wgrad's units (reduce_kernel's mapping): a flat index
    into (units, 9, 64, 32)."""
    out = []
    for t, (cin, cout) in enumerate(trrdb._widths(_NF, _GC), start=1):
        o = torch.arange(cout).view(-1, 1, 1)
        c = torch.arange(cin).view(1, -1, 1)
        tap = torch.arange(9).view(1, 1, 9)
        d = 32 * (t - 1) + o  # dP_t's channel in D
        mb = d // 64
        s = torch.where(c < _NF, 0, 1 + (c - _NF) // _GC)
        n = torch.where(c < _NF, c % 32, (c - _NF) % _GC)
        u = torch.where(s == 0, 2 * mb + c // 32, torch.where(s == 1, 6 + mb, torch.where(
            s == 2, 8 + mb, torch.where(s == 3, 10 + mb, 13))))  # unit_of
        assert all(_UNITS[i][:2] == (si, mi) for i, si, mi in
                   zip(u.expand(cout, cin, 9).reshape(-1).tolist(), s.expand(cout, cin, 9).reshape(-1).tolist(),
                       mb.expand(cout, cin, 9).reshape(-1).tolist()))
        out.append((((u * 9 + tap) * 64 + d % 64) * 32 + n).reshape(-1))
    return torch.cat(out)


@pytest.mark.parametrize("unit", [0, 1, 8, 11])
def test_wgrad_mn_major_emulation_matches_conv2d_weight(rng, unit):
    """One weight-grad unit through the kernel's MN-major operand
    addressing (``_emulate_wgrad``: A the dP tile, B the source tile, a tap
    a 16-byte shift of B's start) against ``torch.nn.grad.conv2d_weight``,
    at a ragged shape (2 frames of 3 rows: a tile past the last row; 70
    columns: a second row run 6 pixels wide). Tolerance: f32 sums in two
    orders."""
    s, mb, ch0 = _UNITS[unit]
    d = torch.from_numpy(rng.randn(2, 3, 70, _DC).astype(np.float32))
    src = torch.from_numpy(rng.randn(2, 3, 70, _NF if s == 0 else 4 * _GC).astype(np.float32))
    got = _emulate_wgrad(d, src, mb, ch0)
    dn = d[..., 64 * mb: 64 * mb + 64].permute(0, 3, 1, 2)
    sn = src[..., ch0: ch0 + 32].permute(0, 3, 1, 2)
    want = torch.nn.grad.conv2d_weight(sn, (64, 32, 3, 3), dn, padding=1)  # (m, n, ky, kx)
    torch.testing.assert_close(got, want.permute(2, 3, 0, 1).reshape(9, 64, 32),
                               atol=2e-5 * want.abs().max().item(), rtol=0)


def test_pull_form_emulation_matches_rdb_bwd_plain(rng):
    """An RDB's backward in K3's form, f32: D in suffix order (dP_5 =
    0.2 g_out at [128, 192)); for s = 4 .. 1 the source's cotangent as ONE
    conv of the suffix D[32 s:] with the packed pull matrix, emulated
    through the kernel's descriptor addressing (``_emulate_conv``), masked
    by the sign of x_s into dP_s at D[32 (s - 1):]; then x's cotangent
    from all of D; the weight grads through the 14 MN-major wgrad units
    and the reduce's mapping; the bias grads as sums of dP. Against
    ``rdb_bwd_plain`` at 1 frame of 3 x 70 (ragged). Tolerance: f32 sums
    in other orders."""
    convs = _rdb_convs(rng)
    p = trrdb.pack_rdb(convs, torch.float32)
    x = torch.from_numpy(rng.randn(1, _NF, 3, 70).astype(np.float32))
    g_out = torch.from_numpy(rng.randn(1, _NF, 3, 70).astype(np.float32))
    _, hidden = trrdb.rdb_plain(x, p, keep_hidden=True)
    want_dx, (want_dw, want_db) = rrdb_bwd.rdb_bwd_plain(x, hidden, g_out, p)

    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
    hid = nhwc(torch.cat(hidden, dim=1))
    pulls = trrdb.pack_rdb_pulls([convs], torch.float32)[0]
    offs = np.cumsum([0] + [9 * (_DC - 32 * s) * (_NF if s == 0 else _GC) for s in range(5)])
    d = torch.zeros(1, 3, 70, _DC)
    d[..., 4 * _GC:] = 0.2 * nhwc(g_out)
    for s in range(4, 0, -1):
        z = _emulate_conv(d[..., 32 * s:].contiguous(), pulls[offs[s]: offs[s + 1]], _GC)
        sign = hid[..., 32 * (s - 1): 32 * s]
        d[..., 32 * (s - 1): 32 * s] = torch.where(sign >= 0, z, 0.2 * z)
    dx = nhwc(g_out) + _emulate_conv(d, pulls[offs[0]: offs[1]], _NF)
    scale = want_dx.abs().max().item()
    torch.testing.assert_close(dx, nhwc(want_dx), atol=2e-5 * scale, rtol=0)

    srcs = {0: nhwc(x), 1: hid}
    part = torch.stack([_emulate_wgrad(d, srcs[min(s, 1)], mb, ch0) for s, mb, ch0 in _UNITS])
    flat_dw = part.reshape(-1)[_reduce_index()]
    want_flat = torch.cat([t.reshape(-1) for t in want_dw])
    torch.testing.assert_close(flat_dw, want_flat, atol=2e-5 * want_flat.abs().max().item(), rtol=0)
    db = d.sum(dim=(0, 1, 2))
    torch.testing.assert_close(db, torch.cat(want_db), atol=1e-4 * torch.cat(want_db).abs().max().item(), rtol=0)


def test_pack_rdb_pulls_is_the_pull_matrix_per_rdb(rng):
    """The one-gather packing of many RDBs equals ``wgmma_pull_matrix`` of
    each, whose unpacked kernels are each conv's slice of the source's
    channels, transposed and flipped (the adjoint), stacked as D's
    suffix."""
    convs = [_rdb_convs(rng) for _ in range(2)]
    packed = trrdb.pack_rdb_pulls(convs, torch.float32)
    assert packed.shape == (2, rrdb_bwd.PULL_NUMEL)
    for r, cv in enumerate(convs):
        ws = [w for w, _ in cv]
        assert torch.equal(packed[r], fragments.wgmma_pull_matrix(ws))
        k1 = fragments.wgmma_unpack(packed[r][9 * _DC * _NF: 9 * _DC * _NF + 9 * 160 * _GC], _GC, 160)
        want = torch.cat([ws[t][:, _NF: _NF + _GC].transpose(0, 1).flip(2, 3) for t in range(1, 5)], dim=1)
        assert torch.equal(k1, want)


def test_rrdb_bwd_plain_over_kept_activations_equals_recompute(rng):
    """The backward over the activations the forward keeps (TrunkFunction's
    data flow: each RDB's input and x1..x4 as one (N, 128, H, W) tensor)
    equals the one that recomputes them, bit for bit, at the kernel's
    widths; and its flat grads (K3's output order) unflatten to the same
    grads."""
    rdbs = [trrdb.pack_rdb(_rdb_convs(rng), torch.float32) for _ in range(3)]
    x = torch.from_numpy(rng.randn(1, _NF, 5, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, _NF, 5, 6).astype(np.float32))
    ins, hids, y = [], [], x
    for j, p in enumerate(rdbs):
        ins.append(y)
        y, hidden = trrdb.rdb_plain(y, p, x if j == 2 else None, keep_hidden=True)
        hids.append(torch.cat(hidden, dim=1))
    dx_k, grads_k = rrdb_bwd.rrdb_bwd_plain(x, g, rdbs, (ins, hids))
    dx_r, grads_r = rrdb_bwd.rrdb_bwd_plain(x, g, rdbs)
    assert torch.equal(dx_k, dx_r)
    flat = rrdb_bwd.flat_grads(grads_k)
    assert flat.numel() == 3 * rrdb_bwd.RDB_GRAD_NUMEL
    assert torch.equal(flat, rrdb_bwd.flat_grads(grads_r))
    for (dws, dbs), (dws_u, dbs_u) in zip(grads_r, rrdb_bwd.rdb_grads(flat)):
        assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws_u + dbs_u))
