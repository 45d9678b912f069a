"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. On a machine with a card (and perhaps without JAX, which
``tests/conftest.py`` imports)::

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Tolerance: max|kernel - plain| <= 1e-2 * max|plain| in bf16; both round
operands at the same points and sum in different orders.
"""

import numpy as np
import pytest
import torch

from master_thesis_tpu_torch.ops import rrdb, tail

pytestmark = pytest.mark.gpu
TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv(rng, cin, cout, scale):
    w = torch.from_numpy((rng.randn(cout, cin, 3, 3) * scale).astype(np.float32))
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    return w, b


def _assert_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= TOL * scale, (err, scale)


def _rdb_weights(rng, cuda):
    nf, gc = rrdb.KERNEL_NF, rrdb.KERNEL_GC
    convs = [_conv(rng, nf + k * gc, gc if k < 4 else nf, (1.0 / (9 * (nf + k * gc))) ** 0.5) for k in range(5)]
    return rrdb.pack_rdb([(w.to(cuda), b.to(cuda)) for w, b in convs], torch.bfloat16)


def _activation(rng, cuda, n, h, w):
    """(n, 64, h, w) bf16 on the card, channels-last: the RDB kernels' layout."""
    x = torch.from_numpy(rng.randn(n, rrdb.KERNEL_NF, h, w).astype(np.float32)).to(cuda, torch.bfloat16)
    return x.contiguous(memory_format=torch.channels_last)


# Widths 13, 60, 64, 120 and 128: under, at and over one 64-pixel row run,
# ragged and whole.
@pytest.mark.parametrize("n,h,w,with_res", [
    (2, 8, 16, False), (1, 13, 21, True), (2, 60, 120, True), (1, 9, 13, True), (2, 20, 60, False),
    (3, 64, 64, True), (1, 30, 128, True),
])
def test_rdb_kernel_matches_plain(cuda, n, h, w, with_res):
    rng = np.random.RandomState(0)
    packed = _rdb_weights(rng, cuda)
    x = _activation(rng, cuda, n, h, w)
    res = _activation(rng, cuda, n, h, w) if with_res else None
    before = rrdb.rdb_cuda.launches
    got = rrdb.rdb_cuda(x, packed, res)
    torch.cuda.synchronize()
    assert rrdb.rdb_cuda.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_close(got, rrdb.rdb_plain(x, packed, res))


@pytest.mark.parametrize("n,h,w", [(2, 8, 16), (1, 13, 21), (2, 60, 120)])
def test_rdb_kernel_hidden_matches_plain(cuda, n, h, w):
    """x1..x4 from the kernel's scratch (NHWC, x_k in channels 32 (k - 1)..)
    against ``rdb_plain(keep_hidden=True)``, within TOL."""
    rng = np.random.RandomState(9)
    packed = _rdb_weights(rng, cuda)
    x = _activation(rng, cuda, n, h, w)
    out, hid = rrdb.rdb_cuda(x, packed, keep_hidden=True)
    torch.cuda.synchronize()
    assert hid.shape == (n, h, w, 4 * rrdb.KERNEL_GC)
    want, want_h = rrdb.rdb_plain(x, packed, keep_hidden=True)
    _assert_close(out, want)
    for k in range(4):
        _assert_close(hid[..., 32 * k: 32 * k + 32].permute(0, 3, 1, 2), want_h[k])


def test_rdb_wrappers_refuse_nchw(cuda):
    """The RDB kernels take channels-last only: a contiguous NCHW bf16
    activation (x or res) is refused, not misread."""
    packed = _rdb_weights(np.random.RandomState(10), cuda)
    x = torch.zeros(1, rrdb.KERNEL_NF, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        rrdb.rdb_cuda(x, packed)
    with pytest.raises(ValueError, match="channels-last"):
        rrdb.rdb_banded_cuda(x, packed)
    with pytest.raises(ValueError, match="channels-last"):
        rrdb.rdb_cuda(x.contiguous(memory_format=torch.channels_last), packed, x)


# Relative L2 limit of the tail forward (K4, K5) against its plain version:
# both round h1..h3 to bf16; sums in another order flip some roundings
# (chip_smoke.py's L2_TAIL).
TAIL_L2 = 5e-3


def _tail_inputs(rng, cuda, n, h, w):
    """Packed tail weights and a channels-last (n, 64, h, w) bf16 input."""
    nf = tail.KERNEL_NF
    convs = [_conv(rng, nf, nf, 0.05) for _ in range(3)] + [_conv(rng, nf, 3, 0.05)]
    p = {k: v.to(cuda) for k, v in tail.pack_tail(*convs, torch.bfloat16).items()}
    return p, _activation(rng, cuda, n, h, w)


# Widths 7 to 120: h2 and h3 from 28 to 480 pixels wide, under and over a
# 64-pixel row run, ragged and whole.
@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (1, 6, 10), (2, 13, 7), (2, 60, 120)])
def test_tail_kernels_match_plain(cuda, n, h, w):
    """K4 (four wgmma launches, channels-last in and out) against the
    plain tail by relative L2 (and within TOL)."""
    rng = np.random.RandomState(1)
    p, x = _tail_inputs(rng, cuda, n, h, w)
    before = tail.tail_cuda.launches
    got = tail.tail_cuda(x, p)
    torch.cuda.synchronize()
    assert tail.tail_cuda.launches == before + tail.TAIL_KERNELS
    assert got.shape == (n, 3, 4 * h, 4 * w) and got.is_contiguous(memory_format=torch.channels_last)
    want = tail.tail_plain(x, p)
    _assert_close(got, want)
    assert _rel_l2(got, want) <= TAIL_L2


@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (2, 13, 7)])
def test_tail_first_design_matches_plain(cuda, n, h, w):
    """The first K4 design (``tail_first_cuda``: NCHW, three launches), kept
    to time the new one against, against the plain tail."""
    rng = np.random.RandomState(1)
    p, x = _tail_inputs(rng, cuda, n, h, w)
    got = tail.tail_first_cuda(x.contiguous(), p)
    torch.cuda.synchronize()
    assert got.shape == (n, 3, 4 * h, 4 * w)
    _assert_close(got, tail.tail_plain(x, p))


def test_tail_function_forward_runs_the_kernel(cuda):
    """``TailFunction``'s forward takes the NCHW tail input of the train
    step, runs K4 on a channels-last copy and equals ``tail_cuda`` on it bit
    for bit."""
    from master_thesis_tpu_torch.ops import tail_bwd

    rng = np.random.RandomState(11)
    nf = tail.KERNEL_NF
    convs = [_conv(rng, nf, nf, 0.05) for _ in range(3)] + [_conv(rng, nf, 3, 0.05)]
    params = [t.to(cuda) for wb in convs for t in wb]
    x = _activation(rng, cuda, 2, 8, 12)
    before = tail.tail_cuda.launches
    with torch.no_grad():
        got = tail_bwd.TailFunction.apply(x.contiguous(), torch.bfloat16, *params)
    torch.cuda.synchronize()
    assert tail.tail_cuda.launches == before + tail.TAIL_KERNELS
    p = tail.pack_tail(*[tuple(params[i: i + 2]) for i in range(0, 8, 2)], torch.bfloat16)
    assert torch.equal(got, tail.tail_cuda(x, p))
    assert _rel_l2(got, tail.tail_plain(x, p)) <= TAIL_L2


@pytest.mark.parametrize("n,h,w,band_rows", [(2, 20, 16, 8), (1, 13, 21, 5), (2, 60, 120, 32)])
def test_rdb_banded_kernel_matches_plain_and_full_frame(cuda, n, h, w, band_rows):
    """K2: one call (five conv launches) per band; equal to K1 bit for bit
    (each output pixel sums the same products in the same order), and to
    the plain band decomposition within TOL."""
    rng = np.random.RandomState(7)
    packed = _rdb_weights(rng, cuda)
    x = _activation(rng, cuda, n, h, w)
    res = _activation(rng, cuda, n, h, w)
    before = rrdb.rdb_banded_cuda.launches
    got = rrdb.rdb_banded_cuda(x, packed, res, band_rows)
    torch.cuda.synchronize()
    assert rrdb.rdb_banded_cuda.launches == before + len(rrdb.bands(h, band_rows))
    assert torch.equal(got, rrdb.rdb_cuda(x, packed, res))
    _assert_close(got, rrdb.rdb_banded_plain(x, packed, res, band_rows))


@pytest.mark.parametrize("n,h,w,band_rows", [(2, 20, 8, 8), (1, 13, 7, 4), (2, 60, 120, 32)])
def test_tail_banded_kernels_match_plain_and_full_frame(cuda, n, h, w, band_rows):
    """K5: one call of four launches per band; equal to K4 bit for bit
    (each output pixel sums the same products in the same order, and a
    band's halo covers the four stages' reach), and to the plain band
    decomposition within TOL and by relative L2."""
    rng = np.random.RandomState(8)
    p, x = _tail_inputs(rng, cuda, n, h, w)
    before = tail.tail_banded_cuda.launches
    got = tail.tail_banded_cuda(x, p, band_rows)
    torch.cuda.synchronize()
    assert tail.tail_banded_cuda.launches == before + tail.TAIL_KERNELS * len(rrdb.bands(h, band_rows))
    assert got.shape == (n, 3, 4 * h, 4 * w) and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, tail.tail_cuda(x, p))
    want = tail.tail_banded_plain(x, p, band_rows)
    _assert_close(got, want)
    assert _rel_l2(got, want) <= TAIL_L2


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 8, 8, device=cuda)  # f32: the kernels take bf16
    with pytest.raises(ValueError, match="bfloat16"):
        rrdb.rdb_cuda(x, rrdb.PackedRDB(torch.zeros(1, device=cuda), torch.zeros(1, device=cuda), ()))
    with pytest.raises(ValueError, match="bfloat16"):
        tail.tail_cuda(x, {})
    with pytest.raises(ValueError, match="bfloat16"):
        rrdb.rdb_banded_cuda(x, rrdb.PackedRDB(torch.zeros(1, device=cuda), torch.zeros(1, device=cuda), ()))
    with pytest.raises(ValueError, match="bfloat16"):
        tail.tail_banded_cuda(x, {})


def test_tail_wrappers_refuse_nchw_and_unpacked_weights(cuda):
    """K4 / K5 take channels-last only (a contiguous NCHW bf16 input is
    refused, not misread) and the wgmma operands of ``pack_tail``; the
    first design takes NCHW only."""
    p, x = _tail_inputs(np.random.RandomState(12), cuda, 1, 8, 8)
    for fn in (tail.tail_cuda, tail.tail_banded_cuda):
        with pytest.raises(ValueError, match="channels-last"):
            fn(x.contiguous(), p)
        with pytest.raises(ValueError, match="packed"):
            fn(x, {k: v for k, v in p.items() if k != "hr_wg"})
        with pytest.raises(ValueError, match="packed"):
            fn(x, dict(p, up2_wg=p["up2_wg"].float()))
    with pytest.raises(ValueError, match="contiguous NCHW"):
        tail.tail_first_cuda(x, p)


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).norm() / want.norm()).item()


# Relative L2 limits of a backward kernel's dx and of each weight or bias
# grad against the plain version: both round every cotangent to bf16 before
# a product, and a sum taken in another order flips some of those roundings,
# which spread through an RDB's dense convs (K3 reads up to ~0.02 at these
# shapes, as the plain version on the CPU against the card does; a mask
# with the wrong lrelu slope reads 0.07). chip_smoke.py uses the same.
K3_L2, K6_L2 = 5e-2, 1e-2


def _rrdb_bwd_inputs(rng, cuda, n, h, w):
    """Three RDBs' weights (packed, pull matrices), channels-last x and g,
    and the activations K1 keeps for the backward."""
    from master_thesis_tpu_torch.ops import rrdb_bwd

    nf, gc = rrdb.KERNEL_NF, rrdb.KERNEL_GC
    convs = [
        [tuple(t.to(cuda) for t in _conv(rng, nf + k * gc, gc if k < 4 else nf, (1.0 / (9 * (nf + k * gc))) ** 0.5))
         for k in range(5)]
        for _ in range(3)
    ]
    rdbs = [rrdb.pack_rdb(c, torch.bfloat16) for c in convs]
    pulls = rrdb.pack_rdb_pulls(convs, torch.bfloat16)
    x, g = _activation(rng, cuda, n, h, w), _activation(rng, cuda, n, h, w)
    _, kept = rrdb_bwd.rrdb_forward_kept(x, rdbs)
    return rdbs, pulls, x, g, kept


@pytest.mark.parametrize("n,h,w", [(2, 8, 16), (1, 13, 21), (2, 60, 120)])
def test_rrdb_bwd_kernel_matches_plain(cuda, n, h, w):
    """K3 (one call an RRDB) over K1's kept activations against the plain
    version over the same ones: dx and every conv's dW and db."""
    from master_thesis_tpu_torch.ops import rrdb_bwd

    rdbs, pulls, x, g, kept = _rrdb_bwd_inputs(np.random.RandomState(2), cuda, n, h, w)
    before = rrdb_bwd.rrdb_bwd_cuda.launches
    dx, flat = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept)
    torch.cuda.synchronize()
    assert rrdb_bwd.rrdb_bwd_cuda.launches == before + 1
    assert dx.is_contiguous(memory_format=torch.channels_last)
    dx_p, grads_p = rrdb_bwd.rrdb_bwd_plain(x, g, rdbs, kept)
    assert _rel_l2(dx, dx_p) <= K3_L2
    for (dws, dbs), (dws_p, dbs_p) in zip(rrdb_bwd.rdb_grads(flat), grads_p):
        for a, b in zip(dws + dbs, dws_p + dbs_p):
            assert a.shape == b.shape and _rel_l2(a, b) <= K3_L2
    dx2, flat2 = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept)
    assert torch.equal(dx, dx2) and torch.equal(flat, flat2)  # no float atomics


def test_rrdb_bwd_kernel_reruns_bit_identical(cuda):
    """Two K3 runs at the train step's shape (8 frames at 64x64) give the
    same dx, dW and db bit for bit: the K-split and bias partial sums are
    reduced in a fixed order, with no float atomics."""
    from master_thesis_tpu_torch.ops import rrdb_bwd

    _, pulls, x, g, kept = _rrdb_bwd_inputs(np.random.RandomState(7), cuda, 8, 64, 64)
    dx, flat = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept)
    dx2, flat2 = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept)
    torch.cuda.synchronize()
    assert torch.isfinite(flat).all() and torch.isfinite(dx.float()).all()
    assert torch.equal(dx, dx2)
    for (dws, dbs), (dws2, dbs2) in zip(rrdb_bwd.rdb_grads(flat), rrdb_bwd.rdb_grads(flat2)):
        assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


def test_rrdb_bwd_wrapper_refuses_nchw(cuda):
    from master_thesis_tpu_torch.ops import rrdb_bwd

    _, pulls, x, g, kept = _rrdb_bwd_inputs(np.random.RandomState(8), cuda, 1, 8, 8)
    with pytest.raises(ValueError, match="channels-last"):
        rrdb_bwd.rrdb_bwd_cuda(x.contiguous(), g, pulls, kept)


def _tail_bwd_inputs(rng, cuda, n, h, w):
    """Tail weights packed in bf16, and channels-last bf16 ``x`` (n, 64, h,
    w) and ``g`` (n, 3, 4h, 4w) on the card."""
    nf = tail.KERNEL_NF
    convs = [tuple(t.to(cuda) for t in _conv(rng, nf, nf, 0.05)) for _ in range(3)]
    convs.append(tuple(t.to(cuda) for t in _conv(rng, nf, 3, 0.05)))
    p = tail.pack_tail(*convs, torch.bfloat16)
    x = _activation(rng, cuda, n, h, w)
    g = torch.from_numpy(rng.randn(n, 3, 4 * h, 4 * w).astype(np.float32)).to(cuda, torch.bfloat16)
    return convs, p, x, g.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (1, 6, 10), (2, 13, 7)])
def test_tail_bwd_kernel_matches_plain(cuda, n, h, w):
    """K6 (one ``tail_backward`` call) on channels-last tensors: dx comes back
    channels-last, and it and every grad are within ``K6_L2`` of the plain
    version. 13 x 7 is odd: ragged tiles at every stage."""
    from master_thesis_tpu_torch.ops import tail_bwd

    _, p, x, g = _tail_bwd_inputs(np.random.RandomState(3), cuda, n, h, w)
    before = tail_bwd.tail_bwd_cuda.launches
    dx, grads = tail_bwd.tail_bwd_cuda(x, g, p, tail_bwd.pack_tail_bwd(p))
    torch.cuda.synchronize()
    assert tail_bwd.tail_bwd_cuda.launches == before + tail_bwd.TAIL_BWD_KERNELS
    assert dx.is_contiguous(memory_format=torch.channels_last)
    dx_p, grads_p = tail_bwd.tail_bwd_plain(x, g, p)
    assert dx.shape == x.shape and _rel_l2(dx, dx_p) <= K6_L2
    for k in tail_bwd.PARAM_NAMES:
        assert grads[k].shape == grads_p[k].shape and _rel_l2(grads[k], grads_p[k]) <= K6_L2, k


def test_tail_bwd_kernel_reruns_bit_identical(cuda):
    """Two K6 runs at the train step's shape (8 frames at 64x64) give the
    same dx, dW and db bit for bit: every partial sum has its own slot and
    the reduce adds them in a fixed order, with no float atomics."""
    from master_thesis_tpu_torch.ops import tail_bwd

    _, p, x, g = _tail_bwd_inputs(np.random.RandomState(9), cuda, 8, 64, 64)
    adj = tail_bwd.pack_tail_bwd(p)
    dx, grads = tail_bwd.tail_bwd_cuda(x, g, p, adj)
    dx2, grads2 = tail_bwd.tail_bwd_cuda(x, g, p, adj)
    torch.cuda.synchronize()
    assert torch.isfinite(dx.float()).all()
    assert torch.equal(dx, dx2) and all(torch.equal(grads[k], grads2[k]) for k in grads)


def test_tail_bwd_wrapper_refuses_nchw(cuda):
    from master_thesis_tpu_torch.ops import tail_bwd

    _, p, x, g = _tail_bwd_inputs(np.random.RandomState(8), cuda, 1, 8, 8)
    adj = tail_bwd.pack_tail_bwd(p)
    with pytest.raises(ValueError, match="channels-last"):
        tail_bwd.tail_bwd_cuda(x.contiguous(), g, p, adj)
    with pytest.raises(ValueError, match="channels-last"):
        tail_bwd.tail_bwd_cuda(x, g.contiguous(), p, adj)


def test_tail_bwd_first_design_matches_plain(cuda):
    """The first K6 design (17 mma.sync launches, NCHW), kept to time the
    new one against, against the plain version."""
    from master_thesis_tpu_torch.ops import tail_bwd

    convs, p, x, g = _tail_bwd_inputs(np.random.RandomState(4), cuda, 2, 8, 8)
    x, g = x.contiguous(), g.contiguous()
    before = tail_bwd.tail_bwd_first_cuda.launches
    dx, grads = tail_bwd.tail_bwd_first_cuda(x, g, p, tail_bwd.pack_tail_adjoint(convs, torch.bfloat16))
    torch.cuda.synchronize()
    assert tail_bwd.tail_bwd_first_cuda.launches == before + 17
    dx_p, grads_p = tail_bwd.tail_bwd_plain(x, g, p)
    assert _rel_l2(dx, dx_p) <= K6_L2
    for k in tail_bwd.PARAM_NAMES:
        assert _rel_l2(grads[k], grads_p[k]) <= K6_L2, k


@pytest.mark.parametrize("loss", ["sum", "nchw_weights"])
def test_tail_function_backward_takes_any_cotangent(cuda, loss):
    """``TailFunction``'s backward on the card takes a cotangent of any
    layout: an expanded one (``.sum()``) or an NCHW one (a product with NCHW
    weights). It runs K6 and matches the plain backward on the same
    values."""
    from master_thesis_tpu_torch.ops import tail_bwd

    rng = np.random.RandomState(12)
    convs, p, x, _ = _tail_bwd_inputs(rng, cuda, 2, 8, 12)
    params = [t.clone().requires_grad_() for wb in convs for t in wb]
    x = x.detach().requires_grad_()
    out = tail_bwd.TailFunction.apply(x, torch.bfloat16, *params)
    before = tail_bwd.tail_bwd_cuda.launches
    if loss == "sum":
        g = torch.ones_like(out)
        out.sum().backward()
    else:
        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(cuda, torch.bfloat16)
        assert g.is_contiguous() and not g.is_contiguous(memory_format=torch.channels_last)
        (out * g).sum().backward()
    torch.cuda.synchronize()
    assert tail_bwd.tail_bwd_cuda.launches == before + tail_bwd.TAIL_BWD_KERNELS
    dx_p, grads_p = tail_bwd.tail_bwd_plain(x.detach(), g.contiguous(memory_format=torch.channels_last), p)
    assert x.grad.is_contiguous(memory_format=torch.channels_last)
    assert _rel_l2(x.grad, dx_p) <= K6_L2
    for k, q in zip(tail_bwd.PARAM_NAMES, params):
        assert _rel_l2(q.grad, grads_p[k]) <= K6_L2, k


def test_train_forward_keeps_the_tail_channels_last(cuda, monkeypatch):
    """The CHN training forward and backward on the card (nb=2, bf16, the
    output read as the train step reads it, through its NHWC view) hand
    the tail its input, and K6 its cotangent, channels-last, and take dx
    back channels-last: no NCHW <-> NHWC copy of x, g or dx around K4 and
    K6."""
    from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply
    from master_thesis_tpu_torch.ops import tail_bwd

    seen = {}
    fwd, bwd = tail_bwd.TailFunction.forward, tail_bwd.TailFunction.backward

    def forward(ctx, x, dtype, *params):
        seen["x"] = x.is_contiguous(memory_format=torch.channels_last)
        return fwd(ctx, x, dtype, *params)

    def backward(ctx, g):
        seen["g"] = g.is_contiguous(memory_format=torch.channels_last)
        grads = bwd(ctx, g)
        seen["dx"] = grads[0].is_contiguous(memory_format=torch.channels_last)
        return grads

    monkeypatch.setattr(tail_bwd.TailFunction, "forward", staticmethod(forward))
    monkeypatch.setattr(tail_bwd.TailFunction, "backward", staticmethod(backward))
    chn = CHN(nb=2, dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator().manual_seed(5)
    b, f, hw = 2, 2, 32
    rnd = lambda *shape: torch.rand(*shape, generator=gen).to(cuda)
    before = tail_bwd.tail_bwd_cuda.launches
    y_hat, _ = chn_infer_apply(chn, rnd(b, hw, hw, 3), rnd(b, hw, hw, 1), rnd(b, f, hw, hw, 3),
                               rnd(b, f, hw, hw, 1), rnd(b, f, hw, hw, 1))
    y_hat.mean().backward()
    torch.cuda.synchronize()
    assert tail_bwd.tail_bwd_cuda.launches == before + tail_bwd.TAIL_BWD_KERNELS
    assert seen == {"x": True, "g": True, "dx": True}
    assert all(torch.isfinite(q.grad).all() for q in chn.parameters())


# Relative L2 limit of the conv-stack kernels (K7, K8) against their plain
# versions: both round every conv's output to bf16, and sums in another
# order flip some of those roundings (chip_smoke.py uses the same limit).
STACK_L2 = 1e-2


def _stack(rng, spec, cin, cuda):
    """A packed stack of ``spec`` = [(k, cout, relu), ...] from ``cin``."""
    from master_thesis_tpu_torch.ops import conv_stack

    convs, relus = [], []
    for k, cout, relu in spec:
        w = rng.randn(cout, cin, k, k).astype(np.float32) * (1.0 / (k * k * cin)) ** 0.5
        b = rng.randn(cout).astype(np.float32) * 0.1
        convs.append((torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda)))
        relus.append(relu)
        cin = cout
    return conv_stack.pack_stack(convs, relus, torch.bfloat16)


@pytest.mark.parametrize("nt,side,cin,spec", [
    (6, 16, 1, [(3, 128, True), (5, 16, True), (3, 2, False)]),  # Cin 1, Cout 2
    (7, 16, 16, [(5, 8, True), (3, 4, True), (3, 1, False)]),  # Cout 1, a ragged tile count
    (3, 4, 16, [(5, 16, True), (3, 8, True), (3, 2, False)]),  # 4x4 tiles
    (2, 16, 256, [(5, 256, True), (3, 16, True), (5, 2, False)]),  # the mixer's widths, split N
])
def test_conv_stack_tiles_kernel_matches_plain(cuda, nt, side, cin, spec):
    from master_thesis_tpu_torch.ops import conv_stack

    rng = np.random.RandomState(4)
    p = _stack(rng, spec, cin, cuda)
    x = torch.from_numpy(rng.randn(nt, cin, side * side).astype(np.float32)).to(cuda, torch.bfloat16)
    before = conv_stack.conv_stack_tiles_cuda.launches
    got = conv_stack.conv_stack_tiles_cuda(x, p, side)
    torch.cuda.synchronize()
    assert conv_stack.conv_stack_tiles_cuda.launches == before + len(conv_stack.plan_tiles(p, side))
    want = conv_stack.conv_stack_tiles_plain(x, p, side)
    assert got.shape == want.shape and _rel_l2(got, want) <= STACK_L2


@pytest.mark.parametrize("n,h,w,cin,spec", [
    (2, 32, 48, 10, [(5, 128, True), (3, 128, True)]),  # flow c0-c1
    (1, 40, 24, 128, [(5, 128, True), (3, 128, True), (3, 2, False)]),  # c15-c17, halo 4
    (2, 60, 120, 3, [(3, 64, True), (3, 64, True)]),  # VGG block 1, a ragged frame
    (1, 5, 7, 16, [(5, 16, True), (3, 1, False)]),  # a frame smaller than a tile
])
def test_conv_stack_banded_kernel_matches_plain(cuda, n, h, w, cin, spec):
    from master_thesis_tpu_torch.ops import conv_stack

    rng = np.random.RandomState(5)
    p = _stack(rng, spec, cin, cuda)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(cuda, torch.bfloat16)
    before = conv_stack.conv_stack_banded_cuda.launches
    got = conv_stack.conv_stack_banded_cuda(x, p)
    torch.cuda.synchronize()
    assert conv_stack.conv_stack_banded_cuda.launches == before + len(conv_stack.plan_banded(p, h, w))
    want = conv_stack.conv_stack_banded_plain(x, p)
    assert got.shape == want.shape and _rel_l2(got, want) <= STACK_L2


def test_conv_stack_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from master_thesis_tpu_torch.ops import conv_stack

    p = _stack(np.random.RandomState(6), [(3, 16, True)], 8, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_stack.conv_stack_banded_cuda(torch.zeros(1, 8, 8, 8, device=cuda), p)
    with pytest.raises(ValueError, match="channels"):
        conv_stack.conv_stack_tiles_cuda(torch.zeros(1, 4, 64, device=cuda, dtype=torch.bfloat16), p, 8)


@pytest.mark.parametrize("nt,cin,cout,relu", [
    (5120, 128, 256, True),  # sep4d's widths at the CHN+DFPN step's tile count
    (640, 256, 256, False),
    (7, 256, 128, True),  # a ragged tile count
    (3, 64, 192, True),  # outputs padded to 256 in the packing
])
def test_conv3x3_wide_kernel_matches_plain(cuda, nt, cin, cout, relu):
    """K7's wide-conv kernel (csrc/conv_stack_wgmma.cu), one launch, against
    the plain conv on channels-last 16x16 tiles."""
    from master_thesis_tpu_torch.ops import conv_stack

    rng = np.random.RandomState(7)
    p = _stack(rng, [(3, cout, relu)], cin, cuda)
    x = torch.from_numpy(rng.randn(nt, cin, 16, 16).astype(np.float32)).to(cuda, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    before = conv_stack.conv3x3_wide_cuda.launches
    got = conv_stack.conv3x3_wide_cuda(x, p, 0)
    torch.cuda.synchronize()
    assert conv_stack.conv3x3_wide_cuda.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = conv_stack.conv_stack_plain(x, p)
    assert got.shape == want.shape and _rel_l2(got, want) <= STACK_L2


@pytest.mark.parametrize("swap", [False, True])
def test_conv_stack_tiles_cl_kernel_matches_plain(cuda, swap):
    """sep4d's stage-1 and stage-2 stacks through the channels-last entry
    (fused 1 -> 128, wide, wide; wide, wide, fused 128 -> 1) on 512 tiles,
    stage 1 with and without the p <-> q swap."""
    from master_thesis_tpu_torch.ops import conv_stack

    rng = np.random.RandomState(8)
    p1 = _stack(rng, [(3, 128, True), (3, 256, True), (3, 256, False)], 1, cuda)
    p2 = _stack(rng, [(3, 256, True), (3, 128, True), (3, 1, False)], 256, cuda)
    x = torch.from_numpy(rng.randn(512, 1, 16, 16).astype(np.float32)).to(cuda, torch.bfloat16)
    wide0, launches0 = conv_stack.conv3x3_wide_cuda.launches, conv_stack.conv_stack_tiles_cuda.launches
    y = conv_stack.conv_stack_tiles_cl_cuda(x, p1, swap=swap)
    z = conv_stack.conv_stack_tiles_cl_cuda(y, p2)
    torch.cuda.synchronize()
    assert conv_stack.conv3x3_wide_cuda.launches == wide0 + 4
    assert conv_stack.conv_stack_tiles_cuda.launches == launches0 + 6
    want_y = conv_stack.conv_stack_tiles_cl_plain(x, p1, swap)
    assert y.shape == want_y.shape and _rel_l2(y, want_y) <= STACK_L2
    want_z = conv_stack.conv_stack_tiles_cl_plain(want_y, p2)
    assert z.shape == want_z.shape and _rel_l2(z, want_z) <= STACK_L2


def test_wide_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """Channel-major (NCHW strides) or non-bf16 tiles, and a conv that is not
    wide (a thin one, or a 5x5 with its packed operand, as the mixer's first
    conv), raise: nothing falls back."""
    from master_thesis_tpu_torch.ops import conv_stack

    p = _stack(np.random.RandomState(9), [(3, 64, True), (3, 8, False)], 64, cuda)
    nchw = torch.zeros(2, 64, 16, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        conv_stack.conv_stack_tiles_cl_cuda(nchw, p)
    with pytest.raises(ValueError, match="channels-last"):
        conv_stack.conv3x3_wide_cuda(nchw, p, 0)
    cl = nchw.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_stack.conv3x3_wide_cuda(cl.float(), p, 0)
    with pytest.raises(ValueError, match="not a wide conv"):
        conv_stack.conv3x3_wide_cuda(cl, p, 1)
    p5 = _stack(np.random.RandomState(9), [(5, 64, True)], 64, cuda)
    assert p5.wide[0] is not None
    with pytest.raises(ValueError, match="not a wide conv"):
        conv_stack.conv3x3_wide_cuda(cl, p5, 0)


# The frame kernel's widths and sizes (K8's routed convs): W 256 / 64 / 32 /
# 16 / 8, 3x3 and 5x5, Cout 64 (64 outputs a CTA), 128 and 512, and a
# ragged frame.
@pytest.mark.parametrize("n,h,w,cin,cout,k,relu", [
    (2, 256, 256, 128, 128, 5, True),  # flow_256's c15
    (3, 64, 64, 128, 128, 3, True),
    (4, 32, 32, 256, 512, 3, True),  # VGG block 4
    (3, 16, 16, 128, 128, 5, True),  # flow_64 at 16x16: two row tiles of 8
    (5, 8, 8, 128, 128, 3, False),  # three whole frames a tile, a ragged last group
    (3, 8, 8, 128, 128, 5, True),  # two whole frames a tile
    (2, 60, 120, 64, 64, 3, True),  # a ragged frame, 64 outputs a CTA
    (1, 20, 72, 64, 128, 5, False),  # a second column tile of 8
])
def test_conv_frame_kernel_matches_plain(cuda, n, h, w, cin, cout, k, relu):
    """K8's frame kernel (csrc/conv_stack_wgmma.cu), one launch, against the
    plain conv on NHWC frames."""
    from master_thesis_tpu_torch.ops import conv_stack

    rng = np.random.RandomState(10)
    p = _stack(rng, [(k, cout, relu)], cin, cuda)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(cuda, torch.bfloat16)
    before = conv_stack.conv_frame_cuda.launches
    got = conv_stack.conv_frame_cuda(x, p, 0)
    torch.cuda.synchronize()
    assert conv_stack.conv_frame_cuda.launches == before + 1
    want = conv_stack.conv_stack_banded_plain(x, p)
    assert got.shape == want.shape and _rel_l2(got, want) <= STACK_L2


def test_conv_stack_banded_launches_the_frame_kernel(cuda):
    """flow_256's last segment through ``conv_stack_banded_cuda``: c15 and
    c16 on the frame kernel, c17 (Cout 2) on the fused kernel, NHWC between
    the three launches; the first design (fused groups alone) agrees."""
    from master_thesis_tpu_torch.ops import conv_stack

    rng = np.random.RandomState(11)
    p = _stack(rng, [(5, 128, True), (3, 128, True), (3, 2, False)], 128, cuda)
    x = torch.from_numpy(rng.randn(2, 64, 96, 128).astype(np.float32)).to(cuda, torch.bfloat16)
    frame0, launches0 = conv_stack.conv_frame_cuda.launches, conv_stack.conv_stack_banded_cuda.launches
    got = conv_stack.conv_stack_banded_cuda(x, p)
    torch.cuda.synchronize()
    assert conv_stack.conv_frame_cuda.launches == frame0 + 2
    assert conv_stack.conv_stack_banded_cuda.launches == launches0 + 3
    want = conv_stack.conv_stack_banded_plain(x, p)
    assert got.shape == want.shape and _rel_l2(got, want) <= STACK_L2
    first = conv_stack.conv_stack_banded_first_cuda(x, p)
    assert first.shape == want.shape and _rel_l2(first, want) <= STACK_L2


def test_frame_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """NCHW strides (an NCHW tensor's NHWC view), non-bf16 frames, a conv
    without its packed operand and a stack packed in f32 raise: nothing
    falls back."""
    from master_thesis_tpu_torch.ops import conv_stack

    p = _stack(np.random.RandomState(12), [(3, 64, True), (3, 8, False)], 64, cuda)
    nhwc = torch.zeros(2, 16, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        conv_stack.conv_frame_cuda(nhwc.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), p, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_stack.conv_frame_cuda(nhwc.float(), p, 0)
    with pytest.raises(ValueError, match="not a frame conv"):
        conv_stack.conv_frame_cuda(nhwc, p, 1)
    w = torch.zeros(64, 64, 3, 3, device=cuda)
    p32 = conv_stack.pack_stack([(w, torch.zeros(64, device=cuda))], [True], torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_stack.conv_frame_cuda(nhwc, p32, 0)


def _flow_inputs(rng, cuda, b, f, size):
    """Frames, 20%-hole masks and a small prior flow, f32 on the card."""
    arrays = (rng.rand(b, size, size, 3), rng.rand(b, size, size, 1) > 0.8, rng.rand(b, f, size, size, 3),
              rng.rand(b, f, size, size, 1) > 0.8, rng.randn(b, f, size, size, 2) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in arrays]


# Relative L2 limit of a whole flow estimator (21 convs in bf16) through K8
# against the same schedule through K8's plain version: chip_smoke.py's
# L2_DFPN.
ESTIMATOR_L2 = 5e-2


def test_hybrid_flow_estimator_launches_k8_and_matches_plain(cuda, monkeypatch):
    """The default hybrid estimator (bf16) at 1 x 2 x 128²: c0 (one launch
    of the fused kernel) and c6-c7, c11-c12 at 32² (two frame launches each)
    on K8, c9-c10 at 16² through the modules; held against the same
    schedule with K8's plain version."""
    from master_thesis_tpu_torch.models.dfpn import FlowEstimator, flow_estimator_apply_hybrid
    from master_thesis_tpu_torch.ops import conv_stack

    est = FlowEstimator(generator=torch.Generator().manual_seed(3), dtype=torch.bfloat16).to(cuda)
    ins = _flow_inputs(np.random.RandomState(13), cuda, 1, 2, 128)
    launches0, frame0 = conv_stack.conv_stack_banded_cuda.launches, conv_stack.conv_frame_cuda.launches
    with torch.no_grad():
        got = flow_estimator_apply_hybrid(est, *ins)
    torch.cuda.synchronize()
    assert conv_stack.conv_stack_banded_cuda.launches - launches0 == 5
    assert conv_stack.conv_frame_cuda.launches - frame0 == 4
    monkeypatch.setattr(conv_stack, "conv_stack_banded_cuda", conv_stack.conv_stack_banded_plain)
    with torch.no_grad():
        want = flow_estimator_apply_hybrid(est, *ins)
    assert got.shape == want.shape == (1, 2, 128, 128, 2)
    assert _rel_l2(got, want) <= ESTIMATOR_L2


def test_hybrid_route_refused_on_a_grad_path_on_the_card(cuda):
    """``dfpn_infer_apply(hybrid_flow=True)`` raises under grad mode with
    trainable parameters before any K8 launch; under ``torch.no_grad()`` it
    runs its K8 launch (flow_256's c0 at 64²)."""
    from master_thesis_tpu_torch.models.dfpn import DFPN, dfpn_infer_apply
    from master_thesis_tpu_torch.ops import conv_stack

    net = DFPN(base_size=64, dtype=torch.bfloat16, device=cuda, generator=torch.Generator().manual_seed(4))
    rng = np.random.RandomState(14)
    x_t, m_t, x_r, m_r, _ = _flow_inputs(rng, cuda, 1, 1, 64)
    feats = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(cuda) for s in ((1, 4, 4, 512), (1, 1, 4, 4, 512))]
    run = lambda: dfpn_infer_apply(net, x_t, m_t, x_r, m_r, *feats, pallas_mixer=False, hybrid_flow=True)
    before = conv_stack.conv_stack_banded_cuda.launches
    with pytest.raises(ValueError, match="hybrid_flow=True.*no backward"):
        run()
    assert conv_stack.conv_stack_banded_cuda.launches == before
    with torch.no_grad():
        out = run()
    torch.cuda.synchronize()
    assert conv_stack.conv_stack_banded_cuda.launches == before + 1
    assert all(torch.isfinite(o).all() for o in out)


def test_dfpn_train_step_on_the_card_matches_the_cpu(cuda):
    """The DFPN train step (``dfpn_task.forward_and_loss`` and its backward)
    at 1 x (1 + 1) x 64², base 64, f32 with TF32 off, on the card against
    the same weights and batch on the CPU: each loss item within 1e-4
    relative, each parameter's grad within 5e-3 relative L2 (cuDNN's and
    the CPU's sums in other orders, as the CPU parity against JAX reads in
    tests/test_torch_dfpn_train.py)."""
    from master_thesis_tpu_torch.models.dfpn import DFPN
    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.ops.flows import identity_grid
    from master_thesis_tpu_torch.train import dfpn_task

    rng = np.random.RandomState(0)
    y = rng.rand(1, 2, 64, 64, 3).astype(np.float32)
    m = (rng.rand(1, 2, 64, 64, 1) > 0.8).astype(np.float32)
    flow = (identity_grid(64, 64).numpy() * 1.05 + rng.uniform(-0.2, 0.2, (1, 2, 1, 1, 2))).astype(np.float32)
    batch = ((1 - m) * y, m, y, flow, np.asarray([True]))

    def run(device):
        net = DFPN(base_size=64, device=device, generator=torch.Generator().manual_seed(26))
        vgg = VGGFeatures(device=device, generator=torch.Generator().manual_seed(2))
        vgg.requires_grad_(False)
        total, items = dfpn_task.forward_and_loss(net, vgg, *(torch.from_numpy(a).to(device) for a in batch))
        total.backward()
        return ({k: v.item() for k, v in items.items()},
                {k: p.grad.cpu() for k, p in net.named_parameters()})

    got_items, got = run(cuda)
    want_items, want = run(torch.device("cpu"))
    for k, v in want_items.items():
        assert abs(got_items[k] - v) <= 1e-4 * abs(v), k
    for k, g in want.items():
        assert g.abs().max() > 0, k
        assert _rel_l2(got[k], g) <= 5e-3, k


def test_cli_trains_dfpn_and_chn_on_the_card(cuda, tmp_path):
    """One step each of DFPN train and CHN train through ``main([...,
    "--device", "cuda"])`` on a small fixture tree (bf16, base 64, two
    RRDBs, no validation). With the JAX CLI's default routes DFPN training
    launches no kernel (VGG and DFPN's convs on their modules); CHN
    training launches K1 (3 calls an RRDB) and K3 (one an RRDB) for the
    trunk, K4 and K6 for the tail."""
    from master_thesis_tpu_torch.__main__ import main
    from master_thesis_tpu_torch.ops import conv_stack, rrdb_bwd, tail_bwd
    from tests.fixtures import make_fake_data_root

    root = make_fake_data_root(str(tmp_path / "data"))
    common = ["--device", "cuda", "--data_path", root, "--data_ckpt_path", str(tmp_path / "data.ckpt"),
              "--default_root_dir", str(tmp_path / "logs"), "--dfpn_base_size", "64", "--chn_nb", "2",
              "--train_size", "64", "64", "--batch_size", "2", "--train_max_iterations", "1",
              "--max_epochs", "1", "--limit_val_batches", "0"]
    counters = {"K1": rrdb.rdb_cuda, "K3": rrdb_bwd.rrdb_bwd_cuda, "K4": tail.tail_cuda,
                "K6": tail_bwd.tail_bwd_cuda, "K7": conv_stack.conv_stack_tiles_cuda,
                "K8": conv_stack.conv_stack_banded_cuda}

    def run(argv):
        for c in counters.values():
            c.launches = 0
        state = main(common + argv)
        torch.cuda.synchronize()
        assert state.step == 1
        assert all(p.is_cuda and torch.isfinite(p).all() for p in state.model.parameters())
        return {k: c.launches for k, c in counters.items()}

    assert run(["--frames_n", "2"]) == dict.fromkeys(counters, 0)
    assert run(["--chn", "--frames_n", "3"]) == {
        "K1": 2 * 3, "K3": 2, "K4": tail.TAIL_KERNELS, "K6": tail_bwd.TAIL_BWD_KERNELS, "K7": 0, "K8": 0}


# ---------------------------------------------------------------------------
# The f32 route's kernels (csrc/conv_f32.cu) against their plain versions,
# TF32 off (the fixture): max|kernel - plain| <= 1e-5 * max|plain| (f32
# sums in another order).
# ---------------------------------------------------------------------------

F32_REL = 1e-5


def _f32_close(got, want):
    assert torch.isfinite(got).all()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= F32_REL * scale, (err, scale)


# (k, up, pool, epi, slices, band, n, h, w, cin, cout): the RDB's widths,
# the tail's upconvs and adjoints, K7 / K8's thin and wide convs.
@pytest.mark.parametrize("k,up,pool,epi,slices,band,n,h,w,cin,cout", [
    (3, False, False, "leaky", True, None, 2, 37, 45, 160, 32),
    (3, False, False, "resid", True, None, 2, 16, 64, 192, 64),
    (3, True, False, "leaky", False, None, 1, 20, 24, 64, 64),
    (3, False, True, "mask_leaky", False, None, 1, 40, 48, 64, 64),
    (3, False, False, "mask_leaky", True, None, 2, 24, 20, 96, 32),
    (3, False, False, "none", False, None, 2, 32, 32, 64, 3),
    (5, False, False, "relu", False, None, 3, 29, 31, 10, 128),
    (3, False, False, "relu", False, None, 64, 16, 16, 1, 128),
    (3, False, False, "mask_relu", False, None, 2, 16, 16, 256, 256),
    (3, False, False, "leaky", True, (5, (11, 23)), 2, 40, 36, 96, 32),
    (3, True, False, "leaky", False, (3, (10, 18)), 1, 16, 24, 64, 64),
])
def test_conv_f32_fwd_kernel_matches_plain(cuda, k, up, pool, epi, slices, band, n, h, w, cin, cout):
    from master_thesis_tpu_torch.ops import conv_f32

    g = torch.Generator().manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g).to(cuda)
    frame = rnd(n, h, w, cin + 8)
    x = frame[..., 8:] if slices else frame[..., :cin].contiguous()
    wk, bias = rnd(k, k, cin, cout) / (k * k * cin) ** 0.5, rnd(cout)
    s = 2 if up else 1
    ho, wo = (s * h // 2, s * w // 2) if pool else (s * h, s * w)
    extra = {}
    if epi == "resid":
        extra = dict(r=rnd(n, ho, wo, cout), r2=rnd(n, ho, wo, cout), alpha=0.2, beta=0.2)
    elif epi.startswith("mask"):
        extra = dict(m=rnd(n, ho, wo, cout))
    kw = dict(bias=bias, k=k, up=up, pool=pool, epi=epi, **extra)
    if band is not None:
        x_row0, rows = band
        x = x[:, x_row0:]
        kw.update(hin=h, rows=rows, x_row0=x_row0)
    bufs = [torch.zeros(n, ho, wo, cout + 4, device=cuda) for _ in range(2)]
    outs = [b[..., 4:] if slices else b[..., :cout].contiguous() for b in bufs]
    before = conv_f32.conv_f32_fwd_cuda.launches
    conv_f32.conv_f32_fwd_cuda(x, wk, outs[0], **kw)
    torch.cuda.synchronize()
    assert conv_f32.conv_f32_fwd_cuda.launches == before + 1
    conv_f32.conv_f32_fwd_plain(x, wk, outs[1], **kw)
    _f32_close(outs[0], outs[1])
    if slices:
        assert torch.equal(bufs[0][..., :4], torch.zeros_like(bufs[0][..., :4]))


@pytest.mark.parametrize("k,up,slices,n,h,w,cin,cout", [
    (3, False, True, 8, 64, 64, 192, 64),
    (3, False, False, 2, 33, 47, 64, 3),
    (3, True, False, 2, 32, 32, 64, 64),
    (5, False, False, 2, 20, 24, 10, 32),
])
def test_conv_f32_wgrad_kernel_matches_plain(cuda, k, up, slices, n, h, w, cin, cout):
    """Weight and bias grads against the plain version's sums in f64
    (cuDNN's f32 weight grads, TF32 off, read up to 3.5e-5 from f64 at
    these sizes, the kernel's 3e-7: the limit holds the kernel, not cuDNN),
    and the same bits on a second run (the partial sums are reduced in a
    fixed order)."""
    from master_thesis_tpu_torch.ops import conv_f32

    g = torch.Generator().manual_seed(4)
    frame = torch.randn(n, h, w, cin + 16, generator=g).to(cuda)
    x = frame[..., 16:] if slices else frame[..., :cin].contiguous()
    s = 2 if up else 1
    dy = torch.randn(n, s * h, s * w, cout, generator=g).to(cuda)
    got = [(torch.empty(cout, cin, k, k, device=cuda), torch.empty(cout, device=cuda)) for _ in range(2)]
    for dw, db in got:
        conv_f32.conv_f32_wgrad_cuda(x, dy, dw, db, k=k, up=up)
    torch.cuda.synchronize()
    xe = x.double().repeat_interleave(2, 1).repeat_interleave(2, 2) if up else x.double()
    want = (torch.nn.grad.conv2d_weight(xe.permute(0, 3, 1, 2), got[0][0].shape,
                                        dy.double().permute(0, 3, 1, 2), padding=k // 2),
            dy.double().sum(dim=(0, 1, 2)))
    for a, b in zip(got[0], want):
        _f32_close(a.double(), b)
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])


def test_f32_routes_take_f32_card_tensors(cuda):
    """An RDB, the tail and a K8 stack in f32 through their dispatchers on
    the card launch the f32 route, and agree with the plain versions."""
    from master_thesis_tpu_torch.ops import conv_f32, conv_stack

    rng = np.random.RandomState(5)
    nf, gc = rrdb.KERNEL_NF, rrdb.KERNEL_GC
    convs = [_conv(rng, nf + k * gc, gc if k < 4 else nf, (1.0 / (9 * (nf + k * gc))) ** 0.5) for k in range(5)]
    p = rrdb.pack_rdb([(w.to(cuda), b.to(cuda)) for w, b in convs], torch.float32)
    x = torch.from_numpy(rng.randn(2, nf, 20, 28).astype(np.float32)).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    before = rrdb.rdb_f32.launches
    _f32_close(rrdb.rdb(x, p), rrdb.rdb_plain(x, p))
    assert rrdb.rdb_f32.launches == before + rrdb.RDB_CONVS
    tp = tail.pack_tail(*[tuple(t.to(cuda) for t in _conv(rng, nf, o, 0.05)) for o in (nf, nf, nf, 3)],
                        torch.float32)
    _f32_close(tail.tail(x, tp), tail.tail_plain(x, tp))
    _f32_close(tail.tail_banded(x, tp, 8), tail.tail_plain(x, tp))
    sp = conv_stack.pack_stack([tuple(t.to(cuda) for t in _conv(rng, 64, 64, 0.05)),
                                tuple(t.to(cuda) for t in _conv(rng, 64, 2, 0.05))], [True, False],
                               torch.float32)
    xs = torch.from_numpy(rng.randn(2, 24, 40, 64).astype(np.float32)).to(cuda)
    _f32_close(conv_stack.conv_stack_banded(xs, sp), conv_stack.conv_stack_banded_plain(xs, sp))
    with pytest.raises(ValueError, match="--use_pallas false"):
        rrdb.rdb(x.half(), p)
    assert conv_f32.conv_f32_fwd_cuda.launches > 0
