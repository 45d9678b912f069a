"""The f32 route of every kernel site (K1-K8) on the CPU: the plain versions
of the two f32 convolutions (``ops/conv_f32.py``: ``conv_f32_fwd`` and
``conv_f32_wgrad``, which the routes call on a CPU tensor) against
``F.conv2d`` and autograd at each option, and each route's own code
(packing, flips, channel slices, masks, bands, row windows) against the
JAX package's Pallas function in f32, interpret mode, under
``jax.default_matmul_precision("highest")``; then the route choice by
dtype and the trunk / tail bands by the dtype's itemsize.

Tolerances: the plain convolutions 1e-5 of the reference's largest value
(f32 sums in two orders); each route the JAX package's own test's
tolerance for that function, stated beside the case."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops import pallas_sep4d as jsep
from master_thesis_tpu.ops.pallas_rrdb import (
    banded_trunk_fits,
    make_hybrid_trunk,
    pallas_trunk_fits_big,
    rrdb_pallas,
    rrdb_trunk_pallas_banded,
)
from master_thesis_tpu.ops.pallas_tail import make_hybrid_tail, rrdbnet_tail_pallas, tail_pallas_fits
from master_thesis_tpu_torch.models.chn import kernel_routes
from master_thesis_tpu_torch.ops import conv_f32, conv_stack, rrdb, rrdb_bwd, tail, tail_bwd
from tests.test_torch_conv_stack import _dfpn_and_params, _stack
from tests.test_torch_rrdb import _pack, _rrdb_params, _to_jax
from tests.test_torch_rrdb_bwd import _flat_params
from tests.test_torch_tail import _pack as _pack_tail
from tests.test_torch_tail import _tail_params
from tests.test_torch_tail_bwd import _JAX_NAMES

REL = 1e-5


def _close(got, want, rel=REL):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * scale, (err, scale)


def _t(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _reference(x, w, bias, k, up, pool):
    """Independent of the plain version: the whole frame through
    ``F.interpolate`` / ``F.conv2d`` / ``F.avg_pool2d``, NHWC out."""
    xn = x.permute(0, 3, 1, 2)
    if up:
        xn = F.interpolate(xn, scale_factor=2, mode="nearest")
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), padding=k // 2)
    if pool:
        y = 4 * F.avg_pool2d(y, 2)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


# (k, up, pool, epi, slices, band): band = (frame rows the buffer holds
# from, output rows); slices: the input a channel slice of a wider buffer
# and the output one of another.
@pytest.mark.parametrize("k,up,pool,epi,slices,band", [
    (3, False, False, "none", False, None),
    (5, False, False, "relu", False, None),
    (3, False, False, "leaky", True, None),
    (3, False, False, "resid", True, None),
    (5, False, False, "mask_leaky", False, None),
    (3, False, False, "mask_relu", True, None),
    (3, True, False, "leaky", False, None),
    (3, False, True, "mask_leaky", True, None),
    (3, False, False, "leaky", True, (3, (5, 9))),  # a band with its halo, ragged H != W
    (5, False, False, "resid", False, (0, (0, 4))),  # the first band: the frame's top border
    (3, True, False, "none", True, (2, (6, 12))),  # a band read through x2
])
def test_conv_f32_fwd_plain_matches_conv2d(rng, k, up, pool, epi, slices, band):
    n, h, w, cin, cout = 2, 11, 7, 5, 6
    if pool:
        h, w = 12, 8
    frame = _t(rng, n, h, w, cin + 3)
    x_full = frame[..., 2:2 + cin] if slices else frame[..., :cin].contiguous()
    wk, bias = _t(rng, k, k, cin, cout), _t(rng, cout)
    want = _reference(x_full, wk, bias, k, up, pool)
    ho, wo = want.shape[1:3]
    extra = {}
    if epi == "resid":
        extra = dict(r=_t(rng, n, ho, wo, cout), r2=_t(rng, n, ho, wo, cout), alpha=0.2, beta=0.3)
        want = 0.3 * (0.2 * want + extra["r"]) + extra["r2"]
    elif epi.startswith("mask"):
        extra = dict(m=_t(rng, n, ho, wo, cout))
        slope = 0.2 if epi == "mask_leaky" else 0.0
        keep = extra["m"] >= 0 if epi == "mask_leaky" else extra["m"] > 0
        want = torch.where(keep, want, slope * want)
    elif epi == "leaky":
        want = torch.where(want >= 0, want, 0.2 * want)
    elif epi == "relu":
        want = torch.relu(want)
    buf = torch.full((n, ho, wo, cout + 4 if slices else cout), float("nan"))
    out = buf[..., 1:1 + cout] if slices else buf
    if band is None:
        conv_f32.conv_f32_fwd(x_full, wk, out, bias=bias, k=k, up=up, pool=pool, epi=epi, **extra)
        _close(out, want)
        return
    x_row0, (r0, r1) = band
    hi = min(r1 // (2 if up else 1) + k // 2 + 1, h)
    x = x_full[:, x_row0:hi]  # only the rows the window reads, and more above
    conv_f32.conv_f32_fwd(x, wk, out, bias=bias, k=k, up=up, epi=epi, hin=h, rows=(r0, r1),
                          x_row0=x_row0, **extra)
    _close(out[:, r0:r1], want[:, r0:r1])
    assert torch.isnan(out[:, :r0]).all() and torch.isnan(out[:, r1:]).all()  # no other row written
    with pytest.raises(ValueError, match="holds frame rows"):  # a window past the buffer's rows
        conv_f32.conv_f32_fwd(x, wk, out, bias=bias, k=k, up=up, epi=epi, hin=h, rows=(0, ho),
                              x_row0=x_row0, **extra)


@pytest.mark.parametrize("k,up,slices", [(3, False, True), (5, False, False), (3, True, True)])
def test_conv_f32_wgrad_plain_matches_autograd(rng, k, up, slices):
    """dW (OIHW) and db against autograd through ``F.conv2d`` of the
    (upsampled) input, for a channel slice of a wider buffer and a ragged
    frame."""
    n, h, w, cin, cout = 2, 9, 6, 7, 5
    frame = _t(rng, n, h, w, cin + 4)
    x = frame[..., 3:3 + cin] if slices else frame[..., :cin].contiguous()
    s = 2 if up else 1
    dy = _t(rng, n, s * h, s * w, cout + 2)[..., 1:1 + cout]
    wt = _t(rng, cout, cin, k, k).requires_grad_()
    bt = torch.zeros(cout, requires_grad=True)
    xn = x.permute(0, 3, 1, 2)
    xn = F.interpolate(xn, scale_factor=2, mode="nearest") if up else xn
    (F.conv2d(xn, wt, bt, padding=k // 2) * dy.permute(0, 3, 1, 2)).sum().backward()
    dw, db = torch.empty(cout, cin, k, k), torch.empty(cout)
    conv_f32.conv_f32_wgrad(x, dy, dw, db, k=k, up=up)
    _close(dw, wt.grad)
    _close(db, bt.grad)


@pytest.mark.parametrize("nf,gc,n,h,w", [(16, 8, 2, 8, 16), (64, 32, 1, 8, 8)],
                         ids=["nf16", "production-channels"])
def test_k1_f32_route_matches_rrdb_pallas(rng, nf, gc, n, h, w):
    """One RRDB on K1's f32 route (``rdb_f32``: the dense-concat buffer, the
    channel slices, conv5's two residuals) against ``rrdb_pallas`` in f32.
    Tolerance 5e-5, the JAX tests' for this kernel."""
    p = _rrdb_params(rng, nf, gc)
    x = rng.rand(n, nf, h, w).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = rrdb_pallas(jnp.asarray(x.reshape(n, nf, h * w)), _to_jax(p), nf, gc, w, interpret=True)
    got = rrdb.rrdb_trunk(torch.from_numpy(x), [_pack(p)], rdb_fn=rrdb.rdb_f32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.contiguous().numpy().reshape(n, nf, h * w), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("band_rows", [3])
def test_k2_f32_route_matches_banded_pallas(rng, band_rows):
    """Two RRDBs on K2's f32 route (``rdb_banded_f32``: each band's rows
    copied with their halo, conv k over :func:`band_windows`, conv5 into the
    frame) against ``rrdb_trunk_pallas_banded`` at the same band height (5
    bands, the last of 2 rows, the first and last clipped by the frame);
    equal to the full-frame f32 route. Tolerance 5e-5, as K1's."""
    nf, gc, h, w, n = 16, 8, 14, 8, 2
    ps = [_rrdb_params(rng, nf, gc) for _ in range(2)]
    x = rng.rand(n, h, w, nf).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = rrdb_trunk_pallas_banded(jnp.asarray(x), {f"rrdb_{i}": _to_jax(p) for i, p in enumerate(ps)},
                                        nb=2, nf=nf, gc=gc, interpret=True, band_rows=band_rows)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    packed = [_pack(p) for p in ps]
    got = rrdb.rrdb_trunk(xt, packed, rdb_fn=functools.partial(rrdb.rdb_banded_f32, band_rows=band_rows))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)
    torch.testing.assert_close(got, rrdb.rrdb_trunk(xt, packed, rdb_fn=rrdb.rdb_f32), atol=0, rtol=0)


@pytest.mark.parametrize("band_rows", [0, 4])
def test_k4_k5_f32_routes_match_tail_pallas(rng, band_rows):
    """The tail's f32 route, full frame (K4, ``tail_f32``: the upconvs read
    through x2) and in bands (K5, ``tail_banded_f32``: each conv over the
    rows the next reads), against ``rrdbnet_tail_pallas`` in f32 at the
    same band height on a ragged 10x6 grid. Tolerance 5e-5, the JAX
    tests'."""
    nf, h, w, n = 16, 10, 6, 2
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y), jnp.float32,
                                   interpret=True, band_rows=band_rows)
    x = torch.from_numpy(y).permute(0, 3, 1, 2)
    packed = _pack_tail(p)
    got = tail.tail_banded_f32(x, packed, band_rows) if band_rows else tail.tail_f32(x, packed)
    assert got.shape == (n, 3, 4 * h, 4 * w) and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)
    if band_rows:
        torch.testing.assert_close(got, tail.tail_f32(x, packed), atol=0, rtol=0)


def test_k3_f32_route_grads_match_jax(rng):
    """An RRDB's backward on K3's f32 route (``rrdb_forward_kept_f32``,
    the pull kernels of ``pack_rdb_pulls_f32``, the masks and the dx
    residuals in the epilogues, ``conv_f32_wgrad``) against ``jax.grad``
    through ``make_hybrid_trunk`` in f32, interpret mode, highest
    precision, on a ragged grid: dx and every weight and bias grad.
    Tolerance 1e-4, the JAX test's own (tests/test_pallas_rrdb.py:83)."""
    nf, gc, nb, n, h, w = 16, 8, 1, 2, 6, 10
    ps = [_rrdb_params(rng, nf, gc) for _ in range(nb)]
    x = rng.rand(n, h, w, nf).astype(np.float32)
    cot = rng.randn(n, h, w, nf).astype(np.float32)
    trunk = make_hybrid_trunk(nb=nb, nf=nf, gc=gc, dtype=jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(lambda a, q: jnp.vdot(trunk(a, q), jnp.asarray(cot)), argnums=(0, 1))(
            jnp.asarray(x), {f"rrdb_{i}": _to_jax(p) for i, p in enumerate(ps)})

    params = [t.detach() for t in _flat_params(ps)]
    convs = [[(params[10 * r + 2 * k], params[10 * r + 2 * k + 1]) for k in range(5)]
             for r in range(3 * nb)]
    sources = rrdb._sources(convs, torch.float32)
    flat = rrdb.pack_rdbs(convs, torch.float32, sources)
    pulls = rrdb_bwd.pack_rdb_pulls_f32(convs, sources)
    y, kept = torch.from_numpy(x).permute(0, 3, 1, 2), []
    for i in range(nb):
        y, k = rrdb_bwd.rrdb_forward_kept_f32(y, flat[3 * i: 3 * i + 3])
        kept.append(k)
    g, grads = torch.from_numpy(cot).permute(0, 3, 1, 2), [None] * nb
    for i in reversed(range(nb)):
        g, grads[i] = rrdb_bwd.rrdb_bwd_f32(kept[i][0][0], g, flat[3 * i: 3 * i + 3],
                                            pulls[3 * i: 3 * i + 3], kept[i])
    np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), atol=1e-4)
    for i in range(nb):
        for j, (dws, dbs) in enumerate(rrdb_bwd.rdb_grads(grads[i], nf, gc), start=1):
            for k in range(5):
                jp = want_p[f"rrdb_{i}"][f"rdb{j}"]
                np.testing.assert_allclose(dws[k].numpy(), np.asarray(jp[f"conv{k + 1}_kernel"]).transpose(3, 2, 0, 1),
                                           atol=1e-4, err_msg=f"{i}/{j}/{k}")
                np.testing.assert_allclose(dbs[k].numpy(), np.asarray(jp[f"conv{k + 1}_bias"]), atol=1e-4)


def test_k6_f32_route_grads_match_jax(rng):
    """The tail's backward on K6's f32 route (the recompute, the adjoints'
    flipped kernels, the masks, the pooled upconv adjoints, the weight
    grads read through x2) against ``jax.grad`` through ``make_hybrid_tail``
    in f32, interpret mode, highest precision, on a ragged grid. Tolerance
    1e-4 relative and absolute, the JAX test's own
    (tests/test_pallas_tail.py:58)."""
    nf, n, h, w = 16, 1, 6, 10
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    cot = rng.randn(n, 4 * h, 4 * w, 3).astype(np.float32)
    fn = make_hybrid_tail(jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(lambda a, q: jnp.vdot(fn(a, q), jnp.asarray(cot)), argnums=(0, 1))(
            jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()})
    packed = _pack_tail(p)
    dx, grads = tail_bwd.tail_bwd_f32(torch.from_numpy(y).permute(0, 3, 1, 2),
                                      torch.from_numpy(cot).permute(0, 3, 1, 2), packed,
                                      tail_bwd.pack_tail_bwd_f32(packed))
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)
    for name in tail_bwd.PARAM_NAMES:
        key, kind = name.rsplit("_", 1)
        ref = np.asarray(want_p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"])
        ref = ref.transpose(3, 2, 0, 1) if kind == "w" else ref
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=name)


def test_k7_f32_route_matches_sep4d_and_mixer_pallas(rng, monkeypatch):
    """sep4d's two stages (the p <-> q swap between them) and the mixer on
    K7's f32 route (one launch a conv over the tiles as images) against
    ``sep4d_apply_pallas`` and ``mixer_apply_pallas`` in f32; and the
    channel-major entry against ``conv_stack_tiles``. Tolerances 5e-5
    (sep4d, mixer) and 2e-5 (the stack), the JAX tests'
    (tests/test_pallas_sep4d.py:56, :71, :92)."""
    monkeypatch.setattr(conv_stack, "conv_stack_tiles_cl", conv_stack.conv_stack_tiles_cl_f32)
    dfpn, params = _dfpn_and_params(64)
    corr = rng.randn(1, 2, 4, 4, 4, 4).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.sep4d_apply_pallas(params["separable4d"], jnp.asarray(corr), dtype=jnp.float32,
                                       interpret=True)
    got = conv_stack.sep4d_apply(*dfpn.corr.conv.packed(), torch.from_numpy(corr), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)

    dfpn, params = _dfpn_and_params(128)
    corr = (rng.randn(1, 2, 8, 8, 8, 8) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.mixer_apply_pallas(params["mixer"], jnp.asarray(corr), corr_size=8, dtype=jnp.float32,
                                       interpret=True)
    got = conv_stack.mixer_apply(dfpn.corr_mixer.packed(), torch.from_numpy(corr), 8, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)

    p, (jk, jb, relus) = _stack(rng, 1, [(3, 5, True), (5, 7, True), (3, 2, False)])
    x = rng.randn(6, 1, 64).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.conv_stack_tiles(jnp.asarray(x), jk, jb, relus, tile_side=8, grid_tiles=4,
                                     interpret=True)
    got = conv_stack.conv_stack_tiles_f32(torch.from_numpy(x), p, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_k8_f32_route_matches_banded_stack_and_vgg_pool4(rng, monkeypatch):
    """K8's f32 route (one launch a conv over whole NHWC frames) against
    ``conv_stack_banded`` at the flow estimators' Cin 10 and 5x5 (tolerance
    2e-5, tests/test_pallas_sep4d.py:130), and VGG's pool-4 tower through
    it against ``vgg_pool4_pallas`` at 64x64 (1e-4, :221)."""
    from master_thesis_tpu.models.vgg import vgg_pool4_pallas as jax_pool4
    from master_thesis_tpu_torch.models import vgg as tvgg
    from tests.test_torch_dfpn import _vgg_pair

    p, (jk, jb, relus) = _stack(rng, 10, [(5, 8, True), (3, 2, False)])
    x = rng.randn(1, 12, 9, 10).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.conv_stack_banded(jnp.asarray(x), jk, jb, relus, band_rows=5, interpret=True)
    got = conv_stack.conv_stack_banded_f32(torch.from_numpy(x), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    monkeypatch.setattr(tvgg, "conv_stack_banded", conv_stack.conv_stack_banded_f32)
    vgg, params = _vgg_pair()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_pool4(params["params"], jnp.asarray(x), dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        got = tvgg.vgg_pool4_pallas(vgg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda``: the dispatchers take their card
    routes for it (their callees are replaced below)."""

    @property
    def is_cuda(self):
        return True


def _sites(monkeypatch):
    """Each dispatcher with its two card routes replaced by recorders:
    ``{site: (call, f32 route name, bf16 route name)}``."""
    calls = []

    def recorder(name):
        return lambda *a, **k: calls.append(name)

    for mod, names in ((rrdb, ("rdb_f32", "rdb_cuda", "rdb_banded_f32", "rdb_banded_cuda")),
                       (rrdb_bwd, ("rrdb_bwd_f32", "rrdb_bwd_cuda")),
                       (tail, ("tail_f32", "tail_cuda", "tail_banded_f32", "tail_banded_cuda")),
                       (tail_bwd, ("tail_bwd_f32", "tail_bwd_cuda", "pack_tail_bwd_f32", "pack_tail_bwd")),
                       (conv_stack, ("conv_stack_tiles_f32", "conv_stack_tiles_cuda",
                                     "conv_stack_tiles_cl_f32", "conv_stack_tiles_cl_cuda",
                                     "conv_stack_banded_f32", "conv_stack_banded_cuda"))):
        for name in names:
            monkeypatch.setattr(mod, name, recorder(name))
    packed = [[None] * 3]
    sites = {
        "K1": (lambda x: rrdb.rdb(x, None), "rdb_f32", "rdb_cuda"),
        "K2": (lambda x: rrdb.rrdb_trunk_banded(x, packed), "rdb_banded_f32", "rdb_banded_cuda"),
        "K3": (lambda x: rrdb_bwd.rrdb_bwd(x, x, None, None), "rrdb_bwd_f32", "rrdb_bwd_cuda"),
        "K4": (lambda x: tail.tail(x, {}), "tail_f32", "tail_cuda"),
        "K5": (lambda x: tail.tail_banded(x, {}), "tail_banded_f32", "tail_banded_cuda"),
        "K6": (lambda x: tail_bwd.tail_bwd(x, x, {}), "tail_bwd_f32", "tail_bwd_cuda"),
        "K7": (lambda x: conv_stack.conv_stack_tiles(x, None, 4), "conv_stack_tiles_f32",
               "conv_stack_tiles_cuda"),
        "K7 channels-last": (lambda x: conv_stack.conv_stack_tiles_cl(x, None), "conv_stack_tiles_cl_f32",
                             "conv_stack_tiles_cl_cuda"),
        "K8": (lambda x: conv_stack.conv_stack_banded(x, None), "conv_stack_banded_f32",
               "conv_stack_banded_cuda"),
    }
    return sites, calls


@pytest.mark.parametrize("site", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7 channels-last", "K8"])
def test_each_site_routes_by_dtype(monkeypatch, site):
    """On a CUDA tensor each site's dispatcher takes its f32 route in f32
    and its ``wgmma`` kernels in bf16, and refuses any other dtype with an
    error that names ``--use_pallas false``."""
    sites, calls = _sites(monkeypatch)
    call, f32_route, bf16_route = sites[site]
    for dtype, route in ((torch.float32, f32_route), (torch.bfloat16, bf16_route)):
        calls.clear()
        call(torch.zeros(1, 4, 4, 4, dtype=dtype).as_subclass(_OnCard))
        assert route in calls and not ({f32_route, bf16_route} - {route}) & set(calls)
    with pytest.raises(ValueError, match="--use_pallas false"):
        call(torch.zeros(1, 4, 4, 4, dtype=torch.float16).as_subclass(_OnCard))
    assert conv_f32.kernel_route(torch.float32) == "f32"
    assert conv_f32.kernel_route(torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("h,w", [(64, 64), (64, 96), (128, 128), (96, 200), (128, 256), (140, 140)])
def test_kernel_routes_band_by_itemsize_as_the_jax_predicates(h, w):
    """In f32 (itemsize 4) the trunk bands past ``pallas_trunk_fits_big``
    (19 660 pixels) and the tail past ``tail_pallas_fits`` (5 734), as
    ``make_hybrid_trunk`` / ``make_hybrid_tail`` do in f32; in bf16 as
    before."""
    for itemsize in (2, 4):
        trunk, tail_banded = kernel_routes(h, w, itemsize=itemsize)
        assert trunk == (not pallas_trunk_fits_big(64, 32, h * w, itemsize))
        assert tail_banded == (not tail_pallas_fits(64, h * w, itemsize))
    # Past banded_trunk_fits the JAX package takes XLA (at 256 columns in
    # f32); the port keeps K2's f32 route there.
    assert not banded_trunk_fits(64, 32, 256, 4) and banded_trunk_fits(64, 32, 256, 2)
    assert kernel_routes(64, 96, itemsize=4) == (False, True) and kernel_routes(64, 96) == (False, False)
    assert kernel_routes(128, 256, itemsize=4) == (True, True)
