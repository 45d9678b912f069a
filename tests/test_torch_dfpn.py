"""The port's DFPN against the JAX package on the same seeded inputs and
weights (port state dict -> ``convert.dfpn_from_torch``), in f32 with the
JAX Pallas kernels in interpret mode: the cost volume, the flow estimator
on K8's route, VGG's pool-4 tower, ``dfpn_infer_apply`` on every route,
``dfpn_align``, and the whole slice: DFPN alignment then the CHN forward.

Tolerance 2e-4, the JAX tests' own, unless a test states another."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.models import convert as jconvert
from master_thesis_tpu.models import dfpn as jdfpn
from master_thesis_tpu.models.vgg import VGGFeatures as JaxVGG
from master_thesis_tpu.models.vgg import vgg_pool4_pallas as jax_vgg_pool4_pallas
from master_thesis_tpu_torch.models import dfpn
from master_thesis_tpu_torch.models.vgg import VGGFeatures, vgg_pool4_pallas

ATOL = 2e-4
BASE = 64


def _frames(rng, b, f, h, w):
    """Frames in [0, 1), masks with 20% holes."""
    return (rng.rand(b, h, w, 3).astype(np.float32), (rng.rand(b, h, w, 1) > 0.8).astype(np.float32),
            rng.rand(b, f, h, w, 3).astype(np.float32), (rng.rand(b, f, h, w, 1) > 0.8).astype(np.float32))


def _port_and_jax_dfpn(seed=1):
    net = dfpn.DFPN(base_size=BASE, device="cpu", generator=torch.Generator().manual_seed(seed))
    return net, {"params": jconvert.dfpn_from_torch(net.state_dict())}


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_correlation_and_softmax_match_jax(rng):
    b, f, h, w, c = 2, 3, 6, 6, 12
    t, r = rng.randn(b, h, w, c).astype(np.float32), rng.randn(b, f, h, w, c).astype(np.float32)
    vt = (rng.rand(b, h, w, 1) > 0.3).astype(np.float32)
    vr = (rng.rand(b, f, h, w, 1) > 0.3).astype(np.float32)
    want = jdfpn.correlation_masked_4d(*map(jnp.asarray, (t, vt, r, vr)))
    got = dfpn.correlation_masked_4d(*_t(t, vt, r, vr))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(dfpn.softmax_3d(got).numpy(), np.asarray(jdfpn.softmax_3d(want)),
                               atol=1e-6)


def test_flow_estimator_matches_jax(rng):
    """At 32² (all three downs and ups): the module route against the flax
    module, K8's route (plain version here) against the JAX Pallas one."""
    b, f, h, w = 1, 2, 32, 32
    net, params = _port_and_jax_dfpn()
    x_t, m_t, x_r, m_r = _frames(rng, b, f, h, w)
    fp = (rng.randn(b, f, h, w, 2) * 0.1).astype(np.float32)
    ins = (x_t, m_t, x_r, m_r, fp)
    p = params["params"]["flow_64"]
    with jax.default_matmul_precision("highest"):
        want = jdfpn.FlowEstimator(dtype=jnp.float32).apply({"params": p}, *map(jnp.asarray, ins))
        want_k = jdfpn.flow_estimator_apply_pallas(p, *map(jnp.asarray, ins), dtype=jnp.float32,
                                                   interpret=True)
    with torch.no_grad():
        got = net.flow_64(*_t(*ins))
        got_k = dfpn.flow_estimator_apply_pallas(net.flow_64, *_t(*ins))
    assert got.shape == got_k.shape == (b, f, h, w, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=ATOL)


def _vgg_pair(seed=2):
    from master_thesis_tpu.models.convert import vgg16_from_torch

    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(seed))
    return vgg, {"params": vgg16_from_torch(vgg.state_dict())}


def test_vgg_pool4_matches_jax(rng):
    """At 64²: the pool-4 exit against the module's 4th map, and K8's
    route (plain version here) against JAX ``vgg_pool4_pallas``.
    Tolerance 1e-4, the JAX test's own for this tower."""
    vgg, params = _vgg_pair()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JaxVGG().apply(params, jnp.asarray(x), normalize_input=False)[3]
        want_k = jax_vgg_pool4_pallas(params["params"], jnp.asarray(x), dtype=jnp.float32,
                                      interpret=True)
    with torch.no_grad():
        got = vgg.pool4(torch.from_numpy(x))
        got_k = vgg_pool4_pallas(vgg, torch.from_numpy(x))
    assert got.shape == got_k.shape == (1, 4, 4, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=1e-4)


@pytest.fixture(scope="module")
def infer_case():
    """Seeded inputs at base 64 and the JAX serving forward's four outputs
    with every Pallas route on (interpret mode), shared by the route cases."""
    rng = np.random.RandomState(0)
    b, f = 1, 2
    net, params = _port_and_jax_dfpn()
    frames = _frames(rng, b, f, BASE, BASE)
    cs = BASE // 16
    feats = (rng.randn(b, cs, cs, 512).astype(np.float32), rng.randn(b, f, cs, cs, 512).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        want = jdfpn.dfpn_infer_apply(params, *map(jnp.asarray, frames + feats), dtype=jnp.float32,
                                      base_size=BASE, interpret=True, pallas_sep4d=True,
                                      pallas_flow=True)
    return net, frames + feats, [np.asarray(o) for o in want]


@pytest.mark.parametrize("routes", [
    dict(),  # the JAX defaults: the mixer on K7
    dict(pallas_sep4d=True, pallas_mixer=True, pallas_flow=True),  # every kernel route
    dict(pallas_mixer=False),  # every stage through the modules
])
def test_dfpn_infer_apply_matches_jax(infer_case, routes):
    """All four outputs at base 64."""
    net, inputs, want = infer_case
    with torch.no_grad():
        got = dfpn.dfpn_infer_apply(net, *_t(*inputs), **routes)
    assert len(got) == 4
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), wnt, atol=ATOL)


def test_dfpn_align_matches_jax(rng):
    """At 48² input (the cascade resizes to base 64 and back): the warped
    frames, the nearest-warped visibility and v_map."""
    b, f, h, w = 1, 2, 48, 48
    net, params = _port_and_jax_dfpn(seed=4)
    frames = _frames(rng, b, f, h, w)
    cs = BASE // 16
    feats = (rng.randn(b, cs, cs, 512).astype(np.float32), rng.randn(b, f, cs, cs, 512).astype(np.float32))
    module = jdfpn.DFPN(dtype=jnp.float32, base_size=BASE)
    with jax.default_matmul_precision("highest"):
        want = jdfpn.dfpn_align(module.apply, params, *map(jnp.asarray, frames + feats))
    got = dfpn.dfpn_align(functools.partial(dfpn.dfpn_infer_apply, net), *_t(*frames, *feats))
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL)
    assert set(np.unique(got[1].numpy())) <= {0.0, 1.0}


def test_slice_dfpn_align_then_chn_matches_jax(rng):
    """The CHN+DFPN inpaint step at 1 x (1 + 2) x 64², base 64, nb=2: the
    port's ``dfpn_align_fn`` then ``chn_infer_apply``, against the JAX
    composition of ``dfpn_align_fn``'s pieces as it runs them off the TPU
    (VGG pool-4 of the prepared frames, the DFPN module, ``dfpn_align``)
    and ``chn_infer_apply``, on the same weights. Tolerance 5e-4, as the
    CPN slice test's: the JAX CHN head is the composed 15x15 conv, the
    port's the nested five."""
    from master_thesis_tpu.models.chn import chn_infer_apply as jax_chn_infer_apply
    from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply
    from master_thesis_tpu_torch.train.build import build_dfpn, dfpn_align_fn

    nb, nf, gc = 2, 16, 8
    b, f = 1, 2
    x_t, m_t, x_r, m_r = _frames(rng, b, f, BASE, BASE)
    net = build_dfpn(base_size=BASE, device="cpu")
    vgg, vgg_params = _vgg_pair(seed=5)
    chn = CHN(nb=nb, nf=nf, gc=gc, device="cpu", generator=torch.Generator().manual_seed(6))

    params = {"params": jconvert.dfpn_from_torch(net.state_dict())}
    jvgg = JaxVGG()
    pool4 = lambda x: jvgg.apply(vgg_params, x, normalize_input=False)[3]
    with jax.default_matmul_precision("highest"):
        jt, jmt, jr, jmr = map(jnp.asarray, (x_t, m_t, x_r, m_r))
        feats_t = pool4(jdfpn.prepare_vgg_input(jt, size=BASE))
        feats_r = pool4(jdfpn.prepare_vgg_input(jr.reshape(b * f, BASE, BASE, 3), size=BASE))
        module = jdfpn.DFPN(dtype=jnp.float32, base_size=BASE)
        xa, va, vm = jdfpn.dfpn_align(module.apply, params, jt, jmt, jr, jmr, feats_t,
                                      feats_r.reshape(b, f, *feats_r.shape[1:]))
        _, want = jax_chn_infer_apply(
            {"params": jconvert.chn_from_torch(chn.state_dict(), nb=nb)}, jt, 1 - jmt, xa, va, vm,
            nb=nb, nf=nf, gc=gc, dtype=jnp.float32, interpret=True)

    align = dfpn_align_fn(net, vgg)
    with torch.no_grad():
        t = _t(x_t, m_t, x_r, m_r)
        _, got = chn_infer_apply(chn, t[0], 1 - t[1], *align(*t))
    assert got.shape == (b, f, BASE, BASE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
