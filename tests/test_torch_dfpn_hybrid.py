"""The port's hybrid DFPN routes, CPN's context-matching modules and the
last transforms against the JAX package on the same seeded inputs and
weights, f32 on the CPU, the JAX side with HIGHEST precision and its Pallas
kernels in interpret mode:

- ``conv_phase_s2d`` (both output layouts), ``_conv_im2col``;
- ``flow_estimator_apply_hybrid`` (the JAX tests' four cases and ``"s2d"``),
  ``vgg_pool4_hybrid``, ``dfpn_infer_apply`` with the hybrid flags (and the
  precedence of ``pallas_flow``), the refusal on a grad path, and the K8
  launches each route plans at the CHN+DFPN step's shapes;
- ``Encoder``, ``cm_module`` and ``Decoder`` on weights carried by
  ``convert.cpn_aux_from_jax``, and a reference ``weight.pth`` split between
  ``CPN`` and ``CPNContext``;
- ``transforms.crop`` and ``transforms.dilate``.

Tolerance 2e-4, the JAX tests' own, unless a test states another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.models import convert as jconvert
from master_thesis_tpu.models import cpn as jcpn
from master_thesis_tpu.models import dfpn as jdfpn
from master_thesis_tpu.models import nn_ext as jnn_ext
from master_thesis_tpu.models.vgg import vgg_pool4_hybrid as jax_vgg_pool4_hybrid
from master_thesis_tpu.ops import transforms as jtransforms
from master_thesis_tpu_torch.models import convert, cpn, dfpn, nn_ext
from master_thesis_tpu_torch.models.vgg import VGGFeatures, vgg_pool4_hybrid
from master_thesis_tpu_torch.ops import conv_stack, transforms

ATOL = 2e-4
BASE = 64


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """2 intra-op threads: the suite runs several workers at once, and
    small CPU ops spread over every core by each of them wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _frames(rng, b, f, h, w):
    """Frames in [0, 1), masks with 20% holes."""
    return (rng.rand(b, h, w, 3).astype(np.float32), (rng.rand(b, h, w, 1) > 0.8).astype(np.float32),
            rng.rand(b, f, h, w, 3).astype(np.float32), (rng.rand(b, f, h, w, 1) > 0.8).astype(np.float32))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shuffle_out", [True, False])
def test_conv_phase_s2d_matches_jax(k, shuffle_out):
    """3 input and 5 output channels, so a swap of ``(q, c)`` or ``(p, o)``
    in the regrouped kernel shows; the unshuffled map keeps ``(py, px, o)``."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 3).astype(np.float32)
    w = rng.randn(5, 3, k, k).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jnn_ext.conv_phase_s2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), 2, k // 2,
                                      k // 2, jnp.float32, shuffle_out=shuffle_out)
    got = nn_ext.conv_phase_s2d(*_t(x, w), 2, k // 2, k // 2, torch.float32, shuffle_out=shuffle_out)
    assert got.shape == want.shape == ((2, 8, 12, 5) if shuffle_out else (2, 4, 6, 20))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_conv_im2col_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 7, 10).astype(np.float32)
    w = rng.randn(6, 10, 5, 5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jdfpn._conv_im2col(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b))
    got = dfpn._conv_im2col(*_t(x, w, b))
    assert got.shape == want.shape == (2, 9, 7, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _port_and_jax_dfpn(seed=1):
    net = dfpn.DFPN(base_size=BASE, device="cpu", generator=torch.Generator().manual_seed(seed))
    return net, {"params": jconvert.dfpn_from_torch(net.state_dict())}


@pytest.fixture(scope="module")
def estimator_case():
    """A flow estimator and seeded inputs at 1 x 1 x 128²: c0, c6-c7 and
    c11-c12 (at 32²) reach K8's route, c9-c10 (at 16²) the modules."""
    rng = np.random.RandomState(0)
    net, params = _port_and_jax_dfpn()
    ins = _frames(rng, 1, 1, 128, 128) + ((rng.randn(1, 1, 128, 128, 2) * 0.1).astype(np.float32),)
    return net.flow_64, params["params"]["flow_64"], ins


@pytest.mark.parametrize("kw", [
    dict(),  # the default hybrid: c0 and the mids on K8
    dict(fuse_mids=False, c0_mode="pallas"),
    dict(fuse_mids=False, c0_mode="im2col"),
    dict(fuse_mids=False, c0_mode="xla"),
    dict(fuse_mids=False, c0_mode="s2d"),
], ids=["mids+c0P", "c0-pallas", "c0-im2col", "c0-xla", "c0-s2d"])
def test_flow_estimator_hybrid_matches_jax(estimator_case, kw):
    est, p, ins = estimator_case
    with jax.default_matmul_precision("highest"):
        want = jdfpn.flow_estimator_apply_hybrid(p, *map(jnp.asarray, ins), dtype=jnp.float32,
                                                 interpret=True, **kw)
    with torch.no_grad():
        got = dfpn.flow_estimator_apply_hybrid(est, *_t(*ins), **kw)
    assert got.shape == want.shape == (1, 1, 128, 128, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vgg_pool4_hybrid_matches_jax():
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2))
    params = jconvert.vgg16_from_torch(vgg.state_dict())
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_vgg_pool4_hybrid(params, jnp.asarray(x), dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        got = vgg_pool4_hybrid(vgg, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 4, 4, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def infer_case():
    """Seeded inputs at base 64 for ``dfpn_infer_apply``."""
    rng = np.random.RandomState(5)
    net, params = _port_and_jax_dfpn()
    cs = BASE // 16
    feats = (rng.randn(1, cs, cs, 512).astype(np.float32), rng.randn(1, 2, cs, cs, 512).astype(np.float32))
    return net, params, _frames(rng, 1, 2, BASE, BASE) + feats


@pytest.mark.parametrize("routes", [
    dict(hybrid_flow=True),
    dict(hybrid_flow=True, hybrid_fuse_mids=False, hybrid_c0_mode="s2d"),
], ids=["hybrid", "hybrid-s2d"])
def test_dfpn_infer_apply_hybrid_matches_jax(infer_case, routes):
    """All four outputs at base 64, the JAX side on the same flags. With
    ``pallas_flow`` also set, the outputs are those of ``pallas_flow`` alone
    bit for bit (its precedence; that route's own parity with JAX is
    ``tests/test_torch_dfpn.py``'s)."""
    net, params, inputs = infer_case
    with jax.default_matmul_precision("highest"):
        want = jdfpn.dfpn_infer_apply(params, *map(jnp.asarray, inputs), dtype=jnp.float32,
                                      base_size=BASE, interpret=True, **routes)
    with torch.no_grad():
        got = dfpn.dfpn_infer_apply(net, *_t(*inputs), **routes)
        both = dfpn.dfpn_infer_apply(net, *_t(*inputs), pallas_flow=True, **routes)
        alone = dfpn.dfpn_infer_apply(net, *_t(*inputs), pallas_flow=True)
    assert all(torch.equal(b, a) for b, a in zip(both, alone))
    assert len(got) == 4
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL)


def test_hybrid_route_refused_on_a_grad_path(infer_case):
    """``hybrid_flow=True`` raises under grad mode with trainable DFPN
    parameters, naming the flag; under ``torch.no_grad()`` it runs."""
    net, _, inputs = infer_case
    run = lambda: dfpn.dfpn_infer_apply(net, *_t(*inputs), pallas_mixer=False, hybrid_flow=True)
    with pytest.raises(ValueError, match="hybrid_flow=True.*no backward"):
        run()
    with torch.no_grad():
        run()


class _Specs:
    """A stand-in for a ``StackCache`` that packs nothing: the specs alone."""

    def get(self, names, convs, relus, dtype):
        return type("Packed", (), {"specs": [conv_stack._spec(c.weight) for c in convs]})()


@pytest.mark.parametrize("kw,want", [
    (dict(), {"flow_256": (7, 6), "flow_64": (1, 0)}),
    (dict(fuse_mids=False), {"flow_256": (1, 0), "flow_64": (1, 0)}),
    (dict(fuse_mids=False, c0_mode="s2d"), {"flow_256": (0, 0), "flow_64": (0, 0)}),
    (dict(fuse_mids=False, c0_mode="im2col"), {"flow_256": (0, 0), "flow_64": (0, 0)}),
], ids=["mids+c0P", "c0-pallas", "c0-s2d", "c0-im2col"])
def test_hybrid_k8_launches_at_the_dfpn_step(monkeypatch, kw, want):
    """The K8 launches (all, and those on the frame kernel) that
    :func:`conv_stack.band_plan` gives each hybrid route at the CHN+DFPN
    step's shapes (20 frames, base 256: flow_256 at 256², flow_64 at 64²),
    the counts ``chip_smoke.py`` holds the card to. Shapes only: the
    estimator runs on the meta device, K8's calls recorded."""
    plans = []

    def record(x, p):
        assert x.is_contiguous()
        n, h, w, _ = x.shape
        plans.append(conv_stack.band_plan(tuple(p.specs), h, w))
        return torch.empty(n, h, w, p.specs[-1][2], dtype=x.dtype, device=x.device)

    monkeypatch.setattr(conv_stack, "conv_stack_banded", record)
    got = {}
    for label, size in (("flow_256", 256), ("flow_64", 64)):
        est = dfpn.FlowEstimator(generator=torch.Generator().manual_seed(0), dtype=torch.float32).to("meta")
        est.stacks = _Specs()
        ins = [torch.empty(4, *s, device="meta") for s in ((size, size, 3), (size, size, 1))]
        ins += [torch.empty(4, 5, size, size, c, device="meta") for c in (3, 1, 2)]
        plans.clear()
        with torch.no_grad():
            out = dfpn.flow_estimator_apply_hybrid(est, *ins, **kw)
        assert out.shape == (4, 5, size, size, 2)
        got[label] = (sum(map(len, plans)), sum(g.kernel == "frame" for pl in plans for g in pl))
    assert got == want


# ---------------------------------------------------------------------------
# CPN's context-matching modules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def context_case():
    """JAX Encoder / Decoder params from their own init, carried into a
    ``CPNContext`` by ``cpn_aux_from_jax``."""
    z = jnp.zeros
    enc = jcpn.Encoder().init(jax.random.PRNGKey(0), z((1, 16, 16, 3)), z((1, 16, 16, 1)))["params"]
    dec = jcpn.Decoder().init(jax.random.PRNGKey(1), z((1, 4, 4, 257)))["params"]
    params = {"Encoder": enc, "Decoder": dec}
    ctx = cpn.CPNContext(device="cpu")
    ctx.load_state_dict(convert.cpn_aux_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return ctx, params


def test_cpn_aux_from_jax_inverts_cpn_aux_from_torch(context_case):
    ctx, params = context_case
    back = jconvert.cpn_aux_from_torch(ctx.state_dict())
    flat = lambda tree: dict(jax.tree_util.tree_leaves_with_path(tree))
    want, got = flat(params), flat(back)
    assert want.keys() == got.keys()
    for key, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(leaf))


def test_encoder_matches_jax(context_case):
    ctx, params = context_case
    rng = np.random.RandomState(6)
    in_f, in_v = rng.rand(2, 32, 24, 3).astype(np.float32), (rng.rand(2, 32, 24, 1) > 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jcpn.Encoder().apply({"params": params["Encoder"]}, jnp.asarray(in_f), jnp.asarray(in_v))
    with torch.no_grad():
        got = ctx.Encoder(*_t(in_f, in_v))
    assert got.shape == want.shape == (2, 8, 6, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cm_module_matches_jax():
    """Two targets, three references at 8x8 features from 32x32 maps; the
    second reference of the first target has no visible pixel and the
    second target none at all (the ``zeros`` branch, the empty softmax)."""
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 4, 8, 8, 6).astype(np.float32)
    v_t = (rng.rand(2, 32, 32, 1) > 0.3).astype(np.float32)
    v_al = (rng.rand(2, 3, 32, 32, 1) > 0.3).astype(np.float32)
    v_al[0, 1] = 0
    v_t[1] = 0
    want = jcpn.cm_module(*map(jnp.asarray, (feats, v_t, v_al)))
    got = cpn.cm_module(*_t(feats, v_t, v_al))
    assert got[0].shape == want[0].shape == (2, 8, 8, 13)
    assert got[1].shape == want[1].shape == (2, 8, 8, 1)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5)


def test_decoder_matches_jax(context_case):
    """At 8x8 (every dilation up to 16 reads only zero padding past the
    frame's edge) -> 32x32."""
    ctx, params = context_case
    x = np.random.RandomState(8).randn(1, 8, 8, 257).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jcpn.Decoder().apply({"params": params["Decoder"]}, jnp.asarray(x))
    with torch.no_grad():
        got = ctx.Decoder(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpn_context_chain_matches_jax(context_case):
    """``CPNContext``: Encoder over the target and its aligned references,
    ``cm_module``, Decoder, against the JAX modules composed the same way,
    at 1 x (1 + 2) x 32²."""
    ctx, params = context_case
    rng = np.random.RandomState(9)
    x_t, m_t, x_al, _ = _frames(rng, 1, 2, 32, 32)
    v_al = (rng.rand(1, 2, 32, 32, 1) > 0.2).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        frames = jnp.concatenate([jnp.asarray(x_t)[:, None], jnp.asarray(x_al)], 1).reshape(3, 32, 32, 3)
        vis = jnp.concatenate([1 - jnp.asarray(m_t)[:, None], jnp.asarray(v_al)], 1).reshape(3, 32, 32, 1)
        feats = jcpn.Encoder().apply({"params": params["Encoder"]}, frames, vis)
        x, c_mask = jcpn.cm_module(feats.reshape(1, 3, 8, 8, 128), 1 - jnp.asarray(m_t), jnp.asarray(v_al))
        want = jcpn.Decoder().apply({"params": params["Decoder"]}, x)
    with torch.no_grad():
        got, got_mask = ctx(*_t(x_t, m_t, x_al, v_al))
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got_mask.numpy(), np.asarray(c_mask), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_reference_weights_split_between_cpn_and_context(tmp_path):
    """A reference ``weight.pth`` (DataParallel ``module.`` prefixes, the
    regressor's dead conv6a / conv6b, the context modules' keys): ``CPN``
    loads the aligner's part, ``CPNContext`` the Encoder's and Decoder's, each
    strictly, and the split leaves no key of either out."""
    from master_thesis_tpu_torch.config import Config
    from master_thesis_tpu_torch.train.build import build_cpn, build_cpn_context

    aligner = cpn.CPN(device="cpu", generator=torch.Generator().manual_seed(11))
    context = cpn.CPNContext(device="cpu", generator=torch.Generator().manual_seed(12))
    dead = {f"A_Regressor.{n}.conv.0.{p}": torch.zeros(3) for n in ("conv6a", "conv6b") for p in ("weight", "bias")}
    sd = {**aligner.state_dict(), **context.state_dict(), **dead}
    path = tmp_path / "weight.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    cfg = Config(device="cpu", compute_dtype="float32")
    for built, want in ((build_cpn(cfg, str(path)), aligner), (build_cpn_context(cfg, str(path)), context)):
        got = built.state_dict()
        assert got.keys() == want.state_dict().keys()
        assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())


# ---------------------------------------------------------------------------
# crop, dilate
# ---------------------------------------------------------------------------


def test_crop_matches_jax():
    x = np.random.RandomState(10).rand(2, 3, 20, 30, 4).astype(np.float32)
    want = jtransforms.crop(jnp.asarray(x), (8, 12), (5, 7))
    got = transforms.crop(torch.from_numpy(x), (8, 12), (5, 7))
    assert got.shape == want.shape == (2, 3, 8, 12, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,filter_size,iterations", [
    (np.float32, (3, 3), 4), (np.bool_, (5, 3), 2),
])
def test_dilate_matches_jax(dtype, filter_size, iterations):
    """A sparse mask over a leading frame axis, bit for bit, in its dtype."""
    m = (np.random.RandomState(11).rand(2, 3, 24, 20, 1) > 0.97).astype(dtype)
    want = jtransforms.dilate(jnp.asarray(m), filter_size, iterations)
    got = transforms.dilate(torch.from_numpy(m), filter_size, iterations)
    assert got.dtype == torch.from_numpy(m).dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
