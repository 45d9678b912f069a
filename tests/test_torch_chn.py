"""The port's CHN forward against the JAX ``chn_infer_apply`` (f32,
interpret-mode Pallas kernels) on the same weights, the whole slice (CPN
alignment then CHN), and the shape routes to the banded trunk and tail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.models import convert
from master_thesis_tpu.models.chn import chn_infer_apply as jax_chn_infer_apply
from master_thesis_tpu.ops.pallas_rrdb import banded_trunk_fits, pallas_trunk_fits_big
from master_thesis_tpu.ops.pallas_tail import _tail_band_rows, tail_pallas_fits
from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply, kernel_routes
from tests.test_torch_cpn import jax_align, make_cpn


def _jax_chn(chn, nb, nf, gc, *inputs):
    variables = {"params": convert.chn_from_torch(chn.state_dict(), nb=nb)}
    with jax.default_matmul_precision("float32"):
        out = jax_chn_infer_apply(
            variables, *(jnp.asarray(a) for a in inputs), nb=nb, nf=nf, gc=gc,
            dtype=jnp.float32, interpret=True,
        )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("nb,b,f,h,w", [(2, 2, 2, 16, 16), (1, 1, 2, 24, 40)])
def test_chn_infer_apply_matches_jax(rng, nb, b, f, h, w):
    """Square, and 24x40 (a 6x10 trunk grid; the reference tests 240x480).
    Tolerance: the JAX head is the composed 15x15 conv, the port's the
    nested five convs."""
    nf, gc = 16, 8
    chn = CHN(nb=nb, nf=nf, gc=gc, device="cpu")
    x_t = rng.rand(b, h, w, 3).astype(np.float32)
    v_t = (rng.rand(b, h, w, 1) > 0.2).astype(np.float32)
    x_r = rng.rand(b, f, h, w, 3).astype(np.float32)
    v_r = (rng.rand(b, f, h, w, 1) > 0.2).astype(np.float32)
    vm = (rng.rand(b, f, h, w, 1) > 0.7).astype(np.float32)
    inputs = (x_t, v_t, x_r, v_r, vm)
    want = _jax_chn(chn, nb, nf, gc, *inputs)
    with torch.no_grad():
        got = chn_infer_apply(chn, *(torch.from_numpy(a) for a in inputs))
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), wnt, atol=1e-4)


def test_slice_align_then_chn_matches_jax(rng):
    """The serving step at B=1, F=2, 32²: ``CPN.align`` then
    ``chn_infer_apply(x_t, 1 - m_t, ...)``, each package on the same
    weights and inputs."""
    nb, nf, gc = 1, 16, 8
    b, f, h, w = 1, 2, 32, 32
    x_t = rng.rand(b, h, w, 3).astype(np.float32)
    m_t = (rng.rand(b, h, w, 1) > 0.9).astype(np.float32)
    x_r = rng.rand(b, f, h, w, 3).astype(np.float32)
    m_r = (rng.rand(b, f, h, w, 1) > 0.9).astype(np.float32)
    cpn = make_cpn(seed=1)
    chn = CHN(nb=nb, nf=nf, gc=gc, device="cpu", generator=torch.Generator().manual_seed(2))

    xa, va, vm = jax_align(cpn, x_t, m_t, x_r, m_r)
    _, want_comp = _jax_chn(chn, nb, nf, gc, x_t, 1 - m_t, xa, va, vm)

    with torch.no_grad():
        t = [torch.from_numpy(a) for a in (x_t, m_t, x_r, m_r)]
        txa, tva, tvm = cpn.align(*t)
        _, got_comp = chn_infer_apply(chn, t[0], 1 - t[1], txa, tva, tvm)
    assert got_comp.shape == (b, f, h, w, 3)
    np.testing.assert_allclose(got_comp.numpy(), want_comp, atol=5e-4)


@pytest.mark.parametrize("h,w,want", [
    (64, 64, (False, False)),  # 256x256 input: K1 + K4
    (128, 128, (False, True)),  # 512x512 input: K1 + K5
    (128, 256, (True, True)),  # 512x1024 input: K2 + K5
    (176, 176, (False, True)),  # 30 976 trunk pixels, inside the trunk's 31 043
    (176, 177, (True, True)),  # 31 152, past it
])
def test_kernel_routes_match_the_jax_predicates(h, w, want):
    """The trunk grid's routes are the JAX serving path's at bf16:
    ``make_hybrid_trunk`` bands past ``pallas_trunk_fits_big`` (with
    ``banded_trunk_fits`` holding here), ``make_hybrid_tail`` past
    ``tail_pallas_fits`` (with ``_tail_band_rows`` >= 8)."""
    trunk, tail = kernel_routes(h, w)
    assert (trunk, tail) == want
    assert trunk == (not pallas_trunk_fits_big(64, 32, h * w, 2))
    assert tail == (not tail_pallas_fits(64, h * w))
    assert not trunk or banded_trunk_fits(64, 32, w, 2)
    assert not tail or _tail_band_rows(64, w) >= 8


def test_forced_band_routes_equal_the_full_frame_forward(rng):
    """A 24x40 input (a 6x10 trunk grid) through bands of 2 trunk rows and
    of 4 tail rows gives the full-frame routes' output; tolerance: the
    band slices' convs sum in another order than the whole frame's."""
    nb, nf, gc, b, f, h, w = 2, 16, 8, 1, 2, 24, 40
    chn = CHN(nb=nb, nf=nf, gc=gc, device="cpu")
    inputs = [torch.from_numpy(a) for a in (
        rng.rand(b, h, w, 3).astype(np.float32), (rng.rand(b, h, w, 1) > 0.2).astype(np.float32),
        rng.rand(b, f, h, w, 3).astype(np.float32), (rng.rand(b, f, h, w, 1) > 0.2).astype(np.float32),
        (rng.rand(b, f, h, w, 1) > 0.7).astype(np.float32))]
    assert kernel_routes(h // 4, w // 4) == (False, False)
    with torch.no_grad():
        full = chn_infer_apply(chn, *inputs)
        banded = chn_infer_apply(chn, *inputs, trunk_band_rows=2, tail_band_rows=4)
    for g, wnt in zip(banded, full):
        torch.testing.assert_close(g, wnt, atol=1e-5, rtol=0)
