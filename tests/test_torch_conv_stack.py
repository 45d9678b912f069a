"""The conv-stack kernels' plain versions (K7 ``conv_stack_tiles``, K8
``conv_stack_banded``) and the DFPN stages on them against the JAX
package's Pallas kernels in interpret mode, in f32 on the same seeded
inputs and weights; the packing and the launch plan the CUDA kernel reads.

Tolerance 2e-4, the JAX tests' own, unless a test states another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops import pallas_sep4d as jsep
from master_thesis_tpu_torch.ops import conv_stack, fragments

ATOL = 2e-4


def _stack(rng, cin, spec):
    """Seeded ``spec`` = [(k, cout, relu), ...]: the port's packed stack
    and the same weights as JAX ``(kernels HWIO, biases, relus)``."""
    convs, jk, jb, relus = [], [], [], []
    for k, cout, relu in spec:
        w = (rng.randn(cout, cin, k, k) * (1.0 / (k * k * cin)) ** 0.5).astype(np.float32)
        b = (rng.randn(cout) * 0.1).astype(np.float32)
        convs.append((torch.from_numpy(w), torch.from_numpy(b)))
        jk.append(jnp.asarray(w.transpose(2, 3, 1, 0)))
        jb.append(jnp.asarray(b))
        relus.append(relu)
        cin = cout
    return conv_stack.pack_stack(convs, relus, torch.float32), (jk, jb, relus)


@pytest.mark.parametrize("nt,side,cin,spec", [
    (6, 8, 1, [(3, 5, True), (5, 7, True), (3, 2, False)]),  # Cin 1, Cout 2
    (5, 8, 3, [(5, 4, True), (3, 1, False)]),  # Cout 1
])
def test_conv_stack_tiles_matches_jax(rng, nt, side, cin, spec):
    p, (jk, jb, relus) = _stack(rng, cin, spec)
    x = rng.randn(nt, cin, side * side).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.conv_stack_tiles(jnp.asarray(x), jk, jb, relus, tile_side=side, grid_tiles=4,
                                     interpret=True)
    got = conv_stack.conv_stack_tiles(torch.from_numpy(x), p, side)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n,h,w,cin,spec,band_rows", [
    (2, 14, 10, 3, [(5, 6, True), (3, 4, False)], 4),  # 4 bands, halo 3 past both borders
    (1, 12, 9, 10, [(5, 8, True), (3, 2, False)], 5),  # the flow estimators' Cin 10 at 5x5
])
def test_conv_stack_banded_matches_jax(rng, n, h, w, cin, spec, band_rows):
    p, (jk, jb, relus) = _stack(rng, cin, spec)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.conv_stack_banded(jnp.asarray(x), jk, jb, relus, band_rows=band_rows,
                                      interpret=True)
    got = conv_stack.conv_stack_banded(torch.from_numpy(x), p)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _dfpn_and_params(base):
    from master_thesis_tpu.models import convert as jconvert
    from master_thesis_tpu_torch.models.dfpn import DFPN

    dfpn = DFPN(base_size=base, device="cpu", generator=torch.Generator().manual_seed(7))
    return dfpn, jconvert.dfpn_from_torch(dfpn.state_dict())


def test_mixer_apply_matches_jax(rng):
    """At corr_size 8 (64 -> .. -> 2 channels, 5x5 and 3x3 taps)."""
    dfpn, params = _dfpn_and_params(128)
    cs = 8
    corr = (rng.randn(1, 2, cs, cs, cs, cs) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.mixer_apply_pallas(params["mixer"], jnp.asarray(corr), corr_size=cs,
                                       dtype=jnp.float32, interpret=True)
    mixer = dfpn.corr_mixer
    got = conv_stack.mixer_apply(mixer.packed(), torch.from_numpy(corr), cs, torch.float32)
    assert got.shape == want.shape == (1, 2, cs, cs, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(mixer(torch.from_numpy(corr)).numpy(), np.asarray(want), atol=ATOL)


def test_sep4d_apply_matches_jax(rng):
    """Both stages and the p <-> q swap at corr_size 4."""
    dfpn, params = _dfpn_and_params(64)
    cs = 4
    corr = (rng.randn(1, 2, cs, cs, cs, cs)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.sep4d_apply_pallas(params["separable4d"], jnp.asarray(corr),
                                       dtype=jnp.float32, interpret=True)
    sep = dfpn.corr.conv
    got = conv_stack.sep4d_apply(*sep.packed(), torch.from_numpy(corr), torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(sep(torch.from_numpy(corr)).numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cout,cin,k", [(2, 1, 3), (128, 10, 5), (1, 128, 3), (64, 3, 3)])
def test_conv_matrix_pads_each_tap_to_16_channels(rng, cout, cin, k):
    """The kernel's B matrix: rows (ky, kx, c) with c zero-padded to 16 per
    tap, outputs padded to 16; unpacked it is the padded HWIO kernel."""
    w = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32))
    c16 = -(-cin // 16) * 16
    mat = fragments.unpack(conv_stack.conv_matrix(w), k * k * c16, cout)
    want = torch.zeros(k, k, c16, cout)
    want[:, :, :cin] = w.permute(2, 3, 1, 0)
    assert torch.equal(mat, want.reshape(k * k * c16, cout))


def test_plan_of_the_dfpn_stacks():
    """Every group of the production stacks fits a block's shared memory,
    the groups cover the stack in order, and the launch counts are the ones
    chip_smoke.py expects: K7 5 on the mixer and 2 + 3 on sep4d; K8 29 on
    the two flow estimators and 9 on a VGG pool-4 tower."""
    mixer = [(5, 256, 256), (3, 256, 256), (3, 256, 16), (5, 16, 16), (3, 16, 16), (3, 16, 8),
             (5, 8, 8), (3, 8, 8), (3, 8, 4), (5, 4, 4), (3, 4, 4), (3, 4, 2), (5, 2, 2), (3, 2, 2)]
    sep1, sep2 = [(3, 1, 128), (3, 128, 256), (3, 256, 256)], [(3, 256, 256), (3, 256, 128), (3, 128, 1)]
    flow = [[(5, 10, 128), (3, 128, 128)]] + [[(5, 128, 128), (3, 128, 128)]] * 5 + [
        [(5, 128, 128), (3, 128, 128), (3, 128, 2)]]
    vgg = [[(3, 3, 64), (3, 64, 64)], [(3, 64, 128), (3, 128, 128)],
           [(3, 128, 256), (3, 256, 256), (3, 256, 256)], [(3, 256, 512), (3, 512, 512), (3, 512, 512)]]
    assert len(conv_stack.plan(tuple(mixer), 4, 4, ((4, 4),))) == 1  # base 64: one launch
    cases = [(mixer, 16, 16, True, 5), (sep1, 16, 16, True, 2), (sep2, 16, 16, True, 3)]
    # flow_256's segments (at base 256) and flow_64's (at base 64): 15 + 14.
    cases += [(s, hw, hw, False, n) for s, hw, n in zip(flow, (256, 128, 64, 32, 64, 128, 256),
                                                        (2, 2, 2, 2, 2, 2, 3))]
    cases += [(s, hw, hw, False, n) for s, hw, n in zip(flow, (64, 32, 16, 8, 16, 32, 64),
                                                        (2, 2, 2, 1, 2, 2, 3))]
    cases += [(s, 256 >> i, 256 >> i, False, n) for i, (s, n) in enumerate(zip(vgg, (1, 2, 3, 3)))]
    for specs, h, w, tiles, launches in cases:
        groups = conv_stack.plan(tuple(specs), h, w, ((h, w),) if tiles else conv_stack.BAND_TILES)
        assert len(groups) == launches, specs
        assert [g.lo for g in groups] == [0] + [g.hi for g in groups[:-1]]
        assert groups[-1].hi == len(specs)
        assert all(g.smem <= conv_stack.SMEM_LIMIT for g in groups)


def test_wrappers_take_the_plain_version_on_the_cpu_only(rng):
    p, _ = _stack(rng, 4, [(3, 4, True)])
    x = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    before = conv_stack.conv_stack_tiles_cuda.launches
    conv_stack.conv_stack_tiles(x, p, 4)
    assert conv_stack.conv_stack_tiles_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        conv_stack.conv_stack_tiles_cuda(x, p, 4)
    with pytest.raises(ValueError, match="CUDA"):
        conv_stack.conv_stack_banded_cuda(x.reshape(2, 4, 4, 4), p)
