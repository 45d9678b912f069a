"""The port's movement simulator and affine helpers
(master_thesis_tpu_torch/ops/movements.py) against the JAX package's: the
same draws from the same RandomState, and the same bits out of every warp,
with the native warp library and without it (numpy)."""

import numpy as np
import pytest

from master_thesis_tpu.ops import movements as jm
from master_thesis_tpu_torch.ops import movements as pm
from master_thesis_tpu_torch.runtime import native


@pytest.fixture(params=["native", "numpy"])
def warp_lib(request, monkeypatch):
    """The port with its native warp library, or without it (the numpy
    expressions the library is bit-exact with)."""
    if request.param == "numpy":
        monkeypatch.setitem(native._libs, "warp", None)
    else:
        assert native.is_available()["warp"]
    return request.param


def test_affine_helpers_equal_jax():
    rng = np.random.RandomState(0)
    mats = [pm.affine_matrix((rng.randint(-9, 9), rng.randint(-9, 9)), rng.uniform(0.8, 1.2, 2),
                             rng.uniform(-0.3, 0.3)) for _ in range(5)]
    stacked = np.stack(mats)
    np.testing.assert_array_equal(pm.stack_transformations(stacked, 2), jm.stack_transformations(stacked, 2))
    for m in mats:
        np.testing.assert_array_equal(pm.affine2theta(m, 37, 53), jm.affine2theta(m, 37, 53))
    theta = np.stack([pm.affine2theta(m, 37, 53) for m in mats])
    for ac in (True, False):
        np.testing.assert_array_equal(pm.affine_grid_np(theta, (37, 53), ac),
                                      jm.affine_grid_np(theta, (37, 53), ac))
    flow = pm.affine_grid_np(theta, (37, 53))
    np.testing.assert_array_equal(pm.crop_flow_np(flow, (20, 31), (5, 7)),
                                  jm.crop_flow_np(flow, (20, 31), (5, 7)))
    np.testing.assert_array_equal(pm.identity_grid_np(9, 11), jm.identity_grid_np(9, 11))
    t = (3.0, -2.0), (1.1, 0.9), 0.2
    np.testing.assert_array_equal(pm.affine_matrix(*t), jm.affine_matrix(*t))


def test_random_affine_draws_equal_jax():
    a = pm.MovementSimulator(50, 0.1, 0.2, np.random.RandomState(7))
    b = jm.MovementSimulator(50, 0.1, 0.2, np.random.RandomState(7))
    for _ in range(6):
        np.testing.assert_array_equal(a.random_affine(), b.random_affine())
    # No displacement: no integer draw.
    a = pm.MovementSimulator(0, 0.1, 0.2, np.random.RandomState(8))
    b = jm.MovementSimulator(0, 0.1, 0.2, np.random.RandomState(8))
    np.testing.assert_array_equal(a.random_affine(), b.random_affine())


@pytest.mark.parametrize("c,n", [(3, 3), (1, 2)])
def test_simulate_movement_equals_jax(warp_lib, c, n):
    x = np.random.RandomState(1).rand(40, 52, c).astype(np.float32)
    got = pm.MovementSimulator(8, 0.1, 0.2, np.random.RandomState(3)).simulate_movement(x, n)
    want = jm.MovementSimulator(8, 0.1, 0.2, np.random.RandomState(3)).simulate_movement(x, n)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode,virtual,resized", [
    ("bilinear", (80, 105), (80, 106)),  # the keep-ratio upscale of a small frame
    ("bilinear", None, None),
    ("nearest", None, None),             # the masks' path
])
def test_simulate_movement_resized_equals_jax(warp_lib, mode, virtual, resized):
    x = np.random.RandomState(2).rand(40, 53, 3 if mode == "bilinear" else 1).astype(np.float32)
    kw = dict(virtual_hw=virtual, value_mode=mode, resized_hw=resized)
    got = pm.MovementSimulator(8, 0.1, 0.2, np.random.RandomState(4)).simulate_movement_resized(
        x, 3, (24, 24), **kw)
    want = jm.MovementSimulator(8, 0.1, 0.2, np.random.RandomState(4)).simulate_movement_resized(
        x, 3, (24, 24), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("ac", [True, False])
def test_grid_sample_bilinear_equals_jax(warp_lib, ac):
    rng = np.random.RandomState(5)
    x = rng.rand(2, 17, 23, 3).astype(np.float32)
    g = (rng.rand(2, 19, 11, 2) * 2.6 - 1.3).astype(np.float32)
    np.testing.assert_array_equal(pm.grid_sample_bilinear_np(x, g, ac), jm.grid_sample_bilinear_np(x, g, ac))
