"""The port's losses and quality measures against the JAX package's
(``master_thesis_tpu.ops.losses``, ``master_thesis_tpu.ops.measures``), f32.
Tolerance 1e-6 relative: the same sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops import losses as jlosses
from master_thesis_tpu.ops import measures as jmeasures
from master_thesis_tpu_torch.ops import losses, measures

T = torch.from_numpy


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("with_batch_mask", [False, True])
def test_masked_l1_matches_jax(rng, reduction, with_batch_mask):
    """A 1-channel mask on 3-channel images: ``"sum"`` normalises by the
    mask's own element count."""
    y_hat = rng.rand(3, 2, 8, 8, 3).astype(np.float32)
    y = rng.rand(3, 2, 8, 8, 3).astype(np.float32)
    mask = (rng.rand(3, 2, 8, 8, 1) > 0.5).astype(np.float32)
    bm = np.asarray([True, False, True]) if with_batch_mask else None
    want = jlosses.masked_l1(jnp.asarray(y_hat), jnp.asarray(y), jnp.asarray(mask),
                             None if bm is None else jnp.asarray(bm), reduction=reduction, weight=0.5)
    got = losses.masked_l1(T(y_hat), T(y), T(mask), None if bm is None else T(bm),
                           reduction=reduction, weight=0.5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_masked_l1_sum_counts_mask_elements():
    y_hat, y = torch.ones(1, 2, 2, 3), torch.zeros(1, 2, 2, 3)
    mask = torch.ones(1, 2, 2, 1)
    # |diff| summed over 4 pixels x 3 channels, over 4 mask elements.
    assert losses.masked_l1(y_hat, y, mask, reduction="sum").item() == pytest.approx(3.0)


def test_masked_l1_mean_with_no_row_left_is_zero():
    y_hat, y = torch.ones(2, 4, 4, 3), torch.zeros(2, 4, 4, 3)
    got = losses.masked_l1(y_hat, y, torch.ones_like(y), torch.tensor([False, False]))
    assert got.item() == 0.0


def test_sobel_grads_channel_order(rng):
    """All H-gradients first, then all V-gradients (losses.py:101-104)."""
    y = rng.rand(2, 9, 7, 3).astype(np.float32)
    want = np.asarray(jlosses.sobel_grads(jnp.asarray(y)))
    got = losses.sobel_grads(T(y)).numpy()
    assert got.shape == (2, 9, 7, 6)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # channel 0 is the horizontal response of R: a ramp along W gives -2*4.
    ramp = torch.arange(5.0).view(1, 1, 5, 1).expand(1, 5, 5, 3)
    g = losses.sobel_grads(ramp)
    assert g[0, 2, 2, 0].item() == pytest.approx(-8.0) and g[0, 2, 2, 3].item() == pytest.approx(0.0)


def test_grad_and_perceptual_match_jax(rng):
    a = rng.rand(2, 8, 8, 3).astype(np.float32)
    b = rng.rand(2, 8, 8, 3).astype(np.float32)
    want = jlosses.grad(jnp.asarray(a), jnp.asarray(b), reduction="mean", weight=1.0)
    np.testing.assert_allclose(losses.grad(T(a), T(b)).item(), float(want), rtol=1e-6)
    fa = [rng.rand(2, s, s, 4).astype(np.float32) for s in (8, 4, 2)]
    fb = [rng.rand(2, s, s, 4).astype(np.float32) for s in (8, 4, 2)]
    want = jlosses.perceptual([jnp.asarray(f) for f in fa], [jnp.asarray(f) for f in fb], weight=0.5)
    got = losses.perceptual([T(f) for f in fa], [T(f) for f in fb], weight=0.5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_psnr_ssim_match_jax(rng):
    """PSNR drops zero-error frames; SSIM keeps skimage's data_range=2."""
    a = rng.rand(3, 16, 16, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(3, 16, 16, 3), 0, 1).astype(np.float32)
    b[1] = a[1]
    with jax.default_matmul_precision("highest"):
        want_p = float(jmeasures.psnr(jnp.asarray(a), jnp.asarray(b)))
        want_s = float(jmeasures.ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(measures.psnr(T(a), T(b)).item(), want_p, rtol=1e-5)
    np.testing.assert_allclose(measures.ssim(T(a), T(b)).item(), want_s, rtol=1e-5)
