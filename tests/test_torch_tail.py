"""The port's tail plain versions against the JAX phase-space tail kernel
(``rrdbnet_tail_pallas`` in interpret mode, full frame and in row bands),
f32; and the packed layouts the CUDA tail kernels read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops.pallas_tail import rrdbnet_tail_pallas
from master_thesis_tpu_torch.models.nn_ext import pixel_shuffle_2x
from master_thesis_tpu_torch.ops import fragments
from master_thesis_tpu_torch.ops import tail as ttail


def _tail_params(rng, nf):
    p = {}
    for name, cout in (("upconv1", nf), ("upconv2", nf), ("hr_conv", nf), ("conv_last", 3)):
        p[f"{name}_kernel"] = (rng.randn(3, 3, nf, cout) * 0.2).astype(np.float32)
        p[f"{name}_bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
    return p


def _pack(p, dtype=torch.float32):
    conv = lambda n: (
        torch.from_numpy(p[f"{n}_kernel"]).permute(3, 2, 0, 1),
        torch.from_numpy(p[f"{n}_bias"]),
    )
    return ttail.pack_tail(conv("upconv1"), conv("upconv2"), conv("hr_conv"), conv("conv_last"), dtype)


@pytest.mark.parametrize("h,w,n", [(8, 8, 2), (6, 10, 1)])
def test_tail_plain_matches_pallas(rng, h, w, n):
    """Square, and the 6x10 grid that a 24x40 frame gives (the reference's
    240x480 is 60x120)."""
    nf = 16
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    want = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y), jnp.float32, interpret=True)
    got = ttail.tail(torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(), _pack(p))
    assert got.shape == (n, 3, 4 * h, 4 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("band_rows", [2, 4])
def test_tail_banded_plain_matches_pallas_banded(rng, band_rows):
    """A 10x6 input in row bands with the 4-row halo: 2 gives 5 bands, 4
    gives 4, 4 and a last band of 2; only the first and last are clipped by
    the frame at both band heights. Tolerance as the full-frame tail's."""
    nf, h, w, n = 16, 10, 6, 2
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    want = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y), jnp.float32,
                               interpret=True, band_rows=band_rows)
    x = torch.from_numpy(y).permute(0, 3, 1, 2).contiguous()
    packed = _pack(p)
    got = ttail.tail_banded_plain(x, packed, band_rows)
    assert got.shape == (n, 3, 4 * h, 4 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5)
    torch.testing.assert_close(ttail.tail_banded(x, packed, band_rows), got, atol=0, rtol=0)
    torch.testing.assert_close(got, ttail.tail_plain(x, packed), atol=1e-5, rtol=0)


def test_tail_kernel_layouts(rng):
    """The kernel-side layouts compute what the plain-side ones do: the
    phase form of each upsample-conv (phase ``(a, b)``, tap ``(ti, tj)``
    reads input offset ``(a-1+ti, b-1+tj)``, rows ``(ti, tj, c)``), and
    hr_conv / conv_last as ``(9*C, O)`` matrices, all in the fragment order
    of ``ops/fragments.py``."""
    nf, h, w = 16, 5, 7
    p = _pack(_tail_params(rng, nf))
    x = torch.from_numpy(rng.randn(2, nf, h, w).astype(np.float32))
    xp = F.pad(x, (1, 1, 1, 1))
    for name in ("up1", "up2"):
        want = pixel_shuffle_2x(F.conv2d(x, p[f"{name}_fused"], padding=1))
        phases = p[f"{name}_phase"].reshape(4, -1)
        got = torch.empty_like(want)
        for a in (0, 1):
            for b in (0, 1):
                mat = fragments.unpack(phases[a * 2 + b], 4 * nf, nf).reshape(4, nf, nf)
                acc = 0
                for ti in (0, 1):
                    for tj in (0, 1):
                        win = xp[:, :, a + ti: a + ti + h, b + tj: b + tj + w]
                        acc = acc + torch.einsum("nchw,co->nohw", win, mat[ti * 2 + tj])
                got[:, :, a::2, b::2] = acc
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for key, cout in (("hr", nf), ("last", 3)):
        mat = fragments.unpack(p[f"{key}_w"], 9 * nf, cout).reshape(3, 3, nf, cout)
        torch.testing.assert_close(mat.permute(3, 2, 0, 1), p[f"{key}_oihw"], atol=0, rtol=0)
    assert p["last_w"].numel() == 9 * nf * 16


def test_tail_flops_counts_reference_convs():
    """619 GFLOP for the production step's tail (80 frames at 64x64): the
    upsample-convs in their 4-phase form (4/9 of the 888 GFLOP the nearest
    upsample then 3x3 convs would take), hr_conv and conv_last at 9 taps."""
    assert round(ttail.tail_flops(80, 64, 64) / 1e9) == 619
    nine_tap = 2 * 80 * 9 * 64 * (128**2 * 64 + 2 * 256**2 * 64 + 256**2 * 3)
    upconv_per_tap = 2 * 80 * 64 * 64 * (128**2 + 256**2)
    assert ttail.tail_flops(80, 64, 64) == nine_tap - 5 * upconv_per_tap
