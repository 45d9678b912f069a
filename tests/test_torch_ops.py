"""Port ops against the JAX package: resize, affine grid and warp; plus the
port's import hygiene and device default."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops import grid_sample as jgs
from master_thesis_tpu.ops import interp as jinterp
from master_thesis_tpu_torch.ops import grid_sample as tgs
from master_thesis_tpu_torch.ops import interp as tinterp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("size,align_corners", [((224, 224), False), ((20, 12), True), ((9, 40), False)])
def test_resize_hw_matches_jax(rng, size, align_corners):
    x = rng.rand(2, 3, 17, 23, 4).astype(np.float32)
    want = jinterp.resize_hw(jnp.asarray(x), size, mode="bilinear", align_corners=align_corners)
    got = tinterp.resize_hw(torch.from_numpy(x), size, align_corners=align_corners)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_grid_and_warp_match_jax(rng, align_corners):
    n, h, w = 3, 16, 24
    theta = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (n, 1, 1))
    theta += rng.randn(n, 2, 3).astype(np.float32) * 0.1
    x = rng.rand(n, h, w, 4).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        g_want = jgs.affine_grid(jnp.asarray(theta), (h, w), align_corners=align_corners)
        want = jgs.grid_sample(jnp.asarray(x), g_want, mode="bilinear", align_corners=align_corners)
    g_got = tgs.affine_grid(torch.from_numpy(theta), (h, w), align_corners=align_corners)
    got = tgs.grid_sample(torch.from_numpy(x), g_got, align_corners=align_corners)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_port_imports_no_jax():
    """Importing every port module loads no jax, flax or JAX-package module.
    Names are compared whole: ``master_thesis_tpu_torch`` shares a prefix
    with ``master_thesis_tpu``."""
    code = (
        "import sys\n"
        "import master_thesis_tpu_torch, master_thesis_tpu_torch._build\n"
        "import master_thesis_tpu_torch.models.chn, master_thesis_tpu_torch.models.cpn\n"
        "import master_thesis_tpu_torch.models.convert, master_thesis_tpu_torch.ops.tail\n"
        "import master_thesis_tpu_torch.models.dfpn, master_thesis_tpu_torch.train.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'master_thesis_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` at the repo root names no JAX module in an import."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        lines = [ln.strip() for ln in fh if ln.strip().startswith(("import ", "from "))]
    for ln in lines:
        mod = ln.split()[1].split(".")[0]
        assert mod not in ("jax", "jaxlib", "flax", "master_thesis_tpu"), ln


def test_entry_points_default_to_cuda():
    """With no ``device`` the models want a card; without one they raise."""
    from master_thesis_tpu_torch.models.chn import CHN
    from master_thesis_tpu_torch.models.cpn import CPN
    from master_thesis_tpu_torch.models.dfpn import DFPN
    from master_thesis_tpu_torch.train.build import build_dfpn

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot occur")
    for make in (lambda: CHN(nb=1, nf=16, gc=8), lambda: CPN(), lambda: DFPN(base_size=64),
                 lambda: build_dfpn(base_size=64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("size", [(7, 40), (34, 46), (17, 23), (4, 4)])
def test_resize_hw_nearest_matches_jax(rng, size):
    """Legacy nearest, ``floor(dst * in / out)``, shrinking and growing by
    ratios that are not integers."""
    x = rng.rand(2, 17, 23, 3).astype(np.float32)
    want = jinterp.resize_hw(jnp.asarray(x), size, mode="nearest")
    got = tinterp.resize_hw(torch.from_numpy(x), size, "nearest")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_nearest_matches_jax(rng, align_corners):
    """Nearest rounds half to even: the grid holds points half-way between
    pixels (exact in binary) besides random ones and points off the frame."""
    n, h, w = 2, 5, 9
    x = rng.rand(n, h, w, 2).astype(np.float32)
    pix_y = np.array([0.5, 1.5, 2.5, 3.5, -0.5, 4.5], np.float32)
    pix_x = np.array([0.5, 1.5, 6.5, 7.5, 8.5, -0.5], np.float32)
    if align_corners:
        gx, gy = pix_x / ((w - 1) / 2) - 1, pix_y / ((h - 1) / 2) - 1
    else:
        gx, gy = (2 * pix_x + 1) / w - 1, (2 * pix_y + 1) / h - 1
    half = np.stack(np.broadcast_arrays(gx[None, :, None], gy[None, :, None]), -1)
    rand = rng.uniform(-1.2, 1.2, size=(1, 6, 7, 2)).astype(np.float32)
    grid = np.concatenate([np.broadcast_to(half, (1, 6, 1, 2)), rand], axis=2)
    grid = np.concatenate([grid, grid[:, ::-1]], axis=0).astype(np.float32)
    want = jgs.grid_sample(jnp.asarray(x), jnp.asarray(grid), mode="nearest", align_corners=align_corners)
    got = tgs.grid_sample(torch.from_numpy(x), torch.from_numpy(grid), "nearest", align_corners=align_corners)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flows_and_resize_set_bis_match_jax(rng):
    """``align_set`` (frames bilinear, visibility nearest, align_corners
    True), ``resize_flow`` (bilinear, align_corners False, values kept),
    ``resize_set_bis`` (masks nearest; unchanged at the same size), the
    abs <-> relative flow conversions and ``crop_flow``."""
    from master_thesis_tpu.ops import flows as jflows
    from master_thesis_tpu.ops import transforms as jtr
    from master_thesis_tpu_torch.ops import flows as tflows
    from master_thesis_tpu_torch.ops import transforms as ttr

    b, f, h, w = 1, 2, 12, 16
    x = rng.rand(b, f, h, w, 3).astype(np.float32)
    v = (rng.rand(b, f, h, w, 1) > 0.3).astype(np.float32)
    flow = np.asarray(jflows.identity_grid(h, w))[None, None] + rng.randn(b, f, h, w, 2).astype(np.float32) * 0.1
    flow = flow.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        wx, wv = jflows.align_set(jnp.asarray(x), jnp.asarray(v), jnp.asarray(flow))
    gx, gv = tflows.align_set(*map(torch.from_numpy, (x, v, flow)))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-5)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    for size in ((24, 32), (5, 7), (h, w)):
        want = jflows.resize_flow(jnp.asarray(flow), size, mode="bilinear")
        got = tflows.resize_flow(torch.from_numpy(flow), size, mode="bilinear")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rel = tflows.flow_abs_to_relative(torch.from_numpy(flow))
    np.testing.assert_allclose(rel.numpy(), np.asarray(jflows.flow_abs_to_relative(jnp.asarray(flow))), atol=1e-6)
    np.testing.assert_allclose(tflows.flow_relative_to_abs(rel).numpy(), flow, atol=1e-6)
    np.testing.assert_allclose(
        tflows.crop_flow(torch.from_numpy(flow), (6, 8), (3, 4)).numpy(),
        np.asarray(jflows.crop_flow(jnp.asarray(flow), (6, 8), (3, 4))), atol=1e-5)

    xt, mt = rng.rand(b, h, w, 3).astype(np.float32), (rng.rand(b, h, w, 1) > 0.5).astype(np.float32)
    m = (rng.rand(b, f, h, w, 1) > 0.5).astype(np.float32)
    for size in ((8, 8), (20, 28), (h, w)):
        want = jtr.resize_set_bis(*map(jnp.asarray, (xt, mt, x, m)), size)
        got = ttr.resize_set_bis(*map(torch.from_numpy, (xt, mt, x, m)), size)
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5)
    inputs = [torch.from_numpy(a) for a in (xt, mt, x, m)]
    assert all(g is t for g, t in zip(ttr.resize_set_bis(*inputs, (h, w)), inputs))


@pytest.mark.parametrize("k,pad", [(3, 1), (5, 2)])
def test_conv_transpose_matches_jax(rng, k, pad):
    """Both DFPN geometries (stride 2, output padding 1): the port's weight
    ``(I, O, k, k)`` is the JAX HWIO kernel permuted, not flipped; the init
    fan is ``O * k * k``."""
    from master_thesis_tpu.models.nn_ext import ConvTranspose2dTorch as JaxCT
    from master_thesis_tpu_torch.models.nn_ext import ConvTranspose2dTorch

    cin, cout = 6, 5
    mod = ConvTranspose2dTorch(cin, cout, k, 2, pad, 1, generator=torch.Generator().manual_seed(0))
    bound = (3.0 / (cout * k * k)) ** 0.5
    assert mod.weight.abs().max() <= bound and mod.weight.abs().max() > 0.5 * bound
    x = rng.randn(2, 7, 9, cin).astype(np.float32)
    params = {"kernel": mod.weight.detach().numpy().transpose(2, 3, 0, 1), "bias": mod.bias.detach().numpy()}
    with jax.default_matmul_precision("highest"):
        want = JaxCT(features=cout, kernel_size=(k, k), strides=(2, 2), padding=(pad, pad),
                     output_padding=(1, 1)).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 14, 18, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
