"""The port's LPIPS (master_thesis_tpu_torch/models/lpips.py) against the JAX
``LPIPS`` on the same random weights (``lpips_from_jax``), f32, and
``build_lpips`` without and with weight files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.models.lpips import LPIPS as JaxLPIPS
from master_thesis_tpu.models.lpips import lpips_distance as jax_lpips_distance
from master_thesis_tpu.models.lpips import lpips_from_torch
from master_thesis_tpu_torch.config import Config
from master_thesis_tpu_torch.models.convert import lpips_from_jax
from master_thesis_tpu_torch.models.lpips import LPIPS, lpips_distance
from master_thesis_tpu_torch.train.build import build_lpips


@pytest.fixture(scope="module")
def jax_lpips():
    model = JaxLPIPS()
    z = jnp.zeros((1, 64, 64, 3))
    params = model.init(jax.random.PRNGKey(5), z, z)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params) -> LPIPS:
    m = LPIPS(device="cpu")
    m.load_state_dict(lpips_from_jax(params["params"]))
    return m


def test_lpips_matches_jax(rng, jax_lpips):
    """Per-image distances within 1e-5 relative: five f32 AlexNet convs and
    the heads, summed in another order."""
    model, params = jax_lpips
    a = rng.rand(3, 72, 80, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = model.apply(params, jnp.asarray(2 * a - 1), jnp.asarray(2 * b - 1))
        want_mean = jax_lpips_distance(model.apply, params, jnp.asarray(a), jnp.asarray(b))
    port = _port(params)
    with torch.no_grad():
        got = port(torch.from_numpy(2 * a - 1), torch.from_numpy(2 * b - 1))
        got_mean = lpips_distance(port, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=1e-5)


def test_build_lpips(tmp_path, rng, jax_lpips):
    """None without the weight files; with the heads' file and the AlexNet
    trunk's (torchvision keys), the metric of those weights, whose keys
    the JAX ``lpips_from_torch`` reads to the same params."""
    cfg = Config(device="cpu", compute_dtype="float32")
    assert build_lpips(cfg) is None
    assert build_lpips(cfg, lpips_checkpoint=str(tmp_path / "absent.pth")) is None
    _, params = jax_lpips
    sd = lpips_from_jax(params["params"])
    trunk = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    heads = {k: v for k, v in sd.items() if k.startswith("lin")}
    back = lpips_from_torch({k: v.numpy() for k, v in trunk.items()}, {k: v.numpy() for k, v in heads.items()})
    for name, leaf in params["params"]["net"].items():
        np.testing.assert_array_equal(back["net"][name]["kernel"], leaf["kernel"])
    torch.save(trunk, tmp_path / "alexnet.pth")
    torch.save(heads, tmp_path / "alex.pth")
    assert build_lpips(cfg, lpips_checkpoint=str(tmp_path / "alex.pth")) is None  # no trunk
    fn = build_lpips(cfg, str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth"))
    a = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    b = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(float(fn(a, b)), float(lpips_distance(_port(params), a, b)), rtol=1e-6)
