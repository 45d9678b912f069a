"""The port's VGG-16 pool features against the JAX ``VGGFeatures`` on the
same weights (``vgg_from_jax``), f32 at 32x32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.models import convert as jconvert
from master_thesis_tpu.models.vgg import VGGFeatures as JaxVGG
from master_thesis_tpu_torch.models.convert import vgg_from_jax
from master_thesis_tpu_torch.models.vgg import VGGFeatures


@pytest.fixture(scope="module")
def jax_vgg():
    model = JaxVGG()
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    return model, params


@pytest.mark.parametrize("normalize_input", [True, False])
def test_vgg_features_match_jax(rng, jax_vgg, normalize_input):
    """Tolerance 1e-4 absolute on maps of magnitude ~1: 13 f32 convs summed
    in another order."""
    model, params = jax_vgg
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = model.apply(params, jnp.asarray(x), normalize_input=normalize_input)
    vgg = VGGFeatures(device="cpu")
    vgg.load_state_dict(vgg_from_jax(jax.tree_util.tree_map(np.asarray, params["params"])))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x), normalize_input=normalize_input)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * scale)


def test_vgg_state_dict_is_torchvision_layout(jax_vgg):
    """The port's keys are torchvision's ``features.{idx}``: the JAX
    package's ``vgg16_from_torch`` reads them back to the same params."""
    _, params = jax_vgg
    sd = vgg_from_jax(jax.tree_util.tree_map(np.asarray, params["params"]))
    vgg = VGGFeatures(device="cpu")
    assert set(vgg.state_dict()) == set(sd)
    back = jconvert.vgg16_from_torch({k: v.numpy() for k, v in sd.items()})
    for name, leaf in params["params"].items():
        np.testing.assert_array_equal(back[name]["kernel"], np.asarray(leaf["kernel"]))
        np.testing.assert_array_equal(back[name]["bias"], np.asarray(leaf["bias"]))
