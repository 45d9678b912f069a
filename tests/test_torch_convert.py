"""``chn_from_jax`` / ``cpn_from_jax`` round-trip exactly through the JAX
package's ``chn_from_torch`` / ``cpn_from_torch``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from master_thesis_tpu.models import convert as jconvert
from master_thesis_tpu.models.chn import CHN as JaxCHN
from master_thesis_tpu.models.cpn import CPN as JaxCPN
from master_thesis_tpu_torch.models.chn import CHN
from master_thesis_tpu_torch.models.convert import chn_from_jax, cpn_from_jax
from master_thesis_tpu_torch.models.cpn import CPN


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_array_equal(np.asarray(lb[path]), leaf, err_msg=str(path))


def test_chn_round_trip():
    nb, nf, gc, h = 2, 16, 8, 16
    z = jnp.zeros
    params = _np_tree(JaxCHN(nb=nb, nf=nf, gc=gc).init(
        jax.random.PRNGKey(0), z((1, h, h, 3)), z((1, h, h, 1)),
        z((1, 1, h, h, 3)), z((1, 1, h, h, 1)), z((1, 1, h, h, 1)),
    )["params"])
    port = CHN(nb=nb, nf=nf, gc=gc, device="cpu")
    port.load_state_dict(chn_from_jax(params, nb))
    _assert_trees_equal(params, jconvert.chn_from_torch(port.state_dict(), nb=nb))
    # And the other way: a port state dict survives JAX and back.
    fresh = CHN(nb=nb, nf=nf, gc=gc, device="cpu", generator=torch.Generator().manual_seed(5))
    sd = fresh.state_dict()
    back = chn_from_jax(jconvert.chn_from_torch(sd, nb=nb), nb)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_cpn_round_trip():
    h = 32
    z = jnp.zeros
    params = _np_tree(JaxCPN().init(
        jax.random.PRNGKey(0), z((1, h, h, 3)), z((1, h, h, 1)),
        z((1, 1, h, h, 3)), z((1, 1, h, h, 1)),
    )["params"])
    port = CPN(device="cpu")
    port.load_state_dict(cpn_from_jax(params))
    _assert_trees_equal(params, jconvert.cpn_from_torch(port.state_dict()))
    sd = CPN(device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    back = cpn_from_jax(jconvert.cpn_from_torch(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_dfpn_round_trip():
    """``dfpn_from_jax`` inverts the JAX ``dfpn_from_torch`` both ways,
    transposed convs included (base 64: a 4x4 correlation)."""
    from master_thesis_tpu.models.dfpn import DFPN as JaxDFPN
    from master_thesis_tpu_torch.models.convert import dfpn_from_jax
    from master_thesis_tpu_torch.models.dfpn import DFPN

    z = jnp.zeros
    params = _np_tree(JaxDFPN(base_size=64).init(
        jax.random.PRNGKey(0), z((1, 64, 64, 3)), z((1, 64, 64, 1)), z((1, 1, 64, 64, 3)),
        z((1, 1, 64, 64, 1)), z((1, 4, 4, 512)), z((1, 1, 4, 4, 512)),
    )["params"])
    port = DFPN(base_size=64, device="cpu")
    port.load_state_dict(dfpn_from_jax(params))
    _assert_trees_equal(params, jconvert.dfpn_from_torch(port.state_dict()))
    sd = DFPN(base_size=64, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    back = dfpn_from_jax(jconvert.dfpn_from_torch(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
