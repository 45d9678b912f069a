"""The port's trunk backward (``TrunkFunction`` on the CPU, i.e. the plain
backward ``rrdb_bwd_plain``) against ``jax.grad`` through the JAX
``make_hybrid_trunk``, whose backward is the fused ``rrdb_bwd_pallas`` in
interpret mode; and the plain backward against ``torch.autograd`` through
``rdb_plain``. f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops.pallas_rrdb import make_hybrid_trunk
from master_thesis_tpu_torch.ops import rrdb as trrdb
from master_thesis_tpu_torch.ops import rrdb_bwd
from tests.test_torch_rrdb import _rrdb_params, _to_jax


def _flat_params(ps):
    """JAX RRDB params (list over RRDBs) -> the Function's flat OIHW list."""
    out = []
    for p in ps:
        for j in (1, 2, 3):
            for k in range(1, 6):
                out.append(torch.from_numpy(p[f"rdb{j}"][f"conv{k}_kernel"]).permute(3, 2, 0, 1).contiguous())
                out.append(torch.from_numpy(p[f"rdb{j}"][f"conv{k}_bias"]).clone())
    return [t.requires_grad_() for t in out]


@pytest.mark.parametrize(
    "nf,gc,nb,n,h,w",
    [(16, 8, 2, 2, 8, 8), (64, 32, 1, 1, 8, 8), (16, 8, 1, 1, 6, 10)],
    ids=["nf16-nb2", "production-channels", "ragged"],
)
def test_trunk_function_grads_match_jax(rng, nf, gc, nb, n, h, w):
    """dx and every conv's weight and bias grad. The second case is the
    production nf=64, gc=32 (the dense-concat channel splits nf=16 misses,
    as tests/test_pallas_rrdb.py:193); the third a ragged H != W grid.
    Tolerance 2e-4 absolute, the JAX tests' own for this backward."""
    ps = [_rrdb_params(rng, nf, gc) for _ in range(nb)]
    x = rng.rand(n, h, w, nf).astype(np.float32)
    cot = rng.randn(n, h, w, nf).astype(np.float32)

    trunk = make_hybrid_trunk(nb=nb, nf=nf, gc=gc, dtype=jnp.float32, interpret=True)
    jparams = {f"rrdb_{i}": _to_jax(p) for i, p in enumerate(ps)}
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(
            lambda a, p: jnp.vdot(trunk(a, p), jnp.asarray(cot)), argnums=(0, 1)
        )(jnp.asarray(x), jparams)

    params = _flat_params(ps)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    y = rrdb_bwd.TrunkFunction.apply(xt, torch.float32, *params)
    y.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), atol=2e-4)
    idx = 0
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                wk = np.asarray(want_p[f"rrdb_{i}"][f"rdb{j}"][f"conv{k}_kernel"]).transpose(3, 2, 0, 1)
                wb = np.asarray(want_p[f"rrdb_{i}"][f"rdb{j}"][f"conv{k}_bias"])
                np.testing.assert_allclose(params[idx].grad.numpy(), wk, atol=2e-4, err_msg=f"{i}/{j}/{k}")
                np.testing.assert_allclose(params[idx + 1].grad.numpy(), wb, atol=2e-4, err_msg=f"{i}/{j}/{k}")
                idx += 2


def test_trunk_function_forward_is_the_trunk(rng):
    nf, gc = 16, 8
    ps = [_rrdb_params(rng, nf, gc)]
    x = torch.from_numpy(rng.rand(1, nf, 6, 6).astype(np.float32))
    params = _flat_params(ps)
    got = rrdb_bwd.TrunkFunction.apply(x, torch.float32, *params)
    packed = [[trrdb.pack_rdb([(params[j * 10 + 2 * k], params[j * 10 + 2 * k + 1]) for k in range(5)],
                              torch.float32) for j in range(3)]]
    assert torch.equal(got, trrdb.rrdb_trunk(x, packed))


@pytest.mark.parametrize("nf,gc", [(16, 8), (64, 32)])
def test_rdb_bwd_plain_matches_autograd(rng, nf, gc):
    """``rdb_bwd_plain`` (explicit adjoints and weight grads) against
    ``torch.autograd`` through ``rdb_plain``, f32; tolerance 1e-5 relative
    to each grad's scale."""
    p = _rrdb_params(rng, nf, gc)["rdb1"]
    ws = [torch.from_numpy(p[f"conv{k}_kernel"]).permute(3, 2, 0, 1).contiguous().requires_grad_() for k in range(1, 6)]
    bs = [torch.from_numpy(p[f"conv{k}_bias"]).clone().requires_grad_() for k in range(1, 6)]
    packed = trrdb.PackedRDB(None, torch.cat(bs), tuple(ws))  # differentiable view for autograd
    x = torch.from_numpy(rng.randn(2, nf, 7, 9).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, nf, 7, 9).astype(np.float32))
    want = torch.autograd.grad((trrdb.rdb_plain(x, packed) * g).sum(), [x, *ws, *bs])

    with torch.no_grad():
        _, hidden = trrdb.rdb_plain(x, packed, keep_hidden=True)
        dx, (dws, dbs) = rrdb_bwd.rdb_bwd_plain(x.detach(), hidden, g, packed)
    for got, ref in zip([dx, *dws, *dbs], want):
        scale = ref.abs().max().item()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 * max(scale, 1.0))


def test_rrdb_bwd_flops_counts_recompute_adjoint_and_weight_grads():
    """141 GFLOP for one RRDB's backward at the train step (8 frames at
    64x64): three times the forward's 47."""
    assert round(rrdb_bwd.rrdb_bwd_flops(8, 64, 64) / 1e9) == 141
    assert rrdb_bwd.rrdb_bwd_flops(8, 64, 64) == 3 * 3 * trrdb.rdb_flops(8, 64, 64)


def test_rrdb_bwd_dispatch_rejects_unknown_device():
    x = torch.zeros(1, 64, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no RRDB backward"):
        rrdb_bwd.rrdb_bwd(x, x, [], [])
