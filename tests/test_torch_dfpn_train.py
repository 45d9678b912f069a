"""The port's DFPN training step against the JAX package's
(``master_thesis_tpu.train.dfpn_task``) on the same weights and batch, f32
on the CPU with HIGHEST precision on the JAX side: the six loss items, the
total and every DFPN parameter grad of one step, the eval step's items;
``transforms.resize`` / ``resize_set``; and the refusal of the K7 / K8
routes on a grad path.

The batch: B=2, F=3 (target index 1, two references), 64², DFPN at base
64, ``flows_use = [True, False]``; the ground-truth flows are the identity
grid plus a smooth seeded displacement that leaves the frame in places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.models import convert as jconvert
from master_thesis_tpu.models import dfpn as jdfpn
from master_thesis_tpu.models.vgg import VGGFeatures as JaxVGG
from master_thesis_tpu.ops import transforms as jtransforms
from master_thesis_tpu.train import dfpn_task as jtask
from master_thesis_tpu_torch.models import dfpn
from master_thesis_tpu_torch.models.convert import dfpn_from_jax
from master_thesis_tpu_torch.models.vgg import VGGFeatures, vgg_pool4_pallas
from master_thesis_tpu_torch.ops import transforms
from master_thesis_tpu_torch.ops.flows import identity_grid
from master_thesis_tpu_torch.train import dfpn_task, state

BASE = 64
B, F, H, W = 2, 3, 64, 64
# Tolerances: the loss terms 2e-5 relative (they read within 5e-7: f32
# sums in another order through ~50 convs and the 4-D correlation); each
# grad tensor by relative L2 5e-3 and max|diff| 2e-2 of max|JAX's| (they
# read within 1.3e-3 and 5e-3: flow_256's grads are ~1e-6 at these weights
# and sum over the batch's pixels, so the order of f32 sums shows).
RTOL_LOSS, L2_GRAD, MAX_GRAD = 2e-5, 5e-3, 2e-2
# At base 64 the mixer narrows to 1-channel ReLU convs, dead for most
# seeds, which zeroes its grads on both sides; with this one every grad of
# the DFPN is live, so each comparison below compares something.
DFPN_SEED = 5



@pytest.fixture(autouse=True, scope="module")
def _threads():
    """2 intra-op threads: the suite runs several workers at once, and
    small CPU ops spread over every core by each of them wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

def _batch():
    rng = np.random.RandomState(0)
    y = rng.rand(B, F, H, W, 3).astype(np.float32)
    m = np.zeros((B, F, H, W, 1), np.float32)
    m[:, :, 20:40, 24:44] = 1
    m[:, 0, 4:12, 40:60] = 1  # a hole in a reference that the target lacks
    x = (1 - m) * y
    # Smooth flows: a per-frame shift and a slow wave, large enough near the
    # borders to leave [-1, 1].
    grid = identity_grid(H, W).numpy()
    yy, xx = np.meshgrid(np.linspace(0, np.pi, H), np.linspace(0, np.pi, W), indexing="ij")
    wave = np.stack([np.sin(xx), np.cos(yy)], axis=-1)[None, None]
    shift = rng.uniform(-0.1, 0.1, (B, F, 1, 1, 2))
    flow = (grid[None, None] + shift + 0.05 * wave).astype(np.float32)
    flows_use = np.asarray([True, False])
    return x, m, y, flow, flows_use


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def case():
    """The port's DFPN and VGG, their JAX params, the batch, and the JAX
    loss, items and grads of one step (compiled once)."""
    from master_thesis_tpu.models.convert import vgg16_from_torch

    net = dfpn.DFPN(base_size=BASE, device="cpu", generator=torch.Generator().manual_seed(DFPN_SEED))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2))
    vgg.requires_grad_(False)
    params = {"params": jconvert.dfpn_from_torch(net.state_dict())}
    vgg_params = {"params": vgg16_from_torch(vgg.state_dict())}
    module = jdfpn.DFPN(dtype=jnp.float32, base_size=BASE)
    batch = _batch()

    # The VGG params and the batch are arguments, not constants of the
    # jitted function: XLA would fold VGG's convs at compile time.
    def loss_fn(p, vgg_p, *arrays):
        def vgg_apply(x, normalize_input=True):
            return JaxVGG().apply(vgg_p, x, normalize_input=normalize_input)

        return jtask.forward_and_loss(module.apply, p, vgg_apply, *arrays, base_size=BASE)

    with jax.default_matmul_precision("highest"):
        (total, items), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, vgg_params, *map(jnp.asarray, batch))
    want_items = {k: float(v) for k, v in items.items()}
    want_items["loss"] = float(total)
    want_grads = dfpn_from_jax(jax.tree_util.tree_map(np.asarray, grads["params"]))
    return net, vgg, batch, want_items, want_grads


def _assert_items(got, want):
    assert set(got) == set(dfpn_task.LOSSES_NAMES) | {"loss"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].item(), want[k], rtol=RTOL_LOSS, atol=1e-7, err_msg=k)


def test_train_step_loss_items_and_grads_match_jax(case):
    """One micro-step at k = 1: the items and total, every DFPN parameter's
    grad (each nonzero), the parameters moved and VGG untouched."""
    _, vgg, batch, want_items, want_grads = case
    net = dfpn.DFPN(base_size=BASE, device="cpu", generator=torch.Generator().manual_seed(DFPN_SEED))
    st = state.create_train_state(net, state.OptimConfig(), steps_per_epoch=10)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    vgg_before = {k: v.clone() for k, v in vgg.state_dict().items()}
    grads = {}
    orig = st.apply_gradients

    def capture():
        grads.update({k: p.grad.clone() for k, p in net.named_parameters()})
        return orig()

    st.apply_gradients = capture
    items = dfpn_task.make_train_step(net, vgg)(st, *_t(*batch))
    _assert_items(items, want_items)
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        want = want_grads[k]
        assert g.abs().max() > 0, k
        assert (g - want).norm() <= L2_GRAD * want.norm(), k
        assert (g - want).abs().max() <= MAX_GRAD * want.abs().max(), k
    assert all(not torch.equal(before[k], v) for k, v in net.state_dict().items())
    assert all(torch.equal(vgg_before[k], v) for k, v in vgg.state_dict().items())
    assert all(p.grad is None for p in vgg.parameters())
    assert st.step == 1 and st.updates == 1


def test_eval_step_items_match_jax(case):
    """The eval step's items against the JAX ``forward_and_loss`` that
    ``make_eval_step`` runs, without grads."""
    net, vgg, batch, want_items, _ = case
    items = dfpn_task.make_eval_step(net, vgg)(*_t(*batch))
    _assert_items(items, want_items)
    assert all(p.grad is None for p in net.parameters())


def test_k8_features_give_the_same_loss(case):
    """``pallas_vgg`` sends the frozen features through K8's route (its
    plain version on the CPU): the same items within the loss tolerance
    (the pool-4 towers agree to 1e-4, tests/test_torch_dfpn.py)."""
    net, vgg, batch, want_items, _ = case
    items = dfpn_task.make_eval_step(net, vgg, pallas_vgg=True)(*_t(*batch))
    for k in items:
        np.testing.assert_allclose(items[k].item(), want_items[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape,size,keep_ratio,mode", [
    ((2, 30, 40, 3), (20, -1), True, "bilinear"),  # the [:-1] quirk: 26 columns, the last dropped
    ((2, 30, 40, 3), (20, 20), True, "bilinear"),  # h < w: height to 20, width cropped
    ((2, 40, 30, 3), (20, 20), True, "bilinear"),  # w < h: width to 20, height cropped
    ((3, 24, 24, 1), (16, 16), True, "nearest"),
    ((2, 30, 40, 3), (24, 18), False, "bilinear"),
    ((1, 2, 30, 40, 3), (15, -1), True, "nearest"),
])
def test_resize_matches_jax(shape, size, keep_ratio, mode):
    """Tolerance 1e-5, as ``resize_hw``'s own test (tests/test_torch_ops.py):
    JAX's tap tables are f32 matmuls; nearest is exact."""
    img = np.random.RandomState(3).rand(*shape).astype(np.float32)
    want = np.asarray(jtransforms.resize(jnp.asarray(img), size, mode=mode, keep_ratio=keep_ratio))
    got = transforms.resize(torch.from_numpy(img), size, mode=mode, keep_ratio=keep_ratio)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_resize_set_matches_jax():
    """Frames bilinear, visibility nearest (still binary); tolerance 1e-5."""
    x, m, y, _, _ = _batch()
    want = jtransforms.resize_set(jnp.asarray(x), jnp.asarray(1 - m), jnp.asarray(y), 16)
    got = transforms.resize_set(*_t(x, 1 - m, y), 16)
    for g, w in zip(got, want):
        assert g.shape == (B, F, 16, 16, w.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert set(np.unique(got[1].numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("flag", ["pallas_sep4d", "pallas_mixer", "pallas_flow", "vgg"])
def test_kernel_routes_refused_on_a_grad_path(flag):
    """Each ``pallas_*`` flag of ``dfpn_infer_apply`` (the mixer's is on by
    default), and ``vgg_pool4_pallas``, raise under grad mode with trainable
    parameters, naming the route; under ``torch.no_grad()`` or with frozen
    parameters they run."""
    net = dfpn.DFPN(base_size=BASE, device="cpu", generator=torch.Generator().manual_seed(1))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(4)
    cs = BASE // 16
    args = _t(rng.rand(1, BASE, BASE, 3).astype(np.float32), np.zeros((1, BASE, BASE, 1), np.float32),
              rng.rand(1, 1, BASE, BASE, 3).astype(np.float32),
              np.zeros((1, 1, BASE, BASE, 1), np.float32),
              rng.randn(1, cs, cs, 512).astype(np.float32),
              rng.randn(1, 1, cs, cs, 512).astype(np.float32))
    if flag == "vgg":
        module, run = vgg, lambda: vgg_pool4_pallas(vgg, args[0])
    else:
        routes = {**dict(pallas_sep4d=False, pallas_mixer=False, pallas_flow=False), flag: True}
        module, run = net, lambda: dfpn.dfpn_infer_apply(net, *args, **routes)
    name = "vgg_pool4_pallas" if flag == "vgg" else f"{flag}=True"
    with pytest.raises(ValueError, match=f"{name}.*no backward"):
        run()
    with torch.no_grad():
        run()
    module.requires_grad_(False)
    run()
