"""The port's CHN training step against the JAX package's
(``master_thesis_tpu.train.chn_task`` / ``train.state``) on the same
weights and batch, f32 on the CPU: loss, items and every parameter grad of
one step, the Adam update, the StepLR schedule, a falling loss, the packed
serving weights after an update, and the eval step's measures."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from master_thesis_tpu.config import Config
from master_thesis_tpu.models import convert as jconvert
from master_thesis_tpu.models.chn import CHN as JaxCHN
from master_thesis_tpu.models.vgg import VGGFeatures as JaxVGG
from master_thesis_tpu.ops import measures as jmeasures
from master_thesis_tpu.train import chn_task as jtask
from master_thesis_tpu.train import state as jstate
from master_thesis_tpu_torch.models.chn import CHN
from master_thesis_tpu_torch.models.convert import chn_from_jax, vgg_from_jax
from master_thesis_tpu_torch.models.vgg import VGGFeatures
from master_thesis_tpu_torch.train import chn_task, state

H = W = 32
NB, NF, GC = 1, 16, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jchn = JaxCHN(nb=NB, nf=NF, gc=GC)
    z = jnp.zeros
    chn_params = jchn.init(
        jax.random.PRNGKey(0), z((1, H, W, 3)), z((1, H, W, 1)),
        z((1, 1, H, W, 3)), z((1, 1, H, W, 1)), z((1, 1, H, W, 1)),
    )
    jvgg = JaxVGG()
    vgg_params = jvgg.init(jax.random.PRNGKey(1), z((1, H, W, 3)))
    return jchn, chn_params, jvgg, vgg_params


def _jax_vgg(jvgg, vgg_params):
    def vgg_apply(x, normalize_input=True):
        return jvgg.apply(vgg_params, x, normalize_input=normalize_input)
    return vgg_apply


def identity_align(x_t, m_t, x_r, m_r):
    """The JAX tests' aligner (tests/test_train_steps.py): references as they
    are; works on jax arrays and torch tensors alike."""
    v_aligned = 1 - m_r
    v_map = (v_aligned - (1 - m_t[:, None])).clip(0, 1)
    return x_r, v_aligned, v_map


def _port(chn_params, vgg_params):
    chn = CHN(nb=NB, nf=NF, gc=GC, device="cpu")
    chn.load_state_dict(chn_from_jax(_np_tree(chn_params["params"]), nb=NB))
    vgg = VGGFeatures(device="cpu")
    vgg.load_state_dict(vgg_from_jax(_np_tree(vgg_params["params"])))
    vgg.requires_grad_(False)
    return chn, vgg


def _batch(rng, b=2, f=2):
    y = rng.rand(b, f, H, W, 3).astype(np.float32)
    m = np.zeros((b, f, H, W, 1), np.float32)
    m[:, :, 10:20, 10:20] = 1
    m[:, 0, 4:8, 20:30] = 1  # a hole in the reference that the target lacks
    x = (1 - m) * y + m * np.asarray([0.485, 0.456, 0.406], np.float32)
    return x, m, y


def _grads_as_state_dict(grads):
    return chn_from_jax(_np_tree(grads["params"]), nb=NB)


def test_one_train_step_loss_items_and_grads_match_jax(rng, setup):
    """Loss, the 5 items and every CHN parameter grad, through CHN (trunk and
    tail as the autograd Functions, plain backward on the CPU) and VGG.
    Tolerance: 1e-5 relative on the loss terms; grads 2e-4 absolute on top
    of 1e-3 relative (the head is nested convs here and one composed 15x15
    conv in JAX, and the nb=1 trunk's grads sum over 32x32x2 pixels)."""
    jchn, chn_params, jvgg, vgg_params = setup
    vgg_apply = _jax_vgg(jvgg, vgg_params)
    x, m, y = _batch(rng)
    t, refs = jtask.target_ref_indexes(x.shape[1])

    def loss_fn(params):
        x_t, m_t = jnp.asarray(x[:, t]), jnp.asarray(m[:, t])
        xa, va, vm = identity_align(x_t, m_t, jnp.asarray(x[:, refs]), jnp.asarray(m[:, refs]))
        y_hat, y_comp = jchn.apply(params, x_t, 1 - m_t, xa, va, vm)
        return jtask.compute_loss(jnp.asarray(y[:, t]), 1 - m_t, y_hat, y_comp, vm, vgg_apply)

    with jax.default_matmul_precision("highest"):
        (want_total, want_items), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(chn_params)

    chn, vgg = _port(chn_params, vgg_params)
    before = {k: v.clone() for k, v in chn.state_dict().items()}
    st = state.create_train_state(chn, state.OptimConfig(), steps_per_epoch=10)
    step = chn_task.make_train_step(chn, identity_align, vgg)
    grads = {}
    orig = st.apply_gradients

    def capture():
        grads.update({k: p.grad.clone() for k, p in chn.named_parameters()})
        orig()

    st.apply_gradients = capture
    items = step(st, *(torch.from_numpy(a) for a in (x, m, y)))

    np.testing.assert_allclose(items["loss"].item(), float(want_total), rtol=1e-5)
    for name in chn_task.LOSSES_NAMES:
        np.testing.assert_allclose(items[name].item(), float(want_items[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    want = _grads_as_state_dict(want_grads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-3, atol=2e-4, err_msg=k)
    # The parameters moved; VGG, frozen, did not get grads.
    assert any(not torch.equal(before[k], v) for k, v in chn.state_dict().items())
    assert all(p.grad is None for p in vgg.parameters())


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_adam_update_matches_optax(rng, setup, clip):
    """One update from the same grads equals ``optax.adam`` (with global-norm
    clipping when ``gradient_clip_val > 0``), through the JAX package's own
    ``create_train_state``. Tolerance 1e-6: f32 Adam arithmetic in another
    order."""
    _, chn_params, jvgg, vgg_params = setup
    chn, _ = _port(chn_params, vgg_params)
    cfg = Config(lr=1e-3, gradient_clip_val=clip)
    st = state.create_train_state(chn, cfg, steps_per_epoch=10)
    sd0 = {k: v.clone() for k, v in chn.state_dict().items()}
    gen = torch.Generator().manual_seed(3)
    for p in chn.parameters():
        p.grad = torch.randn(p.shape, generator=gen) * 0.01
    grads_sd = {k: p.grad.clone() for k, p in chn.named_parameters()}
    st.apply_gradients()

    jparams = {"params": jconvert.chn_from_torch({k: v.numpy() for k, v in sd0.items()}, nb=NB)}
    jgrads = {"params": jconvert.chn_from_torch({k: v.numpy() for k, v in grads_sd.items()}, nb=NB)}
    jst = jstate.create_train_state(None, jparams, cfg, steps_per_epoch=10)
    jst = jst.apply_gradients(jgrads)
    want = chn_from_jax(_np_tree(jst.params["params"]), nb=NB)
    assert st.step == 1
    for k, v in chn.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_clip_by_global_norm_matches_optax():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    norm = state.clip_by_global_norm_(g, 6.5)
    want, _ = optax.clip_by_global_norm(6.5).update([jnp.asarray([3.0, 4.0]), jnp.asarray([12.0])], None)
    assert norm.item() == pytest.approx(13.0)
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


def test_step_lr_schedule_matches_jax():
    """StepLR at the epoch boundaries, against ``step_lr_schedule``; the
    train state applies the schedule's value at each update's count."""
    args = (1e-4, 50, 0.5, 100)
    ours, theirs = state.step_lr_schedule(*args), jstate.step_lr_schedule(*args)
    for count in (0, 49 * 100, 50 * 100 - 1, 50 * 100, 100 * 100, 150 * 100 + 7):
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-7)
    assert ours(50 * 100) == pytest.approx(5e-5) and ours(100 * 100) == pytest.approx(2.5e-5)
    model = torch.nn.Linear(2, 1)
    st = state.create_train_state(model, state.OptimConfig(lr=1.0, lr_scheduler_step_size=1,
                                                           lr_scheduler_gamma=0.5), steps_per_epoch=2)
    lrs = []
    for _ in range(5):
        model.weight.grad, model.bias.grad = torch.ones(1, 2), torch.ones(1)
        st.apply_gradients()
        lrs.append(st.optimizer.param_groups[0]["lr"])
    assert lrs == [1.0, 1.0, 0.5, 0.5, 0.25]


def test_train_step_decreases_loss(rng, setup):
    """Eight steps on a fixed batch (tests/test_train_steps.py:47)."""
    _, chn_params, _, vgg_params = setup
    chn, vgg = _port(chn_params, vgg_params)
    st = state.create_train_state(chn, state.OptimConfig(lr=1e-3), steps_per_epoch=10)
    step = chn_task.make_train_step(chn, identity_align, vgg)
    batch = [torch.from_numpy(a) for a in _batch(rng)]
    losses = [step(st, *batch)["loss"].item() for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_serving_forward_after_a_train_step_uses_the_updated_weights(rng, setup):
    """The packed kernel weights are never older than the parameters: a
    serving forward made before a train step must not be replayed after
    it, and an in-place update without ``repack()`` is seen as well. The
    serving forward runs under ``inference_mode``, and what it caches must
    not break the train step after it."""
    _, chn_params, _, vgg_params = setup
    chn, vgg = _port(chn_params, vgg_params)
    x, m, y = (torch.from_numpy(a) for a in _batch(rng))
    t, refs = chn_task.target_ref_indexes(x.shape[1])
    args = (x[:, t], 1 - m[:, t], *identity_align(x[:, t], m[:, t], x[:, refs], m[:, refs]))

    def serve(model):  # as chip_smoke.py serves, before it trains
        with torch.inference_mode():
            return model(*args)[0]

    before = serve(chn)
    st = state.create_train_state(chn, state.OptimConfig(lr=1e-2), steps_per_epoch=10)
    chn_task.make_train_step(chn, identity_align, vgg)(st, x, m, y)
    fresh = CHN(nb=NB, nf=NF, gc=GC, device="cpu")
    fresh.load_state_dict(chn.state_dict())
    after = serve(chn)
    assert not torch.equal(after, before)
    assert torch.equal(after, serve(fresh))

    with torch.no_grad():  # an optimizer's in-place update, no repack()
        for p in chn.nn.rrdb_trunk.parameters():
            p.mul_(1.5)
    fresh.load_state_dict(chn.state_dict())
    assert torch.equal(serve(chn), serve(fresh))


def test_eval_step_measures_match_jax(rng, setup):
    """The eval step's items, and its PSNR / SSIM against
    ``master_thesis_tpu.ops.measures`` on the same composite."""
    _, chn_params, _, vgg_params = setup
    chn, vgg = _port(chn_params, vgg_params)
    x, m, y = _batch(rng)
    items, y_comp = chn_task.make_eval_step(chn, identity_align, vgg)(
        *(torch.from_numpy(a) for a in (x, m, y)))
    assert set(chn_task.LOSSES_NAMES) <= set(items) and y_comp.shape == (2, 1, H, W, 3)
    t, _ = chn_task.target_ref_indexes(x.shape[1])
    with jax.default_matmul_precision("highest"):
        want_p = float(jmeasures.psnr(jnp.asarray(y_comp[:, 0].numpy()), jnp.asarray(y[:, t])))
        want_s = float(jmeasures.ssim(jnp.asarray(y_comp[:, 0].numpy()), jnp.asarray(y[:, t])))
    np.testing.assert_allclose(items["psnr"].item(), want_p, rtol=1e-5)
    np.testing.assert_allclose(items["ssim"].item(), want_s, rtol=1e-5)
    assert -1 <= items["ssim"].item() <= 1
