"""The port's train loop, gradient accumulation, checkpoints and logging on
the CPU, against the JAX package where it has the same function
(``train/state.py`` with ``optax.MultiSteps``, ``train/loop.py:Trainer``,
``train/dfpn_task.py:log_alignment_frames``): k = 2 accumulation with
clipping over four micro-steps, the Trainer's order of steps, validations
and checkpoints, a resume that lands mid-accumulation (bit for bit), the
Trainer driving the DFPN step, ``Checkpointer``, ``next_version_dir``,
``Logger``, ``StepTimer`` and ``maybe_profile``."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from master_thesis_tpu.config import Config
from master_thesis_tpu.train import dfpn_task as jdfpn_task
from master_thesis_tpu.train import state as jstate
from master_thesis_tpu.train.loop import Trainer as JaxTrainer
from master_thesis_tpu_torch.models.chn import CHN
from master_thesis_tpu_torch.models.dfpn import DFPN
from master_thesis_tpu_torch.models.vgg import VGGFeatures
from master_thesis_tpu_torch.runtime.spans import span
from master_thesis_tpu_torch.train import chn_task, dfpn_task, state
from master_thesis_tpu_torch.train.checkpoint import (
    Checkpointer,
    next_version_dir,
    restore_from_path,
    restore_train_state,
)
from master_thesis_tpu_torch.train.logging import Logger, StepTimer, maybe_profile
from master_thesis_tpu_torch.train.loop import LoopConfig, Trainer



@pytest.fixture(autouse=True, scope="module")
def _threads():
    """1 intra-op thread: the suite runs several workers at once, and
    small CPU ops spread over every core by each of them wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

class _Loader:
    """``n`` batches whose ``x`` is filled with ``start + i``."""

    def __init__(self, n, start=0):
        self.n, self.start = n, start

    def __iter__(self):
        for i in range(self.n):
            yield {"x": np.full((4, 2), float(self.start + i), np.float32)}

    def __len__(self):
        return self.n


class _Recorder:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.scalars, self.images = [], {}

    def log_scalars(self, scalars, step, prefix=""):
        self.scalars.append((prefix, step, dict(scalars)))

    def log_images(self, tag, images, step):
        self.images[tag] = np.asarray(images)

    def flush(self):
        pass


def identity_align(x_t, m_t, x_r, m_r):
    """The references as they are (tests/test_train_steps.py); jax arrays and
    torch tensors alike."""
    v_aligned = 1 - m_r
    return x_r, v_aligned, (v_aligned - (1 - m_t[:, None])).clip(0, 1)


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_accumulation_matches_optax_multisteps():
    """k = 2 with ``gradient_clip_val > 0`` over four micro-steps, against
    the JAX ``create_train_state`` (``MultiSteps(chain(clip, adam))``):
    after each, the parameters, Adam's moments, the micro-step and update
    counts; the learning rate halves every update (one update an epoch), so
    the schedule must count updates. Tolerance 1e-6 relative: f32 Adam in
    another order."""
    cfg = Config(lr=1e-2, lr_scheduler_step_size=1, lr_scheduler_gamma=0.5,
                 accumulate_grad_batches=2, gradient_clip_val=0.05)
    rng = np.random.RandomState(0)
    init = {"weight": rng.randn(2, 3).astype(np.float32), "bias": rng.randn(2).astype(np.float32)}
    model = torch.nn.Linear(3, 2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    st = state.create_train_state(model, cfg, steps_per_epoch=2)
    jst = jstate.create_train_state(None, {k: jnp.asarray(v) for k, v in init.items()}, cfg,
                                    steps_per_epoch=2)
    lrs = []
    for i in range(4):
        g = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in init.items()}
        # The micro-step's backward adds g to .grad.
        sum((p * torch.from_numpy(g[k])).sum() for k, p in model.named_parameters()).backward()
        assert st.apply_gradients() == (i % 2 == 1)
        jst = jst.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        lrs.append(st.optimizer.param_groups[0]["lr"])
        assert st.step == int(jst.step) == i + 1
        assert st.updates == int(jst.opt_state.gradient_step) == (i + 1) // 2
        adam = _adam(jst.opt_state)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jst.params[k]), rtol=1e-6, atol=1e-8)
            s = st.optimizer.state.get(p) or {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
            np.testing.assert_allclose(s["exp_avg"].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(s["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), rtol=1e-6,
                                       atol=1e-12)
    assert lrs[1] == pytest.approx(1e-2) and lrs[3] == pytest.approx(5e-3)
    assert all(p.grad is None for p in model.parameters())  # the window closed


@pytest.mark.parametrize("val_check_interval,limit_val_batches", [
    (2.0, 1.0),  # every 2 steps and at the epoch's end, all batches
    (0.5, 2.0),  # every half epoch (2 of 5 steps), 2 batches each
    (2.0, 0.0),  # validation off
    (1.0, 2.0),  # the epoch's end only
])
def test_trainer_schedule_matches_jax(tmp_path, val_check_interval, limit_val_batches):
    """2 epochs of 5 steps, 3 validation batches: the order of train steps,
    validation batches and checkpoints against the JAX Trainer's. The port's
    Trainer makes its tensorboardX Logger and writes real checkpoints."""
    want, got = [], []
    cfg = Config(max_epochs=2, default_root_dir=str(tmp_path / "jax"), lr=1e-2, mesh_data=1,
                 val_check_interval=val_check_interval, limit_val_batches=limit_val_batches)

    def j_train(st, x):
        want.append(("train", float(x[0, 0])))
        return st.apply_gradients({"w": jnp.mean(x, axis=0)}), {"loss": jnp.mean(x)}

    def j_eval(params, x):
        want.append(("val", float(x[0, 0])))
        return {"loss": jnp.mean(x)}

    jtrainer = JaxTrainer(cfg, "stub")
    jtrainer.checkpointer.save = lambda step, payload: want.append(("ckpt", step))
    jtrainer.fit(jstate.create_train_state(None, {"w": jnp.zeros(2)}, cfg, steps_per_epoch=5),
                 j_train, lambda b: (b["x"],), _Loader(5), eval_step=j_eval,
                 eval_args=lambda b: (b["x"],), val_loader=_Loader(3, start=100))

    model = torch.nn.Linear(2, 1)

    def p_train(st, x):
        got.append(("train", float(x[0, 0])))
        model(torch.from_numpy(x)).sum().backward()
        st.apply_gradients()
        return {"loss": torch.from_numpy(x).mean()}

    def p_eval(x):
        got.append(("val", float(x[0, 0])))
        return {"loss": torch.from_numpy(x).mean()}

    trainer = Trainer(LoopConfig(max_epochs=2, default_root_dir=str(tmp_path / "port"),
                                 val_check_interval=val_check_interval,
                                 limit_val_batches=limit_val_batches), "stub")
    save = trainer.checkpointer.save

    def record_save(step, payload):
        got.append(("ckpt", step))
        save(step, payload)

    trainer.checkpointer.save = record_save
    st = trainer.fit(state.create_train_state(model, state.OptimConfig(lr=1e-2), steps_per_epoch=5),
                     p_train, lambda b: (b["x"],), _Loader(5), eval_step=p_eval,
                     eval_args=lambda b: (b["x"],), val_loader=_Loader(3, start=100))
    assert got == want
    assert st.step == 10
    assert sorted(os.listdir(trainer.checkpointer.dir)) == ["step_10.pt", "step_5.pt"]
    assert glob.glob(os.path.join(trainer.version_dir, "events.out*"))


def _chn_case(k):
    """A tiny CHN, its train state (k-step accumulation, clipping) and step,
    and 3 seeded batches of 2 x (1 + 1) frames at 32²."""
    chn = CHN(nb=1, nf=16, gc=8, device="cpu", generator=torch.Generator().manual_seed(0))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(1))
    vgg.requires_grad_(False)
    cfg = state.OptimConfig(lr=1e-3, accumulate_grad_batches=k, gradient_clip_val=0.5)
    st = state.create_train_state(chn, cfg, steps_per_epoch=3)
    return st, chn_task.make_train_step(chn, identity_align, vgg)


def _chn_batches():
    rng = np.random.RandomState(2)
    out = []
    for _ in range(3):
        y = rng.rand(2, 2, 32, 32, 3).astype(np.float32)
        m = (rng.rand(2, 2, 32, 32, 1) > 0.8).astype(np.float32)
        out.append({"x": torch.from_numpy((1 - m) * y), "m": torch.from_numpy(m), "y": torch.from_numpy(y)})
    return out


def _fit(st, step, root, epochs):
    trainer = Trainer(LoopConfig(max_epochs=epochs, default_root_dir=root), "chn", logger=_Recorder())
    trainer.fit(st, step, lambda b: (b["x"], b["m"], b["y"]), _chn_batches())
    return trainer


def test_resume_mid_accumulation_is_bit_equal(tmp_path):
    """The CHN step through the Trainer with k = 2 and 3 steps an epoch:
    epoch 1's checkpoint holds an open window (one micro-step's grads). A
    fresh state restored from it runs epoch 2 and ends equal, bit for bit,
    to the uninterrupted run: parameters, Adam's state, the counts. The same
    resume with the window's grads dropped differs."""
    full, step = _chn_case(2)
    _fit(full, step, str(tmp_path / "full"), 2)
    assert (full.step, full.updates, full.micro) == (6, 3, 0)

    half, step = _chn_case(2)
    trainer = _fit(half, step, str(tmp_path / "half"), 1)
    assert (half.step, half.micro) == (3, 1)

    def resumed(drop_window):
        st, step = _chn_case(2)
        restore_train_state(st, trainer.version_dir)
        assert (st.step, st.updates, st.micro) == (3, 1, 1)
        if drop_window:
            for p in st.params():
                p.grad = None
        _fit(st, step, str(tmp_path / f"resumed_{drop_window}"), 2)
        return st

    st = resumed(False)
    assert (st.step, st.updates, st.micro) == (6, 3, 0)
    for (k, a), b in zip(full.model.state_dict().items(), st.model.state_dict().values()):
        assert torch.equal(a, b), k
    for pa, pb in zip(full.params(), st.params()):
        sa, sb = full.optimizer.state[pa], st.optimizer.state[pb]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    lost = resumed(True)
    assert any(not torch.equal(a, b) for a, b in zip(full.params(), lost.params()))


def test_trainer_drives_the_dfpn_step(tmp_path):
    """One epoch of 2 DFPN micro-steps (base 64, 1 x (1 + 1) frames at 64²)
    and its validation: the six items and the total logged at step 1 and
    validated, finite; one checkpoint, which restores."""
    dfpn = DFPN(base_size=64, device="cpu", generator=torch.Generator().manual_seed(5))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2))
    vgg.requires_grad_(False)
    rng = np.random.RandomState(3)
    y = torch.from_numpy(rng.rand(1, 2, 64, 64, 3).astype(np.float32))
    m = torch.from_numpy((rng.rand(1, 2, 64, 64, 1) > 0.8).astype(np.float32))
    flow = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 64, 64, 2)).astype(np.float32))
    batch = ((1 - m) * y, m, y, flow, torch.tensor([True]))
    st = state.create_train_state(dfpn, state.OptimConfig(), steps_per_epoch=2)
    log = _Recorder()
    trainer = Trainer(LoopConfig(max_epochs=1, default_root_dir=str(tmp_path)), "dfpn", logger=log)
    trainer.fit(st, dfpn_task.make_train_step(dfpn, vgg), lambda b: b, [batch, batch],
                eval_step=dfpn_task.make_eval_step(dfpn, vgg), eval_args=lambda b: b, val_loader=[batch])
    names = set(dfpn_task.LOSSES_NAMES) | {"loss"}
    (p_train, s_train, train), (p_val, s_val, val) = log.scalars
    assert (p_train, s_train, p_val, s_val) == ("training/", 1, "validation/", 2)
    assert names <= set(train) and names == set(val)
    assert all(np.isfinite(d[k]) for d in (train, val) for k in names)
    assert st.step == 2 and trainer.checkpointer.latest_step == 2
    assert restore_from_path(trainer.version_dir)["step"] == 2


def test_log_alignment_frames_matches_jax():
    """The image strips the DFPN test mode logs, against the JAX function on
    the same batch (B=2, F=3, 16²) and aligner."""
    rng = np.random.RandomState(4)
    y = rng.rand(2, 3, 16, 16, 3).astype(np.float32)
    m = (rng.rand(2, 3, 16, 16, 1) > 0.7).astype(np.float32)
    x = (1 - m) * y
    want, got = _Recorder(), _Recorder()
    jdfpn_task.log_alignment_frames(want, identity_align, *map(jnp.asarray, (x, m, y)), step=1)
    dfpn_task.log_alignment_frames(got, identity_align, *map(torch.from_numpy, (x, m, y)), step=1)
    assert sorted(got.images) == sorted(want.images) == ["frames/1", "frames/2"]
    for tag, img in want.images.items():
        assert got.images[tag].shape == img.shape == (3, 64, 16, 3)
        np.testing.assert_allclose(got.images[tag], img, atol=1e-6)


def test_checkpointer_keeps_three_and_restores(tmp_path):
    root = str(tmp_path)
    vdir = next_version_dir(root)
    assert vdir.endswith("version_0") and next_version_dir(root).endswith("version_1")
    ck = Checkpointer(vdir)
    assert ck.latest_step is None and ck.restore() is None
    for step in (3, 6, 9, 12, 15):
        ck.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert sorted(os.listdir(ck.dir)) == ["step_12.pt", "step_15.pt", "step_9.pt"]
    assert ck.latest_step == 15 and ck.restore()["step"] == 15
    assert ck.restore(9)["w"].tolist() == [9.0, 9.0]
    assert restore_from_path(vdir)["step"] == restore_from_path(ck.dir)["step"] == 15
    assert restore_from_path(ck.path(12))["step"] == 12
    with pytest.raises(FileNotFoundError):
        restore_from_path(next_version_dir(root))


def test_logger_writes_event_files(tmp_path):
    logger = Logger(str(tmp_path))
    logger.log_scalars({"loss": 1.5, "psnr": 30.0}, step=1, prefix="training/")
    logger.log_images("frames/1", np.random.rand(2, 8, 8, 3).astype(np.float32), 1)
    logger.flush()
    logger.close()
    assert glob.glob(os.path.join(str(tmp_path), "events.out*"))


def test_step_timer_skips_warmup():
    import time

    t = StepTimer(skip_first=1)
    for _ in range(4):
        t.tick()
        time.sleep(0.01)
    # A loaded machine can stretch a 10 ms sleep: only its floor is checked.
    assert 0.005 < t.mean < 5.0
    assert len(t.times) == 2  # 4 ticks, 3 intervals, the first skipped


def test_maybe_profile_noop_and_trace(tmp_path):
    with maybe_profile(None):
        torch.ones(4).sum()
    assert not os.listdir(str(tmp_path))
    with maybe_profile(str(tmp_path / "prof")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert any("mm" in e.get("name", "") for e in json.load(f)["traceEvents"])


def test_maybe_profile_trace_holds_spans(tmp_path):
    """A span entered inside the region is in the written ``trace.json``."""
    with maybe_profile(str(tmp_path / "prof")):
        with span("train.step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert any(e.get("name") == "train.step" for e in json.load(f)["traceEvents"])
