"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, with each fault a cell can have planted in the
program."""

import functools

import pytest
import torch

from port_bench.benchlib.runner import run
from port_bench.tests.conftest import tiny

SEED = 2**31 + 77


def _run(workload):
    traffic, cli = tiny(workload)
    return run(workload, SEED, 0.2, False, device="cpu", cli=cli, traffic=traffic)


@pytest.mark.parametrize("workload", ["cpn_serve_b16", "dfpn_serve_b4", "cpn_train_b32"])
def test_a_sound_run_is_correct(workload):
    assert _run(workload)["correct"]


def _serve_fault(monkeypatch, fault):
    from master_thesis_tpu_torch.train import build

    real = build.chn_infer_fn

    def infer_fn(chn, kernels=True):
        fn = real(chn, kernels=kernels)

        def broken(x_t, v_t, xa, va, vm):
            if fault == "half_batch":
                h = x_t.shape[0] // 2
                y, yc = fn(x_t[:h], v_t[:h], xa[:h], va[:h], vm[:h])
                return torch.cat([y, y]), torch.cat([yc, yc])
            y, yc = fn(x_t, v_t, xa, va, vm)
            yc = yc.clone()
            yc[0, 0, :4, :4] += 0.25  # an answer altered where it is produced
            return y, yc
        return broken

    monkeypatch.setattr(build, "chn_infer_fn", infer_fn)


@pytest.mark.parametrize("workload", ["cpn_serve_b16", "dfpn_serve_b4"])
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_serving_fault_is_caught(monkeypatch, workload, fault):
    _serve_fault(monkeypatch, fault)
    assert not _run(workload)["correct"]


def _train_fault(monkeypatch, fault):
    from master_thesis_tpu_torch.train import chn_task, state

    if fault == "unchanged":
        def skip(self):
            self.step += 1
            self.optimizer.zero_grad(set_to_none=True)
            return True
        monkeypatch.setattr(state.TrainState, "apply_gradients", skip)
    else:
        real_make = chn_task.make_train_step

        @functools.wraps(real_make)
        def make(*args, **kw):
            step = real_make(*args, **kw)

            def half(state, *batch):  # half of the batch left out, the mean over the rest
                return step(state, *(t[: t.shape[0] // 2] for t in batch))
            return half
        monkeypatch.setattr(chn_task, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_training_fault_is_caught(monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    assert not _run("cpn_train_b32")["correct"]
