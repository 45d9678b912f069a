"""Training loop (master_thesis_tpu/train/loop.py: Trainer).

Epochs of ``train_max_iterations`` micro-steps (the loader's length where
it has one) and validation with ``pl.Trainer``'s semantics for
``val_check_interval`` and ``limit_val_batches``; TensorBoard scalars at
step 1 and every 50 steps, the only host sync of a step (the card runs
ahead of the host between them); a checkpoint every epoch; StepLR and
gradient accumulation inside the train state (:mod:`.state`). A resumed
state continues the epoch count from its step, so ``max_epochs`` counts
all epochs, as a Lightning resume does.

On a mesh of processes (:mod:`..parallel.mesh`) every rank runs the same
steps, validations and checkpoint steps (the step count is shared, so each
collective is issued by all at once); the logged items are the sums of the
ranks' contributions (one collective at a logging step and one at the end
of a validation); rank 0 alone logs, prints and writes the checkpoint, and
the others wait for the file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from master_thesis_tpu_torch.parallel.mesh import Mesh, barrier, sum_scalars
from master_thesis_tpu_torch.train.checkpoint import Checkpointer, next_version_dir
from master_thesis_tpu_torch.train.logging import Logger, StepTimer, maybe_profile


@dataclass
class LoopConfig:
    """The loop's settings, with the reference's defaults
    (master_thesis_tpu/config.py)."""

    max_epochs: int = 100
    default_root_dir: str = "./lightning_logs"
    train_max_iterations: int = 2000
    validation_max_iterations: int = 200
    # float < 1: that fraction of the train epoch between validations;
    # > 1: every that many steps; 1.0: at the end of the epoch only.
    val_check_interval: float = 1.0
    # 0: no validation; float < 1: that fraction of the validation epoch;
    # > 1: that many batches; 1.0: all.
    limit_val_batches: float = 1.0
    profile_dir: Optional[str] = None


class Trainer:
    """The epoch loop; tasks supply the steps and the batch adapters.
    ``cfg``: any object with :class:`LoopConfig`'s fields. ``logger``:
    anything with ``log_scalars`` and ``flush``; None makes the tensorboardX
    :class:`..logging.Logger` in the run's version directory. ``mesh``: the
    run's processes (None: this one); on a rank other than 0 there is no
    version directory, logger or checkpointer."""

    def __init__(self, cfg, task_name: str, logger=None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.task_name = task_name
        self.main = mesh is None or mesh.rank == 0
        self.version_dir = self.logger = self.checkpointer = None
        if self.main:
            self.version_dir = next_version_dir(cfg.default_root_dir)
            self.logger = Logger(self.version_dir) if logger is None else logger
            self.checkpointer = Checkpointer(self.version_dir)
            shape = mesh.shape if mesh is not None else {"data": 1, "model": 1}
            print(f"[{task_name}] logging to {self.version_dir}, mesh {shape}")

    def fit(
        self,
        state,
        train_step: Callable,
        step_args: Callable,
        train_loader,
        eval_step: Optional[Callable] = None,
        eval_args: Optional[Callable] = None,
        val_loader=None,
    ):
        """Runs ``train_step(state, *step_args(batch))`` over the loader's
        batches, epoch after epoch, updating ``state`` in place, and
        returns it. ``step_args`` returns the step's tensors on the model's
        device; ``eval_step(*eval_args(batch))`` returns items, or a tuple
        whose first element they are."""
        cfg = self.cfg
        timer = StepTimer()
        global_step = int(state.step)
        steps_per_epoch = len(train_loader) if hasattr(train_loader, "__len__") \
            else cfg.train_max_iterations
        vci = float(cfg.val_check_interval)
        if vci > 1:
            val_every = int(vci)
        elif vci < 1.0:
            val_every = max(1, int(vci * steps_per_epoch))
        else:
            val_every = None
        start_epoch = min(cfg.max_epochs, global_step // max(1, steps_per_epoch))
        with maybe_profile(cfg.profile_dir):
            for epoch in range(start_epoch, cfg.max_epochs):
                step_in_epoch = 0
                for batch in train_loader:
                    items = train_step(state, *step_args(batch))
                    timer.tick()
                    global_step += 1
                    step_in_epoch += 1
                    if global_step % 50 == 0 or global_step == 1:
                        scalars = sum_scalars(items, self.mesh)
                        scalars["step_time_s"] = timer.mean
                        if self.main:
                            self.logger.log_scalars(scalars, global_step, "training/")
                            print(f"[{self.task_name}] epoch {epoch} step {global_step} "
                                  f"loss {scalars['loss']:.4f} ({timer.mean * 1e3:.0f} ms/step)")
                    if (
                        val_every is not None
                        and step_in_epoch % val_every == 0
                        and step_in_epoch < steps_per_epoch
                    ):
                        self._validate(eval_step, eval_args, val_loader, epoch, global_step)

                self._validate(eval_step, eval_args, val_loader, epoch, global_step)
                if self.main:
                    self.checkpointer.save(global_step, state.state_dict())
                    self.logger.flush()
                barrier(self.mesh)
        return state

    def _validate(self, eval_step, eval_args, val_loader, epoch, global_step):
        if eval_step is None or val_loader is None:
            return
        lvb = float(self.cfg.limit_val_batches)
        if lvb <= 0:
            return
        n_total = len(val_loader) if hasattr(val_loader, "__len__") \
            else self.cfg.validation_max_iterations
        max_batches = int(lvb) if lvb > 1 else (
            n_total if lvb == 1.0 else max(1, int(lvb * n_total))
        )
        agg: Dict[str, list] = {}
        for i, batch in enumerate(val_loader):
            if i >= max_batches:
                break
            out = eval_step(*eval_args(batch))
            items = out[0] if isinstance(out, tuple) else out
            for k, v in items.items():
                agg.setdefault(k, []).append(float(v))
        val_scalars = sum_scalars({k: float(np.mean(v)) for k, v in agg.items()}, self.mesh)
        if self.main:
            self.logger.log_scalars(val_scalars, global_step, "validation/")
            print(f"[{self.task_name}] epoch {epoch} validation "
                  + " ".join(f"{k}={v:.4f}" for k, v in val_scalars.items()))
