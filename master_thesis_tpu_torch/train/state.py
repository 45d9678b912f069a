"""Train state and optimizer (master_thesis_tpu/train/state.py: TrainState,
step_lr_schedule, make_optimizer, create_train_state).

Adam with torch's defaults (betas 0.9 / 0.999, eps 1e-8), the update
``optax.adam`` makes, under the reference's StepLR schedule: the learning
rate is ``lr * gamma ** ((count // steps_per_epoch) // step_size)``, with
``count`` the number of updates made before this one. With
``gradient_clip_val > 0`` the gradients are first clipped to that global
norm (``optax.clip_by_global_norm``). Gradient accumulation
(``accumulate_grad_batches``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import torch
from torch import nn


@dataclass
class OptimConfig:
    """The optimizer's settings, with the reference's defaults
    (master_thesis_tpu/config.py)."""

    lr: float = 1e-4
    lr_scheduler_step_size: int = 50
    lr_scheduler_gamma: float = 0.5
    gradient_clip_val: float = 0.0


def step_lr_schedule(
    lr: float, step_size_epochs: int, gamma: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """StepLR on the global update count: ``lr * gamma ** (epoch // step_size)``."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return lr * float(gamma) ** (epoch // step_size_epochs)

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scales ``grads`` in place by ``max_norm / norm`` when their global L2
    norm exceeds ``max_norm``, as ``optax.clip_by_global_norm``. Returns the
    norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclass
class TrainState:
    """The trainable model, its optimizer and schedule, and the update count."""

    model: nn.Module
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    gradient_clip_val: float = 0.0
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients in ``param.grad``: clip, Adam at the
        schedule's learning rate for this count, then drop every packed copy
        of the weights (``repack``) so no forward serves the old ones."""
        params = [p for g in self.optimizer.param_groups for p in g["params"] if p.grad is not None]
        if self.gradient_clip_val > 0:
            clip_by_global_norm_([p.grad for p in params], self.gradient_clip_val)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        for m in self.model.modules():
            if hasattr(m, "repack"):
                m.repack()


def create_train_state(model: nn.Module, cfg, steps_per_epoch: int) -> TrainState:
    """``cfg``: any object with :class:`OptimConfig`'s fields."""
    schedule = step_lr_schedule(
        cfg.lr, cfg.lr_scheduler_step_size, cfg.lr_scheduler_gamma, steps_per_epoch
    )
    params = [p for p in model.parameters() if p.requires_grad]
    # fused: one multi-tensor kernel per step in place of ~10 launches per
    # parameter group slice (the step has ~620 parameters).
    opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, fused=True)
    clip = float(getattr(cfg, "gradient_clip_val", 0.0) or 0.0)
    return TrainState(model, opt, schedule, clip)
