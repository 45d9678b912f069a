"""Train state and optimizer (master_thesis_tpu/train/state.py: TrainState,
step_lr_schedule, make_optimizer, create_train_state).

Adam with torch's defaults (betas 0.9 / 0.999, eps 1e-8), the update
``optax.adam`` makes, under the reference's StepLR schedule: the learning
rate is ``lr * gamma ** ((count // steps_per_epoch) // step_size)``, with
``count`` the number of updates made before this one. With
``gradient_clip_val > 0`` the gradients are first clipped to that global
norm (``optax.clip_by_global_norm``). With ``accumulate_grad_batches = k``
an update is made every k micro-steps from the mean of their gradients,
clipped as a whole, as ``optax.MultiSteps`` wraps the chain; the schedule
then counts updates, ``steps_per_epoch // k`` an epoch. On a mesh of
processes the window's summed grads are summed over the world at each
update, once (:func:`..parallel.all_reduce_grads`): each rank's grads are
those of its numerator over the whole batch's denominator, so the sum is
the one-process gradient, and every rank applies the same update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
from torch import nn

from master_thesis_tpu_torch.parallel import mesh as mesh_lib


@dataclass
class OptimConfig:
    """The optimizer's settings, with the reference's defaults
    (master_thesis_tpu/config.py)."""

    lr: float = 1e-4
    lr_scheduler_step_size: int = 50
    lr_scheduler_gamma: float = 0.5
    gradient_clip_val: float = 0.0
    accumulate_grad_batches: int = 1


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
    """The trainable model, its optimizer and schedule, and the counts:
    ``step`` micro-steps (JAX's ``state.step``), ``updates`` optimizer
    updates (the schedule's count), ``micro`` micro-steps whose gradients
    ``param.grad`` holds, summed, since the last update. ``mesh``: the
    processes whose grads an update sums (None: this one)."""

    model: nn.Module
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    gradient_clip_val: float = 0.0
    accumulate_grad_batches: int = 1
    step: int = 0
    updates: int = 0
    micro: int = 0
    mesh: Optional[mesh_lib.Mesh] = None

    def params(self) -> List[torch.Tensor]:
        """The optimizer's parameters, in its order (a checkpoint's grads')."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self) -> bool:
        """Ends a micro-step whose backward added its gradients to
        ``param.grad``. On every ``accumulate_grad_batches``-th: their sum
        over the mesh's processes, their mean over the window, clipped, then
        Adam at the schedule's learning rate for this update's count; the
        grads are dropped, which opens the next
        window, and so is every packed copy of the weights (``repack``), so
        no forward serves the old ones. Returns whether it updated."""
        self.step += 1
        self.micro += 1
        if self.micro < self.accumulate_grad_batches:
            return False
        params = [p for p in self.params() if p.grad is not None]
        mesh_lib.all_reduce_grads(params, self.mesh)
        grads = [p.grad for p in params]
        if self.accumulate_grad_batches > 1:
            torch._foreach_div_(grads, float(self.accumulate_grad_batches))
        if self.gradient_clip_val > 0:
            clip_by_global_norm_(grads, self.gradient_clip_val)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1
        self.micro = 0
        self._repack()
        return True

    def _repack(self) -> None:
        for m in self.model.modules():
            if hasattr(m, "repack"):
                m.repack()

    def state_dict(self) -> dict:
        """What a resume needs: the model's and the optimizer's state, the
        open window's summed grads (``None`` for a parameter without one) and
        the three counts."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "grads": [p.grad for p in self.params()], "micro": self.micro,
                "updates": self.updates, "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        params = self.params()
        if len(sd["grads"]) != len(params):
            raise ValueError(f"the checkpoint holds {len(sd['grads'])} grads, the optimizer "
                             f"{len(params)} parameters")
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        for p, g in zip(params, sd["grads"]):
            p.grad = None if g is None else g.to(p.device)
        self.micro, self.updates, self.step = int(sd["micro"]), int(sd["updates"]), int(sd["step"])
        self._repack()


def create_train_state(model: nn.Module, cfg, steps_per_epoch: int,
                       mesh: Optional[mesh_lib.Mesh] = None) -> TrainState:
    """``cfg``: any object with :class:`OptimConfig`'s fields. The model's
    grads are dropped: the first window starts empty. ``mesh``: see
    :class:`TrainState`."""
    k = max(1, int(cfg.accumulate_grad_batches))
    schedule = step_lr_schedule(
        cfg.lr, cfg.lr_scheduler_step_size, cfg.lr_scheduler_gamma, max(1, steps_per_epoch // k)
    )
    params = [p for p in model.parameters() if p.requires_grad]
    # fused: one multi-tensor kernel per step in place of ~10 launches per
    # parameter group slice (the step has ~620 parameters).
    opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, fused=True)
    opt.zero_grad(set_to_none=True)
    clip = float(getattr(cfg, "gradient_clip_val", 0.0) or 0.0)
    return TrainState(model, opt, schedule, clip, k, mesh=mesh)
