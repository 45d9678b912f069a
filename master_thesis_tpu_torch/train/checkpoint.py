"""Checkpoints (master_thesis_tpu/train/checkpoint.py: next_version_dir,
Checkpointer, restore_train_state, restore_from_path).

The layout is the JAX package's, which mirrors Lightning's versioned runs:

    {root}/version_{n}/checkpoints/step_{k}.pt   (one torch.save file an epoch)
    {root}/version_{n}/events.out...             (tensorboard)

A file holds :meth:`..state.TrainState.state_dict` (the model's and the
optimizer's state, the open accumulation window's grads and its micro-step
count, the update count and the step) and whatever the caller adds. It is
written to a temporary name and renamed, so a file under its step's name is
whole.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, List, Optional

import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def next_version_dir(root: str) -> str:
    """Makes and returns ``root/version_{n}``, n one past the largest there."""
    os.makedirs(root, exist_ok=True)
    existing = [
        int(os.path.basename(p).split("_")[1])
        for p in glob.glob(os.path.join(root, "version_*"))
        if os.path.basename(p).split("_")[-1].isdigit()
    ]
    version = max(existing) + 1 if existing else 0
    path = os.path.join(root, f"version_{version}")
    os.makedirs(path, exist_ok=True)
    return path


def _steps(directory: str) -> List[int]:
    """The steps of the checkpoint files in ``directory``, ascending."""
    found = (_STEP_FILE.match(name) for name in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _load(path: str, map_location) -> Any:
    # weights_only: the files hold tensors, numbers, lists and dicts only.
    return torch.load(path, map_location=map_location, weights_only=True)


class Checkpointer:
    """Saves a payload a step into ``version_dir/checkpoints`` and keeps the
    ``keep`` latest."""

    def __init__(self, version_dir: str, keep: int = 3):
        self.dir = os.path.abspath(os.path.join(version_dir, "checkpoints"))
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def save(self, step: int, payload: Any) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in _steps(self.dir)[:-self.keep]:
            os.remove(self.path(old))

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The payload of ``step`` (default the latest); None if there is none."""
        step = self.latest_step if step is None else step
        return None if step is None else _load(self.path(step), map_location)

    @property
    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None


def restore_from_path(path: str, map_location=None) -> Any:
    """Loads one checkpoint: a ``step_{k}.pt`` file, or the latest in a
    ``checkpoints`` directory or a ``version_{n}`` directory."""
    path = os.path.abspath(path)
    if os.path.isdir(os.path.join(path, "checkpoints")):
        path = os.path.join(path, "checkpoints")
    if os.path.isdir(path):
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no step_*.pt checkpoint in {path}")
        path = os.path.join(path, f"step_{steps[-1]}.pt")
    return _load(path, map_location)


def restore_train_state(state, path: str):
    """Full resume (Lightning's ``resume_from_checkpoint``, reference
    __main__.py:33-42): parameters, Adam moments, the open accumulation
    window, the update count (the schedule's position) and the step, loaded
    into ``state`` in place, which is returned. The checkpoint must come from
    the same model and optimizer configuration."""
    device = next(state.model.parameters()).device
    state.load_state_dict(restore_from_path(path, map_location=device))
    return state
