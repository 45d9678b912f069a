"""TensorBoard logging, step timing and profiling
(master_thesis_tpu/train/logging.py: Logger, StepTimer, maybe_profile).

The reference logs scalars and images through Lightning's TensorBoard
logger (model_dfpn.py:396-456, model_chn.py:393-422); here a thin
tensorboardX writer does the same (PyTorch's own where tensorboardX is not
installed), imported when a :class:`Logger` is made.
:func:`maybe_profile` traces a region with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class Logger:
    def __init__(self, version_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(version_dir)

    def log_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.writer.add_scalar(f"{prefix}{k}", float(v), step)

    def log_images(self, tag: str, images: np.ndarray, step: int):
        """images: (N, H, W, C) float in [0, 1]."""
        self.writer.add_images(tag, images, step, dataformats="NHWC")

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class StepTimer:
    """Mean host time between ticks, the first ``skip_first`` intervals
    (warm-up, the kernels' first builds) left out."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times = []
        self._last = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip_first:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    """With a directory: ``torch.profiler`` over the region (the host, and the
    card when there is one), its trace written to ``profile_dir/trace.json``
    when the region ends. Without: nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
