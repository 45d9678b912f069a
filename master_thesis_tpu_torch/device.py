"""Device choice for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU;
without a card and without that request it raises instead of falling back.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # usable in training after serving
        return torch.tensor(values, dtype=dtype, device=device)


def constant(values: Sequence, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor on ``device``, made once per (values, dtype,
    device) and shared: a copy from host memory to the card waits for the
    card to finish its queue, so the step's code must not make one per
    call. Callers must not modify it."""
    return _constant(tuple(values), dtype, torch.device(device))
