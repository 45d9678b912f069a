"""The precisions the reference computes in: the reference itself (float32,
TF32 off), the witness (the configuration's own compute dtype) and the
control (the next precision below it, named by the configuration's
``control``, which the comparison has to refuse), each a rounding of every
product's operands and result (:mod:`.nets`)."""

from __future__ import annotations

import contextlib
import functools

import torch

from port_bench.reference.nets import ident

# float8 e4m3's largest finite value: larger magnitudes saturate to it.
_LARGEST = {torch.float8_e4m3fn: 448.0}


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, as float32; its gradient passes unrounded
    (the backward's products then read the rounded operands, as a step in
    ``dtype`` does)."""
    top = _LARGEST.get(dtype)
    src = t.detach() if top is None else t.detach().clamp(-top, top)
    r = src.to(dtype).to(torch.float32)
    return t + (r - t.detach()) if t.requires_grad else r


def quantizer(name: str):
    """The rounding of precision ``name`` (``"float32"``: none)."""
    return ident if name == "float32" else functools.partial(_round, dtype=getattr(torch, name))


@contextlib.contextmanager
def reference_mode():
    """float32 products with TF32 off, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
