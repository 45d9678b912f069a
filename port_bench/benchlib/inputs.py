"""Inputs and weights made from the run's seed, on the device, in a few
large calls.

The frame and mask generators follow chip_smoke.py's ``smooth_frames``
(a seeded colour field bilinearly upsampled from 10 rows, panning a few
pixels a frame) and ``ellipse_mask`` (an elliptic hole), rewritten as
batched tensor code so that they run on the card. Holes cover
``mask_area`` (``Config.min_mask_size`` .. ``max_mask_size``) of a frame.
A traffic mix's ``row_gain`` scales the clips' frames row by row (dark and
bright clips in one batch), spread over any batch size. A step kind
(``port_bench/kinds/``) makes its batches from these.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def subseed(seed: int, tag: str) -> int:
    """A 62-bit seed for the stream ``tag`` of run ``seed``: the streams of
    one run are independent, and any whole number is a valid run seed."""
    return int(hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()[:15], 16)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(subseed(seed, tag))
    return g


def _uniform(g: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def smooth_frames(g, n: int, f: int, h: int, w: int, pan: Tuple[int, int], device) -> torch.Tensor:
    """``(n, f, h, w, 3)`` frames in [0, 1): a colour field of 10 rows
    bilinearly upsampled to ``h`` rows, each item panning a whole number of
    pixels a frame drawn from ``pan`` (inclusive)."""
    cw = w + pan[1] * (f - 1)
    low = torch.rand((n, 3, 10, 10 * cw // h + 2), generator=g, device=device)
    canvas = F.interpolate(low, size=(h, cw), mode="bilinear", align_corners=False)
    step = torch.randint(pan[0], pan[1] + 1, (n, 1), generator=g, device=device)
    start = step * torch.arange(f, device=device)  # (n, f)
    cols = start[:, :, None] + torch.arange(w, device=device)  # (n, f, w)
    idx = cols[:, None, None, :, :].expand(n, 3, h, f, w).reshape(n, 3, h, f * w)
    out = torch.gather(canvas, 3, idx).reshape(n, 3, h, f, w)
    return out.permute(0, 3, 2, 4, 1).contiguous()


def blob_masks(g, n: int, f: int, h: int, w: int, area: Tuple[float, float], device) -> torch.Tensor:
    """``(n, f, h, w, 1)`` hole masks in {0, 1}: one ellipse a frame covering
    a share of the frame drawn from ``area``, aspect 1:2 .. 2:1, wholly
    inside the frame."""
    a = _uniform(g, (n, f), area[0], area[1], device) * h * w
    r = torch.exp(_uniform(g, (n, f), -math.log(2.0), math.log(2.0), device))
    ry = torch.sqrt(a * r / math.pi).clamp(max=h / 2 - 1)
    rx = torch.sqrt(a / (r * math.pi)).clamp(max=w / 2 - 1)
    cy = ry + torch.rand((n, f), generator=g, device=device) * (h - 1 - 2 * ry)
    cx = rx + torch.rand((n, f), generator=g, device=device) * (w - 1 - 2 * rx)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    d = (((yy - cy[..., None, None]) / ry[..., None, None]) ** 2
         + ((xx - cx[..., None, None]) / rx[..., None, None]) ** 2)
    return (d <= 1).float()[..., None]


def clip(g, t: Dict, n: int, f: int, device):
    """``(y, m, x)``: clean frames, hole masks and the masked frames ``y (1 -
    m)`` of ``n`` clips of ``f`` frames at the traffic's size; clip ``i``'s
    frames scaled by ``row_gain[i * len(row_gain) // n]`` where the mix has
    one."""
    h, w = t["height"], t["width"]
    y = smooth_frames(g, n, f, h, w, tuple(t["pan_px"]), device)
    if "row_gain" in t:
        gain = torch.tensor(t["row_gain"], dtype=torch.float32, device=device)
        y = y * gain[torch.arange(n, device=device) * len(gain) // n].reshape(n, 1, 1, 1, 1)
    m = blob_masks(g, n, f, h, w, tuple(t["mask_area"]), device)
    return y, m, y * (1 - m)


def weights(template: Dict[str, torch.Size], seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """Float32 weights for a state dict of ``template``'s names and shapes,
    drawn in one call: each tensor uniform in ``(-b, b)``, ``b = sqrt(3 /
    fan_in)`` with ``fan_in`` its weight's elements over its output
    channels (a bias takes its weight's)."""
    g = generator(seed, f"weights:{tag}", device)
    names = list(template)
    sizes = [math.prod(template[k]) for k in names]
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2).sub_(1)
    out, off = {}, 0
    for k, n in zip(names, sizes):
        shape = tuple(template[k])
        wname = k[: -len("bias")] + "weight" if k.endswith("bias") else k
        wshape = tuple(template.get(wname, shape))
        fan = max(1, math.prod(wshape[1:])) if len(wshape) > 1 else max(1, wshape[0])
        out[k] = flat[off:off + n].view(shape).mul_(math.sqrt(3.0 / fan))
        off += n
    return out
