"""Full-video inpainting algorithms (master_thesis_tpu/infer/algorithms.py:
FILL_COLOR, get_indexes_ff, get_indexes_ip, Inpainter).

Three ways to inpaint every frame of a sequence with the CHN, each a loop
of refine rounds (reference model_chn.py:87-254):

- ``inpaint_ff`` (frame by frame): each frame walks its own candidate
  list (``get_indexes_ff``) against the raw sequence until its hole is
  below ``e`` percent or its candidates run out. Each round gathers up to
  ``C`` eligible frames, in index order, into one batch.
- ``inpaint_ip`` (inpaint and propagate): frames in centre-out order,
  already inpainted frames first among the candidates, one frame at a time.
- ``inpaint_cp`` (copy and propagate): ``N`` passes of alternating frame
  parity; each (pass, +-s) half-step refines the frames of that parity
  class whose neighbour is in range and which still have a hole.

One refine round (:meth:`Inpainter._refine`) is the reference's exactly:
align the references, run the CHN, shrink the mask by the visibility map,
refill with the composite and the gray ``FILL_COLOR``.

The JAX package compiles each loop into one device program over index
tables, padded to static shapes: frame counts to a bucket, every batch to
``C`` slots with inert ones. Here the loops run on the host over tensors
that stay on the device; a batch holds only the frames a round updates,
which leaves every frame's result as it is. The host reads each round's
hole sizes with one small copy (a sync with the card), counted in
``Inpainter.syncs``. The ``*_host`` twins are the JAX package's readable
host loops, kept as references.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

from master_thesis_tpu_torch.device import constant, resolve_device

FILL_COLOR = (0.485, 0.456, 0.406)


def get_indexes_ff(t: int, max_t: int, s: int = 1, D: int = 20) -> List[int]:
    """Reference-frame candidate order for frame ``t``
    (reference model_chn.py:459-482)."""
    cands = [i for i in range(max_t) if i != t]
    cands = [r for _, r in sorted((abs(i - t), i) for i in cands)]
    return [i for i in cands if abs(i - t) <= D and abs(i - t) % s == 0]


def get_indexes_ip(t: int, t_list: List[int], s: int, D: int) -> List[int]:
    """Candidates for inpaint-and-propagate: already-inpainted frames first
    (reference model_chn.py:484-503)."""
    inpainted = list(reversed(t_list[: t_list.index(t)]))
    ff = get_indexes_ff(t, len(t_list), s, D)
    return inpainted + [i for i in ff if i not in inpainted]


def _bucket(n: int, step: int = 8) -> int:
    """The JAX package's frame-count bucket (a multiple of ``step``); ff's
    batch width is defined from it."""
    return max(step, -(-n // step) * step)


def _gather(t: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
    """Frames ``idx`` of ``t`` as one batch (views stacked on the device: no
    index tensor crosses from the host)."""
    return torch.stack([t[i] for i in idx])


def _scatter(t: torch.Tensor, idx: Sequence[int], src: torch.Tensor) -> None:
    for j, i in enumerate(idx):
        t[i] = src[j]


class Inpainter:
    """Drives the three algorithms over one sequence.

    Args:
        chn_apply: ``(x_t, v_t, x_refs, v_refs, v_maps) -> (y_hat,
            y_hat_comp)``, e.g. ``train.build.chn_infer_fn(chn)``.
        align_fn: ``(x_t, m_t, x_r, m_r) -> (x_aligned, v_aligned,
            v_map)``, e.g. ``CPN.align``.
        device: where the sequence lives; ``None`` means ``cuda``.

    ``refined`` counts the frames that went through the CHN, ``syncs`` the
    host's reads of loop-control values from the device.
    """

    def __init__(self, chn_apply: Callable, align_fn: Callable, device=None):
        self.chn_apply = chn_apply
        self.align_fn = align_fn
        self.device = resolve_device(device)
        self.refined = 0
        self.syncs = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _read(self, t: torch.Tensor) -> List[float]:
        """A small device tensor on the host: one sync."""
        self.syncs += 1
        return t.tolist()

    def _refine(self, x_tgt, m_tgt, x_ref, m_ref, active=None):
        """One masked refinement round over a batch of target frames.

        x_tgt: (N, H, W, 3); m_tgt: (N, H, W, 1); x_ref / m_ref like the
        targets; active: (N,) bool, the frames to update (None: all).
        Returns ``(x_out, m_out, comp_out, hole_pct)``."""
        fill = constant(FILL_COLOR, x_tgt.dtype, x_tgt.device)
        xa, va, vm = self.align_fn(x_tgt, m_tgt, x_ref[:, None], m_ref[:, None])
        _, y_hat_comp = self.chn_apply(x_tgt, 1 - m_tgt, xa, va, vm)
        self.refined += x_tgt.shape[0]
        comp = y_hat_comp[:, 0]
        m_out = m_tgt - vm[:, 0]
        x_out = (1 - m_out) * comp + m_out * fill
        if active is not None:
            act = active[:, None, None, None]
            x_out = torch.where(act, x_out, x_tgt)
            m_out = torch.where(act, m_out, m_tgt)
            comp = torch.where(act, comp, x_tgt)
        hole_pct = 100.0 * m_out.sum(dim=(1, 2, 3)) / (m_out.shape[1] * m_out.shape[2])
        return x_out, m_out, comp, hole_pct

    @staticmethod
    def _out(y: torch.Tensor, as_numpy: bool):
        return y.cpu().numpy() if as_numpy else y

    # ------------------------------------------------------------------ ff

    @torch.inference_mode()
    def inpaint_ff(self, x, m, s: int = 1, D: int = 20, e: float = 1.0,
                   as_numpy: bool = True, compact: int = 0):
        """Frame by frame (reference :87-135). x: (F, H, W, 3); m:
        (F, H, W, 1), numpy or tensors. Returns (F, H, W, 3), numpy unless
        ``as_numpy=False``.

        Each frame keeps a pointer into its own candidate list; a frame is
        eligible while it has no composite yet or its hole is above ``e``,
        and candidates remain. Each round refines the first ``C = compact
        or min(bucket(F), 8)`` eligible frames (the JAX schedule, whose
        ``jnp.nonzero(size=C)`` picks them in index order) against each
        frame's next candidate from the raw sequence."""
        x, m = self._tensor(x), self._tensor(m)
        F = x.shape[0]
        C = compact or min(_bucket(F), 8)
        cands = [get_indexes_ff(t, F, s, D) for t in range(F)]
        x_tgt, m_tgt, y_out = x.clone(), m.clone(), x.clone()
        have, hole, kptr = [False] * F, [math.inf] * F, [0] * F
        while True:
            idx = [t for t in range(F)
                   if (not have[t] or hole[t] > e) and kptr[t] < len(cands[t])][:C]
            if not idx:
                break
            refs = [cands[t][kptr[t]] for t in idx]
            xb, mb, comp, hole_b = self._refine(
                _gather(x_tgt, idx), _gather(m_tgt, idx), _gather(x, refs), _gather(m, refs))
            _scatter(x_tgt, idx, xb)
            _scatter(m_tgt, idx, mb)
            _scatter(y_out, idx, comp)
            for t, hb in zip(idx, self._read(hole_b)):
                hole[t], have[t] = hb, True
                kptr[t] += 1
        return self._out(y_out, as_numpy)

    @torch.inference_mode()
    def inpaint_ff_host(self, x, m, s: int = 1, D: int = 20, e: float = 1.0,
                        compact: int = 0) -> np.ndarray:
        """Host-loop twin of :meth:`inpaint_ff` (one refine of the whole
        sequence per candidate offset). ``compact`` is accepted for
        signature parity and ignored: ff frames are independent."""
        x_dev, m_dev = self._tensor(x), self._tensor(m)
        F = x_dev.shape[0]
        x_tgt, m_tgt, y_out = x_dev, m_dev, x_dev
        have_comp = np.zeros(F, bool)
        hole = np.full(F, np.inf, np.float32)

        offsets: List[int] = []
        for d in range(s, D + 1, s):
            offsets += [-d, d]

        idx = np.arange(F)
        valid_all = np.stack([(idx + o >= 0) & (idx + o < F) for o in offsets])
        valid_ahead = np.flip(np.logical_or.accumulate(np.flip(valid_all, 0), 0), 0)
        for k, off in enumerate(offsets):
            ref_idx = idx + off
            unfinished = ~have_comp | (hole > e)
            # End only when no unfinished frame has a candidate in any
            # remaining round; skip an empty round.
            if not (valid_ahead[k] & unfinished).any():
                break
            active = valid_all[k] & unfinished
            if not active.any():
                continue
            ref_c = np.clip(ref_idx, 0, F - 1).tolist()
            act = torch.as_tensor(active, device=self.device)
            x_tgt, m_tgt, comp, hole_dev = self._refine(
                x_tgt, m_tgt, x_dev[ref_c], m_dev[ref_c], act)
            y_out = torch.where(act[:, None, None, None], comp, y_out)
            have_comp |= active
            hole = np.asarray(self._read(hole_dev), np.float32)
        return y_out.cpu().numpy()

    # ------------------------------------------------------------------ ip

    @torch.inference_mode()
    def inpaint_ip(self, x, m, s: int = 1, D: int = 20, e: float = 1.0,
                   as_numpy: bool = True):
        """Inpaint and propagate (reference :137-191): frames in centre-out
        order, each refined against its candidates (already inpainted frames
        first) while ``k == 0 or (k < n and hole > e)``; then the frame's
        output is its last composite and its mask is zeroed. One frame a
        round: each frame's first candidate is the one inpainted before it."""
        x, m = self._tensor(x), self._tensor(m)
        F = x.shape[0]
        t_list = sorted(range(F), key=lambda i: abs(i - F // 2))
        y_inp, m_inp = x.clone(), m.clone()
        for t in t_list:
            cands = get_indexes_ip(t, t_list, s, D)
            x_t, m_t = y_inp[t: t + 1], m_inp[t: t + 1]
            k, hole = 0, math.inf
            while k == 0 or (k < len(cands) and hole > e):
                r = cands[k] if k < len(cands) else 0  # the JAX table's zero fill
                x_t, m_t, comp, hole_d = self._refine(
                    x_t, m_t, y_inp[r: r + 1], m_inp[r: r + 1])
                k += 1
                if k < len(cands):  # the hole decides only while candidates remain
                    hole = self._read(hole_d)[0]
            y_inp[t] = comp[0]
            m_inp[t] = 0
        return self._out(y_inp, as_numpy)

    @torch.inference_mode()
    def inpaint_ip_host(self, x, m, s: int = 1, D: int = 20, e: float = 1.0) -> np.ndarray:
        """Host-loop twin of :meth:`inpaint_ip` (one refine per candidate,
        frames copied through host memory)."""
        y_inp = np.array(x, dtype=np.float32, copy=True)
        m_inp = np.array(m, dtype=np.float32, copy=True)
        F = y_inp.shape[0]
        t_list = sorted(range(F), key=lambda i: abs(i - F // 2))
        for t in t_list:
            cands = get_indexes_ip(t, t_list, s, D)
            comp = None
            hole = np.inf
            while (cands and hole > e) or comp is None:
                r = cands.pop(0)
                x_t, m_t, comp_d, hole_d = self._refine(
                    self._tensor(y_inp[t: t + 1]), self._tensor(m_inp[t: t + 1]),
                    self._tensor(y_inp[r: r + 1]), self._tensor(m_inp[r: r + 1]))
                y_inp[t] = x_t[0].cpu().numpy()
                m_inp[t] = m_t[0].cpu().numpy()
                comp = comp_d[0].cpu().numpy()
                hole = self._read(hole_d)[0]
            m_inp[t] = 0
            y_inp[t] = comp
        return y_inp

    # ------------------------------------------------------------------ cp

    @staticmethod
    def _cp_targets(F: int, s: int) -> List[List[int]]:
        """The static target list of each (parity, direction) half-step,
        index ``2 * parity + (d == +s)``: frames of the parity class whose
        neighbour ``t + d`` is in range (``modulus = s if s > 1 else 2``)."""
        modulus = s if s > 1 else 2
        return [[t for t in range(F) if (t // s) % modulus == p and 0 <= t + d < F]
                for p in (0, 1) for d in (-s, s)]

    @torch.inference_mode()
    def inpaint_cp(self, x, m, N: int = 20, s: int = 1, e: float = 1.0,
                   as_numpy: bool = True):
        """Copy and propagate (reference :193-254): passes ``i < N`` while
        ``i <= 1`` or some frame has a hole; pass ``i`` runs the half-steps
        ``-s`` then ``+s`` of parity ``i % 2``. A half-step refines the
        targets of its static list that still have a hole against their
        neighbour ``t + d``, and finalizes those whose hole fell below
        ``e`` or that are in the last two passes (output the composite,
        mask zeroed). Frames' holes are read once per half-step."""
        x, m = self._tensor(x), self._tensor(m)
        F = x.shape[0]
        lists = self._cp_targets(F, s)
        y_inp, m_inp = x.clone(), m.clone()
        holes = self._read(m_inp.sum(dim=(1, 2, 3)))
        i = 0
        while i < N and (i <= 1 or any(h > 0 for h in holes)):
            for d_i, d in enumerate((-s, s)):
                act = [t for t in lists[2 * (i % 2) + d_i] if holes[t] > 0]
                if not act:
                    continue
                refs = [t + d for t in act]
                x_t, m_t, comp, hole_pct = self._refine(
                    _gather(y_inp, act), _gather(m_inp, act),
                    _gather(y_inp, refs), _gather(m_inp, refs))
                fin = ((hole_pct < e) | (i >= N - 2))[:, None, None, None]
                _scatter(y_inp, act, torch.where(fin, comp, x_t))
                _scatter(m_inp, act, torch.where(fin, 0.0, m_t))
                holes = self._read(m_inp.sum(dim=(1, 2, 3)))
            i += 1
        return self._out(y_inp, as_numpy)

    @torch.inference_mode()
    def inpaint_cp_host(self, x, m, N: int = 20, s: int = 1, e: float = 1.0) -> np.ndarray:
        """Host-loop twin of :meth:`inpaint_cp` (one refine of the whole
        sequence per half-step)."""
        y_inp, m_inp = self._tensor(x), self._tensor(m)
        F = y_inp.shape[0]
        idx = np.arange(F)

        for i in range(N):
            parity = [(t // s) % (s if s > 1 else 2) == i % 2 for t in range(F)]
            holes = np.asarray(self._read(m_inp.sum(dim=(1, 2, 3))))
            for delta in (-s, s):
                ref_idx = idx + delta
                valid = (ref_idx >= 0) & (ref_idx < F)
                active = np.asarray(parity) & valid & (holes > 0)
                if not active.any():
                    continue
                ref_c = np.clip(ref_idx, 0, F - 1).tolist()
                x_t, m_t, comp, hole_pct = self._refine(
                    y_inp, m_inp, y_inp[ref_c], m_inp[ref_c],
                    torch.as_tensor(active, device=self.device))
                finalize = active & ((np.asarray(self._read(hole_pct)) < e) | (i >= N - 2))
                fin = torch.as_tensor(finalize, device=self.device)[:, None, None, None]
                y_inp = torch.where(fin, comp, x_t)
                m_inp = torch.where(fin, 0.0, m_t)
                holes = np.asarray(self._read(m_inp.sum(dim=(1, 2, 3))))
            if not np.any(holes > 0) and i >= 1:
                break
        return y_inp.cpu().numpy()
