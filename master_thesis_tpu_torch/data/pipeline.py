"""Host data pipeline (master_thesis_tpu/data/pipeline.py: ContentProvider,
InpaintingDataset, Loader; reference dataset.py and its DataLoader).

Numpy on host threads or worker processes: decode, window sampling,
movement simulation, mask dilation and gray-fill compositing all happen on
the CPU, and the loader hands out fixed-shape float32 numpy batches
``(B, F, H, W, C)``, which the caller copies to the device once a step.
Nothing here touches ``torch.cuda`` or builds a kernel; torch only carries
a worker process's batch to the caller in shared memory.

Randomness is explicit: every item draw takes a ``numpy.random.RandomState``
derived from ``(seed, epoch, item)`` instead of the reference's global
process-wide reseeding (data.py:195-203), so a batch is a pure function of
them: thread and process workers give the same bits, and so does the JAX
package's loader on the same tree.

Layouts: backgrounds ``(F, H, W, 3)`` float32 in [0, 1]; masks
``(F, H, W, 1)`` float32 binary; flows ``(F, H, W, 2)``.
"""

from __future__ import annotations

import copy
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from master_thesis_tpu_torch.data.decode import decode_background, decode_mask, dilate_np
from master_thesis_tpu_torch.ops.interp import resize_hw_np
from master_thesis_tpu_torch.ops.movements import MovementSimulator, crop_flow_np
from master_thesis_tpu_torch.runtime import native

FILL_COLOR = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)


def _resize_keep_ratio(img: np.ndarray, size, mode="bilinear") -> np.ndarray:
    """Reference TransformsUtils.resize keep_ratio branch incl. the
    ``size=(H', -1)`` drop-last-column quirk (utils.py:485-491)."""
    h, w = img.shape[-3], img.shape[-2]
    if size[1] == -1:
        new_size = (size[0], round(w * size[0] / h))
        out = resize_hw_np(img, new_size, mode=mode)
        return out[..., : size[0], : size[1], :]
    new_h = size[0] if h < w else round(h * size[1] / w)
    new_w = size[1] if w <= h else round(w * size[0] / h)
    out = resize_hw_np(img, (new_h, new_w), mode=mode)
    return out[..., : size[0], : size[1], :]


class ContentProvider:
    """Flat frame index over sequences of backgrounds and/or masks
    (reference dataset.py:222-605)."""

    def __init__(
        self,
        dataset_meta: Dict[str, Tuple[Optional[list], Optional[list]]],
        data_path: str,
        movement_min_height: int = -1,
        movement_simulator: Optional[MovementSimulator] = None,
        frames_spacing: int = 10,
        frames_randomize: bool = True,
    ):
        self.dataset_meta = dataset_meta
        self.data_path = data_path
        self.movement_min_height = movement_min_height
        self.movement_simulator = movement_simulator
        self.frames_spacing = frames_spacing
        self.frames_randomize = frames_randomize
        self.items_names = list(dataset_meta.keys())
        self.items_limits = np.cumsum(
            [
                len(dataset_meta[n][0])
                if dataset_meta[n][0] is not None
                else len(dataset_meta[n][1])
                for n in self.items_names
            ]
        )

    def __len__(self) -> int:
        return int(self.items_limits[-1])

    def len_sequences(self) -> int:
        return len(self.items_names)

    # -- decoding -----------------------------------------------------------

    def _decode_bg(self, rel_path: str, min_hw=None) -> np.ndarray:
        """``min_hw=(h, w)``: the caller will resize the frame down to at
        most this size, so the native codec may decode at a reduced DCT
        scale that still covers it (:func:`.decode.decode_background`)."""
        return decode_background(os.path.join(self.data_path, rel_path), min_hw=min_hw)

    def _decode_mask(self, rel_path: str) -> np.ndarray:
        return decode_mask(os.path.join(self.data_path, rel_path))

    def _locate(self, item: int) -> Tuple[int, int]:
        seq = int(np.searchsorted(self.items_limits, item, side="right"))
        first = int(self.items_limits[seq - 1]) if seq > 0 else 0
        return seq, item - first

    def get_frame(self, item: int, bg_min_hw=None):
        """Single frame -> ``(bg | None, mask | None, name)``."""
        seq, fi = self._locate(item)
        name = self.items_names[seq]
        bg_paths, mask_paths = self.dataset_meta[name]
        y = (
            self._decode_bg(bg_paths[fi], min_hw=bg_min_hw)
            if bg_paths is not None
            else None
        )
        m = self._decode_mask(mask_paths[fi]) if mask_paths is not None else None
        return y, m, name

    def get_items(self, frames_indexes: list, bg_min_hw=None):
        ys, ms = [], []
        for i in frames_indexes:
            y, m, _ = self.get_frame(i, bg_min_hw=bg_min_hw)
            ys.append(y)
            ms.append(m)
        y = np.stack(ys) if ys[0] is not None else None
        m = np.stack(ms) if ms[0] is not None else None
        return y, m

    # -- sequence / patch sampling -----------------------------------------

    def get_sequence(self, sequence_index: int, decode_size=None):
        """Full clip for test-time inpainting (reference dataset.py:372-409).

        ``decode_size``: the working resolution the caller resizes to
        (image-resize mode) — lets the native JPEG path decode at a reduced
        DCT scale that still covers it."""
        first = int(self.items_limits[sequence_index - 1]) if sequence_index > 0 else 0
        last = int(self.items_limits[sequence_index]) - 1
        frames_indexes = list(range(first, last + 1))
        y, m = self.get_items(frames_indexes, bg_min_hw=decode_size)
        ref = y if y is not None else m
        gt_movement = np.zeros((len(frames_indexes), ref.shape[1], ref.shape[2], 2), np.float32)
        m_movement = (
            np.zeros((len(frames_indexes), m.shape[1], m.shape[2], 2), np.float32)
            if m is not None
            else gt_movement
        )
        return y, m, self.items_names[sequence_index], frames_indexes, gt_movement, m_movement

    def get_patch(
        self, frame_index: int, frames_n: int, use_simulator: bool, rng,
        out_size=None, decode_size=None,
    ):
        """``out_size``: evaluate the simulator warp directly at this
        resolution (fast-simulator mode). ``decode_size``: the working
        resolution the caller resizes contiguous patches to (image-resize
        mode) — enables DCT-scaled JPEG decode on the contiguous path
        (the simulated path keeps full-size decode: its warp samples the
        stored frame, so reducing the source would change the fast-
        simulator deviation bound)."""
        if use_simulator and self.movement_simulator is not None:
            return self._get_patch_simulated(frame_index, frames_n, rng, out_size)
        return self._get_patch_contiguous(
            frame_index, frames_n, rng, decode_size=decode_size
        )

    def get_patch_random(
        self, frames_n: int, use_simulator: bool, rng, out_size=None,
        decode_size=None,
    ):
        return self.get_patch(
            rng.randint(0, len(self)), frames_n, use_simulator, rng, out_size,
            decode_size,
        )

    def _get_patch_contiguous(
        self, frame_index: int, frames_n: int, rng, decode_size=None
    ):
        """Window of frames around a center (reference dataset.py:473-561)."""
        if not (frames_n % 2 == 1 or frames_n == 2):
            raise ValueError("frames_n must be 2 or an odd number")
        seq, _ = self._locate(frame_index)
        first = int(self.items_limits[seq - 1]) if seq > 0 else 0
        last = int(self.items_limits[seq]) - 1

        spacing = self.frames_spacing
        pre = [max(i, first) for i in range(frame_index - (frames_n // 2) * spacing, frame_index)]
        post = [
            min(i, last)
            for i in range(frame_index + 1, frame_index + (frames_n // 2) * spacing + 1)
        ]

        if self.frames_randomize:
            candidates = set(pre) | set(post)
            candidates.discard(frame_index)
            chosen = sorted(rng.choice(sorted(candidates), frames_n - 1, replace=False).tolist())
            frames_indexes = chosen[: frames_n // 2] + [frame_index] + chosen[frames_n // 2 :]
        else:
            before = pre[::spacing]
            after = post[::spacing] if frames_n > 2 else []
            frames_indexes = before + [frame_index] + after

        y, m = self.get_items(frames_indexes, bg_min_hw=decode_size)
        ref = y if y is not None else m
        gt_movement = np.zeros((len(frames_indexes), ref.shape[1], ref.shape[2], 2), np.float32)
        m_movement = (
            np.zeros((len(frames_indexes), m.shape[1], m.shape[2], 2), np.float32)
            if m is not None
            else None
        )
        return y, m, self.items_names[seq], frames_indexes, gt_movement, m_movement

    def _get_patch_simulated(
        self, frame_index: int, frames_n: int, rng, out_size=None
    ):
        """Single frame + synthetic camera path (reference dataset.py:563-605).

        ``out_size``: when the caller resizes the patch to a fixed working
        resolution anyway (``image_resize`` mode), the simulator evaluates
        the warp directly at that resolution
        (``MovementSimulator.simulate_movement_resized`` — exact flows and
        masks, bounded value deviation) instead of warping a >=2x-train-size
        background and throwing 7/8 of the pixels away.
        """
        y, m, name = self.get_frame(frame_index)
        gt_movement, m_movement, mats = None, None, None
        # The item's own simulator, drawing from the item's stream: loader
        # threads share this provider, so its simulator's rng is not set.
        sim = copy.copy(self.movement_simulator)
        sim.rng = rng

        if y is not None:
            small = (
                self.movement_min_height != -1
                and y.shape[0] < self.movement_min_height
            )
            if out_size is not None:
                if small:
                    # Virtual size of the keep-ratio (min_height, -1) resize
                    # the exact path would warp at — incl. the reference's
                    # drop-last-column quirk (_resize_keep_ratio slices
                    # ``[: -1]`` when the requested width is -1).
                    vh = self.movement_min_height
                    rw = round(y.shape[1] * vh / y.shape[0])
                    virtual, resized = (vh, rw - 1), (vh, rw)
                else:
                    virtual, resized = y.shape[:2], None
                y, gt_movement, mats = sim.simulate_movement_resized(
                    y, frames_n, out_size, virtual, value_mode="bilinear",
                    resized_hw=resized,
                )
            else:
                if small:
                    y = _resize_keep_ratio(y, (self.movement_min_height, -1))
                y, gt_movement, mats = sim.simulate_movement(y, frames_n)
        if m is not None:
            if out_size is not None:
                m, m_movement, _ = sim.simulate_movement_resized(
                    m, frames_n, out_size, None, mats, value_mode="nearest"
                )
            else:
                m, m_movement, _ = sim.simulate_movement(m, frames_n, mats)
            m = (m > 0.5).astype(np.float32)
        return y, m, name, None, gt_movement, m_movement


class InpaintingDataset:
    """Produces one training/eval item (reference dataset.py:16-219).

    An item is ``((x, m), y, info)``: the gray-filled masked sequence, the
    dilated mask, the clean background, and auxiliary info (names, window
    indexes, simulator flags, ground-truth flows).
    """

    def __init__(
        self,
        bgs_provider: ContentProvider,
        masks_provider: Optional[ContentProvider],
        split: str,
        cfg,
    ):
        self.bgs = bgs_provider
        self.masks = masks_provider
        self.split = split
        self.cfg = cfg
        self.image_size = (
            tuple(cfg.train_size) if split in ("train", "validation") else tuple(cfg.test_size)
        )

    def __len__(self) -> int:
        if self.cfg.frames_n == -1:
            return self.bgs.len_sequences()
        if self.split == "train":
            return self.cfg.batch_size * self.cfg.train_max_iterations
        if self.split == "validation":
            return self.cfg.batch_size * self.cfg.validation_max_iterations
        return self.cfg.batch_size

    def get_item(self, item: int, rng: np.random.RandomState):
        cfg = self.cfg
        if cfg.frames_n != -1:
            item = rng.randint(0, len(self.bgs))

        use_sim_bgs = bool(
            rng.choice([False, True], p=[1 - cfg.p_simulator_bgs, cfg.p_simulator_bgs])
        )
        use_sim_masks = bool(
            rng.choice([False, True], p=[1 - cfg.p_simulator_masks, cfg.p_simulator_masks])
        )
        if self.bgs.movement_simulator is None:
            use_sim_bgs = False
        if self.masks is None or self.masks.movement_simulator is None:
            use_sim_masks = False

        # In image_resize mode every simulated patch is resized to the
        # working resolution right below — let the simulator evaluate the
        # warp directly at that size (exact flows/masks, bounded value
        # deviation; ops/movements.py:simulate_movement_resized).
        sim_out = (
            self.image_size
            if cfg.image_resize and getattr(cfg, "fast_simulator", True)
            else None
        )
        # In image-resize mode contiguous backgrounds are resized straight
        # down to the working resolution, so the native JPEG codec may
        # decode at a reduced DCT scale that still covers it
        # (runtime/native.py:decode_jpeg; --fast_decode False decodes full
        # frames like the reference's jpeg4py loop, dataset.py:300-301).
        dec_out = (
            self.image_size
            if cfg.image_resize and getattr(cfg, "fast_decode", True)
            else None
        )
        if cfg.frames_n == -1:
            y, m, bg_name, bg_indexes, gt_movement, m_movement = self.bgs.get_sequence(
                item, decode_size=dec_out
            )
        else:
            y, m, bg_name, bg_indexes, gt_movement, m_movement = self.bgs.get_patch(
                item, cfg.frames_n, use_sim_bgs, rng, sim_out, dec_out
            )
            if self.masks is not None:
                _, m, _, _, _, m_movement = self.masks.get_patch_random(
                    cfg.frames_n, use_sim_masks, rng, sim_out, dec_out
                )

        # Resize-or-crop to the working resolution (reference dataset.py:135-156).
        if cfg.image_resize:
            y = resize_hw_np(y, self.image_size, mode="bilinear")
            gt_movement = resize_hw_np(gt_movement, self.image_size, mode="nearest")
        else:
            ph = rng.randint(0, y.shape[1] - self.image_size[0] + 1)
            pw = rng.randint(0, y.shape[2] - self.image_size[1] + 1)
            y = y[:, ph : ph + self.image_size[0], pw : pw + self.image_size[1]]
            gt_movement = crop_flow_np(gt_movement, self.image_size, (ph, pw))

        if self.image_size != (m.shape[1], m.shape[2]):
            m = resize_hw_np(m, self.image_size, mode="nearest")
            if m_movement is not None:
                m_movement = resize_hw_np(m_movement, self.image_size, mode="nearest")
        if m_movement is None:
            m_movement = np.zeros_like(gt_movement)

        m = dilate_np(m, cfg.dilatation_filter_size, cfg.dilatation_iterations)

        # Gray-fill compositing (reference dataset.py:164-169).
        x = (1 - m) * y + m * FILL_COLOR

        if bg_indexes:
            center = bg_indexes[len(bg_indexes) // 2]
            indexes_str = ",".join(str(i - center) for i in bg_indexes)
        else:
            indexes_str = ",".join("-" for _ in range(cfg.frames_n))

        return (
            (x.astype(np.float32), m.astype(np.float32)),
            y.astype(np.float32),
            {
                "name": bg_name,
                "indexes": indexes_str,
                "use_sim_bgs": use_sim_bgs,
                "use_sim_masks": use_sim_masks,
                "gt_movement": gt_movement.astype(np.float32),
                "m_movement": m_movement.astype(np.float32),
            },
        )


_WORKER_LOADER: Optional["Loader"] = None


def _init_worker_loader(loader: "Loader") -> None:
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def _worker_make_batch(epoch: int, batch_idx: int):
    """A batch made in a worker process, its arrays as tensors: pickled by
    ``torch.multiprocessing``'s reductions, they travel in shared memory,
    and only their handles go through the result pipe (a batch of 8 at
    256² is ~46 MB)."""
    batch = _WORKER_LOADER._make_batch(batch_idx, epoch=epoch)
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def _from_worker(batch: dict) -> Dict[str, np.ndarray]:
    """A worker's batch as numpy arrays again (views of its shared memory)."""
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


class Loader:
    """Prefetching batch loader over threads or worker processes.

    Produces dict batches of stacked numpy arrays; a pool keeps
    ``num_workers + prefetch`` batches in flight so the device never waits
    on decode. ``use_processes=True`` runs the batches in worker processes
    (the reference's ``DataLoader(num_workers=...)``); threads scale as well
    where OpenCV and the native libraries decode and warp, which release the
    GIL (PERF.md has both on the card's host). The processes are spawned,
    never forked (a fork after CUDA started in the parent is unsafe), live
    as long as the loader, and import only the host modules; the parent
    builds the native host libraries first, so the workers load
    them (or skip a failed build) without compiling.

    ``shard=(data_rank, data)`` makes only that data rank's contiguous
    ``batch_size // data`` rows of each batch of ``batch_size``
    (:func:`..parallel.shard_batch` of the whole batch, bit for bit: each
    item keeps its index and its rng), so each process of a mesh decodes
    only its own rows.
    """

    def __init__(
        self,
        dataset: InpaintingDataset,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
        use_processes: bool = False,
        shard: Tuple[int, int] = (0, 1),
    ):
        rank, n = shard
        if batch_size % n != 0 or not 0 <= rank < n:
            raise ValueError(f"shard {rank} of {n}: a batch of {batch_size} does not split evenly")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = (rank, n)
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.use_processes = use_processes
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __getstate__(self):
        # Workers receive the loader through the pool's initializer; the
        # pool itself must not ride along.
        d = dict(self.__dict__)
        d.pop("_pool", None)
        return d

    def _make_batch(self, batch_idx: int, epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        if epoch is None:
            epoch = self.epoch
        items = []
        rank, n = self.shard
        rows = self.batch_size // n
        for j in range(rank * rows, (rank + 1) * rows):
            item = batch_idx * self.batch_size + j
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + epoch * 7_919 + item) % (2**31 - 1)
            )
            items.append(self.dataset.get_item(item, rng))
        infos = [it[2] for it in items]
        return {
            "x": np.stack([it[0][0] for it in items]),
            "m": np.stack([it[0][1] for it in items]),
            "y": np.stack([it[1] for it in items]),
            "flows_use": np.asarray([i["use_sim_bgs"] for i in infos], np.bool_),
            "flow_gt": np.stack([i["gt_movement"] for i in infos]),
            "m_movement": np.stack([i["m_movement"] for i in infos]),
            "names": [i["name"] for i in infos],
            "indexes": [i["indexes"] for i in infos],
        }

    def __iter__(self):
        n_batches = len(self)
        # One worker process still moves the GIL-bound item assembly off
        # the caller's thread; only a single thread runs inline.
        if self.num_workers <= 1 and not self.use_processes:
            for b in range(n_batches):
                yield self._make_batch(b)
            self.epoch += 1
            return

        epoch = self.epoch
        if self.use_processes:
            pool = self._process_pool()
            submit = lambda b: pool.submit(_worker_make_batch, epoch, b)
            done = _from_worker
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            submit = lambda b: pool.submit(self._make_batch, b, epoch)
            done = lambda batch: batch
        try:
            pending = [submit(b) for b in range(min(self.num_workers + self.prefetch, n_batches))]
            next_submit = len(pending)
            while pending:
                fut = pending.pop(0)
                if next_submit < n_batches:
                    pending.append(submit(next_submit))
                    next_submit += 1
                yield done(fut.result())
        finally:
            # On exhaustion and when the consumer abandons the generator. The
            # process pool persists across epochs (close() ends it).
            if not self.use_processes:
                pool.shutdown(wait=False, cancel_futures=True)
        self.epoch += 1

    def _process_pool(self) -> ProcessPoolExecutor:
        pool = getattr(self, "_pool", None)
        if pool is None:
            native.is_available()  # build (or fail) once, here, before the workers
            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker_loader,
                initargs=(self,),
            )
            self._pool = pool
        return pool

    def close(self, wait: bool = True) -> None:
        """Ends the worker processes, if any."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            self._pool = None
            pool.shutdown(wait=wait, cancel_futures=True)

    def __del__(self):
        self.close(wait=False)
