"""Dataset metadata scanners (master_thesis_tpu/data/meta.py; reference
data.py:49-317).

Metadata format matches the reference exactly: a dict mapping sequence id ->
``(bg_paths | None, mask_paths | None)`` with paths relative to the data
root. GOT-10k provides backgrounds, YouTube-VOS provides mask shapes (with
the seeded 90/10 train/validation split, reference data.py:263), DAVIS-2017
provides real test sequences. The scanned + filtered metadata is persisted
so validation/test stay consistent between runs (reference data.py:64-83).
"""

from __future__ import annotations

import glob
import os
import pickle
import random
from typing import Dict, Optional, Tuple

import numpy as np

from master_thesis_tpu_torch.data.decode import read_gray

Meta = Dict[str, Tuple[Optional[list], Optional[list]]]


def get_meta_got10k(data_folder: str, split: str) -> Meta:
    """GOT-10k backgrounds (reference data.py:205-240)."""
    dataset_folder = os.path.join(data_folder, "GOT10k")
    split_folder = "train" if split == "train" else "val"
    with open(os.path.join(dataset_folder, split_folder, "list.txt")) as f:
        names = sorted(f.read().splitlines())

    items_meta: Meta = {}
    for item_name in names:
        item_dir = os.path.join(dataset_folder, split_folder, item_name)
        if not os.path.exists(item_dir):
            continue
        paths = sorted(glob.glob(os.path.join(item_dir, "*.jpg")))
        paths = [os.path.relpath(p, data_folder) for p in paths]
        if paths:
            items_meta[item_name] = (paths, None)
    return items_meta


def get_meta_youtube_vos(data_folder: str, split: str) -> Meta:
    """YouTube-VOS masks with the deterministic 90/10 split
    (reference data.py:242-282)."""
    ann_dir = os.path.join(data_folder, "YouTubeVOS", "train", "Annotations")
    samples = sorted(os.listdir(ann_dir))
    random.Random(0).shuffle(samples)  # same order every time
    cut = int(0.9 * len(samples))
    split_paths = samples[:cut] if split == "train" else samples[cut:]

    items_meta: Meta = {}
    for item_name in split_paths:
        paths = sorted(glob.glob(os.path.join(ann_dir, item_name, "*.png")))
        items_meta[item_name] = (
            None,
            [os.path.relpath(p, data_folder) for p in paths],
        )
    return items_meta


def get_meta_davis(data_folder: str) -> Meta:
    """DAVIS-2017 test sequences (reference data.py:284-317)."""
    dataset_folder = os.path.join(data_folder, "DAVIS-2017")
    with open(os.path.join(dataset_folder, "ImageSets", "custom.txt")) as f:
        names = sorted(f.read().splitlines())

    items_meta: Meta = {}
    for item_name in names:
        bgs = sorted(
            glob.glob(os.path.join(dataset_folder, "JPEGImages", "480p", item_name, "*.jpg"))
        )
        masks = sorted(
            glob.glob(
                os.path.join(dataset_folder, "Annotations_Dense", "480p", item_name, "*.png")
            )
        )
        items_meta[item_name] = (
            [os.path.relpath(p, data_folder) for p in bgs],
            [os.path.relpath(p, data_folder) for p in masks],
        )
    return items_meta


def clean_masks_meta(
    masks_meta: Meta,
    data_path: str,
    min_mask_size: float,
    max_mask_size: Optional[float],
    samples_per_seq: int = 10,
    rng: Optional[random.Random] = None,
) -> None:
    """Drops mask sequences whose mean coverage is outside the configured
    band, sampling at most ``samples_per_seq`` frames per sequence
    (reference data.py:102-126). Mutates ``masks_meta`` in place. Reads
    each mask as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE) > 0``
    (:func:`.decode.read_gray`)."""
    if max_mask_size is None:
        return
    rng = rng or random
    for item in list(masks_meta.keys()):
        paths = masks_meta[item][1]
        sample = rng.sample(paths, min(samples_per_seq, len(paths)))
        vals = []
        for rel in sample:
            img = read_gray(os.path.join(data_path, rel)) > 0
            vals.append(np.count_nonzero(img) / (img.shape[0] * img.shape[1]))
        mask_size = float(np.mean(vals))
        if mask_size <= min_mask_size or mask_size >= max_mask_size:
            masks_meta.pop(item)


def save_data_checkpoint(path: str, metas: tuple) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(metas, f)


def load_data_checkpoint(path: str) -> tuple:
    with open(path, "rb") as f:
        return pickle.load(f)


def prepare_data(cfg) -> tuple:
    """Scans (or restores) all five metadata dicts.

    Returns ``(train_bgs, train_masks, val_bgs, val_masks, test)`` — the
    exact pickle payload format the reference uses (data.py:64-83), so a
    ``data.ckpt`` the reference or the JAX package wrote loads here
    unchanged, and one written here loads there.
    """
    if os.path.exists(cfg.data_ckpt_path):
        return load_data_checkpoint(cfg.data_ckpt_path)

    train_bgs = get_meta_got10k(cfg.data_path, "train")
    train_masks = get_meta_youtube_vos(cfg.data_path, "train")
    val_bgs = get_meta_got10k(cfg.data_path, "validation")
    val_masks = get_meta_youtube_vos(cfg.data_path, "validation")
    test = get_meta_davis(cfg.data_path)

    for masks in (train_masks, val_masks):
        clean_masks_meta(masks, cfg.data_path, cfg.min_mask_size, cfg.max_mask_size)

    metas = (train_bgs, train_masks, val_bgs, val_masks, test)
    save_data_checkpoint(cfg.data_ckpt_path, metas)
    return metas
