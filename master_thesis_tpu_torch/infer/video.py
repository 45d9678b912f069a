"""Video artifact writing (master_thesis_tpu/infer/video.py; reference
model_chn.py:424-440).

Writes inpainted sequences as MJPG ``.avi`` at 10 fps into
``generated_sequences/``, same naming scheme (``{seq}_{ff,ip,cp}.avi``).
Host-side cv2, imported where it is used, RGB -> BGR.
"""

from __future__ import annotations

import os

import numpy as np


def write_video(x: np.ndarray, file_name: str, out_dir: str = "generated_sequences") -> str:
    """x: ``(F, H, W, 3)`` float RGB in [0, 1]."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    h, w = x.shape[1], x.shape[2]
    path = os.path.join(out_dir, f"{file_name}.avi")
    video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    frames = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    for f in range(frames.shape[0]):
        video.write(frames[f][:, :, ::-1])
    video.release()
    return path


def write_frames(x: np.ndarray, seq_name: str, out_dir: str = "generated_sequences") -> str:
    """Also dumps per-frame PNGs (useful for metric comparison)."""
    import cv2

    frame_dir = os.path.join(out_dir, seq_name)
    os.makedirs(frame_dir, exist_ok=True)
    frames = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    for f in range(frames.shape[0]):
        cv2.imwrite(os.path.join(frame_dir, f"{f:05d}.png"), frames[f][:, :, ::-1])
    return frame_dir
