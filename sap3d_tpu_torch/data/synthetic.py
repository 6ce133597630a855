"""Synthetic dataset: a tiny on-disk frame tree for tests.

A copy of ``sap3d_tpu/data/synthetic.py``: ``<root>/frames/<video>/
frame_%d.jpg`` moving-gradient frames, a parallel ``density`` tree of
Gaussian blobs that track a moving point, and optionally a ``fixation``
tree of ``frame_%d.bmp`` files.  Needs ``cv2`` (imported inside).
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_dataset(
    root: str,
    num_videos: int = 2,
    frames_per_video: int = 40,
    size: tuple[int, int] = (64, 48),
    with_fixations: bool = False,
    seed: int = 0,
) -> dict[str, str]:
    """Create a synthetic dataset; returns the frame/density/fixation roots."""
    import cv2

    rng = np.random.default_rng(seed)
    frame_root = os.path.join(root, "frames")
    density_root = os.path.join(root, "density")
    fixation_root = os.path.join(root, "fixation")
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    for v in range(num_videos):
        vname = f"video{v:03d}"
        fdir = os.path.join(frame_root, vname)
        ddir = os.path.join(density_root, vname)
        os.makedirs(fdir, exist_ok=True)
        os.makedirs(ddir, exist_ok=True)
        if with_fixations:
            os.makedirs(os.path.join(fixation_root, vname), exist_ok=True)
        cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        vx, vy = rng.uniform(-2, 2), rng.uniform(-2, 2)
        for t in range(1, frames_per_video + 1):
            cx = (cx + vx) % w
            cy = (cy + vy) % h
            img = np.zeros((h, w, 3), np.uint8)
            img[..., 0] = (xx * 255 // max(w - 1, 1)).astype(np.uint8)
            img[..., 1] = (yy * 255 // max(h - 1, 1)).astype(np.uint8)
            r2 = (xx - cx) ** 2 + (yy - cy) ** 2
            img[..., 2] = np.clip(255 * np.exp(-r2 / (2 * 36.0)), 0, 255).astype(np.uint8)
            density = np.clip(255 * np.exp(-r2 / (2 * 64.0)), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(fdir, f"frame_{t}.jpg"), img)
            cv2.imwrite(os.path.join(ddir, f"frame_{t}.jpg"), density)
            if with_fixations:
                fix = (density > 192).astype(np.uint8) * 255
                cv2.imwrite(os.path.join(fixation_root, vname, f"frame_{t}.bmp"), fix)
    out = {"frame_dirs": frame_root, "density_dirs": density_root}
    if with_fixations:
        out["fixation_dir"] = fixation_root
    return out
