"""Assemble per-frame saliency JPEGs into videos (reference gen_video.py).

A copy of ``sap3d_tpu/infer/video.py`` (``cv2`` imported where it is used):
a DIVX-fourcc AVI at 25 fps, 112x112, grayscale (channel 0 of the loaded
frame), covering frames 6 .. N-1 of each video directory (reference
gen_video.py:37-47).
"""

from __future__ import annotations

import glob
import os

import numpy as np


def frames_to_video(
    video_dir: str,
    save_path: str,
    fps: float = 25.0,
    out_size: tuple[int, int] = (112, 112),
    start_frame: int = 6,
) -> int:
    """Write one AVI from a directory of frame_%d.jpg maps; returns frame count."""
    import cv2

    n_frames = len(glob.glob(os.path.join(video_dir, "*.*")))
    writer = cv2.VideoWriter(
        save_path,
        cv2.VideoWriter_fourcc("D", "I", "V", "X"),
        fps,
        out_size,
        isColor=False,
    )
    written = 0
    try:
        # frames start_frame .. n_frames-1 (reference gen_video.py:42)
        for i in range(start_frame, n_frames - 1):
            frame = cv2.imread(os.path.join(video_dir, f"frame_{i}.jpg"))
            if frame is None:
                continue
            frame = cv2.resize(frame, out_size)
            writer.write(np.ascontiguousarray(frame[:, :, 0]))
            written += 1
    finally:
        writer.release()
    return written


def export_all_videos(
    results_root: str, save_root: str, fps: float = 25.0,
    out_size: tuple[int, int] = (112, 112),
) -> int:
    """One AVI per video directory under results_root (reference gen_video.py:30-48)."""
    os.makedirs(save_root, exist_ok=True)
    count = 0
    for vdir in sorted(glob.glob(os.path.join(results_root, "*"))):
        if not os.path.isdir(vdir):
            continue
        name = os.path.basename(vdir)
        frames_to_video(vdir, os.path.join(save_root, name + ".avi"), fps, out_size)
        count += 1
    return count
