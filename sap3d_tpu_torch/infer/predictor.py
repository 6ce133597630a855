"""Sliding-window per-frame saliency inference and export.

Counterpart of ``sap3d_tpu/infer/predictor.py``, with the same protocol:

* videos are processed in sorted order; a video whose output directory
  already exists is skipped;
* a 16-frame window slides with stride 1 over each video; the FIRST window
  emits all 16 frames and every later window only its last frame;
* emitted maps are scaled x255, resized to (960, 1080) and written as
  ``frame_%d.jpg`` into ``<video>.tmp-partial``, which is renamed to the
  final name once every frame is written, so a crash never leaves a
  final-named directory with missing frames.

Each frame is decoded once on the host, the preprocessed video is uploaded
once, and windows are gathered on the device by index, in batches of
``batch_windows``.  Only the first batch brings full window outputs back to
the host; every other batch brings its last frames only.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from sap3d_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from sap3d_tpu_torch.data.pipeline import imread_checked, preprocess_frame


def _numeric_frame_sort(paths: Sequence[str]) -> list[str]:
    """Sort frame paths by their numeric index (``frame_<n>.jpg``)."""
    return sorted(paths, key=lambda p: int(os.path.basename(p).split("_")[-1].split(".")[0]))


class SlidingWindowPredictor:
    def __init__(
        self,
        apply_fn: Callable[[torch.Tensor], torch.Tensor],
        window: int = 16,
        batch_windows: int = 16,
        image_size: int = 112,
        out_size: tuple[int, int] = (960, 1080),
        num_threads: int = 16,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """apply_fn: ``[W, T, H, W, 3]`` -> ``[W, T, H, W]`` saliency, on
        ``device`` (e.g. ``train.steps.make_eval_step(model)``)."""
        self.apply_fn = apply_fn
        self.window = window
        self.batch_windows = batch_windows
        self.image_size = image_size
        self.out_size = out_size
        self.device = resolve_device(device)
        self._pool = ThreadPoolExecutor(num_threads, thread_name_prefix="pred-decode")
        # a separate pool for the JPEG encode/write, so write-behind does not
        # starve the decode of the next video
        self._write_pool = ThreadPoolExecutor(
            num_threads // 2 or 1, thread_name_prefix="pred-write"
        )
        # write-behind bookkeeping: (futures, tmp_dir, final_dir) per video
        self._pending_videos: list[tuple[list, str, str]] = []

    def close(self) -> None:
        """Finish pending writes and stop the thread pools."""
        try:
            self.flush_writes()
        finally:
            self._pool.shutdown()
            self._write_pool.shutdown()

    def __enter__(self) -> "SlidingWindowPredictor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def decode_video(self, frame_paths: Sequence[str]) -> np.ndarray:
        """Decode + preprocess a whole video on the thread pool -> [N,H,W,3]."""
        import cv2

        paths = _numeric_frame_sort(list(frame_paths))
        if len(paths) < self.window:
            return np.zeros((0, self.image_size, self.image_size, 3), np.float32)

        def one(p):
            return preprocess_frame(imread_checked(p, cv2.IMREAD_COLOR), self.image_size)

        return np.stack(list(self._pool.map(one, paths))).astype(np.float32)

    def prepare_video(self, frame_paths: Sequence[str]) -> torch.Tensor | np.ndarray:
        """Decode and upload a whole video (run ahead on a thread, so the
        decode and the upload overlap the previous video's inference)."""
        frames = self.decode_video(frame_paths)
        return torch.from_numpy(frames).to(self.device) if frames.shape[0] else frames

    def predict_video(
        self,
        frame_paths: Sequence[str] | None = None,
        frames: np.ndarray | torch.Tensor | None = None,
    ) -> np.ndarray:
        """All sliding-window outputs for one video.

        Accepts frame paths (decoded here) or an already decoded float32
        ``[N, H, W, 3]`` array or tensor.  Index i of the result holds the
        map emitted for (1-based) frame i+1.  Videos shorter than one window
        return an empty array."""
        if frames is None:
            frames = self.decode_video(list(frame_paths))
        n = frames.shape[0]
        if n < self.window:
            return np.zeros((0, self.image_size, self.image_size), np.float32)
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
        frames_dev = frames.to(self.device)

        n_windows = n - self.window + 1
        offsets = torch.arange(self.window, device=self.device)
        emitted = np.zeros((n, self.image_size, self.image_size), np.float32)
        # Enqueue every window batch, then copy to the host once at the end.
        pending: list[tuple[np.ndarray, torch.Tensor, bool]] = []
        for base in range(0, n_windows, self.batch_windows):
            starts = np.arange(base, min(base + self.batch_windows, n_windows))
            # pad the last batch by repeating its last window (fixed shapes)
            starts_p = np.concatenate(
                [starts, np.full(self.batch_windows - len(starts), starts[-1])])
            idx = torch.from_numpy(starts_p).to(self.device)[:, None] + offsets
            out = self.apply_fn(frames_dev[idx])  # [W, T, H, W]
            full = base == 0
            pending.append((starts, out if full else out[:, -1], full))
        for starts, dev_out, full in pending:
            out = dev_out.float().cpu().numpy()[: len(starts)]
            for j, s in enumerate(starts):
                if s == 0:
                    emitted[0:self.window] = out[j]  # first window: all 16
                elif full:
                    emitted[s + self.window - 1] = out[j, -1]
                else:
                    emitted[s + self.window - 1] = out[j]  # last frame only
        return emitted

    @staticmethod
    def _video_paths(frame_dir: str) -> list[str]:
        return [os.path.join(frame_dir, f) for f in os.listdir(frame_dir)
                if f.endswith(".jpg")]

    def export_video(
        self,
        frame_dir: str,
        save_dir: str,
        skip_existing: bool = True,
        frames: np.ndarray | torch.Tensor | None = None,
        wait: bool = True,
    ) -> bool:
        """Predict one video directory and write ``frame_%d.jpg`` maps.

        Returns False if skipped (output dir already exists).  With
        ``wait=False`` the writes trail in the background; call
        :meth:`flush_writes` before relying on the files."""
        import cv2

        if os.path.exists(save_dir) and skip_existing:
            return False
        maps = self.predict_video(self._video_paths(frame_dir), frames=frames)
        tmp_dir = save_dir + ".tmp-partial"
        if os.path.exists(tmp_dir):  # stale partial from a crashed run
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)

        def write_one(i: int) -> None:
            img = cv2.resize(maps[i] * 255.0, dsize=self.out_size)
            img = np.clip(img, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(tmp_dir, f"frame_{i + 1}.jpg"), img)

        futs = [self._write_pool.submit(write_one, i) for i in range(maps.shape[0])]
        if wait:
            for f in futs:
                f.result()
            self._finalize_video(tmp_dir, save_dir)
        else:
            self._pending_videos.append((futs, tmp_dir, save_dir))
        return True

    @staticmethod
    def _finalize_video(tmp_dir: str, save_dir: str) -> None:
        if os.path.exists(save_dir):  # only with skip_existing=False
            shutil.rmtree(save_dir)
        os.rename(tmp_dir, save_dir)

    def flush_writes(self) -> None:
        """Block until every write-behind JPEG is written, then rename each
        finished video's tmp dir to its final name."""
        for futs, tmp_dir, save_dir in self._pending_videos:
            for f in futs:
                f.result()
            self._finalize_video(tmp_dir, save_dir)
        self._pending_videos.clear()

    def export_dataset(self, data_root: str, save_root: str) -> int:
        """Every video under ``data_root``, sorted; returns the count
        exported.  A lookahead thread decodes video N+1 while the device
        runs video N."""
        os.makedirs(save_root, exist_ok=True)
        todo = []
        for vname in sorted(os.listdir(data_root)):
            vdir = os.path.join(data_root, vname)
            if not os.path.isdir(vdir):
                continue
            sdir = os.path.join(save_root, vname)
            if not os.path.exists(sdir):  # skip existing
                todo.append((vdir, sdir))
        count = 0
        with ThreadPoolExecutor(1, thread_name_prefix="pred-ahead") as ahead:
            fut = None
            for i, (vdir, sdir) in enumerate(todo):
                frames = (fut.result() if fut is not None
                          else self.prepare_video(self._video_paths(vdir)))
                fut = (ahead.submit(self.prepare_video, self._video_paths(todo[i + 1][0]))
                       if i + 1 < len(todo) else None)
                if self.export_video(vdir, sdir, frames=frames, wait=False):
                    count += 1
        self.flush_writes()
        return count
