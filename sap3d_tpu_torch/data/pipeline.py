"""Frame decode and preprocessing for inference.

Copied from ``sap3d_tpu/data/pipeline.py`` (``_RGB_MEAN``,
``imread_checked``, ``preprocess_frame``); the training loader ports with
the trainer (ROADMAP A.8).  ``cv2`` is imported inside the functions that
use it: the GPU host need not have OpenCV to run the model.

Preprocessing order matters for parity: frames are read BGR, flipped to
RGB, promoted to float, resized to 112, mean-subtracted with the RGB mean
[90, 102, 98] and divided by 255.
"""

from __future__ import annotations

import os

import numpy as np

# RGB-order mean (the reference's BGR [98, 102, 90] reversed).
_RGB_MEAN = np.array([90.0, 102.0, 98.0], dtype=np.float32)


def imread_checked(path: str, flags: int) -> np.ndarray:
    """cv2.imread that raises, naming the file, instead of returning None."""
    import cv2

    img = cv2.imread(path, flags)
    if img is None:
        if os.path.exists(path):
            raise ValueError(
                f"cv2 could not decode {path!r} (file exists but is "
                "corrupt or not a supported image format)"
            )
        raise FileNotFoundError(f"cv2 could not decode {path!r}: no such file")
    return img


def preprocess_frame(bgr: np.ndarray, size: int = 112) -> np.ndarray:
    """BGR uint8 frame -> float32 [size, size, 3]: RGB flip, float promote,
    bilinear resize, mean-subtract, /255.  Resizing before the
    mean-subtract equals the reference order up to float rounding, since
    bilinear interpolation is linear."""
    import cv2

    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    fl = cv2.multiply(rgb, (1.0, 1.0, 1.0, 1.0), dtype=cv2.CV_32F)
    small = cv2.resize(fl, (size, size), interpolation=cv2.INTER_LINEAR)
    return (small - _RGB_MEAN) * np.float32(1.0 / 255.0)
