"""Configuration dataclasses of the trainer.

A copy of ``sap3d_tpu/core/config.py`` (``Config``, ``ModelConfig``,
``DataConfig``, ``TrainConfig``, ``DATASET_ROOTS``, ``EVAL_DATASETS``,
``parse_bool``); the port imports nothing of ``sap3d_tpu``.  The fields are
the JAX package's, so a configuration reads the same in both.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

CROP_SIZE = 112
NUM_FRAMES_PER_CLIP = 16
RGB_CHANNEL = 3
BLOCK_EXPANSION = 4

# Per-channel RGB mean subtracted by the decode pipeline (the reference's BGR
# mean [98, 102, 90] reversed).
RGB_MEAN = (90.0, 102.0, 98.0)


def parse_bool(v: Any) -> bool:
    """Strict bool parsing: any non-empty string is not True."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y"):
        return True
    if s in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


@dataclass(frozen=True)
class ModelConfig:
    """Which model variant to build and with what numerics."""

    # Registry name, e.g. "p3d_unetplusplus_ds" (models/registry.py).
    name: str = "p3d_unetplusplus_ds"
    # Compute dtype; parameters always live in float32.
    dtype: str = "bfloat16"
    # Dropout rate fed at train time.
    dropout: float = 0.5


@dataclass(frozen=True)
class DataConfig:
    """Clip indexing and decode settings."""

    frame_dirs: Sequence[str] = ()
    density_dirs: Sequence[str] = ()
    fixation_dir: str | None = None
    video_length: int = NUM_FRAMES_PER_CLIP
    # Stride between clip starts is video_length - overlap.
    overlap: int = 15
    # Frames skipped at the head of every video.
    skip_head: int = 11
    # Train/valid split proportion.
    training_props: float = 0.9
    image_size: int = CROP_SIZE
    # Decode worker threads.
    num_threads: int = 16
    # Batches buffered ahead of the device.
    prefetch: int = 4
    # LRU capacity (in frames) of the decoded-frame cache.
    cache_frames: int = 8192
    shuffle_seed: int = 0
    frame_wildcard: str = "frame_%d.jpg"
    gt_wildcard: str = "frame_%d.jpg"
    fix_wildcard: str = "frame_%d.bmp"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2  # global batch
    lr: float = 1e-4
    epochs: int = 4
    plot_iter: int = 1000
    valid_iter: int = 160000
    save_iter: int = 4000
    max_to_keep: int = 10
    seed: int = 0
    # Coupled L2 on conv kernels (added to the gradient before Adam).
    weight_decay: float = 0.0
    # Hard step cap; None = run the loader dry.
    max_steps: int | None = None
    # Resume from the latest checkpoint of this run dir.
    pretrain: str | None = None
    # Data-parallel mesh size; -1 = all local devices.
    num_devices: int = -1
    # Long-clip sequence parallelism over the time axis; 0/1 = off.
    time_shards: int = 0
    ring_attention: bool = True
    model_dir: str = "./model"
    logs_dir: str = "./logs"
    info: str = ""
    sync_bn: bool = False
    # K train steps per call (train/steps.make_multi_train_step): a CUDA graph
    # replayed K times on one card, K single steps elsewhere.
    steps_per_call: int = 1
    # Anomaly detection (the counterpart of jax debug_nans).
    debug_nans: bool = False
    profile_dir: str | None = None
    profile_start: int = 10
    profile_steps: int = 5


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Named dataset roots (config values, overridable on the command line).
DATASET_ROOTS: dict[str, dict[str, Any]] = {
    "svsd": {
        "frame_dirs": ["/data/svsd/train/left_view_svsd/"],
        "density_dirs": ["/data/svsd/train/left_density_svsd/"],
        "fixation_dir": None,
    },
    "dhf1k": {
        "frame_dirs": ["/data/DHF1K/frames/"],
        "density_dirs": ["/data/DHF1K/density/"],
        "fixation_dir": None,
    },
    "svsdndhf1k": {
        "frame_dirs": ["/data/svsd/train/left_view_svsd/", "/data/DHF1K/frames/"],
        "density_dirs": ["/data/svsd/train/left_density_svsd/", "/data/DHF1K/density/"],
        "fixation_dir": None,
    },
}


def _eval_ds(density: str, saliency: str, fixation: str) -> dict[str, str]:
    return {"density_dir": density, "saliency_dir": saliency,
            "fixation_dir": fixation}


# Batch-scoring dataset map: the 9 --dsname values of the reference's MATLAB
# evaluator orchestrator (reference utils/matlab_metric/eval_vid.py:22-61),
# each resolving to (density, produced-saliency, fixation) roots.  The
# reference hard-codes absolute /data paths; here the common root is
# overridable via $SAP3D_DATA_ROOT (default "/data") so the map is config,
# not code.
_DR = os.environ.get("SAP3D_DATA_ROOT", "/data")
EVAL_DATASETS: dict[str, dict[str, str]] = {
    "videoset": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/VideoSet/ImageSet/Seperate/density/sigma32",
        f"{_DR}/SaliencyDataset/Video/VideoSet/Results/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/VideoSet/ImageSet/Seperate/fixation",
    ),
    "msu": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/MSU/density/sigma32",
        f"{_DR}/SaliencyDataset/Video/MSU/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/MSU/fixation/image",
    ),
    "ledov": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/LEDOV/density/sigma32",
        f"{_DR}/SaliencyDataset/Video/LEDOV/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/LEDOV/fixation",
    ),
    "hollywood": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/ActionInTheEye/Hollywood2/density",
        f"{_DR}/SaliencyDataset/Video/ActionInTheEye/Hollywood2/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/ActionInTheEye/Hollywood2/fixation",
    ),
    "dhf1k": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/DHF1K/density",
        f"{_DR}/SaliencyDataset/Video/DHF1K/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/DHF1K/fixation",
    ),
    "diem": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/DIEM/density/sigma32",
        f"{_DR}/SaliencyDataset/Video/DIEM/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/DIEM/fixation_map/image",
    ),
    "gazecom": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/GAZECOM/density/sigma32",
        f"{_DR}/SaliencyDataset/Video/GAZECOM/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/GAZECOM/fixations",
    ),
    "coutort2": _eval_ds(
        f"{_DR}/SaliencyDataset/Video/Coutort2/density/sigma32",
        f"{_DR}/SaliencyDataset/Video/Coutort2/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/Coutort2/fixations",
    ),
    # the reference's svsd entry points its density at a DHF1K dir — kept
    # verbatim for parity (reference eval_vid.py:58-61)
    "svsd": _eval_ds(
        f"{_DR}/lishikai/svsd/DHF1K/density",
        f"{_DR}/SaliencyDataset/Video/DHF1K/saliency_map_1128",
        f"{_DR}/SaliencyDataset/Video/DHF1K/fixation",
    ),
}
