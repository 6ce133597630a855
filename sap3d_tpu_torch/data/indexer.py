"""Clip indexing: scan video frame directories into (video, start) tuples.

A copy of ``sap3d_tpu/data/indexer.py`` (the port imports nothing of
``sap3d_tpu``).  Every video directory under each ``frame_dir`` contributes
clips whose starts step by ``video_length - overlap`` from ``skip_head``; a
clip must fit inside its video; the tuple list is shuffled once with a seed
and split train/valid by ``training_props``; each tuple materializes into
1-based ``frame_%d.jpg`` paths, density paths from the last density root
holding the video, and optional ``frame_%d.bmp`` fixation paths.
"""

from __future__ import annotations

import glob
import os
import random
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ClipPaths:
    """Materialized path lists for one clip."""

    video_name: str
    start_frame: int  # 0-based start index (filenames are 1-based)
    frames: tuple[str, ...]
    densities: tuple[str, ...]
    fixations: tuple[str, ...] = ()


class ClipIndex:
    """Builds and splits the clip tuple list for a set of video datasets."""

    def __init__(
        self,
        frame_dirs: Sequence[str],
        density_dirs: Sequence[str],
        fixation_dir: str | None = None,
        video_length: int = 16,
        frame_wildcard: str = "frame_%d.jpg",
        gt_wildcard: str = "frame_%d.jpg",
        fix_wildcard: str = "frame_%d.bmp",
    ):
        self.frame_dirs = list(frame_dirs)
        self.density_dirs = list(density_dirs)
        self.fixation_dir = fixation_dir
        self.video_length = video_length
        self.frame_wildcard = frame_wildcard
        self.gt_wildcard = gt_wildcard
        self.fix_wildcard = fix_wildcard

        self.video_dirs: list[str] = []
        for root in self.frame_dirs:
            self.video_dirs += sorted(glob.glob(os.path.join(root, "*")))
        self.video_dirs = [d for d in self.video_dirs if os.path.isdir(d)]

        self.tuples: list[tuple[int, int]] = []
        self.train_tuples: list[tuple[int, int]] = []
        self.valid_tuples: list[tuple[int, int]] = []

    def setup(
        self,
        overlap: int = 15,
        training_props: float = 0.9,
        skip_head: int = 11,
        seed: int = 0,
    ) -> "ClipIndex":
        """Index clips and split train/valid."""
        assert overlap < self.video_length, "overlap must be < video_length"
        step = self.video_length - overlap
        self.tuples = []
        for vi, vdir in enumerate(self.video_dirs):
            total = len(glob.glob(os.path.join(vdir, "*.*")))
            for j in range(skip_head, total, step):
                if j + self.video_length > total:
                    break
                self.tuples.append((vi, j))
        rng = random.Random(seed)
        rng.shuffle(self.tuples)
        n_train = int(len(self.tuples) * training_props)
        self.train_tuples = self.tuples[:n_train]
        self.valid_tuples = self.tuples[n_train:]
        return self

    def _density_dir_for(self, video_name: str) -> str:
        # the last matching density root wins
        found = None
        for root in self.density_dirs:
            cand = os.path.join(root, video_name)
            if os.path.exists(cand):
                found = cand
        if found is None:
            raise FileNotFoundError(
                f"no density dir for video {video_name!r} under {self.density_dirs}"
            )
        return found

    def materialize(
        self, tuples: Sequence[tuple[int, int]], with_fixations: bool = False
    ) -> list[ClipPaths]:
        """Expand tuples into explicit frame/density/fixation path lists."""
        out = []
        for vi, start in tuples:
            vdir = self.video_dirs[vi]
            vname = os.path.basename(vdir)
            ddir = self._density_dir_for(vname)
            idxs = range(start + 1, start + 1 + self.video_length)  # 1-based
            frames = tuple(os.path.join(vdir, self.frame_wildcard % i) for i in idxs)
            densities = tuple(os.path.join(ddir, self.gt_wildcard % i) for i in idxs)
            fixations: tuple[str, ...] = ()
            if with_fixations:
                if not self.fixation_dir:
                    raise ValueError("fixation_dir not set")
                fdir = os.path.join(self.fixation_dir, vname)
                fixations = tuple(os.path.join(fdir, self.fix_wildcard % i) for i in idxs)
            out.append(ClipPaths(video_name=vname, start_frame=start, frames=frames,
                                 densities=densities, fixations=fixations))
        return out

    def train_clips(self, with_fixations: bool = False) -> list[ClipPaths]:
        return self.materialize(self.train_tuples, with_fixations)

    def valid_clips(self, with_fixations: bool = False) -> list[ClipPaths]:
        return self.materialize(self.valid_tuples, with_fixations)

    def summary(self) -> str:
        return (
            f"{len(self.tuples)} samples generated in total, "
            f"{len(self.train_tuples)} training samples, "
            f"{len(self.valid_tuples)} validation samples"
        )
