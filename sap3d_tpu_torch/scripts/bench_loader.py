"""The train path's host side: the clip loader's clips/s, with and without
its decoded-frame cache.

Counterpart of the root ``bench_loader.py``.

    python sap3d_tpu_torch/scripts/bench_loader.py [--device cuda] [--root <checkout>]

A synthetic frame tree of 6 videos of 120 frames at 640 x 360
(``data/synthetic.make_synthetic_dataset``) is indexed as training clips
at the reference's settings (16 frames, overlap 15: consecutive clips
share 15 frames), and ``data/pipeline.ClipLoader`` (batch 2, 112 px, 16
threads) yields every clip once with ``cache_frames`` 0 and 16384; each
pass is timed on the host clock, and the cached pass's hit rate read from
its cache.  The loader runs on the host and touches no card: ``--device``
names the machine whose card the readings sit beside (default cuda, which
raises on a host without one).  Prints a last JSON line, the JAX script's
keys with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing

VIDEOS, FRAMES, SIZE = 6, 120, (640, 360)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p)
    args = p.parse_args(argv)
    device = _timing.setup(args)

    from sap3d_tpu_torch.data.indexer import ClipIndex
    from sap3d_tpu_torch.data.pipeline import ClipLoader
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tempfile.mkdtemp(prefix="sap3d_loaderbench_")
    try:
        roots = make_synthetic_dataset(root, num_videos=VIDEOS, frames_per_video=FRAMES,
                                       size=SIZE)
        idx = ClipIndex([roots["frame_dirs"]], [roots["density_dirs"]]).setup(
            overlap=15, training_props=1.0)
        clips = idx.train_clips()
        results = {}
        for cache in (0, 16384):
            loader = ClipLoader(clips, batch_size=2, size=112, num_threads=16,
                                cache_frames=cache)
            n = 0
            t0 = time.perf_counter()
            with loader:
                for frames, _ in loader:
                    n += frames.shape[0]
            dt = time.perf_counter() - t0
            key = "cached" if cache else "uncached"
            results[f"{key}_clips_per_sec"] = round(n / dt, 1)
            if cache:
                results["cache_hit_rate"] = round(
                    loader.cache.hits / (loader.cache.hits + loader.cache.misses), 3)
        results["n_clips"] = len(clips)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return _timing.emit("bench_loader", device, results)


if __name__ == "__main__":
    main()
