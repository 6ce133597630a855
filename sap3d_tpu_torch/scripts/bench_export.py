"""The export path end to end on the card: decode, sliding windows, the
eval forward, 960 x 1080 JPEG maps.

Counterpart of ``scripts/bench_export.py``.

    BENCH_EXPORT_VIDEOS=4 BENCH_EXPORT_FRAMES=200 \\
        python sap3d_tpu_torch/scripts/bench_export.py [--device cuda] [--root <checkout>]

``infer/predictor.SlidingWindowPredictor.export_dataset`` (``cli
predict``'s work, reference gen_pred.py) on a synthetic dataset of
``BENCH_EXPORT_VIDEOS`` videos of ``BENCH_EXPORT_FRAMES`` frames at 640 x
360 (``data/synthetic.make_synthetic_dataset``), with the flagship
(p3d_unetplusplus_ds, weights of the port's initialisation from seed 0) in
bf16: the host's JPEG decode, the stride-1 windows in batches of 16, the
eval forward (kernel B1 at the three attention sites of each batch), the
JPEG encode and write of each map.  A first run warms up (cuDNN, and the
kernels' build where they are not built yet); the second is timed on the
host clock, and frames/s counts each emitted frame (about one 16-frame
window each).  Prints one line and a last JSON line with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing


MODEL = "p3d_unetplusplus_ds"
IMAGE_SIZE, BATCH_WINDOWS = 112, 16  # the predictor's defaults, as cli predict runs it


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    n_videos = int(os.environ.get("BENCH_EXPORT_VIDEOS", "4"))
    frames_per_video = int(os.environ.get("BENCH_EXPORT_FRAMES", "200"))

    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    before = _timing.launch_counts()
    with tempfile.TemporaryDirectory() as root:
        ds = make_synthetic_dataset(os.path.join(root, "data"), num_videos=n_videos,
                                    frames_per_video=frames_per_video, size=(640, 360))
        model = build_model(MODEL, dtype="bfloat16", device=device)
        with SlidingWindowPredictor(make_eval_step(model), batch_windows=BATCH_WINDOWS,
                                    image_size=IMAGE_SIZE, device=device) as pred:
            pred.export_dataset(ds["frame_dirs"], os.path.join(root, "warm"))
            shutil.rmtree(os.path.join(root, "warm"))
            t0 = time.perf_counter()
            n = pred.export_dataset(ds["frame_dirs"], os.path.join(root, "out"))
            dt = time.perf_counter() - t0
        maps = sum(len(files) for _, _, files in os.walk(os.path.join(root, "out")))
    total_frames = n_videos * frames_per_video
    if n != n_videos or maps != total_frames:
        raise AssertionError(f"exported {n} of {n_videos} videos, {maps} of {total_frames} maps")
    print(f"exported {n} videos, {total_frames} frames in {dt:.1f}s = "
          f"{total_frames / dt:.1f} frames/s end-to-end "
          f"(decode + windows + device + 960x1080 JPEG write)", flush=True)
    return _timing.emit("bench_export", device, dict(
        structure=MODEL, dtype="bfloat16", videos=n_videos,
        frames_per_video=frames_per_video, exported=n, seconds_s=dt,
        frames_per_s=total_frames / dt, launches=_timing.launches_since(before)))


if __name__ == "__main__":
    main()
