"""``cli eval`` (the reference test.py's replacement) end to end on the
card, its wall time split into the device forward, the loader's waits and
the host's metrics.

Counterpart of ``scripts/bench_cli_eval.py``.

    python sap3d_tpu_torch/scripts/bench_cli_eval.py [--videos 3] [--frames 60]
        [--size 320 180] [--batch 8] [--structure unet++] [--device cuda]
        [--root <checkout>]

A synthetic validation set (``data/synthetic.make_synthetic_dataset`` with
fixations) and a checkpoint of the freshly built model in float32, written
by ``train/checkpoint.CheckpointManager`` (the cost of an evaluation does
not depend on the weights), are scored by the port's ``cli eval`` as a
user runs it on one device: the clip loader in test mode, the float32
eval forward (kernel B1 on the card), the five metrics of the last frame at 960 x 1080
on the host.  ``eval/evaluator.evaluate_prediction_batches`` is wrapped for
the run to time each forward (up to a synchronize; its output stays on
the device, where the evaluator resizes it) and each wait on the loader;
the host's metrics are the rest of the wall time.  The first forward,
reported apart, holds the cuDNN warm-up and, on a card where the kernels
are not yet built, their build.  Prints the command's
own lines and a last JSON line, the JAX script's keys with the card in
place of ``platform``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing


IMAGE_SIZE = 112  # cli eval's --imagesize default, the network's input


def instrumented(ev_mod, shares: dict):
    """``evaluate_prediction_batches`` timing each loader wait and each
    forward into ``shares``."""
    orig = ev_mod.evaluate_prediction_batches

    def wrapped(batches, forward_fn, **kw):
        def timed_batches():
            it = iter(batches)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                shares["data"] += time.perf_counter() - t0
                shares["clips"] += len(b[0])
                yield b

        def timed_forward(f):
            t0 = time.perf_counter()
            out = forward_fn(f)
            _timing.synchronize(out.device)
            dt = time.perf_counter() - t0
            shares["forward"] += dt
            shares["n_forward"] += 1
            if shares["first_forward"] is None:
                shares["first_forward"] = dt
            return out

        return orig(timed_batches(), timed_forward, **kw)

    return wrapped


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--videos", type=int, default=3)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--size", type=int, nargs=2, default=(320, 180),
                   help="synthetic frame WxH; densities are scored at 960x1080 regardless "
                        "(the reference protocol)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--structure", type=str, default="unet++")
    _timing.add_common_args(p)
    args = p.parse_args(argv)
    device = _timing.setup(args)

    import sap3d_tpu_torch.eval.evaluator as ev_mod
    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.checkpoint import CheckpointManager
    from sap3d_tpu_torch.train.state import create_train_state

    with tempfile.TemporaryDirectory() as td:
        ds = make_synthetic_dataset(os.path.join(td, "data"), num_videos=args.videos,
                                    frames_per_video=args.frames, size=tuple(args.size),
                                    with_fixations=True)
        mgr = CheckpointManager(os.path.join(td, "model", "bench_run"))
        mgr.save(create_train_state(build_model(args.structure, dtype="float32",
                                                device=device)), step=0)
        mgr.close()

        shares = {"forward": 0.0, "data": 0.0, "clips": 0, "first_forward": None,
                  "n_forward": 0}
        orig = ev_mod.evaluate_prediction_batches
        ev_mod.evaluate_prediction_batches = instrumented(ev_mod, shares)
        try:
            t0 = time.perf_counter()
            rc = cli.main([
                "eval", "--structure", args.structure, "--checkpoint", "bench_run",
                "--model-dir", os.path.join(td, "model"), "--frames", ds["frame_dirs"],
                "--densities", ds["density_dirs"], "--fixations", ds["fixation_dir"],
                "--batch", str(args.batch), "--trainingprops", "0", "--device", str(device),
                "--devices", "1", "--imagesize", str(IMAGE_SIZE),
            ])
            e2e = time.perf_counter() - t0
        finally:
            ev_mod.evaluate_prediction_batches = orig
    if rc != 0:
        raise RuntimeError(f"cli eval exited {rc}")

    n, first, nf = shares["clips"], shares["first_forward"] or 0.0, shares["n_forward"]
    metric_t = e2e - shares["forward"] - shares["data"]
    steady_fwd = (shares["forward"] - first) / (nf - 1) if nf > 1 else None
    # frames/s without the first forward: what a long evaluation converges to
    steady_fps = n / (e2e - first) if e2e > first else None
    return _timing.emit("bench_cli_eval", device, {
        "metric": "cli-eval end-to-end frames/s (5-metric protocol, 960x1080 last frame)",
        "value": round(n / e2e, 2),
        "unit": "frames/s",
        "clips_scored": n,
        "e2e_s": round(e2e, 2),
        "device_forward_share": round(shares["forward"] / e2e, 3),
        "data_wait_share": round(shares["data"] / e2e, 3),
        "host_metric_share": round(metric_t / e2e, 3),
        "first_forward_s": round(first, 2),
        "steady_forward_s_per_batch": round(steady_fwd, 3) if steady_fwd is not None else None,
        "steady_frames_per_sec": round(steady_fps, 2) if steady_fps is not None else None,
        "batch": args.batch,
        "structure": args.structure,
    })


if __name__ == "__main__":
    main()
