"""Batch saliency scoring (``cli eval-dirs``, the MATLAB evaluator's
replacement) in frames/s on a synthetic tree: on the host and on the card.

Counterpart of ``scripts/bench_eval.py``.

    python sap3d_tpu_torch/scripts/bench_eval.py [--videos 6] [--frames 50]
        [--size 480 640] [--metrics cc sim auc_judd] [--device cuda]
        [--root <checkout>]

``make_tree`` writes the JAX script's tree from numpy seed 0 (a Gaussian
blob per video plus noise as the JPEG prediction, the blob as the JPEG
density, 8 fixations per frame as a BMP).  ``eval/evaluator.
evaluate_saliency_dirs`` scores it, each run timed on the host clock:
``device="host"`` (frame by frame, NumPy) with ``workers=1`` and with
``workers=None``, then on ``--device`` (a warm-up run, then the timed
one); with ``auc_judd`` among the metrics, the same again with no
fixation root (dense targets: AUC-Judd against the density map itself,
whose many active pixels take the device's wider sweep).  The card's mean
of each metric over the videos is held to the host's (``MEAN_TOLERANCE``);
a failed hold raises.  Prints one line per run and a last JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing

# |card mean - host mean| of each metric over the videos.  cc and sim: the
# device sums in float32, the host in float64 (1e-4, as chip_smoke.py's
# METRIC_TOL).  AUC-Judd: the two paths break ties between equal JPEG
# levels with jitter from other random streams, which moves a fixation's
# rank; 0.02, the JAX package's own device-against-host limit
# (tests/test_torch_eval.py, AUC_LIMITS).
MEAN_TOLERANCE = {"cc": 1e-4, "sim": 1e-4, "nss": 1e-4, "kldiv": 1e-4, "auc_judd": 0.02,
                  "auc_borji": 0.06, "auc_shuffled": 0.08}


def make_tree(root: Path, n_videos: int, n_frames: int, size: tuple[int, int]) -> None:
    """The JAX script's synthetic tree under ``root``: pred/, density/ and
    fixation/, one directory per video, frames numbered from 1."""
    import cv2

    h, w = size
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    for v in range(n_videos):
        vname = f"video{v:03d}"
        for sub in ("pred", "density", "fixation"):
            (root / sub / vname).mkdir(parents=True, exist_ok=True)
        cx, cy = rng.uniform(0.2, 0.8, 2) * (w, h)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (0.08 * w) ** 2))
        for i in range(1, n_frames + 1):
            noise = rng.random((h, w)) * 0.15
            cv2.imwrite(str(root / "pred" / vname / f"frame_{i}.jpg"),
                        np.uint8(np.clip(blob + noise, 0, 1) * 255))
            cv2.imwrite(str(root / "density" / vname / f"frame_{i}.jpg"),
                        np.uint8(blob * 255))
            fix = np.zeros((h, w), np.uint8)
            pts = rng.normal([cy, cx], 0.04 * w, size=(8, 2)).astype(int)
            pts = np.clip(pts, 0, [h - 1, w - 1])
            fix[pts[:, 0], pts[:, 1]] = 255
            cv2.imwrite(str(root / "fixation" / vname / f"frame_{i}.bmp"), fix)


def means(res: dict) -> dict[str, float]:
    """Each metric's mean over the videos (NaN-filtered)."""
    metrics = sorted({m for r in res.values() for m in r})
    return {m: float(np.nanmean([r[m] for r in res.values()])) for m in metrics}


def hold_means(label: str, card: dict[str, float], host: dict[str, float]) -> dict:
    """The card's means against the host's under ``MEAN_TOLERANCE``."""
    diff = {m: abs(card[m] - host[m]) for m in host}
    print(f"{label}: |card - host| of the means {diff} (limits "
          f"{ {m: MEAN_TOLERANCE[m] for m in diff} })", flush=True)
    bad = {m: d for m, d in diff.items() if not d <= MEAN_TOLERANCE[m]}
    if bad or set(card) != set(host):
        raise AssertionError(f"{label}: the card's means are not the host's: {bad}")
    return diff


def run(label: str, root: Path, metrics, fixations: bool, n_total: int, **kw) -> dict:
    from sap3d_tpu_torch.eval.evaluator import evaluate_saliency_dirs

    t0 = time.perf_counter()
    res = evaluate_saliency_dirs(str(root / "pred"), str(root / "density"),
                                 str(root / "fixation") if fixations else None, tuple(metrics),
                                 rng=np.random.default_rng(0), **kw)
    dt = time.perf_counter() - t0
    m = means(res)
    key = "auc_judd" if not fixations else "cc"
    print(f"{label}: {n_total} frames in {dt:.2f}s = {n_total / dt:.1f} frames/s  "
          f"(mean {key} {m.get(key, float('nan')):.3f})", flush=True)
    return dict(seconds_s=dt, frames_per_s=n_total / dt, means=m)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--videos", type=int, default=6)
    p.add_argument("--frames", type=int, default=50)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--metrics", type=str, nargs="*", default=["cc", "sim", "auc_judd"],
                   help="default = the MATLAB evaluator's active set "
                        "(metric_video_base.m:11-16 masks the others)")
    _timing.add_common_args(p)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    n_total = args.videos * args.frames
    dev = str(device)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        make_tree(root, args.videos, args.frames, tuple(args.size))
        for label, kw in (("workers=1", dict(device="host", workers=1)),
                          ("workers=auto", dict(device="host", workers=None)),
                          (f"{dev} (warmup)", dict(device=dev)),
                          (dev, dict(device=dev))):
            out[label] = run(label, root, args.metrics, True, n_total, **kw)
        checks = {"fixations": hold_means("fixations", out[dev]["means"],
                                          out["workers=auto"]["means"])}
        if "auc_judd" in args.metrics:
            for label, kw in (("dense-gt host workers=auto", dict(device="host")),
                              (f"dense-gt {dev} (warmup)", dict(device=dev)),
                              (f"dense-gt {dev}", dict(device=dev))):
                out[label] = run(label, root, args.metrics, False, n_total, **kw)
            checks["dense"] = hold_means("dense-gt", out[f"dense-gt {dev}"]["means"],
                                         out["dense-gt host workers=auto"]["means"])
    return _timing.emit("bench_eval", device, dict(
        videos=args.videos, frames=args.frames, size=list(args.size), metrics=args.metrics,
        runs=out, card_minus_host=checks))


if __name__ == "__main__":
    main()
