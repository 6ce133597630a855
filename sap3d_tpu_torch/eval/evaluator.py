"""Checkpoint evaluator and the batch scorer of exported saliency maps.

Counterpart of ``sap3d_tpu/eval/evaluator.py``, with the same protocol
(reference test.py:79-183):

* ``evaluate_prediction_batches``: the model's forward on the device over
  test-mode batches (frames at 112, densities at (960, 1080), fixations at
  native resolution); per clip the last frame's prediction, resized
  bilinearly to (960, 1080) on the forward's device, is scored with the
  NumPy metrics (``eval/metrics_np.py``): CC and SIM against the density,
  NSS, AUC-Judd and AUC-Borji against the fixations; NaN-filtered means.
* ``evaluate_saliency_dirs``: per-video scores of exported maps against
  ground-truth trees (the reference's MATLAB batch evaluator), on the host
  per frame with the NumPy metrics (``device="host"``), or batched with the
  device metrics (``eval/metrics.py``) on a torch device (``"cuda"``, the
  default, or ``"cpu"``).  ``score_density`` and ``score_fixations`` are the
  batched scoring on arrays, which needs no files and no ``cv2``.

Reading files and resizing maps of another shape use ``cv2``, imported
where it is needed.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from sap3d_tpu_torch.core.device import resolve_device
from sap3d_tpu_torch.eval import metrics as MD
from sap3d_tpu_torch.eval import metrics_np as M

# The device path's sweeps: AUC-Judd and AUC-Borji take at most this many
# fixations per map at their default width (metrics.py's ``fix_cap``).
FIX_CAP = 4096


def resize_bilinear(maps: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """[N, H, W] -> [N, out_size[1], out_size[0]] float32, bilinear with
    half-pixel centres (``cv2.resize``'s default for ``dsize=out_size``), on
    the maps' device."""
    return F.interpolate(maps.float()[:, None], size=(out_size[1], out_size[0]),
                         mode="bilinear", align_corners=False)[:, 0]


def evaluate_prediction_batches(
    batches: Iterable,
    forward_fn: Callable[[np.ndarray], torch.Tensor],
    out_size: tuple[int, int] = (960, 1080),
    log_every: int = 100,
    rng: np.random.Generator | None = None,
) -> dict:
    """Run the model over (frames, densities, fixations) batches and score.

    forward_fn: frames [B, T, H, W, 3] float32 -> saliency [B, T, H, W]
    (a tensor on the forward's device).  The last frame's map is resized to
    ``out_size`` (width, height) there before it is scored, as the
    reference resizes it before scoring (reference test.py:168)."""
    rng = rng or np.random.default_rng(0)
    cc, sim, nss, auc_judd, auc_borji = [], [], [], [], []
    index = 0
    for frames, densities, fixations in batches:
        index += 1
        pred = torch.as_tensor(forward_fn(frames))
        last = resize_bilinear(pred[:, -1], out_size).cpu().numpy()
        for b in range(last.shape[0]):
            p = last[b]
            density = densities[b, -1]
            fixation = fixations[b, -1]
            cc.append(M.CC(p, density))
            sim.append(M.SIM(p, density))
            nss.append(M.NSS(p, fixation))
            auc_judd.append(M.AUC_Judd(p, fixation, rng=rng))
            auc_borji.append(M.AUC_Borji(p, fixation, rng=rng))
        if log_every and index % log_every == 0:
            print(
                f" Step: {index}, Metrics: CC: {M.nan_filtered_mean(cc):.3f}  "
                f"SIM: {M.nan_filtered_mean(sim):.3f}   "
                f"NSS: {M.nan_filtered_mean(nss):.3f}  "
                f"AUC_Judd: {M.nan_filtered_mean(auc_judd):.3f}   "
                f"AUC_Borji: {M.nan_filtered_mean(auc_borji):.3f}"
            )
    return {
        "n": len(cc),
        "cc": M.nan_filtered_mean(cc),
        "sim": M.nan_filtered_mean(sim),
        "nss": M.nan_filtered_mean(nss),
        "auc_judd": M.nan_filtered_mean(auc_judd),
        "auc_borji": M.nan_filtered_mean(auc_borji),
    }


# ---- batched scoring on arrays ------------------------------------------------


def score_density(metrics: tuple[str, ...], pred: np.ndarray, gt: np.ndarray,
                  device) -> dict[str, list[float]]:
    """cc, sim and kldiv (those named in ``metrics``) of each map of
    ``pred`` [N, H, W] (at the densities' shape) against ``gt`` [N, H, W],
    batched on ``device``."""
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    g = torch.as_tensor(np.asarray(gt, np.float32), device=device)
    fns = {"cc": lambda: MD.cc(p, g), "sim": lambda: MD.sim(p, g),
           "kldiv": lambda: MD.kldiv(p.clamp_min(0.0), g)}
    return {m: fn().tolist() for m, fn in fns.items() if m in metrics}


def score_fixations(metrics: tuple[str, ...], pred: np.ndarray, target: np.ndarray,
                    has_fix: np.ndarray, generator: torch.Generator,
                    rng: np.random.Generator, device, pred_linear: np.ndarray | None = None,
                    pool: np.ndarray | None = None,
                    stats: dict[str, int] | None = None) -> dict[str, list[float]]:
    """nss, auc_judd, auc_borji and auc_shuffled (those named in
    ``metrics``) of ``pred`` [N, H, W] (bicubic at the targets' shape;
    ``pred_linear``, bilinear, for NSS, default ``pred``) against
    ``target`` [N, H, W], batched on ``device``.  ``target`` is a fixation
    map where ``has_fix`` [N] is true, else the density (AUC-Judd only, as
    the host path falls back).  nss, auc_borji and auc_shuffled score the
    maps with fixations only; auc_shuffled draws its negatives from ``pool``
    (flat pixel indices of other videos' fixations at this shape) and runs
    only with one.  Random draws come from ``generator`` (on ``device``),
    in the order auc_shuffled, auc_judd, auc_borji.  A map with more active
    pixels than ``FIX_CAP`` is swept again with a cap that holds it
    (AUC-Judd), or scored on the host with ``rng`` (AUC-Borji); ``stats``
    counts both."""
    stats = {} if stats is None else stats
    for key in ("judd_frames", "judd_dense_device", "borji_frames", "borji_host_fallback"):
        stats.setdefault(key, 0)
    has_fix = np.asarray(has_fix, bool)
    pred, target = np.asarray(pred, np.float32), np.asarray(target, np.float32)
    n = len(has_fix)
    p = torch.as_tensor(pred, device=device)
    t = torch.as_tensor(target, device=device)
    out: dict[str, list[float]] = {}
    if "auc_shuffled" in metrics and pool is not None and has_fix.any():
        v = MD.auc_shuffled(p, t, torch.as_tensor(pool), generator).tolist()
        out["auc_shuffled"] = [v[b] for b in range(n) if has_fix[b]]
    active = (target > 0.5).reshape(n, -1).sum(axis=1)
    over = active > min(FIX_CAP, target[0].size)
    if "auc_judd" in metrics:
        stats["judd_frames"] += n
        v = MD.auc_judd(p, t, generator).tolist()
        sel = np.flatnonzero(over)
        if sel.size:
            # dense targets: one more sweep, wide enough, in chunks whose
            # [N, cap] sweep arrays stay near 32 MB
            cap = int(active[sel].max())
            step = max(1, (1 << 23) // cap)
            for c0 in range(0, sel.size, step):
                part = sel[c0:c0 + step]
                idx = torch.as_tensor(part, device=p.device)
                for b, x in zip(part, MD.auc_judd(p[idx], t[idx], generator,
                                                  fix_cap=cap).tolist()):
                    v[b] = x
            stats["judd_dense_device"] += int(sel.size)
        out["auc_judd"] = v
    if "auc_borji" in metrics:
        stats["borji_frames"] += int(has_fix.sum())
        stats["borji_host_fallback"] += int((over & has_fix).sum())
        v = MD.auc_borji(p, t, generator).tolist()
        out["auc_borji"] = [M.AUC_Borji(pred[b], target[b], rng=rng)
                            if over[b] else v[b] for b in range(n) if has_fix[b]]
    if "nss" in metrics and has_fix.any():
        pl = p if pred_linear is None else torch.as_tensor(np.asarray(pred_linear, np.float32),
                                                           device=device)
        v = MD.nss(pl, t).tolist()
        out["nss"] = [v[b] for b in range(n) if has_fix[b]]
    return out


# ---- per-video scoring of exported maps -------------------------------------


def _read_gray(path: str) -> np.ndarray:
    import cv2

    from sap3d_tpu_torch.data.pipeline import imread_checked

    return imread_checked(path, cv2.IMREAD_GRAYSCALE).astype(np.float64) / 255.0


def _resize_nearest(mask: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(mask.astype(np.uint8), (shape[1], shape[0]),
                      interpolation=cv2.INTER_NEAREST) > 0


def _video_frame_pairs(
    vdir: str, vname: str, density_root: str, fixation_root: str | None
) -> list[tuple[str, str, str | None]]:
    """Sorted (pred, density, fixation|None) path triples for one video."""
    out = []
    for pf in sorted(
        glob.glob(os.path.join(vdir, "*.jpg")),
        key=lambda p: int(os.path.basename(p).split("_")[-1].split(".")[0]),
    ):
        fname = os.path.basename(pf)
        gt_path = os.path.join(density_root, vname, fname)
        if not os.path.exists(gt_path):
            continue
        fix_path = None
        if fixation_root:
            cand = os.path.join(fixation_root, vname, fname.rsplit(".", 1)[0] + ".bmp")
            if os.path.exists(cand):
                fix_path = cand
        out.append((pf, gt_path, fix_path))
    return out


def _fixation_union(
    pairs: list[tuple[str, str, str | None]], max_frames: int = 20
) -> np.ndarray | None:
    """OR of up to ``max_frames`` evenly strided fixation maps of a video
    (native resolution): the negative pool of the shuffled AUC for the other
    videos (the JAX package's documented deviation from the reference, which
    pools every frame)."""
    fix_paths = [fp for _, _, fp in pairs if fp is not None]
    if not fix_paths:
        return None
    stride = max(1, len(fix_paths) // max_frames)
    union = None
    for fp in fix_paths[::stride][:max_frames]:
        m = _read_gray(fp) > 0.5
        union = m if union is None else (union | m)
    return union


def _score_video(
    pairs: list[tuple[str, str, str | None]],
    metrics: tuple[str, ...],
    rng: np.random.Generator,
    other_union: np.ndarray | None,
) -> dict[str, float]:
    """One video's scores on the host, frame by frame, with the NumPy
    metrics."""
    scores: dict[str, list] = {m: [] for m in metrics}
    other_resized: dict[tuple[int, int], np.ndarray] = {}
    for pf, gt_path, fix_path in pairs:
        pred = _read_gray(pf)
        gt = _read_gray(gt_path)
        fix = _read_gray(fix_path) if fix_path else None
        for m in metrics:
            if m == "cc":
                scores[m].append(M.CC(pred, gt))
            elif m == "sim":
                scores[m].append(M.SIM(pred, gt))
            elif m == "kldiv":
                scores[m].append(M.KLdiv(pred, gt))
            elif m == "nss" and fix is not None:
                scores[m].append(M.NSS(pred, fix))
            elif m == "auc_judd":
                target = fix if fix is not None else gt
                scores[m].append(M.AUC_Judd(pred, target, rng=rng))
            elif m == "auc_borji" and fix is not None:
                scores[m].append(M.AUC_Borji(pred, fix, rng=rng))
            elif m == "auc_shuffled" and fix is not None and other_union is not None:
                if fix.shape not in other_resized:
                    other_resized[fix.shape] = _resize_nearest(other_union, fix.shape)
                scores[m].append(M.AUC_shuffled(pred, fix, other_resized[fix.shape], rng=rng))
    return {m: M.nan_filtered_mean(v) for m, v in scores.items() if v}


def _score_video_device(
    pairs: list[tuple[str, str, str | None]],
    metrics: tuple[str, ...],
    rng: np.random.Generator,
    device: torch.device,
    other_union: np.ndarray | None = None,
    batch: int = 32,
    stats: dict[str, int] | None = None,
) -> dict[str, float]:
    """One video's scores with the metric arithmetic batched on ``device``.

    Decoding and resizing stay on the host (``cv2``: bicubic to the target's
    shape, bilinear for NSS, as the NumPy metrics resize); frames go in
    chunks of ``batch`` to ``score_density`` and, bucketed by target shape,
    to ``score_fixations``.  The random draws come from a generator on
    ``device`` seeded from ``rng``, so the sampled AUCs match the host path
    in distribution."""
    import cv2

    generator = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**31)))
    scores: dict[str, list] = {m: [] for m in metrics}
    want_fix = {"nss", "auc_judd", "auc_borji", "auc_shuffled"} & set(metrics)
    pools: dict[tuple, np.ndarray] = {}

    def resize_stack(preds, targets, interpolation):
        return np.stack([
            cv2.resize(p, (t.shape[1], t.shape[0]), interpolation=interpolation)
            if p.shape != t.shape else p
            for p, t in zip(preds, targets)]).astype(np.float32)

    def pool(shape):
        if other_union is None:
            return None
        if shape not in pools:
            pools[shape] = np.flatnonzero(_resize_nearest(other_union, shape))
        return pools[shape]

    for i in range(0, len(pairs), batch):
        chunk = pairs[i:i + batch]
        preds = [_read_gray(pf) for pf, _, _ in chunk]
        gts = [_read_gray(gp) for _, gp, _ in chunk]
        if {"cc", "sim", "kldiv"} & set(metrics):
            for m, v in score_density(metrics, resize_stack(preds, gts, cv2.INTER_CUBIC),
                                      np.stack(gts), device).items():
                scores[m] += v
        if not want_fix:
            continue
        fixes = [_read_gray(fp) if fp else None for _, _, fp in chunk]
        targets = [f if f is not None else g for f, g in zip(fixes, gts)]
        buckets: dict[tuple, list[int]] = {}
        for j, t in enumerate(targets):
            buckets.setdefault(t.shape, []).append(j)
        for shape, idxs in buckets.items():
            tgt = [targets[j] for j in idxs]
            bucket_preds = [preds[j] for j in idxs]
            for m, v in score_fixations(
                    metrics, resize_stack(bucket_preds, tgt, cv2.INTER_CUBIC), np.stack(tgt),
                    np.array([fixes[j] is not None for j in idxs]), generator, rng, device,
                    pred_linear=resize_stack(bucket_preds, tgt, cv2.INTER_LINEAR),
                    pool=pool(shape), stats=stats).items():
                scores[m] += v
    return {m: M.nan_filtered_mean(v) for m, v in scores.items() if v}


def evaluate_saliency_dirs(
    pred_root: str,
    density_root: str,
    fixation_root: str | None = None,
    metrics: tuple[str, ...] = ("cc", "sim", "auc_judd"),
    rng: np.random.Generator | None = None,
    workers: int | None = None,
    device: str = "cuda",
) -> dict[str, dict[str, float]]:
    """Score exported saliency maps against ground truth, per video.

    ``device="host"`` scores frame by frame with the NumPy metrics, videos
    on a thread pool of ``workers`` (the reference's MATLAB ``parfor``);
    any other value is a torch device (default ``"cuda"``; ``"cpu"`` runs
    the same batched metrics on the CPU) on which each video's frames are
    scored in chunks, videos one after another.  ``auc_shuffled`` draws its
    negatives from the union of the other videos' fixation maps and needs
    ``fixation_root``.  Returns {video: {metric: mean score}}; for a fixed
    ``rng`` the same whatever the worker count (the per-video child seeds
    are drawn first, in sorted-name order)."""
    rng = rng or np.random.default_rng(0)
    vdirs = [d for d in sorted(glob.glob(os.path.join(pred_root, "*"))) if os.path.isdir(d)]
    vnames = [os.path.basename(d) for d in vdirs]
    all_pairs = [_video_frame_pairs(d, v, density_root, fixation_root)
                 for d, v in zip(vdirs, vnames)]

    others: list[np.ndarray | None] = [None] * len(vdirs)
    if "auc_shuffled" in metrics and fixation_root:
        unions = [_fixation_union(p) for p in all_pairs]
        for i in range(len(vdirs)):
            pool = [u for j, u in enumerate(unions) if j != i and u is not None]
            if pool:
                # OR the other videos' unions at the largest native shape
                shape = max((u.shape for u in pool), key=lambda s: s[0] * s[1])
                acc = np.zeros(shape, bool)
                for u in pool:
                    acc |= u if u.shape == shape else _resize_nearest(u, shape)
                others[i] = acc

    child_rngs = [np.random.default_rng(s) for s in rng.spawn(len(vdirs))] if vdirs else []
    if device != "host":
        dev = resolve_device(device)
        stats: dict[str, int] = {}
        result = {v: _score_video_device(pairs, metrics, crng, dev, other, stats=stats)
                  for v, pairs, crng, other in zip(vnames, all_pairs, child_rngs, others)}
        if stats.get("judd_dense_device") or stats.get("borji_host_fallback"):
            print(f"[eval-dirs --device {device}] dense targets: "
                  f"{stats['judd_dense_device']}/{stats['judd_frames']} AUC-Judd frames "
                  f"swept again on the device with a wider cap; "
                  f"{stats['borji_host_fallback']}/{stats['borji_frames']} AUC-Borji "
                  "frames scored on the host")
        return result
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers, thread_name_prefix="eval") as pool:
        futs = [pool.submit(_score_video, pairs, metrics, crng, other)
                for pairs, crng, other in zip(all_pairs, child_rngs, others)]
        return {v: f.result() for v, f in zip(vnames, futs)}
