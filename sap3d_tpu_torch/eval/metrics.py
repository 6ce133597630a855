"""Saliency metrics on the device, batched over ``[N, H, W]`` maps.

Counterpart of ``sap3d_tpu/eval/metrics_jax.py``: ``cc``, ``sim``, ``nss``,
``kldiv``, ``auc_judd``, ``auc_borji`` and ``auc_shuffled`` with the JAX
package's formulas and static sweep widths, on the maps' device.  The
sampled AUCs draw their negatives from an explicit ``torch.Generator`` on
that device, so they match the NumPy oracle in distribution, not bitwise
(both are Monte-Carlo over the sampler).  The NumPy oracle, a copy of
``sap3d_tpu/eval/metrics.py``, is ``eval/metrics_np.py``; its NaN-filtered
mean is the reporting reduction here too.
"""

from __future__ import annotations

import numpy as np
import torch

from sap3d_tpu_torch.eval.metrics_np import nan_filtered_mean  # noqa: F401

_EPS_KL = 2.2204e-16


def _standardize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    std, mean = torch.std_mean(x, dim=(-2, -1), keepdim=True, correction=0)
    return (x - mean) / std


def cc(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pearson correlation per map: [..., H, W] x 2 -> [...]."""
    n = pred.shape[-1] * pred.shape[-2]
    return (_standardize(pred) * _standardize(gt)).sum(dim=(-2, -1)) / n


def sim(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Histogram intersection per map after range and sum normalization."""

    def norm(x):
        x = x.float()
        lo = x.amin(dim=(-2, -1), keepdim=True)
        hi = x.amax(dim=(-2, -1), keepdim=True)
        x = (x - lo) / (hi - lo)
        return x / x.sum(dim=(-2, -1), keepdim=True)

    return torch.minimum(norm(pred), norm(gt)).sum(dim=(-2, -1))


def nss(pred: torch.Tensor, fixations: torch.Tensor) -> torch.Tensor:
    """Mean standardized saliency at the fixations (binarized > 0.5) per
    map; NaN for a map with no fixations."""
    f = (fixations > 0.5).float()
    count = f.sum(dim=(-2, -1))
    total = (_standardize(pred) * f).sum(dim=(-2, -1))
    return torch.where(count > 0, total / count, torch.nan)


def kldiv(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """KL divergence of sum-normalized maps."""

    def norm(x):
        x = x.float()
        s = x.sum(dim=(-2, -1), keepdim=True)
        return torch.where(s > 0, x / s, x)

    p, g = norm(pred), norm(gt)
    return (g * torch.log(_EPS_KL + g / (p + _EPS_KL))).sum(dim=(-2, -1))


def auc_judd(pred: torch.Tensor, fixations: torch.Tensor,
             generator: torch.Generator | None = None,
             fix_cap: int = 4096) -> torch.Tensor:
    """AUC-Judd per map: pred/fixations [N, H, W] -> [N].

    Thresholds are the fixated pixels' saliency values, descending; the sweep
    has the static width ``min(fix_cap, H*W)`` and is masked past each map's
    fixation count.  NaN for maps without fixations, with every pixel
    fixated, or with more fixations than the cap.  With ``generator``, ties
    are broken by uniform jitter of 1e-4 (the JAX version's, drawn from
    another stream)."""
    n, h, w = pred.shape
    p = h * w
    s = pred.float().reshape(n, p)
    if generator is not None:
        s = s + torch.rand(s.shape, generator=generator, device=s.device) * 1e-4
    f = (fixations > 0.5).reshape(n, p)
    n_fix = f.sum(dim=1)
    cap = min(fix_cap, p)

    s_sorted = torch.sort(s, dim=1).values
    thr = torch.topk(torch.where(f, s, torch.full_like(s, -torch.inf)), cap, dim=1).values
    above = p - torch.searchsorted(s_sorted, thr.contiguous(), side="left")  # #{S >= thr}

    k = torch.arange(1, cap + 1, dtype=torch.float32, device=s.device)[None, :]
    valid = k <= n_fix[:, None]
    nf = n_fix.clamp_min(1).float()[:, None]
    tp = torch.where(valid, k / nf, 1.0)
    fp = torch.where(valid, (above - k) / (p - nf).clamp_min(1.0), 1.0)
    zeros, ones = s.new_zeros(n, 1), s.new_ones(n, 1)
    auc = _trapz_rows(torch.cat([zeros, tp, ones], dim=1), torch.cat([zeros, fp, ones], dim=1))
    ok = (n_fix > 0) & (n_fix <= cap) & (n_fix < p)
    return torch.where(ok, auc, torch.nan)


def _trapz_rows(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise trapezoid integral of y over x ([..., K] -> [...])."""
    return (0.5 * (y[..., 1:] + y[..., :-1]) * (x[..., 1:] - x[..., :-1])).sum(dim=-1)


def _range_normalize_rows(pred: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, H, W] -> ([N, H*W] range-normalized into [0, 1], [N] constant
    rows)."""
    s = pred.float().reshape(pred.shape[0], -1)
    lo = s.amin(dim=1, keepdim=True)
    hi = s.amax(dim=1, keepdim=True)
    constant = (hi - lo)[:, 0] <= 0
    return (s - lo) / torch.where(hi > lo, hi - lo, 1.0), constant


def _count_at_least(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """#{values >= t} along the last axis for each threshold:
    [..., K] x [T] -> [..., T]."""
    ordered = torch.sort(values, dim=-1).values
    t = thresholds.expand(*values.shape[:-1], thresholds.numel()).contiguous()
    return values.shape[-1] - torch.searchsorted(ordered, t, side="left")


def _auc_sampled_negatives(s: torch.Tensor, f: torch.Tensor, n_fix: torch.Tensor,
                           s_rand: torch.Tensor, step_size: float) -> torch.Tensor:
    """The Borji / shuffled curve per map: tp from the fixated pixels of the
    range-normalized maps ``s`` [N, P] (``f`` the fixation mask), fp from
    the sampled negatives ``s_rand`` [N, R, cap] (-inf past each map's
    ``n_fix``), the trapezoid over the static descending threshold grid
    0, step, ..., 1 (exact after range normalization: thresholds above a
    repetition's largest value add zero area), averaged over the R
    repetitions -> [N]."""
    n, n_rep, _ = s_rand.shape
    nf = n_fix.clamp_min(1).float()
    # the JAX package's float32 grid (i * step in float32), descending
    n_t = np.arange(0.0, 1.0 + step_size, step_size).size
    thresholds = (torch.arange(n_t, dtype=torch.float32, device=s.device)
                  * step_size).flip(0)
    tp = _count_at_least(torch.where(f, s, -torch.inf), thresholds) / nf[:, None]  # [N, T]
    fp = _count_at_least(s_rand, thresholds) / nf[:, None, None]  # [N, R, T]
    zeros = s.new_zeros(n, n_rep, 1)
    ones = s.new_ones(n, n_rep, 1)
    tp_full = torch.cat([zeros, tp[:, None, :].expand_as(fp), ones], dim=2)
    fp_full = torch.cat([zeros, fp, ones], dim=2)
    return _trapz_rows(tp_full, fp_full).mean(dim=1)


def _sampled_auc(pred, fixations, pixels, n_rep, step_size, fix_cap):
    """The shared body of ``auc_borji`` and ``auc_shuffled``: ``pixels(n,
    n_rep, cap)`` gives the flat pixel index of every negative draw."""
    n, h, w = pred.shape
    s, constant = _range_normalize_rows(pred)
    f = (fixations > 0.5).reshape(n, h * w)
    n_fix = f.sum(dim=1)
    cap = min(fix_cap, h * w)
    # cap draws per repetition; only the first n_fix of each count
    s_rand = torch.gather(s, 1, pixels(n, n_rep, cap).reshape(n, -1)).reshape(n, n_rep, cap)
    live = torch.arange(cap, device=s.device)[None, None, :] < n_fix[:, None, None]
    s_rand = torch.where(live, s_rand, -torch.inf)
    auc = _auc_sampled_negatives(s, f, n_fix, s_rand, step_size)
    return torch.where((n_fix > 0) & ~constant & (n_fix <= cap), auc, torch.nan)


def auc_borji(pred: torch.Tensor, fixations: torch.Tensor, generator: torch.Generator,
              n_rep: int = 100, step_size: float = 0.1, fix_cap: int = 4096) -> torch.Tensor:
    """AUC-Borji per map: pred/fixations [N, H, W] -> [N].

    Negatives are uniform pixel draws from ``generator`` (on the maps'
    device): ``min(fix_cap, H*W)`` per repetition, of which the first n_fix
    count, so each repetition samples as many negatives as the NumPy
    oracle's.  NaN for maps without fixations, for constant maps and past
    the cap."""
    p = pred.shape[-2] * pred.shape[-1]
    return _sampled_auc(
        pred, fixations,
        lambda n, r, cap: torch.randint(0, p, (n, r, cap), generator=generator,
                                        device=pred.device),
        n_rep, step_size, fix_cap)


def auc_shuffled(pred: torch.Tensor, fixations: torch.Tensor, other_idx: torch.Tensor,
                 generator: torch.Generator, n_rep: int = 100, step_size: float = 0.1,
                 fix_cap: int = 4096) -> torch.Tensor:
    """Shuffled AUC per map: negatives drawn from the flat pixel indices
    ``other_idx`` [M] of other videos' fixations (the NumPy oracle's
    ``AUC_shuffled``).  Draws are with replacement, as the JAX version's
    (the oracle permutes the pool per repetition); for a pool much larger
    than n_fix the two agree within Monte-Carlo noise.  NaN also when the
    pool is empty."""
    if other_idx.numel() == 0:
        return torch.full((pred.shape[0],), torch.nan, device=pred.device)
    pool = other_idx.to(pred.device, torch.int64)
    return _sampled_auc(
        pred, fixations,
        lambda n, r, cap: pool[torch.randint(0, pool.numel(), (n, r, cap), generator=generator,
                                             device=pred.device)],
        n_rep, step_size, fix_cap)
