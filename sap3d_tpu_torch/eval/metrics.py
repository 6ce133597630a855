"""Saliency metrics on the device, batched over ``[N, H, W]`` maps.

The subset of ``sap3d_tpu/eval/metrics_jax.py`` that validation uses
(``cc``, ``sim``, ``kldiv``, ``auc_judd``) and the NaN-filtered mean of
``sap3d_tpu/eval/metrics.py``.  The formulas are the JAX package's; NSS, the
Borji and shuffled AUCs and the evaluator port with ``cli eval`` (ROADMAP
A.7).
"""

from __future__ import annotations

import numpy as np
import torch

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
    tp = torch.cat([zeros, tp, ones], dim=1)
    fp = torch.cat([zeros, fp, ones], dim=1)
    auc = (0.5 * (tp[:, 1:] + tp[:, :-1]) * (fp[:, 1:] - fp[:, :-1])).sum(dim=1)
    ok = (n_fix > 0) & (n_fix <= cap) & (n_fix < p)
    return torch.where(ok, auc, torch.nan)


def nan_filtered_mean(values) -> float:
    """Mean ignoring NaNs (the reference's reporting reduction); NaN when
    nothing is left."""
    arr = np.asarray(values, dtype=np.float64)
    arr = arr[~np.isnan(arr)]
    return float(np.mean(arr)) if arr.size else float("nan")
