"""Host-side NumPy saliency metrics, formula-identical to the reference:
a copy of ``sap3d_tpu/eval/metrics.py`` (the port imports nothing of
``sap3d_tpu``).

It is the oracle the device metrics (``eval/metrics.py``, the counterpart of
``sap3d_tpu/eval/metrics_jax.py``) are held against, and what the
evaluator (``eval/evaluator.py``) scores with on the host.  The port's
``eval/metrics.py`` already holds the device metrics, so this copy takes
another name.  Each function works on one 2D map and resizes the prediction
to the ground truth's shape on a mismatch (bicubic, as the reference's
skimage order=3 / MATLAB imresize; bilinear for NSS), with ``cv2``, which is
imported only then: maps of one shape need no ``cv2``.

AUC_Judd computes the reference's O(n_fix * n_pixels) loop as one sort and a
searchsorted (O(n log n)); the tests of the JAX package hold that against a
direct transcription.
"""

from __future__ import annotations

import numpy as np


def _resize_to(src: np.ndarray, shape: tuple[int, int], linear: bool = False) -> np.ndarray:
    """Resize to (rows, cols) — stand-in for skimage resize.

    Bicubic by default (the reference passes order=3 in AUC_Judd/AUC_Borji/CC,
    reference utils/metrics.py:56,127,247); NSS passes ``linear`` because the
    reference's NSS calls resize() with the skimage default order=1
    (reference utils/metrics.py:219)."""
    if src.shape == shape:
        return src
    import cv2

    return cv2.resize(src.astype(np.float64), (shape[1], shape[0]),
                      interpolation=cv2.INTER_LINEAR if linear else cv2.INTER_CUBIC)


def normalize(x: np.ndarray, method: str = "standard") -> np.ndarray:
    """standard / range / sum normalization (reference metric_utils.py:10-53)."""
    x = np.asarray(x, dtype=np.float64)
    if method == "standard":
        return (x - np.mean(x)) / np.std(x)
    if method == "range":
        return (x - np.min(x)) / (np.max(x) - np.min(x))
    if method == "sum":
        return x / float(np.sum(x))
    raise ValueError('method not in {"standard", "range", "sum"}')


def AUC_Judd(
    saliency_map: np.ndarray,
    fixation_map: np.ndarray,
    jitter: bool = True,
    rng: np.random.Generator | None = None,
) -> float:
    """AUC with thresholds at the saliency values of each fixation.

    Formula parity with reference utils/metrics.py:25-85; the tp/fp sweep is
    vectorized but produces the same trapezoid (tests compare against a
    direct loop transcription).  Returns NaN when the fixation map is empty.
    """
    s = np.asarray(saliency_map, dtype=np.float64)
    f = np.asarray(fixation_map) > 0.5
    if not np.any(f):
        return float("nan")
    if s.shape != f.shape:
        s = _resize_to(s, f.shape)
    if jitter:
        r = rng or np.random.default_rng()
        s = s + r.random(s.shape) * 1e-7

    S = s.ravel()
    F = f.ravel()
    S_fix = S[F]
    n_fix = S_fix.size
    n_pixels = S.size

    thresholds = np.sort(S_fix)[::-1]
    # above_th[k] = #{S >= thresholds[k]} via one sort of S.
    S_sorted = np.sort(S)
    above = n_pixels - np.searchsorted(S_sorted, thresholds, side="left")
    k = np.arange(1, n_fix + 1, dtype=np.float64)
    tp = np.concatenate([[0.0], k / n_fix, [1.0]])
    fp = np.concatenate([[0.0], (above - k) / (n_pixels - n_fix), [1.0]])
    return float(np.trapezoid(tp, fp))


def AUC_Borji(
    saliency_map: np.ndarray,
    fixation_map: np.ndarray,
    n_rep: int = 100,
    step_size: float = 0.1,
    rand_sampler=None,
    rng: np.random.Generator | None = None,
) -> float:
    """AUC against uniformly-sampled random locations (reference metrics.py:88-154)."""
    s = np.asarray(saliency_map, dtype=np.float64)
    f = np.asarray(fixation_map) > 0.5
    if not np.any(f):
        return float("nan")
    if s.shape != f.shape:
        s = _resize_to(s, f.shape)
    if s.max() == s.min():
        # constant map: range normalization is 0/0 (the reference emits a
        # NaN array here and the score is dropped by the NaN filter,
        # reference metric_utils.py:34-36 + test.py:177-183)
        return float("nan")
    s = normalize(s, "range")

    S = s.ravel()
    F = f.ravel()
    S_fix = S[F]
    n_fix = S_fix.size
    n_pixels = S.size
    r = rng or np.random.default_rng()
    if rand_sampler is None:
        idx = r.integers(0, n_pixels, size=(n_fix, n_rep))
        S_rand = S[idx]
    else:
        S_rand = rand_sampler(S, F, n_rep, n_fix)
    if S_rand.shape[0] == 0:
        # empty negative pool (e.g. a shuffled sampler whose other-map has
        # no fixations): every rep's fp is 0/0 — the per-rep loop this
        # vectorization replaced produced NaN curves here, filtered upstream
        return float("nan")

    # Vectorized across the n_rep repetitions (the reference loops per rep,
    # reference metrics.py:140-152).  Every rep's threshold list is the
    # descending multiples of step_size below its own max
    # (np.arange(0, hi_rep, step)[::-1]); using the GLOBAL grid for all reps
    # is exact: a threshold above a rep's max scores tp=fp=0, and extra
    # (0, 0) points contribute precisely zero trapezoid area.
    hi = float(max(S_fix.max(), S_rand.max()))
    thresholds = np.arange(0.0, hi, step_size)[::-1]  # [n_th], descending
    n_th = len(thresholds)
    tp = np.zeros((n_th + 2, n_rep))
    fp = np.zeros((n_th + 2, n_rep))
    tp[-1] = 1.0
    fp[-1] = 1.0
    # tp is rep-independent (same fixation saliencies every rep)
    tp[1:-1] = (
        (S_fix[None, :] >= thresholds[:, None]).sum(1) / float(n_fix)
    )[:, None]
    fp[1:-1] = (
        (S_rand[None, :, :] >= thresholds[:, None, None]).sum(1) / float(n_fix)
    )
    auc = np.trapezoid(tp, fp, axis=0)
    return float(np.mean(auc))


def AUC_shuffled(
    saliency_map: np.ndarray,
    fixation_map: np.ndarray,
    other_map: np.ndarray,
    n_rep: int = 100,
    step_size: float = 0.1,
    rng: np.random.Generator | None = None,
) -> float:
    """Shuffled AUC: negatives sampled from fixations on OTHER images
    (reference utils/metrics.py:157-197)."""
    other = np.asarray(other_map) > 0.5
    fix = np.asarray(fixation_map)
    if other.shape != fix.shape:
        raise ValueError("other_map.shape != fixation_map.shape")
    r = rng or np.random.default_rng()

    def sample_other(S, F, n_rep_, n_fix):
        fixated = np.nonzero(other.ravel())[0]
        rows = [r.permutation(len(fixated))[:n_fix] for _ in range(n_rep_)]
        idx = fixated[np.stack(rows, axis=1)]  # [n_fix, n_rep]
        return S[idx]

    return AUC_Borji(saliency_map, fixation_map, n_rep, step_size, sample_other, rng=r)


def NSS(saliency_map: np.ndarray, fixation_map: np.ndarray) -> float:
    """Mean standardized saliency at fixations (reference metrics.py:200-224).

    Resize is bilinear: the reference's NSS is the one metric that calls
    resize() without order=3 (reference utils/metrics.py:219, skimage default
    order=1)."""
    s = np.asarray(saliency_map, dtype=np.float64)
    f = np.asarray(fixation_map) > 0.5
    if s.shape != f.shape:
        s = _resize_to(s, f.shape, linear=True)
    s = normalize(s, "standard")
    return float(np.mean(s[f]))


def CC(saliency_map1: np.ndarray, saliency_map2: np.ndarray) -> float:
    """Pearson correlation of standardized maps (reference metrics.py:227-250).

    Computed directly from the moment sums (one pass per map) rather than
    standardize + np.corrcoef (which costs ~8 full-map passes + temporaries);
    Pearson is invariant to the standardization so the value is identical
    (oracle-checked in tests/test_metrics.py)."""
    m1 = np.asarray(saliency_map1, dtype=np.float64)
    m2 = np.asarray(saliency_map2, dtype=np.float64)
    if m1.shape != m2.shape:
        m1 = _resize_to(m1, m2.shape)
    a = m1.ravel()
    b = m2.ravel()
    am = a.mean()
    bm = b.mean()
    cov = np.dot(a, b) / a.size - am * bm
    va = np.dot(a, a) / a.size - am * am
    vb = np.dot(b, b) / b.size - bm * bm
    return float(cov / np.sqrt(va * vb))


def SIM(saliency_map1: np.ndarray, saliency_map2: np.ndarray) -> float:
    """Histogram intersection of range+sum-normalized maps
    (reference metrics.py:258-287)."""
    m1 = np.asarray(saliency_map1, dtype=np.float64)
    m2 = np.asarray(saliency_map2, dtype=np.float64)
    if m1.shape != m2.shape:
        m1 = _resize_to(m1, m2.shape)
    m1 = normalize(normalize(m1, "range"), "sum")
    m2 = normalize(normalize(m2, "range"), "sum")
    return float(np.sum(np.minimum(m1, m2)))


def KLdiv(saliency_map: np.ndarray, fixation_map: np.ndarray) -> float:
    """KL divergence of sum-normalized maps (reference metrics.py:338-361).

    The reference used the long-deprecated scipy.misc.imresize (uint8 PIL
    path); here the prediction is bicubic-resized in float, then both maps are
    sum-normalized with the same eps and formula.
    """
    m1 = np.asarray(saliency_map, dtype=np.float32)
    m2 = np.asarray(fixation_map, dtype=np.float32)
    if m1.shape != m2.shape:
        # clip bicubic overshoot: the reference's uint8 imresize path could
        # not produce negatives, and log() requires a non-negative density.
        m1 = np.clip(_resize_to(m1, m2.shape), 0.0, None).astype(np.float32)
    if m1.any():
        m1 = m1 / m1.sum()
    if m2.any():
        m2 = m2 / m2.sum()
    eps = np.float32(2.2204e-16)
    return float(np.sum(m2 * np.log(eps + m2 / (m1 + eps))))


def nan_filtered_mean(values) -> float:
    """NaN-filtered mean, the reference's reporting reduction
    (reference train.py:261-264, test.py:177-183)."""
    arr = np.asarray(values, dtype=np.float64)
    arr = arr[~np.isnan(arr)]
    return float(np.mean(arr)) if arr.size else float("nan")
