"""Fused attention backward (kernels B3 and B4): the CUDA kernel and its
plain version.

Counterpart of ``sap3d_tpu/ops/pallas/flash_attention.py``'s
``_flash_backward``: dq, dk, dv of ``o = softmax(q k^T) v`` (unscaled) from
``(q, k, v, o, lse, do)``, with one exponential per score:

    delta = rowsum(do * o) - dlse,  p = exp(q k^T - lse),
    ds = p * (do v^T - delta),  dq = ds k,  dk = ds^T q,  dv = p^T do

* B3 (``dlse=None``): the custom_vjp backward rule of
  ``flash_attend_tokens`` that training runs;
* B4 (``dlse`` given, ``[B, Nq]`` float32): the backward rule of
  ``flash_attend_tokens_lse``, whose lse the ring-attention hop merge
  consumes; ``d lse / d s = p`` folds the lse cotangent into delta.  The TPU
  kernel's ``[B, 8, Nq]`` sublane layout is not kept.

``flash_backward`` launches ``csrc/flash_attention_bwd.cu`` for CUDA tensors
and runs ``flash_backward_reference`` only for CPU tensors.  On a CUDA
tensor it launches the kernel or raises; it never falls back.
``flash_backward.launches`` counts B3's launches and
``flash_backward.launches_lse`` B4's.

``backward_viable`` is the dispatch gate of a differentiated site: B2's gate
and the backward kernel's further limits on C (``backward_c_ok``); the
constants are checked against the library's own when it loads.
"""

from __future__ import annotations

import ctypes

import torch

from sap3d_tpu_torch.ops.cuda import build
from sap3d_tpu_torch.ops.cuda.flash_attention import (
    C_MULTIPLE,
    MAX_D,
    contiguous_aligned,
    forward_viable,
    pad_rows,
)

SOURCE = "flash_attention_bwd"
# The kernel's own limits beyond the forward's (csrc/flash_attention_bwd.cu):
# C up to MAX_C; above NARROW_MAX_C (8 warps of 16 columns) a multiple of
# WIDE_C_MULTIPLE.
MAX_C = 512
WIDE_C_MULTIPLE = 64
NARROW_MAX_C = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows per step of the plain version: bounds its [B, rows, Nk] float32
# temporaries (about 0.8 GB each at the flagship's x_1_3 site, batch 16).
_REFERENCE_CHUNK = 4096

# The limits the kernel's dq, dk and dv are held to against the plain
# version on the same inputs, per dtype: (rtol, atol, mean_tol), read as
# ``flash_attention.agreement`` reads them.
# bf16: both sides round p and ds to bf16 before their products and round
# each output to bf16 once.  Their float32 values differ by the order of
# the sums (the kernel's dq sum across key tiles is made of atomic adds in
# an order that changes from run to run) and by __expf, ~1e-6 relative, which
# flips the bf16 rounding of a few p and ds: a relative 2^-8 on those terms,
# averaging out over the sums.  The output rounding adds up to one ulp
# (2^-8 relative) per element.  ds = p (dp - delta) cancels, so an element
# of dq or dk can be small against the errors of its terms: atol scales
# with the largest element.  rtol allows two ulps, atol and mean_tol cover
# the flipped roundings.
# fp32: summation order, atomics and __expf, ~1e-6 relative; the
# cancellation in ds makes atol, relative to the largest element, the limit
# that binds.
TOLERANCE = {torch.bfloat16: (2.0 ** -6, 2.0 ** -7, 2.0 ** -6),
             torch.float32: (1e-4, 1e-4, 1e-4)}
# dv is also held row by row, one row per key (``agreement``'s
# ``row_tolerance``): the per-element limits scale with the largest element,
# so in a heavy-tailed dv a key whose row the kernel left at zero can pass
# them.  dv = p^T do takes its one rounded operand, p, from the same float32
# scores on both sides; two roundings of nearly the same float32 sum differ
# by one ulp (at most 2^-7 relative) where they straddle a rounding
# boundary, so a row's relative L2 distance stays below 2^-7 even if every
# element flips.  bf16 allows 2^-5; fp32, whose error is the summation
# order, 1e-4.  A row left at zero reads 1 against either.
DV_ROW_TOLERANCE = {torch.bfloat16: 2.0 ** -5, torch.float32: 1e-4}


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             dlse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch, with the TPU kernel's rounding steps: float32 scores,
    p, dp, ds and sums; p and ds rounded to the operand dtype before their
    products; dq, dk, dv rounded to q's, k's, v's dtype at the end; with
    ``dlse``, delta less the lse cotangent (B4).  Works through the queries
    in chunks of ``_REFERENCE_CHUNK`` rows."""
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(-1)  # [B, Nq]
    if dlse is not None:
        delta = delta - dlse.float()
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=v.device)
    dq = []
    for i in range(0, q.shape[1], _REFERENCE_CHUNK):
        rows = slice(i, i + _REFERENCE_CHUNK)
        qc, doc = q[:, rows].float(), do[:, rows].float()
        p = torch.exp(torch.bmm(qc, kf.transpose(1, 2)) - lse[:, rows, None])
        dp = torch.bmm(doc, vf.transpose(1, 2))
        ds = (p * (dp - delta[:, rows, None])).to(k.dtype).float()
        p = p.to(v.dtype).float()
        dq.append(torch.bmm(ds, kf).to(q.dtype))
        dk += torch.bmm(ds.transpose(1, 2), qc)
        dv += torch.bmm(p.transpose(1, 2), doc)
    return torch.cat(dq, dim=1), dk.to(k.dtype), dv.to(v.dtype)


def backward_c_ok(c: int) -> bool:
    """C the backward kernel takes: a multiple of 16 up to 128, or of 64 up
    to 512."""
    return (c > 0 and c % C_MULTIPLE == 0 and c <= MAX_C
            and (c <= NARROW_MAX_C or c % WIDE_C_MULTIPLE == 0))


def backward_viable(nq: int, nk: int, d: int, c: int, dtype: torch.dtype) -> bool:
    """True where the dispatch gives a site that autograd differentiates to
    B2 + B3 (and a ring hop to B2 + B4): the forward's gate, and a C the
    backward kernel takes."""
    return forward_viable(nq, nk, d, c, dtype) and backward_c_ok(c)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_sap3d_typed", False):
        lib.sap3d_flash_bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_bwd.restype = ctypes.c_int
        names = ("max_d", "max_c", "c_multiple", "wide_c_multiple", "narrow_max_c")
        for name in names:
            getattr(lib, f"sap3d_flash_bwd_{name}").restype = ctypes.c_int
        lib.sap3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sap3d_cuda_error_string.restype = ctypes.c_char_p
        limits = tuple(getattr(lib, f"sap3d_flash_bwd_{name}")() for name in names)
        ours = (MAX_D, MAX_C, C_MULTIPLE, WIDE_C_MULTIPLE, NARROW_MAX_C)
        if limits != ours:
            raise RuntimeError(f"csrc/{SOURCE}.cu takes ({', '.join(names)}) = {limits}; "
                               f"the gate's constants say {ours}")
        lib._sap3d_typed = True
    return lib


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, dlse: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T) v (kernel B3), or with the lse
    cotangent ``dlse`` [B, Nq] of (o, lse) (kernel B4): the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors.  ``do`` is in v's
    dtype."""
    tensors = (q, k, v, o, lse, do) + (() if dlse is None else (dlse,))
    if all(t.device.type == "cpu" for t in tensors):
        if dlse is None:
            return flash_backward_reference(q, k, v, o, lse, do)
        return flash_backward_reference(q, k, v, o, lse, do, dlse)
    lib = _library()
    if not all(t.device.type == "cuda" and t.device == q.device for t in tensors):
        raise ValueError("q/k/v/o/lse/do must share one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype) \
            or q.dtype not in _DTYPE_CODES or lse.dtype != torch.float32 \
            or (dlse is not None and dlse.dtype != torch.float32):
        raise TypeError("flash backward takes q/k/v/o/do of one dtype of "
                        "float32/bfloat16 and a float32 lse (and dlse), got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if any(t.dim() != 3 for t in (q, k, v, o, do)):
        raise ValueError("q, k, v, o, do must be [B, N, width]")
    b, nq, d = q.shape
    _, nk, c = v.shape
    if k.shape != (b, nk, d) or v.shape[0] != b or o.shape != (b, nq, c) \
            or do.shape != (b, nq, c) or lse.shape != (b, nq) \
            or (dlse is not None and dlse.shape != (b, nq)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, "
                         f"lse {tuple(lse.shape)}, do {tuple(do.shape)}"
                         + ("" if dlse is None else f", dlse {tuple(dlse.shape)}"))
    if d > MAX_D or not backward_c_ok(c):
        raise ValueError(f"flash backward takes d <= {MAX_D} and C a multiple of "
                         f"{C_MULTIPLE} up to {NARROW_MAX_C} or of {WIDE_C_MULTIPLE} up to "
                         f"{MAX_C}; got d={d}, C={c}")
    # rows of q and k in whole 16-byte chunks; the padded columns of dq and
    # dk are dropped below
    q, k = pad_rows(q), pad_rows(k)
    q, k, v, o, lse, do = (contiguous_aligned(t) for t in (q, k, v, o, lse, do))
    dlse = None if dlse is None else contiguous_aligned(dlse)
    dp = q.shape[2]
    delta = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((b, nq, dp), dtype=torch.float32, device=q.device)
    dq = dq_acc if q.dtype == torch.float32 else torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the launches go to the current device: make it q's, and take its stream
    with torch.cuda.device(q.device):
        err = lib.sap3d_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(),
                                  None if dlse is None else dlse.data_ptr(), delta.data_ptr(),
                                  dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), b, nq, nk, dp, c, _DTYPE_CODES[q.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention_bwd launch failed: "
                           + lib.sap3d_cuda_error_string(err).decode())
    if dlse is None:
        flash_backward.launches += 1
    else:
        flash_backward.launches_lse += 1
    if dp != d:
        dq, dk = dq[..., :d].contiguous(), dk[..., :d].contiguous()
    return dq, dk, dv


flash_backward.launches = 0      # B3
flash_backward.launches_lse = 0  # B4
