"""Fused attention backward (kernel B3): the CUDA kernel and its plain version.

Counterpart of ``sap3d_tpu/ops/pallas/flash_attention.py``'s
``_flash_backward(dlse=None)``, the custom_vjp backward rule of
``flash_attend_tokens``: dq, dk, dv of ``o = softmax(q k^T) v`` (unscaled)
from ``(q, k, v, o, lse, do)``, with one exponential per score:

    delta = rowsum(do * o),  p = exp(q k^T - lse),  ds = p * (do v^T - delta)
    dq = ds k,  dk = ds^T q,  dv = p^T do

``flash_backward`` launches ``csrc/flash_attention_bwd.cu`` for CUDA tensors
and runs ``flash_backward_reference`` only for CPU tensors.  On a CUDA
tensor it launches the kernel or raises; it never falls back.
``flash_backward.launches`` counts kernel launches.

``backward_viable`` is the dispatch gate of a differentiated site: B2's gate
and the backward kernel's one further limit, ``MAX_C`` (``MAX_D`` and
``C_MULTIPLE`` are the forward's); the constants are checked against the
library's own when it loads.
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
    row_chunks_ok,
)

SOURCE = "flash_attention_bwd"
# The kernel's own limit beyond the forward's (csrc/flash_attention_bwd.cu).
MAX_C = 512
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
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch, with the TPU kernel's rounding steps: float32 scores,
    p, dp, ds and sums; p and ds rounded to the operand dtype before their
    products; dq, dk, dv rounded to q's, k's, v's dtype at the end.  Works
    through the queries in chunks of ``_REFERENCE_CHUNK`` rows."""
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(-1)  # [B, Nq]
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


def backward_viable(nq: int, nk: int, d: int, c: int, dtype: torch.dtype) -> bool:
    """True where the dispatch gives a site that autograd differentiates to
    B2 + B3: the forward's gate, and C within the backward kernel's limit."""
    return forward_viable(nq, nk, d, c, dtype) and c <= MAX_C


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_sap3d_typed", False):
        lib.sap3d_flash_bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_bwd.restype = ctypes.c_int
        for name in ("sap3d_flash_bwd_max_d", "sap3d_flash_bwd_max_c",
                     "sap3d_flash_bwd_c_multiple"):
            getattr(lib, name).restype = ctypes.c_int
        lib.sap3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sap3d_cuda_error_string.restype = ctypes.c_char_p
        limits = (lib.sap3d_flash_bwd_max_d(), lib.sap3d_flash_bwd_max_c(),
                  lib.sap3d_flash_bwd_c_multiple())
        if limits != (MAX_D, MAX_C, C_MULTIPLE):
            raise RuntimeError(f"csrc/{SOURCE}.cu takes (max d, max C, C multiple) = "
                               f"{limits}; the gate's constants say "
                               f"{(MAX_D, MAX_C, C_MULTIPLE)}")
        lib._sap3d_typed = True
    return lib


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T) v: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors.  ``do`` is in v's dtype."""
    tensors = (q, k, v, o, lse, do)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_backward_reference(q, k, v, o, lse, do)
    lib = _library()
    if not all(t.device.type == "cuda" and t.device == q.device for t in tensors):
        raise ValueError("q/k/v/o/lse/do must share one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype) \
            or q.dtype not in _DTYPE_CODES or lse.dtype != torch.float32:
        raise TypeError("flash backward takes q/k/v/o/do of one dtype of "
                        "float32/bfloat16 and a float32 lse, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if any(t.dim() != 3 for t in (q, k, v, o, do)):
        raise ValueError("q, k, v, o, do must be [B, N, width]")
    b, nq, d = q.shape
    _, nk, c = v.shape
    if k.shape != (b, nk, d) or v.shape[0] != b or o.shape != (b, nq, c) \
            or do.shape != (b, nq, c) or lse.shape != (b, nq):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, "
                         f"lse {tuple(lse.shape)}, do {tuple(do.shape)}")
    if d > MAX_D or c > MAX_C or c % C_MULTIPLE:
        raise ValueError(f"flash backward takes d <= {MAX_D} and C a multiple of "
                         f"{C_MULTIPLE} up to {MAX_C}; got d={d}, C={c}")
    if not row_chunks_ok(d, q.dtype):
        raise ValueError(f"the bf16 kernel reads rows in 16-byte chunks: d={d} "
                         "must be a multiple of 8")
    q, k, v, o, lse, do = (contiguous_aligned(t) for t in tensors)
    delta = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((b, nq, d), dtype=torch.float32, device=q.device)
    dq = dq_acc if q.dtype == torch.float32 else torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sap3d_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), b, nq, nk, d, c, _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError("flash_attention_bwd launch failed: "
                           + lib.sap3d_cuda_error_string(err).decode())
    flash_backward.launches += 1
    return dq, dk, dv


flash_backward.launches = 0
