"""Fused attention forward: the CUDA kernel and its plain version.

Counterpart of ``sap3d_tpu/ops/pallas/flash_attention.py``'s
``_flash_forward``: ``softmax(q k^T) v`` over the key axis with no
1/sqrt(d) scale, fp32 scores, output in v's dtype.  q ``[B, Nq, d]``,
k ``[B, Nk, d]``, v ``[B, Nk, C]``.  Two entry points run
``csrc/flash_attention_fwd.cu``:

* ``flash_attend_tokens`` (kernel B1): o only, as the ``flash_attend_tokens``
  primal (``want_lse=False``) that inference runs;
* ``flash_forward_lse`` (kernel B2): o and ``lse`` ``[B, Nq]`` float32, the
  log-sum-exp of each query row's scores, as the custom_vjp forward rule
  (``want_lse=True``) that training runs.  The TPU kernel's ``[B, 8, Nq]``
  sublane replication is a TPU layout and is not kept.

Each launches the kernel for CUDA tensors and runs its plain version
(``flash_attend_tokens_reference``, ``flash_forward_lse_reference``) only
for CPU tensors.  On a CUDA tensor it launches the kernel or raises; it
never falls back.  ``<function>.launches`` counts kernel launches.

``forward_viable`` is the dispatch gate of the forward: the shapes and types
the kernel takes (``MAX_D``, ``C_MULTIPLE``), kept here as constants so that
a host without the library decides as the card does; ``_library`` checks
them against the library's own.  The kernel reads rows of q and k in whole
16-byte chunks; the launcher pads a narrower row with zero columns
(``pad_rows``: d to a multiple of 8 in bf16, of 4 in float32), which add
nothing to q k^T.  Nothing of the TPU kernel's VMEM model carries over.
"""

from __future__ import annotations

import ctypes

import torch

from sap3d_tpu_torch.ops.cuda import build

SOURCE = "flash_attention_fwd"
# Below one query block of the TPU kernel the JAX package takes the XLA path
# (flash_attention_viable: nq >= BLOCK_Q); the port keeps that dispatch rule.
BLOCK_Q = 256
# The kernel's own limits (csrc/flash_attention_fwd.cu: MAX_D, C_MULTIPLE).
MAX_D = 128
C_MULTIPLE = 16
# Bytes per chunk in which the kernels read a row of q or k.
ROW_CHUNK_BYTES = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The limits the kernel is held to against its plain version on the same
# inputs, per dtype: (rtol, atol, mean_tol), read as
#   |got - want| <= rtol * |want| + atol * max|want|   for every element,
#   mean|got - want| <= mean_tol * mean|want|.
# bf16: both sides round the output to bf16, so an element may differ by an
# ulp (at most 2^-7 of its value); before that they differ by the rounding
# of the probabilities (the plain version rounds p, the kernel exp(s - m)),
# a relative ~2^-9 per key that averages out over the keys.  rtol allows two
# ulps, atol and mean_tol cover the probability rounding.
# fp32: summation order and __expf, ~1e-6 relative.
TOLERANCE = {torch.bfloat16: (2.0 ** -6, 2.0 ** -8, 2.0 ** -7),
             torch.float32: (1e-5, 1e-4, 1e-4)}
# lse (float32 in both dtypes, from the same float32 scores): the kernel's
# running max and sum against torch.logsumexp differ by summation order and
# __expf, ~1e-6 relative; dropping one tile of 64 keys moves lse by ~1e-2.
LSE_TOLERANCE = {torch.float32: (1e-5, 1e-5, 1e-5)}


def agreement(got: torch.Tensor, want: torch.Tensor, tolerance: dict | None = None,
              row_tolerance: dict | None = None) -> dict[str, float]:
    """How far the kernel's output ``got`` is from its plain version's
    ``want`` under ``tolerance[want.dtype]`` (default ``TOLERANCE``): the
    largest and the mean absolute error, the relative L2 distance (read,
    not held), and ``excess``, the largest ratio
    of an error (per element, or the mean) to its limit.  With
    ``row_tolerance``, each row (the last axis) is also held by its relative
    L2 distance, ``||got_r - want_r|| <= row_tol * ||want_r||`` (rows below
    2^-20 of the largest row's norm are held to that floor), so that a row
    left at zero reads 1 / row_tol however small it is; ``row_excess`` is
    the largest ratio.  They agree when excess <= 1."""
    rtol, atol, mean_tol = (TOLERANCE if tolerance is None else tolerance)[want.dtype]
    row_tol = None if row_tolerance is None else row_tolerance[want.dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    mag = want.abs()
    limit = (rtol * mag + atol * mag.max()).clamp_min(torch.finfo(torch.float32).tiny)
    mean_err = err.mean().item()
    excess = max((err / limit).max().item(),
                 mean_err / (mean_tol * mag.mean().item()))
    out = dict(max_abs_err=err.max().item(), mean_abs_err=mean_err,
               rel_l2=(err.norm() / want.norm().clamp_min(torch.finfo(torch.float32).tiny)
                       ).item(),
               finite=bool(torch.isfinite(got).all().item()))
    if row_tol is not None:
        row_err = (got - want).flatten(0, -2).norm(dim=-1)
        row_norm = want.flatten(0, -2).norm(dim=-1)
        row_limit = (row_tol * row_norm.clamp_min(2.0 ** -20 * row_norm.max())
                     ).clamp_min(torch.finfo(torch.float32).tiny)
        out["row_excess"] = (row_err / row_limit).max().item()
        excess = max(excess, out["row_excess"])
    return dict(out, excess=excess)


def flash_attend_tokens_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: softmax(q k^T) v with fp32 scores and softmax; the
    probabilities are cast to v's dtype before the product, which
    accumulates in fp32 (``sap3d_tpu`` ``_dot_softmax_attend``)."""
    scores = torch.bmm(q.float(), k.float().transpose(1, 2))
    beta = torch.softmax(scores, dim=-1)
    return torch.bmm(beta.to(v.dtype), v)


def flash_forward_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: ``flash_attend_tokens_reference``'s output and the
    float32 log-sum-exp of each query row's fp32 scores, ``[B, Nq]``."""
    scores = torch.bmm(q.float(), k.float().transpose(1, 2))
    beta = torch.softmax(scores, dim=-1)
    return torch.bmm(beta.to(v.dtype), v), torch.logsumexp(scores, dim=-1)


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [..., d] with zero columns appended up to whole 16-byte rows
    (``t`` itself when they are whole already)."""
    per_chunk = ROW_CHUNK_BYTES // t.element_size()
    pad = -t.shape[-1] % per_chunk
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def forward_viable(nq: int, nk: int, d: int, c: int, dtype: torch.dtype) -> bool:
    """True where the dispatch gives (q [.., nq, d], k [.., nk, d],
    v [.., nk, c]) of ``dtype`` to the forward kernel (B1, B2): at least one
    block of queries (below it the JAX package takes the plain path too) and
    a shape and type the kernel takes."""
    return (nq >= BLOCK_Q and nk >= 1 and dtype in _DTYPE_CODES and 0 < d <= MAX_D
            and c > 0 and c % C_MULTIPLE == 0)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_sap3d_typed", False):
        lib.sap3d_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_fwd.restype = ctypes.c_int
        lib.sap3d_flash_fwd_block_c.restype = ctypes.c_int
        lib.sap3d_flash_fwd_max_d.restype = ctypes.c_int
        lib.sap3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sap3d_cuda_error_string.restype = ctypes.c_char_p
        limits = (lib.sap3d_flash_fwd_max_d(), lib.sap3d_flash_fwd_block_c())
        if limits != (MAX_D, C_MULTIPLE):
            raise RuntimeError(f"csrc/{SOURCE}.cu takes (max d, C multiple) = {limits}; "
                               f"the gate's constants say {(MAX_D, C_MULTIPLE)}")
        lib._sap3d_typed = True
    return lib


def launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   want_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Check the inputs and launch the forward kernel, with or without lse.
    Counts nothing: each wrapper that calls it counts its own launches."""
    lib = _library()
    if not all(t.device.type == "cuda" and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"q/k/v must share one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes one dtype of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, N, width]")
    b, nq, d = q.shape
    _, nk, c = v.shape
    if k.shape != (b, nk, d) or v.shape[0] != b:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d > MAX_D or c % C_MULTIPLE:
        raise ValueError(f"flash kernel takes d <= {MAX_D} and C a multiple of "
                         f"{C_MULTIPLE}; got d={d}, C={c}")
    q, k, v = (contiguous_aligned(t) for t in (pad_rows(q), pad_rows(k), v))
    o = torch.empty((b, nq, c), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, nq), dtype=torch.float32, device=v.device) if want_lse else None
    # the launch goes to the current device: make it q's, and take its stream
    with torch.cuda.device(q.device):
        err = lib.sap3d_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  None if lse is None else lse.data_ptr(), b, nq, nk,
                                  q.shape[2], c, _DTYPE_CODES[q.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + lib.sap3d_cuda_error_string(err).decode())
    return o, lse


def contiguous_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if contiguous and 16-byte aligned (the kernels' vector loads),
    else a contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attend_tokens(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v (kernel B1): the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attend_tokens_reference(q, k, v)
    o, _ = launch_forward(q, k, v, want_lse=False)
    flash_attend_tokens.launches += 1
    return o


def flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(softmax(q k^T) v, lse) (kernel B2): the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_forward_lse_reference(q, k, v)
    o, lse = launch_forward(q, k, v, want_lse=True)
    flash_forward_lse.launches += 1
    return o, lse


flash_attend_tokens.launches = 0
flash_forward_lse.launches = 0
