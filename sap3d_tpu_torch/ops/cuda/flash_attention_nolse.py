"""Lse-free attention forward that rounds the normalised probabilities
(kernel B6): the CUDA kernel and its plain version.

Counterpart of ``flash_nolse`` in ``scripts/bisect_infer.py`` (its Pallas
kernel ``_fwd_kernel_nolse``), which the inference bisect swaps in for
``flash_attend_tokens``: ``softmax(q k^T) v`` over the key axis with no
1/sqrt(d) scale, fp32 scores, ``p = e / sum(e)`` normalised in fp32 and
rounded to v's dtype before the product, which accumulates in fp32; output
in v's dtype.  q ``[B, Nq, d]``, k ``[B, Nk, d]``, v ``[B, Nk, C]``.

B1 (``flash_attention.flash_attend_tokens``) computes the same function
with an online softmax and rounds the unnormalised ``exp(s - m)``; this
kernel (``csrc/flash_attention_nolse.cu``) makes two passes over the keys
so that it rounds where the TPU kernel rounds.  It is for inference only
(no lse, no backward) and nothing routes to it: the bisect
(``sap3d_tpu_torch.scripts.bisect_infer``) swaps it in for B1.

``flash_nolse`` launches the kernel for CUDA tensors and runs its plain
version (``flash_nolse_reference``) only for CPU tensors.  On a CUDA tensor
it launches the kernel or raises; it never falls back.
``flash_nolse.launches`` counts kernel launches.  It takes what B1 takes
(``flash_attention.forward_viable``; d <= ``MAX_D``, C a multiple of
``C_MULTIPLE``), and the launcher pads q and k to 16-byte rows as B1's does.
"""

from __future__ import annotations

import ctypes

import torch

from sap3d_tpu_torch.ops.cuda import build
from sap3d_tpu_torch.ops.cuda.flash_attention import (
    C_MULTIPLE,
    MAX_D,
    contiguous_aligned,
    pad_rows,
)

SOURCE = "flash_attention_nolse"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The limits the kernel is held to against ``flash_nolse_reference`` on the
# same inputs, per dtype: (rtol, atol, mean_tol), read as
# ``flash_attention.agreement`` reads them.
# bf16: both sides normalise p in fp32 and round it to bf16 before the
# product, and round the fp32 sum once.  Their fp32 p differ by a few fp32
# ulps (__expf, a multiply by 1/l against a division) and their sums by
# their order (~1e-6 of sum |p v|), so an element agrees or rounds to the
# neighbouring bf16 value: rtol is one ulp (at most 2^-7 of the value).
# Rarely a p lies so near a rounding midpoint that the two round it apart,
# which moves an output by an ulp of that p times |v| (up to 2^-7 p |v|),
# many ulps of an output near zero (9 ulps, 1e-3, where the plain version
# meets the JAX kernel on the CPU at x_3_1's shape): atol is B1's 2^-8 of
# the largest output for that.  Such flips touch under 1e-3 of the
# elements, so the mean is held to 2^-11, 16x B1's 2^-7: B1 rounds the
# unnormalised exp(s - m), which moves every element.
# fp32: no rounding point; __expf and summation order, ~1e-6 relative.
TOLERANCE = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8, 2.0 ** -11),
             torch.float32: (1e-5, 1e-5, 1e-5)}


def flash_nolse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch, the TPU kernel's arithmetic step by step
    (``scripts/bisect_infer.py:_fwd_kernel_nolse``): fp32 scores, the row
    max m, e = exp(s - m), p = e / sum(e) in fp32, p rounded to v's dtype,
    the product of the rounded p and v summed in fp32, the output in v's
    dtype."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    return torch.bmm(p.to(v.dtype).float(), v.float()).to(v.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_sap3d_typed", False):
        lib.sap3d_flash_nolse.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_nolse.restype = ctypes.c_int
        lib.sap3d_flash_nolse_block_c.restype = ctypes.c_int
        lib.sap3d_flash_nolse_max_d.restype = ctypes.c_int
        lib.sap3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sap3d_cuda_error_string.restype = ctypes.c_char_p
        limits = (lib.sap3d_flash_nolse_max_d(), lib.sap3d_flash_nolse_block_c())
        if limits != (MAX_D, C_MULTIPLE):
            raise RuntimeError(f"csrc/{SOURCE}.cu takes (max d, C multiple) = {limits}; "
                               f"B1's gate says {(MAX_D, C_MULTIPLE)}")
        lib._sap3d_typed = True
    return lib


def flash_nolse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v with the normalised p rounded to v's dtype (kernel
    B6): the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_nolse_reference(q, k, v)
    lib = _library()
    if not all(t.device.type == "cuda" and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"q/k/v must share one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_nolse takes one dtype of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, N, width]")
    b, nq, d = q.shape
    _, nk, c = v.shape
    if k.shape != (b, nk, d) or v.shape[0] != b:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d > MAX_D or c % C_MULTIPLE:
        raise ValueError(f"flash_nolse takes d <= {MAX_D} and C a multiple of "
                         f"{C_MULTIPLE}; got d={d}, C={c}")
    q, k, v = (contiguous_aligned(t) for t in (pad_rows(q), pad_rows(k), v))
    o = torch.empty((b, nq, c), dtype=v.dtype, device=v.device)
    # the launch goes to the current device: make it q's, and take its stream
    with torch.cuda.device(q.device):
        err = lib.sap3d_flash_nolse(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    b, nq, nk, q.shape[2], c, _DTYPE_CODES[q.dtype],
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention_nolse launch failed: "
                           + lib.sap3d_cuda_error_string(err).decode())
    flash_nolse.launches += 1
    return o


flash_nolse.launches = 0
