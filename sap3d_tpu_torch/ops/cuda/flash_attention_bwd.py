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
and the backward kernel's further limits, on C (``backward_c_ok``) and on d
(``BACKWARD_MAX_D``); the constants are checked against the library's own
when it loads.  ``query_split`` is the rule by which the kernels split a
key tile's query range over several CTAs.

Both dtypes run wgmma kernels on bf16 operands.  A float32 call splits q,
k, v and do into three bf16 planes each (``flash_attention.split_bf16x3``
is the plain version) in a scratch tensor the launcher allocates; each
product is then six bf16 products, an fp32 product to within fp32
rounding.  The bf16 dk and dq kernel keeps V of its 64 keys resident where
V and two do stages fit (d <= 64, C <= 512); elsewhere, and at three planes
always, the streaming kernel streams V and do in chunks of C per query tile
(``dkdq_streams``, ``stream_config``), and dv is a second kernel's, by
column slab (``dv_slab``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from sap3d_tpu_torch.ops.cuda import build
from sap3d_tpu_torch.ops.cuda.flash_attention import (
    C_MULTIPLE,
    CTA_SMEM_RESERVE,
    MAX_CTA_SMEM,
    MAX_D,  # the forward's limit on d, which backward_viable applies first
    PLANES,
    SM_COUNT,
    SMEM_PER_SM,
    contiguous_aligned,
    forward_viable,
    pad_rows,
)

SOURCE = "flash_attention_bwd"
# The kernel's own limits beyond the forward's (csrc/flash_attention_bwd.cu):
# C up to MAX_C; above NARROW_MAX_C a multiple of WIDE_C_MULTIPLE; d up to
# BACKWARD_MAX_D in both dtypes (q and k tiles of up to two 64-column
# boxes; at d above 64 in float32 the streaming kernel keeps one q stage and
# stages dq over the ds^T region to fit).  Every attention site of the
# registry (d = C/8 <= 128, C <= 1024) passes them.
MAX_C = 1024
WIDE_C_MULTIPLE = 64
NARROW_MAX_C = 128
BACKWARD_MAX_D = 128
# The bf16 dk and dq kernel keeps V resident up to this C and d; beyond
# either, the streaming kernel takes the call (``dkdq_streams``).
RESIDENT_MAX_C = 512
RESIDENT_MAX_D = 64
# Keys per CTA and queries per tile of the kernels.
BLOCK = 64
# What ``query_split`` knows beyond the card (``flash_attention``'s
# SM_COUNT, SMEM_PER_SM, CTA_SMEM_RESERVE): the most splits it makes.
MAX_SPLIT = 16
SETUP_TILES = 2
# C at which the bf16 dkdq kernel also computes dv (128 only where d <=
# 16: wider, its registers would spill); elsewhere a second kernel does, by
# column slab.
FUSED_DV_C = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows per step of the plain version: bounds its [B, rows, Nk] float32
# temporaries (about 0.8 GB each at the flagship's x_1_3 site, batch 16).
_REFERENCE_CHUNK = 4096

# The limits the kernel's dq, dk and dv are held to against the plain
# version on the same inputs, per dtype: (rtol, atol, mean_tol), read as
# ``flash_attention.agreement`` reads them.
# bf16: both sides round p and ds to bf16 before their products and round
# each output to bf16 once.  Their float32 values differ by the order of
# the sums (the kernel's dq sum across key tiles, and dk and dv across
# query splits, are atomic bulk adds in an order that changes from run to
# run) and by the kernel's exponential (ex2.approx), ~1e-6 relative, which
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


def backward_max_d(dtype: torch.dtype) -> int:
    """The widest d the backward kernel takes in ``dtype`` (the same in
    both)."""
    return BACKWARD_MAX_D


def backward_viable(nq: int, nk: int, d: int, c: int, dtype: torch.dtype) -> bool:
    """True where the dispatch gives a site that autograd differentiates to
    B2 + B3 (and a ring hop to B2 + B4): the forward's gate, a C the
    backward kernel takes, and a d it takes in ``dtype``."""
    return (forward_viable(nq, nk, d, c, dtype) and backward_c_ok(c)
            and d <= backward_max_d(dtype))


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def _d_tile(d: int) -> int:
    return 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128


def dkdq_streams(d: int, c: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the dk and dq kernel at (d, C) is the streaming one
    (``flash_bwd_dkdq_split``): always in float32, and in bf16 where V and
    two do stages do not stay resident (C above ``RESIDENT_MAX_C``) or the
    q and k tiles are two boxes wide (d above ``RESIDENT_MAX_D``)."""
    return PLANES[dtype] != 1 or _d_tile(d) > RESIDENT_MAX_D or c > RESIDENT_MAX_C


def dv_in_dkdq(d: int, c: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the dkdq kernel also computes dv at (d, C) (never in
    float32, nor in the streaming kernel)."""
    return (not dkdq_streams(d, c, dtype) and c in FUSED_DV_C
            and (c < 128 or _d_tile(d) == 16))


def dv_slab(c: int, dtype: torch.dtype = torch.bfloat16, d: int = 64) -> int:
    """Columns of C per CTA of the dv kernel (where dv is its): in bf16 256
    where they divide C; in float32 (each slab beside a per-tile
    accumulator) 128 at d from 33 to 64 where they divide C (one CTA per SM
    either way, half the slabs recomputing the scores; at d above 64 three
    planes of a 128-column slab do not fit beside K and the q tiles); else
    64 where they divide C, else 16."""
    widest = 256 if PLANES[dtype] == 1 else 128 if _d_tile(d) == 64 else 64
    return widest if c % widest == 0 else 64 if c % 64 == 0 else 16


def _chunk_cols(c: int) -> int:
    """Columns of C per chunk of V and do in the streaming dkdq kernel."""
    return 64 if c % 64 == 0 else 16


def _stream_layout(d_tile: int, cb: int, planes: int, qstages: int, cstages: int,
                   unioned: bool) -> int:
    """``split_layout`` in the source, with 1 KB of alignment: the planes of
    K, the q stages of (the planes of a q tile, lse and delta), the chunk
    stages of (the planes of v and of do), the planes of ds^T and the dq and
    dk staging rows (apart, or over the ds^T region where ``unioned``), the
    mbarriers."""
    plane = _align1k(BLOCK * d_tile * 2)
    qstage = planes * plane + _align1k(BLOCK * 8)
    chunk = 2 * planes * _align1k(BLOCK * cb * 2)
    ds, stg = planes * BLOCK * BLOCK * 2, _align1k(BLOCK * d_tile * 4)
    return (planes * plane + qstages * qstage + cstages * chunk
            + (max(ds, stg) if unioned else ds + stg)
            + 8 * (1 + 2 * qstages + 2 * cstages) + 1024)


def stream_config(d: int, c: int, dtype: torch.dtype = torch.float32) -> dict:
    """The streaming dkdq kernel's layout at (d, C), as ``split_config`` in
    the source picks it: two q stages, ds^T and the staging rows apart, and
    the most chunk stages, 4 down to 2, that fit one CTA; where none fits
    (three planes at d above 64), one q stage and the staging rows over the
    ds^T region.  Keys ``qstages``, ``cstages``, ``unioned``, ``smem``."""
    d_tile, cb, planes = _d_tile(d), _chunk_cols(c), PLANES[dtype]
    for qstages in (2, 1):
        for cstages in (4, 3, 2):
            smem = _stream_layout(d_tile, cb, planes, qstages, cstages, qstages == 1)
            if smem <= MAX_CTA_SMEM:
                return dict(qstages=qstages, cstages=cstages, unioned=qstages == 1, smem=smem)
    return dict(qstages=1, cstages=2, unioned=True,
                smem=_stream_layout(d_tile, cb, planes, 1, 2, True))


def split_chunk_stages(d: int, c: int, dtype: torch.dtype = torch.float32) -> int:
    """Chunk stages of the streaming dkdq kernel (``stream_config``)."""
    return stream_config(d, c, dtype)["cstages"]


def dkdq_smem_bytes(d: int, c: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one dkdq CTA.  The resident bf16 kernel
    (``smem_layout`` in the source): K, V and two stages of q tile, do tile
    or ds and dq, lse and delta, the mbarriers, 1 KB of alignment; the
    streaming kernel: ``stream_config``'s."""
    if dkdq_streams(d, c, dtype):
        return stream_config(d, c, dtype)["smem"]
    d_tile = _d_tile(d)
    tile = max(BLOCK * c * 2, BLOCK * BLOCK * 2 + BLOCK * d_tile * 4)
    stage = _align1k(BLOCK * d_tile * 2) + _align1k(tile) + _align1k(BLOCK * 8)
    return _align1k(BLOCK * d_tile * 2) + _align1k(BLOCK * c * 2) + 2 * stage + 8 * 5 + 1024


def dv_smem_bytes(d: int, c: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one dv CTA (``smem_layout`` in the source):
    the planes of K and two stages of (the planes of a q tile and of a do
    slab, lse and delta), the mbarriers, 1 KB of alignment."""
    planes, d_tile = PLANES[dtype], _d_tile(d)
    stage = planes * (_align1k(BLOCK * d_tile * 2) + _align1k(BLOCK * dv_slab(c, dtype, d) * 2)) \
        + _align1k(BLOCK * 8)
    return planes * _align1k(BLOCK * d_tile * 2) + 2 * stage + 8 * 5 + 1024


def resident_ctas(d: int, c: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """CTAs of the dkdq kernel resident on one SM at (d, C): the fewer of
    what its launch bounds leave room for in registers (the resident bf16
    kernel: 4 at d <= 16 without dv or with C <= 32, else 3; the streaming
    kernel: 2) and what fits in shared memory.  ``chip_smoke.py`` and the
    card tests hold it to the card's occupancy calculator."""
    if dkdq_streams(d, c, dtype):
        by_regs = 2
    else:
        by_regs = 4 if _d_tile(d) == 16 and (c <= 32 or not dv_in_dkdq(d, c)) else 3
    return max(1, min(by_regs,
                      SMEM_PER_SM // (dkdq_smem_bytes(d, c, dtype) + CTA_SMEM_RESERVE)))


def launch_grid(b: int, nq: int, nk: int, d: int, c: int, dtype: torch.dtype) -> dict:
    """The backward kernels' CTAs per call: the query split and the CTAs of
    each kernel."""
    split = query_split(b, nq, nk, d, c, dtype)
    dkdq = b * math.ceil(nk / BLOCK) * split
    dv = 0 if dv_in_dkdq(d, c, dtype) else dkdq * (c // dv_slab(c, dtype, d))
    return dict(split=split, ctas=dkdq + dv, dkdq_ctas=dkdq, dv_ctas=dv)


def query_split(b: int, nq: int, nk: int, d: int, c: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """S, the query ranges each key tile's work is split into.
    ``b * ceil(nk / BLOCK)`` CTAs per range run in waves of
    ``SM_COUNT * resident_ctas(d, c, dtype)``; a CTA walks ceil(tiles / S)
    query tiles after a set-up (K and V loads, the dk and dv epilogue) worth
    about ``SETUP_TILES`` tiles.  S is the smallest of 1 .. min(tiles,
    MAX_SPLIT) that minimises waves x (tiles per range + SETUP_TILES).  The
    ranges' dk and dv are summed in float32 (bf16: scratch, then
    rounded)."""
    ctas, tiles = b * math.ceil(nk / BLOCK), math.ceil(nq / BLOCK)
    slots = SM_COUNT * resident_ctas(d, c, dtype)
    best, best_cost = 1, math.inf
    for split in range(1, min(tiles, MAX_SPLIT) + 1):
        cost = math.ceil(ctas * split / slots) * (math.ceil(tiles / split) + SETUP_TILES)
        if cost < best_cost:
            best, best_cost = split, cost
    return best


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_sap3d_typed", False):
        lib.sap3d_flash_bwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_bwd.restype = ctypes.c_int
        names = ("max_d", "max_c", "c_multiple", "wide_c_multiple", "narrow_max_c", "block")
        for name in names:
            getattr(lib, f"sap3d_flash_bwd_{name}").restype = ctypes.c_int
        lib.sap3d_flash_bwd_resident_ctas.argtypes = [ctypes.c_int] * 3
        lib.sap3d_flash_bwd_resident_ctas.restype = ctypes.c_int
        lib.sap3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sap3d_cuda_error_string.restype = ctypes.c_char_p
        limits = tuple(getattr(lib, f"sap3d_flash_bwd_{name}")() for name in names)
        ours = (BACKWARD_MAX_D, MAX_C, C_MULTIPLE, WIDE_C_MULTIPLE, NARROW_MAX_C, BLOCK)
        if limits != ours:
            raise RuntimeError(f"csrc/{SOURCE}.cu takes ({', '.join(names)}) = {limits}; "
                               f"the gate's constants say {ours}")
        lib._sap3d_typed = True
    return lib


def card_resident_ctas(d: int, c: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """``resident_ctas`` as the card's occupancy calculator reads it for the
    dkdq kernel the library launches at (d, C) in ``dtype`` (d padded to
    8)."""
    return _library().sap3d_flash_bwd_resident_ctas(-(-d // 8) * 8, c, _DTYPE_CODES[dtype])


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
    max_d = backward_max_d(q.dtype)
    if d > max_d or not backward_c_ok(c):
        raise ValueError(f"flash backward takes d <= {max_d} in {q.dtype} and C a multiple "
                         f"of {C_MULTIPLE} up to {NARROW_MAX_C} or of {WIDE_C_MULTIPLE} up to "
                         f"{MAX_C}; got d={d}, C={c}")
    # rows of q and k in whole 16-byte chunks (bf16: padded here; float32:
    # as the kernel writes their planes); the padded columns of dq and dk
    # are dropped below
    dp = -(-d // 8) * 8
    if q.dtype == torch.bfloat16:
        q, k = pad_rows(q), pad_rows(k)
    q, k, v, o, lse, do = (contiguous_aligned(t) for t in (q, k, v, o, lse, do))
    dlse = None if dlse is None else contiguous_aligned(dlse)
    # float32 sums and scratch, zeroed by the library (memsets, no kernel)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((b, nq, dp), **f32)
    dk_acc = dv_acc = planes = None
    # (lse, delta) of each row, padded to whole query tiles
    stats = torch.empty((b, math.ceil(nq / BLOCK) * BLOCK, 2), **f32)
    splits = query_split(b, nq, nk, d, c, q.dtype)
    if q.dtype == torch.float32:
        # the outputs themselves, added to; the three bf16 planes of q, k,
        # v and do
        dk_acc, dv_acc = torch.empty((b, nk, dp), **f32), torch.empty(v.shape, **f32)
        dq, dk, dv = dq_acc, dk_acc, dv_acc
        planes = torch.empty(PLANES[q.dtype] * b * (nq * dp + nk * dp + nk * c + nq * c),
                             dtype=torch.bfloat16, device=q.device)
    else:
        # dk summed in float32 over query splits or by the streaming
        # kernel, dv over query splits; then rounded
        if splits > 1 or dkdq_streams(d, c, q.dtype):
            dk_acc = torch.empty(k.shape, **f32)
        if splits > 1:
            dv_acc = torch.empty(v.shape, **f32)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the launches go to the current device: make it q's, and take its stream
    with torch.cuda.device(q.device):
        err = lib.sap3d_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), None if dlse is None else dlse.data_ptr(), stats.data_ptr(),
            dq_acc.data_ptr(), None if dk_acc is None else dk_acc.data_ptr(),
            None if dv_acc is None else dv_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if planes is None else planes.data_ptr(), b, nq, nk, q.shape[2],
            c, splits, _DTYPE_CODES[q.dtype],
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
