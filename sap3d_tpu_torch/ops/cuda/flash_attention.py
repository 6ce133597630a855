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
  sublane replication is a TPU layout and is not kept;
* ``flash_row_stats``: each query row's max m and 1/l (l = sum_j
  exp(s_ij - m)) from q and k alone, or lse = m + log l: the first pass of
  kernel B6 (``flash_attention_nolse``) and the lse of kernel B5's backward
  (``ops/attention.py``).  Its kernel ``flash_row_stats`` shares the
  forward's wgmma body (``csrc/flash_fwd.cuh``).

Each launches the kernel for CUDA tensors and runs its plain version
(``flash_attend_tokens_reference``, ``flash_forward_lse_reference``,
``row_stats_reference``) only for CPU tensors.  On a CUDA tensor it launches the kernel or raises; it
never falls back.  ``<function>.launches`` counts kernel launches.

``forward_viable`` is the dispatch gate of the forward: the shapes and types
the kernel takes (``MAX_D``, ``C_MULTIPLE``), kept here as constants so that
a host without the library decides as the card does; ``_library`` checks
them against the library's own.  The kernel reads rows of q and k in whole
16-byte chunks; in bf16 the launcher pads a narrower row with zero columns
(``pad_rows``: d to a multiple of 8), which add nothing to q k^T.  Nothing
of the TPU kernel's VMEM model carries over.

Both dtypes run one wgmma kernel on bf16 operands.  A float32 call first
splits q, k and v into three bf16 planes each (hi + mid + lo, padded to
whole 16-byte rows as they are written; ``split_bf16x3`` is the plain
version, ``csrc/split_bf16.cuh`` the kernel) in a scratch tensor the
launcher allocates, and each product of the kernel is then six bf16
products (``split_product`` emulates one), an fp32 product to within fp32
rounding; o stays float32.

``launch_plan`` mirrors the kernel's host function ``plan``: how a call is
cut into CTAs (query rows, a slab of C's columns, a batch element each),
which of the compiled instantiations runs (``INSTANTIATIONS``), its key
tile, ring stages and shared memory, per dtype.  The CPU tests hold the
plan at every site; on the card ``card_launch_plan`` reads the library's
own.
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
# The bf16 kernels' launch plans (here and in flash_attention_bwd) count on
# an H100 SXM: its SMs, the most dynamic shared memory one CTA may take,
# shared memory per SM and the runtime's reserve per CTA.
SM_COUNT = 132
MAX_CTA_SMEM = 232448
SMEM_PER_SM = 233472
CTA_SMEM_RESERVE = 1024
# The forward kernel (csrc/flash_attention_fwd.cu, namespace wg): query
# rows per warpgroup, warpgroups per CTA at most, the bytes beyond a CTA's
# layout that align its base to 1024 (the dynamic shared memory starts at
# least 128-byte aligned), the bf16 planes of an operand per dtype (float32:
# hi, mid, lo; csrc/split_bf16.cuh), and the compiled (d tile, column slab,
# planes) instantiations (float32 slabs up to 128 columns).
WG_ROWS = 64
MAX_WGS = 2
SMEM_SLACK = 896
PLANES = {torch.bfloat16: 1, torch.float32: 3}
INSTANTIATIONS = frozenset((d, cw, np) for d in (16, 32, 64, 128)
                           for cw in (16, 32, 64, 128, 256) for np in (1, 3)
                           if cw <= 128 or np == 1)
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
# fp32: summation order and the exponential (ex2.approx), ~1e-6 relative;
# the kernel's six bf16 products per fp32 product (split_bf16.cuh) add
# terms of 2^-24 relative, the fp32 reordering level, where one bf16
# product (the inputs rounded to bf16) exceeds these limits 60-150 times.
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
    accumulates in fp32 (``sap3d_tpu`` ``_dot_softmax_attend``).  A float64
    input keeps float64 throughout."""
    scores = _scores(q, k)
    beta = torch.softmax(scores, dim=-1)
    return torch.bmm(beta.to(v.dtype), v)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T in float32, or in the inputs' dtype where it is wider."""
    acc = torch.promote_types(q.dtype, torch.float32)
    return torch.bmm(q.to(acc), k.to(acc).transpose(1, 2))


def flash_forward_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: ``flash_attend_tokens_reference``'s output and the
    float32 log-sum-exp of each query row's fp32 scores, ``[B, Nq]``
    (float64 for a float64 input)."""
    scores = _scores(q, k)
    beta = torch.softmax(scores, dim=-1)
    return torch.bmm(beta.to(v.dtype), v), torch.logsumexp(scores, dim=-1)


# Query rows per step of ``row_stats_reference``: bounds its [B, rows, Nk]
# float32 temporaries (about 0.8 GB each at the flagship's x_1_3 site,
# batch 16).
_STATS_CHUNK = 4096


def row_stats_reference(q: torch.Tensor, k: torch.Tensor, lse: bool = False):
    """Plain PyTorch: each query row's max m of the float32 scores
    s = q k^T and 1/l, l = sum_j exp(s_ij - m), both float32 ``[B, Nq]``;
    with ``lse``, m + log l instead (``torch.logsumexp`` of the row).  Works
    through the queries in chunks of ``_STATS_CHUNK`` rows."""
    kf = k.float().transpose(1, 2)
    ms, invs = [], []
    for qc in q.split(_STATS_CHUNK, dim=1):
        s = torch.bmm(qc.float(), kf)
        m = s.amax(-1)
        lsum = torch.exp(s - m[..., None]).sum(-1)
        ms.append(m)
        invs.append(lsum.log() if lse else 1.0 / lsum)
    m, rest = torch.cat(ms, dim=1), torch.cat(invs, dim=1)
    return m + rest if lse else (m, rest)


def split_bf16x3(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch: the three bf16 planes of float32 ``t``, hi = rn(t),
    mid = rn(t - hi), lo = rn(t - hi - mid), whose sum gives ``t`` back to
    within 2^-24 of each value (what ``csrc/split_bf16.cuh`` writes)."""
    hi = t.to(torch.bfloat16)
    r = t - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


# The products of a split product in the order the kernels add them, small
# first: (plane of a, plane of b), 0 = hi, 1 = mid, 2 = lo (split_bf16.cuh).
SPLIT_PRODUCTS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def split_product(a: torch.Tensor, b: torch.Tensor, products=SPLIT_PRODUCTS) -> torch.Tensor:
    """Plain PyTorch emulation of the kernels' float32 ``a @ b`` (batched):
    the sum of the bf16 plane products ``products`` (default the six the
    kernels take; ``((0, 0),)`` is one bf16 product), each exact in float32,
    added in order in float32."""
    pa, pb = split_bf16x3(a.float()), split_bf16x3(b.float())
    out = None
    for i, j in products:
        term = torch.matmul(pa[i].float(), pb[j].float())
        out = term if out is None else out + term
    return out


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


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def key_tile(d_tile: int, cw: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Keys per streamed tile of the kernel beside a ``cw``-column
    accumulator.  bf16: 64 from ``cw`` = 64 up (beside 128 accumulator
    registers a thread at 256; at 64 and 128 so that a thread fits in 128
    registers), 128 below.  float32 (three planes per tile): 64, or 32 at
    ``d_tile`` = 128."""
    if PLANES[dtype] == 1:
        return 64 if cw >= 64 else 128
    return 32 if d_tile >= 128 else 64


def launch_plan(b: int, nq: int, nk: int, d: int, c: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """How the forward kernel cuts a call (q [b, nq, d], k [b, nk, d],
    v [b, nk, c]) of ``dtype``, as the kernel's host function ``plan`` does:
    d padded to 8 and then to the q and k box width ``d_tile`` (16, 32, 64
    or 128); ``cw``, the least of 16 ... 256 that covers C up to 256 (in
    float32 up to 128), and ``slabs`` of it cover C (each slab's CTAs
    recompute the scores); ``bk``
    keys per tile; ``wgs`` warpgroups of 64 query rows per CTA and
    ``stages`` of the ring of K and V tiles (3 with two warpgroups, or 2
    where 3 do not fit; 2 with one); ``smem``, the CTA's dynamic shared
    memory (the ``planes`` of Q, the ring's planes of K and V tiles, the
    mbarriers, ``SMEM_SLACK`` of alignment), at most ``MAX_CTA_SMEM`` (a cut
    above it is not taken); ``resident``, the CTAs per SM the plan counts on
    (registers: one 256-thread CTA, two in bf16 at ``cw`` <= 128 as the
    launch bounds ask, or twice as many of 128 threads; and shared memory);
    ``grid`` (query tiles, slabs, batch) and ``threads``, 128 per
    warpgroup.  Two warpgroups (each K and V tile then serves 128 rows)
    unless one takes fewer waves over the SMs.  ``nk`` does not change the
    cut: every key tile costs the same."""
    planes = PLANES[dtype]
    dp = -(-d // 8) * 8
    d_tile = next(w for w in (16, 32, 64, 128) if dp <= w)
    cw = next((w for w in (16, 32, 64, 128) if c <= w), 256 if planes == 1 else 128)
    slabs = -(-c // cw)
    bk = key_tile(d_tile, cw, dtype)
    # one K and one V tile, each of `planes` planes
    stage = planes * (_align1k(bk * d_tile * 2) + _align1k(bk * cw * 2))
    best = None
    for wgs in (MAX_WGS, 1):
        for stages in ((3, 2) if wgs == MAX_WGS else (2,)):
            smem = (planes * _align1k(wgs * WG_ROWS * d_tile * 2) + stages * stage
                    + 8 * (1 + 2 * stages) + SMEM_SLACK)
            if smem <= MAX_CTA_SMEM:
                break
        if smem > MAX_CTA_SMEM:
            continue
        resident = min((2 if planes == 1 and cw <= 128 else 1) * (MAX_WGS // wgs),
                       SMEM_PER_SM // (smem + CTA_SMEM_RESERVE))
        ctas = b * -(-nq // (WG_ROWS * wgs)) * slabs
        waves = -(-ctas // (SM_COUNT * resident))
        if best is None or waves < best[0]:  # ties keep two warpgroups
            best = (waves, dict(wgs=wgs, stages=stages, smem=smem, resident=resident))
    cut = best[1]
    grid = (-(-nq // (WG_ROWS * cut["wgs"])), slabs, b)
    return dict(d_tile=d_tile, cw=cw, slabs=slabs, bk=bk, **cut, grid=grid,
                threads=128 * cut["wgs"], planes=planes)


def card_launch_plan(b: int, nq: int, nk: int, d: int, c: int,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """``launch_plan``'s keys as the library's own ``plan`` reads them (the
    card tests and ``chip_smoke.py`` hold the two equal)."""
    out = (ctypes.c_int * 11)()
    err = _library().sap3d_flash_fwd_plan(b, nq, nk, d, c, _DTYPE_CODES[dtype], out)
    if err:
        raise ValueError(f"the forward kernel does not take d={d}, C={c}")
    v = list(out)
    return dict(d_tile=v[0], cw=v[1], slabs=v[2], bk=v[3], wgs=v[4], stages=v[5], smem=v[6],
                resident=v[10], grid=tuple(v[7:10]), threads=128 * v[4], planes=PLANES[dtype])


def card_resident_ctas(b: int, nq: int, nk: int, d: int, c: int,
                       dtype: torch.dtype = torch.bfloat16) -> int:
    """CTAs of the kernel that such a call launches resident on one SM, from
    the card's occupancy calculator."""
    return _library().sap3d_flash_fwd_resident_ctas(b, nq, nk, d, c, _DTYPE_CODES[dtype])


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_sap3d_typed", False):
        lib.sap3d_flash_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_fwd.restype = ctypes.c_int
        lib.sap3d_flash_fwd_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.sap3d_flash_fwd_plan.restype = ctypes.c_int
        lib.sap3d_flash_fwd_resident_ctas.argtypes = [ctypes.c_int] * 6
        lib.sap3d_flash_fwd_resident_ctas.restype = ctypes.c_int
        lib.sap3d_flash_row_stats.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.sap3d_flash_row_stats.restype = ctypes.c_int
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


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor | None,
                 name: str = "flash kernel") -> None:
    """Raise unless q [B, Nq, d], k [B, Nk, d] and v [B, Nk, C] (where
    given) share one CUDA device and one dtype of float32/bfloat16 and the
    forward kernel takes (d, C) (``MAX_D``, ``C_MULTIPLE``)."""
    tensors = (q, k) if v is None else (q, k, v)
    if not all(t.device.type == "cuda" and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: inputs must share one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes one dtype of float32/bfloat16, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if any(t.dim() != 3 for t in tensors):
        raise ValueError("q, k, v must be [B, N, width]")
    b, _, d = q.shape
    nk = k.shape[1]
    c = C_MULTIPLE if v is None else v.shape[2]
    if k.shape != (b, nk, d) or (v is not None and v.shape[:2] != (b, nk)):
        raise ValueError(f"shape mismatch: " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in zip("qkv", tensors)))
    if d > MAX_D or c % C_MULTIPLE:
        raise ValueError(f"{name} takes d <= {MAX_D} and C a multiple of "
                         f"{C_MULTIPLE}; got d={d}, C={c}")


def split_scratch(q: torch.Tensor, k: torch.Tensor, c: int = 0) -> torch.Tensor:
    """The bf16 scratch that a float32 launch splits q, k (and, with ``c``,
    v [B, Nk, c]) into: three planes each, rows of q and k padded to 16
    bytes as the kernel writes them."""
    b, nq, d = q.shape
    nk, dp = k.shape[1], -(-d // 8) * 8
    return torch.empty(PLANES[torch.float32] * b * (nq * dp + nk * dp + nk * c),
                       dtype=torch.bfloat16, device=q.device)


def launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   want_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Check the inputs and launch the forward kernel, with or without lse.
    Counts nothing: each wrapper that calls it counts its own launches."""
    lib = _library()
    check_inputs(q, k, v)
    b, nq, _ = q.shape
    _, nk, c = v.shape
    planes = None
    if q.dtype == torch.float32:
        planes = split_scratch(q, k, c)
    else:
        q, k = pad_rows(q), pad_rows(k)
    q, k, v = (contiguous_aligned(t) for t in (q, k, v))
    o = torch.empty((b, nq, c), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, nq), dtype=torch.float32, device=v.device) if want_lse else None
    # the launch goes to the current device: make it q's, and take its stream
    with torch.cuda.device(q.device):
        err = lib.sap3d_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  None if lse is None else lse.data_ptr(),
                                  None if planes is None else planes.data_ptr(), b, nq, nk,
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


def flash_row_stats(q: torch.Tensor, k: torch.Tensor, lse: bool = False):
    """Each query row's max m and 1/l of s = q k^T, float32 ``[B, Nq]``
    each, or with ``lse`` m + log l: the row-stats kernel on CUDA tensors,
    the plain version (``row_stats_reference``) on CPU tensors.
    ``flash_row_stats.launches`` counts kernel launches."""
    if q.device.type == "cpu" and k.device.type == "cpu":
        return row_stats_reference(q, k, lse)
    lib = _library()
    check_inputs(q, k, None, "flash_row_stats")
    b, nq, _ = q.shape
    nk = k.shape[1]
    planes = None
    if q.dtype == torch.float32:
        planes = split_scratch(q, k)
    else:
        q, k = pad_rows(q), pad_rows(k)
    q, k = contiguous_aligned(q), contiguous_aligned(k)
    out = torch.empty((1 if lse else 2, b, nq), dtype=torch.float32, device=q.device)
    ptr = out.data_ptr()
    m, inv, lse_ptr = (None, None, ptr) if lse else (ptr, ptr + 4 * b * nq, None)
    with torch.cuda.device(q.device):
        err = lib.sap3d_flash_row_stats(q.data_ptr(), k.data_ptr(), m, inv, lse_ptr,
                                        None if planes is None else planes.data_ptr(), b, nq,
                                        nk, q.shape[2], _DTYPE_CODES[q.dtype],
                                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_row_stats launch failed: "
                           + lib.sap3d_cuda_error_string(err).decode())
    flash_row_stats.launches += 1
    return out[0] if lse else (out[0], out[1])


flash_attend_tokens.launches = 0
flash_forward_lse.launches = 0
flash_row_stats.launches = 0
