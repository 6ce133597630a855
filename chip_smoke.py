#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases (each prints its lines; any failure exits non-zero and prints no
result line):
  1. card: name and power limit from nvidia-smi;
  2. kernel build: the port's CUDA sources, one nvcc each, started
     together; build time and ptxas register/spill report;
  3. kernels against their plain versions at the three flagship
     self-attention sites (batch 16), bf16 and fp32, on one set of random
     inputs: the flash forward without lse (B1), with lse (B2: o and lse)
     and the flash backward (B3: dq, dk, dv), each output under its
     module's limits (``TOLERANCE``, ``LSE_TOLERANCE``), which a planted
     fault must fail (the last key tile dropped for o, lse and dv, which is
     also held row by row; delta left out for dq and dk); with the
     kernel's, the plain version's and a PyTorch yardstick's times
     (scaled_dot_product_attention, forward or autograd backward; the port
     never calls it) beside the bound;
  4. full-width forward: the flagship (p3d_unetplusplus_ds) on
     [16, 16, 112, 112, 3] bf16, seeded weights, gamma nonzero and random BN
     statistics; each B1 call held against its plain version on the tensors
     the model gave it, the kernel path against the plain path end to end,
     3 launches per forward, clips/s of both (median of 10); with
     --json-out, a torch.profiler breakdown of one kernel-path forward by
     layer;
  5. predictor (the inference path): SlidingWindowPredictor.predict_video
     on a 40-frame synthetic video; launch counts zeroed just before and
     read just after;
  6. training (the train path), the same flagship in bf16, batch 16:
     (a) 3 B2 + 3 B3 launches and no B1 per make_train_step call;
     (b) with dropout 0, each B2 and B3 call held against its plain version
     on the tensors the model gave it, with its planted faults failing;
     (c) one step end to end in bf16 and in fp32: the loss against the
     attention Function on the plain B2 and B3, the whole gradient against
     B2 with the plain B3 (the same forward), with a B3 without delta as
     the control that fails; the gradient's distance from the plain B2 and
     B3, from the plain path and from a plain forward rounding as the
     kernel does, read beside it;
     (d) Trainer.fit on in-memory batches at dropout 0.5: launch counts
     zeroed before and read after, finite losses, a validation pass,
     checkpoints saved, restored into a second trainer and resumed;
     (e) train clips/s of both paths (plain, kernel, kernel, plain; the
     median, slowest and fastest of 10 steps each) and peak device
     memory; with --json-out, a torch.profiler breakdown of one kernel-path
     train step;
  7. the GN + CBAM SA decoder (inference_p3d_sa_decoder_block, alias
     P3D_SA_DECODER) at full width in bf16, batch 16; its three attention
     sites' (Nq, Nk, d, C) are read from the model:
     (a) eval forward: 3 B1 launches, each held against its plain version on
     the model's tensors (planted fault: the key tile with the most attention
     mass dropped; the last keys of the pool4 deconv hold the bias alone);
     kernel path against plain path in bf16 and fp32; the linear output
     neither constant nor blown up; clips/s of both paths;
     (b) kernels at the GN sites on random inputs, bf16 and fp32: B1 at all
     three, B2 and B3 where the backward gate takes the shape, and B5
     (flash forward + chunked recompute backward) at all three: o against
     the plain version, dq, dk, dv against autograd through attend_tokens,
     a planted fault (the last 64 keys zeroed) failing, times beside bounds;
     at a shape of more than one chunk, the backward's peak memory under one
     full [B, Nq, Nk] float32 block;
     (c) predictor on a 40-frame video: 3 B1 launches per batch of windows;
     (d) training with SAP3D_FLASH_HYBRID=1 (set by the phase for itself,
     restored after): launches per step as the gate predicts from the
     printed shapes (B5 where the backward gate refuses, B2 + B3 elsewhere);
     the B5 call of one step held on the step's own tensors (o against the
     plain version, dq, dk, dv against autograd through attend_tokens; the
     heaviest key tile's keys zeroed must fail); one step from one state (dropout 0) in bf16 and fp32 against the same
     attention Functions on the plain kernels (cuDNN's deterministic
     algorithms for this comparison), with a B3 without delta as the
     control; Trainer.fit, 3 steps with a validation pass and
     checkpoints; train clips/s and peak memory, plain, hybrid, hybrid,
     plain, and the same with the flag off;
  8. every registry name built on the card, one bf16 eval forward at batch
     2: shape, finite values, B1 launches as the gate gives them, no site of
     256 queries or more on plain PyTorch; then B1, B2 and B3 at batch 2 at
     the sites no earlier phase measured (the 'full' head's x_0_1_sa, d = 2,
     C = 16: the kernels' narrow instantiation), as in phase 3;
  9. long clips: the flagship on [4, 64, 112, 112, 3] bf16 with its
     attention as rings over make_time_mesh(4, devices=[cuda:0] * 4), the
     calibrated weights of phase 4:
     (a) eval forward, ring against the gather path (B1 on the whole sites):
     12 B2 launches and nothing else; mean distance under E2E_MEAN_TOL, which
     the forward without attention must exceed;
     (b) one train step (dropout 0): every B4 call held on the step's own
     tensors against its plain version, B3 in its place (the lse cotangent
     dropped) failing; the launches of one make_train_step call predicted
     (24 B2, 12 B4) and counted; in fp32 at batch 1 the ring step's loss and
     whole gradient against the gather step (B2 + B3), with B3 in B4's place
     as the control;
     (c) B4 at the per-shard shapes on random inputs, bf16 and fp32, beside
     B3 on the same inputs, the plain version and the bound;
     (d) ms, 64-frame clips/s and peak memory of the ring and the gather
     train step, order gather, ring, ring, gather;
 10. the inference bisect (``sap3d_tpu_torch.scripts.bisect_infer``) and
     kernel B6 (the lse-free forward that rounds the normalised p, as the
     TPU kernel does):
     (a) B6 at the flagship's sites on random inputs, bf16 and fp32,
     against its plain version under ``flash_attention_nolse.TOLERANCE``,
     the last key tile dropped failing; B1 on the same inputs read against
     the same plain version, whose mean error B6's must not exceed in bf16;
     times of B6, B1, the plain version and SDPA beside B6's bound;
     (b) the bisect's ``main()`` at full width, batch 16: the current
     forward (B1), B6 swapped in, the plain path, the x_1_3 projection
     products fused against separate; launches per forward 3 B1 / 3 B6 /
     3 B1 after the swap / none on the plain path; every B6 call of one
     swapped forward held on the model's own tensors;
 11. the evaluator without files or cv2: (a) evaluate_prediction_batches
     with the calibrated flagship in fp32 on in-memory batches (densities
     and fixations at 1080 x 960 made from the plain path's own maps): B1
     launches, the five means against the plain path's run, the forward
     without attention failing the limit, clips scored per second; (b) the
     batched device metrics on a [32, 1080, 960] stack against the NumPy
     oracle, frames per second of both;
 12. a JSON line of per-kernel numbers, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs torch with CUDA and nvcc; imports nothing of JAX or ``sap3d_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
import warnings

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor-core rate
            "float32": 67e12}      # fp32 outside the tensor cores
# The flagship's attention sites that take the kernel (batch 16):
# name -> (Nq, Nk, d, C)
SITES = {
    "x_3_1": (392, 392, 64, 512),
    "x_2_2": (3136, 3136, 32, 256),
    "x_1_3": (25088, 3136, 16, 128),
}
BATCH = 16
SIZE = 112                         # frame height and width of the model input
DEVICE = "cuda"
KEY_TILE = 64                      # keys per streamed tile in both B1 kernels
# Mean |kernel path - plain path| of the bf16 flagship's sigmoid output.
# The two paths differ by bf16 rounding inside attention, which the random
# 47-block network amplifies (about 3e-3 on an H100, PERF.md).  The forward
# without attention must exceed this limit for the check to count.
E2E_MEAN_TOL = 1e-2
# The same for the GN SA decoder, whose output is linear: in units of the
# fp32 output's standard deviation.
GN_E2E_MEAN_TOL = 5e-2
# Train phase (c): (relative loss, relative L2 of the whole gradient) limits
# of the kernel path against B2 with the plain B3 (the same forward, so the
# backward's own difference) on one batch (dropout 0), per dtype, from runs
# on an H100.  bf16: 3.3e-2 read, as far as the plain path's other backward
# moves the gradient (3.6e-2), while each B3 output is 3e-5 to 6e-4 from
# its plain version: the bf16 backward carries rounding far; the control, a
# B3 without delta, read 124.  fp32: 2.1e-3 read (cuDNN's backward run
# twice: 9e-4), the control 60.  The loss is the forward's: the kernel path
# against the plain B2 and B3, 2.0e-5 read in bf16 and 0 in fp32.  (The
# whole bf16 gradient against the plain B2 and B3 is 0.43 away: moving the
# forward's rounding point moves it that far; PERF.md.)
TRAIN_TOL = {"bf16": (1e-4, 1e-1), "float32": (1e-6, 1e-2)}
# The same limits for the GN SA decoder (B2 + B3 at two sites, B5 at the
# third), from runs on an H100: the whole gradient against the same path
# with the plain B3 read 1.9e-2 in bf16 and 3.0e-3 in fp32 (the plain path
# run twice: 1.9e-3 and 1.7e-3 to 2.7e-3).  Its linear output makes a loss
# (2e6) whose gradient the attention sites move little: a B3 without delta
# moves the whole gradient 2.6e-2 to 8.3e-2 (1.6e-2 to 8.1e-2 in fp32), too
# near the sound reading to be a control: the whole-gradient limit has no
# control of its own and guards against gross faults only.  What holds the
# kernels in this step: B5's o, dq, dk and dv on the step's own tensors
# against ``attend_tokens`` and autograd through it (``b5_in_step``, with a
# planted fault that must fail; in the comparison below the kernel path and
# the plain-B3 run share B5's code, so it says nothing of B5), and for B3 the
# gradient of the sites' f, g and h projections, which only dq, dk and dv
# feed, held to GN_PROJ_TOL; B3's control is read there.  The projections
# read 1.4e-4 to 2.4e-4 in bf16
# (each B3 output is about 2e-4 from its plain version), the control 0.94 to
# 3.9 in both types.  In fp32 the reading is 2.9e-7 to 2.4e-6 when cuDNN's
# backward repeats itself and was 6.9e-4 in a run where it did not (the plain
# path run twice was then 6.7e-4 from itself on these projections).  The
# comparison therefore asks cuDNN for its deterministic algorithms: the plain
# path run twice then reads 0 there.
GN_TRAIN_TOL = {"bf16": (1e-4, 5e-2), "float32": (1e-6, 1e-2)}
GN_PROJ_TOL = {"bf16": 2e-3, "float32": 1e-4}
TRAIN_STEPS = 3
THROUGHPUT_CALLS = 10              # timed calls per path and round of clips/s
GN_MODEL = "P3D_SA_DECODER"        # inference_p3d_sa_decoder_block
# B1 launches of one eval forward of each registry name at 112 px: the
# attention sites the forward gate takes (at least 256 queries, C a multiple
# of 16): none without self-attention; x_3_1, x_2_2 and x_1_3 in the UNet++
# models (x_4_0 has 49 queries; 'nl' has a non-local block at x_1_3), and the
# 'full' head's x_0_1_sa (d = 2, C = 16: the kernels' narrow instantiation);
# pool2 and pool3 in sa_concat (pool4 has 49 tokens); all three sites of the
# two other GN SA decoders.
ZOO_LAUNCHES = {
    "p3d_unet": 0, "p3d_concat": 0, "p3d_unetplusplus": 4, "p3d_unetplusplus_ds": 3,
    "p3d_unetplusplus_nonsa": 0, "p3d_unetplusplus_nl": 2, "inference_p3d": 0,
    "inference_p3d_concat": 0, "inference_p3d_sa_concat": 2, "inference_p3d_sa_concat_2": 3,
    "inference_p3d_sa_decoder_block": 3, "inference_p3d_decoder_block": 0,
    "p3d_micro": 0, "p3d_micro_sa": 3,
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` from CUDA events, L2 evicted before each
    call (a 256 MB write), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _bound(nbytes: int, flops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int, lse: bool = False):
    """(bound_ms, bound_by) of the forward (B1; B2 with ``lse``): each input
    read once and each output written once over HBM bandwidth, against
    2*b*nq*nk*(d+c) FLOPs over the peak."""
    nbytes = b * (nq * d + nk * d + nk * c + nq * c) * itemsize + (4 * b * nq if lse else 0)
    return _bound(nbytes, 2 * b * nq * nk * (d + c), dtype_name)


def flash_bwd_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of the backward (B3): q, k, v, o, do and lse
    read, dq, dk, dv written; five products, 2*b*nq*nk*(3d + 2C) FLOPs."""
    nbytes = b * (2 * (nq * d + nk * d + nk * c) + 2 * nq * c) * itemsize + 4 * b * nq
    return _bound(nbytes, 2 * b * nq * nk * (3 * d + 2 * c), dtype_name)


def sdpa_yardstick(q, k, v, flush, do=None):
    """Time of one scaled_dot_product_attention call (scale=1.0) on the same
    inputs, with the first backend that accepts d != C; with ``do``, of
    torch.autograd.grad of its output (the forward outside the timing)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_(do is not None) for t in (q, k, v))
    warnings.filterwarnings("ignore", message=".*(kernel not used|attention has been "
                            "runtime disabled|Flash attention requires|Memory efficient "
                            "kernel not used|cuDNN attention).*")
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
                if do is None:
                    call = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)  # noqa: E731
                else:
                    do4 = do.unsqueeze(1)
                    call = lambda: torch.autograd.grad(out, (q4, k4, v4), do4,  # noqa: E731
                                                       retain_graph=True)
                call()
                torch.cuda.synchronize()
                return time_ms(call, 3, flush), backend.name
        except RuntimeError:
            continue
    return None, "none"


def drop_last_key_tile(fa, q, k, v):
    """A planted fault: what a kernel that skipped its last tile of
    ``KEY_TILE`` keys would return (the plain version on the other keys)."""
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    return fa.flash_attend_tokens_reference(q, k[:, :keep], v[:, :keep])


def heaviest_key_tile(q, k) -> slice:
    """The ``KEY_TILE``-key tile that holds the most attention mass over all
    queries."""
    import torch

    p = torch.softmax(torch.bmm(q.float(), k.float().transpose(1, 2)), dim=-1)
    mass = p.sum(dim=(0, 1))
    pad = (-mass.numel()) % KEY_TILE
    tile = int(torch.nn.functional.pad(mass, (0, pad)).view(-1, KEY_TILE).sum(-1).argmax())
    return slice(tile * KEY_TILE, (tile + 1) * KEY_TILE)


def drop_heaviest_key_tile(fa, q, k, v):
    """A planted fault for tensors whose last keys carry no weight (the GN
    decoder's pool4 deconv, stride 4 over a kernel of 1 and 3, ends in
    tokens that hold the bias alone, all alike: dropping them moves nothing):
    the plain version without the ``KEY_TILE``-key tile that holds the most
    attention mass over all queries."""
    import torch

    keep = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
    keep[heaviest_key_tile(q, k)] = False
    return fa.flash_attend_tokens_reference(q, k[:, keep], v[:, keep])


def hold(label, got, want, fault, fault_name, tolerance, row_tolerance=None):
    """Hold a kernel output against its plain version's under
    ``tolerance`` (and ``row_tolerance``), and show that the same limits
    fail a planted fault."""
    from sap3d_tpu_torch.ops.cuda.flash_attention import agreement

    sound = agreement(got, want, tolerance, row_tolerance)
    bad = agreement(fault, want, tolerance, row_tolerance)
    rtol, atol, mean_tol = tolerance[want.dtype]
    rows = "" if row_tolerance is None else \
        f", {row_tolerance[want.dtype]:g}*|want_row| per row (L2)"
    print(f"[check] {label}: max_abs_err {sound['max_abs_err']:.3e}, mean "
          f"{sound['mean_abs_err']:.3e}, rel L2 {sound['rel_l2']:.3e}, excess {sound['excess']:.3f} (limits: "
          f"{rtol:g}*|want| + {atol:g}*max|want| per element, {mean_tol:g}*mean|want| "
          f"mean{rows}); planted fault ({fault_name}): max_abs_err {bad['max_abs_err']:.3e}, "
          f"mean {bad['mean_abs_err']:.3e}, excess {bad['excess']:.3f}", flush=True)
    if not sound["finite"] or not sound["excess"] <= 1:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    if not bad["excess"] > 1:
        raise AssertionError(f"{label}: the limits pass the planted fault; the check is void")
    return dict(sound, fault_excess=bad["excess"], fault_max_abs_err=bad["max_abs_err"],
                fault_mean_abs_err=bad["mean_abs_err"])


_DROPPED = f"last {KEY_TILE}-key tile dropped"


def check_b1(fa, label, q, k, v, got, heaviest: bool = False):
    """B1's output on (q, k, v) against its plain version; the planted fault
    drops the last key tile, or with ``heaviest`` the one with the most
    attention mass."""
    fault = drop_heaviest_key_tile(fa, q, k, v) if heaviest else drop_last_key_tile(fa, q, k, v)
    name = f"the heaviest {KEY_TILE}-key tile dropped" if heaviest else _DROPPED
    return hold(f"B1 {label}", got, fa.flash_attend_tokens_reference(q, k, v),
                fault, name, fa.TOLERANCE)


def check_b2(fa, label, q, k, v, o, lse):
    """B2's o and lse against the plain version's."""
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    want_o, want_lse = fa.flash_forward_lse_reference(q, k, v)
    fault_o, fault_lse = fa.flash_forward_lse_reference(q, k[:, :keep], v[:, :keep])
    res = {"o": hold(f"B2 o {label}", o, want_o, fault_o, _DROPPED, fa.TOLERANCE),
           "lse": hold(f"B2 lse {label}", lse, want_lse, fault_lse, _DROPPED,
                       fa.LSE_TOLERANCE)}
    return dict(res, max_abs_err=max(r["max_abs_err"] for r in res.values()))


def check_b3(fb, label, q, k, v, o, lse, do, got):
    """B3's dq, dk, dv against the plain version's.  Planted faults: delta
    left out (the plain version on o = 0) for dq and dk; the last key tile
    dropped (its dv rows left at zero) for dv, which is also held row by
    row (``DV_ROW_TOLERANCE``)."""
    import torch

    want = fb.flash_backward_reference(q, k, v, o, lse, do)
    no_delta = fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    dv_dropped = want[2].clone()
    dv_dropped[:, keep:] = 0
    faults = (no_delta[0], no_delta[1], dv_dropped)
    names = ("delta left out", "delta left out", _DROPPED)
    rows = (None, None, fb.DV_ROW_TOLERANCE)
    res = {out: hold(f"B3 {out} {label}", g, w, f, n, fb.TOLERANCE, r)
           for out, g, w, f, n, r in zip(("dq", "dk", "dv"), got, want, faults, names, rows)}
    return dict(res, max_abs_err=max(r["max_abs_err"] for r in res.values()))


def phase_kernels(torch, fa, fb, flush, sites=None, batch=BATCH):
    """Phases 3, 7(b) and 8: B1, B2 and B3 against their plain versions at
    the shapes of ``sites`` (default: the flagship's) and ``batch``, with
    their times; B2 and B3 only where the backward gate takes the shape."""
    sites = SITES if sites is None else sites
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {"B1": [], "B2": [], "B3": []}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in sites.items():
            # q, k with std d^-1/4: unit-variance scores, a soft softmax
            q = (torch.randn(batch, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(batch, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(batch, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(batch, nq, c, device=DEVICE, generator=gen).to(dtype)
            shape = dict(site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            label = f"{site} {dname} (random inputs)"
            heavy = nq * nk * (d + c) > 5e9  # x_1_3 and the two wider GN sites
            iters = (3 if dtype == torch.float32 else 5) if heavy else 20
            plain_iters = max(iters // 4, 3)

            got = fa.flash_attend_tokens(q, k, v)
            check = check_b1(fa, label, q, k, v, got)
            del got
            row = dict(check, **shape)
            row["ms"] = time_ms(lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: fa.flash_attend_tokens_reference(q, k, v),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush)
            row["bound_ms"], row["bound_by"] = flash_bound(batch, nq, nk, d, c, dname,
                                                           q.element_size())
            rows["B1"].append(row)
            ran = ["B1"]
            if not fb.backward_viable(nq, nk, d, c, dtype):
                report_kernel_rows(rows, ran, site, dname, nq, nk, d, c, batch)
                del q, k, v, do
                torch.cuda.empty_cache()
                continue
            ran += ["B2", "B3"]

            o, lse = fa.flash_forward_lse(q, k, v)
            row = dict(check_b2(fa, label, q, k, v, o, lse), **shape)
            row["ms"] = time_ms(lambda: fa.flash_forward_lse(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: fa.flash_forward_lse_reference(q, k, v),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = rows["B1"][-1]["library_ms"], \
                rows["B1"][-1]["library_backend"]
            row["bound_ms"], row["bound_by"] = flash_bound(batch, nq, nk, d, c, dname,
                                                           q.element_size(), lse=True)
            rows["B2"].append(row)

            got = fb.flash_backward(q, k, v, o, lse, do)
            row = dict(check_b3(fb, label, q, k, v, o, lse, do, got), **shape)
            del got
            row["ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do), iters, flush)
            row["plain_ms"] = time_ms(lambda: fb.flash_backward_reference(q, k, v, o, lse, do),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush, do=do)
            row["bound_ms"], row["bound_by"] = flash_bwd_bound(batch, nq, nk, d, c, dname,
                                                               q.element_size())
            rows["B3"].append(row)
            report_kernel_rows(rows, ran, site, dname, nq, nk, d, c, batch)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return rows


def report_kernel_rows(rows, names, site, dname, nq, nk, d, c, batch=BATCH):
    for name in names:
        r = rows[name][-1]
        lib = r["library_ms"]
        print(f"[kernel] {name} {site} {dname} B={batch} Nq={nq} Nk={nk} d={d} C={c}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"sdpa {lib if lib is None else f'{lib:.4f}'} ms "
              f"({r['library_backend']}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)


def calibrate_and_randomize_bn(torch, model, x, gen):
    """Random BN statistics that keep the 47-block network out of
    saturation.  Scales, biases and gamma (every attention site) are drawn
    first; then one forward with pre-hooks, in network order, sets each BN's
    statistics from the batch it sees and perturbs them at random (mean +=
    0.1*std*N(0,1), var *= U(0.5, 1.5)), so that every later BN is
    calibrated against the perturbed layers before it."""
    from sap3d_tpu_torch.ops.layers import BatchNorm

    def rand(shape, lo, hi):
        return torch.rand(shape, device=DEVICE, generator=gen) * (hi - lo) + lo

    def hook(mod, args):
        a = args[0].float()
        dims = [0] + list(range(2, a.dim()))
        var = a.var(dims, unbiased=False)
        noise = torch.randn(var.shape, device=DEVICE, generator=gen)
        mod.mean.copy_(a.mean(dims) + 0.1 * var.sqrt() * noise)
        mod.var.copy_(var * rand(var.shape, 0.5, 1.5))

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.scale.copy_(rand(m.scale.shape, 0.5, 1.5))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, device=DEVICE, generator=gen))
        for sa in model.attention_modules():
            sa.gamma.copy_(rand((1,), 0.5, 1.5))
    handles = [m.register_forward_pre_hook(hook) for m in bns]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()


def phase_forward(torch, fa, model, x):
    """Phase 4: the flagship forward, kernel path against plain path.

    fp32: the two paths agree to 1e-3 on the sigmoid output (the attention
    outputs differ at ~1e-6 relative; the limit leaves room for the decoder
    to amplify that).  bf16, the main path: each of the 3 kernel calls is
    held against its plain version on the very tensors the model gave it,
    under the kernel's own limits; end to end, the mean distance between the
    paths is held to ``E2E_MEAN_TOL``, which the forward without attention
    (gamma = 0) must exceed.  The planted fault at every site is read end to
    end too; the random network's amplification of rounding noise keeps the
    end-to-end check too coarse to be held to it (PERF.md)."""
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.steps import make_eval_step

    model32 = build_model("unet++", dtype="float32", device=DEVICE)
    model32.load_state_dict(model.state_dict())

    def run(m, use_kernel, launches=None, inputs=x):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        out = make_eval_step(m)(inputs)
        torch.cuda.synchronize()
        got = fa.flash_attend_tokens.launches
        want = (len(SITES) if use_kernel else 0) if launches is None else launches
        if got != want:
            raise AssertionError(f"expected {want} kernel launches per forward, got {got}")
        return out

    ref32 = run(model32, False)
    kern32 = run(model32, True)
    # the fp32 forward of the input rounded to bf16: how far the random
    # network carries one bf16 rounding
    rounded32 = run(model32, False, inputs=x.to(torch.bfloat16).float())
    with torch.no_grad():
        for sa in model32.attention_modules():
            sa.gamma.zero_()
    no_attn = run(model32, False)
    del model32

    plain16 = run(model, False)
    calls = []

    def spy(q, k, v):
        o = fa.flash_attend_tokens(q, k, v)
        calls.append((q, k, v, o))
        return o

    with ta.forward_kernel(spy):
        kern16 = run(model, True)
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    sites = {}
    for q, k, v, o in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        sites[name] = check_b1(fa, f"{name} bf16 (in the flagship forward)", q, k, v, o)
    del calls
    with ta.forward_kernel(lambda q, k, v: drop_last_key_tile(fa, q, k, v)):
        fault16 = run(model, True, launches=0)
    gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.zero_()
        no_attn16 = run(model, False)
        for sa, g in zip(model.attention_modules(), gammas):
            sa.gamma.copy_(g)

    tol32 = 1e-3
    err32 = (kern32 - ref32).abs().max().item()
    mean16 = (kern16 - plain16).abs().mean().item()
    fault_mean16 = (fault16 - plain16).abs().mean().item()
    no_attn_mean16 = (no_attn16 - plain16).abs().mean().item()
    attn_effect = (ref32 - no_attn).abs().max().item()
    bf16_gap = (plain16 - ref32).abs().mean().item()
    rounding_gap = (rounded32 - ref32).abs().mean().item()
    inside = float(((kern16 > 0.01) & (kern16 < 0.99)).float().mean().item())
    print(f"[forward] flagship {tuple(x.shape)} -> {tuple(kern16.shape)}, 3 B1 launches "
          f"per forward; fp32 kernel vs plain path max_abs_err {err32:.3e} (tol {tol32:g}); "
          f"bf16 kernel vs plain path mean_abs_err {mean16:.3e} (tol {E2E_MEAN_TOL:g}); "
          f"vs the plain path: no attention {no_attn_mean16:.3e}, planted fault "
          f"{fault_mean16:.3e}; fp32 attention effect max {attn_effect:.3e}; "
          f"{inside:.3f} of outputs in (0.01, 0.99)", flush=True)
    print(f"[forward] mean distance from the fp32 forward: bf16 forward {bf16_gap:.3e}, "
          f"fp32 forward of the bf16-rounded input {rounding_gap:.3e}", flush=True)
    if not bool(torch.isfinite(kern16).all().item()) or kern16.shape != (*x.shape[:4],):
        raise AssertionError("flagship forward: non-finite output or wrong shape")
    if not err32 <= tol32 or not mean16 <= E2E_MEAN_TOL:
        raise AssertionError("flagship forward: kernel path disagrees with plain path")
    if not attn_effect > 10 * tol32 or not no_attn_mean16 > E2E_MEAN_TOL:
        raise AssertionError("the forward's checks pass a model with broken attention; "
                             "they are void")
    return dict(fp32_max_abs_err=err32, tol_fp32=tol32, bf16_mean_abs_err=mean16,
                bf16_fault_mean_abs_err=fault_mean16, tol_bf16_mean=E2E_MEAN_TOL,
                bf16_no_attention_mean_abs_err=no_attn_mean16,
                sites=sites, attention_effect=attn_effect, bf16_vs_fp32_mean=bf16_gap,
                rounded_input_vs_fp32_mean=rounding_gap, unsaturated_share=inside)


def describe_rates(res: dict) -> str:
    """'kernel m [lo, hi] / m [lo, hi], plain ...' of ``rate_summary``s."""
    def one(r):
        return f"{r['clips_per_s']:.2f} [{r['slowest']:.2f}, {r['fastest']:.2f}]"
    return (f"kernel {one(res['kernel'])} / {one(res['kernel2'])}, plain "
            f"{one(res['plain'])} / {one(res['plain2'])}")


def phase_throughput(torch, model, x, card):
    from sap3d_tpu_torch.train.steps import make_eval_step

    step = make_eval_step(model)
    res = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        for m in model.attention_modules():
            m.use_kernel = use_kernel
        res[label] = rate_summary(step_times(torch, lambda: step(x), THROUGHPUT_CALLS))
    for m in model.attention_modules():
        m.use_kernel = True
    print(f"[forward] clips/s (batch {BATCH}, bf16; median [slowest, fastest] of "
          f"{THROUGHPUT_CALLS} forwards each, order plain, kernel, kernel, plain): "
          f"{describe_rates(res)}  [{card}]", flush=True)
    return res


# Device kernels by name -> layer of PERF.md, first match wins.
_KERNEL_GROUPS = (
    ("B3/B4 flash_attention_bwd", ("flash_bwd", "bwd_delta", "round_to_bf16")),
    ("B1/B2 flash_attention_fwd", ("flash_fwd",)),
    ("group norm", ("groupnorm", "group_norm", "rowwisemoments", "computeinternalgradients",
                    "computefusedparams", "gammabeta")),
    ("convolution (cuDNN, with its layout transforms)",
     ("conv", "cudnn", "xmma", "implicit_gemm", "dgrad", "wgrad", "cutlass")),
    ("attention plain path at x_4_0 (bmm, softmax)", ("softmax", "gemm", "bmm")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("pooling", ("pool",)),
    ("optimizer (Adam)", ("multi_tensor", "adam")),
    ("copy / cast / pad / cat", ("copy", "pad", "cat", "transpose", "index")),
    ("other elementwise (relu, add, sigmoid, ...)", ("elementwise", "vectorized", "unrolled")),
)


def profile_device_time(torch, fn, label: str, batch: int | None = None):
    """Where one call of ``fn`` spends device time (torch.profiler): device
    time by layer group and the top kernels, against the host wall time of
    the same call (inflated by the tracing itself)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    device_ms = sum(r[0] for r in rows)
    if not rows:
        print("[profile] the profiler saw no device time; no breakdown", flush=True)
        return None
    groups: dict[str, float] = {}
    for ms, _, name in rows:
        low = name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS if any(k in low for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"[profile] {label} (batch {BATCH if batch is None else batch}, bf16): device busy "
          f"{device_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f})", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {group}", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   top {ms:9.3f} ms x{count:<4d} {name[:110]}", flush=True)
    return dict(device_ms=device_ms, wall_ms=wall_ms, groups=groups,
                top=[(ms, count, name) for ms, count, name in sorted(rows, reverse=True)[:25]])


def phase_profile(torch, model, x):
    """One kernel-path eval forward, profiled."""
    from sap3d_tpu_torch.train.steps import make_eval_step

    step = make_eval_step(model)
    return profile_device_time(torch, lambda: step(x), "one kernel-path forward")


def phase_predictor(torch, fa, model):
    """Phase 5, the main path: the sliding-window predictor on 40 frames."""
    import numpy as np

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.train.steps import make_eval_step

    size = SIZE
    frames = (np.random.default_rng(SEED).normal(size=(40, size, size, 3)) * 0.3
              ).astype(np.float32)
    with SlidingWindowPredictor(make_eval_step(model), batch_windows=BATCH,
                                image_size=size, device=DEVICE) as pred:
        fa.flash_attend_tokens.launches = 0
        t0 = time.perf_counter()
        maps = pred.predict_video(frames=frames)
        dt = time.perf_counter() - t0
        launches = fa.flash_attend_tokens.launches
    ok = (maps.shape == (40, size, size) and np.isfinite(maps).all()
          and maps.min() >= 0.0 and maps.max() <= 1.0)
    print(f"[predictor] 40 frames -> {maps.shape}, range [{maps.min():.4f}, "
          f"{maps.max():.4f}], {dt:.3f} s, B1 launches {launches}", flush=True)
    if not ok:
        raise AssertionError("predictor output has the wrong shape or values")
    want = -(-25 // BATCH) * len(SITES)  # 25 windows in batches of 16, a launch per site
    if launches != want:
        raise AssertionError(f"expected {want} B1 launches in the predictor run, got {launches}")
    return launches


def _launch_counts(fa, fb) -> dict[str, int]:
    return {"B1": fa.flash_attend_tokens.launches, "B2": fa.flash_forward_lse.launches,
            "B3": fb.flash_backward.launches, "B4": fb.flash_backward.launches_lse}


def _zero_launch_counts(fa, fb) -> None:
    fa.flash_attend_tokens.launches = 0
    fa.flash_forward_lse.launches = 0
    fb.flash_backward.launches = 0
    fb.flash_backward.launches_lse = 0


@contextlib.contextmanager
def function_calls(forward=None, backward=None):
    """Route the attention Function's forward through ``forward(q, k, v)
    -> (o, lse)`` and its backward through ``backward(q, k, v, o, lse, do)``
    for the duration (None: as is)."""
    from sap3d_tpu_torch.ops import attention

    orig = attention.flash_forward_lse, attention.flash_backward
    attention.flash_forward_lse = forward or orig[0]
    attention.flash_backward = backward or orig[1]
    try:
        yield
    finally:
        attention.flash_forward_lse, attention.flash_backward = orig


def forward_rounded_as_kernel(q, k, v):
    """A diagnostic: the plain B2 with the kernel's rounding point: p =
    exp(s - m) (m the row's largest score) rounded to v's dtype before the
    product, whose float32 sum is divided by l after it, where the plain B2
    rounds the normalized softmax."""
    import torch

    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = (torch.bmm(e.to(v.dtype).float(), v.float()) / l).to(v.dtype)
    return o, (m + l.log()).squeeze(-1)


def step_times(torch, fn, n: int) -> list[float]:
    """Host seconds of each of ``n`` calls of ``fn``, each ended by a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def rate_summary(times: list[float], clips: int | None = None) -> dict:
    """clips/s from the median, fastest and slowest call of ``times``, each
    call ``clips`` clips (default ``BATCH``)."""
    import statistics

    clips = BATCH if clips is None else clips
    return dict(clips_per_s=clips / statistics.median(times), fastest=clips / min(times),
                slowest=clips / max(times), calls=len(times))


def phase_train(torch, fa, fb, model, card, profile: bool = False):
    """Phase 6, the train path, on the calibrated flagship of phase 4; with
    ``profile``, one kernel-path train step is profiled as well."""
    import os
    import shutil

    import numpy as np

    from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
    from sap3d_tpu_torch.train.checkpoint import checkpoint_steps
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_train_step
    from sap3d_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(SEED)

    def batch():
        frames = (rng.normal(size=(BATCH, 16, SIZE, SIZE, 3)) * 0.3).astype(np.float32)
        targets = rng.uniform(size=(BATCH, 16, SIZE, SIZE)).astype(np.float32)
        return frames, targets

    def put(b):
        return tuple(torch.from_numpy(a).to(DEVICE) for a in b)

    def set_kernel(use_kernel):
        for sa in model.attention_modules():
            sa.use_kernel = use_kernel

    x, y = put(batch())
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    res = {}

    # (b), (c): one forward and backward, dropout 0, from one state
    from sap3d_tpu_torch.models.registry import build_model

    model.decoder.dropout_rate = 0.0

    def grads(m, use_kernel, forward=None, backward=None):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        m.train()
        m.zero_grad(set_to_none=True)
        with function_calls(forward, backward):
            loss = loss_fn_saliency(m(x), y)
            loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat

    fwd_calls, calls = [], []

    def spy_forward(q, k, v):
        o, lse = fa.flash_forward_lse(q, k, v)
        fwd_calls.append((q, k, v, o, lse))
        return o, lse

    def spy(q, k, v, o, lse, do):
        out = fb.flash_backward(q, k, v, o, lse, do)
        calls.append((q, k, v, o, lse, do, out))
        return out

    loss_k, g_k = grads(model, True, forward=spy_forward, backward=spy)
    res["b2_in_step"], res["b3_in_step"] = {}, {}
    for q, k, v, o, lse in fwd_calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        res["b2_in_step"][name] = check_b2(fa, f"{name} bf16 (in the flagship train step)",
                                           q, k, v, o, lse)
    for q, k, v, o, lse, do, out in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        res["b3_in_step"][name] = check_b3(fb, f"{name} bf16 (in the flagship train step)",
                                           q, k, v, o, lse, do, out)
    for kernel in ("b2_in_step", "b3_in_step"):
        if sorted(res[kernel]) != sorted(SITES):
            raise AssertionError(f"{kernel}: ran at {sorted(res[kernel])}, not at every site")
    del calls, fwd_calls

    def no_delta(q, k, v, o, lse, do):
        return fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    def one_step(m, bf16: bool) -> dict:
        """The kernel path against three other paths.  Held: against B2 with
        the plain B3 (the same forward; the backward's own difference), with
        a B3 without delta as the control.  Read beside it: the reference,
        the autograd Function on the plain B2 and B3, which rounds where the
        kernels do and shares no code with them (run twice: the floor), the
        plain path (autograd of softmax attention), and the reference with a
        plain forward that rounds where the kernel does."""
        ref = fb.flash_backward_reference
        loss_k_, g_k_ = (loss_k, g_k) if bf16 else grads(m, True)
        loss_s, g_s = grads(m, True, backward=ref)
        _, g_f = grads(m, True, backward=no_delta)
        loss_r, g_r = grads(m, True, forward=fa.flash_forward_lse_reference, backward=ref)
        _, g_r2 = grads(m, True, forward=fa.flash_forward_lse_reference, backward=ref)
        _, g_o = grads(m, True, forward=forward_rounded_as_kernel, backward=ref)
        loss_p, g_p = grads(m, False)
        return dict(loss_kernel=loss_k_, loss_reference=loss_r, loss_plain=loss_p,
                    loss_rel=abs(loss_k_ - loss_r) / abs(loss_r), grad_rel_l2=rel(g_k_, g_s),
                    fault_grad_rel_l2=rel(g_f, g_s), kernel_vs_reference=rel(g_k_, g_r),
                    reference_again=rel(g_r2, g_r), b2_forward_vs_reference=rel(g_s, g_r),
                    kernel_rounding_forward_vs_reference=rel(g_o, g_r),
                    plain_vs_reference=rel(g_p, g_r), kernel_vs_plain=rel(g_k_, g_p),
                    same_forward_loss_rel=abs(loss_k_ - loss_s) / abs(loss_s))

    e2e = {"bf16": one_step(model, True)}
    del g_k
    model32 = build_model("unet++", dtype="float32", device=DEVICE, dropout_rate=0.0)
    model32.load_state_dict(model.state_dict())
    e2e["float32"] = one_step(model32, False)
    del model32
    torch.cuda.empty_cache()
    for dname, r in e2e.items():
        loss_tol, grad_tol = TRAIN_TOL[dname]
        r.update(tol_loss_rel=loss_tol, tol_grad_rel_l2=grad_tol)
        print(f"[train] one step, {dname}, dropout 0: loss kernel path {r['loss_kernel']:.6f}, "
              f"reference {r['loss_reference']:.6f} (relative {r['loss_rel']:.3e}, limit "
              f"{loss_tol:g}); whole-gradient relative L2 of the kernel path against B2 with "
              f"the plain B3 {r['grad_rel_l2']:.3e} (limit {grad_tol:g}), control (B3 without "
              f"delta) {r['fault_grad_rel_l2']:.3e}", flush=True)
        print(f"[train]   {dname}, whole-gradient relative L2 against the reference (the "
              f"Function on the plain B2 and B3): the reference again "
              f"{r['reference_again']:.3e}, the kernel path {r['kernel_vs_reference']:.3e}, B2 "
              f"with the plain B3 {r['b2_forward_vs_reference']:.3e}, a plain forward rounding "
              f"as the kernel does {r['kernel_rounding_forward_vs_reference']:.3e}, the plain "
              f"path {r['plain_vs_reference']:.3e} (kernel path against the plain path "
              f"{r['kernel_vs_plain']:.3e})", flush=True)
    res["end_to_end"] = e2e

    # (a) launches per make_train_step call; (e) train clips/s and peak memory
    state = create_train_state(model, lr=1e-4)
    step = make_train_step(state)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    for use_kernel in (True, False):
        set_kernel(use_kernel)
        _zero_launch_counts(fa, fb)
        loss = step(x, y, gen)
        torch.cuda.synchronize()
        got = _launch_counts(fa, fb)
        want = {"B1": 0, "B2": len(SITES) if use_kernel else 0,
                "B3": len(SITES) if use_kernel else 0, "B4": 0}
        path = "kernel" if use_kernel else "plain"
        print(f"[train] launches in one make_train_step call ({path} path): {got}, "
              f"loss {loss.item():.4f}", flush=True)
        if got != want or not np.isfinite(loss.item()):
            raise AssertionError(f"expected {want} launches and a finite loss, got {got}")
    model.decoder.dropout_rate = 0.5
    thr = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        set_kernel(use_kernel)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        thr[label] = dict(rate_summary(step_times(torch, lambda: step(x, y, gen),
                                                  THROUGHPUT_CALLS)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    set_kernel(True)
    if profile:
        res["profile"] = profile_device_time(torch, lambda: step(x, y, gen),
                                             "one kernel-path train step")
    res["train_clips_per_s"] = thr
    print(f"[train] clips/s (batch {BATCH}, bf16, dropout 0.5; median [slowest, fastest] of "
          f"{THROUGHPUT_CALLS} steps each, order plain, kernel, kernel, plain): "
          f"{describe_rates(thr)}; peak memory kernel {thr['kernel']['peak_gib']:.2f} GiB, "
          f"plain {thr['plain']['peak_gib']:.2f} GiB  [{card}]", flush=True)
    del state, step

    # (d) Trainer.fit on in-memory batches, a checkpoint restored and resumed
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    cfg = Config(model=ModelConfig(name="unet++", dtype="bfloat16", dropout=0.5),
                 train=TrainConfig(batch_size=BATCH, lr=1e-4, valid_iter=2, save_iter=2,
                                   max_steps=TRAIN_STEPS, seed=SEED, info="smoke",
                                   model_dir=os.path.join(root, "model"),
                                   logs_dir=os.path.join(root, "logs")))
    try:
        trainer = Trainer(cfg, run="smoke", device=DEVICE)
        trainer.model.load_state_dict(model.state_dict())  # calibrated BN, gamma
        train_batches = [batch() for _ in range(TRAIN_STEPS)]
        valid = [batch()]
        _zero_launch_counts(fa, fb)
        t0 = time.perf_counter()
        trainer.fit(iter(train_batches), lambda: iter(valid))
        trainer.ckpt.wait_until_finished()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = _launch_counts(fa, fb)
        trainer.close()
        with open(os.path.join(trainer.logs_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["loss"] for r in records if "loss" in r]
        valid_rec = [r for r in records if "cc" in r]
        steps = checkpoint_steps(trainer.model_dir)
        # side dumps at every logged step (steps < 10) and one validation
        # batch run the eval forward, B1
        want = {"B1": len(SITES) * (TRAIN_STEPS + 1), "B2": len(SITES) * TRAIN_STEPS,
                "B3": len(SITES) * TRAIN_STEPS, "B4": 0}
        print(f"[train] Trainer.fit: {TRAIN_STEPS} steps in {fit_s:.2f} s, losses "
              f"{[round(v, 3) for v in losses]}, launches {fit_launches}, validation "
              f"{valid_rec}, checkpoints at steps {steps}", flush=True)
        if fit_launches != want:
            raise AssertionError(f"Trainer.fit: expected launches {want}, got {fit_launches}")
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError("Trainer.fit: missing or non-finite losses")
        if len(valid_rec) != 1 or not all(np.isfinite(valid_rec[0][k])
                                          for k in ("cc", "sim", "kld", "auc_judd")):
            raise AssertionError("Trainer.fit: no validation pass with finite metrics")
        if steps != [2, TRAIN_STEPS]:
            raise AssertionError(f"Trainer.fit: checkpoints at {steps}")
        final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        del trainer
        torch.cuda.empty_cache()

        resumed = Trainer(cfg.replace(train=dataclasses.replace(
            cfg.train, pretrain="smoke", max_steps=TRAIN_STEPS + 1)), run="smoke",
            device=DEVICE)
        same = all(torch.equal(resumed.model.state_dict()[k], v) for k, v in final.items())
        if resumed.state.step != TRAIN_STEPS or not same:
            raise AssertionError("the restored state is not the saved one")
        resumed.fit(iter([batch()]))
        resumed.close()
        steps = checkpoint_steps(resumed.model_dir)
        print(f"[train] restored step {TRAIN_STEPS} exactly into a second trainer and "
              f"resumed to step {resumed.state.step}; checkpoints at steps {steps}", flush=True)
        if resumed.state.step != TRAIN_STEPS + 1 or steps[-1] != TRAIN_STEPS + 1:
            raise AssertionError("the resumed trainer did not step on")
        del resumed, final
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    res["fit"] = dict(steps=TRAIN_STEPS, seconds=fit_s, losses=losses, launches=fit_launches,
                      validation=valid_rec[0])
    # (c)'s limits, held after the phase's other readings are taken
    for dname, r in e2e.items():
        if not (r["loss_rel"] <= r["tol_loss_rel"] and r["grad_rel_l2"] <= r["tol_grad_rel_l2"]):
            raise AssertionError(f"train step, {dname}: the kernel path disagrees with its "
                                 "plain versions")
        if not r["fault_grad_rel_l2"] > r["tol_grad_rel_l2"]:
            raise AssertionError("the train-step limits pass a B3 without delta; void")
    return res


# ---- phase 7: the GN + CBAM SA decoder ---------------------------------------


def launch_counts(fa, fb, ta) -> dict[str, int]:
    return dict(_launch_counts(fa, fb), B5=ta.flash_fwd_chunked_bwd.launches)


def zero_launch_counts(fa, fb, ta) -> None:
    _zero_launch_counts(fa, fb)
    ta.flash_fwd_chunked_bwd.launches = 0


@contextlib.contextmanager
def attention_sites(model):
    """Yields a dict that fills, for the duration, with name -> ((Nq, Nk, d,
    C), route) of the latest gated call of each self-attention module of
    ``model``'s decoder: what each module asked of ``attention_route`` and
    what it was told."""
    from sap3d_tpu_torch.ops import attention

    sites, running = {}, []
    orig = attention.attention_route

    def spy(nq, nk, d, c, dtype, train):
        route = orig(nq, nk, d, c, dtype, train)
        sites[running[-1]] = ((nq, nk, d, c), route)
        return route

    def leave(_module, _args, _output) -> None:
        running.pop()

    handles = []
    for name, m in model.decoder.named_modules():
        if isinstance(m, attention.SelfAttention3D):
            handles.append(m.register_forward_pre_hook(
                lambda _m, _args, name=name: running.append(name)))
            handles.append(m.register_forward_hook(leave))
    attention.attention_route = spy
    try:
        yield sites
    finally:
        attention.attention_route = orig
        for h in handles:
            h.remove()


@contextlib.contextmanager
def hybrid_flag(value: str | None):
    """SAP3D_FLASH_HYBRID set to ``value`` (None: unset) for the duration."""
    import os

    old = os.environ.get("SAP3D_FLASH_HYBRID")
    if value is None:
        os.environ.pop("SAP3D_FLASH_HYBRID", None)
    else:
        os.environ["SAP3D_FLASH_HYBRID"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("SAP3D_FLASH_HYBRID", None)
        else:
            os.environ["SAP3D_FLASH_HYBRID"] = old


def build_gn_model(torch, dtype: str, gen=None, like=None, dropout_rate: float = 0.5):
    """The GN SA decoder at full width; gamma drawn from [0.5, 1.5] (at its
    init, 0, a dead attention kernel passes every end-to-end check), or the
    weights of ``like``."""
    from sap3d_tpu_torch.models.registry import build_model

    model = build_model(GN_MODEL, dtype=dtype, device=DEVICE, seed=SEED,
                        dropout_rate=dropout_rate)
    if like is not None:
        model.load_state_dict(like.state_dict())
    else:
        with torch.no_grad():
            for sa in model.attention_modules():
                sa.gamma.copy_(torch.rand(1, device=DEVICE, generator=gen) + 0.5)
    return model


def phase_gn_forward(torch, fa, model, x, card):
    """Phase 7(a): the GN SA decoder's eval forward."""
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.steps import make_eval_step

    def run(m, use_kernel, want_launches):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        out = make_eval_step(m)(x)
        torch.cuda.synchronize()
        if fa.flash_attend_tokens.launches != want_launches:
            raise AssertionError(f"GN forward: expected {want_launches} B1 launches, got "
                                 f"{fa.flash_attend_tokens.launches}")
        return out

    calls = []

    def spy(q, k, v):
        o = fa.flash_attend_tokens(q, k, v)
        calls.append((q, k, v, o))
        return o

    with ta.forward_kernel(spy), attention_sites(model) as sites:
        kern16 = run(model, True, 3)
    for name, (shape, route) in sites.items():
        print(f"[gn] site {name}: (Nq, Nk, d, C) = {shape}, eval route {route}", flush=True)
    if len(sites) != 3 or any(route != "flash" for _, route in sites.values()):
        raise AssertionError(f"GN forward: expected three sites on the kernel, got {sites}")
    by_shape = {shape: name for name, (shape, _) in sites.items()}
    held = {}
    for q, k, v, o in calls:
        name = by_shape[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        held[name] = check_b1(fa, f"{name} bf16 (in the GN forward)", q, k, v, o,
                              heaviest=True)
    if sorted(held) != sorted(sites):
        raise AssertionError(f"B1 ran at {sorted(held)}, not at every GN site")
    del calls
    plain16 = run(model, False, 0)
    with ta.forward_kernel(lambda q, k, v: drop_heaviest_key_tile(fa, q, k, v)):
        fault16 = run(model, True, 0)
    gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.zero_()
        no_attn16 = run(model, False, 0)
        for sa, g in zip(model.attention_modules(), gammas):
            sa.gamma.copy_(g)

    model32 = build_gn_model(torch, "float32", like=model)
    ref32 = run(model32, False, 0)
    kern32 = run(model32, True, 3)
    del model32
    torch.cuda.empty_cache()

    # The output is linear: distances are read against its spread.
    scale = ref32.std().item()
    err32 = (kern32 - ref32).abs().max().item() / scale
    mean16 = (kern16 - plain16).abs().mean().item() / scale
    fault16_mean = (fault16 - plain16).abs().mean().item() / scale
    no_attn_mean = (no_attn16 - plain16).abs().mean().item() / scale
    bf16_gap = (plain16 - ref32).abs().mean().item() / scale
    tol32 = 1e-3
    print(f"[gn] forward {tuple(x.shape)} -> {tuple(kern16.shape)}, 3 B1 launches; linear "
          f"output mean {kern16.mean().item():.4f}, std {kern16.std().item():.4f}, range "
          f"[{kern16.min().item():.4f}, {kern16.max().item():.4f}]; in units of the fp32 "
          f"output's std {scale:.4f}: fp32 kernel vs plain path max {err32:.3e} (tol "
          f"{tol32:g}); bf16 kernel vs plain path mean {mean16:.3e} (tol {GN_E2E_MEAN_TOL:g}), "
          f"no attention {no_attn_mean:.3e}, planted fault {fault16_mean:.3e}; bf16 vs fp32 "
          f"forward mean {bf16_gap:.3e}", flush=True)
    if not bool(torch.isfinite(kern16).all().item()) or kern16.shape != (*x.shape[:4],):
        raise AssertionError("GN forward: non-finite output or wrong shape")
    # neither constant nor blown up: GroupNorm keeps the activations O(1)
    if not (1e-3 < kern16.std().item() < 1e3 and kern16.abs().max().item() < 1e4):
        raise AssertionError("GN forward: the output is constant or blown up")
    if not err32 <= tol32 or not mean16 <= GN_E2E_MEAN_TOL:
        raise AssertionError("GN forward: kernel path disagrees with plain path")
    if not no_attn_mean > GN_E2E_MEAN_TOL:
        raise AssertionError("GN forward: the checks pass a model without attention; void")

    step = make_eval_step(model)
    thr = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        for m in model.attention_modules():
            m.use_kernel = use_kernel
        thr[label] = rate_summary(step_times(torch, lambda: step(x), THROUGHPUT_CALLS))
    for m in model.attention_modules():
        m.use_kernel = True
    print(f"[gn] forward clips/s (batch {BATCH}, bf16; median [slowest, fastest] of "
          f"{THROUGHPUT_CALLS} forwards each, order plain, kernel, kernel, plain): "
          f"{describe_rates(thr)}  [{card}]", flush=True)
    return dict(sites={n: dict(shape=s_, route=r) for n, (s_, r) in sites.items()}, held=held,
                fp32_max_err_over_std=err32, bf16_mean_err_over_std=mean16,
                bf16_fault_over_std=fault16_mean, bf16_no_attention_over_std=no_attn_mean,
                bf16_vs_fp32_over_std=bf16_gap, output_std=scale, clips_per_s=thr)


def b5_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of B5's forward plus backward: the forward's
    bound (B1's), and for the backward q, k, v and do read and dq, dk, dv
    written, against the five products that dq, dk and dv of (q, k, v, do)
    need, 2*b*nq*nk*(3d + 2C) FLOPs as for B3 (o is not needed: delta =
    rowsum(p * dp)).  The bound is the function's: the p v product of the
    implementation's recompute is not counted."""
    fwd_ms, _ = flash_bound(b, nq, nk, d, c, dtype_name, itemsize)
    nbytes = b * (2 * (nq * d + nk * d + nk * c) + nq * c) * itemsize
    bwd_ms, bwd_by = _bound(nbytes, 2 * b * nq * nk * (3 * d + 2 * c), dtype_name)
    return fwd_ms + bwd_ms, bwd_by, fwd_ms, bwd_ms


def phase_b5(torch, fa, fb, ta, flush, sites):
    """Phase 7(b), kernel B5 at the GN sites on random inputs: o against the
    plain version under B1's limits; dq, dk, dv against autograd through
    ``attend_tokens`` on the same inputs under B3's limits; the planted
    fault is the same computation on a k whose last 64 keys are zeroed."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in sites.items():
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            label = f"{site} {dname} (random inputs)"

            before = ta.flash_fwd_chunked_bwd.launches, fa.flash_attend_tokens.launches
            out = ta.flash_fwd_chunked_bwd(q, k, v)
            if (ta.flash_fwd_chunked_bwd.launches, fa.flash_attend_tokens.launches) != \
                    (before[0] + 1, before[1]):
                raise AssertionError("B5 counts one launch of its own per call and none of B1's")
            got = torch.autograd.grad(out, (q, k, v), do)
            plain_out = ta.attend_tokens(q, k, v)
            want = torch.autograd.grad(plain_out, (q, k, v), do)
            kz = k.detach().clone()
            kz[:, -KEY_TILE:] = 0
            kz.requires_grad_()
            fault_out = ta.flash_fwd_chunked_bwd(q, kz, v)
            fault = torch.autograd.grad(fault_out, (q, kz, v), do)
            zeroed = f"last {KEY_TILE} keys zeroed"
            res = {"o": hold(f"B5 o {label}", out.detach(), plain_out.detach(),
                             fault_out.detach(), zeroed, fa.TOLERANCE)}
            for name, g, w, f in zip(("dq", "dk", "dv"), got, want, fault):
                res[name] = hold(f"B5 {name} {label}", g, w, f, zeroed, fb.TOLERANCE)
            del out, plain_out, fault_out, got, want, fault, kz
            row = dict(res, site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c,
                       max_abs_err=max(r["max_abs_err"] for r in res.values()))

            iters = 3 if dtype == torch.float32 else 5
            out = ta.flash_fwd_chunked_bwd(q, k, v)
            row["fwd_ms"] = time_ms(lambda: ta.flash_fwd_chunked_bwd(q, k, v), iters, flush)
            row["bwd_ms"] = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do,
                                                                retain_graph=True), iters, flush)
            del out
            plain_out = ta.attend_tokens(q, k, v)
            row["plain_fwd_ms"] = time_ms(lambda: ta.attend_tokens(q, k, v), iters, flush)
            row["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                plain_out, (q, k, v), do, retain_graph=True), iters, flush)
            del plain_out
            row["ms"] = row["fwd_ms"] + row["bwd_ms"]
            row["plain_ms"] = row["plain_fwd_ms"] + row["plain_bwd_ms"]
            qd, kd, vd = (t.detach() for t in (q, k, v))
            lib_f, backend = sdpa_yardstick(qd, kd, vd, flush)
            lib_b, _ = sdpa_yardstick(qd, kd, vd, flush, do=do)
            row["library_ms"] = None if None in (lib_f, lib_b) else lib_f + lib_b
            row["library_backend"] = backend
            row["bound_ms"], row["bound_by"], row["bound_fwd_ms"], row["bound_bwd_ms"] = \
                b5_bound(BATCH, nq, nk, d, c, dname, q.element_size())
            lib = row["library_ms"]
            print(f"[kernel] B5 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: forward "
                  f"{row['fwd_ms']:.4f} + backward {row['bwd_ms']:.4f} = {row['ms']:.4f} ms, "
                  f"plain {row['plain_fwd_ms']:.4f} + {row['plain_bwd_ms']:.4f} = "
                  f"{row['plain_ms']:.4f} ms, sdpa forward + backward "
                  f"{lib if lib is None else f'{lib:.4f}'} ms ({backend}), bound "
                  f"{row['bound_fwd_ms']:.4f} + {row['bound_bwd_ms']:.4f} = "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            rows.append(row)
            del q, k, v, do, qd, kd, vd
            torch.cuda.empty_cache()

    # Chunking: at the flagship's x_1_3 shape the backward runs 7 chunks of
    # 4096 queries; its peak stays under one full [B, Nq, Nk] float32 block.
    nq, nk, d, c = SITES["x_1_3"]
    dtype = torch.bfloat16
    q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
    k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
    v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
    do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def backward_peak(fn):
        out = fn(q, k, v)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        return grads, held, torch.cuda.max_memory_allocated() - held

    got, held_b5, peak_b5 = backward_peak(ta.flash_fwd_chunked_bwd)
    want, held_plain, peak_plain = backward_peak(ta.attend_tokens)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check = fa.agreement(g, w, fb.TOLERANCE)
        print(f"[check] B5 {name} x_1_3 bf16 (7 chunks): max_abs_err "
              f"{check['max_abs_err']:.3e}, excess {check['excess']:.3f}", flush=True)
        if not check["finite"] or not check["excess"] <= 1:
            raise AssertionError(f"B5 {name} over 7 chunks disagrees with attend_tokens")
    full_block = BATCH * nq * nk * 4
    gib = 2.0 ** 30
    print(f"[kernel] B5 backward at x_1_3 (B={BATCH}, Nq={nq}, Nk={nk}; 7 chunks): peak "
          f"{peak_b5 / gib:.3f} GiB above the {held_b5 / gib:.3f} GiB held after its forward; "
          f"one full [B, Nq, Nk] fp32 block is {full_block / gib:.3f} GiB; autograd through "
          f"attend_tokens holds {held_plain / gib:.3f} GiB after its forward and peaks "
          f"{peak_plain / gib:.3f} GiB above that", flush=True)
    if not peak_b5 < full_block:
        raise AssertionError("B5's backward peaks above one full score block: not chunked")
    del got, want, q, k, v, do
    torch.cuda.empty_cache()
    return rows, dict(peak_b5_bytes=peak_b5, held_b5_bytes=held_b5, full_block_bytes=full_block,
                      peak_plain_bytes=peak_plain, held_plain_bytes=held_plain)


def phase_gn_predictor(torch, fa, model):
    """Phase 7(c), the GN inference path: the predictor on 40 frames."""
    import numpy as np

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.train.steps import make_eval_step

    frames = (np.random.default_rng(SEED).normal(size=(40, SIZE, SIZE, 3)) * 0.3
              ).astype(np.float32)
    with SlidingWindowPredictor(make_eval_step(model), batch_windows=BATCH,
                                image_size=SIZE, device=DEVICE) as pred:
        fa.flash_attend_tokens.launches = 0
        t0 = time.perf_counter()
        maps = pred.predict_video(frames=frames)
        dt = time.perf_counter() - t0
        launches = fa.flash_attend_tokens.launches
    print(f"[gn] predictor: 40 frames -> {maps.shape}, linear maps mean {maps.mean():.4f}, "
          f"std {maps.std():.4f}, range [{maps.min():.4f}, {maps.max():.4f}], {dt:.3f} s, "
          f"B1 launches {launches}", flush=True)
    if maps.shape != (40, SIZE, SIZE) or not np.isfinite(maps).all() \
            or not 1e-3 < maps.std() < 1e3:
        raise AssertionError("GN predictor: wrong shape, non-finite or constant maps")
    want = -(-25 // BATCH) * 3  # 25 windows in batches of 16, a launch per site
    if launches != want:
        raise AssertionError(f"expected {want} B1 launches in the GN predictor run, got "
                             f"{launches}")
    return launches


def phase_gn_train(torch, fa, fb, ta, model, sites, card, profile: bool = False):
    """Phase 7(d), the GN train path with SAP3D_FLASH_HYBRID=1."""
    import os
    import shutil

    import numpy as np

    from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
    from sap3d_tpu_torch.ops import attention
    from sap3d_tpu_torch.train.checkpoint import checkpoint_steps
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_train_step
    from sap3d_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(SEED + 7)

    def batch():
        frames = (rng.normal(size=(BATCH, 16, SIZE, SIZE, 3)) * 0.3).astype(np.float32)
        targets = rng.uniform(size=(BATCH, 16, SIZE, SIZE)).astype(np.float32)
        return frames, targets

    x, y = (torch.from_numpy(a).to(DEVICE) for a in batch())

    # what the gate predicts from the shapes the model printed
    def predicted(hybrid: bool) -> dict[str, int]:
        with hybrid_flag("1" if hybrid else None):
            routes = [ta.attention_route(*shape, torch.bfloat16, train=True)
                      for shape, _ in sites.values()]
        return {"B1": 0, "B2": routes.count("flash"), "B3": routes.count("flash"), "B4": 0,
                "B5": routes.count("hybrid")}

    want_on, want_off = predicted(True), predicted(False)
    print(f"[gn] launches per train step as the gate predicts: hybrid on {want_on}, off "
          f"{want_off}", flush=True)
    if want_on["B5"] != 1 or want_off["B5"] != 0 or want_on["B2"] != 2:
        raise AssertionError("the gate does not route the GN sites as B3's limits say")
    res = {"predicted_launches": {"hybrid_on": want_on, "hybrid_off": want_off}}

    def set_kernel(m, use_kernel):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel

    @contextlib.contextmanager
    def plain_kernels(b3=None, everything=False):
        """B3 replaced by ``b3`` and, with ``everything``, B2 and B5's
        forward by their plain versions too."""
        orig = attention.launch_forward
        if everything:
            attention.launch_forward = \
                lambda q, k, v, want_lse: (fa.flash_attend_tokens_reference(q, k, v), None)
        try:
            with function_calls(fa.flash_forward_lse_reference if everything else None, b3):
                yield
        finally:
            attention.launch_forward = orig

    def grads(m, use_kernel, **patch):
        """(loss, the whole gradient, the gradient of the attention sites'
        f, g and h projections), flattened."""
        set_kernel(m, use_kernel)
        m.train()
        m.zero_grad(set_to_none=True)
        with plain_kernels(**patch):
            loss = loss_fn_saliency(m(x), y)
            loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        proj = torch.cat([p.grad.float().flatten() for sa in m.attention_modules()
                          for conv in (sa.f, sa.g, sa.h) for p in conv.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat, proj

    def b5_in_step(m, dname: str) -> dict:
        """Kernel B5 on the train step's own tensors: the o it returned and
        the dq, dk and dv it handed back to autograd, against
        ``attend_tokens`` and autograd through it on the same q, k, v and
        do.  Planted fault: the plain computation on a k whose heaviest tile
        of keys is zeroed (the last keys of this site hold the bias alone)."""
        import types

        function, calls = attention._FlashForwardChunkedBackward, []

        def apply(q, k, v):
            o = function.apply(q, k, v)
            rec = dict(q=q.detach(), k=k.detach(), v=v.detach(), o=o.detach())
            o.register_hook(lambda g: rec.__setitem__("do", g.to(v.dtype)))
            for name, t in (("dq", q), ("dk", k), ("dv", v)):
                t.register_hook(lambda g, name=name: rec.__setitem__(name, g))
            calls.append(rec)
            return o

        attention._FlashForwardChunkedBackward = types.SimpleNamespace(apply=apply)
        try:
            grads(m, True)
        finally:
            attention._FlashForwardChunkedBackward = function
        names = {shape: name for name, (shape, _) in sites.items()}
        held = {}
        for rec in calls:
            q, k, v = (rec[n].clone().requires_grad_() for n in "qkv")
            name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
            label = f"{name} {dname} (in the GN train step)"
            want_o = ta.attend_tokens(q, k, v)
            want = torch.autograd.grad(want_o, (q, k, v), rec["do"])
            kz = rec["k"].clone()
            kz[:, heaviest_key_tile(rec["q"], rec["k"])] = 0
            kz.requires_grad_()
            fault_o = ta.attend_tokens(q, kz, v)
            fault = torch.autograd.grad(fault_o, (q, kz, v), rec["do"])
            zeroed = f"the heaviest {KEY_TILE}-key tile's keys zeroed"
            res_ = {"o": hold(f"B5 o {label}", rec["o"], want_o.detach(), fault_o.detach(),
                              zeroed, fa.TOLERANCE)}
            for out, w, f in zip(("dq", "dk", "dv"), want, fault):
                res_[out] = hold(f"B5 {out} {label}", rec[out], w, f, zeroed, fb.TOLERANCE)
            held[name] = dict(res_, max_abs_err=max(r["max_abs_err"] for r in res_.values()))
        if len(calls) != want_on["B5"] or len(held) != want_on["B5"]:
            raise AssertionError(f"B5 ran {len(calls)} times in the step, at {sorted(held)}; "
                                 f"the gate gives it {want_on['B5']} site(s)")
        return held

    def no_delta(q, k, v, o, lse, do):
        return fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    def one_step(m) -> dict:
        """The kernel path (B2 + B3 at two sites, B5 at the third) against:
        the same with the plain B3 (held: the same forward, the backward's
        own difference), on the whole gradient and on the gradient of the
        sites' f, g and h projections, which dq, dk and dv alone feed;
        control: a B3 without delta, read on the projections (this model's
        linear output makes a loss whose gradient the attention sites move
        little: on the whole gradient the control is within 1.5x of the sound
        reading); the same Functions on the plain B2, B3 and B1 (the loss is
        held against it); the plain path (attend_tokens at every site), run
        twice for the floor."""
        ref = fb.flash_backward_reference
        loss_k, g_k, a_k = grads(m, True)
        loss_s, g_s, a_s = grads(m, True, b3=ref)
        _, g_f, a_f = grads(m, True, b3=no_delta)
        loss_r, g_r, _ = grads(m, True, b3=ref, everything=True)
        loss_p, g_p, a_p = grads(m, False)
        _, g_p2, a_p2 = grads(m, False)
        return dict(loss_kernel=loss_k, loss_reference=loss_r, loss_plain=loss_p,
                    loss_rel=abs(loss_k - loss_r) / abs(loss_r), grad_rel_l2=rel(g_k, g_s),
                    proj_grad_rel_l2=rel(a_k, a_s), fault_grad_rel_l2=rel(g_f, g_s),
                    fault_proj_grad_rel_l2=rel(a_f, a_s), kernel_vs_reference=rel(g_k, g_r),
                    kernel_vs_plain=rel(g_k, g_p), plain_again=rel(g_p2, g_p),
                    proj_kernel_vs_plain=rel(a_k, a_p), proj_plain_again=rel(a_p2, a_p),
                    same_forward_loss_rel=abs(loss_k - loss_s) / abs(loss_s))

    with hybrid_flag("1"):
        model.decoder.dropout_rate = 0.0
        # deterministic cuDNN algorithms for the comparison alone: what is
        # left between two runs is the kernels' own (B3's atomic dq sums)
        was_deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            res["b5_in_step"] = {"bf16": b5_in_step(model, "bf16")}
            e2e = {"bf16": one_step(model)}
            model32 = build_gn_model(torch, "float32", like=model, dropout_rate=0.0)
            res["b5_in_step"]["float32"] = b5_in_step(model32, "float32")
            e2e["float32"] = one_step(model32)
            del model32
        finally:
            torch.backends.cudnn.deterministic = was_deterministic
        torch.cuda.empty_cache()
        for dname, r in e2e.items():
            loss_tol, grad_tol = GN_TRAIN_TOL[dname]
            proj_tol = GN_PROJ_TOL[dname]
            r.update(tol_loss_rel=loss_tol, tol_grad_rel_l2=grad_tol, tol_proj_rel_l2=proj_tol)
            print(f"[gn] one step, {dname}, dropout 0, hybrid on: loss kernel path "
                  f"{r['loss_kernel']:.6f}, the same Functions on the plain kernels "
                  f"{r['loss_reference']:.6f} (relative {r['loss_rel']:.3e}, limit "
                  f"{loss_tol:g}), plain path {r['loss_plain']:.6f}; whole-gradient relative "
                  f"L2 of the kernel path against the same with the plain B3 "
                  f"{r['grad_rel_l2']:.3e} (limit {grad_tol:g}), of the sites' f/g/h projections "
                  f"{r['proj_grad_rel_l2']:.3e} (limit {proj_tol:g}), control (B3 without "
                  f"delta) {r['fault_grad_rel_l2']:.3e} and {r['fault_proj_grad_rel_l2']:.3e}; "
                  f"whole gradient against the plain kernels {r['kernel_vs_reference']:.3e}, "
                  f"against the plain path {r['kernel_vs_plain']:.3e} (the plain path again "
                  f"{r['plain_again']:.3e}); projections against the plain path "
                  f"{r['proj_kernel_vs_plain']:.3e} (again {r['proj_plain_again']:.3e})",
                  flush=True)
        res["end_to_end"] = e2e

        # launches per make_train_step call, flag on and off
        state = create_train_state(model, lr=1e-4)
        step = make_train_step(state)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        set_kernel(model, True)
        for flag, want in (("1", want_on), (None, want_off)):
            with hybrid_flag(flag):
                zero_launch_counts(fa, fb, ta)
                with attention_sites(model) as seen:
                    loss = step(x, y, gen)
                torch.cuda.synchronize()
                got = launch_counts(fa, fb, ta)
                routes = {n: r for n, (_, r) in seen.items()}
            print(f"[gn] launches in one make_train_step call (hybrid "
                  f"{'on' if flag else 'off'}): {got}, routes {routes}, loss "
                  f"{loss.item():.4f}", flush=True)
            if got != want or not np.isfinite(loss.item()):
                raise AssertionError(f"expected {want} launches and a finite loss, got {got}")

        # train clips/s and peak memory: plain, kernel, kernel, plain, with
        # the flag on (B5 at the C = 1024 site) and off (attend_tokens there)
        model.decoder.dropout_rate = 0.5
        thr = {}
        for name, flag in (("hybrid_on", "1"), ("hybrid_off", None)):
            with hybrid_flag(flag):
                thr[name] = {}
                for label, use_kernel in (("plain", False), ("kernel", True),
                                          ("kernel2", True), ("plain2", False)):
                    set_kernel(model, use_kernel)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    thr[name][label] = dict(
                        rate_summary(step_times(torch, lambda: step(x, y, gen),
                                                THROUGHPUT_CALLS)),
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            print(f"[gn] train clips/s, {name.replace('_', ' ')} (batch {BATCH}, bf16, dropout "
                  f"0.5; median [slowest, fastest] of {THROUGHPUT_CALLS} steps each, order "
                  f"plain, kernel, kernel, plain): {describe_rates(thr[name])}; peak memory "
                  f"kernel {thr[name]['kernel']['peak_gib']:.2f} GiB, plain "
                  f"{thr[name]['plain']['peak_gib']:.2f} GiB  [{card}]", flush=True)
        set_kernel(model, True)
        res["train_clips_per_s"] = thr
        if profile:
            res["profile"] = profile_device_time(
                torch, lambda: step(x, y, gen), "one GN train step, hybrid on")
        del state, step

        # Trainer.fit: 3 steps, side dumps, one validation pass, checkpoints
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "smoke_train_gn")
        shutil.rmtree(root, ignore_errors=True)
        cfg = Config(model=ModelConfig(name=GN_MODEL, dtype="bfloat16", dropout=0.5),
                     train=TrainConfig(batch_size=BATCH, lr=1e-4, valid_iter=2, save_iter=2,
                                       max_steps=TRAIN_STEPS, seed=SEED, info="smoke",
                                       model_dir=os.path.join(root, "model"),
                                       logs_dir=os.path.join(root, "logs")))
        try:
            trainer = Trainer(cfg, run="smoke", device=DEVICE)
            trainer.model.load_state_dict(model.state_dict())  # gamma nonzero
            train_batches = [batch() for _ in range(TRAIN_STEPS)]
            valid = [batch()]
            zero_launch_counts(fa, fb, ta)
            t0 = time.perf_counter()
            trainer.fit(iter(train_batches), lambda: iter(valid))
            trainer.ckpt.wait_until_finished()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            fit_launches = launch_counts(fa, fb, ta)
            trainer.close()
            with open(os.path.join(trainer.logs_dir, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            losses = [r["loss"] for r in records if "loss" in r]
            valid_rec = [r for r in records if "cc" in r]
            steps = checkpoint_steps(trainer.model_dir)
            no_stats = not any(key.endswith((".mean", ".var"))
                               for key in trainer.model.state_dict())
            del trainer
        finally:
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
    # side dumps at every logged step (steps < 10) and one validation batch
    # run the eval forward: B1 at the three sites
    want = {"B1": 3 * (TRAIN_STEPS + 1), "B2": want_on["B2"] * TRAIN_STEPS,
            "B3": want_on["B3"] * TRAIN_STEPS, "B4": 0, "B5": want_on["B5"] * TRAIN_STEPS}
    falling = losses[-1] < losses[0]
    trend = "falling" if falling else "not falling: each step sees another random batch"
    print(f"[gn] Trainer.fit, hybrid on: {TRAIN_STEPS} steps in {fit_s:.2f} s, losses "
          f"{[round(v, 3) for v in losses]} ({trend}), launches {fit_launches}, "
          f"validation {valid_rec}, checkpoints at steps {steps}", flush=True)
    if fit_launches != want:
        raise AssertionError(f"GN Trainer.fit: expected launches {want}, got {fit_launches}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError("GN Trainer.fit: missing or non-finite losses")
    # KLD of a linear output with negative values is NaN (the log of a
    # negative ratio, in both packages); the other three must be finite
    if len(valid_rec) != 1 or not all(np.isfinite(valid_rec[0][key])
                                      for key in ("cc", "sim", "auc_judd")):
        raise AssertionError("GN Trainer.fit: no validation pass with finite metrics")
    if steps != [2, TRAIN_STEPS] or not no_stats:
        raise AssertionError(f"GN Trainer.fit: checkpoints at {steps}, BN statistics in a "
                             "GN model")
    res["fit"] = dict(steps=TRAIN_STEPS, seconds=fit_s, losses=losses, launches=fit_launches,
                      validation=valid_rec[0], falling=falling)
    for dname, r in e2e.items():
        if not (r["loss_rel"] <= r["tol_loss_rel"] and r["grad_rel_l2"] <= r["tol_grad_rel_l2"]
                and r["proj_grad_rel_l2"] <= r["tol_proj_rel_l2"]):
            raise AssertionError(f"GN train step, {dname}: the kernel path disagrees with its "
                                 "plain versions")
        if not r["fault_proj_grad_rel_l2"] > r["tol_proj_rel_l2"]:
            raise AssertionError("the GN train-step limits pass a B3 without delta; void")
    return res


def phase_zoo(torch, fa, measured):
    """Phase 8: every registry name on the card, one bf16 eval forward at
    batch 2.  No site of at least one query block may run plain PyTorch.
    Returns the (Nq, Nk, d, C) of each site of at least one query block
    whose shape is not in ``measured`` (the 'full' head's x_0_1_sa, d = 2,
    C = 16), by site name, for ``phase_kernels`` at batch 2."""
    from sap3d_tpu_torch.models.registry import LINEAR_OUTPUT, MODEL_REGISTRY, build_model

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    x = torch.randn(2, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
    res, new_sites = {}, {}
    for name in MODEL_REGISTRY:
        model = build_model(name, dtype="bfloat16", device=DEVICE, seed=SEED)
        # gamma nonzero, and BN statistics calibrated on the batch: at their
        # init (0, 1) nothing normalizes the 47 blocks, and the non-local
        # blocks (cubic in their input) then overflow
        calibrate_and_randomize_bn(torch, model, x, gen)
        fa.flash_attend_tokens.launches = 0
        with torch.inference_mode(), attention_sites(model) as sites:
            out = model(x)
        torch.cuda.synchronize()
        launches = fa.flash_attend_tokens.launches
        gated = sum(route == "flash" for _, route in sites.values())
        lo, hi = out.min().item(), out.max().item()
        print(f"[zoo] {name}: {tuple(out.shape)}, range [{lo:.4f}, {hi:.4f}], B1 launches "
              f"{launches}, sites {({n: s_ for n, (s_, _) in sites.items()})}", flush=True)
        if tuple(out.shape) != (2, 16, SIZE, SIZE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: wrong shape or non-finite output")
        if name not in LINEAR_OUTPUT and not (0.0 <= lo and hi <= 1.0):
            raise AssertionError(f"{name}: a sigmoid output outside [0, 1]")
        if not launches == gated == ZOO_LAUNCHES[name]:
            raise AssertionError(f"{name}: {launches} B1 launches, the gate gives {gated}, "
                                 f"expected {ZOO_LAUNCHES[name]}")
        res[name] = dict(launches=launches, min=lo, max=hi)
        for site, (shape, route) in sites.items():
            if route == "plain" and shape[0] >= fa.BLOCK_Q:
                raise AssertionError(f"{name} site {site} {shape}: plain PyTorch on the card")
            if shape[0] >= fa.BLOCK_Q and shape not in measured:
                new_sites[site] = shape
        del model, out
        torch.cuda.empty_cache()
    if len(res) != 14:
        raise AssertionError(f"the registry holds {len(res)} names, not 14")
    return res, new_sites


# ---- phase 9: long clips, ring attention over a time mesh ------------------


def check_b4(fb, label, q, k, v, o, lse, do, dlse, got):
    """B4's dq, dk, dv against the plain version's (with ``dlse``).  Planted
    faults: B3 in B4's place, the lse cotangent dropped (the B3 kernel on the
    same inputs), for dq and dk; dv, which dlse does not reach, with its last
    key tile dropped, held row by row too (``DV_ROW_TOLERANCE``)."""
    want = fb.flash_backward_reference(q, k, v, o, lse, do, dlse)
    b3 = fb.flash_backward(q, k, v, o, lse, do)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    dv_dropped = want[2].clone()
    dv_dropped[:, keep:] = 0
    faults = (b3[0], b3[1], dv_dropped)
    names = ("B3 in its place, dlse dropped",) * 2 + (_DROPPED,)
    rows = (None, None, fb.DV_ROW_TOLERANCE)
    res = {out: hold(f"B4 {out} {label}", g, w, f, n, fb.TOLERANCE, r)
           for out, g, w, f, n, r in zip(("dq", "dk", "dv"), got, want, faults, names, rows)}
    return dict(res, max_abs_err=max(r["max_abs_err"] for r in res.values()))


def b4_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of B4: B3's, and the [b, nq] float32 dlse read."""
    nbytes = b * (2 * (nq * d + nk * d + nk * c) + 2 * nq * c) * itemsize + 8 * b * nq
    return _bound(nbytes, 2 * b * nq * nk * (3 * d + 2 * c), dtype_name)


def phase_b4(torch, fa, fb, flush):
    """Phase 9(c): B4 at the ring's per-shard shapes (the flagship's SITES:
    the 4 shards of a batch of 4 stack into one batch-16 launch per hop) on
    random inputs, bf16 and fp32, against its plain version, with B3's time
    on the same inputs beside it."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in SITES.items():
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
            dlse = torch.randn(BATCH, nq, device=DEVICE, generator=gen)
            o, lse = fa.flash_forward_lse(q, k, v)
            got = fb.flash_backward(q, k, v, o, lse, do, dlse=dlse)
            row = dict(check_b4(fb, f"{site} {dname} (random inputs)", q, k, v, o, lse, do,
                                dlse, got), site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            del got
            heavy = nq * nk * (d + c) > 5e9
            iters = (3 if dtype == torch.float32 else 5) if heavy else 20
            row["ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do, dlse=dlse),
                                iters, flush)
            row["b3_ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do), iters, flush)
            row["plain_ms"] = time_ms(
                lambda: fb.flash_backward_reference(q, k, v, o, lse, do, dlse),
                max(iters // 4, 3), flush)
            row["library_ms"], row["library_backend"] = None, "none"
            row["bound_ms"], row["bound_by"] = b4_bound(BATCH, nq, nk, d, c, dname,
                                                        q.element_size())
            print(f"[kernel] B4 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: kernel "
                  f"{row['ms']:.4f} ms, B3 on the same inputs {row['b3_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, no library call returns an lse gradient, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            rows.append(row)
            del q, k, v, do, dlse, o, lse
            torch.cuda.empty_cache()
    return rows


RING_SHARDS = 4
# [4, 64, 112, 112, 3]: the activation volume of phase 6's batch of 16
# 16-frame clips.  The per-shard sites of the flagship at 64 frames are
# SITES (and x_4_0 at 49 queries, the chunked hop); the 4 shards of one
# site share the card and run each hop as one batch-16 launch.
RING_BATCH, RING_FRAMES = 4, 64
RING_SITES = dict(SITES, x_4_0=(49, 49, 128, 1024))
# Mean |ring - gather| of the bf16 eval forward (sigmoid output).  At 64
# frames the random network carries bf16 rounding further than at 16
# (E2E_MEAN_TOL): on an H100 the plain path read 4.5e-2 from the gather
# path's kernels, the ring 3.1e-2, the forward without attention 0.50.  The
# tight check of the forward is in float32 (RING_FP32_FWD_TOL).
RING_E2E_MEAN_TOL = 0.1
# fp32 eval forward at batch 1, ring against gather: mean |diff| of the
# sigmoid output; the forward without attention must exceed it.  On an H100
# the ring read 8.0e-6, the plain path 8.2e-6 from the gather path's
# kernels, no attention 0.50.  The largest element is read, not held: 6.2e-2
# for the ring and 2.4e-2 for the plain path (no attention 0.99).  The
# random network amplifies any disturbance of the attention outputs: the
# gather path with B1's o moved at random by the ring op's own relative
# distance (2.2e-6, ``perturbed``) reads mean 4.3e-5 and max 0.29.
RING_FP32_FWD_TOL = 1e-4
# The fp32 train step, ring against gather, at batch 1 (dropout 0, cuDNN's
# deterministic algorithms): (relative loss, relative L2 of the whole
# gradient) limits.  On an H100 the loss read 2.1e-7 and the gradient
# 2.05e-3, where the gather step run twice reads 1.0e-5 (B3's atomic dq),
# the plain path 1.05e-3, the gather path with B2's o moved at random by the
# ring op's own distance 1.6e-2, and the control, B3 in B4's place (the lse
# cotangent dropped), 0.65.  The ring op alone is within 6.2e-6 of the gather
# path at every site (RING_OP_TOL): the gap is the network's amplification
# of float32 reordering, which BN on its running statistics makes larger
# (ring 3.8e-2, moved o 0.20), not smaller.
RING_FP32_BATCH = 1
RING_FP32_TOL = (1e-5, 1e-2)
# The ring op alone in float32 at each kernel-hop site's whole shape, against
# the gather path's B2 + B3 on the same random inputs: relative L2 limits of
# (o, and each of dq, dk, dv).  The ring's hops and merge reorder float32
# sums (on an H100: o 7.6e-7 to 2.2e-6, gradients 7.4e-7 to 6.2e-6); the
# limits are the CPU tests' (1e-5 values, 1e-4 gradients), which B3 in B4's
# place exceeds in dq and dk (2.7e-2 to 9.5e-2).
RING_OP_TOL = (1e-5, 1e-4)


def phase_ring(torch, fa, fb, calibrated, flush, card, profile: bool = False):
    """Phase 9: the flagship's long-clip mode on one card, 4 time shards
    (``make_time_mesh(4, devices=[cuda:0] * 4)``), bf16, the calibrated
    weights of phase 4; with ``profile``, one ring and one gather train step
    are profiled as well."""
    import numpy as np

    from sap3d_tpu_torch.core.mesh import make_time_mesh
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_eval_step, make_train_step

    dev = torch.empty(0, device=DEVICE).device
    mesh = make_time_mesh(RING_SHARDS, devices=[dev] * RING_SHARDS)

    def twin(dtype, ring, dropout_rate=0.0):
        m = build_model("unet++", dtype=dtype, device=DEVICE, seed=SEED,
                        dropout_rate=dropout_rate, ring_mesh=mesh if ring else None)
        m.load_state_dict(calibrated)
        return m

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    x = torch.randn(RING_BATCH, RING_FRAMES, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
    y = torch.rand(RING_BATCH, RING_FRAMES, SIZE, SIZE, device=DEVICE, generator=gen)
    ring, gather = twin("bfloat16", True), twin("bfloat16", False)
    # the kernel hop where the backward gate takes the per-shard shape; B1
    # on the gather path where the forward gate takes the whole site
    kernel_sites = {name: shape for name, shape in RING_SITES.items()
                    if fb.backward_viable(*shape, torch.bfloat16)}
    n_kernel, n_gather = len(kernel_sites), sum(
        fa.forward_viable(nq * RING_SHARDS, nk * RING_SHARDS, d, c, torch.bfloat16)
        for nq, nk, d, c in RING_SITES.values())
    want_fwd = {"B1": 0, "B2": n_kernel * RING_SHARDS, "B3": 0, "B4": 0}
    want_step = {"B1": 0, "B2": 2 * n_kernel * RING_SHARDS, "B3": 0,
                 "B4": n_kernel * RING_SHARDS}
    print(f"[ring] flagship [{RING_BATCH}, {RING_FRAMES}, {SIZE}, {SIZE}, 3] bf16 on "
          f"{RING_SHARDS} time shards of one card; per-shard sites {RING_SITES}; the kernel "
          f"hop at {n_kernel} of them; predicted launches per ring forward {want_fwd}, per "
          f"ring train step {want_step} (forward, checkpoint recompute, backward)", flush=True)
    res = {"predicted": {"forward": want_fwd, "step": want_step}}

    # (a) eval forward: the ring against the gather path (B1 on the whole sites)
    def forward(m, use_kernel=True):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        _zero_launch_counts(fa, fb)
        out = make_eval_step(m)(x)
        torch.cuda.synchronize()
        return out, _launch_counts(fa, fb)

    out_g, n_g = forward(gather)
    out_r, n_r = forward(ring)  # the main path: counts zeroed just before, read just after
    out_p, _ = forward(gather, use_kernel=False)
    with torch.no_grad():
        for sa in gather.attention_modules():
            sa.gamma.zero_()
        no_attn, _ = forward(gather, use_kernel=False)
    gather.load_state_dict(calibrated)
    for sa in gather.attention_modules():
        sa.use_kernel = True
    mean_rg = (out_r - out_g).abs().mean().item()
    mean_pg = (out_p - out_g).abs().mean().item()
    mean_na = (no_attn - out_g).abs().mean().item()
    print(f"[ring] eval forward: launches ring {n_r}, gather {n_g}; mean |ring - gather| "
          f"{mean_rg:.3e} (limit {RING_E2E_MEAN_TOL:g}), plain path - gather {mean_pg:.3e}, no "
          f"attention - gather {mean_na:.3e}; output {tuple(out_r.shape)}", flush=True)
    if n_r != want_fwd or n_g != {"B1": n_gather, "B2": 0, "B3": 0, "B4": 0}:
        raise AssertionError(f"ring forward launches {n_r}, gather {n_g}")
    if not bool(torch.isfinite(out_r).all()) or out_r.shape != (*x.shape[:4],):
        raise AssertionError("ring forward: non-finite output or wrong shape")
    if not mean_rg <= RING_E2E_MEAN_TOL:
        raise AssertionError("ring forward disagrees with the gather path")
    if not mean_na > RING_E2E_MEAN_TOL:
        raise AssertionError("the ring forward's limit passes a model without attention; void")
    res["forward"] = dict(launches=n_r, gather_launches=n_g, ring_vs_gather_mean=mean_rg,
                          plain_vs_gather_mean=mean_pg, no_attention_vs_gather_mean=mean_na)
    del out_g, out_r, out_p, no_attn

    # (b) one ring train step: every B4 call held on the step's own tensors
    calls = []

    def spy_b4(q, k, v, o, lse, do, dlse=None):
        out = fb.flash_backward(q, k, v, o, lse, do, dlse=dlse)
        calls.append((q, k, v, o, lse, do, dlse, out))
        return out

    ring.train()
    ring.zero_grad(set_to_none=True)
    with function_calls(backward=spy_b4):
        loss_fn_saliency(ring(x), y).backward()
    torch.cuda.synchronize()
    ring.zero_grad(set_to_none=True)
    names = {shape: name for name, shape in kernel_sites.items()}
    held = {}
    for i, (q, k, v, o, lse, do, dlse, out) in enumerate(calls):
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        if dlse is None or q.shape[0] != RING_SHARDS * RING_BATCH:
            raise AssertionError(f"a ring hop's backward at {name} ran without dlse or "
                                 f"unstacked (batch {q.shape[0]})")
        held.setdefault(name, []).append(check_b4(
            fb, f"{name} call {len(held.get(name, [])) + 1} bf16 (in the ring train step)",
            q, k, v, o, lse, do, dlse, out))
    del calls
    torch.cuda.empty_cache()
    if sorted(held) != sorted(kernel_sites) or any(len(h) != RING_SHARDS
                                                   for h in held.values()):
        raise AssertionError(f"B4 ran {({n: len(h) for n, h in held.items()})} times by site, "
                             f"not {RING_SHARDS} at each of {sorted(kernel_sites)}")
    res["b4_in_step"] = held

    state = create_train_state(ring, lr=1e-4)
    step = make_train_step(state)
    step_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    _zero_launch_counts(fa, fb)  # the main path: one make_train_step call
    loss = step(x, y, step_gen)
    torch.cuda.synchronize()
    n_step = _launch_counts(fa, fb)
    print(f"[ring] launches in one ring make_train_step call: predicted {want_step}, counted "
          f"{n_step}, loss {loss.item():.4f}", flush=True)
    if n_step != want_step or not np.isfinite(loss.item()):
        raise AssertionError(f"ring train step: launches {n_step}, predicted {want_step}")
    res["launches"] = {"forward": n_r, "step": n_step}

    # fp32 at batch 1: the ring step against the gather step (B2 + B3)
    xs, ys = x[:RING_FP32_BATCH].float(), y[:RING_FP32_BATCH]

    def b3_in_place(q, k, v, o, lse, do, dlse=None):
        return fb.flash_backward(q, k, v, o, lse, do)

    def grads(m, forward=None, backward=None, train=True):
        m.train(train)
        m.zero_grad(set_to_none=True)
        with function_calls(forward=forward, backward=backward):
            loss_ = loss_fn_saliency(m(xs), ys)
            loss_.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        m.load_state_dict(calibrated)  # BN's running statistics as they were
        return loss_.item(), flat

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        op = ring_op_check(torch, fb, mesh)
        # the yardstick of a forward disturbance: the ring op's own relative
        # distance from the gather path's kernels
        eps = max(r["o"] for r in op.values())
        ring32, gather32 = twin("float32", True), twin("float32", False)
        fwd_r, fwd_g = make_eval_step(ring32)(xs), make_eval_step(gather32)(xs)
        b1 = ta.flash_attend_tokens
        ta.flash_attend_tokens = perturbed(torch, b1, eps)
        try:
            fwd_n = make_eval_step(gather32)(xs)
        finally:
            ta.flash_attend_tokens = b1
        for sa in gather32.attention_modules():
            sa.use_kernel = False
        fwd_p = make_eval_step(gather32)(xs)
        with torch.no_grad():
            for sa in gather32.attention_modules():
                sa.gamma.zero_()
        fwd_na = make_eval_step(gather32)(xs)
        gather32.load_state_dict(calibrated)
        for sa in gather32.attention_modules():
            sa.use_kernel = True
        fwd32 = {f"{name}_{stat}": getattr((out - fwd_g).abs(), stat)().item()
                 for name, out in (("ring", fwd_r), ("plain", fwd_p), ("perturbed", fwd_n),
                                   ("no_attention", fwd_na))
                 for stat in ("mean", "max")}
        fwd32["tol_mean"] = RING_FP32_FWD_TOL
        print(f"[ring] eval forward, float32, batch {RING_FP32_BATCH}: |ring - gather| mean "
              f"{fwd32['ring_mean']:.3e} (limit {RING_FP32_FWD_TOL:g}), max "
              f"{fwd32['ring_max']:.3e}; plain path - gather mean {fwd32['plain_mean']:.3e}, "
              f"max {fwd32['plain_max']:.3e}; gather with B1's o moved by {eps:.2e} - gather "
              f"mean {fwd32['perturbed_mean']:.3e}, max {fwd32['perturbed_max']:.3e}; no "
              f"attention - gather mean "
              f"{fwd32['no_attention_mean']:.3e}, max {fwd32['no_attention_max']:.3e}",
              flush=True)
        res["fp32_forward"] = fwd32
        del fwd_r, fwd_g, fwd_n, fwd_p, fwd_na
        loss_g, g_g = grads(gather32)
        _, g_g2 = grads(gather32)
        loss_r, g_r = grads(ring32)
        _, g_f = grads(ring32, backward=b3_in_place)
        # yardsticks: another float32 order of the same sums (the plain
        # path), and the gather path with its B2 outputs moved at random by
        # the ring op's own relative distance from them
        for sa in gather32.attention_modules():
            sa.use_kernel = False
        _, g_p = grads(gather32)
        for sa in gather32.attention_modules():
            sa.use_kernel = True
        _, g_n = grads(gather32, forward=perturbed(torch, fa.flash_forward_lse, eps))
        fp32 = dict(loss_ring=loss_r, loss_gather=loss_g,
                    loss_rel=abs(loss_r - loss_g) / abs(loss_g), grad_rel_l2=rel(g_r, g_g),
                    gather_again=rel(g_g2, g_g), plain_grad_rel_l2=rel(g_p, g_g),
                    perturbed_eps=eps, perturbed_grad_rel_l2=rel(g_n, g_g),
                    fault_grad_rel_l2=rel(g_f, g_g))
        del g_g, g_g2, g_r, g_f, g_p, g_n
        # the same with BN on its running statistics (eval mode; the sites
        # are differentiated, so they route as in training)
        _, g_g = grads(gather32, train=False)
        _, g_g2 = grads(gather32, train=False)
        _, g_r = grads(ring32, train=False)
        _, g_n = grads(gather32, forward=perturbed(torch, fa.flash_forward_lse, eps),
                       train=False)
        fp32.update(bn_running_grad_rel_l2=rel(g_r, g_g), bn_running_gather_again=rel(g_g2, g_g),
                    bn_running_perturbed_grad_rel_l2=rel(g_n, g_g))
        del ring32, gather32, g_g, g_g2, g_r, g_n
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    torch.cuda.empty_cache()
    loss_tol, grad_tol = RING_FP32_TOL
    fp32.update(tol_loss_rel=loss_tol, tol_grad_rel_l2=grad_tol)
    print(f"[ring] one train step, float32, batch {RING_FP32_BATCH}, dropout 0: loss ring "
          f"{loss_r:.6f}, gather {loss_g:.6f} (relative {fp32['loss_rel']:.3e}, limit "
          f"{loss_tol:g}); whole-gradient relative L2 ring against gather "
          f"{fp32['grad_rel_l2']:.3e} (limit {grad_tol:g}), the gather step again "
          f"{fp32['gather_again']:.3e}, the plain path against gather "
          f"{fp32['plain_grad_rel_l2']:.3e}, gather with B2's o moved by {eps:.2e} "
          f"{fp32['perturbed_grad_rel_l2']:.3e}, control (B3 in B4's place) "
          f"{fp32['fault_grad_rel_l2']:.3e}; with BN on its running statistics: ring against "
          f"gather {fp32['bn_running_grad_rel_l2']:.3e}, the gather step again "
          f"{fp32['bn_running_gather_again']:.3e}, gather with o moved "
          f"{fp32['bn_running_perturbed_grad_rel_l2']:.3e}", flush=True)
    res["fp32_step"] = fp32
    res["fp32_op"] = op

    # (c) B4's kernel times beside B3's
    rows = phase_b4(torch, fa, fb, flush)

    # (d) step times: gather, ring, ring, gather (dropout 0.5)
    steps = {}
    for label, m in (("gather", gather), ("ring", ring)):
        m.decoder.dropout_rate = 0.5
        steps[label] = make_train_step(create_train_state(m, lr=1e-4)) if m is gather else step
    thr = {}
    for label in ("gather", "ring", "ring2", "gather2"):
        fn = steps[label.rstrip("2")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = step_times(torch, lambda: fn(x, y, step_gen), THROUGHPUT_CALLS)
        thr[label] = dict(rate_summary(times, RING_BATCH),
                          ms=1e3 * float(np.median(times)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    res["train_clips_per_s"] = thr
    if profile:
        res["profile"] = {label: profile_device_time(
            torch, lambda fn=fn: fn(x, y, step_gen), f"one {label} train step, 64-frame clips",
            RING_BATCH)
            for label, fn in steps.items()}

    def one(r):
        return (f"{r['ms']:.2f} ms, {r['clips_per_s']:.2f} [{r['slowest']:.2f}, "
                f"{r['fastest']:.2f}] clips/s, peak {r['peak_gib']:.2f} GiB")
    print(f"[ring] train step, {RING_FRAMES}-frame clips, batch {RING_BATCH}, bf16, dropout "
          f"0.5 (median [slowest, fastest] of {THROUGHPUT_CALLS} steps each, order gather, "
          f"ring, ring, gather): gather {one(thr['gather'])}; ring {one(thr['ring'])}; ring "
          f"{one(thr['ring2'])}; gather {one(thr['gather2'])}  [{card}]", flush=True)
    del steps, step, state, ring, gather
    torch.cuda.empty_cache()
    # (a)'s and (b)'s fp32 limits, held after the phase's other readings are taken
    if not fwd32["ring_mean"] <= RING_FP32_FWD_TOL:
        raise AssertionError("ring forward, float32: the ring disagrees with the gather path")
    if not fwd32["no_attention_mean"] > RING_FP32_FWD_TOL:
        raise AssertionError("the ring's float32 forward limit passes no attention; void")
    if not (fp32["loss_rel"] <= loss_tol and fp32["grad_rel_l2"] <= grad_tol):
        raise AssertionError("ring train step, float32: the ring disagrees with the gather path")
    if not fp32["fault_grad_rel_l2"] > grad_tol:
        raise AssertionError("the ring train-step limit passes B3 in B4's place; void")
    for site, r in op.items():
        if not all(r[out] <= tol for out, tol in zip(("o", "dq", "dk", "dv"), RING_OP_TOL)):
            raise AssertionError(f"the ring op at {site}, float32, disagrees with the gather path")
        if not min(r["fault_dq"], r["fault_dk"]) > RING_OP_TOL[1]:
            raise AssertionError(f"the ring op's limit at {site} passes B3 in B4's place; void")
    return res, rows


def perturbed(torch, forward, eps):
    """``forward`` (B1, or B2 and its lse) with o moved by a relative ``eps``
    at random (o (1 + eps z), z ~ N(0, 1) from a fixed seed): a forward
    disturbance of a given size at the gather path's sites, the yardstick
    for the ring's."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)

    def moved(q, k, v):
        out = forward(q, k, v)
        o = out[0] if isinstance(out, tuple) else out
        z = torch.randn(o.shape, device=o.device, generator=gen, dtype=torch.float32)
        o = (o.float() * (1 + eps * z)).to(o.dtype)
        return (o,) + out[1:] if isinstance(out, tuple) else o
    return moved


def ring_op_check(torch, fb, mesh):
    """The ring op alone at each kernel-hop site's whole shape (batch 1,
    float32, random inputs and cotangent): o, dq, dk and dv of
    ``ring_attend_sharded`` on ``mesh`` against the gather path's Function
    (``flash_attend``: B2 + B3), as relative L2 distances; the control runs
    the ring with B3 in B4's place (the merge's lse cotangent dropped)."""
    from sap3d_tpu_torch.ops.attention import flash_attend
    from sap3d_tpu_torch.ops.ring_attention import ring_attend_sharded

    def b3_in_place(q, k, v, o, lse, do, dlse=None):
        return fb.flash_backward(q, k, v, o, lse, do)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    res = {}
    for site, (nq, nk, d, c) in RING_SITES.items():
        if not fb.backward_viable(nq, nk, d, c, torch.float32):
            continue
        nq, nk = nq * RING_SHARDS, nk * RING_SHARDS
        q = (torch.randn(1, nq, d, device=DEVICE, generator=gen) * d ** -0.25).requires_grad_()
        k = (torch.randn(1, nk, d, device=DEVICE, generator=gen) * d ** -0.25).requires_grad_()
        v = torch.randn(1, nk, c, device=DEVICE, generator=gen).requires_grad_()
        do = torch.randn(1, nq, c, device=DEVICE, generator=gen)

        def run(fn, backward=None):
            with function_calls(backward=backward):
                out = fn(q, k, v)
                return (out.detach(),) + torch.autograd.grad(out, (q, k, v), do)

        def ring(*a):
            return ring_attend_sharded(mesh, *a)

        want, got, fault = run(flash_attend), run(ring), run(ring, b3_in_place)
        r = {out: rel(g, w) for out, g, w in zip(("o", "dq", "dk", "dv"), got, want)}
        r.update(fault_dq=rel(fault[1], want[1]), fault_dk=rel(fault[2], want[2]))
        print(f"[ring] the ring op alone at {site} (whole site {(nq, nk, d, c)}, batch 1, "
              f"float32), relative L2 against the gather path: o {r['o']:.3e} (limit "
              f"{RING_OP_TOL[0]:g}), dq {r['dq']:.3e}, dk {r['dk']:.3e}, dv {r['dv']:.3e} "
              f"(limit {RING_OP_TOL[1]:g}); control (B3 in B4's place) dq {r['fault_dq']:.3e}, "
              f"dk {r['fault_dk']:.3e}", flush=True)
        res[site] = r
        del q, k, v, do, want, got, fault
    return res


# ---- phase 10: the inference bisect and kernel B6 ----------------------------


def check_b6(fa, nolse, label, q, k, v, got):
    """B6's output against its plain version under ``nolse.TOLERANCE``, the
    last key tile dropped failing; B1 on the same inputs read against the
    same plain version (the TPU kernel's rounding point) beside it."""
    import torch

    want = nolse.flash_nolse_reference(q, k, v)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    res = hold(f"B6 {label}", got, want, nolse.flash_nolse_reference(q, k[:, :keep], v[:, :keep]),
               _DROPPED, nolse.TOLERANCE)
    b1 = fa.agreement(fa.flash_attend_tokens(q, k, v), want, nolse.TOLERANCE)
    print(f"[check] B1 on the same inputs against B6's plain version: max_abs_err "
          f"{b1['max_abs_err']:.3e}, mean {b1['mean_abs_err']:.3e}, excess under B6's limits "
          f"{b1['excess']:.3f}", flush=True)
    res.update(b1_max_abs_err=b1["max_abs_err"], b1_mean_abs_err=b1["mean_abs_err"],
               b1_excess=b1["excess"])
    if q.dtype == torch.bfloat16 and not res["mean_abs_err"] <= res["b1_mean_abs_err"]:
        raise AssertionError(f"B6 {label}: its mean error exceeds B1's; it does not round "
                             "where the TPU kernel rounds")
    return res


def phase_b6(torch, fa, nolse, flush):
    """Phase 10(a): B6 at the flagship's sites on random inputs, bf16 and
    fp32, against its plain version, with B1's errors and time on the same
    inputs beside it."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in SITES.items():
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            got = nolse.flash_nolse(q, k, v)
            row = dict(check_b6(fa, nolse, f"{site} {dname} (random inputs)", q, k, v, got),
                       site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            del got
            heavy = nq * nk * (d + c) > 5e9
            iters = (3 if dtype == torch.float32 else 5) if heavy else 20
            row["ms"] = time_ms(lambda: nolse.flash_nolse(q, k, v), iters, flush)
            row["b1_ms"] = time_ms(lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: nolse.flash_nolse_reference(q, k, v),
                                      max(iters // 4, 3), flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush)
            # B1's function: the second QK^T pass is this kernel's design,
            # not work the function needs, and is not counted
            row["bound_ms"], row["bound_by"] = flash_bound(BATCH, nq, nk, d, c, dname,
                                                           q.element_size())
            print(f"[kernel] B6 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: kernel "
                  f"{row['ms']:.4f} ms, B1 on the same inputs {row['b1_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']} ms "
                  f"({row['library_backend']}), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
            rows.append(row)
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def phase_bisect(torch, fa, nolse, ta, card):
    """Phase 10(b): the bisect (``scripts/bisect_infer.main``) at full width,
    batch 16: its four readings and each variant's launches per forward
    (current 3 B1, swapped 3 B6, B1 again after the swap, plain none); then
    every B6 call of one swapped forward held on the model's own tensors,
    with B1 on them beside it."""
    from sap3d_tpu_torch.scripts import bisect_infer
    from sap3d_tpu_torch.train.steps import make_eval_step

    res = bisect_infer.main(DEVICE, BATCH)
    n = len(SITES)
    want = {"current": {"B1": n, "B6": 0}, "nolse": {"B1": 0, "B6": n},
            "after": {"B1": n, "B6": 0}, "plain": {"B1": 0, "B6": 0}}
    print(f"[bisect] {card}: launches per forward {res['launches']} (want {want})", flush=True)
    if res["launches"] != want:
        raise AssertionError("the bisect's forwards did not launch the kernels of their route")
    model, frames = bisect_infer.flagship(BATCH, DEVICE)
    calls = []

    def spy(q, k, v):
        o = nolse.flash_nolse(q, k, v)
        calls.append((q, k, v, o))
        return o

    with ta.forward_kernel(spy):
        make_eval_step(model)(frames)
    torch.cuda.synchronize()
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    held = {}
    for q, k, v, o in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        held[name] = check_b6(fa, nolse, f"{name} bf16 (in the bisect's swapped forward)",
                              q, k, v, o)
    if sorted(held) != sorted(SITES):
        raise AssertionError(f"the swapped forward reached B6 at {sorted(held)}")
    del calls, model, frames
    torch.cuda.empty_cache()
    return dict(res, held=held)


# ---- phase 11: the evaluator on the card, without files or cv2 --------------


EVAL_BATCHES = 3   # batches of 4 clips through evaluate_prediction_batches
EVAL_CLIPS = 4
# The five means of the kernel path against the plain path: |difference| <=
# EVAL_MEAN_TOL * max(1, |plain value|).  fp32, where B1 and the plain path
# differ by float32 reordering (~1e-6 of an attention output) and phase 4
# holds the whole forward to 1e-3; the ground truth is made from the plain
# path's own maps, so the metrics sit near their best values and a small
# change of the maps moves them.  The forward without attention must exceed
# it.
EVAL_MEAN_TOL = 1e-3
# The batched device metrics against the NumPy oracle on the same maps: cc,
# sim and nss to 1e-4 (float32 against float64 sums); AUC-Judd to 1e-3 (its
# tie-breaking jitter is 1e-4 on the device and 1e-7 on the host, which
# moves a fixation's rank among 10^6 pixels spread over [0, 1] by about
# 1e-4 of them); the sampled AUCs (AUC-Borji, shuffled) draw other
# negatives, 100 repetitions of n_fix draws each: their Monte-Carlo spread
# per map is about 0.3 / sqrt(100 n_fix), 2.4e-3 at the 150 fixations
# drawn here, held to 0.02.
METRIC_TOL = {"cc": 1e-4, "sim": 1e-4, "nss": 1e-4, "auc_judd": 1e-3,
              "auc_borji": 0.02, "auc_shuffled": 0.02}


def eval_truth(torch, maps, gen):
    """Densities and fixations at (1080, 960) made from ``maps`` [B, T, 112,
    112] (the plain path's own last frames): the bilinear resize plus noise,
    and the top 0.02% of each density's pixels as fixations."""
    from sap3d_tpu_torch.eval.evaluator import resize_bilinear

    b, t = maps.shape[:2]
    dens = resize_bilinear(maps.reshape(b * t, *maps.shape[2:]), (960, 1080))
    dens = (dens + 0.05 * torch.rand(dens.shape, device=DEVICE, generator=gen)).clamp(0, 1)
    cut = torch.quantile(dens[:, ::8, ::8].reshape(b * t, -1), 0.9998, dim=1)
    fix = (dens >= cut[:, None, None]).float()
    shape = (b, t, 1080, 960)
    return dens.reshape(shape).cpu().numpy(), fix.reshape(shape).cpu().numpy()


def phase_eval(torch, fa, calibrated, card):
    """Phase 11: (a) ``evaluate_prediction_batches`` with the calibrated
    flagship in fp32 (``cli eval``'s dtype) on in-memory batches: B1
    launches, the five means against the plain path's run and the forward
    without attention as the control, scored clips per second; (b) the
    batched device metrics (``score_density``, ``score_fixations``) on a
    [32, 1080, 960] stack against the NumPy oracle, frames per second of
    both."""
    import numpy as np

    from sap3d_tpu_torch.eval import metrics_np as M
    from sap3d_tpu_torch.eval.evaluator import (
        evaluate_prediction_batches,
        score_density,
        score_fixations,
    )
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    model = build_model("unet++", dtype="float32", device=DEVICE, seed=SEED)
    model.load_state_dict(calibrated)
    ev = make_eval_step(model)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    frames = [torch.randn(EVAL_CLIPS, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
              for _ in range(EVAL_BATCHES)]
    for sa in model.attention_modules():
        sa.use_kernel = False
    truth = [eval_truth(torch, ev(f)[:, -1:], gen) for f in frames]
    batches = [(f.cpu().numpy(), np.broadcast_to(d, (EVAL_CLIPS, 16, *d.shape[2:])),
                np.broadcast_to(x, (EVAL_CLIPS, 16, *x.shape[2:])))
               for f, (d, x) in zip(frames, truth)]

    def run(use_kernel):
        for sa in model.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        t0 = time.perf_counter()
        out = evaluate_prediction_batches(
            batches, lambda f: ev(torch.from_numpy(f).to(DEVICE)),
            rng=np.random.default_rng(SEED))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fa.flash_attend_tokens.launches

    plain, plain_s, plain_launches = run(False)
    kern, kern_s, launches = run(True)
    gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.zero_()
    no_attn, _, _ = run(False)
    del model, ev, frames, batches, truth
    torch.cuda.empty_cache()
    names = ("cc", "sim", "nss", "auc_judd", "auc_borji")
    diff = {m: abs(kern[m] - plain[m]) / max(1.0, abs(plain[m])) for m in names}
    control = {m: abs(no_attn[m] - plain[m]) / max(1.0, abs(plain[m])) for m in names}
    n_clips = EVAL_BATCHES * EVAL_CLIPS
    print(f"[eval] evaluate_prediction_batches, flagship fp32, {n_clips} clips scored at "
          f"(1080, 960): kernel path {kern}, plain path {plain}; B1 launches {launches} "
          f"(plain path {plain_launches}); scaled |kernel - plain| "
          f"{ {m: f'{v:.2e}' for m, v in diff.items()} } (limit {EVAL_MEAN_TOL:g}); no "
          f"attention {no_attn}; {n_clips / kern_s:.2f} clips/s scored (plain path "
          f"{n_clips / plain_s:.2f})  [{card}]", flush=True)
    if launches != EVAL_BATCHES * len(SITES) or plain_launches:
        raise AssertionError(f"evaluate_prediction_batches launched B1 {launches} times")
    if not all(v <= EVAL_MEAN_TOL for v in diff.values()):
        raise AssertionError("evaluation: the kernel path's means disagree with the plain path's")
    if not max(control.values()) > EVAL_MEAN_TOL:
        raise AssertionError("evaluation: the limit passes the forward without attention; void")
    res = dict(kernel=kern, plain=plain, no_attention=no_attn, scaled_diff=diff,
               clips_per_s=n_clips / kern_s, plain_clips_per_s=n_clips / plain_s,
               b1_launches=launches)

    # (b) the batched device metrics against the NumPy oracle
    rng = np.random.default_rng(SEED + 15)
    n, h, w = 32, 1080, 960
    lo = rng.random((n, h // 40, w // 40))
    pred = torch.nn.functional.interpolate(torch.from_numpy(lo)[:, None], size=(h, w),
                                           mode="bilinear")[:, 0].numpy().astype(np.float32)
    pred += 0.01 * rng.random(pred.shape, dtype=np.float32)
    gt = np.clip(pred + 0.3 * rng.random(pred.shape, dtype=np.float32), 0, None)
    fix = np.zeros((n, h, w), np.float32)
    for i in range(n):
        fix[i].flat[rng.choice(h * w, 150, replace=False)] = 1.0
    other = np.zeros((h, w), bool)
    other.flat[rng.choice(h * w, 3000, replace=False)] = True
    pool = np.flatnonzero(other)
    dev_metrics = ("cc", "sim", "nss", "auc_judd", "auc_borji", "auc_shuffled")
    generator = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = score_density(dev_metrics, pred, gt, DEVICE)
    got.update(score_fixations(dev_metrics, pred, fix, np.ones(n, bool), generator, rng,
                               DEVICE, pool=pool))
    dev_s = time.perf_counter() - t0
    host_rng = np.random.default_rng(SEED + 17)
    t0 = time.perf_counter()
    want = {"cc": [M.CC(p, g) for p, g in zip(pred, gt)],
            "sim": [M.SIM(p, g) for p, g in zip(pred, gt)],
            "nss": [M.NSS(p, f) for p, f in zip(pred, fix)],
            "auc_judd": [M.AUC_Judd(p, f, rng=host_rng) for p, f in zip(pred, fix)],
            "auc_borji": [M.AUC_Borji(p, f, rng=host_rng) for p, f in zip(pred, fix)],
            "auc_shuffled": [M.AUC_shuffled(p, f, other, rng=host_rng)
                             for p, f in zip(pred, fix)]}
    host_s = time.perf_counter() - t0
    err = {m: float(np.max(np.abs(np.asarray(got[m]) - np.asarray(want[m])))) for m in want}
    print(f"[eval] device metrics on [{n}, {h}, {w}] against the NumPy oracle, largest "
          f"|difference| per metric {({m: f'{v:.2e}' for m, v in err.items()})} (limits "
          f"{METRIC_TOL}); {n / dev_s:.2f} frames/s on the device, {n / host_s:.2f} frames/s "
          f"on the host  [{card}]", flush=True)
    if not all(err[m] <= METRIC_TOL[m] for m in want):
        raise AssertionError("the device metrics disagree with the NumPy oracle")
    return dict(res, metric_err=err, device_frames_per_s=n / dev_s,
                host_frames_per_s=n / host_s)


def kernel_entry(name, source, replaces, launches, rows, extra_err=(), more_rows=()):
    """One kernel's entry of the JSON line: times summed over the bf16 site
    calls of ``rows`` (one batch-16 step of the model whose sites they are);
    bound_by is the term that holds most of the summed bound.  ``more_rows``
    (the same kernel at another model's sites) count towards max_abs_err."""
    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
    total = {key: sum(r[key] for r in main_rows) for key in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in main_rows]
    t_ops = sum(r["bound_ms"] for r in main_rows if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": f"sap3d_tpu_torch/csrc/{source}.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in list(rows) + list(more_rows)]
                           + list(extra_err)),
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "operations" if t_ops >= total["bound_ms"] / 2 else "bytes",
        "library_ms": None if None in lib else sum(lib),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json-out", default=None,
                   help="also profile one forward and one train step by layer and "
                        "write the details here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"[card] {card}", flush=True)
        # float32 references in full float32: no TF32 in products or in cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        from concurrent.futures import ThreadPoolExecutor

        from sap3d_tpu_torch.models.registry import build_model
        from sap3d_tpu_torch.ops import attention as ta
        from sap3d_tpu_torch.ops.cuda import build
        from sap3d_tpu_torch.ops.cuda import flash_attention as fa
        from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
        from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse

        def timed_build(source):
            t0 = time.perf_counter()
            return build.build(source), time.perf_counter() - t0

        sources = (fa.SOURCE, fb.SOURCE, nolse.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
            builds = dict(zip(sources, pool.map(timed_build, sources)))
        for source, (log, secs) in builds.items():
            print(f"[build] {source}.cu built in {secs:.2f} s", flush=True)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build]   {line.strip()}", flush=True)

        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
        rows = phase_kernels(torch, fa, fb, flush)

        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        model = build_model("unet++", dtype="bfloat16", device=DEVICE, seed=SEED)
        x = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
        calibrate_and_randomize_bn(torch, model, x, gen)
        calibrated = {k: v.detach().clone() for k, v in model.state_dict().items()}
        fwd = phase_forward(torch, fa, model, x)
        thr = phase_throughput(torch, model, x, card)
        prof = phase_profile(torch, model, x) if args.json_out else None
        launches = phase_predictor(torch, fa, model)
        del x
        train = phase_train(torch, fa, fb, model, card, profile=bool(args.json_out))
        del model
        torch.cuda.empty_cache()

        gn_model = build_gn_model(torch, "bfloat16", gen=gen)
        x = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
        gn_fwd = phase_gn_forward(torch, fa, gn_model, x, card)
        gn_prof = None
        if args.json_out:
            from sap3d_tpu_torch.train.steps import make_eval_step

            gn_prof = profile_device_time(torch, lambda: make_eval_step(gn_model)(x),
                                          "one GN kernel-path forward")
        del x
        gn_sites = {name: tuple(site["shape"]) for name, site in gn_fwd["sites"].items()}
        gn_rows = phase_kernels(torch, fa, fb, flush, gn_sites)
        b5_rows, b5_memory = phase_b5(torch, fa, fb, ta, flush, gn_sites)
        gn_launches = phase_gn_predictor(torch, fa, gn_model)
        gn_train = phase_gn_train(torch, fa, fb, ta, gn_model,
                                  {n: (tuple(s_["shape"]), s_["route"])
                                   for n, s_ in gn_fwd["sites"].items()},
                                  card, profile=bool(args.json_out))
        del gn_model
        torch.cuda.empty_cache()
        zoo, zoo_sites = phase_zoo(torch, fa, set(SITES.values()) | set(gn_sites.values()))
        # B1, B2 and B3 at the sites no earlier phase measured (the 'full'
        # head's x_0_1_sa), at the zoo's batch of 2
        print(f"[zoo] sites of at least {fa.BLOCK_Q} queries no earlier phase measured: "
              f"{zoo_sites}", flush=True)
        if "x_0_1_sa" not in zoo_sites:
            raise AssertionError("the 'full' head's x_0_1_sa did not reach a kernel")
        zoo_rows = phase_kernels(torch, fa, fb, flush, zoo_sites, batch=2)
        if not all(len(zoo_rows[n]) == 2 * len(zoo_sites) for n in ("B1", "B2", "B3")):
            raise AssertionError("B1, B2 and B3 were not all held at the zoo's new sites")

        ring, b4_rows = phase_ring(torch, fa, fb, calibrated, flush, card,
                                   profile=bool(args.json_out))
        torch.cuda.empty_cache()
        b6_rows = phase_b6(torch, fa, nolse, flush)
        bisect = phase_bisect(torch, fa, nolse, ta, card)
        evaluation = phase_eval(torch, fa, calibrated, card)
        del calibrated
        torch.cuda.empty_cache()

        fit, gn_fit = train["fit"]["launches"], gn_train["fit"]["launches"]
        ring_fwd, ring_step = ring["launches"]["forward"], ring["launches"]["step"]
        b6_launches = bisect["launches"]["nolse"]["B6"]
        # every main path launched every kernel the gate gives it
        if not (launches > 0 and fit["B2"] > 0 and fit["B3"] > 0 and gn_launches > 0
                and gn_fit["B2"] > 0 and gn_fit["B3"] > 0 and gn_fit["B5"] > 0
                and ring_fwd["B2"] > 0 and ring_step["B2"] > 0 and ring_step["B4"] > 0
                and b6_launches > 0 and evaluation["b1_launches"] > 0):
            raise AssertionError("a kernel of a main path was never launched")
        print(f"[launches] flagship predictor B1 {launches}; flagship Trainer.fit {fit}; GN "
              f"predictor B1 {gn_launches}; GN Trainer.fit (hybrid on) {gn_fit}; ring eval "
              f"forward {ring_fwd}; ring train step {ring_step}; the bisect's swapped forward "
              f"{bisect['launches']['nolse']}; evaluate_prediction_batches B1 "
              f"{evaluation['b1_launches']}", flush=True)
        in_step = {k: [r["max_abs_err"] for r in train[f"{k}_in_step"].values()]
                   for k in ("b2", "b3")}
        kernels = [
            # B1 to B3: times at the flagship's sites, as in earlier runs;
            # launches summed over the flagship's and the GN model's main paths
            kernel_entry("flash_attention_fwd", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141",
                         launches + gn_launches + evaluation["b1_launches"],
                         rows["B1"], [r["max_abs_err"] for r in gn_fwd["held"].values()],
                         gn_rows["B1"] + zoo_rows["B1"]),
            kernel_entry("flash_attention_fwd_lse", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141",
                         fit["B2"] + gn_fit["B2"] + ring_fwd["B2"] + ring_step["B2"],
                         rows["B2"], in_step["b2"], gn_rows["B2"] + zoo_rows["B2"]),
            kernel_entry("flash_attention_bwd", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274", fit["B3"] + gn_fit["B3"],
                         rows["B3"], in_step["b3"], gn_rows["B3"] + zoo_rows["B3"]),
            # B4: the ring train step's backward, times at the per-shard shapes
            kernel_entry("flash_attention_bwd_lse", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274", ring_step["B4"],
                         b4_rows, [r["max_abs_err"] for by_site in ring["b4_in_step"].values()
                                   for r in by_site]),
            # B5: forward + backward at the three GN sites
            kernel_entry("flash_fwd_chunked_bwd", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:373", gn_fit["B5"], b5_rows,
                         [r["max_abs_err"] for by_site in gn_train["b5_in_step"].values()
                          for r in by_site.values()]),
            # B6: the bisect's swapped forward, times at the flagship's sites
            kernel_entry("flash_attention_nolse", nolse.SOURCE, "scripts/bisect_infer.py:96",
                         b6_launches, b6_rows,
                         [r["max_abs_err"] for r in bisect["held"].values()]),
        ]
        if args.json_out:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(dict(card=card, kernel_rows=rows, forward=fwd, clips_per_s=thr,
                               profile=prof, train=train, gn_forward=gn_fwd,
                               gn_profile=gn_prof, gn_kernel_rows=gn_rows, b5_rows=b5_rows,
                               b5_memory=b5_memory, gn_train=gn_train, zoo=zoo,
                               zoo_kernel_rows=zoo_rows, ring=ring, b4_rows=b4_rows,
                               b6_rows=b6_rows, bisect=bisect, evaluation=evaluation,
                               kernels=kernels), f, indent=1)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
