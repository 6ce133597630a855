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
     3 launches per forward, clips/s of both (median of 20); with
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
     median, slowest and fastest of 20 steps each) and peak device
     memory; with --json-out, a torch.profiler breakdown of one kernel-path
     train step;
  7. a JSON line of per-kernel numbers, then the result line
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
TRAIN_STEPS = 3
THROUGHPUT_CALLS = 20              # timed calls per path and round of clips/s


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


def check_b1(fa, label, q, k, v, got):
    """B1's output on (q, k, v) against its plain version."""
    return hold(f"B1 {label}", got, fa.flash_attend_tokens_reference(q, k, v),
                drop_last_key_tile(fa, q, k, v), _DROPPED, fa.TOLERANCE)


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


def phase_kernels(torch, fa, fb, flush):
    """Phase 3: B1, B2 and B3 against their plain versions at the flagship
    shapes, with their times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {"B1": [], "B2": [], "B3": []}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in SITES.items():
            # q, k with std d^-1/4: unit-variance scores, a soft softmax
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
            shape = dict(site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            label = f"{site} {dname} (random inputs)"
            iters = (3 if dtype == torch.float32 else 5) if site == "x_1_3" else 20
            plain_iters = max(iters // 4, 3)

            got = fa.flash_attend_tokens(q, k, v)
            check = check_b1(fa, label, q, k, v, got)
            del got
            row = dict(check, **shape)
            row["ms"] = time_ms(lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: fa.flash_attend_tokens_reference(q, k, v),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush)
            row["bound_ms"], row["bound_by"] = flash_bound(BATCH, nq, nk, d, c, dname,
                                                           q.element_size())
            rows["B1"].append(row)

            o, lse = fa.flash_forward_lse(q, k, v)
            row = dict(check_b2(fa, label, q, k, v, o, lse), **shape)
            row["ms"] = time_ms(lambda: fa.flash_forward_lse(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: fa.flash_forward_lse_reference(q, k, v),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = rows["B1"][-1]["library_ms"], \
                rows["B1"][-1]["library_backend"]
            row["bound_ms"], row["bound_by"] = flash_bound(BATCH, nq, nk, d, c, dname,
                                                           q.element_size(), lse=True)
            rows["B2"].append(row)

            got = fb.flash_backward(q, k, v, o, lse, do)
            row = dict(check_b3(fb, label, q, k, v, o, lse, do, got), **shape)
            del got
            row["ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do), iters, flush)
            row["plain_ms"] = time_ms(lambda: fb.flash_backward_reference(q, k, v, o, lse, do),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush, do=do)
            row["bound_ms"], row["bound_by"] = flash_bwd_bound(BATCH, nq, nk, d, c, dname,
                                                               q.element_size())
            rows["B3"].append(row)
            for name in ("B1", "B2", "B3"):
                r = rows[name][-1]
                lib = r["library_ms"]
                print(f"[kernel] {name} {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: "
                      f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                      f"sdpa {lib if lib is None else f'{lib:.4f}'} ms "
                      f"({r['library_backend']}), bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']})", flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return rows


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


@contextlib.contextmanager
def attention_call(replacement):
    """Route the model's kernel-path attention calls through
    ``replacement(q, k, v)`` for the duration."""
    from sap3d_tpu_torch.ops import attention

    orig = attention.flash_attend_tokens
    attention.flash_attend_tokens = replacement
    try:
        yield
    finally:
        attention.flash_attend_tokens = orig


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

    with attention_call(spy):
        kern16 = run(model, True)
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    sites = {}
    for q, k, v, o in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        sites[name] = check_b1(fa, f"{name} bf16 (in the flagship forward)", q, k, v, o)
    del calls
    with attention_call(lambda q, k, v: drop_last_key_tile(fa, q, k, v)):
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
    ("B3 flash_attention_bwd", ("flash_bwd", "bwd_delta", "round_to_bf16")),
    ("B1/B2 flash_attention_fwd", ("flash_fwd",)),
    ("convolution (cuDNN, with its layout transforms)",
     ("conv", "cudnn", "xmma", "implicit_gemm", "dgrad", "wgrad", "cutlass")),
    ("attention plain path at x_4_0 (bmm, softmax)", ("softmax", "gemm", "bmm")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("pooling", ("pool",)),
    ("optimizer (Adam)", ("multi_tensor", "adam")),
    ("copy / cast / pad / cat", ("copy", "pad", "cat", "transpose", "index")),
    ("other elementwise (relu, add, sigmoid, ...)", ("elementwise", "vectorized", "unrolled")),
)


def profile_device_time(torch, fn, label: str):
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
    print(f"[profile] {label} (batch {BATCH}, bf16): device busy {device_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share {max(0.0, 1 - device_ms / wall_ms):.3f})",
          flush=True)
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
            "B3": fb.flash_backward.launches}


def _zero_launch_counts(fa, fb) -> None:
    fa.flash_attend_tokens.launches = 0
    fa.flash_forward_lse.launches = 0
    fb.flash_backward.launches = 0


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


def rate_summary(times: list[float]) -> dict:
    """clips/s from the median, fastest and slowest call of ``times``."""
    import statistics

    return dict(clips_per_s=BATCH / statistics.median(times), fastest=BATCH / min(times),
                slowest=BATCH / max(times), calls=len(times))


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
                "B3": len(SITES) if use_kernel else 0}
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
                "B3": len(SITES) * TRAIN_STEPS}
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


def kernel_entry(name, source, replaces, launches, rows, extra_err=()):
    """One kernel's entry of the JSON line: times summed over the three bf16
    site calls of one batch-16 step; bound_by is the term that holds most
    of the summed bound."""
    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
    total = {key: sum(r[key] for r in main_rows) for key in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in main_rows]
    t_ops = sum(r["bound_ms"] for r in main_rows if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": f"sap3d_tpu_torch/csrc/{source}.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in rows] + list(extra_err)),
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

        from concurrent.futures import ThreadPoolExecutor

        from sap3d_tpu_torch.models.registry import build_model
        from sap3d_tpu_torch.ops.cuda import build
        from sap3d_tpu_torch.ops.cuda import flash_attention as fa
        from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

        def timed_build(source):
            t0 = time.perf_counter()
            return build.build(source), time.perf_counter() - t0

        with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
            builds = dict(zip((fa.SOURCE, fb.SOURCE), pool.map(timed_build,
                                                              (fa.SOURCE, fb.SOURCE))))
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
        fwd = phase_forward(torch, fa, model, x)
        thr = phase_throughput(torch, model, x, card)
        prof = phase_profile(torch, model, x) if args.json_out else None
        launches = phase_predictor(torch, fa, model)
        del x
        train = phase_train(torch, fa, fb, model, card, profile=bool(args.json_out))

        fit = train["fit"]["launches"]
        if not (launches > 0 and fit["B2"] > 0 and fit["B3"] > 0):
            raise AssertionError("a kernel of a main path was never launched")
        in_step = {k: [r["max_abs_err"] for r in train[f"{k}_in_step"].values()]
                   for k in ("b2", "b3")}
        kernels = [
            kernel_entry("flash_attention_fwd", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141", launches, rows["B1"]),
            kernel_entry("flash_attention_fwd_lse", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141", fit["B2"], rows["B2"],
                         in_step["b2"]),
            kernel_entry("flash_attention_bwd", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274", fit["B3"], rows["B3"],
                         in_step["b3"]),
        ]
        if args.json_out:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(dict(card=card, kernel_rows=rows, forward=fwd, clips_per_s=thr,
                               profile=prof, train=train, kernels=kernels), f, indent=1)
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
