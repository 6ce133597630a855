#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases (each prints its lines; any failure exits non-zero and prints no
result line):
  1. card: name and power limit from nvidia-smi;
  2. kernel build: the port's CUDA source; build time and ptxas
     register/spill report;
  3. kernel against its plain version: the flash forward (kernel B1) at the
     three flagship self-attention sites (batch 16), bf16 and fp32, under
     the kernel's limits (flash_attention.TOLERANCE), which a planted fault
     (the last key tile dropped) must fail; with the kernel's, the plain
     version's and scaled_dot_product_attention's times (the last is a
     yardstick only; the port never calls it);
  4. full-width forward: the flagship (p3d_unetplusplus_ds) on
     [16, 16, 112, 112, 3] bf16, seeded weights, gamma nonzero and random BN
     statistics; each kernel call held against its plain version on the
     tensors the model gave it, the kernel path against the plain path end
     to end, 3 launches per forward, clips/s of both; with --json-out, a
     torch.profiler breakdown of one kernel-path forward by layer (kernels
     grouped by name);
  5. predictor (the main path): SlidingWindowPredictor.predict_video on a
     40-frame synthetic video; launch counts are zeroed just before and read
     just after;
  6. a JSON line of per-kernel numbers, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs torch with CUDA and nvcc; imports nothing of JAX or ``sap3d_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
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
DEVICE = "cuda"
KEY_TILE = 64                      # keys per streamed tile in both B1 kernels
# Mean |kernel path - plain path| of the bf16 flagship's sigmoid output.
# The two paths differ by bf16 rounding inside attention, which the random
# 47-block network amplifies (about 3e-3 on an H100, PERF.md).  The forward
# without attention must exceed this limit for the check to count.
E2E_MEAN_TOL = 1e-2


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


def flash_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by): each input read once and the output written
    once over HBM bandwidth, against 2*b*nq*nk*(d+c) FLOPs over the peak."""
    nbytes = b * (nq * d + nk * d + nk * c + nq * c) * itemsize
    flops = 2 * b * nq * nk * (d + c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(q, k, v, flush):
    """Time of one scaled_dot_product_attention call (scale=1.0) on the same
    inputs, with the first backend that accepts d != C."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1)
    warnings.filterwarnings("ignore", message=".*(kernel not used|attention has been "
                            "runtime disabled|Flash attention requires).*")
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return time_ms(call, 3, flush), backend.name
    return None, "none"


def drop_last_key_tile(fa, q, k, v):
    """A planted fault: what a kernel that skipped its last tile of
    ``KEY_TILE`` keys would return (the plain version on the other keys)."""
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    return fa.flash_attend_tokens_reference(q, k[:, :keep], v[:, :keep])


def check_b1(fa, label, q, k, v, got):
    """Hold B1's output on (q, k, v) against its plain version under
    ``fa.TOLERANCE``, and show that the limits fail the planted fault."""
    want = fa.flash_attend_tokens_reference(q, k, v)
    sound = fa.agreement(got, want)
    fault = fa.agreement(drop_last_key_tile(fa, q, k, v), want)
    rtol, atol, mean_tol = fa.TOLERANCE[want.dtype]
    print(f"[check] B1 {label}: max_abs_err {sound['max_abs_err']:.3e}, mean "
          f"{sound['mean_abs_err']:.3e}, excess {sound['excess']:.3f} (limits: "
          f"{rtol:g}*|want| + {atol:g}*max|want| per element, {mean_tol:g}*mean|want| "
          f"mean); planted fault (last {KEY_TILE}-key tile dropped): max_abs_err "
          f"{fault['max_abs_err']:.3e}, mean {fault['mean_abs_err']:.3e}, excess "
          f"{fault['excess']:.3f}", flush=True)
    if not sound["finite"] or not sound["excess"] <= 1:
        raise AssertionError(f"B1 disagrees with its plain version at {label}")
    if not fault["excess"] > 1:
        raise AssertionError(f"the limits pass the planted fault at {label}; the check is void")
    return dict(sound, fault_excess=fault["excess"], fault_max_abs_err=fault["max_abs_err"],
                fault_mean_abs_err=fault["mean_abs_err"])


def phase_kernels(torch, fa, flush):
    """Phase 3: B1 against its plain version at the flagship shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in SITES.items():
            # q, k with std d^-1/4: unit-variance scores, a soft softmax
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            got = fa.flash_attend_tokens(q, k, v)
            check = check_b1(fa, f"{site} {dname} (random inputs)", q, k, v, got)
            iters = 5 if site == "x_1_3" else 20
            ms = time_ms(lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
            plain_ms = time_ms(lambda: fa.flash_attend_tokens_reference(q, k, v),
                               max(iters // 4, 3), flush)
            lib_ms, backend = sdpa_yardstick(q, k, v, flush)
            bound_ms, bound_by = flash_bound(BATCH, nq, nk, d, c, dname, q.element_size())
            rows.append(dict(check, site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c,
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             library_backend=backend, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f"[kernel] B1 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms ({backend}), "
                  f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
            del q, k, v, got
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


def phase_throughput(torch, model, x, card):
    from sap3d_tpu_torch.train.steps import make_eval_step

    step = make_eval_step(model)
    res = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        for m in model.attention_modules():
            m.use_kernel = use_kernel
        step(x)
        torch.cuda.synchronize()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            step(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[label] = BATCH * n / dt
    for m in model.attention_modules():
        m.use_kernel = True
    print(f"[forward] clips/s (batch {BATCH}, bf16, 5 forwards each, order plain, "
          f"kernel, kernel, plain): kernel {res['kernel']:.2f} / {res['kernel2']:.2f}, "
          f"plain {res['plain']:.2f} / {res['plain2']:.2f}  [{card}]", flush=True)
    return res


# Device kernels by name -> layer of PERF.md, first match wins.
_KERNEL_GROUPS = (
    ("B1 flash_attention_fwd", ("flash_fwd",)),
    ("convolution (cuDNN, with its layout transforms)",
     ("conv", "cudnn", "xmma", "implicit_gemm", "dgrad", "cutlass")),
    ("attention plain path at x_4_0 (bmm, softmax)", ("softmax", "gemm", "bmm")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("pooling", ("pool",)),
    ("copy / cast / pad / cat", ("copy", "pad", "cat", "transpose", "index")),
    ("other elementwise (relu, add, sigmoid, ...)", ("elementwise", "vectorized", "unrolled")),
)


def phase_profile(torch, model, x):
    """Where one kernel-path forward spends device time (torch.profiler):
    device time by layer group and the top kernels, against the host wall
    time of the same forward."""
    from torch.profiler import ProfilerActivity, profile

    from sap3d_tpu_torch.train.steps import make_eval_step

    step = make_eval_step(model)
    step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x)
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
        label = next((g for g, keys in _KERNEL_GROUPS if any(k in low for k in keys)),
                     "other")
        groups[label] = groups.get(label, 0.0) + ms
    print(f"[profile] one kernel-path forward (batch {BATCH}, bf16): device busy "
          f"{device_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f})", flush=True)
    for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {label}", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   top {ms:9.3f} ms x{count:<4d} {name[:110]}", flush=True)
    return dict(device_ms=device_ms, wall_ms=wall_ms, groups=groups,
                top=[(ms, count, name) for ms, count, name in sorted(rows, reverse=True)[:25]])


def phase_predictor(torch, fa, model, size: int = 112):
    """Phase 5, the main path: the sliding-window predictor on 40 frames."""
    import numpy as np

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.train.steps import make_eval_step

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
    if launches != 6:  # 25 windows = 2 batches of 16, 3 launches each
        raise AssertionError(f"expected 6 B1 launches in the predictor run, got {launches}")
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json-out", default=None,
                   help="also profile one forward by layer and write the details here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"[card] {card}", flush=True)

        from sap3d_tpu_torch.models.registry import build_model
        from sap3d_tpu_torch.ops.cuda import build
        from sap3d_tpu_torch.ops.cuda import flash_attention as fa

        t0 = time.perf_counter()
        log = build.build(fa.SOURCE)
        print(f"[build] {fa.SOURCE}.cu built in {time.perf_counter() - t0:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)

        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
        rows = phase_kernels(torch, fa, flush)

        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        model = build_model("unet++", dtype="bfloat16", device=DEVICE, seed=SEED)
        x = torch.randn(BATCH, 16, 112, 112, 3, device=DEVICE, generator=gen) * 0.3
        calibrate_and_randomize_bn(torch, model, x, gen)
        fwd = phase_forward(torch, fa, model, x)
        thr = phase_throughput(torch, model, x, card)
        prof = phase_profile(torch, model, x) if args.json_out else None
        launches = phase_predictor(torch, fa, model)

        main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
        total = {key: sum(r[key] for r in main_rows)
                 for key in ("ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in main_rows]
        # bound_by: the term that holds most of the summed bound
        t_ops = sum(r["bound_ms"] for r in main_rows if r["bound_by"] == "operations")
        kernels = [{
            "name": "flash_attention_fwd",
            "route": "cuda",
            "source": "sap3d_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "sap3d_tpu/ops/pallas/flash_attention.py:141",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times: the three bf16 calls of one batch-16 forward, summed
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if t_ops >= total["bound_ms"] / 2 else "bytes",
            "library_ms": None if None in lib else sum(lib),
        }]
        if args.json_out:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(dict(card=card, kernel_rows=rows, forward=fwd,
                               clips_per_s=thr, profile=prof, kernels=kernels), f, indent=1)
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
