"""Time kernels B1 and B2 (the flash forward), and B6 (the lse-free forward
of the bisect, both passes) with its first pass, the row statistics, at the
flagship's sites, of a checkout of the port at the sites ``PERF.md``
reports, so that two versions can be read on one card in one run.

    python sap3d_tpu_torch/scripts/time_flash_forward.py --root <checkout> [--label L]
        [--dtype bfloat16|float32] [--profile] [--no-sdpa]

``--root`` names the checkout whose ``sap3d_tpu_torch`` is imported (its
kernels are built into its own ``build/kernels``); run the file by its path,
not with ``-m``, so that no other copy of the package is imported first.
Comparing two commits: unpack each (``git archive``) and run parent,
change, change, parent in one command.

Per site (B, Nq, Nk, d, C), in ``--dtype`` (default bf16; this script
times any checkout's kernels, so that a checkout older than the option
can be timed by this file with ``--root``): q, k with std d^-1/4 and v unit
normal, from one seed; each time the mean of CUDA events over ``iters``
calls, the L2 evicted (a 256 MB write) before each, after one warm-up
call.  Beside them: one ``scaled_dot_product_attention`` call on the same
inputs (``scale=1.0``, the first backend that takes d != C; the port never
calls it), the bound (each input read once and o written once at 3.35 TB/s
against 2 B Nq Nk (d + C) FLOPs at 989 TFLOP/s, in float32 six times as
many, the split-bf16 products; ``chip_smoke.py:flash_bound``), in float32
also that bound at the CUDA cores' 67 TFLOP/s, and the exp floor (B Nq Nk exponentials at the SFU's 16 per clock per SM,
132 SMs at 1.98 GHz, which the bound leaves out).  Prints one line per site
and a last JSON line, with the card's name and power limit.  ``--profile``
adds B1's device time per kernel (torch.profiler, the mean of 3 calls).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (name, B, Nq, Nk, d, C): the flagship's three sites at batch 16 (also the
# ring hops' stacked shapes; GN pool2 is x_2_2's shape), the GN decoders'
# deconv_pool3 and deconv_pool4, the 'full' head's x_0_1_sa at batch 2
SITES = (("x_3_1", 16, 392, 392, 64, 512), ("x_2_2", 16, 3136, 3136, 32, 256),
         ("x_1_3", 16, 25088, 3136, 16, 128), ("deconv_pool3", 16, 3136, 3136, 64, 512),
         ("deconv_pool4", 16, 3136, 3136, 128, 1024), ("x_0_1_sa", 2, 200704, 3136, 2, 16))
# The sites where B6 (the bisect's swap) runs
FLAGSHIP_SITES = ("x_3_1", "x_2_2", "x_1_3")
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_CUDA_CORE_FLOPS = 67e12
SPLIT_PRODUCTS = 6  # bf16 products per float32 product (csrc/split_bf16.cuh)
EXP_PER_S = 16 * 132 * 1.98e9


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, flush) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_times(torch, fn, calls: int = 3) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key[:90]] = us / 1e3 / calls
    return out


def sdpa_ms(torch, q, k, v, flush, iters: int):
    """One scaled_dot_product_attention call (scale=1.0) with the first
    backend that takes the shape, and that backend's name."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    warnings.filterwarnings("ignore", message=".*(kernel not used|Flash attention requires|"
                            "Memory efficient kernel not used|cuDNN attention).*")
    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                call = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)  # noqa: E731
                call()
                torch.cuda.synchronize()
                return time_ms(torch, call, iters, flush), backend.name
        except RuntimeError:
            continue
    return None, "none"


def b6_times(torch, fa, q, k, v, iters, flush, name) -> dict:
    """B6 and, where the checkout has it, its first pass (the row-stats
    kernel) at the flagship's sites; nothing elsewhere."""
    if name not in FLAGSHIP_SITES:
        return {}
    from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse

    out = {"B6_ms": time_ms(torch, lambda: nolse.flash_nolse(q, k, v), iters, flush)}
    if hasattr(fa, "flash_row_stats"):
        out["RS_ms"] = time_ms(torch, lambda: fa.flash_row_stats(q, k), iters, flush)
    return out


def bound_ms(b, nq, nk, d, c, itemsize: int = 2, rate: float = BF16_FLOPS) -> float:
    nbytes = itemsize * b * (nq * d + nk * d + nk * c + nq * c)
    return max(nbytes / HBM_BYTES_PER_S, 2 * b * nq * nk * (d + c) / rate) * 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True, help="checkout whose sap3d_tpu_torch is timed")
    p.add_argument("--label", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--no-sdpa", action="store_true", help="leave out the SDPA yardstick")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from sap3d_tpu_torch.ops.cuda import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("time_flash_forward: needs a GPU")
    if not os.path.abspath(fa.__file__).startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {fa.__file__}, not the checkout at {args.root}")
    label = args.label or args.root
    card = card_line()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {}
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    for name, b, nq, nk, d, c in SITES:
        q = (torch.randn(b, nq, d, device="cuda", generator=gen) * d ** -0.25).to(dtype)
        k = (torch.randn(b, nk, d, device="cuda", generator=gen) * d ** -0.25).to(dtype)
        v = torch.randn(b, nk, c, device="cuda", generator=gen).to(dtype)
        iters = 5 if f32 else 20
        b1 = time_ms(torch, lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
        b2 = time_ms(torch, lambda: fa.flash_forward_lse(q, k, v), iters, flush)
        item = q.element_size()
        row = {"B1_ms": b1, "B2_ms": b2,
               **b6_times(torch, fa, q, k, v, iters, flush, name),
               "bound_ms": bound_ms(b, nq, nk, d, c, item,
                                    BF16_FLOPS / SPLIT_PRODUCTS if f32 else BF16_FLOPS),
               "exp_floor_ms": b * nq * nk / EXP_PER_S * 1e3}
        if f32:
            row["cuda_core_bound_ms"] = bound_ms(b, nq, nk, d, c, item, FP32_CUDA_CORE_FLOPS)
        if not args.no_sdpa:
            row["sdpa_ms"], row["sdpa_backend"] = sdpa_ms(torch, q, k, v, flush, 5)
        sdpa = "" if args.no_sdpa else (
            f", sdpa {row['sdpa_ms']:.4f} ms ({row['sdpa_backend']})"
            if row["sdpa_ms"] is not None else ", sdpa none")
        cores = f", CUDA-core bound {row['cuda_core_bound_ms']:.4f} ms" if f32 else ""
        b6 = "".join(f", {key[:-3]} {row[key]:.4f} ms" for key in ("B6_ms", "RS_ms") if key in row)
        print(f"[{label}] {name} {args.dtype} B={b} Nq={nq} Nk={nk} d={d} C={c}: B1 {b1:.4f} ms, "
              f"B2 {b2:.4f} ms{b6}{sdpa}, bound {row['bound_ms']:.4f} ms{cores}, exp floor "
              f"{row['exp_floor_ms']:.4f} ms ({card})", flush=True)
        if args.profile:
            row["B1_kernels_ms"] = kernel_times(torch, lambda: fa.flash_attend_tokens(q, k, v))
            for kernel, ms in row["B1_kernels_ms"].items():
                print(f"[{label}]   {ms:.4f} ms  {kernel}", flush=True)
        res[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    out = {"label": label, "card": card, "dtype": args.dtype, "sites": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
