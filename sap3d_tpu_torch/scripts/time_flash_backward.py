"""Time kernels B3 and B4 (the flash backward), and B5 (forward and
backward) at the GN decoders' sites, of a checkout of the port at the sites
``PERF.md`` reports, so that two versions can be read on one card in one
run.

    python sap3d_tpu_torch/scripts/time_flash_backward.py --root <checkout> [--label L]
        [--dtype bfloat16|float32] [--profile] [--splits 1,2,4,8]

``--root`` names the checkout whose ``sap3d_tpu_torch`` is imported (its
kernels are built into its own ``build/kernels``); run the file by its path,
not with ``-m``, so that no other copy of the package is imported first.
Comparing two commits: unpack each (``git archive``) and run parent,
change, change, parent in one command.

Per site (B, Nq, Nk, d, C), in ``--dtype`` (default bf16; this script times
any checkout's kernels, so that a checkout older than the option can be
timed by this file with ``--root``): q, k with std d^-1/4, v and do unit
normal and dlse normal, from one seed; o and lse from the checkout's own
kernel B2; each time the mean of CUDA events over ``iters`` calls, the L2
evicted (a 256 MB write) before each, after one warm-up call.  A site the
checkout's backward gate refuses (GN deconv_pool4, d = 128 and C = 1024,
before B3 took it) reads B3 and B4 as null.  B5 (``flash_fwd_chunked_bwd``)
is timed as its forward plus one autograd backward at the GN sites (pool2
is x_2_2's shape).  Prints one line per site and a last JSON line, with the
card's name and power limit.
``--profile`` adds B3's device time per kernel (torch.profiler, the mean
of 3 calls); ``--splits`` times B3 with the query split forced to each
value (a checkout whose ``flash_attention_bwd`` has ``query_split``) at the
sites whose key tiles alone leave SMs idle (fewer than 264 CTAs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

try:
    from ._timing import card_line
except ImportError:  # run by its path: this file's directory is on sys.path
    from _timing import card_line

# (name, B, Nq, Nk, d, C): the flagship's three sites at batch 16 (also the
# ring hops' stacked shapes), the GN decoders' deconv_pool3 and deconv_pool4
# (their pool2 is x_2_2's shape), the 'full' head's x_0_1_sa at batch 2
SITES = (("x_3_1", 16, 392, 392, 64, 512), ("x_2_2", 16, 3136, 3136, 32, 256),
         ("x_1_3", 16, 25088, 3136, 16, 128), ("deconv_pool3", 16, 3136, 3136, 64, 512),
         ("deconv_pool4", 16, 3136, 3136, 128, 1024), ("x_0_1_sa", 2, 200704, 3136, 2, 16))
# The GN sites, where B5 is timed
B5_SITES = ("x_2_2", "deconv_pool3", "deconv_pool4")


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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True, help="checkout whose sap3d_tpu_torch is timed")
    p.add_argument("--label", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--splits", default=None, help="comma-separated query splits to sweep")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    if not torch.cuda.is_available():
        raise SystemExit("time_flash_backward: needs a GPU")
    if not os.path.abspath(fb.__file__).startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {fb.__file__}, not the checkout at {args.root}")
    label = args.label or args.root
    card = card_line()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {}
    dtype = getattr(torch, args.dtype)
    for name, b, nq, nk, d, c in SITES:
        q = (torch.randn(b, nq, d, device="cuda", generator=gen) * d ** -0.25).to(dtype)
        k = (torch.randn(b, nk, d, device="cuda", generator=gen) * d ** -0.25).to(dtype)
        v = torch.randn(b, nk, c, device="cuda", generator=gen).to(dtype)
        do = torch.randn(b, nq, c, device="cuda", generator=gen).to(dtype)
        dlse = torch.randn(b, nq, device="cuda", generator=gen)
        o, lse = fa.flash_forward_lse(q, k, v)
        iters = 5 if nq * nk * (d + c) > 5e9 else 20
        res[name] = {"B3_ms": None, "B4_ms": None}
        if fb.backward_viable(nq, nk, d, c, dtype):
            res[name]["B3_ms"] = time_ms(torch, lambda: fb.flash_backward(q, k, v, o, lse, do),
                                         iters, flush)
            res[name]["B4_ms"] = time_ms(
                torch, lambda: fb.flash_backward(q, k, v, o, lse, do, dlse=dlse), iters, flush)
        if name in B5_SITES:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def b5():
                out = ta.flash_fwd_chunked_bwd(qg, kg, vg)
                return torch.autograd.grad(out, (qg, kg, vg), do)

            res[name]["B5_ms"] = time_ms(torch, b5, max(iters // 2, 3), flush)
        line = ", ".join(f"{key[:-3]} {ms:.4f} ms" if ms is not None else f"{key[:-3]} refused"
                         for key, ms in res[name].items())
        print(f"[{label}] {name} {args.dtype} B={b} Nq={nq} Nk={nk} d={d} C={c}: {line} "
              f"({card})", flush=True)
        if args.profile and res[name]["B3_ms"] is not None:
            res[name]["B3_kernels_ms"] = kernel_times(
                torch, lambda: fb.flash_backward(q, k, v, o, lse, do))
            for kernel, ms in res[name]["B3_kernels_ms"].items():
                print(f"[{label}]   {ms:.4f} ms  {kernel}", flush=True)
        if args.splits and b * -(-nk // 64) < 264:
            rule, res[name]["B3_ms_by_split"] = fb.query_split, {}
            try:
                for split in (int(x) for x in args.splits.split(",")):
                    fb.query_split = lambda *_, split=split: min(split, -(-nq // 64))
                    ms = time_ms(torch, lambda: fb.flash_backward(q, k, v, o, lse, do), iters,
                                 flush)
                    res[name]["B3_ms_by_split"][split] = ms
                    print(f"[{label}]   query split {split}: B3 {ms:.4f} ms", flush=True)
            finally:
                fb.query_split = rule
        del q, k, v, do, dlse, o, lse
        torch.cuda.empty_cache()
    out = {"label": label, "card": card, "dtype": args.dtype, "sites": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
