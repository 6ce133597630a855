"""Bisect the flagship's inference forward: does the attention kernel's
formulation cost throughput?

Counterpart of ``scripts/bisect_infer.py``.  Times the flagship
(``p3d_unetplusplus_ds``, bf16, random weights from seed 0) eval forward
on ``[batch, 16, 112, 112, 3]`` frames four ways:

1. the current route: kernel B1 (``flash_attend_tokens``, online softmax)
   at every site the forward gate takes;
2. kernel B6 (``ops/cuda/flash_attention_nolse.flash_nolse``, two passes,
   the normalised p rounded as the TPU kernel rounds it) in B1's place,
   swapped in by ``ops.attention.forward_kernel`` and B1 again afterwards;
3. the plain path (``use_kernel=False`` on every ``SelfAttention3D``, the
   JAX package's ``SAP3D_DISABLE_PALLAS=1``);
4. the x_1_3 site's projection products on ``[16, 8, 56, 56, 128]`` bf16:
   one fused 128 -> 160 product against three separate ones (128 -> 16, 16,
   128), plain ``torch.matmul`` products as the JAX script leaves them to
   XLA.

Each time is chained N-differencing: 2 warm-up runs, then runs of 4 and
14 calls, each call's input carrying 1e-12 of the previous output's sum
(a data dependency the runtime cannot drop), the difference over 10 calls.
Before each forward is timed, one forward is run with the launch counters
at 0 and read after: the current route launches B1 only, the swapped one B6
only (its two passes: the row statistics, RS, and pass 2, B6), the plain
path neither.

    python -m sap3d_tpu_torch.scripts.bisect_infer [--device cuda] [--batch 16]

``main()`` returns the readings and the launch counts as a dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sap3d_tpu_torch.core.device import resolve_device
from sap3d_tpu_torch.models.registry import build_model
from sap3d_tpu_torch.ops import attention, cuda
from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse
from sap3d_tpu_torch.train.steps import make_eval_step

FLAGSHIP = "p3d_unetplusplus_ds"
PROJ_SHAPE = (16, 8, 56, 56, 128)  # the x_1_3 site's input at batch 16
PROJ_WIDTHS = (16, 16, 128)        # f, g, h: C/8, C/8, C


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained(step, x0: torch.Tensor, n_small: int = 4, n_large: int = 14,
            warmup: int = 2) -> float:
    """ms per call of ``step(x)`` by chained N-differencing (module
    docstring)."""
    def run(n):
        x, out = x0, None
        for _ in range(n):
            out = step(x)
            # * 1e-12, not * 0: the term stays a real dependency
            x = x0 + out.float().sum().to(x0.dtype) * 1e-12
        total = out.float().sum().item()  # waits for the last call
        synchronize(x0.device)
        return total

    run(warmup)
    t0 = time.perf_counter()
    run(n_small)
    ts = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(n_large)
    tl = time.perf_counter() - t0
    return (tl - ts) / (n_large - n_small) * 1e3


def flagship(batch: int, device, structure: str = FLAGSHIP, size: int = 112):
    """The model in bf16 (seed 0) on ``device`` and its frames, normal from
    ``numpy.random.default_rng(0)`` times 0.3, float32."""
    dev = resolve_device(device)
    model = build_model(structure, dtype="bfloat16", device=dev, seed=0)
    shape = (batch, 16, size, size, 3)
    frames = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 0.3
    return model, torch.from_numpy(frames).to(dev)


def launch_counts() -> dict[str, int]:
    return cuda.launch_counts("B1", "RS", "B6")


def forward_launches(fwd, frames: torch.Tensor) -> dict[str, int]:
    """B1 and B6 (row statistics and pass 2) launches of one call of
    ``fwd``, counted from 0."""
    cuda.reset_launch_counts("B1", "RS", "B6")
    fwd(frames)
    synchronize(frames.device)
    return launch_counts()


def projection_ms(device, shape=PROJ_SHAPE, n_small: int = 4, n_large: int = 14,
                  warmup: int = 2) -> dict[str, float]:
    """ms of the fused (128 -> 160) and the three separate (128 -> 16, 16,
    128) projection products at the x_1_3 site on ``shape`` (C = 128 last),
    bf16, fp32 accumulation."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    c = shape[-1]

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    x = bf16(rng.normal(size=shape))
    wc = bf16(rng.normal(size=(c, sum(PROJ_WIDTHS))) * 0.05)
    w3 = [bf16(rng.normal(size=(c, o)) * 0.05) for o in PROJ_WIDTHS]

    def fused(x):
        return torch.matmul(x, wc)

    def separate(x):
        return torch.cat([torch.matmul(x, w) for w in w3], dim=-1)

    return {name: chained(f, x, n_small, n_large, warmup)
            for name, f in (("fused_proj_ms", fused), ("separate_proj_ms", separate))}


def main(device="cuda", batch: int = 16, structure: str = FLAGSHIP, size: int = 112,
         proj_shape=PROJ_SHAPE, n_small: int = 4, n_large: int = 14,
         warmup: int = 2) -> dict:
    """The four readings (ms) and each variant's launches of one forward;
    prints them as the JAX script does."""
    dev = resolve_device(device)
    model, frames = flagship(batch, dev, structure, size)
    fwd = make_eval_step(model)

    def timed(label):
        launches = forward_launches(fwd, frames)
        ms = chained(fwd, frames, n_small, n_large, warmup)
        print(f"{label}: {ms:.2f} ms/batch{batch} = {batch / ms * 1e3:.1f} clips/s "
              f"(launches per forward {launches})", flush=True)
        return ms, launches

    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
           "batch": batch, "launches": {}}
    res["current_ms"], res["launches"]["current"] = timed("current fwd (B1)")
    with attention.forward_kernel(nolse.flash_nolse):
        res["nolse_ms"], res["launches"]["nolse"] = timed("lse-free fwd kernel (B6)")
    res["launches"]["after"] = forward_launches(fwd, frames)
    for sa in model.attention_modules():
        sa.use_kernel = False
    res["plain_ms"], res["launches"]["plain"] = timed("plain attention fwd")
    del model, fwd, frames
    proj = projection_ms(dev, proj_shape, n_small, n_large, warmup)
    for name, ms in proj.items():
        print(f"{name.removesuffix('_ms').replace('_', ' ')} x_1_3: {ms:.3f} ms", flush=True)
    res.update(proj)
    synchronize(dev)
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--batch", type=int, default=16, help="clips per forward")
    args = p.parse_args()
    main(args.device, args.batch)
