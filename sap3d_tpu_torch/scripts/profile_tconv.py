"""Does the card run the up_2_0 transposed conv at the cost of its dense
dilated form?

Counterpart of ``scripts/profile_tconv.py``.

    python sap3d_tpu_torch/scripts/profile_tconv.py [--device cuda]
        [--root <checkout>] [--repeats 10]

The up_2_0 site of the flagship's decoder, [16, 256, 4, 28, 28] ->
[16, 128, 8, 56, 56] in bf16 (NCDHW), forward only, three ways:

* ``tconv``: the transposed conv, kernel 3, stride 2, SAME
  (``ops/layers.ConvTranspose3d``, cuDNN's ``conv_transpose3d``);
* ``dense``: a stride-1 kernel-3 conv at the output's resolution
  ([16, 256, 8, 56, 56] -> 128), the work of the dense dilated form;
* ``packed``: a kernel-2 conv at the input's resolution to 8 x 128 output
  channels, the phase-packed alternative (``ops/fast_tconv.py``'s form,
  2^3 taps where the exact phase plan needs 27 of 64).

If tconv takes about dense's time, the zeros of the dilated form are
multiplied.  The labels are the JAX script's printed names (``LABELS``).
The JAX script slices the packed conv's output to 256 of its 1024
channels, which lets XLA drop the rest; here the whole conv runs, the work
its label counts.  Inputs unit normal (numpy seed 0), kernels normal
times 0.05 (numpy seed 1); no bias.  Each time is the mean of
``--repeats`` calls (CUDA events, the L2 flushed before each).  Prints one
line per case and a last JSON line, its cases keyed by those labels, with
the work in FLOPs (the JAX script's counts: 710 G nominal and 89 G minimal
for the transposed conv), the share of the H100's dense bf16 peak, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing

BATCH = 16
CIN, COUT = 256, 128
SMALL = (4, 28, 28)  # up_2_0's input [D, H, W]
BIG = (8, 56, 56)    # its output
LABELS = {
    "tconv": f"tconv k3 s2 (4,28,28,{CIN})->(8,56,56,{COUT})",
    "dense": f"dense conv k3 (8,56,56,{CIN})->{COUT}",
    "packed": f"packed conv k2 (4,28,28,{CIN})->{8 * COUT}",
}


def work_flops(batch: int) -> dict[str, int]:
    """The products each case needs (2 per multiply-add): the transposed
    conv's minimal work (each input position meets each of 27 taps), the
    dense conv's and the packed conv's."""
    small, big = batch * int(np.prod(SMALL)), batch * int(np.prod(BIG))
    return {"tconv": 2 * small * 27 * CIN * COUT, "dense": 2 * big * 27 * CIN * COUT,
            "packed": 2 * small * 8 * CIN * 8 * COUT}


def arrays(batch: int, seed: int = 0):
    """x_small [B, 256, 4, 28, 28] and x_big [B, 256, 8, 56, 56], unit
    normal (NCDHW), float64 numpy in that order."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, CIN) + SMALL), rng.normal(size=(batch, CIN) + BIG))


def layers(dtype: torch.dtype, device: torch.device, seed: int = 0) -> dict:
    """The three cases' layers, no bias, kernels normal times 0.05."""
    from sap3d_tpu_torch.ops.layers import Conv3d, ConvTranspose3d

    rng = np.random.default_rng(seed + 1)
    out = {"tconv": ConvTranspose3d(CIN, COUT, 3, 2, use_bias=False, dtype=dtype),
           "dense": Conv3d(CIN, COUT, 3, use_bias=False, dtype=dtype),
           "packed": Conv3d(CIN, 8 * COUT, 2, use_bias=False, dtype=dtype)}
    with torch.no_grad():
        for layer in out.values():
            layer.kernel.copy_(torch.from_numpy(rng.normal(size=layer.kernel.shape) * 0.05))
    return {k: v.to(device) for k, v in out.items()}


def cases(mods: dict, x_small: torch.Tensor, x_big: torch.Tensor) -> dict:
    """name -> the forward to time (no autograd)."""
    def run(name, x):
        def fn():
            with torch.no_grad():
                return mods[name](x)
        return fn
    return {"tconv": run("tconv", x_small), "dense": run("dense", x_big),
            "packed": run("packed", x_small)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    x_small, x_big = (torch.from_numpy(a).to(device, torch.bfloat16) for a in arrays(BATCH))
    fns = cases(layers(torch.bfloat16, device), x_small, x_big)
    flops = work_flops(BATCH)
    rows = {}
    for name, fn in fns.items():
        ms = timer.ms(fn, args.repeats)
        share = flops[name] / (ms * 1e-3) / _timing.BF16_PEAK_FLOPS
        rows[LABELS[name]] = dict(case=name, ms=ms, work_flops=flops[name], peak_share=share)
        print(f"{LABELS[name]:44s} {ms:8.3f} ms   ({flops[name] / 1e9:6.1f} GFLOP, "
              f"{share * 100:5.1f}% of peak)", flush=True)
    return _timing.emit("profile_tconv", device, dict(
        batch=BATCH, dtype="bfloat16", repeats=args.repeats,
        peak_flops=_timing.BF16_PEAK_FLOPS, cases=rows))


if __name__ == "__main__":
    main()
