"""Forward only, the up_2_0 transposed conv taken apart: where does the
phase form gain or lose?

Counterpart of ``scripts/profile_tconv3.py``.

    python sap3d_tpu_torch/scripts/profile_tconv3.py [--device cuda]
        [--root <checkout>] [--repeats 10]

On [16, 256, 4, 28, 28] bf16 (NCDHW), the variants of the JAX script
(``LABELS``):

  A. the transposed conv, kernel 3, stride 2, SAME (``conv_transpose3d``
     through ``ops/layers.ConvTranspose3d``'s crop), the dilated baseline;
  B. the packed kernel-2 conv only (8 x 128 phase-blocked channels, no
     interleave);
  C. B and the interleave to [16, 128, 8, 56, 56];
  D. C times a per-channel scale plus a shift (a batch norm's affine);
  E. A with the same affine;
  F. the phase transposed conv itself (``ops/fast_tconv.phase_tconv``,
     the exact phase plan of A's kernel).

x unit normal, the kernels [3, 3, 3, 256, 128] and [2, 2, 2, 256, 1024]
(flax's layout) normal times 0.05, scale and shift unit normal, numpy seed
0 in the JAX script's order, all bf16.  Each time is the mean of
``--repeats`` calls (CUDA events, the L2 flushed before each).  Prints one
line per variant and a last JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing

BATCH = 16
CIN, COUT = 256, 128
SMALL = (4, 28, 28)  # up_2_0's input [D, H, W]
LABELS = ("A tconv", "B packed only", "C packed+interleave", "D C+affine", "E A+affine",
          "F phase_tconv op")


def arrays(batch: int, seed: int = 0) -> dict[str, np.ndarray]:
    """x [B, 4, 28, 28, 256], w_t [3, 3, 3, 256, 128], w_p [2, 2, 2, 256,
    1024], scale and shift [128]: the JAX script's draws, in its order
    (NDHWC and flax's DHWIO, as it holds them)."""
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(batch, *SMALL, CIN)),
                w_t=rng.normal(size=(3, 3, 3, CIN, COUT)) * 0.05,
                w_p=rng.normal(size=(2, 2, 2, CIN, 8 * COUT)) * 0.05,
                scale=rng.normal(size=(COUT,)), shift=rng.normal(size=(COUT,)))


def tensors(a: dict, dtype: torch.dtype, device: torch.device) -> dict[str, torch.Tensor]:
    """``arrays`` in the port's layouts: x NCDHW, w_t as a transposed-conv
    kernel (flipped, [in, out, ...]), w_p as a conv kernel ([out, in,
    ...]), each cast to ``dtype``."""
    w_t = np.flip(a["w_t"], (0, 1, 2)).transpose(3, 4, 0, 1, 2)
    out = dict(x=a["x"].transpose(0, 4, 1, 2, 3), w_t=w_t,
               w_p=a["w_p"].transpose(4, 3, 0, 1, 2), scale=a["scale"], shift=a["shift"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype)
            for k, v in out.items()}


def variants(t: dict) -> dict:
    """label -> the forward (no autograd) on ``t`` (``tensors``)."""
    from sap3d_tpu_torch.ops.fast_tconv import _interleave, phase_tconv
    from sap3d_tpu_torch.ops.layers import tconv_same_crop

    x, w_t, w_p = t["x"], t["w_t"], t["w_p"]
    scale, shift = (t[k].view(1, -1, 1, 1, 1) for k in ("scale", "shift"))
    crops = [tconv_same_crop(n, 3, 2) for n in x.shape[2:]]

    def tconv():
        y = F.conv_transpose3d(x, w_t, None, 2, output_padding=[op for _, op in crops])
        (d0, _), (h0, _), (w0, _) = crops
        d, h, w = (2 * n for n in x.shape[2:])
        return y[:, :, d0:d0 + d, h0:h0 + h, w0:w0 + w]

    def packed():
        return F.conv3d(F.pad(x, (0, 1, 0, 1, 0, 1)), w_p)  # kernel 2, SAME: (0, 1)

    def interleaved():
        return _interleave(packed(), (2, 2, 2), COUT)

    cases = {"A tconv": tconv, "B packed only": packed, "C packed+interleave": interleaved,
             "D C+affine": lambda: interleaved() * scale + shift,
             "E A+affine": lambda: tconv() * scale + shift,
             "F phase_tconv op": lambda: phase_tconv(x, w_t, (2, 2, 2))}

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run
    return {k: no_grad(v) for k, v in cases.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    fns = variants(tensors(arrays(BATCH), torch.bfloat16, device))
    rows = {}
    for name, fn in fns.items():
        rows[name] = dict(ms=timer.ms(fn, args.repeats))
        print(f"{name:22s} {rows[name]['ms']:8.3f} ms", flush=True)
    return _timing.emit("profile_tconv3", device, dict(
        batch=BATCH, dtype="bfloat16", repeats=args.repeats, cases=rows))


if __name__ == "__main__":
    main()
