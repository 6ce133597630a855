"""Forward + backward of the up_2_0 transposed conv against the
phase-packed conv and its interleave.

Counterpart of ``scripts/profile_tconv2.py``.

    python sap3d_tpu_torch/scripts/profile_tconv2.py [--device cuda]
        [--root <checkout>] [--repeats 10]

On [16, 256, 4, 28, 28] bf16 (NCDHW, unit normal, numpy seed 0), the
gradient with respect to the input of sum(y^2) (in float32), as the JAX
script's ``jax.grad`` of its loss takes it:

* ``tconv``: y the transposed conv, kernel 3, stride 2, SAME, to 128
  channels (``ops/layers.ConvTranspose3d``);
* ``packed+interleave``: y a kernel-2 conv to 8 x 128 channels at the
  input's resolution, its phase blocks interleaved to [16, 128, 8, 56, 56]
  (``ops/fast_tconv._interleave``).

Kernels normal times 0.05 (numpy seed 1), no bias.  Each time is the mean
of ``--repeats`` calls (CUDA events, the L2 flushed before each).  Prints
one line per case (the JAX script's names, ``LABELS``) and a last JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

try:
    from . import _timing
    from . import profile_tconv
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing
    import profile_tconv

BATCH = 16
LABELS = ("tconv", "packed+interleave")


def losses(mods: dict) -> dict:
    """name -> loss(x) = sum(y(x)^2) in float32."""
    from sap3d_tpu_torch.ops.fast_tconv import _interleave

    def loss_t(x):
        return mods["tconv"](x).float().square().sum()

    def loss_p(x):
        y = _interleave(mods["packed"](x), (2, 2, 2), profile_tconv.COUT)
        return y.float().square().sum()

    return {"tconv": loss_t, "packed+interleave": loss_p}


def input_grad(loss, x: torch.Tensor) -> torch.Tensor:
    """d loss / d x."""
    x = x.detach().requires_grad_()
    (g,) = torch.autograd.grad(loss(x), x)
    return g


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    x = torch.from_numpy(profile_tconv.arrays(BATCH)[0]).to(device, torch.bfloat16)
    mods = profile_tconv.layers(torch.bfloat16, device)
    rows = {}
    for name, loss in losses(mods).items():
        ms = timer.ms(lambda: input_grad(loss, x), args.repeats)
        rows[name] = dict(fwd_bwd_ms=ms)
        print(f"{name:20s} f+b {ms:8.3f} ms", flush=True)
    return _timing.emit("profile_tconv2", device, dict(
        batch=BATCH, dtype="bfloat16", repeats=args.repeats, cases=rows))


if __name__ == "__main__":
    main()
