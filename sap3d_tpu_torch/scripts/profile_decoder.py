"""The flagship's heaviest convolutions on the card, each alone, with the
share of the H100's dense bf16 peak each reaches.

Counterpart of ``scripts/profile_decoder.py``.

    python sap3d_tpu_torch/scripts/profile_decoder.py [--device cuda]
        [--root <checkout>] [--repeats 10]

Each site of ``SITES`` (the JAX script's seven, at batch 16 in bf16) runs
through the port's own layer, ``ops/layers.Conv3d`` or ``ConvTranspose3d``
without bias, so that the explicit SAME padding (asymmetric at stride 2)
is timed as the model runs it.  x is unit normal and the kernel normal
times 0.02 in flax's DHWIO layout, from numpy seed 0 as the JAX script
draws them, then put in the layer's layout (``layer_kernel``).  Timed: the
forward, and the forward with dx and dw of the quadratic loss 0.5
sum(y^2) (with a linear loss the cotangent would be constant).  The FLOPs
are the JAX script's count (``conv_flops``): 2 MACs per tap, input and
output channel and output position, the forward + backward three times
that; achieved shares are against 989 TFLOP/s (the H100 SXM's dense bf16
rate), not the TPU's.  For a transposed conv that count takes the output
positions, prod(strides) times the products' work (``work_flops``), so
its share can pass 100%; its share of the work is printed beside it.  Prints one line per site and a last JSON line with
the card's name and power limit.
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
# (name, input [D, H, W, C], output C, kernel, strides, transposed)
SITES = [
    ("x_1_3 conv 3^3 256->128 @8x56x56", (8, 56, 56, 256), 128, (3, 3, 3), (1, 1, 1), False),
    ("x_1_1 conv 3^3 192->128 @8x56x56", (8, 56, 56, 192), 128, (3, 3, 3), (1, 1, 1), False),
    ("x_2_2 conv 3^3 512->256 @4x28x28", (4, 28, 28, 512), 256, (3, 3, 3), (1, 1, 1), False),
    ("x_3_1 conv (2,3,3) 1024->512 @2x14", (2, 14, 14, 1024), 512, (2, 3, 3), (1, 1, 1), False),
    ("up_2_2 tconv 3^3 s2 256->128", (4, 28, 28, 256), 128, (3, 3, 3), (2, 2, 2), True),
    ("x_0_1 tconv 3^3 s2 128->1", (8, 56, 56, 128), 1, (3, 3, 3), (2, 2, 2), True),
    ("stem conv (1,7,7) s(1,2,2) 3->64", (16, 112, 112, 3), 64, (1, 7, 7), (1, 2, 2), False),
]


def conv_flops(in_shape, cout: int, kernel, strides, batch: int, transpose: bool) -> int:
    """The JAX script's forward FLOP count: 2 x output positions x taps x
    C_in x C_out, output positions ceil(n / s) per axis, or n s for a
    transposed conv (whose count is then rounded down to a multiple of
    prod(strides), as the JAX script writes it)."""
    cin = in_shape[-1]
    if transpose:
        out_sp = tuple(s * st for s, st in zip(in_shape[:-1], strides))
    else:
        out_sp = tuple(-(-s // st) for s, st in zip(in_shape[:-1], strides))
    flops = 2 * batch * int(np.prod(out_sp)) * int(np.prod(kernel)) * cin * cout
    if transpose:
        flops = flops // int(np.prod(strides)) * int(np.prod(strides))
    return flops


def work_flops(in_shape, cout: int, kernel, batch: int) -> int:
    """The FLOPs a transposed conv's products need: 2 x input positions x
    taps x C_in x C_out (each input position meets each tap once).  The
    JAX script's count (``conv_flops``) takes the output positions in
    their place, prod(strides) times as many."""
    return 2 * batch * int(np.prod(in_shape[:-1])) * int(np.prod(kernel)) * in_shape[-1] * cout


def site_arrays(in_shape, cout: int, kernel, batch: int, seed: int = 0):
    """x [B, D, H, W, C] unit normal and w [kd, kh, kw, C_in, C_out] normal
    times 0.02, float64 numpy from ``seed`` in the JAX script's order."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch,) + tuple(in_shape))
    w = rng.normal(size=tuple(kernel) + (in_shape[-1], cout)) * 0.02
    return x, w


def layer_kernel(w: np.ndarray, transpose: bool) -> torch.Tensor:
    """A DHWIO kernel in the port's layout: [out, in, kd, kh, kw] for
    ``Conv3d``; flipped on the three spatial axes and [in, out, kd, kh, kw]
    for ``ConvTranspose3d`` (flax's transposed conv does not flip its
    kernel, torch's does)."""
    if transpose:
        w = np.flip(w, (0, 1, 2)).transpose(3, 4, 0, 1, 2)
    else:
        w = w.transpose(4, 3, 0, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(w))


def site_layer(w: np.ndarray, strides, transpose: bool, dtype: torch.dtype,
               device: torch.device):
    """The port's layer for a site, without bias, carrying ``w``."""
    from sap3d_tpu_torch.ops.layers import Conv3d, ConvTranspose3d

    kd, kh, kw, cin, cout = w.shape
    cls = ConvTranspose3d if transpose else Conv3d
    layer = cls(cin, cout, (kd, kh, kw), strides, use_bias=False, dtype=dtype)
    with torch.no_grad():
        layer.kernel.copy_(layer_kernel(w, transpose))
    return layer.to(device)


def fwd_bwd(layer, x):
    """dx and dw of 0.5 sum(layer(x)^2), the loss in float32."""
    x = x.detach().requires_grad_()
    y = layer(x)
    return torch.autograd.grad(0.5 * y.float().square().sum(), (x, layer.kernel))


def profile_site(timer: _timing.Timer, name: str, in_shape, cout: int, kernel, strides,
                 transpose: bool, batch: int, repeats: int, dtype=torch.bfloat16) -> dict:
    x_np, w_np = site_arrays(in_shape, cout, kernel, batch)
    layer = site_layer(w_np, strides, transpose, dtype, timer.device)
    # NDHWC -> NCDHW, the model's layout
    x = torch.from_numpy(x_np).to(timer.device, dtype).permute(0, 4, 1, 2, 3).contiguous()
    flops = conv_flops(in_shape, cout, kernel, strides, batch, transpose)

    def forward():
        with torch.no_grad():
            return layer(x)

    ms_f = timer.ms(forward, repeats)
    ms_fb = timer.ms(lambda: fwd_bwd(layer, x), repeats)
    row = dict(flops=flops, forward_ms=ms_f, fwd_bwd_ms=ms_fb,
               forward_peak_share=flops / (ms_f * 1e-3) / _timing.BF16_PEAK_FLOPS,
               fwd_bwd_peak_share=3 * flops / (ms_fb * 1e-3) / _timing.BF16_PEAK_FLOPS)
    work = ""
    if transpose:
        row["work_flops"] = work_flops(in_shape, cout, kernel, batch)
        row["forward_work_share"] = row["work_flops"] / (ms_f * 1e-3) / _timing.BF16_PEAK_FLOPS
        row["fwd_bwd_work_share"] = 3 * row["work_flops"] / (ms_fb * 1e-3) \
            / _timing.BF16_PEAK_FLOPS
        work = (f"   on the products' work {row['forward_work_share'] * 100:4.1f}% / "
                f"{row['fwd_bwd_work_share'] * 100:4.1f}%")
    print(f"{name:34s} fwd {ms_f:7.3f} ms ({row['forward_peak_share'] * 100:4.1f}%)   "
          f"f+b {ms_fb:7.3f} ms ({row['fwd_bwd_peak_share'] * 100:4.1f}%){work}", flush=True)
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    sites = {}
    for name, in_shape, cout, kernel, strides, transpose in SITES:
        sites[name] = profile_site(timer, name, in_shape, cout, kernel, strides, transpose,
                                   BATCH, args.repeats)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return _timing.emit("profile_decoder", device, dict(
        batch=BATCH, dtype="bfloat16", repeats=args.repeats,
        peak_flops=_timing.BF16_PEAK_FLOPS, sites=sites))


if __name__ == "__main__":
    main()
