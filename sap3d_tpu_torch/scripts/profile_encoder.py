"""The P3D encoder's time on the card: truncated encoders stage by stage,
one stage-3 bottleneck, and the stage-3 convolutions as products.

Counterpart of ``scripts/profile_encoder.py``.

    python sap3d_tpu_torch/scripts/profile_encoder.py [all|stages|block|micro]
        [--device cuda] [--root <checkout>] [--repeats 10]

* ``stages``: ``models/p3d.P3DEncoder`` with the first 0, 1, 2 and 3 of its
  stages ((64, 3), (128, 8), (256, 36)) in bf16 and train mode (batch
  statistics), on [16, 16, 112, 112, 3] clips (normal times 0.3, numpy
  seed 0); the forward to the last pooled feature, and the forward with
  every parameter's gradient of the feature's sum.
* ``block``: one stage-3 ``Bottleneck`` (1024 -> 256 -> 1024) of each type
  A, B, C with BN and B with GN, chained 6 times with the same weights on
  [16, 1024, 2, 7, 7] (NCDHW), ms per block, and 36 times that.
* ``micro``: the stage-3 (1, 3, 3) convolution at 7 x 7 (256 -> 256, no
  bias) as cuDNN runs it (``ops/layers.Conv3d``, NCDHW), the same as an
  im2col product (the 9 taps of the padded NDHWC input side by side, times
  the [9 C, C] kernel, ``torch.matmul``: the JAX script computes it outside
  any Pallas kernel), and the 1 x 1 x 1 reduce (1024 -> 256) as a product;
  inputs unit normal, kernels normal times 0.03, numpy seed 1.  The im2col
  product is held against the convolution's output (``IM2COL_TOLERANCE``);
  a failed hold raises.

Each time is the mean of ``--repeats`` calls (CUDA events, the L2 flushed
before each), the convolution and its im2col product in turns.  Prints one
line per reading and a last JSON line with the card's name and power
limit.
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
FRAMES, SIZE = 16, 112
FULL_STAGES = ((64, 3), (128, 8), (256, 36))
N_REP = 6       # chained stage-3 blocks per timed call
STAGE3_BLOCKS = 36
# The im2col product against the convolution, bf16, as (rtol, atol,
# mean_tol) (``flash_attention.agreement``): both are float32 sums of the
# same 2304 bf16 products rounded once to bf16; the sums differ by their
# order (~1e-6 of the largest output), which can move the rounding by one
# ulp (at most 2^-7 of the value), and an output that cancels to near zero
# takes the sums' difference at the scale of the largest output.
IM2COL_TOLERANCE = {torch.bfloat16: (2.0 ** -7, 2.0 ** -10, 2.0 ** -8),
                    torch.float32: (1e-5, 1e-6, 1e-6)}


def report(name: str, ms: float) -> None:
    print(f"{name:46s} {ms:8.3f} ms", flush=True)


def seeded(build, seed: int = 0):
    """``build()`` with torch's CPU generator seeded (the port's init)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def grads_of(module, loss):
    """Every parameter's gradient of ``loss`` (the whole tree, as the JAX
    script returns it)."""
    return torch.autograd.grad(loss, [p for p in module.parameters() if p.requires_grad])


def encoder_stages(timer: _timing.Timer, repeats: int, batch: int, frames: int, size: int,
                   full_stages) -> dict:
    """Truncated encoders of the first 0 to all of ``full_stages``, train
    mode: ms of the forward to the last pooled feature, and of the forward
    with every parameter's gradient of its sum."""
    from sap3d_tpu_torch.models.p3d import P3DEncoder

    x = torch.from_numpy((np.random.default_rng(0).normal(size=(batch, frames, size, size, 3))
                          .astype(np.float32) * 0.3)).to(timer.device)
    x = x.permute(0, 4, 1, 2, 3).contiguous()  # the model's NCDHW
    out = {}
    for n_stages in range(len(full_stages) + 1):
        stages = full_stages[:n_stages]
        enc = seeded(lambda: P3DEncoder(dtype=torch.bfloat16, stages=stages)).to(timer.device)
        enc.train()
        last = f"pool{len(stages) + 1}" if stages else "pool1"

        def fwd(enc=enc, last=last):
            with torch.no_grad():
                return enc(x)[last]

        def fwdbwd(enc=enc, last=last):
            return grads_of(enc, enc(x)[last].float().sum())

        out[n_stages] = {"forward_ms": timer.ms(fwd, repeats),
                         "fwd_bwd_ms": timer.ms(fwdbwd, repeats)}
        report(f"encoder[{n_stages} stages] fwd", out[n_stages]["forward_ms"])
        report(f"encoder[{n_stages} stages] fwd+bwd", out[n_stages]["fwd_bwd_ms"])
        del enc
    return out


def one_block(timer: _timing.Timer, repeats: int, batch: int, norm: str = "bn",
              st: str = "B", n_rep: int = N_REP, planes: int = 256, spatial=(2, 7, 7)) -> dict:
    """ms per block of ``n_rep`` chained stage-3 bottlenecks (one set of
    weights), forward and forward + backward."""
    from sap3d_tpu_torch.models.p3d import BLOCK_EXPANSION, Bottleneck

    width = planes * BLOCK_EXPANSION
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(batch,) + spatial + (width,))
                          .astype(np.float32) * 0.3)).to(timer.device, torch.bfloat16)
    x = x.permute(0, 4, 1, 2, 3).contiguous()
    blk = seeded(lambda: Bottleneck(width, planes, st, norm_mode=norm,
                                    dtype=torch.bfloat16)).to(timer.device)
    blk.train()

    def chain():
        h = x
        for _ in range(n_rep):
            h = blk(h)
        return h

    def fwd():
        with torch.no_grad():
            return chain()

    ms_f = timer.ms(fwd, repeats) / n_rep
    ms_fb = timer.ms(lambda: grads_of(blk, chain().float().sum()), repeats) / n_rep
    report(f"stage3 block [{st},{norm}] fwd (x{STAGE3_BLOCKS}={ms_f * STAGE3_BLOCKS:.1f})", ms_f)
    report(f"stage3 block [{st},{norm}] fwd+bwd (x{STAGE3_BLOCKS}="
           f"{ms_fb * STAGE3_BLOCKS:.1f})", ms_fb)
    return {"forward_ms": ms_f, "fwd_bwd_ms": ms_fb,
            "forward_x36_ms": ms_f * STAGE3_BLOCKS, "fwd_bwd_x36_ms": ms_fb * STAGE3_BLOCKS}


def micro_arrays(batch: int, spatial=(2, 7, 7), c: int = 256, c_in: int = 1024):
    """The JAX script's draws (numpy seed 1): xs [B, D, H, W, c], xin [B, D,
    H, W, c_in] unit normal, w_s [1, 3, 3, c, c] and w_r [c_in, c] normal
    times 0.03."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(batch,) + spatial + (c,))
    xin = rng.normal(size=(batch,) + spatial + (c_in,))
    w_s = rng.normal(size=(1, 3, 3, c, c)) * 0.03
    w_r = rng.normal(size=(c_in, c)) * 0.03
    return xs, xin, w_s, w_r


def conv_s_layer(w_s: np.ndarray, dtype, device):
    """``ops/layers.Conv3d`` (1, 3, 3), no bias, carrying the DHWIO
    ``w_s``."""
    from sap3d_tpu_torch.ops.layers import Conv3d

    c_in, c_out = w_s.shape[3:]
    layer = Conv3d(c_in, c_out, w_s.shape[:3], use_bias=False, dtype=dtype)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(np.ascontiguousarray(w_s.transpose(4, 3, 0, 1, 2))))
    return layer.to(device)


def conv_s_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The (1, 3, 3) SAME convolution of NDHWC ``x`` with the DHWIO ``w``
    as one product: the 9 taps of the input padded by 1 in H and W, side by
    side on the channel axis, times ``w`` as [9 C_in, C_out]."""
    h, wd = x.shape[2:4]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    taps = torch.cat([xp[:, :, i:i + h, j:j + wd, :] for i in range(3) for j in range(3)], dim=-1)
    return torch.matmul(taps, w.reshape(9 * w.shape[3], w.shape[4]))


def hold_im2col(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The im2col product's output against the convolution's; raises if it
    exceeds ``IM2COL_TOLERANCE``."""
    from sap3d_tpu_torch.ops.cuda.flash_attention import agreement

    a = agreement(got, want, IM2COL_TOLERANCE)
    print(f"im2col against conv_s: max_abs_err {a['max_abs_err']:.3e}, excess "
          f"{a['excess']:.3f} (limits {IM2COL_TOLERANCE[want.dtype]})", flush=True)
    if not (a["finite"] and a["excess"] <= 1):
        raise AssertionError(f"the im2col product disagrees with the convolution: {a}")
    return dict(max_abs_err=a["max_abs_err"], excess=a["excess"])


def micro_convs(timer: _timing.Timer, repeats: int, batch: int, spatial=(2, 7, 7),
                c: int = 256, c_in: int = 1024, dtype=torch.bfloat16) -> dict:
    xs_np, xin_np, w_s_np, w_r_np = micro_arrays(batch, spatial, c, c_in)
    dev = timer.device
    xs, xin = (torch.from_numpy(a).to(dev, dtype) for a in (xs_np, xin_np))
    w_s, w_r = (torch.from_numpy(a).to(dev, dtype) for a in (w_s_np, w_r_np))
    layer = conv_s_layer(w_s_np, dtype, dev)
    xs_ncdhw = xs.permute(0, 4, 1, 2, 3).contiguous()

    def conv():
        with torch.no_grad():
            return layer(xs_ncdhw)

    check = hold_im2col(conv_s_im2col(xs, w_s), conv().permute(0, 2, 3, 4, 1))
    ms = timer.alternating({"conv_s (1,3,3)@7x7 cuDNN conv": conv,
                            "conv_s im2col product": lambda: conv_s_im2col(xs, w_s)}, repeats)
    ms["reduce 1x1x1 product 1024->256"] = timer.ms(lambda: torch.matmul(xin, w_r), repeats)
    for name, t in ms.items():
        report(name, t)
    return {"ms": ms, "im2col_check": check}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("which", nargs="?", default="all", choices=("all", "stages", "block", "micro"))
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    out = {}
    if args.which in ("all", "stages"):
        out["stages"] = encoder_stages(timer, args.repeats, BATCH, FRAMES, SIZE, FULL_STAGES)
    if args.which in ("all", "block"):
        out["blocks"] = {f"{st},bn": one_block(timer, args.repeats, BATCH, st=st)
                         for st in "ABC"}
        out["blocks"]["B,gn"] = one_block(timer, args.repeats, BATCH, norm="gn")
    if args.which in ("all", "micro"):
        out["micro"] = micro_convs(timer, args.repeats, BATCH)
    return _timing.emit("profile_encoder", device, dict(
        batch=BATCH, dtype="bfloat16", repeats=args.repeats, **out))


if __name__ == "__main__":
    main()
