"""One hop of ring attention at the flagship's long-clip shard shapes on the
card: the chunked plain hop against the kernel hop, forward and forward +
backward.

Counterpart of ``scripts/profile_ring_hop.py``.

    python sap3d_tpu_torch/scripts/profile_ring_hop.py [--device cuda]
        [--root <checkout>] [--repeats 10]

The ring needs a time mesh; the hop body, the work of one device between
two exchanges of keys and values, runs on one card, so its two versions
are timed at the x_1_3 site of a 128-frame clip over 8 time shards: q
[1, 25088, 16] (8 x 56 x 56 tokens, d = 128 / 8), k [1, 3136, 16], v [1,
3136, 128] (keys and values pooled by 2), bf16, unit normal from numpy
seed 0, as the JAX script draws them.

* "xla": the port's chunked hop (``ops/ring_attention._chunk_update``
  over ``RING_QUERY_CHUNK`` query rows at a time, each chunk under
  ``torch.utils.checkpoint``), the counterpart of JAX's ``xla_hop``;
* "pallas": the kernel hop (``ops/ring_attention._pallas_hop``: kernel B2
  and the hop-level merge in float32; its backward is B4, whose delta takes
  the lse cotangent of the merge), JAX's ``pallas_hop``.

Both start from the JAX script's explicit state (m = -inf, den = 0, acc =
0), not from the ring's first-hop shortcut.  The forward + backward takes
the gradients of 0.5 sum((acc / den)^2) with respect to q, k and v.  The
two hops' outputs acc / den are held to each other (``HOP_TOLERANCE``,
read as ``flash_attention.agreement`` reads a limit; JAX's script only
prints max|xla - pallas|), and each hop's gradients must be finite: from
the -inf state a merge that took exp(-inf - -inf) would make them NaN.
A failed hold raises.  Prints one line per hop and a last JSON line with
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

# (B, Nq, Nk, d, C)
SHAPE = (1, 25088, 3136, 16, 128)
# The kernel hop's o against the chunked hop's, as (rtol, atol, mean_tol)
# per input dtype.  bf16: the kernel rounds its o to bf16 before the
# float32 merge, an ulp of at most 2^-7 of the value where the chunked hop
# keeps float32, and the two round their probabilities to bf16 at other
# points (the chunked hop exp(s - m) of its chunk's max, the kernel exp(s
# - m) of its running max), a relative 2^-9 per key that averages out over
# the keys: B1's limits against its plain version (flash_attention.
# TOLERANCE), which allow two ulps.  float32: both in float32, the order of
# the sums and the exponential, as the kernel's fp32 limits.
HOP_TOLERANCE = {torch.bfloat16: (2.0 ** -6, 2.0 ** -8, 2.0 ** -7),
                 torch.float32: (1e-5, 1e-4, 1e-4)}


def xla_hop(q, k, v, m, den, acc):
    """(m, den, acc) after one chunked hop from the state (m, den, acc):
    ``_chunk_update`` on each ``RING_QUERY_CHUNK`` rows of q and of the
    state, under checkpoint where autograd records, as the ring runs it."""
    from sap3d_tpu_torch.ops.ring_attention import (
        RING_QUERY_CHUNK,
        _checkpointed,
        _chunk_update,
    )

    def chunks(t):
        return t.split(RING_QUERY_CHUNK, dim=1)

    parts = [_checkpointed(_chunk_update, qc, k, v, mc, lc, oc)
             for qc, mc, lc, oc in zip(chunks(q), chunks(m), chunks(den), chunks(acc))]
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def pallas_hop(q, k, v, m, den, acc):
    """(m, den, acc) after one kernel hop from the state (m, den, acc)."""
    from sap3d_tpu_torch.ops.ring_attention import _pallas_hop

    return _pallas_hop(q, k, v, m, den, acc)


HOPS = {"xla": xla_hop, "pallas": pallas_hop}


def hop_inputs(shape, dtype: torch.dtype, device: torch.device, seed: int = 0):
    """q, k, v unit normal from numpy ``seed`` in the JAX script's order,
    and the explicit start state (m = -inf, den = 0, acc = 0) in float32."""
    b, nq, nk, d, c = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).to(device, dtype)
               for s in ((b, nq, d), (b, nk, d), (b, nk, c)))
    f32 = dict(dtype=torch.float32, device=device)
    return q, k, v, torch.full((b, nq), -torch.inf, **f32), torch.zeros((b, nq), **f32), \
        torch.zeros((b, nq, c), **f32)


def hop_output(hop, args):
    _, den, acc = hop(*args)
    return acc / den[..., None]


def hop_grads(hop, args):
    """(dq, dk, dv) of 0.5 sum((acc / den)^2) after one hop."""
    q, k, v = (t.detach().requires_grad_() for t in args[:3])
    out = hop_output(hop, (q, k, v) + tuple(args[3:]))
    return torch.autograd.grad(0.5 * out.square().sum(), (q, k, v))


def check_hops(args, tolerance=HOP_TOLERANCE) -> dict:
    """The kernel hop's output against the chunked hop's under
    ``tolerance[q.dtype]``, and both hops' gradients finite; raises if
    either fails."""
    from sap3d_tpu_torch.ops.cuda.flash_attention import agreement

    with torch.no_grad():
        want, got = (hop_output(HOPS[name], args) for name in ("xla", "pallas"))
    dtype = args[0].dtype
    hold = agreement(got, want, {want.dtype: tolerance[dtype]})
    finite = {name: all(bool(torch.isfinite(g).all()) for g in hop_grads(hop, args))
              for name, hop in HOPS.items()}
    print(f"hop output max|xla-pallas| = {hold['max_abs_err']:.3e}, mean "
          f"{hold['mean_abs_err']:.3e}, excess {hold['excess']:.3f} (limits "
          f"{tolerance[dtype]}); gradients finite from the -inf state: {finite}", flush=True)
    if not (hold["finite"] and hold["excess"] <= 1):
        raise AssertionError(f"the kernel hop disagrees with the chunked hop: {hold}")
    if not all(finite.values()):
        raise AssertionError(f"a hop's gradient is not finite from the -inf state: {finite}")
    return dict(max_abs_err=hold["max_abs_err"], mean_abs_err=hold["mean_abs_err"],
                excess=hold["excess"], grads_finite=finite)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    inputs = hop_inputs(SHAPE, torch.bfloat16, device)
    before = _timing.launch_counts()
    fwd = timer.alternating({name: lambda hop=hop: hop(*inputs) for name, hop in HOPS.items()},
                            args.repeats)
    fwd_bwd = timer.alternating({name: lambda hop=hop: hop_grads(hop, inputs)
                                 for name, hop in HOPS.items()}, args.repeats)
    for name in HOPS:
        print(f"hop[{name:6s}]  fwd {fwd[name]:7.3f} ms   fwd+bwd {fwd_bwd[name]:7.3f} ms",
              flush=True)
    check = check_hops(inputs)
    return _timing.emit("profile_ring_hop", device, dict(
        shape=dict(zip(("b", "nq", "nk", "d", "c"), SHAPE)), dtype="bfloat16",
        repeats=args.repeats, forward_ms=fwd, fwd_bwd_ms=fwd_bwd, check=check,
        launches=_timing.launches_since(before)))


if __name__ == "__main__":
    main()
