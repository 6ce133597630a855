"""Per-site timing of the flagship's self-attention on the card: the kernel
route against the plain path, forward and forward + backward.

Counterpart of ``scripts/profile_attention.py``.

    python sap3d_tpu_torch/scripts/profile_attention.py [--device cuda]
        [--root <checkout>] [--repeats 10]

The flagship (p3d_unetplusplus_ds) has four self-attention sites; each one's
token attention runs alone at batch 16 in bf16 on q, k, v drawn as the JAX
script draws them (numpy seed 0, unit normal).  A site's route is
``ops/attention.attention_route``'s, in eval mode for the forward and in
train mode for the forward + backward.  Where it is "flash", the kernel
forward is ``flash_attend`` under ``no_grad`` (kernel B1) and the forward +
backward is autograd through ``flash_attend``'s Function (B2, then B3);
beside them ``attend_tokens``, the plain path, timed in turns with them
(``_timing.Timer.alternating``).  The forward + backward takes the
gradients of the quadratic loss 0.5 sum(o^2) with respect to q, k and v,
as the JAX script does.  Before the timing each kernel's output at the
site is held against its plain version under its module's ``TOLERANCE``
(``flash_attention.agreement``): B1's o, B2's o and lse, and B3's dq, dk,
dv (dv also row by row) given B2's o and lse and the quadratic loss's
cotangent; a hold that fails raises.  Prints one line per site and a last
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing

B = 16
# (name, (D, H, W), C, keys and values pooled by 2)
SITES = [
    ("x_4_0", (1, 7, 7), 1024, False),
    ("x_3_1", (2, 14, 14), 512, False),
    ("x_2_2", (4, 28, 28), 256, False),
    ("x_1_3", (8, 56, 56), 128, True),
]


def site_inputs(rng: np.random.Generator, dhw, c: int, sub: bool, batch: int,
                dtype: torch.dtype, device: torch.device):
    """q [B, Nq, C/8], k [B, Nk, C/8], v [B, Nk, C], unit normal from
    ``rng`` in the JAX script's order; Nk = Nq / 8 when pooled."""
    inter = max(1, c // 8)
    nq = int(np.prod(dhw))
    nk = nq // 8 if sub else nq
    return tuple(torch.from_numpy(rng.normal(size=shape)).to(device, dtype)
                 for shape in ((batch, nq, inter), (batch, nk, inter), (batch, nk, c)))


def quadratic_grads(attend, q, k, v):
    """(dq, dk, dv) of 0.5 sum(attend(q, k, v)^2), the loss in float32."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = attend(q, k, v)
    return torch.autograd.grad(0.5 * o.float().square().sum(), (q, k, v))


def hold_kernels(name: str, q, k, v, routes: dict) -> dict:
    """Where ``routes`` take the kernels: B1's o (the forward route), B2's
    o and lse and B3's dq, dk, dv given B2's o and lse and the quadratic
    loss's cotangent, o itself (the train route), against their plain
    versions; raises if any exceeds its limits."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    ref_o, ref_lse = fa.flash_forward_lse_reference(q, k, v)
    out = {}
    if routes["forward"] == "flash":
        out["B1 o"] = fa.agreement(fa.flash_attend_tokens(q, k, v), ref_o)
    if routes["train"] == "flash":
        o, lse = fa.flash_forward_lse(q, k, v)
        out["B2 o"] = fa.agreement(o, ref_o)
        out["B2 lse"] = fa.agreement(lse, ref_lse, fa.LSE_TOLERANCE)
        got = fb.flash_backward(q, k, v, o, lse, o)
        want = fb.flash_backward_reference(q, k, v, o, lse, o)
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            out[f"B3 {grad}"] = fa.agreement(
                g, w, fb.TOLERANCE, fb.DV_ROW_TOLERANCE if grad == "dv" else None)
    for label, a in out.items():
        print(f"  [hold] {name} {label}: max_abs_err {a['max_abs_err']:.3e}, "
              f"excess {a['excess']:.3f}", flush=True)
    bad = [label for label, a in out.items() if not (a["finite"] and a["excess"] <= 1)]
    if bad:
        raise AssertionError(f"{name}: the kernels disagree with their plain versions: {bad}")
    return {label: dict(max_abs_err=a["max_abs_err"], excess=a["excess"])
            for label, a in out.items()}


def profile_site(timer: _timing.Timer, rng, name: str, dhw, c: int, sub: bool,
                 batch: int, repeats: int, dtype=torch.bfloat16) -> dict:
    """One site's routes, holds and times (ms): kernel and plain forward and
    forward + backward where the routes take the kernels, else plain."""
    from sap3d_tpu_torch.ops import attention as ta

    q, k, v = site_inputs(rng, dhw, c, sub, batch, dtype, timer.device)
    (_, nq, d), (nk, _) = q.shape, v.shape[1:]
    routes = {"forward": ta.attention_route(nq, nk, d, c, dtype, train=False),
              "train": ta.attention_route(nq, nk, d, c, dtype, train=True)}
    row = dict(nq=nq, nk=nk, d=d, c=c, routes=routes)
    if "flash" in routes.values():
        row["holds"] = hold_kernels(name, q, k, v, routes)

    def forward(attend):
        def call():
            with torch.no_grad():
                return attend(q, k, v)
        return call

    fwd = {"plain": forward(ta.attend_tokens)}
    fwd_bwd = {"plain": lambda: quadratic_grads(ta.attend_tokens, q, k, v)}
    if routes["forward"] == "flash":
        fwd["kernel"] = forward(ta.flash_attend)
    if routes["train"] == "flash":
        fwd_bwd["kernel"] = lambda: quadratic_grads(ta.flash_attend, q, k, v)
    row["forward_ms"] = timer.alternating(fwd, repeats)
    row["fwd_bwd_ms"] = timer.alternating(fwd_bwd, repeats)
    times = "  ".join(
        f"{path}" + (f" fwd {row['forward_ms'][path]:8.3f} ms" if path in fwd else "")
        + (f" f+b {row['fwd_bwd_ms'][path]:8.3f} ms" if path in fwd_bwd else "")
        for path in ("kernel", "plain") if path in fwd or path in fwd_bwd)
    print(f"{name:7s} nq={nq:6d} nk={nk:5d} d={d:3d} c={c:4d} route(eval)={routes['forward']} "
          f"route(train)={routes['train']}  {times}", flush=True)
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    timer = _timing.Timer(device)
    rng = np.random.default_rng(0)
    before = _timing.launch_counts()
    sites = {name: profile_site(timer, rng, name, dhw, c, sub, B, args.repeats)
             for name, dhw, c, sub in SITES}
    return _timing.emit("profile_attention", device, dict(
        batch=B, dtype="bfloat16", repeats=args.repeats, sites=sites,
        launches=_timing.launches_since(before)))


if __name__ == "__main__":
    main()
