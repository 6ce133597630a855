"""Read how far the micro train step's float32 gradient moves between runs,
of a checkout of the port: the reading that the card test
``test_micro_train_step_kernel_path_matches_plain_path`` holds (the kernel
path's whole gradient against the same step with B3's plain version, limit
1e-4), under cuDNN's default and its deterministic algorithms, and B3's own
spread on the step's tensors.

    python sap3d_tpu_torch/scripts/train_step_spread.py --root <checkout> [--runs 8]
        [--label L] [--tf32]

``--root`` names the checkout whose ``sap3d_tpu_torch`` is imported; run the
file by its path, not with ``-m``.  Comparing two commits: unpack each
(``git archive``) and run both in one command.

The test's step: p3d_micro_sa at 32 px, batch 2, float32, dropout 0, every
gamma 1, inputs from seed 0 (two sites, x_2_2 and x_1_3, on B2 + B3), with
TF32 off in cuDNN and in matmuls, as the card tests set it (``--tf32``
leaves PyTorch's default, TF32 convolutions).  Per
cuDNN setting, ``--runs`` times: the kernel path's gradient and the same
with B3's plain version; the relative L2 distance between the two (the
test's reading), and each path's distance from its own first run.  Then B3
alone: its inputs at each site captured in one step and B3 run ``--runs``
times on them, the largest relative L2 distance of dq, dk, dv from the first
run.  Prints one line per run and a last JSON line with the card's name and
power limit.
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True, help="checkout whose sap3d_tpu_torch is read")
    p.add_argument("--label", default=None)
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--tf32", action="store_true", help="leave cuDNN's TF32 convolutions on")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
    from sap3d_tpu_torch.train.steps import loss_fn_saliency

    if not torch.cuda.is_available():
        raise SystemExit("train_step_spread: needs a GPU")
    if not os.path.abspath(fb.__file__).startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {fb.__file__}, not the checkout at {args.root}")
    label = args.label or args.root
    card = card_line()
    if not args.tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = build_model("p3d_micro_sa", dtype=torch.float32, device=dev, seed=0,
                        dropout_rate=0.0)
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.fill_(1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 16, 32, 32, 3, device=dev, generator=gen) * 0.5
    y = torch.rand(2, 16, 32, 32, device=dev, generator=gen)
    kernel_b3 = attention.flash_backward

    def gradient(backward):
        attention.flash_backward = backward
        try:
            model.train()
            model.zero_grad(set_to_none=True)
            loss_fn_saliency(model(x), y).backward()
            torch.cuda.synchronize()
        finally:
            attention.flash_backward = kernel_b3
        return torch.cat([p.grad.flatten() for p in model.parameters()])

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    res = {"card": card, "label": label, "tf32": torch.backends.cudnn.allow_tf32}
    was = torch.backends.cudnn.deterministic
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        key = "cudnn_deterministic" if deterministic else "cudnn_default"
        rows, first = [], None
        for i in range(args.runs):
            g_k, g_s = gradient(kernel_b3), gradient(fb.flash_backward_reference)
            first = first or (g_k, g_s)
            rows.append(dict(test_reading=rel(g_k, g_s), kernel_vs_first=rel(g_k, first[0]),
                             plain_b3_vs_first=rel(g_s, first[1])))
            print(f"[{label}] {key} run {i}: kernel path against plain B3 "
                  f"{rows[-1]['test_reading']:.3e} (the test's limit 1e-4); kernel path from its "
                  f"first run {rows[-1]['kernel_vs_first']:.3e}, plain-B3 path from its first "
                  f"run {rows[-1]['plain_b3_vs_first']:.3e}", flush=True)
        res[key] = rows
    torch.backends.cudnn.deterministic = was

    captured = []

    def spy(*a, **kw):
        captured.append(([t.detach().clone() for t in a], kw))
        return kernel_b3(*a, **kw)

    gradient(spy)
    res["b3"] = []
    for inputs, kw in captured:
        first = kernel_b3(*inputs, **kw)
        spread = [0.0, 0.0, 0.0]
        for _ in range(args.runs):
            again = kernel_b3(*inputs, **kw)
            spread = [max(s, rel(a, f)) for s, a, f in zip(spread, again, first)]
        q, k, v = inputs[:3]
        shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2])
        res["b3"].append(dict(shape=shape, spread=spread))
        print(f"[{label}] B3 at (B, Nq, Nk, d, C) {shape}: largest relative L2 of a run from "
              f"the first over {args.runs} runs, dq {spread[0]:.3e}, dk {spread[1]:.3e}, dv "
              f"{spread[2]:.3e}", flush=True)
    print(f"[{label}] {card}", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
