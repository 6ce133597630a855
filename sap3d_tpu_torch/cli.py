"""Command-line interface of the port: the ``predict`` subcommand.

Counterpart of ``sap3d_tpu/cli.py``'s ``predict``, with the same flags plus
``--device`` (default ``cuda``).  ``--checkpoint`` names a port weights file
(``torch.save`` of the model's ``state_dict``; ``interop/flax_bridge.py``
makes one from flax weights) under ``--model-dir`` or as a path.
``--tf-checkpoint`` waits for the interop slice (ROADMAP A.12); the other
subcommands port with the trainer (ROADMAP A.5-A.8).

    python -m sap3d_tpu_torch.cli predict --checkpoint weights.pt \\
        --data <frames root> --out <output root> [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any


def parse_bool(v: Any) -> bool:
    """Strict bool parsing (a copy of ``sap3d_tpu.core.config.parse_bool``)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y"):
        return True
    if s in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


def _add_common_model_flags(p: argparse.ArgumentParser, dtype: str = "bfloat16"):
    p.add_argument("--structure", type=str, default="unet++",
                   help="model name or alias (unet++, unet++nonsa, p3d_micro_sa, ...)")
    p.add_argument("--dtype", type=str, default=dtype,
                   help=f"compute dtype: bfloat16/float32 (default {dtype})")
    p.add_argument("--normalization", type=str, default=None,
                   help="ignored; BN/GN is keyed by the model variant "
                        "(kept for reference CLI compat)")
    p.add_argument("--SA", type=parse_bool, default=True,
                   help="kept for reference CLI compat (variant-keyed)")


def _weights_path(checkpoint: str, model_dir: str) -> str:
    under = os.path.join(model_dir, checkpoint)
    return under if os.path.exists(under) else checkpoint


def cmd_predict(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch predict")
    _add_common_model_flags(p)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="port weights file (torch.save of the state_dict), "
                        "under --model-dir or a path")
    p.add_argument("--model-dir", type=str, default="./model")
    p.add_argument("--tf-checkpoint", type=str, default=None,
                   help="not ported yet (ROADMAP A.12, TF interop)")
    p.add_argument("--data", type=str, required=True, help="video frames root")
    p.add_argument("--out", type=str, required=True, help="output root")
    p.add_argument("--batch-windows", type=int, default=16,
                   help="windows per device step")
    p.add_argument("--imagesize", type=int, default=112,
                   help="network input resolution")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)
    if (args.checkpoint is None) == (args.tf_checkpoint is None):
        p.error("exactly one of --checkpoint / --tf-checkpoint is required")
    if args.tf_checkpoint is not None:
        print("--tf-checkpoint is not ported yet (ROADMAP A.12, TF interop)",
              file=sys.stderr)
        return 2

    import torch

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    model = build_model(args.structure, dtype=args.dtype, device=args.device)
    path = _weights_path(args.checkpoint, args.model_dir)
    if not os.path.isfile(path):
        print(f"checkpoint missing: {path}", file=sys.stderr)
        return 1
    state = torch.load(path, map_location=args.device, weights_only=True)
    model.load_state_dict(state, strict=True)
    with SlidingWindowPredictor(
        make_eval_step(model), batch_windows=args.batch_windows,
        image_size=args.imagesize, device=args.device,
    ) as pred:
        n = pred.export_dataset(args.data, args.out)
    print(f"exported {n} videos")
    return 0


COMMANDS = {"predict": cmd_predict}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: sap3d_tpu_torch {{{','.join(COMMANDS)}}} [args]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
