"""Checkpoint variable inspector (reference utils/test_model.py parity).

Counterpart of ``sap3d_tpu/train/inspect_ckpt.py`` for the port's
checkpoints (``train/checkpoint.py``: a run directory's latest
``ckpt_<step>.pt``, or a weights file, ``torch.save`` of a model's
``state_dict``): the name, shape and dtype of every tensor of the model whose
name holds the filter, and the totals.  With ``--tf``, the name and shape
of every variable of a TF checkpoint (a directory or a prefix, read without
TensorFlow by ``interop/tf_bundle.py``), sorted: the reference's own view,
which filters for 'conv' (reference utils/test_model.py:17-27).

    python -m sap3d_tpu_torch.train.inspect_ckpt <run dir | weights.pt> [filter]
    python -m sap3d_tpu_torch.train.inspect_ckpt --tf <TF checkpoint> [filter]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from sap3d_tpu_torch.train.checkpoint import load_checkpoint


def inspect(path: str, name_filter: str = "") -> list[tuple[str, tuple, str]]:
    """[(name, shape, dtype)] of every tensor of the model in the checkpoint
    at ``path`` (a run directory or a weights file) whose name holds
    ``name_filter``, in the state dict's order."""
    if os.path.isdir(path):
        weights = load_checkpoint(path)["model"]
    elif os.path.isfile(path):
        weights = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no checkpoint at {path}")
    return [(name, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in weights.items() if name_filter in name]


def inspect_tf(ckpt_path: str, name_filter: str = "") -> list[tuple[str, tuple]]:
    """[(name, shape)] of every variable of the TF checkpoint at
    ``ckpt_path`` whose name holds ``name_filter``, sorted (the JAX
    package's rows)."""
    from sap3d_tpu_torch.interop.tf_import import load_tf_checkpoint

    return sorted((name, tuple(np.shape(arr)))
                  for name, arr in load_tf_checkpoint(ckpt_path).items()
                  if name_filter in name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tf_mode = "--tf" in argv
    argv = [a for a in argv if a != "--tf"]
    if not argv:
        print("usage: inspect_ckpt [--tf] <checkpoint> [filter]", file=sys.stderr)
        return 2
    name_filter = argv[1] if len(argv) > 1 else ""
    rows = (inspect_tf if tf_mode else inspect)(argv[0], name_filter)
    total = 0
    for name, shape, *dtype in rows:
        print("  ".join([name, str(shape), *dtype]))
        total += int(np.prod(shape)) if shape else 1
    print(f"-- {len(rows)} tensors, {total / 1e6:.2f}M values")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
