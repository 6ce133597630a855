"""Eval-mode forward.  Counterpart of ``make_eval_step`` / ``make_forward_fn``
in ``sap3d_tpu/train/steps.py``; the train step ports in a later slice
(ROADMAP A.5).

In PyTorch the parameters and BN statistics live in the module, so the
returned function takes the frames only: ``[B, T, H, W, 3]`` on the model's
device -> saliency ``[B, T, H, W]`` float32, with running BN statistics and
no dropout, under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def make_eval_step(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    model.eval()

    def step(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(frames).squeeze(-1)

    return step


# The JAX package's two names differ only in how the variables are passed;
# here both are the same eval-mode forward.
make_forward_fn = make_eval_step
