"""Train and eval steps.  Counterpart of ``sap3d_tpu/train/steps.py``.

In PyTorch the parameters and BN statistics live in the module and the Adam
moments in the optimizer, so a step function closes over them and takes the
batch only:

* ``make_train_step(state)(frames, targets, generator)`` runs the model in
  train mode (batch statistics, dropout drawn from ``generator``), the
  summed smooth-L1 loss, the backward, the Adam update and the step counter,
  and returns the loss (a 0-d float32 tensor on the device, not
  synchronized).  The BN running statistics move inside the forward.
* ``make_eval_step(model)(frames)`` is the eval-mode forward under
  ``torch.inference_mode()``: ``[B, T, H, W, 3]`` -> ``[B, T, H, W]``.

Each step sets its module's mode when called, so a trainer can interleave
them.  The JAX package's ``make_multi_train_step`` fuses K steps into one
dispatch with ``lax.scan``; eager PyTorch has no dispatch to save that way
(K steps in one call would be the same loop of K single steps), so it has
no counterpart here and the trainer runs single steps.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from sap3d_tpu_torch.ops.layers import smooth_l1_loss
from sap3d_tpu_torch.train.state import TrainState


def loss_fn_saliency(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """smooth_l1(pred, target, 1, 1, sigma=1) summed over every element;
    ``pred`` [B, T, H, W, 1] or [B, T, H, W], ``target`` [B, T, H, W]."""
    if pred.shape[-1] == 1 and pred.dim() == target.dim() + 1:
        pred = pred.squeeze(-1)
    return smooth_l1_loss(pred, target, 1.0, 1.0, sigma=1.0)


def make_train_step(state: TrainState
                    ) -> Callable[[torch.Tensor, torch.Tensor, torch.Generator | None],
                                  torch.Tensor]:
    model, opt = state.model, state.optimizer

    def step(frames: torch.Tensor, targets: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        model.train()
        loss = loss_fn_saliency(model(frames, generator), targets)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        state.step += 1
        return loss.detach()

    return step


def make_eval_step(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval-mode forward.  A model built with ``bn_reference_quirk``
    normalizes its bottlenecks with batch statistics and leaves every buffer
    as it was: the JAX eval step computes that update and discards it."""

    def step(frames: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(frames).squeeze(-1)

    return step


# The JAX package's two names differ only in how the variables are passed;
# here both are the same eval-mode forward.
make_forward_fn = make_eval_step
