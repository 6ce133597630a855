"""Train state: the model (parameters and BN statistics), its optimizer and
the step counter.

Counterpart of ``sap3d_tpu/train/state.py``.  The optimizer is
``torch.optim.Adam(lr)`` (betas 0.9/0.999, eps 1e-8), the same update as
``optax.adam``: ``lr * m_hat / (sqrt(v_hat) + eps)``.  Weight decay is the
JAX package's coupled L2 on conv kernels only: torch Adam's
``weight_decay`` adds ``wd * p`` to the gradient before the moments, which
is ``optax.add_decayed_weights`` ahead of ``scale_by_adam``, so kernels form
one parameter group with ``weight_decay`` and every other parameter (biases,
BN scales, ``gamma``) a group with 0.

Under tensor parallel (``core/sharding_rules.apply_state_sharding``) the
model holds this rank's slices of the wide kernels and the optimizer is
built over them, so its ``exp_avg``/``exp_avg_sq`` have the slices' shapes
(the JAX package's ``mu``/``nu`` sharded as their parameter);
``sharding`` records the state's ``StateSharding``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    sharding: Any = None

    def load_optimizer_state(self, by_name: dict[str, dict[str, torch.Tensor]]) -> None:
        """Set the optimizer's per-parameter state from ``{parameter name:
        state}`` (``interop/flax_bridge.optimizer_state_from_optax``).  Each
        moment takes its parameter's shape: a sharded kernel's slice under
        tensor parallel; another shape raises."""
        params = dict(self.model.named_parameters())
        bad = [(name, k, tuple(t.shape), tuple(params[name].shape))
               for name, entry in by_name.items() for k, t in entry.items()
               if k in ("exp_avg", "exp_avg_sq") and t.shape != params[name].shape]
        if bad:
            raise ValueError(f"moments whose shape is not their parameter's: {bad[:5]}")
        order = [p for group in self.optimizer.param_groups for p in group["params"]]
        index = {id(p): i for i, p in enumerate(order)}
        sd = self.optimizer.state_dict()
        sd["state"] = {index[id(params[name])]: entry for name, entry in by_name.items()}
        # load_state_dict puts each tensor on its parameter's device (the step
        # count too where the update is fused)
        self.optimizer.load_state_dict(sd)


def is_kernel(name: str) -> bool:
    """True for conv kernels, the leaves the JAX package's ``kernel_mask``
    selects."""
    return name.split(".")[-1] == "kernel"


def make_optimizer(model: nn.Module, lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam, with coupled L2 on kernels only when ``weight_decay`` > 0.
    On CUDA parameters the update runs fused (one multi-tensor kernel per
    step; the same arithmetic as the default implementation) and
    ``capturable``, so that a CUDA graph may hold the step
    (``train/steps.CapturedMultiStep``): fused Adam keeps its step counts on
    the device either way and computes the same update, and the flag only
    lets a capture take it."""
    named = list(model.named_parameters())
    fused = all(p.is_cuda for _, p in named)
    if weight_decay <= 0:
        return torch.optim.Adam([p for _, p in named], lr=lr, fused=fused, capturable=fused)
    return torch.optim.Adam([
        {"params": [p for n, p in named if is_kernel(n)], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not is_kernel(n)], "weight_decay": 0.0},
    ], lr=lr, fused=fused, capturable=fused)


def create_train_state(model: nn.Module, lr: float = 1e-4,
                       weight_decay: float = 0.0) -> TrainState:
    """The state of a freshly built model (``models/registry.build_model``
    makes its parameters from a seed) at step 0."""
    return TrainState(model=model, optimizer=make_optimizer(model, lr, weight_decay))
