"""Rank functions of ``tests/test_torch_tensor_parallel.py`` and of the
card tests of ``tests/test_torch_cuda.py``.

Each runs in one process of a data x model mesh that
``sap3d_tpu_torch.core.mesh.launch`` starts (4 gloo ranks, dp2 x tp2, on
the CPU in the tensor-parallel tests).  Spawned ranks start from a fresh
import of this module, so it imports nothing of JAX.
"""

import contextlib

import numpy as np
import torch

from chip_smoke import TENSOR_PARALLEL_FAULTS, planted_tensor_parallel_fault
from sap3d_tpu_torch.core.sharding_rules import (
    gather_state,
    gather_tensors,
    make_mesh_2d,
    sharded_layers,
    state_shardings,
)
from sap3d_tpu_torch.models.p3d import P3DSaliency
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import make_train_step

LR, WEIGHT_DECAY = 1e-4, 1e-3
MIN_FEATURES = 128  # the micro models' widest kernels: JAX's tests/test_tensor_parallel.py
MICRO = dict(stages=((8, 1), (16, 1), (32, 1)), stem_features=8)
# The GN + CBAM micro model of tests/test_tensor_parallel.py
GN_CBAM = dict(decoder="gn_easy", norm_mode="gn", backbone_cbam=True, **MICRO)


def model_of(cfg: dict, weights, dtype=torch.float32, device="cpu"):
    """The port model ``cfg`` (dropout 0) carrying ``weights``, in float64
    throughout for a float64 ``dtype`` (the attention on the plain path)."""
    m = P3DSaliency(**cfg, dropout_rate=0.0, dtype=dtype)
    m.load_state_dict(weights, strict=True)
    m = m.to(device)
    return m.double() if dtype == torch.float64 else m


def local_state(state) -> dict:
    """This rank's parameters, buffers and Adam moments, as they are (the
    kernel slices sliced), on the host."""
    model, opt = state.model, state.optimizer
    out = {f"model/{k}": v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for n, p in model.named_parameters():
        for k, v in opt.state[p].items():
            out[f"optimizer/{n}/{k}"] = v.detach().cpu().clone()
    return out


def tp_step(group, cfg, weights, frames, targets, dtype, fault=None, steps=1,
            whole_state=False):
    """``steps`` tensor-parallel steps of ``cfg`` on this rank's rows of the
    global batch (``frames``, ``targets`` host arrays): the state sharded
    by ``core/sharding_rules`` at ``MIN_FEATURES`` over ``group``'s mesh,
    with ``fault`` (``TENSOR_PARALLEL_FAULTS``) planted.  Returns the
    losses, the first step's summed gradient gathered whole (and with
    ``whole_state`` the state after it, gathered whole), the state after
    the last step as this rank holds it, and the names and local shapes of
    the sharded kernels."""
    dev = group.device
    mesh = make_mesh_2d(group.data.world_size, group.model.world_size,
                        devices=[dev] * group.world_size)
    model = model_of(cfg, weights, dtype, dev)
    state = create_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
    step = make_train_step(state, group, state_shardings(state, mesh, MIN_FEATURES))
    b = frames.shape[0] // group.data.world_size
    rows = slice(group.data.rank * b, (group.data.rank + 1) * b)
    x, t = (torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev, dtype)
            for a in (frames, targets))
    out = dict(losses=[], shapes={n: tuple(layer.kernel.shape)
                                  for n, (layer, _) in sharded_layers(model).items()})
    with planted_tensor_parallel_fault(fault) if fault else contextlib.nullcontext():
        for i in range(steps):
            out["losses"].append(step(x, t).item())
            if i == 0:
                out["grads"] = {n: g.cpu().clone() for n, g in gather_tensors(
                    model, {n: p.grad for n, p in model.named_parameters()}).items()}
            if i == 0 and whole_state:  # copies: the next step moves the state in place
                whole = gather_state(state)
                out["state"] = {k: v.cpu().clone() for k, v in whole["model"].items()}
                out["moments"] = {n: {k: v.cpu().clone() for k, v in e.items()}
                                  for n, e in whole["optimizer"].items()}
    out["local"] = local_state(state)
    return out


def one_device_step(cfg, weights, frames, targets, dtype, device="cpu"):
    """The port's one-device step at the global batch: loss and gradient."""
    model = model_of(cfg, weights, dtype, device)
    step = make_train_step(create_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY))
    x, t = (torch.from_numpy(a).to(device, dtype) for a in (frames, targets))
    loss = step(x, t).item()
    return dict(loss=loss, grads={n: p.grad.cpu() for n, p in model.named_parameters()})


def parity_rank(group, micro, gn, frames, targets):
    """This rank's readings of the CPU tests: (a) ``p3d_micro_sa``
    (``micro`` = (config, weights)) in float32, two steps; (b) the same in
    float64, sound and with each planted fault, one step; (c) the GN +
    CBAM micro model (``gn``) in float32, one step.  Readings that every
    rank holds alike come back from rank 0 only."""
    torch.set_num_threads(1)
    out = {"coords": (group.data.rank, group.model.rank)}
    a = tp_step(group, *micro, frames, targets, torch.float32, steps=2, whole_state=True)
    out["local"] = a.pop("local")
    out["shapes"] = a["shapes"]
    runs = {"f32": a}
    runs["f64"] = tp_step(group, *micro, frames, targets, torch.float64)
    for fault in TENSOR_PARALLEL_FAULTS:
        runs[fault] = tp_step(group, *micro, frames, targets, torch.float64, fault=fault)
    runs["gn"] = tp_step(group, *gn, frames, targets, torch.float32)
    if group.is_main:
        out.update({k: {n: v for n, v in r.items() if n != "local"} for k, r in runs.items()})
    return out


def card_rank(group, cfg, weights, frames, targets):
    """This rank's float64 tensor-parallel steps on its card (cuDNN's
    deterministic algorithms): two sound steps, and one with each planted
    fault (``tests/test_torch_cuda.py -k tensor_parallel``)."""
    torch.backends.cudnn.deterministic = True
    out = {"sound": tp_step(group, cfg, weights, frames, targets, torch.float64, steps=2)}
    for fault in TENSOR_PARALLEL_FAULTS:
        out[fault] = tp_step(group, cfg, weights, frames, targets, torch.float64, fault=fault)
        out[fault].pop("local")
    return out
