"""Rank functions of ``tests/test_torch_data_parallel.py`` and of the card
tests of ``tests/test_torch_cuda.py``.

Each runs in one process of a data mesh that
``sap3d_tpu_torch.core.mesh.launch`` starts (2 gloo ranks on the CPU in
the data-parallel tests).  Spawned ranks start from a fresh import of this
module, so it imports nothing of JAX.
"""

import json
import os

import numpy as np
import torch

from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.ops.layers import set_data_group
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import DataParallelForward, make_eval_step, make_train_step

LR, WEIGHT_DECAY = 1e-4, 1e-3


def micro_model(weights, dtype=torch.float32, quirk: bool = False, device="cpu"):
    """``p3d_micro_sa`` (dropout 0) carrying ``weights``; float64 runs in
    float64 throughout (its attention on the plain path)."""
    m = treg.build_model("p3d_micro_sa", device=device, dropout_rate=0.0, dtype=dtype,
                         bn_reference_quirk=quirk)
    m.load_state_dict(weights, strict=True)
    return m.double() if dtype == torch.float64 else m


def moments(state) -> dict:
    """The Adam state by parameter name (``TrainState.load_optimizer_state``'s
    layout)."""
    opt = state.optimizer
    return {n: {k: v.clone() for k, v in opt.state[p].items()}
            for n, p in state.model.named_parameters()}


def parity_rank(group, weights, batches, skewed):
    """This rank's readings: (a) two float32 data-parallel steps on
    ``batches`` (global batch, this rank's rows): the global loss, the
    parameters and buffers, and the Adam state after each, and the first
    step's summed gradient (read before the update, it stays in ``.grad``);
    (b) float64 steps on ``skewed`` (``batches[0]``'s frames with rank 1's
    rows scaled and shifted, so that the halves differ): the summed
    gradient, and the control with per-rank BN statistics; on rank 0 the
    one-device gradients of the whole batches, float32 on ``batches[0]`` and
    float64 on ``skewed``; (c) rank 0: the quirk model's eval output over the
    group."""
    torch.set_num_threads(2)
    b = batches[0][0].shape[0] // group.world_size
    rows = slice(group.rank * b, (group.rank + 1) * b)
    out = {"steps": []}

    model = micro_model(weights)
    state = create_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
    step = make_train_step(state, group)
    for frames, targets in batches:
        loss = step(torch.from_numpy(frames[rows]), torch.from_numpy(targets[rows]))
        out["steps"].append(dict(loss=loss.item(), moments=moments(state),
                                 state={k: v.clone() for k, v in model.state_dict().items()}))
        if "summed32" not in out:  # the first step's summed gradient
            out["summed32"] = dict(loss=loss.item(), grads={
                n: p.grad.clone() for n, p in model.named_parameters()})

    runs = [(dtype, name, frames, g, global_bn)
            for dtype, name, frames, g, global_bn in (
                (torch.float32, "one_device32", batches[0][0], None, True),
                (torch.float64, "summed", skewed, group, True),
                (torch.float64, "per_rank_bn", skewed, group, False),
                (torch.float64, "one_device", skewed, None, True))
            if g is not None or group.is_main]
    for dtype, name, frames, g, global_bn in runs:
        model = micro_model(weights, dtype)
        step = make_train_step(create_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY), g)
        if not global_bn:
            set_data_group(model, None)
        x, t = (torch.from_numpy(a).to(dtype) for a in (frames, batches[0][1]))
        loss = step(*(x, t) if g is None else (x[rows], t[rows]))
        out[name] = dict(loss=loss.item(),
                         grads={n: p.grad.clone() for n, p in model.named_parameters()})

    quirk = micro_model(weights, quirk=True)
    set_data_group(quirk, group)
    forward = DataParallelForward(make_eval_step(quirk), group)
    if group.is_main:
        out["quirk"] = forward(batches[0][0]).numpy()
        forward.stop()
    else:
        forward.serve()
    return out


def card_rank(group, weights, frames, targets):
    """One data-parallel step on the card (cuDNN's deterministic
    algorithms), in float32 (the kernels: B2 and B3 per site) and in
    float64 (the plain path): the global loss, this rank's summed gradient
    and state on the host, and the B2 and B3 launches of the step."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    b = frames.shape[0] // group.world_size
    rows = slice(group.rank * b, (group.rank + 1) * b)
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = micro_model(weights, dtype, device=group.device)
        step = make_train_step(create_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY),
                               group)
        before = fa.flash_forward_lse.launches, fb.flash_backward.launches
        loss = step(*(torch.from_numpy(a[rows]).to(group.device, dtype)
                      for a in (frames, targets)))
        torch.cuda.synchronize(group.device)
        out[str(dtype)] = dict(
            loss=loss.item(),
            launches=(fa.flash_forward_lse.launches - before[0],
                      fb.flash_backward.launches - before[1]),
            grads={n: p.grad.cpu() for n, p in model.named_parameters()},
            state={k: v.cpu() for k, v in model.state_dict().items()})
    return out


def failing_rank(group):
    """Rank 1 raises; rank 0 waits for it at a barrier."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    group.barrier()
    return np.zeros(1)


# Where ``recorded_train`` writes each rank's group (an environment
# variable, which the ranks a launcher spawns inherit).
RANKS_ENV = "SAP3D_TEST_RANKS_DIR"


def recorded_train(group, *args):
    """``cli._train`` as one rank, after writing the rank's group (rank,
    world size, backend, device) to ``$SAP3D_TEST_RANKS_DIR/rank<r>.json``:
    the backend the rank itself took."""
    from sap3d_tpu_torch import cli

    with open(os.path.join(os.environ[RANKS_ENV], f"rank{group.rank}.json"), "w") as f:
        json.dump(dict(rank=group.rank, world_size=group.world_size, backend=group.backend,
                       device=str(group.device)), f)
    cli._train(group, *args)


def recorded_cli(argv) -> int:
    """``python -m sap3d_tpu_torch.cli <argv>`` with each rank's group
    recorded (``recorded_train`` in place of ``cli._train``, pickled to the
    ranks by this module's path)."""
    from sap3d_tpu_torch import cli

    cli._train = recorded_train
    return cli.main(argv)
