"""Parameter sharding rules for hybrid data + tensor parallelism.

Counterpart of ``sap3d_tpu/core/sharding_rules.py`` and of the
``state_sharding`` route of its ``make_train_step``.  The rule is the JAX
package's:

  * conv / dense kernels whose output-feature dim is >= ``min_features``
    and divisible by the ``model`` axis size are sharded on that dim;
  * their biases and norm scales stay replicated (small);
  * everything else is replicated, and Adam's moments follow their
    parameter.

The output-feature dim is flax's last; in the port's layouts it is dim 0 of
a ``Conv3d`` kernel (``[out, in, kd, kh, kw]``), dim 1 of a
``ConvTranspose3d`` kernel (``[in, out, kd, kh, kw]``) and dim 0 of a
``Dense`` kernel (``[out, in]``): ``OUTPUT_FEATURE_DIM``.

Where JAX jits one step over the mesh and GSPMD inserts the collectives,
each rank here is one process of a data x model mesh (``make_mesh_2d``,
``core/mesh.launch``) and the collectives are written out:

  * ``apply_state_sharding`` keeps on each rank its 1/``n_model`` slice of
    every sharded kernel (the ``model`` index picks it) and of its Adam
    moments, and makes those layers column-parallel
    (``ops/layers.column_parallel``): each convolves the whole input with
    its slice and the slices are all-gathered over the model row; the
    backward keeps this rank's slice of the output's gradient and sums the
    input's gradient over the row;
  * the batch norms take their statistics over the data column
    (``ops/layers.set_data_group``), and the train step sums the
    gradients as GSPMD's function does (``train/steps.py``).

``gather_tensors`` and ``gather_state`` put the slices back together, for
the tests and for anything that saves.

A data x model mesh spans the ranks of one process: a multi-host run
(``core/mesh.Cluster``) takes the 1-D data mesh only.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sap3d_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    _first,
    _visible_cards,
)
from sap3d_tpu_torch.ops.cbam import Dense
from sap3d_tpu_torch.ops.layers import Conv3d, ConvTranspose3d

# The kernel dim that holds a layer's output features (flax's last dim)
OUTPUT_FEATURE_DIM = {Conv3d: 0, ConvTranspose3d: 1, Dense: 0}


def make_mesh_2d(n_data: int, n_model: int, devices=None, device: str | torch.device = "cuda",
                 cluster=None) -> Mesh:
    """A ``data`` x ``model`` mesh of the first ``n_data * n_model`` of
    ``devices``, row-major: rank ``r`` is entry (``r // n_model``,
    ``r % n_model``), as JAX reshapes its device list.  Without
    ``devices``, a CUDA ``device`` means the visible cards and the CPU
    means itself ``n_data * n_model`` times.  ``devices`` may repeat a
    device.  Asking for more entries than there are devices raises.  A
    ``cluster`` raises: the mesh spans one process's ranks."""
    if cluster is not None:
        raise ValueError("a data x model mesh spans the ranks of one process; a multi-host "
                         "run takes the 1-D data mesh (core/mesh.make_mesh with its cluster)")
    if n_data < 1 or n_model < 1:
        raise ValueError(f"a data x model mesh of {n_data} x {n_model}")
    n = n_data * n_model
    if devices is None:
        cpu = torch.device(device).type == "cpu"
        devs = [torch.device("cpu")] * n if cpu else _visible_cards()
    else:
        devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devs]
    return Mesh(tuple(_first(n, devs, "data x model")), DATA_AXIS, n_model=n_model)


def _kernel_layers(model: nn.Module):
    """(name of the kernel, its layer, the layer's output-feature dim) of
    every parameter called ``kernel``; a layer the rule does not know
    raises."""
    for prefix, module in model.named_modules():
        if "kernel" not in module._parameters:
            continue
        # the nearest class of the rule: a layer's formulations (the stem's
        # space-to-depth conv, the phase transposed conv) keep its layout
        dim = next((OUTPUT_FEATURE_DIM[t] for t in type(module).__mro__
                    if t in OUTPUT_FEATURE_DIM), None)
        if dim is None:
            raise TypeError(f"{prefix}: no output-feature dim known for "
                            f"{type(module).__name__}'s kernel")
        yield f"{prefix}.kernel" if prefix else "kernel", module, dim


def infer_param_specs(model: nn.Module, mesh: Mesh, min_features: int = 512
                      ) -> dict[str, int | None]:
    """{parameter name: the dim sharded on ``MODEL_AXIS``, or None}: a
    kernel whose output features number at least ``min_features`` and
    divide by the model axis is sharded on its output-feature dim
    (``OUTPUT_FEATURE_DIM``); every other parameter is replicated.  A model
    that is already sharded raises.  Works on the meta device."""
    specs: dict[str, int | None] = {name: None for name, _ in model.named_parameters()}
    if MODEL_AXIS not in mesh.shape:
        return specs
    m = mesh.shape[MODEL_AXIS]
    for name, layer, dim in _kernel_layers(model):
        if layer.model_group is not None:
            raise ValueError(f"{name} is already a slice: infer the specs before sharding")
        features = layer.kernel.shape[dim]
        if layer.kernel.dim() >= 2 and features >= min_features and features % m == 0:
            specs[name] = dim
    return specs


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """The sharding of a train state (the JAX package's TrainState of
    NamedShardings): the mesh's shape, the sharded dim of each parameter
    (None: replicated) and of each parameter's Adam state (``exp_avg`` and
    ``exp_avg_sq`` as their parameter, ``step`` replicated).  The step
    count and the buffers (BN statistics) are replicated."""

    mesh_shape: dict
    params: dict
    optimizer: dict

    @property
    def sharded(self) -> dict[str, int]:
        return {n: d for n, d in self.params.items() if d is not None}


def state_shardings(state, mesh: Mesh, min_features: int = 512) -> StateSharding:
    """The sharding of ``state`` (``train/state.TrainState``) on ``mesh``:
    parameters by ``infer_param_specs``, their Adam moments with them,
    everything else replicated."""
    specs = infer_param_specs(state.model, mesh, min_features)
    return StateSharding(
        mesh_shape=dict(mesh.shape), params=specs,
        optimizer={n: {"step": None, "exp_avg": d, "exp_avg_sq": d} for n, d in specs.items()})


def sharded_layers(model: nn.Module) -> dict[str, tuple[nn.Module, int]]:
    """{kernel name: (layer, output-feature dim)} of the layers whose
    kernel is a slice on a model row (``apply_state_sharding``)."""
    return {name: (layer, dim) for name, layer, dim in _kernel_layers(model)
            if layer.model_group is not None}


def _check_group(shardings: StateSharding, group) -> None:
    if group is None or group.model is None:
        raise ValueError("a state sharding needs the group of a data x model mesh "
                         "(core/mesh.launch of make_mesh_2d)")
    want = shardings.mesh_shape
    got = {DATA_AXIS: group.data.world_size, MODEL_AXIS: group.model.world_size}
    if want.get(MODEL_AXIS) != got[MODEL_AXIS] or want.get(DATA_AXIS) != got[DATA_AXIS]:
        raise ValueError(f"a state sharding for a mesh of {want} on a group of {got}")


def apply_state_sharding(state, shardings: StateSharding, group):
    """Keep on this rank its slice of each sharded kernel and of the Adam
    moments it already has (the model index of ``group``, a data x model
    group, picks the slice), make those layers column-parallel over the
    group's model row, and rebuild the optimizer over the local parameters
    with the coupled-L2 groups of ``train/state.make_optimizer``, its
    learning rate and weight decay kept.  Returns ``state``, which records
    ``shardings``."""
    from sap3d_tpu_torch.train.state import make_optimizer

    _check_group(shardings, group)
    if state.sharding is not None:
        raise ValueError("the state is already sharded")
    model, opt = state.model, state.optimizer
    row = group.model
    r, m = row.rank, row.world_size
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {names[id(p)]: dict(s) for p, s in opt.state.items()}
    groups = opt.param_groups
    lr = groups[0]["lr"]
    weight_decay = max(g.get("weight_decay", 0.0) for g in groups)
    layers = {name: layer for name, layer, _ in _kernel_layers(model)}
    for name, dim in shardings.sharded.items():
        layer = layers[name]
        full = layer.kernel
        n = full.shape[dim] // m
        layer.kernel = nn.Parameter(full.detach().narrow(dim, r * n, n).clone(),
                                    requires_grad=full.requires_grad)
        layer.model_group = row
        for key, sdim in shardings.optimizer[name].items():
            if sdim is not None and key in moments.get(name, {}):
                moments[name][key] = moments[name][key].narrow(sdim, r * n, n).clone()
    state.optimizer = make_optimizer(model, lr, weight_decay)
    if moments:
        state.load_optimizer_state(moments)
    state.sharding = shardings
    return state


def gather_tensors(model: nn.Module, tensors: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """``tensors`` by parameter name (the parameters, their gradients or
    one of their moments) with each sharded kernel's slices gathered into
    the whole tensor over its model row; the rest as they are.  Every rank
    of the row must call it, with the same names."""
    layers = sharded_layers(model)
    out = {}
    for name, t in tensors.items():
        if name in layers:
            layer, dim = layers[name]
            t = layer.model_group.all_gather(t.detach(), dim)
        out[name] = t
    return out


def gather_state(state) -> dict:
    """The whole train state of a sharded ``state``: ``model``, the state
    dict with every kernel whole, and ``optimizer``, the Adam state by
    parameter name (``TrainState.load_optimizer_state``'s layout) with the
    moments whole.  Collective over each model row."""
    model, opt = state.model, state.optimizer
    sd = model.state_dict()
    sd.update(gather_tensors(model, {n: p.detach() for n, p in model.named_parameters()}))
    per_param = {n: opt.state[p] for n, p in model.named_parameters() if p in opt.state}
    moments = {n: dict(s) for n, s in per_param.items()}
    for key in ("exp_avg", "exp_avg_sq"):
        whole = gather_tensors(model, {n: s[key] for n, s in per_param.items()})
        for n, t in whole.items():
            moments[n][key] = t
    return {"model": sd, "optimizer": moments}
