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

Both take time-sharded frames and targets (``core/mesh.time_shard_batch``,
long-clip mode) as well: the model then runs every layer on each shard's
device, the loss adds the shards' sums, and the eval step returns a
time-sharded [B, T, H, W].  Adam steps the one copy of the parameters on
the model's device, as ever.

Each step sets its module's mode when called, so a trainer can interleave
them.

Data parallel (``core/mesh.launch``, one process per device): with a
``group`` of more than one rank, ``make_train_step`` runs each rank's share
of the global batch with global-batch BN statistics (``set_data_group``)
and, the loss being a global sum (``sap3d_tpu/train/steps.py:122-124``),
**sums** the ranks' gradients after the backward (in flat buckets of at
most ``BUCKET_BYTES``) before the optimizer adds the coupled L2 and steps;
it returns the global loss.  ``DataParallelForward`` is the eval forward
over a group: rank 0 broadcasts each batch, every rank forwards its
contiguous rows, and a sum of the zero-padded rows assembles the output.

Tensor parallel (``core/sharding_rules.py``): with the group of a data x
model mesh and a ``state_sharding``, the step is this rank's share of the
JAX package's ``state_sharding`` step.  The wide kernels are this rank's
slices (column-parallel layers), the BN statistics cover the data column,
and the gradients are summed as GSPMD's function: each kernel slice's over
its data column; each replicated parameter's over the world and divided
by ``n_model``, which is the data column's sum and leaves the ranks of a
model row bit-identical where their own gradients differ in the last bits
(pool1's max-pool backward and B3's dq are not deterministic on a card;
the division is exact for a power of two).  The loss is the data column's
sum.  Dropout draws on whole activations (a gathered output is whole on
every rank of the row), so every rank of a model row must draw the same
masks: the caller passes generators seeded by the data index
(``group.data.rank``), not the global rank.

K steps per call (``make_multi_train_step``, the JAX package's
``lax.scan`` of K steps in one dispatch): ``multi_step(frames [K, B, T, H,
W, 3], targets [K, B, T, H, W], generator)`` computes what K calls of the
train step compute, in order, dropout drawn from the one ``generator``,
and returns the K losses (float32 ``[K]`` on the device, not
synchronized); ``state.step`` grows by K.  Its path is fixed when it is
built.  On a CUDA model with no data group of more than one rank, no state
sharding and no time mesh, one step is a captured CUDA graph
(``CapturedMultiStep``): eager PyTorch spends more host time launching a
step's few thousand kernels than the card spends running them (PERF.md
§5), and a replay launches them all at once.  On the CPU, on a data group,
on a data x model grid and over a time mesh the K single steps run one
after the other in the call.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from sap3d_tpu_torch.core.mesh import time_shard_batch
from sap3d_tpu_torch.core.sharding_rules import apply_state_sharding, sharded_layers
from sap3d_tpu_torch.ops.cuda import launch_counts
from sap3d_tpu_torch.ops.layers import set_data_group, smooth_l1_loss, smooth_l1_terms
from sap3d_tpu_torch.ops.time_shard import Shards, shard_sums
from sap3d_tpu_torch.train.state import TrainState

# Gradient bytes per all-reduce of the data-parallel step
BUCKET_BYTES = 64 << 20


def loss_fn_saliency(pred, target) -> torch.Tensor:
    """smooth_l1(pred, target, 1, 1, sigma=1) summed over every element;
    ``pred`` [B, T, H, W, 1] or [B, T, H, W], ``target`` [B, T, H, W].
    Time-sharded ``pred`` and ``target`` (``core/mesh.time_shard_batch``)
    give each shard's sum on its device, and those sums are added on the
    mesh's first device in shard order."""
    if pred.shape[-1] == 1 and len(pred.shape) == len(target.shape) + 1:
        pred = pred.squeeze(-1)
    if isinstance(pred, Shards):
        return shard_sums(pred.zip(target, smooth_l1_terms)).sum()
    return smooth_l1_loss(pred, target, 1.0, 1.0, sigma=1.0)


def gradient_buckets(params) -> list[list[torch.Tensor]]:
    """The parameters' gradients in order, grouped into buckets of one
    dtype and at most ``BUCKET_BYTES`` (a larger gradient alone).
    Parameters without a gradient are left out (the same on every rank:
    each runs the same graph)."""
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for g in (p.grad for p in params if p.grad is not None):
        nbytes = g.numel() * g.element_size()
        if not buckets or size + nbytes > BUCKET_BYTES or g.dtype != buckets[-1][0].dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    return buckets


def all_reduce_gradients(params, group, divisor: int = 1) -> None:
    """Sum each parameter's ``.grad`` over the ranks of ``group`` in place,
    one all-reduce per bucket (``gradient_buckets``), divided by
    ``divisor``."""
    for bucket in gradient_buckets(params):
        flat = group.all_reduce(torch.cat([g.reshape(-1) for g in bucket]))
        if divisor != 1:
            flat.div_(divisor)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def reduce_grid_gradients(sharded, replicated, group) -> None:
    """The gradient sums of a tensor-parallel step on the data x model
    ``group``: the kernel slices' (``sharded``) over the data column, the
    replicated parameters' over the world divided by ``n_model``."""
    all_reduce_gradients(sharded, group.data)
    all_reduce_gradients(replicated, group, divisor=group.model.world_size)


def make_train_step(state: TrainState, group=None, state_sharding=None
                    ) -> Callable[[torch.Tensor, torch.Tensor, torch.Generator | None],
                                  torch.Tensor]:
    """The train step; with a ``group`` (``core/mesh.DataGroup``) of more
    than one rank, this rank's share of a data-parallel step, whose BN
    layers take the group (global-batch statistics).  With the group of a
    data x model mesh and a ``state_sharding``
    (``core/sharding_rules.state_shardings``), which go together, a
    tensor-parallel step: the state is sharded first where it is not yet
    (``apply_state_sharding``); a state sharded otherwise raises."""
    model = state.model
    grid = state_sharding is not None
    if grid != (group is not None and group.model is not None):
        raise ValueError("a tensor-parallel step takes a state_sharding and the group of "
                         "its data x model mesh together")
    if grid and state.sharding is None:
        apply_state_sharding(state, state_sharding, group)
    elif state.sharding != state_sharding:
        raise ValueError("the state is sharded otherwise than state_sharding says")
    opt = state.optimizer
    parallel = group is not None and group.world_size > 1
    if parallel:
        set_data_group(model, group)
    params = list(model.parameters())
    sliced = {id(layer.kernel) for layer, _ in sharded_layers(model).values()} if grid else ()
    sharded = [p for p in params if id(p) in sliced]
    replicated = [p for p in params if id(p) not in sliced]

    def step(frames: torch.Tensor, targets: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        model.train()
        loss = loss_fn_saliency(model(frames, generator), targets)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if grid and parallel:
            reduce_grid_gradients(sharded, replicated, group)
            loss = group.data.all_reduce(loss.clone())
        elif parallel:
            all_reduce_gradients(params, group)
            loss = group.all_reduce(loss.clone())
        opt.step()
        state.step += 1
        return loss

    return step


def micro_batch(frames, targets, i: int):
    """Step ``i``'s batch of a multi-step call."""
    return frames[i], targets[i]


def make_multi_train_step(state: TrainState, steps_per_call: int, group=None,
                          state_sharding=None, time_mesh=None):
    """K = ``steps_per_call`` train steps per call (``multi_step(frames,
    targets, generator) -> losses [K]``), over ``make_train_step(state,
    group, state_sharding)``.  The path is chosen here, once:

    * captured (``CapturedMultiStep``): the model's parameters on a CUDA
      device, ``group`` None or of one rank, no ``state_sharding`` and no
      ``time_mesh``.  A capture that fails raises; nothing then runs the
      steps eagerly in its place.
    * loop: anywhere else (the CPU, a data group over NCCL or gloo, a data x
      model grid, a time mesh), the K single steps one after the other.
      With ``time_mesh`` (long-clip mode) ``frames`` and ``targets`` are
      host arrays and each step's batch is cut onto the mesh's shards
      (``core/mesh.time_shard_batch``), as the trainer's single steps are.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be at least 1, got {steps_per_call}")
    step = make_train_step(state, group, state_sharding)
    on_card = next(state.model.parameters()).device.type == "cuda"
    if on_card and time_mesh is None and state_sharding is None \
            and (group is None or group.world_size == 1):
        return CapturedMultiStep(state, step, steps_per_call)

    def multi_step(frames, targets, generator: torch.Generator | None = None) -> torch.Tensor:
        _check_steps(frames, targets, steps_per_call)
        losses = []
        for i in range(steps_per_call):
            f, t = micro_batch(frames, targets, i)
            if time_mesh is not None:
                f, t = time_shard_batch(time_mesh, (f, t))
            losses.append(step(f, t, generator))
        return torch.stack(losses)

    return multi_step


def _check_steps(frames, targets, k: int) -> None:
    if len(frames) != k or len(targets) != k:
        raise ValueError(f"a call of {k} steps takes [{k}, B, ...] frames and targets, "
                         f"got {len(frames)} and {len(targets)}")


class CapturedMultiStep:
    """The captured path of ``make_multi_train_step``: one train step
    (``step``, a ``make_train_step`` of ``state``) as a CUDA graph.

    The first call runs its K steps eagerly on the graph's side stream.
    They are real steps, and the warm-up that capture needs: the kernels'
    first-use build and shared-memory attributes, cuDNN's plans, fused
    Adam's state.  Then it captures one step (the forward, the loss,
    ``zero_grad(set_to_none=True)``, the backward, ``opt.step()``) on
    static frames and targets, with ``generator`` registered to the graph,
    so that each replay draws the dropout masks an eager step would draw
    and advances the generator as far.  Each step of a later call copies
    its batch into the static inputs and replays the graph.  The optimizer
    must be ``capturable`` (``train/state.make_optimizer`` makes it so on
    the card; fused Adam computes the same update either way), or the
    capture raises, as any failed capture does.

    What the graph holds fixed:

    * where the parameters, BN buffers, Adam moments and step counts lie.
      A call that finds any of them replaced
      (``TrainState.load_optimizer_state``, a checkpoint restore) warms up
      and captures again;
    * the generator: a later call with another one raises;
    * what Python read while capturing: the attention routes and
      ``use_kernel``, the dropout rate, train mode, the optimizer's lr, a
      patched function.  A change to any of them needs a new multi-step;
    * the batch's shape and dtype, which a later call must keep.

    ``.grad`` after a call is the graph's memory or an eager step's: read
    nothing from it.  The launch counters of ``ops.cuda`` count Python
    calls, so a replay adds nothing to them and each capture's recording
    calls, which launch nothing, add ``captured_launches`` (one captured
    step's launches).  ``replays`` counts the steps replayed and
    ``captures`` the captures, so a run that moved the counters by
    ``counted`` launched ``counted + captured_launches * (replays -
    captures)``, both taken over the run.  ``capture_s`` is the last
    capture's seconds.
    """

    def __init__(self, state: TrainState, step, steps_per_call: int):
        self.state, self.step, self.k = state, step, steps_per_call
        self.device = next(state.model.parameters()).device
        self.stream = torch.cuda.Stream(self.device)
        self.graph = None
        self.generator = None
        self.static_frames = self.static_targets = self.static_loss = None
        self.replays = self.captures = 0
        self.captured_launches: dict[str, int] = {}
        self.capture_s = 0.0
        self._storage: tuple[int, ...] = ()

    def _storage_now(self) -> tuple[int, ...]:
        opt = self.state.optimizer
        tensors = [*self.state.model.parameters(), *self.state.model.buffers(),
                   *(t for s in opt.state.values() for t in s.values() if torch.is_tensor(t))]
        return tuple(t.data_ptr() for t in tensors)

    def __call__(self, frames: torch.Tensor, targets: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        _check_steps(frames, targets, self.k)
        losses = torch.empty(self.k, dtype=torch.float32, device=self.device)
        if self.graph is None or self._storage != self._storage_now():
            self._warm_up(frames, targets, generator, losses)
            self._capture(frames, targets, generator)
            return losses
        if generator is not self.generator:
            raise ValueError("the graph was captured with another dropout generator")
        if (frames.shape[1:], frames.dtype, targets.shape[1:], targets.dtype) != (
                self.static_frames.shape, self.static_frames.dtype,
                self.static_targets.shape, self.static_targets.dtype):
            raise ValueError(f"the graph was captured on frames {tuple(self.static_frames.shape)} "
                             f"and targets {tuple(self.static_targets.shape)}; got "
                             f"{tuple(frames.shape[1:])} and {tuple(targets.shape[1:])}")
        for i in range(self.k):
            self._replay(i, frames, targets, losses)
        self.replays += self.k
        self.state.step += self.k
        return losses

    def _warm_up(self, frames, targets, generator, losses) -> None:
        """The call's K steps, eagerly on the side stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            for i in range(self.k):
                losses[i] = self.step(*micro_batch(frames, targets, i), generator)
        current.wait_stream(self.stream)

    def _capture(self, frames, targets, generator) -> None:
        self.graph = None
        self.static_frames = frames[0].clone()
        self.static_targets = targets[0].clone()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before, count = launch_counts(), self.state.step
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.static_loss = self.step(self.static_frames, self.static_targets, generator)
        finally:
            self.state.step = count  # capturing ran no step
        self.capture_s = time.perf_counter() - t0
        self.captured_launches = {k: n - before[k] for k, n in launch_counts().items()}
        self.captures += 1
        self.graph, self.generator, self._storage = graph, generator, self._storage_now()

    def _load(self, frames, targets, i: int) -> None:
        f, t = micro_batch(frames, targets, i)
        self.static_frames.copy_(f)
        self.static_targets.copy_(t)

    def _replay(self, i: int, frames, targets, losses) -> None:
        """Step ``i`` of a call: its batch into the static inputs, one
        replay, its loss out."""
        self._load(frames, targets, i)
        self.graph.replay()
        losses[i] = self.static_loss


def make_eval_step(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval-mode forward.  A model built with ``bn_reference_quirk``
    normalizes its bottlenecks with batch statistics and leaves every buffer
    as it was: the JAX eval step computes that update and discards it."""

    def step(frames: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(frames).squeeze(-1)

    return step


class DataParallelForward:
    """An eval step (``make_eval_step``) over a data group.  Rank 0 calls
    it with each batch of frames [B, T, H, W, 3] (B a multiple of the
    ranks) and gets the whole output [B, T, H, W], the other ranks run
    ``serve`` until rank 0 calls ``stop``.  Each batch is broadcast from
    rank 0, every rank forwards its B / N contiguous rows, and an all-reduce
    of the zero-padded rows assembles the output on every rank.  A quirk
    model whose BN layers take the group normalizes with the global batch's
    statistics."""

    def __init__(self, eval_step: Callable[[torch.Tensor], torch.Tensor], group):
        self.eval_step, self.group = eval_step, group

    def _header(self, shape=()) -> torch.Tensor:
        # [more batches?, B, T, H, W, 3]
        head = torch.zeros(6, dtype=torch.int64, device=self.group.device)
        if shape:
            head[0] = 1
            head[1:] = torch.tensor(shape)
        return self.group.broadcast(head)

    def _rows(self, frames: torch.Tensor) -> torch.Tensor:
        g = self.group
        b = frames.shape[0] // g.world_size
        mine = self.eval_step(frames[g.rank * b:(g.rank + 1) * b])
        out = torch.zeros((frames.shape[0], *mine.shape[1:]), dtype=mine.dtype,
                          device=mine.device)
        out[g.rank * b:(g.rank + 1) * b] = mine
        return g.all_reduce(out)

    def __call__(self, frames) -> torch.Tensor:
        frames = torch.as_tensor(np.asarray(frames, np.float32), device=self.group.device)
        if frames.shape[0] % self.group.world_size:
            raise ValueError(f"a batch of {frames.shape[0]} does not divide by "
                             f"{self.group.world_size} ranks")
        self._header(tuple(frames.shape))
        return self._rows(self.group.broadcast(frames))

    def serve(self) -> None:
        while True:
            head = self._header()
            if not head[0]:
                return
            frames = torch.empty(tuple(head[1:].tolist()), dtype=torch.float32,
                                 device=self.group.device)
            self._rows(self.group.broadcast(frames))

    def stop(self) -> None:
        self._header()


# The JAX package's two names differ only in how the variables are passed;
# here both are the same eval-mode forward.
make_forward_fn = make_eval_step
