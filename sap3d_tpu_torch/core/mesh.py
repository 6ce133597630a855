"""Device meshes: the time mesh of long-clip mode and the data mesh of data
parallel, with the process group that runs a data mesh.

Counterpart of ``sap3d_tpu/core/mesh.py`` (``TIME_AXIS``,
``make_time_mesh``, ``DATA_AXIS``, ``make_mesh``).  A mesh is an ordered
list of devices along one axis.

* The time mesh: ``ops/ring_attention.py`` places one contiguous shard of a
  site's tokens on each device and rotates the key/value shards around the
  ring, all in one process.  It may name one device more than once: 4
  shards on one card (or on the CPU, as the tests run it) run every hop of
  the ring for real, the rotation between two shards on the same device
  being a no-op.
* The data mesh: one process per entry, each holding a replica of the
  model and its share of the batch (``launch``).  Where JAX jits one step
  over the mesh and GSPMD inserts the reductions, each rank here reduces
  what the global batch needs through its ``DataGroup``: BN's sums
  (``ops/layers.py:BatchNorm``), the gradients and the loss
  (``train/steps.py``).  One card per rank talks over NCCL; the CPU, and a
  mesh that names a card more than once, over gloo (NCCL refuses two ranks
  on one device).  Gloo moves CUDA tensors only by ``all_reduce`` and
  ``broadcast``, so those are the only collectives on device tensors; host
  data (metric lists) goes by ``all_gather_object``.

Multi-host runs are not ported (ROADMAP A.5).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

TIME_AXIS = "time"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in order along one axis, ``TIME_AXIS`` or ``DATA_AXIS``."""

    devices: tuple[torch.device, ...]
    axis: str = TIME_AXIS

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: number of devices}, as a JAX mesh's ``shape``."""
        return {self.axis: len(self.devices)}


def _visible_cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _first(num_devices: int, devs: list[torch.device], what: str) -> list[torch.device]:
    """The first ``num_devices`` of ``devs`` (all of them for -1 and 0);
    more than ``devs`` holds raises, as does an empty result."""
    if num_devices > 0:
        if num_devices > len(devs):
            raise ValueError(f"a {what} mesh of {num_devices} devices exceeds the "
                             f"{len(devs)} available")
        devs = devs[:num_devices]
    if not devs:
        raise ValueError(f"a {what} mesh needs at least one device")
    return devs


def make_time_mesh(num_devices: int = -1, devices=None) -> Mesh:
    """A 1-D mesh over the clip's time axis: the first ``num_devices`` of
    ``devices`` (default: the visible CUDA devices; -1: all of them).
    ``devices`` may repeat a device.  Asking for more devices than the list
    holds raises."""
    devs = _visible_cards() if devices is None else [torch.device(d) for d in devices]
    return Mesh(tuple(_first(num_devices, devs, "time")), TIME_AXIS)


def make_mesh(num_devices: int = -1, devices=None, device: str | torch.device = "cuda"
              ) -> Mesh:
    """A 1-D data mesh: the first ``num_devices`` of ``devices``.  Without
    ``devices``, a CUDA ``device`` means the visible cards (-1 and 0: all of
    them) and the CPU means itself ``num_devices`` times (-1 and 0: once).
    ``devices`` may repeat a device.  Asking for more devices than there are
    raises."""
    if devices is None:
        cpu = torch.device(device).type == "cpu"
        devs = [torch.device("cpu")] * max(1, num_devices) if cpu else _visible_cards()
    else:
        devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devs]
    return Mesh(tuple(_first(num_devices, devs, "data")), DATA_AXIS)


def data_backend(mesh: Mesh) -> str:
    """``nccl`` for a mesh of distinct cards, ``gloo`` for the CPU or a mesh
    that names a card more than once."""
    devs = mesh.devices
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the process group of a data mesh (``launch``
    makes it): its rank, the number of ranks, its device and the backend.
    The collectives sum over every rank, in place, and return their
    tensor; with one rank they do nothing."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes logs and checkpoints."""
        return self.rank == 0

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        if self.world_size > 1:
            dist.all_reduce(tensor)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``tensor`` set to rank ``src``'s on every rank; a tensor off the
        group's device (a CPU step count under NCCL) goes through it."""
        if self.world_size > 1:
            if tensor.device == self.device:
                dist.broadcast(tensor, src)
            else:
                staged = tensor.to(self.device)
                dist.broadcast(staged, src)
                tensor.copy_(staged)
        return tensor

    def all_gather_object(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order (pickled through the host)."""
        if self.world_size == 1:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.world_size > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def _rank_main(rank: int, fn: Callable, args: tuple, devices: tuple, backend: str,
               workdir: str, threads: int | None) -> None:
    """One rank: join the group on a file store, run ``fn(group, *args)``,
    leave the group and write its return value for the launcher."""
    n, device = len(devices), devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(workdir, "store"), n),
                            rank=rank, world_size=n)
    try:
        result = fn(DataGroup(rank, n, device, backend), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(mesh: Mesh, fn: Callable, *args) -> list:
    """Run ``fn(group, *args)`` in one new process per entry of the data
    mesh, with the backend ``data_backend`` names, and return each rank's
    return value, in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and the
    processes start by ``spawn``: the caller's CUDA context, if any, is not
    inherited.  The ranks meet on a file store in a temporary directory,
    so no port is needed.  On the CPU each rank takes an equal share of
    the caller's threads.  A rank that raises or dies ends the others, and
    the launcher raises ``RuntimeError`` with the first failure it sees."""
    import torch.multiprocessing as mp

    devices = tuple(mesh.devices)
    cpu = all(d.type == "cpu" for d in devices)
    threads = max(1, torch.get_num_threads() // len(devices)) if cpu else None
    with tempfile.TemporaryDirectory(prefix="sap3d_data_mesh_") as workdir:
        try:
            mp.start_processes(_rank_main, nprocs=len(devices), start_method="spawn",
                               args=(fn, args, devices, data_backend(mesh), workdir, threads))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"a rank of the data mesh failed: {e}") from e
        results = []
        for rank in range(len(devices)):
            with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
