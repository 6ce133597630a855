"""Device meshes: the time mesh of long-clip mode and the data mesh of data
parallel, with the process group that runs a data mesh.

Counterpart of ``sap3d_tpu/core/mesh.py`` (``TIME_AXIS``,
``make_time_mesh``, ``DATA_AXIS``, ``make_mesh``).  A mesh is an ordered
list of devices along one axis.

* The time mesh: a clip cut along time into one contiguous shard per
  entry (``time_shard_batch``, ``ops/time_shard.Shards``), every layer
  running on each shard on its device, all in one process; the ring
  attention (``ops/ring_attention.py``) rotates the key/value shards around
  it.  It may name one device more than once: 4 shards on one card (or on
  the CPU, as the tests run it) run every halo exchange and every hop of
  the ring for real, a move between two shards on the same device being a
  no-op.
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
* The data x model mesh of tensor parallel (``core/sharding_rules.py``'s
  ``make_mesh_2d``): a data mesh whose entries form a grid of
  ``n_data`` rows and ``n_model`` columns, rank ``r`` at (``r // n_model``,
  ``r % n_model``), as JAX reshapes its device list.  ``launch`` runs it
  as a data mesh whose ``DataGroup`` also carries two subgroups: ``data``,
  the ranks of its model index (its column, over which the batch is
  split), and ``model``, the ranks of its data index (its row, over which
  the wide kernels are split).  Under gloo the all-gather of a layer's
  output slices is a sum of zero-padded slices (``DataGroup.all_gather``);
  under NCCL it is ``all_gather_into_tensor``.  A 2-D mesh spans the ranks
  of one process: a cluster's mesh is 1-D.

Multi-host (``initialize_distributed``, the counterpart of JAX's): process
``i`` of ``P`` meets the others at a coordinator, a TCP store that process
0 holds (``Cluster``).  Each process publishes its host name and its cards
there, so every process knows the whole layout before a rank starts.
``Cluster.make_mesh`` then spans the ranks of every process, process ``i``'s
first at the sum of the earlier processes' counts, and ``launch`` starts
this process's entries with those global ranks, meeting the others' on the
TCP store.  The backend is chosen on (host, card) pairs, so that two
processes on one host that name the same card talk over gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import socket
import sys
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

TIME_AXIS = "time"
DATA_AXIS = "data"
MODEL_AXIS = "model"
# Seconds a process waits for the others at the coordinator, and the ranks
# in a collective: jax.distributed.initialize's initialization_timeout.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in order along one axis, ``TIME_AXIS`` or ``DATA_AXIS``.

    A data mesh across processes (``make_mesh`` with a ``cluster``) also
    holds each entry's (host, card), the entries ``[start, stop)`` that
    this process runs, and the cluster its ranks meet through.  A data mesh
    with ``n_model`` set is the data x model grid of tensor parallel, its
    devices in row-major order (``core/sharding_rules.make_mesh_2d``)."""

    devices: tuple[torch.device, ...]
    axis: str = TIME_AXIS
    places: tuple[tuple[str, str], ...] = ()
    local: tuple[int, int] | None = None
    cluster: Cluster | None = dataclasses.field(default=None, compare=False, repr=False)
    n_model: int | None = None

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: number of devices}, as a JAX mesh's ``shape``."""
        if self.n_model is not None:
            return {DATA_AXIS: len(self.devices) // self.n_model, MODEL_AXIS: self.n_model}
        return {self.axis: len(self.devices)}


class Cluster:
    """This process's place among the ``num_processes`` processes of a run
    that met at ``coordinator`` (``HOST:PORT``); ``initialize_distributed``
    makes it.

    Process 0 holds the TCP store at that address, and every process
    publishes its host name there before the constructor returns.  Values
    pass between processes as JSON through the store, every process calling
    the same exchanges in the same order.  Each wait ends after ``timeout``
    seconds with a ``RuntimeError`` naming the processes that did not
    arrive.  ``close`` (or leaving a ``with`` block) says that this process
    is done; process 0 lets the store go only when every process has said
    so, after every rank has left."""

    def __init__(self, coordinator: str, num_processes: int, process_id: int,
                 timeout: float = DEFAULT_TIMEOUT_S):
        host, sep, port = coordinator.rpartition(":")
        if not (sep and host and port.isdigit()):
            raise ValueError(f"coordinator {coordinator!r} is not HOST:PORT")
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes and this "
                             "process's id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
        self.host, self.port = host, int(port)
        self.num_processes, self.process_id = num_processes, process_id
        self.timeout = datetime.timedelta(seconds=timeout)
        self._exchanges = 0
        try:
            self.store = dist.TCPStore(host, self.port, is_master=process_id == 0,
                                       timeout=self.timeout, wait_for_workers=False)
        except dist.DistError as e:
            raise RuntimeError(f"process {process_id} of {num_processes}: no store at the "
                               f"coordinator {self.address}: {e}") from e
        try:
            self.hosts = self.all_gather("host", socket.gethostname())
        except RuntimeError:
            self.store = None
            raise

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _key(self, name: str) -> str:
        """A fresh store key for the next exchange called ``name``."""
        self._exchanges += 1
        return f"{name}{self._exchanges}"

    def _wait(self, keys: list[str], what: str) -> None:
        """Wait for one key of each process, ``keys[i]`` process ``i``'s."""
        try:
            self.store.wait(keys, self.timeout)
        except dist.DistError as e:
            missing = [i for i, k in enumerate(keys) if not self.store.check([k])]
            raise RuntimeError(
                f"process {self.process_id} of {self.num_processes}: no {what} from "
                f"process {missing} at the coordinator {self.address} within "
                f"{self.timeout.total_seconds():g} s") from e

    def all_gather(self, name: str, value) -> list:
        """Every process's ``value``, in process order."""
        key = self._key(name)
        self.store.set(f"{key}/{self.process_id}", json.dumps(value))
        keys = [f"{key}/{i}" for i in range(self.num_processes)]
        self._wait(keys, name)
        return [json.loads(self.store.get(k)) for k in keys]

    def span(self, local: Mesh) -> Mesh:
        """The data mesh of every process's ``local`` mesh, in process order:
        this process's entries start at the sum of the earlier processes'
        counts."""
        me = self.hosts[self.process_id]
        entries = self.all_gather("mesh", [[me, _card(d), str(d)] for d in local.devices])
        start = sum(len(e) for e in entries[:self.process_id])
        flat = [entry for e in entries for entry in e]
        return Mesh(tuple(torch.device(d) for _, _, d in flat), DATA_AXIS,
                    places=tuple((h, c) for h, c, _ in flat),
                    local=(start, start + len(local.devices)), cluster=self)

    def rendezvous(self) -> tuple:
        """What a rank of ``launch`` needs to reach the store: the address,
        the timeout and a key prefix of its launch's own."""
        return self.host, self.port, self.timeout, self._key("launch") + "/"

    def close(self) -> None:
        """Say that this process is done; process 0 first waits for every
        process to say so.  Prints, and does not raise, when a process
        never does (it failed, and its ranks' peers with it)."""
        if self.store is None:
            return
        try:
            self.store.set(f"done/{self.process_id}", "1")
            if self.process_id == 0:
                self._wait([f"done/{i}" for i in range(self.num_processes)], "word of its end")
        except (RuntimeError, dist.DistError) as e:
            print(f"closing the cluster: {e}", file=sys.stderr)
        finally:
            self.store = None

    def __enter__(self) -> Cluster:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           timeout: float = DEFAULT_TIMEOUT_S) -> Cluster | None:
    """Counterpart of ``sap3d_tpu/core/mesh.py:initialize_distributed``:
    call once in each process of a multi-host run, before its mesh.

    With a coordinator address, join the run there as process
    ``process_id`` of ``num_processes`` and return the ``Cluster``.  A
    coordinator that cannot be reached, or a process that has not arrived
    within ``timeout`` seconds (``jax.distributed.initialize``'s
    ``initialization_timeout``), raises: such a run must not go on alone.
    Without one there is nothing to join (the port has no counterpart of a
    TPU pod's auto-detection): print that it is skipped, as the JAX
    package does off a pod, and return None; the run is one process."""
    if coordinator_address is None:
        print("initialize_distributed skipped: no coordinator address, so this is a "
              "run of one process")
        return None
    return Cluster(coordinator_address, num_processes, process_id, timeout)


def _card(device: torch.device) -> str:
    """A device's identity on its host: a card's UUID, the same under any
    ``CUDA_VISIBLE_DEVICES``, where the card reports one."""
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        if uuid is not None:
            return f"GPU-{uuid}"
    return str(device)


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


def time_shard_batch(mesh: Mesh, batch):
    """Host arrays (numpy frames [B, T, H, W, C], targets [B, T, H, W], or a
    tuple of them) cut along T into the time mesh's shards, each copied
    from the host straight to its shard's device (``ops/time_shard.Shards``
    with the time axis at 1): nothing is staged on one device first."""
    from sap3d_tpu_torch.ops.time_shard import from_host

    if isinstance(batch, (tuple, list)):
        return type(batch)(from_host(mesh, a) for a in batch)
    return from_host(mesh, batch)


def make_mesh(num_devices: int = -1, devices=None, device: str | torch.device = "cuda",
              cluster: Cluster | None = None) -> Mesh:
    """A 1-D data mesh: the first ``num_devices`` of ``devices``.  Without
    ``devices``, a CUDA ``device`` means the visible cards (-1 and 0: all of
    them) and the CPU means itself ``num_devices`` times (-1 and 0: once).
    ``devices`` may repeat a device.  Asking for more devices than there are
    raises.

    With a ``cluster`` the mesh spans the ranks of every process
    (``Cluster.span``): ``num_devices`` counts them all, each process taking
    ``num_devices / P`` of its own, and -1 and 0 mean every visible card of
    every process (the CPU once per process).  A count that does not divide
    by P raises: the port refuses a mesh that leaves out part of a
    process."""
    if cluster is not None:
        p = cluster.num_processes
        if num_devices > 0 and num_devices % p:
            raise ValueError(f"a data mesh of {num_devices} devices does not divide over "
                             f"{p} processes, each of which takes N / {p} of its own")
        return cluster.span(make_mesh(num_devices // p if num_devices > 0 else num_devices,
                                      devices, device))
    if devices is None:
        cpu = torch.device(device).type == "cpu"
        devs = [torch.device("cpu")] * max(1, num_devices) if cpu else _visible_cards()
    else:
        devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devs]
    return Mesh(tuple(_first(num_devices, devs, "data")), DATA_AXIS)


def data_backend(mesh: Mesh) -> str:
    """``nccl`` when every entry is a card and no (host, card) pair repeats;
    ``gloo`` for the CPU, or when a card is named twice on one host."""
    places = mesh.places or tuple(("", str(d)) for d in mesh.devices)
    if all(d.type == "cuda" for d in mesh.devices) and len(set(places)) == len(places):
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the process group of a data mesh (``launch``
    makes it): its rank, the number of ranks, its device and the backend.
    The collectives sum over every rank, in place, and return their
    tensor; with one rank they do nothing.

    A subgroup (``process_group`` set) is the same view of some of the
    ranks: ``rank`` is this rank's index among ``ranks``, the members'
    global ranks in order.  On a data x model mesh the world's group holds
    this rank's two subgroups, ``data`` (its column) and ``model`` (its
    row)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    process_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    ranks: tuple[int, ...] = ()
    data: DataGroup | None = None
    model: DataGroup | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes logs and checkpoints."""
        return self.rank == 0

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        if self.world_size > 1:
            dist.all_reduce(tensor, group=self.process_group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        """The members' tensors (one shape on every rank) concatenated
        along ``dim`` in member order, the same on every rank.  NCCL
        gathers them (``all_gather_into_tensor``); gloo, which moves CUDA
        tensors only by ``all_reduce`` and ``broadcast``, sums zero-padded
        copies, 16-bit values in float32 (exact either way: each element is
        one member's value plus zeros)."""
        if self.world_size == 1:
            return tensor
        dim = dim % tensor.dim()
        n = tensor.shape[dim]
        if self.backend == "nccl":
            out = torch.empty((self.world_size, *tensor.shape), dtype=tensor.dtype,
                              device=tensor.device)
            dist.all_gather_into_tensor(out, tensor.contiguous(), group=self.process_group)
            return out.movedim(0, dim).flatten(dim, dim + 1)
        acc = torch.promote_types(tensor.dtype, torch.float32)
        shape = list(tensor.shape)
        shape[dim] = n * self.world_size
        out = torch.zeros(shape, dtype=acc, device=tensor.device)
        out.narrow(dim, self.rank * n, n).copy_(tensor)
        dist.all_reduce(out, group=self.process_group)
        return out.to(tensor.dtype)

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``tensor`` set to member ``src``'s on every rank; a tensor off the
        group's device (a CPU step count under NCCL) goes through it."""
        if self.world_size > 1:
            root = self.ranks[src] if self.ranks else src
            if tensor.device == self.device:
                dist.broadcast(tensor, root, group=self.process_group)
            else:
                staged = tensor.to(self.device)
                dist.broadcast(staged, root, group=self.process_group)
                tensor.copy_(staged)
        return tensor

    def all_gather_object(self, obj: Any) -> list:
        """Every member's ``obj``, in member order (pickled through the
        host)."""
        if self.world_size == 1:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.process_group)
        return out

    def barrier(self) -> None:
        if self.world_size > 1:
            if self.backend == "nccl":
                dist.barrier(group=self.process_group, device_ids=[self.device.index])
            else:
                dist.barrier(group=self.process_group)


def grid_ranks(world_size: int, n_model: int) -> tuple[list[list[int]], list[list[int]]]:
    """The columns (one per model index, the ranks of a data group) and the
    rows (one per data index, the ranks of a model group) of a grid of
    ``world_size`` ranks in ``n_model`` columns, rank ``r`` at (``r //
    n_model``, ``r % n_model``)."""
    if n_model < 1 or world_size % n_model:
        raise ValueError(f"{world_size} ranks do not form a grid of {n_model} columns")
    n_data = world_size // n_model
    return ([[d * n_model + m for d in range(n_data)] for m in range(n_model)],
            [[d * n_model + m for m in range(n_model)] for d in range(n_data)])


def grid_groups(world: DataGroup, n_model: int, timeout: datetime.timedelta) -> DataGroup:
    """``world`` with its ``data`` and ``model`` subgroups on a grid of
    ``n_model`` columns (``grid_ranks``): every rank creates every column's
    group, then every row's, in the same order (``dist.new_group`` is
    collective over the world, and ranks that create groups in another
    order wait on each other until the timeout)."""
    columns, rows = grid_ranks(world.world_size, n_model)
    groups = [(tuple(g), dist.new_group(g, timeout=timeout)) for g in columns + rows]
    r = world.rank
    data, model = (DataGroup(ranks.index(r), len(ranks), world.device, world.backend, pg, ranks)
                   for ranks, pg in groups if r in ranks)
    return dataclasses.replace(world, data=data, model=model)


def _rank_main(local_rank: int, fn: Callable, devices: tuple, first: int, backend: str,
               workdir: str, threads: int | None, rendezvous: tuple | None,
               n_model: int | None = None) -> None:
    """One rank, ``first + local_rank`` of the mesh: join the group (on a
    file store, or on the cluster's TCP store under the launch's prefix;
    on a data x model grid, with its subgroups and ``DEFAULT_TIMEOUT_S``
    on every collective), run ``fn(group, *args)`` with the launcher's
    ``args`` read from its file, leave the group and write its return
    value for the launcher."""
    rank = first + local_rank
    n, device = len(devices), devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if threads:
        torch.set_num_threads(threads)
    if rendezvous is None:
        store, kw = dist.FileStore(os.path.join(workdir, "store"), n), {}
        if n_model is not None:
            kw = {"timeout": datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)}
    else:
        host, port, timeout, prefix = rendezvous
        store = dist.PrefixStore(prefix, dist.TCPStore(host, port, is_master=False,
                                                       timeout=timeout))
        kw = {"timeout": timeout}
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n, **kw)
    try:
        group = DataGroup(rank, n, device, backend)
        if n_model is not None:
            group = grid_groups(group, n_model, kw["timeout"])
        result = fn(group, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"result_{local_rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(mesh: Mesh, fn: Callable, *args) -> list:
    """Run ``fn(group, *args)`` in one new process per entry of the data
    mesh, with the backend ``data_backend`` names, and return each rank's
    return value, in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path; ``args``
    into a file that each rank reads, since a spawned process takes what
    comes through its pipe only once it has imported the caller's main
    module, and a large pipe write would start the ranks one by one) and
    the processes start by ``spawn``: the caller's CUDA context, if any, is
    not inherited.  The ranks meet on a file store in a temporary directory,
    so no port is needed.  On the CPU each rank takes an equal share of
    the caller's threads.  A rank that raises or dies ends the others, and
    the launcher raises ``RuntimeError`` with the first failure it sees.

    A data x model mesh (``core/sharding_rules.make_mesh_2d``) gives each
    rank's group its ``data`` and ``model`` subgroups (``grid_groups``).

    A mesh across processes (``make_mesh`` with a cluster) starts only this
    process's entries, with their global ranks; they meet the other
    processes' ranks on the cluster's TCP store, under a prefix of this
    launch's own, and wait for them in the rendezvous and in each
    collective at most the cluster's timeout.  The return values are this
    process's ranks'."""
    import torch.multiprocessing as mp

    first, stop = mesh.local or (0, len(mesh.devices))
    local = mesh.devices[first:stop]
    cpu = all(d.type == "cpu" for d in local)
    threads = max(1, torch.get_num_threads() // len(local)) if cpu else None
    rendezvous = mesh.cluster.rendezvous() if mesh.cluster is not None else None
    with tempfile.TemporaryDirectory(prefix="sap3d_data_mesh_") as workdir:
        with open(os.path.join(workdir, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        try:
            mp.start_processes(_rank_main, nprocs=len(local), start_method="spawn",
                               args=(fn, tuple(mesh.devices), first, data_backend(mesh),
                                     workdir, threads, rendezvous, mesh.n_model))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"a rank of the data mesh failed: {e}") from e
        results = []
        for rank in range(len(local)):
            with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
