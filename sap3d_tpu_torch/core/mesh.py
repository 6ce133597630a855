"""The time mesh of long-clip mode.

Counterpart of the time-mesh part of ``sap3d_tpu/core/mesh.py``
(``TIME_AXIS``, ``make_time_mesh``).  A mesh is an ordered list of devices
along one axis; ``ops/ring_attention.py`` places one contiguous shard
of a site's tokens on each and rotates the key/value shards around the ring.
Unlike a JAX mesh it may name one device more than once: 4 shards on one
card (or on the CPU, as the tests run it) run every hop of the ring for
real, the rotation between two shards on the same device being a no-op.

The data mesh, ``shard_batch`` and the multi-host set-up are not ported
(ROADMAP A.2 data parallel, A.5 multi-host).
"""

from __future__ import annotations

import dataclasses

import torch

TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in ring order along the one axis, ``TIME_AXIS``."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: number of shards}, as a JAX mesh's ``shape``."""
        return {TIME_AXIS: len(self.devices)}


def make_time_mesh(num_devices: int = -1, devices=None) -> Mesh:
    """A 1-D mesh over the clip's time axis: the first ``num_devices`` of
    ``devices`` (default: the visible CUDA devices; -1: all of them).
    ``devices`` may repeat a device.  Asking for more devices than the list
    holds raises."""
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is None else [torch.device(d) for d in devices])
    if num_devices > 0:
        if num_devices > len(devs):
            raise ValueError(f"a time mesh of {num_devices} devices exceeds the "
                             f"{len(devs)} available")
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a time mesh needs at least one device")
    return Mesh(tuple(devs))
