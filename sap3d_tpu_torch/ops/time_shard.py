"""Time-sharded clips: the counterpart of GSPMD's time partitioning.

In the JAX package a long clip is put on a time mesh with
``time_sharding(mesh)`` and GSPMD partitions every layer along the time
axis: each device convolves its own contiguous chunk of frames, with the
halo frames a temporal window needs exchanged between neighbours, the
batch statistics summed over the mesh, and the global attention sites
gathered or run as rings (``sap3d_tpu/core/mesh.py:make_time_mesh``).
This module is that partitioning, written out for PyTorch:

* ``Shards`` is a clip under a time mesh of N devices: shard j holds frames
  ``[j T/N, (j+1) T/N)`` on ``mesh.devices[j]``.  Shards that share a device
  are stacked along the batch axis in one tensor of that device (shard
  order within it, each shard's B rows together), so a mesh that names one
  card four times (or the CPU, as the tests run it) goes through each layer
  as one call per device, as many calls as the unsharded model makes; with
  four cards each card takes its own shard.  The ring attention stacks its
  hops the same way (``ops/ring_attention.py``).
* Elementwise operations (``F.relu``, ``torch.sigmoid``, arithmetic, a
  concatenation along channels) map over the devices' tensors; a tensor
  operand (a parameter such as ``gamma``) is moved to each device.  Any
  other torch function raises: a layer that has no sharded form refuses a
  sharded clip instead of running on it as if each shard were a clip.
* ``halo`` gives each shard the ``lo`` frames before it and the ``hi``
  frames after it, cut from the neighbouring shards (further ones where a
  halo is wider than a shard), and the op's own fill beyond the clip's two
  ends: the counterpart of GSPMD's halo exchange.
* ``sum_to`` adds per-device partial sums on one device (``.to`` inside
  autograd, so the gradient flows back to every shard).
* ``shard``/``gather`` cut a tensor along its time axis onto the mesh and
  put the shards back together on one device; ``from_host`` cuts a numpy
  array straight from the host onto each shard's device.

The layers that need more than a map take a ``Shards`` themselves
(``ops/layers.py``, ``ops/cbam.py``, ``ops/attention.py``).  The
parameters stay once on the trainer's device; each layer moves them to the
devices of the shards (a no-op where the device is the same), and autograd
adds the shards' gradients into the one copy.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch
import torch.nn.functional as F

from sap3d_tpu_torch.core.mesh import Mesh


@functools.cache
def groups(mesh: Mesh) -> tuple[tuple[torch.device, tuple[int, ...]], ...]:
    """The mesh's devices in order of first appearance, each with its shard
    indices in ring order."""
    by_dev: dict[torch.device, list[int]] = {}
    for j, dev in enumerate(mesh.devices):
        by_dev.setdefault(dev, []).append(j)
    return tuple((dev, tuple(idx)) for dev, idx in by_dev.items())


@functools.cache
def _places(mesh: Mesh) -> tuple[tuple[int, int], ...]:
    """Shard j's (group, position in the group)."""
    out = {}
    for g, (_, idx) in enumerate(groups(mesh)):
        for pos, j in enumerate(idx):
            out[j] = (g, pos)
    return tuple(out[j] for j in range(len(mesh.devices)))


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself where it is there already (no dispatch),
    else a differentiable copy."""
    return t if t.device == device else t.to(device)


def _operand(t, part: torch.Tensor, time_dim: int):
    """A plain operand of an elementwise op on a shard group's tensor: a
    tensor that broadcasts over batch and time, moved to the group's
    device; anything else as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    lead = part.dim() - t.dim()  # broadcasting aligns the trailing axes
    for axis in (0, time_dim):
        if axis >= lead and t.shape[axis - lead] != 1:
            raise ValueError(f"a tensor of shape {tuple(t.shape)} spans the batch or time "
                             "axis of a time-sharded clip: shard it first")
    return to_device(t, part.device)


_ELEMENTWISE = {
    F.relu, torch.relu, torch.sigmoid,
    torch.Tensor.__add__, torch.Tensor.__radd__, torch.Tensor.__mul__, torch.Tensor.__rmul__,
}


class Shards:
    """A clip cut along its time axis (``time_dim``: 2 for NCDHW
    activations, 1 for NDHWC frames, NTHW targets and [B, N, C] tokens) over
    ``mesh``: ``parts[g]`` is group g's tensor (``groups(mesh)``), its
    shards stacked along the batch axis, ``batch`` rows each."""

    __slots__ = ("mesh", "parts", "batch", "time_dim")

    def __init__(self, mesh: Mesh, parts, batch: int, time_dim: int = 2):
        self.mesh, self.parts = mesh, tuple(parts)
        self.batch, self.time_dim = batch, time_dim

    # -- layout ------------------------------------------------------------

    @property
    def groups(self):
        return groups(self.mesh)

    @property
    def n(self) -> int:
        """The number of shards."""
        return len(self.mesh.devices)

    @property
    def frames(self) -> int:
        """Frames (or tokens) per shard."""
        return self.parts[0].shape[self.time_dim]

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> tuple[int, ...]:
        """The whole clip's shape."""
        s = list(self.parts[0].shape)
        s[0], s[self.time_dim] = self.batch, self.frames * self.n
        return tuple(s)

    def shard(self, j: int) -> torch.Tensor:
        """Shard j, a view on its device."""
        g, pos = _places(self.mesh)[j]
        return self.parts[g].narrow(0, pos * self.batch, self.batch)

    def with_parts(self, parts, time_dim: int | None = None) -> Shards:
        """The same mesh and batch with new per-device tensors."""
        return Shards(self.mesh, parts, self.batch,
                      self.time_dim if time_dim is None else time_dim)

    def map(self, fn, time_dim: int | None = None) -> Shards:
        """``fn`` on each device's tensor (a per-frame op)."""
        return self.with_parts([fn(p) for p in self.parts], time_dim)

    def zip(self, other: Shards, fn) -> Shards:
        """``fn(mine, other's)`` on each device's tensors."""
        self._check_like(other)
        return self.with_parts([fn(a, b) for a, b in zip(self.parts, other.parts)])

    def _check_like(self, other: Shards) -> None:
        if (other.mesh, other.batch, other.time_dim, other.frames) != \
                (self.mesh, self.batch, self.time_dim, self.frames):
            raise ValueError("time-sharded clips of different meshes or layouts")

    # -- elementwise ops ---------------------------------------------------

    def _elementwise(self, func, args, kwargs) -> Shards:
        for a in args:
            if isinstance(a, Shards):
                self._check_like(a)
        parts = []
        for g, part in enumerate(self.parts):
            parts.append(func(*(a.parts[g] if isinstance(a, Shards) else
                                _operand(a, part, self.time_dim) for a in args), **kwargs))
        return self.with_parts(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.cat:
            return _cat(*args, **kwargs)
        if func not in _ELEMENTWISE:
            raise TypeError(f"{getattr(func, '__name__', func)} has no time-sharded form; a "
                            "layer that takes a sharded clip must handle Shards itself")
        like = next(a for a in args if isinstance(a, Shards))
        return like._elementwise(func, args, kwargs)

    def __add__(self, o):
        return self._elementwise(operator.add, (self, o), {})

    def __radd__(self, o):
        return self._elementwise(operator.add, (o, self), {})

    def __mul__(self, o):
        return self._elementwise(operator.mul, (self, o), {})

    def __rmul__(self, o):
        return self._elementwise(operator.mul, (o, self), {})

    def __truediv__(self, o):
        return self._elementwise(operator.truediv, (self, o), {})

    def to(self, dtype: torch.dtype) -> Shards:
        """A cast; the shards stay on their devices."""
        if not isinstance(dtype, torch.dtype):
            raise TypeError("a time-sharded clip casts its dtype only; use shard/gather "
                            "to move it")
        return self.map(lambda p: p.to(dtype))

    def float(self) -> Shards:
        return self.to(torch.float32)

    def permute(self, *dims) -> Shards:
        if dims[0] != 0:
            raise ValueError("a time-sharded clip keeps its batch axis first")
        return self.map(lambda p: p.permute(*dims), time_dim=dims.index(self.time_dim))

    def squeeze(self, dim: int) -> Shards:
        dim %= self.parts[0].dim()
        if dim in (0, self.time_dim):
            raise ValueError("a time-sharded clip keeps its batch and time axes")
        return self.map(lambda p: p.squeeze(dim),
                        time_dim=self.time_dim - (dim < self.time_dim))


def _cat(tensors, dim: int = 0) -> Shards:
    """``torch.cat`` of time-sharded clips along an axis other than batch and
    time (the decoders' channel concatenations)."""
    first = tensors[0]
    if not all(isinstance(t, Shards) for t in tensors):
        raise TypeError("torch.cat mixes time-sharded clips with whole tensors")
    dim %= first.parts[0].dim()
    if dim in (0, first.time_dim):
        raise ValueError("time-sharded clips concatenate along channels only")
    for t in tensors[1:]:
        first._check_like(t)
    return first.with_parts([torch.cat([t.parts[g] for t in tensors], dim)
                             for g in range(len(first.parts))])


# -- placement ---------------------------------------------------------------


def shard(mesh: Mesh, x: torch.Tensor, time_dim: int = 2) -> Shards:
    """``x`` cut along ``time_dim`` into the mesh's shards, each moved to
    its device (differentiable)."""
    n = len(mesh.devices)
    if x.shape[time_dim] % n:
        raise ValueError(f"a time axis of {x.shape[time_dim]} does not divide over {n} shards")
    chunks = x.chunk(n, time_dim)
    return Shards(mesh, [torch.cat([to_device(chunks[j], dev) for j in idx])
                         for dev, idx in groups(mesh)], x.shape[0], time_dim)


def gather(x: Shards, device=None) -> torch.Tensor:
    """The whole clip on ``device`` (the mesh's first device by default):
    the shards concatenated along time (differentiable)."""
    device = x.mesh.devices[0] if device is None else device
    return torch.cat([to_device(x.shard(j), device) for j in range(x.n)], x.time_dim)


def from_host(mesh: Mesh, array, time_dim: int = 1) -> Shards:
    """A host array cut along ``time_dim``, each device's shards copied to
    it from the host: nothing is staged on one device first."""
    a = np.asarray(array)
    n = len(mesh.devices)
    if a.shape[time_dim] % n:
        raise ValueError(f"a time axis of {a.shape[time_dim]} does not divide over {n} shards")
    t = a.shape[time_dim] // n
    cut = [slice(None)] * a.ndim
    parts = []
    for dev, idx in groups(mesh):
        rows = []
        for j in idx:
            cut[time_dim] = slice(j * t, (j + 1) * t)
            rows.append(a[tuple(cut)])
        parts.append(torch.as_tensor(np.ascontiguousarray(np.concatenate(rows)), device=dev))
    return Shards(mesh, parts, a.shape[0], time_dim)


def last_frame(x) -> torch.Tensor:
    """``x[:, -1]`` along the time axis (axis 1): from the last shard of a
    time-sharded clip."""
    if isinstance(x, Shards):
        if x.time_dim != 1:
            raise ValueError("last_frame takes a clip whose time axis is axis 1")
        return x.shard(x.n - 1)[:, -1]
    return x[:, -1]


# -- halos and reductions ------------------------------------------------------


def _frames(x: Shards, start: int, stop: int, device, fill: float) -> torch.Tensor:
    """Frames ``[start, stop)`` of the whole clip on ``device``, cut from the
    shards that hold them; ``fill`` before the first frame and past the
    last (the clip's own SAME padding)."""
    t, total, td = x.frames, x.frames * x.n, x.time_dim
    pieces, f = [], start
    while f < stop:
        if 0 <= f < total:
            s, off = divmod(f, t)
            w = min(stop, (s + 1) * t) - f
            pieces.append(to_device(x.shard(s).narrow(td, off, w), device))
        else:
            w = (min(stop, 0) if f < 0 else stop) - f
            shape = list(x.parts[0].shape)
            shape[0], shape[td] = x.batch, w
            pieces.append(torch.full(shape, fill, dtype=x.dtype, device=device))
        f += w
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, td)


def halo(x: Shards, lo: int, hi: int, fill: float = 0.0) -> list[torch.Tensor]:
    """Each device's tensor with every shard widened by the ``lo`` frames
    before it and the ``hi`` frames after it in the whole clip, ``fill``
    beyond the clip's ends: [k B, C, lo + T/N + hi, H, W] per device.  A
    halo wider than a shard reaches the shards beyond its neighbour."""
    if not (lo or hi):
        return list(x.parts)
    t, td = x.frames, x.time_dim
    out = []
    for (dev, idx), part in zip(x.groups, x.parts):
        pieces = []
        if lo:
            pieces.append(_side(x, part, idx, lo, dev, fill, before=True))
        pieces.append(part)
        if hi:
            pieces.append(_side(x, part, idx, hi, dev, fill, before=False))
        out.append(torch.cat(pieces, td))
    return out


def _side(x: Shards, part, idx, w: int, dev, fill: float, before: bool) -> torch.Tensor:
    """The ``w`` halo frames before (or after) each of a device's shards,
    stacked as the shards are.  Where the device holds consecutive shards
    and the halo is no wider than a shard, the inner shards' halos are one
    slice of the device's own tensor and only the outer shard's comes from
    another device or the fill."""
    t, td, k = x.frames, x.time_dim, len(idx)
    if w > t or k == 1 or idx != tuple(range(idx[0], idx[0] + k)):
        ends = [(j * t - w, j * t) if before else ((j + 1) * t, (j + 1) * t + w) for j in idx]
        return torch.cat([_frames(x, a, b, dev, fill) for a, b in ends])
    v = part.reshape(k, x.batch, *part.shape[1:])  # [k, B, C, t, ...]
    td += 1
    if before:
        outer = _frames(x, idx[0] * t - w, idx[0] * t, dev, fill)
        inner = v.narrow(0, 0, k - 1).narrow(td, t - w, w)
        sides = torch.cat([outer.unsqueeze(0), inner])
    else:
        outer = _frames(x, (idx[-1] + 1) * t, (idx[-1] + 1) * t + w, dev, fill)
        inner = v.narrow(0, 1, k - 1).narrow(td, 0, w)
        sides = torch.cat([inner, outer.unsqueeze(0)])
    return sides.reshape(k * x.batch, *sides.shape[2:])


def sum_to(partials, device) -> torch.Tensor:
    """The sum of per-device tensors on ``device``, in order
    (differentiable: each term's gradient goes back to its device)."""
    total = to_device(partials[0], device)
    for p in partials[1:]:
        total = total + to_device(p, device)
    return total


def per_sample_channel(x: Shards, reduce) -> list[torch.Tensor]:
    """``reduce(v)`` on each device's tensor viewed as [k, B, C, frames x
    H x W] (k shards): one [B, C] partial result per device."""
    return [reduce(p.reshape(len(idx), x.batch, p.shape[1], -1))
            for (_, idx), p in zip(x.groups, x.parts)]


def clip_mean(x: Shards) -> torch.Tensor:
    """The mean over time, height and width of every sample and channel,
    [B, C] on the mesh's first device: partial sums (float32 or wider)
    added there, over the count."""
    acc = torch.promote_types(x.dtype, torch.float32)
    sums = per_sample_channel(x, lambda v: v.sum((0, 3), dtype=acc))
    count = x.n * x.parts[0][0, 0].numel()
    return (sum_to(sums, x.mesh.devices[0]) / count).to(x.dtype)


def clip_amax(x: Shards) -> torch.Tensor:
    """The largest value over time, height and width of every sample and
    channel, [B, C] on the mesh's first device."""
    first = x.mesh.devices[0]
    maxes = per_sample_channel(x, lambda v: v.amax((0, 3)))
    return torch.stack([to_device(m, first) for m in maxes]).amax(0)


def scale_samples(x: Shards, s: torch.Tensor) -> Shards:
    """Each shard of sample b, channel c times ``s[b, c]``."""
    def one(p, k):
        v = p.reshape(k, x.batch, p.shape[1], -1) * to_device(s, p.device)[None, :, :, None]
        return v.reshape(p.shape)
    return x.with_parts([one(p, len(idx)) for (_, idx), p in zip(x.groups, x.parts)])


def shard_sums(x: Shards) -> torch.Tensor:
    """Each shard's sum of all its elements, [N] on the mesh's first
    device in shard order."""
    first = x.mesh.devices[0]
    per_group = [p.reshape(len(idx), -1).sum(1) for (_, idx), p in zip(x.groups, x.parts)]
    return torch.stack([to_device(per_group[g][pos], first) for g, pos in _places(x.mesh)])
