"""Ring attention over a time mesh (long-clip sequence parallelism).

Counterpart of ``sap3d_tpu/ops/ring_attention.py``.  A site's tokens are
time-major (``ops/attention._tokens`` flattens [B, C, D, H, W] that way),
so n contiguous shards of the token axis are n contiguous time chunks.
``ring_attend_shards`` takes the shards where they lie (one tensor per
device of the mesh, ``ops/time_shard.groups``): each shard's queries stay
on its device while the key/value shards rotate one step around the ring
per hop (``.to`` the next shard's device, the counterpart of
``lax.ppermute``; a no-op between shards on one device), and an online
softmax (running max, running sum) merges each hop's partial attention.
After n hops every query has seen every key, and each shard's output is on
its own device.  ``ring_attend_sharded`` wraps it for whole tensors: it
cuts q, k and v into shards, runs the ring and gathers the output back on
q's device.  The result is ``attend_tokens`` up to float reordering.

Two hop bodies, as in the JAX package:

* ``_ring_pallas_local`` ("pallas"): kernel B2 on the hop's shards returns
  (o_h, lse_h), merged at hop granularity in float32:
  ``new_m = max(m, lse_h); w = exp(lse_h - new_m);
  acc = acc exp(m - new_m) + o_h w; den = den exp(m - new_m) + w``.  Each
  hop runs under ``torch.utils.checkpoint``: the backward recomputes the
  hop's forward (B2 again) and runs kernel B4, whose delta takes the lse
  cotangent of the merge.
* ``_ring_local`` ("xla"): plain PyTorch, the queries in chunks of
  ``chunk_q`` rows, each chunk's online-softmax update under
  ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` inside
  ``lax.map``), so at most one [B, chunk_q, Nk/n] score block is alive.

The shards that share a device run each hop as one call, stacked along the
batch axis: on a mesh that names one card 4 times a hop is one launch, not
4 (with 4 cards, one launch per card per hop, as in the JAX package).
"""

from __future__ import annotations

import os

import torch
from torch.utils.checkpoint import checkpoint

from sap3d_tpu_torch.core.mesh import Mesh
from sap3d_tpu_torch.ops.attention import attend_tokens, flash_attend_tokens_lse
from sap3d_tpu_torch.ops.cuda.flash_attention_bwd import backward_viable
from sap3d_tpu_torch.ops.time_shard import gather, groups, shard

# Query rows per checkpointed step of the chunked hop: bounds the live score
# block to [B, RING_QUERY_CHUNK, Nk/n] float32.
RING_QUERY_CHUNK = 1024


def _checkpointed(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where autograd
    records the call."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _pallas_hop(q, k, v, *state):
    """(m, den, acc) after one kernel hop; the first hop starts the state
    from (lse_h, 1, o_h), which the merge gives from (-inf, 0, 0)."""
    o, lse = flash_attend_tokens_lse(q, k, v)
    o = o.to(lse.dtype)
    if not state:
        return lse, torch.ones_like(lse), o
    m, den, acc = state
    new_m = torch.maximum(m, lse)
    w_old = torch.exp(m - new_m)
    w_new = torch.exp(lse - new_m)
    return new_m, den * w_old + w_new, acc * w_old[..., None] + o * w_new[..., None]


def _ring_pallas_local(q, k, v, state, chunk_q):
    """One hop of the kernel ring on the shards of one device (``chunk_q``
    is unused: the kernel bounds its own working set)."""
    return _checkpointed(_pallas_hop, q, k, v, *state)


def _pallas_finish(state, dtype):
    _, den, acc = state
    return (acc / den[..., None]).to(dtype)


def _chunk_update(qc, k, v, *state):
    """(m, l, o) of one query chunk after one hop: float32 scores, p rounded
    to v's dtype before its float32-accumulated product, as the JAX chunk
    body (float64 throughout for a float64 input)."""
    acc = torch.promote_types(qc.dtype, torch.float32)
    s = torch.bmm(qc.to(acc), k.to(acc).transpose(1, 2))
    m_new = s.amax(-1) if not state else torch.maximum(state[0], s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    pv = torch.bmm(p.to(v.dtype).to(acc), v.to(acc))
    if not state:
        return m_new, p.sum(-1), pv
    m, l, o = state
    corr = torch.exp(m - m_new)
    return m_new, l * corr + p.sum(-1), o * corr[..., None] + pv


def _ring_local(q, k, v, state, chunk_q):
    """One hop of the chunked ring on the shards of one device: a list of
    each query chunk's (m, l, o)."""
    chunks = q.split(chunk_q, dim=1)
    state = state or [()] * len(chunks)
    return [_checkpointed(_chunk_update, qc, k, v, *st) for qc, st in zip(chunks, state)]


def _local_finish(state, dtype):
    return torch.cat([o / l[..., None] for _, l, o in state], dim=1).to(dtype)


_HOPS = {"pallas": (_ring_pallas_local, _pallas_finish),
         "xla": (_ring_local, _local_finish)}


def ring_attend_shards(mesh: Mesh, q, k, v, chunk_q: int = RING_QUERY_CHUNK,
                       hop_impl: str | None = None) -> list[torch.Tensor]:
    """softmax(q k^T) v of a time-sharded site: ``q``, ``k`` and ``v`` are
    one tensor per device of ``groups(mesh)``, [k B, Nq/n, d], [k B, Nk/n,
    d] and [k B, Nk/n, C], that device's k shards stacked along the batch
    axis in ring order; returns each device's output [k B, Nq/n, C] there.

    ``hop_impl``: "pallas" (the kernel hop), "xla" (the chunked hop), or
    None: ``SAP3D_RING_HOP`` if set (read at each call), else "pallas" where
    the mesh's devices are CUDA devices and ``backward_viable`` takes the
    per-shard shape, else "xla"."""
    devices, grouped = mesh.devices, groups(mesh)
    n = len(devices)
    (nq, d), (nk, c) = q[0].shape[1:], v[0].shape[1:]
    hop_impl = hop_impl or os.environ.get("SAP3D_RING_HOP")
    if hop_impl is None:
        on_cuda = all(dev.type == "cuda" for dev in devices)
        hop_impl = "pallas" if on_cuda and backward_viable(nq, nk, d, c, q[0].dtype) else "xla"
    if hop_impl not in _HOPS:
        raise ValueError(f"unknown ring hop_impl: {hop_impl!r}")
    hop, finish = _HOPS[hop_impl]

    b = q[0].shape[0] // len(grouped[0][1])
    k_sh, v_sh = [None] * n, [None] * n  # shard j's keys and values, in ring order
    for (_, idx), kp, vp in zip(grouped, k, v):
        for pos, j in enumerate(idx):
            k_sh[j], v_sh[j] = kp[pos * b:(pos + 1) * b], vp[pos * b:(pos + 1) * b]
    state = [()] * len(grouped)
    for h in range(n):
        for g, (_, idx) in enumerate(grouped):
            kk = k[g] if h == 0 else torch.cat([k_sh[j] for j in idx])
            vv = v[g] if h == 0 else torch.cat([v_sh[j] for j in idx])
            state[g] = hop(q[g], kk, vv, state[g], chunk_q)
        if h != n - 1:  # shard j takes shard j - 1's keys and values
            k_sh = [k_sh[j - 1].to(devices[j]) for j in range(n)]
            v_sh = [v_sh[j - 1].to(devices[j]) for j in range(n)]
    return [finish(st, v[0].dtype) for st in state]


def ring_attend_sharded(mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk_q: int = RING_QUERY_CHUNK,
                        hop_impl: str | None = None) -> torch.Tensor:
    """softmax(q k^T) v over whole tensors q [B, Nq, d], k [B, Nk, d], v
    [B, Nk, C]: the token axis cut into the mesh's n shards (Nq and Nk
    divisible by n), ``ring_attend_shards``, and the output gathered on q's
    device.  With n = 1 it is ``attend_tokens``."""
    n = len(mesh.devices)
    if n == 1:
        return attend_tokens(q, k, v)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"ring attention over {n} shards needs token counts divisible by "
                         f"{n}; got Nq={q.shape[1]}, Nk={k.shape[1]}")
    qs, ks, vs = (shard(mesh, t, time_dim=1) for t in (q, k, v))
    o = ring_attend_shards(mesh, qs.parts, ks.parts, vs.parts, chunk_q, hop_impl)
    return gather(qs.with_parts(o), q.device)
