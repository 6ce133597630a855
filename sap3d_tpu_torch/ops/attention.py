"""Self-attention and non-local blocks over 3D (D,H,W) token grids.

Counterpart of ``sap3d_tpu/ops/attention.py`` (``_dot_softmax_attend``,
``attend_tokens``, ``SelfAttention3D``, ``NonLocal3D``).  The semantics are
the same: scores are unscaled dot products, softmax is over the key axis,
keys and values are max-pooled by ``sub_size`` when subsampling while queries
never are, and the output is ``x + gamma * relu(norm(out_conv(o)))`` with
``gamma`` initialized to 0.

Dispatch (``attention_route``) mirrors the JAX package's rule with the port's
own gates, built on what the CUDA kernels take
(``flash_attention.forward_viable``, ``flash_attention_bwd.backward_viable``)
and on nothing of the TPU's VMEM budget:

* eval mode, autograd not recording: a site the forward gate takes goes to
  ``flash_attend`` (kernel B1); any other to ``attend_tokens``, as ``x_4_0``
  (Nq = 49, below one query block);
* train mode, or eval mode while autograd records the tokens (an input-
  gradient pass, fine-tuning under ``eval()``): the site will be
  differentiated, so a site the backward gate takes goes to ``flash_attend``
  (forward kernel B2 saving lse, backward kernel B3), any other to
  ``attend_tokens``.  The backward gate takes every attention site of the
  registry (d <= 128, C <= 1024), the GN decoders' C = 1024 site too, so
  no registry site reaches ``attend_tokens`` in train mode but the ones
  below one query block (x_4_0).  The JAX rule's hybrid route
  (``SAP3D_FLASH_HYBRID=1``: B5 where only the forward gate holds) has no
  counterpart: B5's backward on the card is B3, so it takes no site that
  ``flash_attend`` does not, and the JAX package tries flash first.
* with a time mesh (``ring_mesh``, long-clip mode), every site goes to
  ring attention, whatever its shape, as in the JAX package: its kernel hop
  is ``flash_attend_tokens_lse`` (B2 forward, B4 backward), its chunked hop
  plain PyTorch.  A whole clip is cut into shards at the site and gathered
  after it (``ring_attend_sharded``); a time-sharded clip
  (``ops/time_shard.Shards``) is projected, pooled and tokenised shard by
  shard and attends where it lies (``ring_attend_shards``).
* a time-sharded clip at a site without a ring gathers the site's tokens
  on the mesh's first device, attends there by the rules above and scatters
  the output back to the shards: the gather GSPMD makes for a global
  attention site of a time-sharded clip.  ``NonLocal3D`` always gathers so.

``flash_attend`` is the counterpart of the JAX ``flash_attend_tokens``
custom_vjp and ``flash_fwd_chunked_bwd`` of the JAX function of that name:
its forward is kernel B1 (no lse), and its backward recomputes from q, k
and v.  On the card that backward is kernels: the row-stats kernel gives
lse (``flash_attention.flash_row_stats``), and B3 (``flash_backward``:
delta = rowsum(do o) from B5's own saved output, then dq, dk, dv).  Its
plain version, for CPU tensors, recomputes ``attend_tokens`` chunk by chunk
and differentiates each chunk, so at most one ``[B, 4096, Nk]`` score block
is alive, as the JAX rule differentiates the chunked XLA path.
``flash_attend_tokens_lse`` is the counterpart of the JAX function of that
name: (o, lse) from kernel B2, and a backward that is kernel B4 (B3 when
autograd gives lse no cotangent).  Each kernel wrapper runs its plain
version on CPU tensors.  The function is the same on every route.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from sap3d_tpu_torch.ops.cuda.flash_attention import (
    flash_attend_tokens,
    flash_attend_tokens_reference as _dot_softmax_attend,
    flash_forward_lse,
    flash_row_stats,
    forward_viable,
    launch_forward,
)
from sap3d_tpu_torch.ops.cuda.flash_attention_bwd import backward_viable, flash_backward
from sap3d_tpu_torch.ops.layers import Conv3d, Norm, pool3d
from sap3d_tpu_torch.ops.time_shard import Shards, gather, shard

# Above this many query tokens, attend in query chunks so the score matrix
# is at most [B, chunk, Nk].
_CHUNKED_THRESHOLD = 4096
_QUERY_CHUNK = 4096


def attend_tokens(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unscaled dot-product attention, chunking queries when Nq is large."""
    if q.shape[1] <= _CHUNKED_THRESHOLD:
        return _dot_softmax_attend(q, k, v)
    return torch.cat([_dot_softmax_attend(qc, k, v)
                      for qc in q.split(_QUERY_CHUNK, dim=1)], dim=1)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel B2 saving (q, k, v, o, lse); backward kernel B3 on the
    cotangent cast to v's dtype (the JAX ``_fwd_rule`` / ``_bwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_forward_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_backward(q, k, v, o, lse, do.to(v.dtype).contiguous())


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused attention: kernels B2 + B3 when autograd records, B1 otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    return flash_attend_tokens(q, k, v)


@contextlib.contextmanager
def forward_kernel(replacement):
    """Route the calls that ``flash_attend`` gives B1 (the eval-mode sites
    the forward gate takes) through ``replacement(q, k, v)`` for the
    duration, and B1 again afterwards: the inference bisect's swap of kernel
    B6 (``ops/cuda/flash_attention_nolse.flash_nolse``) for B1, as the JAX
    script monkeypatches ``flash_attend_tokens``."""
    global flash_attend_tokens
    orig = flash_attend_tokens
    flash_attend_tokens = replacement
    try:
        yield
    finally:
        flash_attend_tokens = orig


class _FlashForwardChunkedBackward(torch.autograd.Function):
    """Forward kernel B1 (no lse) saving (q, k, v) and its own output o (the
    out projection holds o's storage: saving it costs no memory); the
    backward recomputes from them (the JAX ``_hybrid_fwd_rule`` /
    ``_hybrid_bwd_rule``), the cotangent in v's dtype.  On CUDA tensors:
    the row-stats kernel's lse of (q, k), then B3 on (q, k, v, o, lse, do).
    On CPU tensors, its plain version: ``attend_tokens`` one chunk of
    ``_QUERY_CHUNK`` queries at a time under ``torch.enable_grad()``, each
    chunk differentiated (``jax.vjp`` of the checkpointed ``lax.map``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if all(t.device.type == "cpu" for t in (q, k, v)):
            o = _dot_softmax_attend(q, k, v)
        else:
            # the card's backward is B3: refuse here what it would refuse
            if not backward_viable(q.shape[1], k.shape[1], q.shape[2], v.shape[2], q.dtype):
                raise ValueError(
                    f"kernel B5 takes on the card what B3 takes; got Nq={q.shape[1]}, "
                    f"Nk={k.shape[1]}, d={q.shape[2]}, C={v.shape[2]} in {q.dtype}")
            o, _ = launch_forward(q, k, v, want_lse=False)
            flash_fwd_chunked_bwd.launches += 1
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        do = do.to(v.dtype)
        if not all(t.device.type == "cpu" for t in (q, k, v)):
            lse = flash_row_stats(q, k, lse=True)
            return flash_backward(q, k, v, o, lse, do)
        kd, vd = k.detach().requires_grad_(), v.detach().requires_grad_()
        dq, dk, dv = [], None, None
        for qc, doc in zip(q.detach().split(_QUERY_CHUNK, dim=1),
                           do.split(_QUERY_CHUNK, dim=1)):
            qc = qc.requires_grad_()
            with torch.enable_grad():
                oc = _dot_softmax_attend(qc, kd, vd)
            gq, gk, gv = torch.autograd.grad(oc, (qc, kd, vd), doc)
            dq.append(gq)
            dk = gk if dk is None else dk.add_(gk)
            dv = gv if dv is None else dv.add_(gv)
        return (dq[0] if len(dq) == 1 else torch.cat(dq, dim=1)), dk, dv


def flash_fwd_chunked_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v (kernel B5): the B1 forward kernel on CUDA tensors
    (the plain version on CPU tensors) with a backward that recomputes from
    q, k and v: the row-stats kernel and B3 on CUDA tensors, the chunked
    plain attention on CPU tensors.  On CUDA tensors it takes the shapes B3
    takes (``backward_viable``) and raises on any other.
    ``flash_fwd_chunked_bwd.launches`` counts the forward kernel's launches
    made here; the backward's are counted by the wrappers of the kernels it
    launches (``flash_row_stats.launches``, ``flash_backward.launches``)."""
    return _FlashForwardChunkedBackward.apply(q, k, v)


flash_fwd_chunked_bwd.launches = 0


class _FlashAttentionLse(torch.autograd.Function):
    """Forward kernel B2 returning (o, lse [B, Nq]) and saving (q, k, v, o,
    lse); backward kernel B4 on both cotangents, or B3 when lse has none
    (the JAX ``_fwd_rule_lse`` / ``_bwd_rule_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.set_materialize_grads(False)
        o, lse = flash_forward_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(v.dtype).contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        return flash_backward(q, k, v, o, lse, do, dlse=dlse)


def flash_attend_tokens_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(softmax(q k^T) v, lse [B, Nq] float32), differentiable in both: the
    ring-attention hop body (kernels B2 and B4; their plain versions on CPU
    tensors)."""
    return _FlashAttentionLse.apply(q, k, v)


def attention_route(nq: int, nk: int, d: int, c: int, dtype: torch.dtype,
                    train: bool) -> str:
    """Where a site's tokens go: "flash" (``flash_attend``) or "plain"
    (``attend_tokens``); ``train`` says that the site will be
    differentiated, and the module docstring states the rule."""
    viable = backward_viable if train else forward_viable
    return "flash" if viable(nq, nk, d, c, dtype) else "plain"


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, D, H, W] -> contiguous [B, D*H*W, C]."""
    return x.flatten(2).transpose(1, 2).contiguous()


def _untokens(o: torch.Tensor, grid) -> torch.Tensor:
    """[B, D*H*W, C] -> [B, C, D, H, W] on the (D, H, W) ``grid``."""
    return o.transpose(1, 2).reshape(o.shape[0], -1, *grid)


def _sharded_tokens(x: Shards) -> Shards:
    """Each shard's tokens: time-major, so the token axis is cut as time."""
    return x.map(_tokens, time_dim=1)


def _gathered(x: Shards) -> torch.Tensor:
    """A time-sharded clip's tokens, [B, D*H*W, C] on the mesh's first device."""
    return gather(_sharded_tokens(x))


def _scattered(o: torch.Tensor, like: Shards) -> Shards:
    """Tokens [B, D*H*W, C] of the whole clip cut back onto ``like``'s
    shards, on ``like``'s frame grid."""
    grid = like.parts[0].shape[2:]
    return shard(like.mesh, o, time_dim=1).map(lambda p: _untokens(p, grid), time_dim=2)


class SelfAttention3D(nn.Module):
    """SAGAN-style global self-attention over D*H*W tokens (NCDHW in/out).

    f/g project to max(1, C//8) channels, h to C, each a biased 1x1x1 conv
    (the JAX package's default "separate" projections).  With
    ``use_kernel=False`` every size takes ``attend_tokens`` (the plain path,
    to compare the kernel path against; with a ``ring_mesh``, the ring's
    chunked hop); otherwise the dispatch rule above applies.  ``ring_mesh``
    (``core/mesh.make_time_mesh``) holds no parameters: the state dict is
    the same with and without it.

    A time-sharded clip runs every projection, pool, norm and the residual
    shard by shard; the attention is the ring on the shards where they lie
    with a ``ring_mesh`` (the clip's own mesh), else the site's tokens are
    gathered on the mesh's first device and the output scattered back (the
    gather GSPMD makes for a global attention site)."""

    def __init__(self, features: int, norm_mode: str = "bn",
                 subsample: bool = False, sub_size: int = 2,
                 dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True, ring_mesh=None):
        super().__init__()
        inter = max(1, features // 8)
        self.subsample = subsample
        self.sub_size = sub_size
        self.use_kernel = use_kernel
        self.ring_mesh = ring_mesh
        self.f = Conv3d(features, inter, 1, dtype=dtype)
        self.g = Conv3d(features, inter, 1, dtype=dtype)
        self.h = Conv3d(features, features, 1, dtype=dtype)
        self.out = Conv3d(features, features, 1, dtype=dtype)
        self.Norm_0 = Norm(norm_mode, features, dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        f, g, hv = self.f(x), self.g(x), self.h(x)
        if self.subsample:
            f = pool3d(f, self.sub_size)
            hv = pool3d(hv, self.sub_size)
        if isinstance(x, Shards):
            o = self._attend_shards(g, f, hv)
        else:
            o = _untokens(self._attend(_tokens(g), _tokens(f), _tokens(hv)), x.shape[2:])
        o = F.relu(self.Norm_0(self.out(o)))
        return x + self.gamma.to(x.dtype) * o

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The attention of whole-clip tokens by the module docstring's rule."""
        # a site autograd records is differentiated, whatever the mode
        train = self.training or (torch.is_grad_enabled() and q.requires_grad)
        if self.ring_mesh is not None:
            from sap3d_tpu_torch.ops.ring_attention import ring_attend_sharded

            return ring_attend_sharded(self.ring_mesh, q, k, v,
                                       hop_impl=None if self.use_kernel else "xla")
        if self.use_kernel and attention_route(q.shape[1], k.shape[1], q.shape[2],
                                               v.shape[2], q.dtype, train) == "flash":
            return flash_attend(q, k, v)
        return attend_tokens(q, k, v)

    def _attend_shards(self, g: Shards, f: Shards, hv: Shards) -> Shards:
        """The attention of a time-sharded clip, as time-sharded outputs on
        g's frame grid: the ring in place, or GSPMD's gather."""
        if self.ring_mesh is None:
            o = self._attend(_gathered(g), _gathered(f), _gathered(hv))
            return _scattered(o, g)
        from sap3d_tpu_torch.ops.ring_attention import ring_attend_shards

        if self.ring_mesh != g.mesh:
            raise ValueError("a ring site's mesh differs from its clip's time mesh")
        q, k, v = (_sharded_tokens(t).parts for t in (g, f, hv))
        o = ring_attend_shards(g.mesh, q, k, v, hop_impl=None if self.use_kernel else "xla")
        grid = g.parts[0].shape[2:]
        return g.with_parts([_untokens(p, grid) for p in o])


class NonLocal3D(nn.Module):
    """Dot-product non-local block (NCDHW in/out): theta/phi/g project to
    C//2 channels with biased 1x1x1 convs; the scores are divided by the
    key-token count (no softmax); the output passes a 1x1x1 conv, a batch
    norm (always BN, whatever the model's norm mode) and a relu, and is added
    to the input.  ``sub_sample`` pools keys and values (phi, g) by 2.

    A time-sharded clip runs the projections, pools, norm and residual
    shard by shard; the scores are global over the keys, so the tokens are
    gathered on the mesh's first device and the output scattered back to
    the shards (as GSPMD gathers a global site)."""

    def __init__(self, features: int, sub_sample: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if features < 2:
            raise ValueError(f"NonLocal3D needs >=2 channels, got {features}")
        inter = features // 2
        self.sub_sample = sub_sample
        self.g = Conv3d(features, inter, 1, dtype=dtype)
        self.theta = Conv3d(features, inter, 1, dtype=dtype)
        self.phi = Conv3d(features, inter, 1, dtype=dtype)
        self.w_y = Conv3d(inter, features, 1, dtype=dtype)
        self.Norm_0 = Norm("bn", features, dtype)

    def forward(self, x):
        g_x, theta, phi = self.g(x), self.theta(x), self.phi(x)
        if self.sub_sample:
            g_x, phi = pool3d(g_x, 2), pool3d(phi, 2)
        if isinstance(x, Shards):
            y = _scattered(self._attend(_gathered(theta), _gathered(phi), _gathered(g_x)),
                           theta)
        else:
            y = _untokens(self._attend(_tokens(theta), _tokens(phi), _tokens(g_x)),
                          x.shape[2:])
        return x + F.relu(self.Norm_0(self.w_y(y)))

    @staticmethod
    def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        # float32 scores (float64 for a float64 input), cast to v's dtype
        # before the product, which accumulates in float32 (the JAX block's
        # preferred_element_type)
        acc = torch.promote_types(q.dtype, torch.float32)
        scores = torch.bmm(q.to(acc), k.to(acc).transpose(1, 2)) / float(k.shape[1])
        return torch.bmm(scores.to(v.dtype), v)
