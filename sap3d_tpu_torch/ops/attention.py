"""Self-attention over 3D (D,H,W) token grids.

Counterpart of ``sap3d_tpu/ops/attention.py`` (``_dot_softmax_attend``,
``attend_tokens``, ``SelfAttention3D``).  The semantics are the same: scores
are unscaled dot products, softmax is over the key axis, keys and values
are max-pooled by ``sub_size`` when subsampling while queries never are, and
the output is ``x + gamma * relu(norm(out_conv(o)))`` with ``gamma``
initialized to 0.

Dispatch mirrors the JAX package: where the query count reaches one block of
the fused kernels (``BLOCK_Q`` = 256) the tokens go to ``flash_attend``;
otherwise to ``attend_tokens``, as JAX does at ``x_4_0`` (Nq = 49).
``flash_attend`` is the counterpart of the JAX ``flash_attend_tokens``
custom_vjp: under autograd its forward is kernel B2 (o and lse) and its
backward kernel B3; without autograd it is kernel B1, as the custom_vjp
primal.  Each kernel wrapper runs its plain version on CPU tensors, so the
CPU path computes the same one-exp backward formula.  One difference is
deliberate: JAX's training gate (``flash_attention_viable``) sends an fp32
x_2_2 site to ``attend_tokens`` because of the TPU's VMEM budget; the port
keeps "Nq >= BLOCK_Q" in both dtypes (the same function either way).
``ring_mesh`` and ``NonLocal3D`` port in later slices (ROADMAP A.9, A.11).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sap3d_tpu_torch.ops.cuda.flash_attention import (
    BLOCK_Q,
    flash_attend_tokens,
    flash_attend_tokens_reference as _dot_softmax_attend,
    flash_forward_lse,
)
from sap3d_tpu_torch.ops.cuda.flash_attention_bwd import flash_backward
from sap3d_tpu_torch.ops.layers import Conv3d, Norm, pool3d

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


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, D, H, W] -> contiguous [B, D*H*W, C]."""
    return x.flatten(2).transpose(1, 2).contiguous()


class SelfAttention3D(nn.Module):
    """SAGAN-style global self-attention over D*H*W tokens (NCDHW in/out).

    f/g project to max(1, C//8) channels, h to C, each a biased 1x1x1 conv
    (the JAX package's default "separate" projections).  With
    ``use_kernel=False`` every size takes ``attend_tokens`` (the plain path,
    to compare the kernel path against); otherwise the dispatch rule above
    applies."""

    def __init__(self, features: int, norm_mode: str = "bn",
                 subsample: bool = False, sub_size: int = 2,
                 dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True):
        super().__init__()
        inter = max(1, features // 8)
        self.subsample = subsample
        self.sub_size = sub_size
        self.use_kernel = use_kernel
        self.f = Conv3d(features, inter, 1, dtype=dtype)
        self.g = Conv3d(features, inter, 1, dtype=dtype)
        self.h = Conv3d(features, features, 1, dtype=dtype)
        self.out = Conv3d(features, features, 1, dtype=dtype)
        self.Norm_0 = Norm(norm_mode, features, dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f, g, hv = self.f(x), self.g(x), self.h(x)
        if self.subsample:
            f = pool3d(f, self.sub_size)
            hv = pool3d(hv, self.sub_size)
        q, k, v = _tokens(g), _tokens(f), _tokens(hv)
        if self.use_kernel and q.shape[1] >= BLOCK_Q:
            o = flash_attend(q, k, v)
        else:
            o = attend_tokens(q, k, v)
        o = o.transpose(1, 2).reshape(g.shape[0], -1, *x.shape[2:])
        o = F.relu(self.Norm_0(self.out(o)))
        return x + self.gamma.to(x.dtype) * o
