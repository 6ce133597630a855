"""Space-to-depth stem convolution (``SAP3D_STEM_S2D``).

Counterpart of ``sap3d_tpu/ops/stem_s2d.py``.  The encoder stem is a
(1, 7, 7) conv of stride (1, 2, 2) over 3-channel frames.  Because the
output grid of a stride-2 conv is the input's 2x2 block grid, the same
operator is a stride-1 VALID conv over a 2x2 space-to-depth view of the
SAME-padded input (3 -> 12 channels), against the kernel with each tap t
split into (block offset t // 2, phase t % 2), odd taps padded with zeros
to a full phase pair (7 -> 8 taps):

    out[y, x] = sum_{jy,jx,py,px,c} W[2jy+py, 2jx+px, c] S[y+jy, x+jx, (py,px,c)]

with S[u, v, (py, px, c)] = P[2u+py, 2v+px, c] and P the padded input,
which takes one trailing zero row and column beyond the SAME padding so
that its length is even (``_dim_pads``).

``StemConv`` is a ``Conv3d`` (the stem's ``kernel`` parameter, unchanged)
that runs this formulation where ``stem_s2d_enabled()`` held when it was
built and H and W are even, and the plain strided conv elsewhere.  The flag
is read once, when the layer is built; a captured step fixes the schedule
at capture anyway.  The stem's temporal kernel is 1, so a time-sharded clip
takes it shard by shard with no halo.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from sap3d_tpu_torch.ops.layers import Conv3d, in_memory_format_of


def stem_s2d_enabled() -> bool:
    """``SAP3D_STEM_S2D=1`` opts in (off by default, as in the JAX
    package)."""
    return os.environ.get("SAP3D_STEM_S2D", "0") == "1"


def _dim_pads(k: int) -> tuple[int, int]:
    """(lo, hi) padding of one stride-2 spatial axis of even length: lo is
    the SAME padding's (``ops/layers.same_pads``), hi the SAME padding's
    plus one trailing zero where the padded length would be odd."""
    total = max(k - 2, 0)
    lo = total // 2
    hi = 2 * ((k + 1) // 2) - 2 - lo
    return lo, hi


def conv_stem_s2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """conv(x, kernel, strides (1, 2, 2), SAME) via 2x2 space-to-depth:
    ``x`` NCDHW with even H and W, ``kernel`` [F, C, 1, kh, kw]."""
    cout, cin, kd, kh, kw = kernel.shape
    b, c, t, h, w = x.shape
    if kd != 1:
        raise ValueError(f"stem s2d path needs a (1, kh, kw) kernel, got kd={kd}")
    if h % 2 or w % 2:
        raise ValueError(f"stem s2d path needs even H, W, got {h}x{w}")
    jh, jw = (kh + 1) // 2, (kw + 1) // 2
    (hl, hh), (wl, wh) = _dim_pads(kh), _dim_pads(kw)
    # the JAX function's NDHWC formulation (the model's frames are channels-last
    # in memory); the output takes x's memory format, as the plain conv's does
    xp = F.pad(x.permute(0, 2, 3, 4, 1), (0, 0, wl, wh, hl, hh))
    hp, wp = xp.shape[2], xp.shape[3]
    # space-to-depth: [B, T, hp, wp, C] -> [B, T, hp/2, wp/2, (py, px, C)]
    s = xp.reshape(b, t, hp // 2, 2, wp // 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    s = s.reshape(b, t, hp // 2, wp // 2, 4 * c).permute(0, 4, 1, 2, 3)
    # kernel: taps padded to full phase pairs, re-blocked to [F, (py, px, C), 1, jh, jw]
    kp = F.pad(kernel, (0, 2 * jw - kw, 0, 2 * jh - kh))
    k2 = kp.reshape(cout, cin, 1, jh, 2, jw, 2)
    k2 = k2.permute(0, 4, 6, 1, 2, 3, 5).reshape(cout, 4 * cin, 1, jh, jw)
    return in_memory_format_of(F.conv3d(s, k2), x)


class StemConv(Conv3d):
    """The encoder stem: (1, k, k) conv, stride (1, 2, 2), SAME, no bias;
    with ``s2d`` it runs ``conv_stem_s2d`` on frames of even H and W."""

    def __init__(self, in_features: int, features: int, kernel_hw: int = 7,
                 dtype: torch.dtype = torch.float32, s2d: bool = False):
        super().__init__(in_features, features, (1, kernel_hw, kernel_hw), (1, 2, 2),
                         use_bias=False, dtype=dtype)
        self.s2d = s2d

    def _conv(self, x: torch.Tensor, time_pads: tuple[int, int],
              kernel: torch.Tensor | None = None, with_bias: bool = True) -> torch.Tensor:
        if self.s2d and x.shape[3] % 2 == 0 and x.shape[4] % 2 == 0:
            return conv_stem_s2d(x, self._kernel(x, kernel))
        return super()._conv(x, time_pads, kernel, with_bias)
