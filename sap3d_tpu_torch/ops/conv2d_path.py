"""A 3-D convolution computed as one 2-D convolution (``SAP3D_CONV3D_VIA_2D``).

Counterpart of ``sap3d_tpu/ops/conv2d_path.py``.  A [kd, kh, kw] conv over
[B, C, D, H, W] with temporal stride 1 equals one [kh, kw] 2-D conv over
[B*D, kd*C, H, W], whose channel blocks are the kd temporally shifted copies
of the input (zero-padded at the clip's ends: TF-SAME in D, front
``(kd - 1) // 2``), against the kernel re-blocked to [F, kd*C, kh, kw] in the
same t-major order.  The bias is added after the conv, in the compute dtype,
as the JAX function adds it.

``Conv3dVia2D`` is a ``Conv3d`` (the same ``kernel``/``bias`` parameters,
so state dicts and checkpoints are unchanged) whose convolution runs this
formulation; ``ops/concat_split.conv_norm_relu`` builds it when
``conv3d_via_2d_enabled()`` and the temporal stride is 1.  The flag is read
when the layer is built, not per call: a captured step
(``train/steps.CapturedMultiStep``) fixes the schedule at capture anyway.
A time-sharded clip takes the layer's halos and then this conv with no
temporal padding; a column-parallel layer (tensor parallel) runs it on its
slice of the kernel.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from sap3d_tpu_torch.ops.layers import Conv3d, in_memory_format_of, same_pads


def conv3d_via_2d_enabled() -> bool:
    """``SAP3D_CONV3D_VIA_2D=1`` opts in (off by default, as in the JAX
    package)."""
    return os.environ.get("SAP3D_CONV3D_VIA_2D") == "1"


def conv3d_via_2d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None,
                  strides=(1, 1, 1), time_pads: tuple[int, int] | None = None) -> torch.Tensor:
    """SAME-padded 3-D conv of NCDHW ``x`` with ``kernel`` [F, C, kd, kh, kw]
    as one 2-D conv (temporal stride 1 only).  ``time_pads`` (lo, hi)
    replaces the temporal SAME padding (a time shard's halo is already on
    ``x``)."""
    f, cin, kd, kh, kw = kernel.shape
    sd, sh, sw = strides
    if sd != 1:
        raise ValueError("conv3d_via_2d supports unit temporal stride only")
    if time_pads is None:
        time_pads = ((kd - 1) // 2, kd - 1 - (kd - 1) // 2)
    # the JAX function's NDHWC formulation: the model's activations are
    # channels-last in memory (its input's order), so these views cost no copy;
    # the output takes x's memory format, as the plain conv's does
    xn = x.permute(0, 2, 3, 4, 1)
    if any(time_pads):
        xn = F.pad(xn, (0, 0, 0, 0, 0, 0, *time_pads))
    b, d, h, w, c = xn.shape
    d -= kd - 1
    if kd > 1:  # kd temporally shifted views, stacked on channels (t-major blocks)
        xn = torch.cat([xn[:, t:t + d] for t in range(kd)], dim=-1)
    (hl, hh), (wl, wh) = same_pads(h, kh, sh), same_pads(w, kw, sw)
    x2 = xn.reshape(b * d, h, w, kd * c).permute(0, 3, 1, 2)  # NCHW view, channels-last
    if hl == hh and wl == wh:
        padding = (hl, wl)
    else:
        x2 = F.pad(x2, (wl, wh, hl, hh))
        padding = 0
    # [F, C, kd, kh, kw] -> [F, kd*C, kh, kw] with the same t-major blocks
    k2 = kernel.transpose(1, 2).reshape(f, kd * cin, kh, kw)
    y = F.conv2d(x2, k2, None, (sh, sw), padding)
    y = y.permute(0, 2, 3, 1).reshape(b, d, y.shape[2], y.shape[3], f).permute(0, 4, 1, 2, 3)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1, 1)
    return in_memory_format_of(y, x)


class Conv3dVia2D(Conv3d):
    """``Conv3d`` running ``conv3d_via_2d`` (temporal stride 1; any other
    stride takes the plain conv)."""

    def _conv(self, x: torch.Tensor, time_pads: tuple[int, int],
              kernel: torch.Tensor | None = None, with_bias: bool = True) -> torch.Tensor:
        if self.strides[0] != 1:
            return super()._conv(x, time_pads, kernel, with_bias)
        return conv3d_via_2d(x, self._kernel(x, kernel), self._bias(x, with_bias),
                             self.strides, time_pads)
