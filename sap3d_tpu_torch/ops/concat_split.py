"""Concat-free dense-skip convolution (``SAP3D_CONCAT_SPLIT``).

Counterpart of ``sap3d_tpu/ops/concat_split.py``.  The UNet++ decoder's conv
sites take channel-concatenated skips, ``conv3d(cat([a, b], 1), W)``.  A
convolution is linear in its input channels, so that is
``conv3d(a, W[:, :Ca]) + conv3d(b, W[:, Ca:])``, and the concatenated tensor
never has to exist.  The layer keeps its one fused ``[F, sum Ci, kd, kh,
kw]`` kernel and bias (the state dict is unchanged); the kernel is sliced
per part at call time.  Rounding follows the JAX function: each part's conv
output is in the compute dtype, the parts are added in that dtype, then the
bias.  Under ``SAP3D_CONV3D_VIA_2D`` each part's conv runs the 2-D
formulation (``ops/conv2d_path.py``).

The flags are read when a layer is built (``conv_norm_relu``), as
the JAX package's readers are, and never per call: the eager step is bound
by host launches, and a captured step (``train/steps.CapturedMultiStep``)
fixes the schedule at capture anyway.  Tests set the variables before they
build a model.

The port's default differs from the JAX package's: the split is off unless
``SAP3D_CONCAT_SPLIT=1`` (the JAX default "on" rests on a TPU measurement,
which says nothing of the card).  ``SAP3D_CONCAT_EAGER_SITES=x_1_1,x_2_1``
keeps the named sites eager while the split is on.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from sap3d_tpu_torch.ops.conv2d_path import Conv3dVia2D, conv3d_via_2d, conv3d_via_2d_enabled
from sap3d_tpu_torch.ops.layers import Conv3d, ConvNormRelu, _triple, column_parallel, same_pads


def concat_split_enabled() -> bool:
    """``SAP3D_CONCAT_SPLIT=1`` runs the dense-skip convs per part (off by
    default in the port)."""
    return os.environ.get("SAP3D_CONCAT_SPLIT", "0") == "1"


def eager_concat_sites() -> frozenset[str]:
    """The sites named in ``SAP3D_CONCAT_EAGER_SITES`` (comma-separated):
    these concatenate eagerly even while the split is on."""
    raw = os.environ.get("SAP3D_CONCAT_EAGER_SITES", "")
    return frozenset(s.strip() for s in raw.split(",") if s.strip())


def split_site(site: str | None) -> bool:
    """Whether the conv at ``site`` runs per part."""
    return concat_split_enabled() and site not in eager_concat_sites()


def _same_conv(strides, via_2d: bool) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    def conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        if via_2d and strides[0] == 1:
            return conv3d_via_2d(x, kernel, None, strides)
        pads = [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], kernel.shape[2:], strides)]
        (dl, dh), (hl, hh), (wl, wh) = pads
        return F.conv3d(F.pad(x, (wl, wh, hl, hh, dl, dh)), kernel, None, strides)
    return conv


def conv3d_concat_split(parts: Sequence, kernel: torch.Tensor, bias: torch.Tensor | None,
                        strides=(1, 1, 1), via_2d: bool = False, conv=None):
    """The SAME conv of ``cat(parts, 1)`` with ``kernel`` [F, sum Ci, kd, kh,
    kw], without the concat: ``conv(part, kernel slice)`` per part (the
    plain SAME conv, or the 2-D formulation with ``via_2d``, by default),
    the outputs added in order, then ``bias``."""
    total = sum(p.shape[1] for p in parts)
    if kernel.shape[1] != total:
        raise ValueError(f"kernel expects {kernel.shape[1]} input channels, parts supply {total}")
    conv = conv or _same_conv(tuple(strides), via_2d)
    out, off = None, 0
    for p in parts:
        ci = p.shape[1]
        y = conv(p, kernel[:, off:off + ci])
        off += ci
        out = y if out is None else out + y
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1, 1)
    return out


def split_conv(layer: Conv3d, parts: Sequence):
    """``layer`` (a ``Conv3d`` over the concatenated parts) run per part:
    whole tensors, time-sharded clips (each part's halos) or, for a
    column-parallel layer, this rank's slice of the output features."""
    parts = [p.to(layer.dtype) for p in parts]

    def local(ps, with_bias: bool):
        bias = layer.bias.to(layer.dtype) if with_bias and layer.bias is not None else None
        return conv3d_concat_split(ps, layer.kernel, bias, layer.strides,
                                   conv=lambda p, k: layer.conv(p, k, with_bias=False))

    if layer.model_group is not None:
        return column_parallel(tuple(parts), layer.model_group,
                               lambda ps: local(ps, False), layer.bias, 1)
    return local(parts, True)


def conv_norm_relu(in_features: int, features: int, kernel=3, strides=1,
                   site: str | None = None, **kw) -> ConvNormRelu:
    """A ``ConvNormRelu`` on the conv path the layout variables pick, read
    now: ``split_conv`` over its parts where ``split_site(site)``, and
    ``Conv3dVia2D`` under ``SAP3D_CONV3D_VIA_2D=1`` where the temporal
    stride is 1.  ``kw`` goes to ``ConvNormRelu``."""
    via_2d = conv3d_via_2d_enabled() and _triple(strides)[0] == 1
    return ConvNormRelu(in_features, features, kernel, strides,
                        conv=Conv3dVia2D if via_2d else Conv3d,
                        split=split_conv if split_site(site) else None, **kw)
