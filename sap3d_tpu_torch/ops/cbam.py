"""CBAM (channel + spatial attention) and SE blocks for NCDHW tensors.

Counterpart of ``sap3d_tpu/ops/cbam.py``.  The channel attention applies one
shared two-layer MLP to the global-average and the global-max pooled
descriptors, sums, sigmoids and scales; the spatial attention concatenates
the channel-mean and channel-max maps, runs a 7x7x7 conv without bias,
sigmoids and scales.  These are bandwidth-bound reductions and elementwise
passes that the JAX package leaves to XLA; here they are plain PyTorch ops.

Parameter names follow the flax modules (``ch_at/mlp_0``, ``ch_at/mlp_1``,
``sp_at/conv3d``, ``squeeze``, ``excite``).  A ``Dense`` kernel is stored
``[out, in]`` (flax: ``[in, out]``; ``interop/flax_bridge.py`` transposes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sap3d_tpu_torch.ops.layers import Conv3d

# Standard deviation of a unit normal truncated at +-2, by which flax's
# variance_scaling(..., "truncated_normal") divides its scale.
_TRUNCATED_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, fan_in: int) -> None:
    """flax ``variance_scaling(2.0, "fan_in", "truncated_normal")``."""
    std = (2.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


class Dense(nn.Module):
    """``nn.Dense`` (flax) twin on the last axis; ``kernel`` is ``[out, in]``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        _variance_scaling_(self.kernel, in_features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype),
                        self.bias.to(self.dtype))


class ChannelAttention3D(nn.Module):
    """Shared-MLP channel attention: x * sigmoid(mlp(avg) + mlp(max))."""

    def __init__(self, features: int, ratio: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = max(1, features // ratio)
        self.mlp_0 = Dense(features, hidden, dtype)
        self.mlp_1 = Dense(hidden, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = self.mlp_1(F.relu(self.mlp_0(x.mean(dim=(2, 3, 4)))))
        mx = self.mlp_1(F.relu(self.mlp_0(x.amax(dim=(2, 3, 4)))))
        return x * torch.sigmoid(avg + mx)[:, :, None, None, None]


class SpatialAttention3D(nn.Module):
    """x * sigmoid(conv7x7x7([mean_c, max_c])), 'SAME', no bias."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv3d = Conv3d(2, 1, 7, use_bias=False, dtype=dtype)
        _variance_scaling_(self.conv3d.kernel, 2 * 7 ** 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv3d(cat))


class CBAM(nn.Module):
    """Channel attention, then spatial attention."""

    def __init__(self, features: int, ratio: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch_at = ChannelAttention3D(features, ratio, dtype)
        self.sp_at = SpatialAttention3D(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sp_at(self.ch_at(x))


class SEBlock3D(nn.Module):
    """Squeeze-and-excitation: x * sigmoid(excite(relu(squeeze(mean(x)))))."""

    def __init__(self, features: int, ratio: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.squeeze = Dense(features, max(1, features // ratio), dtype)
        self.excite = Dense(max(1, features // ratio), features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.excite(F.relu(self.squeeze(x.mean(dim=(2, 3, 4))))))
        return x * s[:, :, None, None, None]
