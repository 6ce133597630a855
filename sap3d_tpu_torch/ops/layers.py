"""Core op library: pooling, normalization, conv blocks.

Counterpart of ``sap3d_tpu/ops/layers.py``.  The JAX package is NDHWC and
'SAME' padded; here the modules work on NCDHW tensors (cuDNN's layout) and
the TF-style 'SAME' padding is written out explicitly: at stride 2 it is
asymmetric (more on the high side), which torch's symmetric ``padding=``
cannot express.  Callers convert layouts once at the model boundary
(``models/p3d.py``).

Parameter names follow the flax modules (``kernel``, ``bias``, ``scale``,
``mean``, ``var``; submodules ``Conv_0``, ``ConvTranspose_0``, ``Norm_0``,
``BatchNorm_0``, ``GroupNorm_0``) so that a flax variable path maps to a
torch ``state_dict`` key by replacing ``/`` with ``.``
(``interop/flax_bridge.py``).  Only the kernels change layout: a conv
kernel is stored ``[out, in, kd, kh, kw]`` and a transposed-conv kernel
``[in, out, kd, kh, kw]``, spatially flipped.

Mixed precision follows flax's ``dtype=`` rule: parameters stay float32 and
each module casts its weights and input to the compute dtype at call time.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _triple(v) -> tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 values, got {v!r}")
    return t


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF/XLA 'SAME' padding (low, high) of one axis of length ``n``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel, strides, value: float = 0.0) -> torch.Tensor:
    """Pad the D,H,W axes of an NCDHW tensor for a 'SAME' window op."""
    pads = [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], kernel, strides)]
    if not any(lo or hi for lo, hi in pads):
        return x
    (dl, dh), (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh, dl, dh), value=value)


def max_pool3d(
    x: torch.Tensor,
    window: Sequence[int] | int,
    strides: Sequence[int] | int,
    padding: str = "SAME",
) -> torch.Tensor:
    """3D max pool over the D,H,W axes of an NCDHW tensor.

    'SAME' pads with -inf, as XLA's reduce_window does (e.g. the stem pool
    (2,3,3)/(2,2,2) on 56x56 pads H/W by (0, 1))."""
    w, s = _triple(window), _triple(strides)
    if padding == "SAME":
        x = pad_same(x, w, s, value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return F.max_pool3d(x, w, s)


def pool3d(x: torch.Tensor, sub_size: int) -> torch.Tensor:
    """Cubic max-pool, kernel == stride == sub_size, VALID padding."""
    if sub_size == 1:
        return x
    return max_pool3d(x, sub_size, sub_size, padding="VALID")


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   inside_weights: torch.Tensor | float = 1.0,
                   outside_weights: torch.Tensor | float = 1.0,
                   sigma: float = 1.0) -> torch.Tensor:
    """Huber-style smooth-L1 summed over every element (``sap3d_tpu``
    ``smooth_l1_loss``).  The quadratic/linear switch factor is a constant
    to the gradient (detached), as the JAX package's ``stop_gradient``."""
    sigma2 = sigma ** 2
    diff = (pred - target) * inside_weights
    abs_diff = diff.abs()
    is_small = (abs_diff < 1.0 / sigma2).to(diff.dtype).detach()
    per_elem = diff.square() * (sigma2 / 2.0) * is_small \
        + (abs_diff - 0.5 / sigma2) * (1.0 - is_small)
    return (per_elem * outside_weights).sum()


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int) -> None:
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        w.uniform_(-bound, bound)


class Conv3d(nn.Module):
    """``nn.Conv`` (flax) twin: SAME-padded 3D conv, Glorot-uniform init.

    ``kernel`` is ``[out, in, kd, kh, kw]``."""

    def __init__(self, in_features: int, features: int, kernel=3, strides=1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ksize = _triple(kernel)
        self.strides = _triple(strides)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, *self.ksize))
        vol = self.ksize[0] * self.ksize[1] * self.ksize[2]
        _glorot_(self.kernel, in_features * vol, features * vol)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pads = [same_pads(n, k, s) for n, k, s in
                zip(x.shape[2:], self.ksize, self.strides)]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)  # symmetric: let cuDNN pad
        else:
            x = pad_same(x, self.ksize, self.strides)
            padding = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv3d(x, self.kernel.to(self.dtype), bias, self.strides, padding)


def tconv_same_crop(n: int, k: int, s: int) -> tuple[int, int]:
    """(crop start, output_padding) that make ``conv_transpose(padding=0)``
    with the flipped kernel equal XLA's 'SAME' transposed conv on one axis.

    XLA pads the stride-dilated input by ``pad_a`` before the window
    (``lax._conv_transpose_padding``); torch's full transposed conv is that
    correlation shifted by ``k - 1 - pad_a``.  The output is ``n * s`` long;
    where torch's ``(n - 1) * s + k`` falls short (k=1, s=2) the shortfall
    becomes ``output_padding``."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    start = k - 1 - pad_a
    extra = start + n * s - ((n - 1) * s + k)
    if extra >= s:
        raise ValueError(f"SAME transposed conv k={k} s={s} needs "
                         f"output_padding {extra} >= stride")
    return start, max(extra, 0)


class ConvTranspose3d(nn.Module):
    """``nn.ConvTranspose`` (flax, ``transpose_kernel=False``) twin: 'SAME'
    padding, output = input * stride.

    ``kernel`` is ``[in, out, kd, kh, kw]`` and already flipped on the three
    spatial axes relative to flax's ``[kd, kh, kw, in, out]``."""

    def __init__(self, in_features: int, features: int, kernel=3, strides=2,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ksize = _triple(kernel)
        self.strides = _triple(strides)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features, *self.ksize))
        vol = self.ksize[0] * self.ksize[1] * self.ksize[2]
        _glorot_(self.kernel, in_features * vol, features * vol)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        crops = [tconv_same_crop(n, k, s) for n, k, s in
                 zip(x.shape[2:], self.ksize, self.strides)]
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv_transpose3d(
            x, self.kernel.to(self.dtype), bias, self.strides,
            output_padding=tuple(op for _, op in crops),
        )
        (d0, _), (h0, _), (w0, _) = crops
        d, h, w = (n * s for n, s in zip(x.shape[2:], self.strides))
        return y[:, :, d0:d0 + d, h0:h0 + h, w0:w0 + w]


class BatchNorm(nn.Module):
    """``nn.BatchNorm`` (flax, momentum 0.99, epsilon 1e-3) twin.

    Eval mode normalizes with the running statistics.  Train mode normalizes
    with the batch mean and biased variance and moves the running
    statistics with those same batch statistics, under ``no_grad``, as flax
    does: ``running = 0.99 * running + 0.01 * batch``.  The buffers are not
    handed to the batch-norm call in train mode: torch would move ``var``
    with the unbiased variance.  The statistics are float32 from the
    compute-dtype input, as flax's; the variance is read back from the
    call's inverse standard deviation (``invstd^-2 - eps``), where flax
    takes ``max(0, E[x^2] - E[x]^2)``: the two differ by float32 rounding.

    Both modes are one batch-norm call on the input in the compute dtype
    with float32 statistics and affine parameters: PyTorch normalizes such
    mixed inputs in float32 and returns the compute dtype, as flax does.

    With ``batch_stats_at_eval`` eval mode normalizes as train mode does,
    with the batch mean and biased variance, and leaves the running
    statistics where they are: the reference's bottleneck BNs at inference
    (``models/p3d.py:Bottleneck``, ``bn_reference_quirk``), whose statistics
    update the JAX eval step discards."""

    eps = 1e-3
    momentum = 0.99  # flax convention: running = m * running + (1 - m) * batch

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 batch_stats_at_eval: bool = False):
        super().__init__()
        self.dtype = dtype
        self.batch_stats_at_eval = batch_stats_at_eval
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.training and not self.batch_stats_at_eval:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(x, self.scale, self.bias, None, None,
                                                  True, 0.0, self.eps)
        if not self.training:
            return y
        with torch.no_grad():
            var = (invstd.float().square().reciprocal() - self.eps).clamp_min(0.0)
            self.mean.mul_(self.momentum).add_(mean.float(), alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return y


class GroupNorm(nn.Module):
    """``nn.GroupNorm`` (flax) twin: G = min(32, C) groups, eps 1e-5."""

    eps = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.groups = min(32, features)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, self.scale, self.bias, self.eps)
        return y.to(self.dtype)


class Norm(nn.Module):
    """Dispatch BatchNorm / GroupNorm / identity (``sap3d_tpu`` ``Norm``);
    ``batch_stats_at_eval`` reaches the BatchNorm alone."""

    def __init__(self, mode: str, features: int, dtype: torch.dtype = torch.float32,
                 batch_stats_at_eval: bool = False):
        super().__init__()
        self.mode = mode
        if mode == "bn":
            self.BatchNorm_0 = BatchNorm(features, dtype, batch_stats_at_eval)
        elif mode == "gn":
            self.GroupNorm_0 = GroupNorm(features, dtype)
        elif mode != "none":
            raise ValueError(f"unknown norm mode {mode!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "bn":
            return self.BatchNorm_0(x)
        if self.mode == "gn":
            return self.GroupNorm_0(x)
        return x


def _cat(x) -> torch.Tensor:
    """A tuple of channel-concat parts (the decoders' dense skips) becomes
    one tensor; the fused ``[out, sum(Ci), ...]`` kernel then runs once."""
    if isinstance(x, (tuple, list)):
        return torch.cat(list(x), dim=1)
    return x


class ConvNormRelu(nn.Module):
    """conv3d -> norm -> relu.  Accepts a tuple of parts, concatenated on
    the channel axis (the JAX package's split-conv of the parts is a TPU
    formulation of the same math and is not ported)."""

    def __init__(self, in_features: int, features: int, kernel=3, strides=1,
                 norm_mode: str = "bn", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv3d(in_features, features, kernel, strides, use_bias, dtype)
        self.Norm_0 = Norm(norm_mode, features, dtype)

    def forward(self, x) -> torch.Tensor:
        return F.relu(self.Norm_0(self.Conv_0(_cat(x))))


class TransposeConvNormRelu(nn.Module):
    """conv3d_transpose ('SAME', output = input * stride) -> norm -> relu."""

    def __init__(self, in_features: int, features: int, kernel=3, strides=2,
                 norm_mode: str = "bn", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose3d(
            in_features, features, kernel, strides, use_bias, dtype)
        self.Norm_0 = Norm(norm_mode, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Norm_0(self.ConvTranspose_0(x)))
