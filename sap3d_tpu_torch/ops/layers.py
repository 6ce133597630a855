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

Every layer also takes a time-sharded clip (``ops/time_shard.Shards``, the
counterpart of GSPMD's time partitioning) and returns one.  The halos come
from the whole clip's SAME padding, never from each shard's own: a conv of
temporal kernel k at stride 1 takes ``same_pads(T, k, 1)`` frames from its
neighbours (k = 3: (1, 1); k = 2: (0, 1); CBAM's k = 7: (3, 3), across
several shards where a shard holds fewer); a transposed conv takes the input
frames whose windows reach the shard's own output frames and crops the rest;
the norms sum their statistics over every shard.  The parameters are moved
to each shard's device (a no-op on their own).

Under tensor parallel (``core/sharding_rules.apply_state_sharding``) a
``Conv3d`` or ``ConvTranspose3d`` whose kernel is sharded holds this rank's
slice of its output features and a ``model_group`` (the rank's model row):
it is column-parallel (``column_parallel``).  Its bias stays whole, as the
JAX package keeps biases replicated.  A time-sharded clip through such a
layer raises: the JAX package does not combine the two either.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sap3d_tpu_torch.ops import time_shard
from sap3d_tpu_torch.ops.time_shard import Shards, to_device


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


def in_memory_format_of(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in the memory format of ``x`` (channels-last or contiguous), as
    a conv keeps its input's: a layout rewrite of a layer hands on the
    format the layer would, so what follows (the dropout masks, drawn in
    memory order; cuDNN's choice of kernels) sees the default path's."""
    channels_last = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last_3d)
    return y.contiguous(memory_format=torch.channels_last_3d if channels_last
                        else torch.contiguous_format)


def max_pool3d(
    x: torch.Tensor,
    window: Sequence[int] | int,
    strides: Sequence[int] | int,
    padding: str = "SAME",
) -> torch.Tensor:
    """3D max pool over the D,H,W axes of an NCDHW tensor.

    'SAME' pads with -inf, as XLA's reduce_window does (e.g. the stem pool
    (2,3,3)/(2,2,2) on 56x56 pads H/W by (0, 1)).

    A time-sharded clip is pooled shard by shard: every temporal window of
    the registry equals its stride (2, or 4 in ``pool3d``), so where each
    shard's length is a multiple of the stride no window crosses a seam and
    no halo is needed.  The trainer's guard (clip length a multiple of 16
    per shard, ``train/trainer.py:Trainer._time_mesh``) makes every shard
    length even down to pool4; any other case raises."""
    w, s = _triple(window), _triple(strides)
    if isinstance(x, Shards):
        if x.time_dim != 2 or w[0] != s[0] or x.frames % s[0]:
            raise ValueError(f"a temporal window {w[0]} at stride {s[0]} needs halos on "
                             f"shards of {x.frames} frames")
        return x.map(lambda p: max_pool3d(p, w, s, padding))
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
    return smooth_l1_terms(pred, target, inside_weights, outside_weights, sigma).sum()


def smooth_l1_terms(pred: torch.Tensor, target: torch.Tensor,
                    inside_weights: torch.Tensor | float = 1.0,
                    outside_weights: torch.Tensor | float = 1.0,
                    sigma: float = 1.0) -> torch.Tensor:
    """``smooth_l1_loss``'s terms, element by element, before the sum."""
    sigma2 = sigma ** 2
    diff = (pred - target) * inside_weights
    abs_diff = diff.abs()
    is_small = (abs_diff < 1.0 / sigma2).to(diff.dtype).detach()
    per_elem = diff.square() * (sigma2 / 2.0) * is_small \
        + (abs_diff - 0.5 / sigma2) * (1.0 - is_small)
    return per_elem * outside_weights


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
        self.model_group = None  # core/mesh.DataGroup: the kernel is this rank's slice

    def forward(self, x):
        x = x.to(self.dtype)
        if self.model_group is not None:
            return column_parallel(x, self.model_group, lambda t: self.conv(t, with_bias=False),
                                   self.bias, 1)
        return self.conv(x)

    def conv(self, x, kernel: torch.Tensor | None = None, with_bias: bool = True):
        """The SAME conv of a whole or time-sharded ``x`` (in the compute
        dtype) with ``kernel``: the layer's own, or a slice of its input
        channels (``ops/concat_split.py``)."""
        if isinstance(x, Shards):
            if self.strides[0] != 1:
                raise ValueError("a time-sharded conv takes temporal stride 1")
            lo, hi = same_pads(x.shape[2], self.ksize[0], 1)
            return x.with_parts([self._conv(p, (0, 0), kernel, with_bias)
                                 for p in time_shard.halo(x, lo, hi)])
        return self._conv(x, same_pads(x.shape[2], self.ksize[0], self.strides[0]), kernel,
                          with_bias)

    def _conv(self, x: torch.Tensor, time_pads: tuple[int, int],
              kernel: torch.Tensor | None = None, with_bias: bool = True) -> torch.Tensor:
        pads = [time_pads] + [same_pads(n, k, s) for n, k, s in
                              zip(x.shape[3:], self.ksize[1:], self.strides[1:])]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)  # symmetric: let cuDNN pad
        else:
            (dl, dh), (hl, hh), (wl, wh) = pads
            x = F.pad(x, (wl, wh, hl, hh, dl, dh))
            padding = 0
        return F.conv3d(x, self._kernel(x, kernel), self._bias(x, with_bias), self.strides,
                        padding)

    def _kernel(self, x: torch.Tensor, kernel: torch.Tensor | None = None) -> torch.Tensor:
        """``kernel`` (the layer's own by default) on x's device, in the
        compute dtype."""
        return to_device(self.kernel if kernel is None else kernel, x.device).to(self.dtype)

    def _bias(self, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor | None:
        if self.bias is None or not with_bias:
            return None
        return to_device(self.bias, x.device).to(self.dtype)


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
        self.model_group = None  # core/mesh.DataGroup: the kernel is this rank's slice

    def forward(self, x):
        x = x.to(self.dtype)
        crops = [tconv_same_crop(n, k, s) for n, k, s in
                 zip(x.shape[2:], self.ksize, self.strides)]
        if self.model_group is not None:
            return column_parallel(x, self.model_group,
                                   lambda t: self._tconv(t, *crops, with_bias=False),
                                   self.bias, 1)
        if not isinstance(x, Shards):
            return self._tconv(x, *crops)
        # shard j's output frames [j t s, (j + 1) t s) take the input frames
        # [j t - lo, (j + 1) t + hi): the windows that overlap a seam at
        # (k, s) = (3, 2) or (3, 1) reach the neighbours' frames
        (k, s), t = (self.ksize[0], self.strides[0]), x.frames
        d0 = crops[0][0]
        lo, hi = (k - 1 - d0) // s, -(-d0 // s)
        start = lo * s + d0
        parts = []
        for p in time_shard.halo(x, lo, hi):
            short = start + t * s - ((p.shape[2] - 1) * s + k)  # < s: where k < s
            parts.append(self._tconv(p, (start, max(short, 0)), *crops[1:], d=t * s))
        return x.with_parts(parts)

    def _tconv(self, x: torch.Tensor, *crops, d: int | None = None,
               with_bias: bool = True) -> torch.Tensor:
        bias = None if self.bias is None or not with_bias else \
            to_device(self.bias, x.device).to(self.dtype)
        y = F.conv_transpose3d(
            x, to_device(self.kernel, x.device).to(self.dtype), bias, self.strides,
            output_padding=tuple(op for _, op in crops),
        )
        (d0, _), (h0, _), (w0, _) = crops
        dd, h, w = (n * s for n, s in zip(x.shape[2:], self.strides))
        d = dd if d is None else d
        return y[:, :, d0:d0 + d, h0:h0 + h, w0:w0 + w]


class _CopyToModelRow(torch.autograd.Function):
    """The identity, whose backward sums the gradient over a model row: a
    column-parallel layer's slice gives only its share of the gradient of
    the input, which every rank of the row holds whole."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_reduce(grad.clone(memory_format=torch.contiguous_format)), None


class _GatherFeatures(torch.autograd.Function):
    """The row's slices of an output, all-gathered along ``dim``
    (``DataGroup.all_gather``); the backward keeps this rank's slice of the
    gradient, with no reduction: every rank of the row computes the same
    gradient of the whole output."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim, ctx.n = group, dim, y.shape[dim]
        return group.all_gather(y, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model_row(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient summed over the model row ``group``."""
    return _CopyToModelRow.apply(x, group)


def gather_features(y: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The model row's slices of ``y`` gathered along ``dim``, in row order."""
    return _GatherFeatures.apply(y, group, dim)


def column_parallel(x, group, local, bias, dim: int) -> torch.Tensor:
    """A layer whose kernel is this rank's slice of the output features,
    on the model row ``group``: ``local(x)`` (the layer on its slice, no
    bias) for each rank, the slices all-gathered along ``dim`` into the
    whole output, then the whole bias added.  The gradient of ``x`` is
    summed over the row (``copy_to_model_row``); the kernel's gradient is
    this rank's slice's, the bias's the whole layer's.  ``x`` may be a
    tuple of channel-concat parts (``ops/concat_split.py``): each part's
    gradient is summed over the row, and ``local`` takes the tuple."""
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if any(isinstance(p, Shards) for p in parts):
        raise ValueError("a time-sharded clip through a layer sharded on the model axis: "
                         "tensor parallel takes whole clips")
    parts = tuple(copy_to_model_row(p, group) for p in parts)
    y = gather_features(local(parts if isinstance(x, (tuple, list)) else parts[0]), group, dim)
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(y.dtype).view(shape)


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
    update the JAX eval step discards.

    With a data group of more than one rank (``group``, set by
    ``set_data_group``), the batch statistics are the global batch's, as
    under the JAX package's jit over a data mesh: each rank all-reduces one
    float32 tensor [sum x, sum x^2, count] over its rows (float64 for a
    float64 input), and mean = sum x / n, var = max(0, sum x^2 / n -
    mean^2), flax's own formula (where a channel's mean is large against
    its spread it loses digits of the variance that the one-device path
    keeps).  The normalization is then
    elementwise in that dtype (the batch-norm call takes no gradient
    through statistics handed to it), and the gradient flows back through
    the reduction, whose backward is the same all-reduce.  The
    running statistics move as on one device, the same on every rank.

    A time-sharded clip (``ops/time_shard.Shards``) in train mode (and with
    ``batch_stats_at_eval``) is normalized with the whole clip's statistics:
    each device's [sum x, sum x^2] (float32 or wider) is added on the
    mesh's first device, with the same formula, and the gradient flows back
    through that sum (``_ShardedBatchNorm``, whose backward adds each
    device's two channel sums of the cotangent there as well).  Where one
    device holds every shard (a mesh that names one card N times) its
    stacked tensor is the whole clip's rows, and the one-device path above
    normalizes it in one call.  The running statistics move once per call.
    Eval mode normalizes each shard with the running statistics.  A clip
    that is time-sharded while the layer has a data group of more than one
    rank is refused."""

    eps = 1e-3
    momentum = 0.99  # flax convention: running = m * running + (1 - m) * batch

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 batch_stats_at_eval: bool = False):
        super().__init__()
        self.dtype = dtype
        self.batch_stats_at_eval = batch_stats_at_eval
        self.group = None  # core/mesh.DataGroup: global-batch statistics
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        x = x.to(self.dtype)
        if isinstance(x, Shards):
            return self._sharded(x)
        if not self.training and not self.batch_stats_at_eval:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, self.eps)
        if self.group is not None and self.group.world_size > 1:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.native_batch_norm(x, self.scale, self.bias, None, None,
                                                      True, 0.0, self.eps)
            var = None if not self.training else \
                (invstd.to(self.var).square().reciprocal() - self.eps).clamp_min(0.0)
        if self.training:
            self._move_running(mean, var)
        return y

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.99 running + 0.01 batch, in the buffers' dtype."""
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean.to(self.mean), alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var.to(self.var), alpha=1.0 - self.momentum)

    def _global_batch_norm(self, x: torch.Tensor):
        """Normalize ``x`` with the statistics of every rank's rows; returns
        the output and the (detached) mean and biased variance."""
        c, xf = x.shape[1], x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0, *range(2, x.dim())]
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dims), xf.square().sum(dims), count]),
                              self.group)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean.square()).clamp_min(0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype), mean.detach(), var.detach()

    def _sharded(self, x: Shards) -> Shards:
        if self.group is not None and self.group.world_size > 1:
            raise ValueError("a time-sharded clip under a data group of more than one rank: "
                             "time mode keeps a data mesh of 1")
        if not self.training and not self.batch_stats_at_eval:
            return x.map(lambda p: F.batch_norm(
                p, *(to_device(t, p.device) for t in (self.mean, self.var, self.scale,
                                                      self.bias)), False, 0.0, self.eps))
        if len(x.parts) == 1:  # one device holds every shard: its statistics are the clip's
            return x.with_parts([self.forward(x.parts[0])])
        *parts, mean, var = _ShardedBatchNorm.apply(x.mesh.devices[0], self.eps, self.scale,
                                                    self.bias, *x.parts)
        if self.training:
            self._move_running(mean, var)
        return x.with_parts(parts)


def _channel_dims(x: torch.Tensor) -> list[int]:
    return [0, *range(2, x.dim())]


class _ShardedBatchNorm(torch.autograd.Function):
    """Batch norm of per-device tensors with the statistics of all of them:
    returns each device's output, and the (non-differentiable) mean and
    biased variance on ``first``.  Each device's [sum x, sum x^2] is added
    on ``first`` (float32 for a low-precision input; mean = sum x / n, var
    = max(0, sum x^2 / n - mean^2), flax's formula); each tensor is then
    normalized by one batch-norm call with those statistics.  The backward
    adds each device's [sum dy, sum dy (x - mean)] on ``first`` and gives
    dx = (dy - sum dy / n - (x - mean) invstd^2 sum dy (x - mean) / n)
    invstd scale, the batch norm's gradient; it saves the inputs in their
    own dtype, as the batch-norm call does."""

    @staticmethod
    def forward(ctx, first, eps, scale, bias, *parts):
        acc = torch.promote_types(parts[0].dtype, torch.float32)
        c = scale.shape[0]
        sums = time_shard.sum_to([torch.cat([p.sum(_channel_dims(p), dtype=acc),
                                  p.to(acc).square().sum(_channel_dims(p))]) for p in parts],
                      first)
        n = sum(p.numel() // c for p in parts)
        mean = sums[:c] / n
        var = (sums[c:] / n - mean.square()).clamp_min(0.0)
        outs = [F.batch_norm(p, mean.to(p.device), var.to(p.device), scale.to(p.device),
                             bias.to(p.device), False, 0.0, eps) for p in parts]
        ctx.save_for_backward(scale, mean, torch.rsqrt(var + eps), *parts)
        ctx.n, ctx.first = n, first
        ctx.mark_non_differentiable(mean, var)
        return (*outs, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        scale, mean, invstd, *parts = ctx.saved_tensors
        acc, c = mean.dtype, scale.shape[0]

        def per_channel(t, p):  # a [C] tensor on p's device, shaped to broadcast
            return t.to(p.device).view(1, c, *([1] * (p.dim() - 2)))

        red = []
        for p, dy in zip(parts, grads):
            dyf = dy.to(acc)
            red.append(torch.cat([dyf.sum(_channel_dims(p)),
                                  (dyf * (p.to(acc) - per_channel(mean, p)))
                                  .sum(_channel_dims(p))]))
        tot = time_shard.sum_to(red, ctx.first)
        sum_dy, sum_dy_xmu = tot[:c], tot[c:]
        k_dy, k_x = sum_dy / ctx.n, sum_dy_xmu / ctx.n * invstd.square()
        mul = invstd * scale.to(acc)
        dxs = [((dy.to(acc) - per_channel(k_dy, p)
                 - (p.to(acc) - per_channel(mean, p)) * per_channel(k_x, p))
                * per_channel(mul, p)).to(p.dtype) for p, dy in zip(parts, grads)]
        return (None, None, (sum_dy_xmu * invstd).to(scale.dtype), sum_dy.to(scale.dtype),
                *dxs)


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a data group's ranks; its gradient is the
    sum of the ranks' gradients, the same all-reduce."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_reduce(grad.clone(memory_format=torch.contiguous_format)), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``core/mesh.DataGroup``),
    differentiably."""
    return _AllReduceSum.apply(x, group)


def set_data_group(model: nn.Module, group) -> None:
    """Give every ``BatchNorm`` of ``model`` the data group whose global
    batch its statistics cover (None: this process's batch alone).  A data
    x model group gives its data column: the ranks of a model row hold the
    same rows, and a sum over the world would count each row ``n_model``
    times."""
    if group is not None and group.data is not None:
        group = group.data
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class GroupNorm(nn.Module):
    """``nn.GroupNorm`` (flax) twin: G = min(32, C) groups, eps 1e-5, in
    float32 (or the input's wider dtype).  A time-sharded clip takes each
    sample's group statistics over every shard: each device's [sum x, sum
    x^2] per sample and group is added on the mesh's first device (flax's
    formula, var = E[x^2] - E[x]^2)."""

    eps = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.groups = min(32, features)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if isinstance(x, Shards):
            return self._sharded(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        y = F.group_norm(xf, self.groups, self.scale.to(xf.dtype), self.bias.to(xf.dtype),
                         self.eps)
        return y.to(self.dtype)

    def _sharded(self, x: Shards) -> Shards:
        acc = torch.promote_types(x.dtype, torch.float32)
        b, g = x.batch, self.groups

        def grouped(p, k):  # [k shards, B, G, C/G x frames x H x W]
            return p.to(acc).reshape(k, b, g, -1)

        sums = time_shard.sum_to([torch.stack([v.sum((0, 3)), v.square().sum((0, 3))])
                       for v in (grouped(p, len(idx)) for (_, idx), p in
                                 zip(x.groups, x.parts))], x.mesh.devices[0])
        n = x.n * x.parts[0][0].numel() // g
        mean = sums[0] / n
        inv = torch.rsqrt((sums[1] / n - mean.square()).clamp_min(0.0) + self.eps)
        parts = []
        for (dev, idx), p in zip(x.groups, x.parts):
            v = (grouped(p, len(idx)) - to_device(mean, dev)[None, :, :, None]) \
                * to_device(inv, dev)[None, :, :, None]
            shape = (1, p.shape[1]) + (1,) * (p.dim() - 2)
            y = v.reshape(p.shape) * to_device(self.scale, dev).to(acc).view(shape) \
                + to_device(self.bias, dev).to(acc).view(shape)
            parts.append(y.to(self.dtype))
        return x.with_parts(parts)


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

    def forward(self, x):
        if self.mode == "bn":
            return self.BatchNorm_0(x)
        if self.mode == "gn":
            return self.GroupNorm_0(x)
        return x


def _cat(x):
    """A tuple of channel-concat parts (the decoders' dense skips) becomes
    one tensor (or one time-sharded clip); the fused ``[out, sum(Ci),
    ...]`` kernel then runs once."""
    if isinstance(x, (tuple, list)):
        return torch.cat(list(x), dim=1)
    return x


class ConvNormRelu(nn.Module):
    """conv3d -> norm -> relu.  Accepts a tuple of parts (the decoders'
    dense skips), concatenated on the channel axis (``_cat``), or, given
    ``split``, handed to ``split(Conv_0, parts)`` without the concat.
    ``conv`` replaces the plain ``Conv3d`` (a subclass with the same
    parameters, so the state dict is the same).  Which conv and split a
    layer takes under the layout variables is chosen where the model is
    built (``ops/concat_split.conv_norm_relu``)."""

    def __init__(self, in_features: int, features: int, kernel=3, strides=1,
                 norm_mode: str = "bn", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, conv: type[Conv3d] | None = None,
                 split: Callable | None = None):
        super().__init__()
        self.split_conv = split
        self.Conv_0 = (conv or Conv3d)(in_features, features, kernel, strides, use_bias, dtype)
        self.Norm_0 = Norm(norm_mode, features, dtype)

    def forward(self, x):
        if self.split_conv is not None and isinstance(x, (tuple, list)):
            y = self.split_conv(self.Conv_0, x)
        else:
            y = self.Conv_0(_cat(x))
        return F.relu(self.Norm_0(y))


class TransposeConvNormRelu(nn.Module):
    """conv3d_transpose ('SAME', output = input * stride) -> norm -> relu."""

    def __init__(self, in_features: int, features: int, kernel=3, strides=2,
                 norm_mode: str = "bn", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose3d(
            in_features, features, kernel, strides, use_bias, dtype)
        self.Norm_0 = Norm(norm_mode, features, dtype)

    def forward(self, x):
        return F.relu(self.Norm_0(self.ConvTranspose_0(x)))
