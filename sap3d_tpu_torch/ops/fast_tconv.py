"""Phase-decomposed transposed convolution and the phase-layout train head.

Counterpart of ``sap3d_tpu/ops/fast_tconv.py``.  A transposed conv of stride
s lowers to a conv over an input with s - 1 zeros between its samples, so
(s^3 - 1) / s^3 of its products are with zeros.  The same operator is one
dense stride-1 conv whose S = sd sh sw output-channel blocks are the output's
phases (``phase_tconv_pre_interleave``), then a depth-to-space interleave.

The plan (``_dim_plan``) is the JAX package's, derived for flax's
``[kd, kh, kw, in, out]`` kernel of ``conv_transpose(..., transpose_kernel=
False)``: per axis, output phase e takes tap t from input offset
(e + t - pad_a) / s where that divides (pad_a from the SAME padding).  The
port stores a transposed-conv kernel as ``[in, out, kd, kh, kw]``, flipped on
its three spatial axes (``ops/layers.ConvTranspose3d``), so the plan indexes
``_flax_kernel(kernel)``, the stored kernel mapped back.  The phase weight
is built from the kernel at every call (it is small next to the
activations) and carries the gradient back to it.

* ``FastConvTranspose`` (``SAP3D_HEAD_TCONV_PS=1``, the 1-output-channel
  heads): the phase forward, whose backward is the plain transposed conv's
  adjoint (``torch.ops.aten.convolution_backward`` on the uncropped output's
  gradient), the JAX ``custom_vjp``.  A time-sharded clip takes the phase
  forward shard by shard after a halo of the frames its windows reach, and
  is differentiated through it by autograd.
* ``PhaseHeadTConv`` (``SAP3D_HEAD_PHASE_LOSS=1``, the UNet++ 'ds' head): in
  train mode the phase layout itself, [B, S, D, H, W] for one output
  channel (the model returns it as [B, T/2, H/2, W/2, 8]), which
  ``train/steps.loss_fn_saliency`` holds against ``space_to_depth3d`` of the
  target: the summed loss has the same terms, so the same value and
  gradients, and the interleave never runs.  In eval mode it gives the
  interleaved map (through ``FastConvTranspose``'s forward where
  ``SAP3D_HEAD_TCONV_PS=1`` too).

Both keep ``ConvTranspose3d``'s parameters: state dicts, the flax bridge and
the TF import are unchanged.  The flags are read when a model is built, not
per call: a captured step (``train/steps.CapturedMultiStep``) fixes the
schedule at capture anyway.  The port's default for
``SAP3D_HEAD_PHASE_LOSS`` is off (the JAX package's is on, from a TPU
measurement that says nothing of the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from sap3d_tpu_torch.ops import time_shard
from sap3d_tpu_torch.ops.layers import ConvTranspose3d, column_parallel, tconv_same_crop
from sap3d_tpu_torch.ops.time_shard import Shards


def phase_head_loss_enabled() -> bool:
    """``SAP3D_HEAD_PHASE_LOSS=1``: the UNet++ 'ds' head gives its phase
    layout in train mode (off by default in the port)."""
    return os.environ.get("SAP3D_HEAD_PHASE_LOSS", "0") == "1"


def head_tconv_ps_enabled() -> bool:
    """``SAP3D_HEAD_TCONV_PS=1``: the 1-output-channel heads run the phase
    forward (off by default, as in the JAX package)."""
    return os.environ.get("SAP3D_HEAD_TCONV_PS", "0") == "1"


def _dim_plan(k: int, s: int):
    """One axis's phase plan for a SAME transposed conv: (tap_index [s, A],
    tap_mask [s, A], pad_before, pad_after), A the input window's span;
    tap_index[e, a] is the (flax) kernel tap feeding output phase e from
    input offset a + delta_min, masked where no tap lands."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    taps, deltas = [], []
    for e in range(s):
        ph = [(t, (e + t - pad_a) // s) for t in range(k) if (e + t - pad_a) % s == 0]
        taps.append(ph)
        deltas += [d for _, d in ph]
    dmin = min(deltas) if deltas else 0
    dmax = max(deltas) if deltas else 0
    span = dmax - dmin + 1
    idx = np.zeros((s, span), np.int64)
    mask = np.zeros((s, span), np.float32)
    for e, ph in enumerate(taps):
        for t, d in ph:
            idx[e, d - dmin] = t
            mask[e, d - dmin] = 1.0
    return idx, mask, -dmin, dmax


def _flax_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The port's stored transposed-conv kernel [in, out, kd, kh, kw]
    (spatially flipped) as flax's [kd, kh, kw, in, out]."""
    return kernel.flip(2, 3, 4).permute(2, 3, 4, 0, 1)


def _taps(w: torch.Tensor, axis: int, idx: np.ndarray, mask: np.ndarray) -> torch.Tensor:
    """``w``'s taps along ``axis`` as one axis plan's [s, A] (zeros where no
    tap lands), by slices and stacks of ``w`` alone: no index tensor is
    copied to the device, so a CUDA graph can capture it."""
    zeros = torch.zeros_like(w.select(axis, 0))
    rows = [w.select(axis, int(t)) if m else zeros
            for t, m in zip(idx.reshape(-1), mask.reshape(-1))]
    return torch.stack(rows, dim=axis).unflatten(axis, idx.shape)


def phase_weight(kernel: torch.Tensor, strides) -> tuple[torch.Tensor, list[tuple[int, int]]]:
    """The dense conv weight [S*out, in, Ad, Ah, Aw] (phase-major output
    blocks, p = (e_d sh + e_h) sw + e_w) of the SAME transposed conv with the
    port's ``kernel``, and the (before, after) input padding per axis."""
    plans = [_dim_plan(k, s) for k, s in zip(kernel.shape[2:], strides)]
    g = _flax_kernel(kernel)
    for axis, (idx, mask, _, _) in zip((0, 2, 4), plans):
        g = _taps(g, axis, idx, mask)  # [sd, Ad, sh, Ah, sw, Aw, in, out] at the end
    sd, ad, sh, ah, sw, aw, cin, cout = g.shape
    w = g.permute(0, 2, 4, 7, 6, 1, 3, 5).reshape(sd * sh * sw * cout, cin, ad, ah, aw)
    return w, [(lo, hi) for _, _, lo, hi in plans]


def phase_tconv_pre_interleave(x: torch.Tensor, kernel: torch.Tensor, strides,
                               time_pads: tuple[int, int] | None = None) -> torch.Tensor:
    """The SAME transposed conv of NCDHW ``x`` with the port's ``kernel``
    before its interleave: [B, S*out, D, H, W], channel p*out + c holding
    ``out[b, c, d sd + e_d, h sh + e_h, w sw + e_w]``.  ``time_pads``
    replaces the temporal padding (a time shard's halo is already on
    ``x``)."""
    w, pads = phase_weight(kernel, strides)
    (dl, dh), (hl, hh), (wl, wh) = [time_pads or pads[0]] + pads[1:]
    return F.conv3d(F.pad(x, (wl, wh, hl, hh, dl, dh)), w)


def _interleave(y: torch.Tensor, strides, cout: int) -> torch.Tensor:
    """[B, S*out, D, H, W] phase blocks -> [B, out, D sd, H sh, W sw]."""
    sd, sh, sw = strides
    b, _, nd, nh, nw = y.shape
    y = y.reshape(b, sd, sh, sw, cout, nd, nh, nw).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return y.reshape(b, cout, nd * sd, nh * sh, nw * sw)


def _phase_forward(x: torch.Tensor, kernel: torch.Tensor, strides,
                   time_pads: tuple[int, int] | None = None) -> torch.Tensor:
    return _interleave(phase_tconv_pre_interleave(x, kernel, strides, time_pads), strides,
                       kernel.shape[1])


def space_to_depth3d(t: torch.Tensor, strides) -> torch.Tensor:
    """[B, D sd, H sh, W sw] -> [B, D, H, W, S] in the phase order of
    ``phase_tconv_pre_interleave`` (one output channel): an elementwise loss
    against the phase layout sums the same terms as in the interleaved
    one."""
    sd, sh, sw = strides
    b, dd, hh, ww = t.shape
    t = t.reshape(b, dd // sd, sd, hh // sh, sh, ww // sw, sw)
    return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, dd // sd, hh // sh, ww // sw,
                                                  sd * sh * sw)


class _PhaseTConv(torch.autograd.Function):
    """Forward: the phase decomposition.  Backward: the adjoint of the plain
    transposed conv (``ConvTranspose3d._tconv``: the full
    ``conv_transpose3d``, then the SAME crop), i.e. the cropped gradient
    padded back to the full output and handed to the convolution's own
    backward, which computes dx and dkernel and no forward."""

    @staticmethod
    def forward(ctx, x, kernel, strides):
        crops = [tconv_same_crop(n, k, s) for n, k, s in
                 zip(x.shape[2:], kernel.shape[2:], strides)]
        ctx.save_for_backward(x, kernel)
        ctx.strides, ctx.crops = strides, crops
        return _phase_forward(x, kernel, strides)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        pads = []
        for (start, op), n, k, s, m in zip(ctx.crops, x.shape[2:], kernel.shape[2:],
                                           ctx.strides, dy.shape[2:]):
            full = (n - 1) * s + k + op
            pads.append((start, full - start - m))
        (dl, dh), (hl, hh), (wl, wh) = pads
        dy_full = F.pad(dy.to(x.dtype), (wl, wh, hl, hh, dl, dh))
        dx, dk, _ = torch.ops.aten.convolution_backward(
            dy_full, x, kernel, None, list(ctx.strides), [0, 0, 0], [1, 1, 1], True,
            [op for _, op in ctx.crops], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                                             False])
        return dx, dk, None


def phase_tconv(x: torch.Tensor, kernel: torch.Tensor, strides) -> torch.Tensor:
    """The SAME transposed conv of NCDHW ``x`` with the port's ``kernel``:
    the phase forward, the plain transposed conv's backward."""
    return _PhaseTConv.apply(x, kernel, tuple(strides))


class FastConvTranspose(ConvTranspose3d):
    """``ConvTranspose3d`` (SAME) through the phase decomposition."""

    def forward(self, x):
        x = x.to(self.dtype)
        if self.model_group is not None:
            return column_parallel(x, self.model_group, lambda t: self._phase(t, None),
                                   self.bias, 1)
        return self._phase(x, self.bias)

    def _phase(self, x, bias):
        if isinstance(x, Shards):
            _, _, lo, hi = _dim_plan(self.ksize[0], self.strides[0])
            y = x.with_parts([_phase_forward(p, self._own_kernel(p), self.strides, (0, 0))
                              for p in time_shard.halo(x, lo, hi)])
        else:
            y = phase_tconv(x, self._own_kernel(x), self.strides)
        return y if bias is None else y + bias.to(self.dtype).view(1, -1, 1, 1, 1)

    def _own_kernel(self, x: torch.Tensor) -> torch.Tensor:
        return time_shard.to_device(self.kernel, x.device).to(self.dtype)


class PhaseHeadTConv(FastConvTranspose):
    """The UNet++ 'ds' head under ``SAP3D_HEAD_PHASE_LOSS``: in train mode
    the phase layout [B, S*out, D, H, W], every phase of a channel with
    that channel's bias (the JAX ``PhaseHeadTConv``); in eval mode the
    interleaved map, through the phase forward where ``fast`` (the head
    flag ``SAP3D_HEAD_TCONV_PS``) else the plain transposed conv."""

    def __init__(self, *args, fast: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.fast = fast

    def forward(self, x):
        if not self.training:
            return super().forward(x) if self.fast else ConvTranspose3d.forward(self, x)
        x = x.to(self.dtype)
        if isinstance(x, Shards):
            _, _, lo, hi = _dim_plan(self.ksize[0], self.strides[0])
            y = x.with_parts([phase_tconv_pre_interleave(p, self._own_kernel(p), self.strides,
                                                         (0, 0))
                              for p in time_shard.halo(x, lo, hi)])
        else:
            y = phase_tconv_pre_interleave(x, self._own_kernel(x), self.strides)
        if self.bias is None:
            return y
        phases = int(np.prod(self.strides))
        return y + self.bias.to(y.dtype).repeat(phases).view(1, -1, 1, 1, 1)


def head_tconv(in_features: int, dtype: torch.dtype, phase_layout: bool = False):
    """A 1-output-channel head: kernel 3, stride 2, SAME.  ``phase_layout``
    (the UNet++ 'ds' head under ``SAP3D_HEAD_PHASE_LOSS``) gives a
    ``PhaseHeadTConv``; otherwise ``SAP3D_HEAD_TCONV_PS=1`` gives a
    ``FastConvTranspose`` and its absence the plain ``ConvTranspose3d``."""
    fast = head_tconv_ps_enabled()
    if phase_layout:
        return PhaseHeadTConv(in_features, 1, 3, 2, dtype=dtype, fast=fast)
    return (FastConvTranspose if fast else ConvTranspose3d)(in_features, 1, 3, 2, dtype=dtype)
