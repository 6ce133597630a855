"""P3D (Pseudo-3D ResNet-199) video-saliency model family.

Counterpart of ``sap3d_tpu/models/p3d.py``: ``Bottleneck`` (with CBAM on the
residual in the GN family), ``P3DEncoder``, the six decoders (``UNetDecoder``,
``ConcatDecoder``, ``UNetPPDecoder`` with attention 'sa' / 'nl' / 'none' and
head 'ds' / 'full', ``GNEasyDecoder``, ``GNSAConcat2Decoder``,
``GNDecoderBlock``) and ``P3DSaliency``, in eval and train mode
(``model.train()``: batch statistics in every BN, dropout where the decoder
has it).  ``bn_reference_quirk`` gives the reference's inference: its
bottleneck BNs normalize with batch statistics in eval mode too.

The module tree mirrors the flax variable tree (``encoder/stage1_block0/
reduce``, ``decoder/x_3_1/Conv_0``, ``decoder/x_1_3_sa/f``, ...), so weights
carry across by name (``interop/flax_bridge.py``).  Inside, tensors are
NCDHW; ``P3DSaliency`` takes ``[B, T, H, W, 3]`` and returns
``[B, T, H, W, 1]`` in float32, as the JAX model does.

The JAX package's layout rewrites sit behind its environment variables,
read when a model is built (each module's docstring says why not per call):
``SAP3D_CONCAT_SPLIT`` / ``SAP3D_CONCAT_EAGER_SITES`` (the dense-skip convs
per part, ``ops/concat_split.py``), ``SAP3D_CONV3D_VIA_2D`` (the
``ConvNormRelu`` convs as 2-D convs, ``ops/conv2d_path.py``; both chosen
by ``ops/concat_split.conv_norm_relu``),
``SAP3D_STEM_S2D`` (the stem on a space-to-depth view,
``ops/stem_s2d.py``), ``SAP3D_HEAD_TCONV_PS`` (the 1-channel heads' phase
forward) and ``SAP3D_HEAD_PHASE_LOSS`` (the UNet++ 'ds' head's phase layout
in train mode, ``ops/fast_tconv.py``), and ``SAP3D_ATTN_PROJ``
(``ops/attention.py``).  Each computes the same function and keeps the
state dict; with every variable unset the model is the port's default.
The port's default for ``SAP3D_CONCAT_SPLIT`` and ``SAP3D_HEAD_PHASE_LOSS``
is off, where the JAX package's is on.

Under a time mesh every model takes a time-sharded clip
(``ops/time_shard.Shards``, the counterpart of GSPMD's time partitioning)
and returns one: every layer runs on each shard on its device (halos at the
temporal convs, statistics summed over the shards), so the whole clip never
exists on one device but where the attention sites without a ring and the
non-local blocks gather their tokens, as GSPMD does.

Encoder (input [B, 16, 112, 112, 3]):
    stem   conv (1,7,7) s(1,2,2), no bias -> 64ch, norm, relu  -> 16 x 56x56
    x_1_0  maxpool (2,1,1)/(2,1,1)                            ->  8 x 56x56
    pool1  maxpool (2,3,3)/(2,2,2)                            ->  8 x 28x28
    stage1..3: 3 + 8 + 36 bottlenecks, each stage followed by a temporal
    maxpool /2 (pool2..pool4: 4x28x28x256, 2x14x14x512, 1x7x7x1024).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sap3d_tpu_torch.ops.attention import NonLocal3D, SelfAttention3D
from sap3d_tpu_torch.ops.cbam import CBAM
from sap3d_tpu_torch.ops.concat_split import conv_norm_relu
from sap3d_tpu_torch.ops.fast_tconv import head_tconv, phase_head_loss_enabled
from sap3d_tpu_torch.ops.layers import (
    Conv3d,
    ConvTranspose3d,
    Norm,
    TransposeConvNormRelu,
    max_pool3d,
)
from sap3d_tpu_torch.ops.stem_s2d import StemConv, stem_s2d_enabled
from sap3d_tpu_torch.ops.time_shard import Shards

BLOCK_EXPANSION = 4
# (planes, num_blocks) per stage: 3 + 8 + 36 = 47 bottlenecks = P3D-199.
_STAGES = ((64, 3), (128, 8), (256, 36))


class Bottleneck(nn.Module):
    """1x1x1 reduce (spatial stride on stage entry) -> norm -> relu ->
    ST_{A|B|C} -> 1x1x1 expand x4 -> norm; residual optionally projected by
    a strided 1x1x1 conv + norm, and with ``use_cbam`` (the GN family) passed
    through CBAM, projected or not; add -> relu.  The 1x1x1 convs have no
    bias, the spatial/temporal convs do.

    ``bn_reference_quirk`` (BN only; GN ignores it): every norm of the block
    normalizes with batch statistics in eval mode too, and the running
    statistics stay where they are.  The reference never forwards its
    training flag into its bottlenecks (reference p3d.py:141,148,290-303),
    so its inference does this; the maps of its TF checkpoints need it."""

    def __init__(self, in_features: int, planes: int, st_type: str,
                 spatial_stride: int = 1, project: bool = False,
                 norm_mode: str = "bn", use_cbam: bool = False,
                 dtype: torch.dtype = torch.float32, bn_reference_quirk: bool = False):
        super().__init__()
        if st_type not in ("A", "B", "C"):
            raise ValueError(f"bad st_type {st_type!r}")
        p, s = planes, spatial_stride
        quirk = bn_reference_quirk and norm_mode == "bn"

        def norm(features):
            return Norm(norm_mode, features, dtype, batch_stats_at_eval=quirk)

        self.st_type = st_type
        self.reduce = Conv3d(in_features, p, 1, (1, s, s), use_bias=False, dtype=dtype)
        self.reduce_norm = norm(p)
        self.conv_s = Conv3d(p, p, (1, 3, 3), dtype=dtype)
        self.conv_t = Conv3d(p, p, (3, 1, 1), dtype=dtype)
        self.s_norm = norm(p)
        self.t_norm = norm(p)
        self.expand = Conv3d(p, p * BLOCK_EXPANSION, 1, use_bias=False, dtype=dtype)
        self.expand_norm = norm(p * BLOCK_EXPANSION)
        if project:
            self.proj = Conv3d(in_features, p * BLOCK_EXPANSION, 1, (1, s, s),
                               use_bias=False, dtype=dtype)
            self.proj_norm = norm(p * BLOCK_EXPANSION)
        else:
            self.proj = None
        self.cbam = CBAM(p * BLOCK_EXPANSION, dtype=dtype) if use_cbam else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.reduce_norm(self.reduce(x)))
        if self.st_type == "A":  # S then T, serially
            out = F.relu(self.s_norm(self.conv_s(out)))
            out = F.relu(self.t_norm(self.conv_t(out)))
        elif self.st_type == "B":  # S parallel T, summed
            sp = F.relu(self.s_norm(self.conv_s(out)))
            out = sp + F.relu(self.t_norm(self.conv_t(out)))
        else:  # C: S then S + T(S)
            sp = F.relu(self.s_norm(self.conv_s(out)))
            out = sp + F.relu(self.t_norm(self.conv_t(sp)))
        out = self.expand_norm(self.expand(out))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        if self.cbam is not None:
            residual = self.cbam(residual)
        return F.relu(out + residual)


class P3DEncoder(nn.Module):
    """Shared bottleneck encoder; returns the skip features by name
    (conv1, x_1_0, pool1, res1..3, pool2..4), NCDHW.  ``bn_reference_quirk``
    reaches the bottlenecks; the stem's norm honours eval mode."""

    def __init__(self, norm_mode: str = "bn", dtype: torch.dtype = torch.float32,
                 stages: tuple = _STAGES, stem_features: int = 64,
                 in_features: int = 3, use_cbam: bool = False,
                 bn_reference_quirk: bool = False):
        super().__init__()
        self.stem = StemConv(in_features, stem_features, 7, dtype, s2d=stem_s2d_enabled())
        self.stem_norm = Norm(norm_mode, stem_features, dtype)
        self.stage_blocks: list[list[str]] = []
        ch, n_s = stem_features, 0  # n_s: global block index drives A/B/C
        for stage_idx, (planes, num) in enumerate(stages):
            names = []
            for block_idx in range(num):
                first = block_idx == 0
                name = f"stage{stage_idx + 1}_block{block_idx}"
                self.add_module(name, Bottleneck(
                    ch, planes, "ABC"[n_s % 3],
                    # stage entry downsamples spatially except stage 1
                    spatial_stride=2 if (first and n_s != 0) else 1,
                    project=first, norm_mode=norm_mode, use_cbam=use_cbam, dtype=dtype,
                    bn_reference_quirk=bn_reference_quirk,
                ))
                names.append(name)
                ch = planes * BLOCK_EXPANSION
                n_s += 1
            self.stage_blocks.append(names)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        feats: dict[str, torch.Tensor] = {}
        h = F.relu(self.stem_norm(self.stem(x)))
        feats["conv1"] = h
        feats["x_1_0"] = max_pool3d(h, (2, 1, 1), (2, 1, 1))
        h = max_pool3d(h, (2, 3, 3), (2, 2, 2))
        feats["pool1"] = h
        for stage_idx, names in enumerate(self.stage_blocks):
            for name in names:
                h = getattr(self, name)(h)
            feats[f"res{stage_idx + 1}"] = h
            h = max_pool3d(h, (2, 1, 1), (2, 1, 1))
            feats[f"pool{stage_idx + 2}"] = h
        return feats


class _Decoder(nn.Module):
    """What the decoders share: the norm/dtype keywords of their blocks, the
    dropout rate, and the list of their self-attention sites.  Each takes
    the encoder's feature dict (NCDHW) and returns ``[B, 1, T, H, W]``."""

    def __init__(self, norm_mode: str, dtype: torch.dtype, dropout_rate: float):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.kw = dict(norm_mode=norm_mode, dtype=dtype)

    def _drop(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """Inverted dropout in train mode with a mask drawn from
        ``generator`` (flax's ``nn.Dropout``: keep with probability 1 - rate,
        scale by its inverse in the input's dtype).  The mask is drawn in
        channels-last order, the memory order the model's layers keep from
        its NDHWC input on the card, whatever ``x``'s own memory format: a
        layout rewrite, or a backend whose convs hand back contiguous
        tensors, draws the same mask from the same generator."""
        keep = 1.0 - self.dropout_rate
        if not self.training or self.dropout_rate == 0.0:
            return x
        if isinstance(x, Shards):
            if keep <= 0.0:
                return x.map(torch.zeros_like)
            return x * self._shard_masks(x, keep, generator) / keep
        if keep <= 0.0:
            return torch.zeros_like(x)
        mask = torch.empty_like(x, memory_format=torch.channels_last_3d)
        return x * mask.bernoulli_(keep, generator=generator) / keep

    @staticmethod
    def _shard_masks(x: Shards, keep: float, generator) -> Shards:
        """Each shard's mask, drawn from ``generator`` (on its own device)
        in shard order and moved to the shard's device.  The masks differ
        from the unsharded model's, as a data-parallel rank's do."""
        masks = []
        for j in range(x.n):
            s = x.shard(j)
            dev = s.device if generator is None else generator.device
            m = torch.empty(s.shape, dtype=s.dtype, device=dev)
            masks.append(m.bernoulli_(keep, generator=generator).to(s.device))
        return x.with_parts([torch.cat([masks[j] for j in idx]) for _, idx in x.groups])


class UNetDecoder(_Decoder):
    """U-Net skip decoder of p3d_unet: three transposed-conv blocks, each fed
    the previous one concatenated with the encoder skip, dropout, a 1x1x1
    conv to 32 channels and a transposed conv to 1.  Sigmoid output."""

    def __init__(self, skip_features: tuple[int, int, int, int], norm_mode: str = "bn",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5):
        super().__init__(norm_mode, dtype, dropout_rate)
        _, c2, c3, c4 = skip_features
        self.deconv1 = TransposeConvNormRelu(c4, 512, (1, 3, 3), 2, **self.kw)
        self.deconv2 = TransposeConvNormRelu(512 + c3, 256, (2, 3, 3), 2, **self.kw)
        self.deconv3 = TransposeConvNormRelu(256 + c2, 128, 3, 2, **self.kw)
        self.head_conv = Conv3d(128, 32, 1, dtype=dtype)
        self.head_tconv = head_tconv(32, dtype)

    def forward(self, feats, generator=None) -> torch.Tensor:
        d1 = self.deconv1(feats["pool4"])
        d2 = self.deconv2(torch.cat([d1, feats["pool3"]], dim=1))
        d3 = self.deconv3(torch.cat([d2, feats["pool2"]], dim=1))
        h = self.head_conv(self._drop(d3, generator))
        return torch.sigmoid(self.head_tconv(h).float())


class ConcatDecoder(_Decoder):
    """Easy-upsampling concat decoder of p3d_concat: pool2/3/4 brought to
    pool2's grid by transposed convs of stride 1/2/4, concatenated, a conv,
    a transposed conv, dropout and a transposed conv to 1.  Linear output."""

    def __init__(self, skip_features: tuple[int, int, int, int], norm_mode: str = "bn",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5):
        super().__init__(norm_mode, dtype, dropout_rate)
        _, c2, c3, c4 = skip_features
        self.deconv_pool2 = TransposeConvNormRelu(c2, 128, 3, 1, **self.kw)
        self.deconv_pool3 = TransposeConvNormRelu(c3, 256, 3, 2, **self.kw)
        self.deconv_pool4 = TransposeConvNormRelu(c4, 512, 3, 4, **self.kw)
        self.conv_concat = conv_norm_relu(128 + 256 + 512, 512, 3, 1, **self.kw)
        self.deconv_revise = TransposeConvNormRelu(512, 128, 3, 2, **self.kw)
        self.predict_revise = head_tconv(128, dtype)

    def forward(self, feats, generator=None) -> torch.Tensor:
        h = self.conv_concat((self.deconv_pool2(feats["pool2"]),
                              self.deconv_pool3(feats["pool3"]),
                              self.deconv_pool4(feats["pool4"])))
        h = self._drop(self.deconv_revise(h), generator)
        return self.predict_revise(h)


class UNetPPDecoder(_Decoder):
    """UNet++ nested decoder.

    attention: 'sa'   self-attention at x_4_0, x_3_1, x_2_2 and,
                      key/value-subsampled, x_1_3;
               'nl'   a non-local block after the self-attention at x_4_0,
                      x_3_1 and x_2_2, and (key/value-subsampled) instead
                      of it at x_1_3;
               'none' no attention.
    head: 'ds'   dropout, then a single transposed conv straight to 1 channel;
          'full' transposed conv to 16 channels, self-attention with keys and
                 values pooled by 4 (``x_0_1_sa``; d = 2, C = 16: the
                 kernels' narrow instantiation), dropout, a 1x1x1 conv to 1
                 channel.
    Output is sigmoid-activated.  ``ring_mesh`` (long-clip mode) sends every
    self-attention site to ring attention over the mesh
    (``ops/ring_attention.py``), ``x_4_0`` included.  Fed a whole clip, the
    other layers run on the input's device and each site cuts and gathers
    its tokens; fed a time-sharded clip of the same mesh, every layer runs
    shard by shard and the rings take the shards where they lie.

    Under ``SAP3D_HEAD_PHASE_LOSS=1`` the 'ds' head gives its phase layout
    in train mode, [B, 8, T/2, H/2, W/2] (``ops/fast_tconv.PhaseHeadTConv``;
    ``train/steps.loss_fn_saliency`` takes it); eval mode gives the
    interleaved map either way."""

    def __init__(self, skip_features: tuple[int, int, int, int],
                 attention: str = "sa", head: str = "ds", norm_mode: str = "bn",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5,
                 ring_mesh=None):
        super().__init__(norm_mode, dtype, dropout_rate)
        if attention not in ("sa", "nl", "none") or head not in ("ds", "full"):
            raise ValueError(f"unknown attention/head {attention!r}/{head!r}")
        self.head = head
        c1, c2, c3, c4 = skip_features  # x_1_0, pool2, pool3, pool4
        kw = self.kw
        self.sites: list[str] = []  # attention blocks by name, in call order

        def sa(name, ch, **extra):
            if attention != "none":
                self.add_module(name, SelfAttention3D(ch, **kw, **extra, ring_mesh=ring_mesh))
                self.sites.append(name)

        def nl(name, ch, sub_sample):
            if attention == "nl":
                self.add_module(name, NonLocal3D(ch, sub_sample, dtype))
                self.sites.append(name)

        sa("x_4_0_sa", c4)
        nl("x_4_0_nl", c4, False)
        self.upx_4_0 = TransposeConvNormRelu(c4, 512, (1, 3, 3), 2, **kw)
        self.x_3_1 = conv_norm_relu(c3 + 512, 512, (2, 3, 3), 1, **kw, site="x_3_1")
        sa("x_3_1_sa", 512)
        nl("x_3_1_nl", 512, False)
        self.upx_3_0 = TransposeConvNormRelu(c3, 256, (2, 3, 3), 2, **kw)
        self.x_2_1 = conv_norm_relu(c2 + 256, 256, 3, 1, **kw, site="x_2_1")
        self.upx_3_1 = TransposeConvNormRelu(512, 256, (2, 3, 3), 2, **kw)
        self.x_2_2 = conv_norm_relu(512, 256, 3, 1, **kw, site="x_2_2")
        sa("x_2_2_sa", 256)
        nl("x_2_2_nl", 256, False)
        self.upx_2_0 = TransposeConvNormRelu(c2, 128, 3, 2, **kw)
        self.x_1_1 = conv_norm_relu(c1 + 128, 128, 3, 1, **kw, site="x_1_1")
        self.upx_2_1 = TransposeConvNormRelu(256, 128, 3, 2, **kw)
        self.x_1_2 = conv_norm_relu(256, 128, 3, 1, **kw, site="x_1_2")
        self.upx_2_2 = TransposeConvNormRelu(256, 128, 3, 2, **kw)
        self.x_1_3 = conv_norm_relu(256, 128, 3, 1, **kw, site="x_1_3")
        if attention == "nl":
            nl("x_1_3_nl", 128, True)
        else:
            sa("x_1_3_sa", 128, subsample=True)
        if head == "full":
            self.x_0_1 = ConvTranspose3d(128, 16, 3, 2, dtype=dtype)
            sa("x_0_1_sa", 16, subsample=True, sub_size=4)
            self.result = Conv3d(16, 1, 1, dtype=dtype)
        else:
            self.x_0_1 = head_tconv(128, dtype, phase_layout=phase_head_loss_enabled())

    def _attend(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """The attention blocks registered at ``site`` (``<site>_sa``, then
        ``<site>_nl``), in that order."""
        for name in (f"{site}_sa", f"{site}_nl"):
            if name in self.sites:
                x = getattr(self, name)(x)
        return x

    def forward(self, feats: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        x_1_0, x_2_0 = feats["x_1_0"], feats["pool2"]
        x_3_0, x_4_0 = feats["pool3"], feats["pool4"]

        x_4_0 = self._attend(x_4_0, "x_4_0")
        up_4_0 = self.upx_4_0(x_4_0)
        x_3_1 = self._attend(self.x_3_1((x_3_0, up_4_0)), "x_3_1")

        up_3_0 = self.upx_3_0(x_3_0)
        x_2_1 = self.x_2_1((x_2_0, up_3_0))
        up_3_1 = self.upx_3_1(x_3_1)
        x_2_2 = self._attend(self.x_2_2((x_2_1, up_3_1)), "x_2_2")

        up_2_0 = self.upx_2_0(x_2_0)
        x_1_1 = self.x_1_1((x_1_0, up_2_0))
        up_2_1 = self.upx_2_1(x_2_1)
        x_1_2 = self.x_1_2((x_1_1, up_2_1))
        up_2_2 = self.upx_2_2(x_2_2)
        x_1_3 = self._attend(self.x_1_3((x_1_2, up_2_2)), "x_1_3")
        if self.head == "full":
            out = self._attend(self.x_0_1(x_1_3), "x_0_1")
            out = self.result(self._drop(out, generator))
        else:
            out = self.x_0_1(self._drop(x_1_3, generator))
        # The sigmoid runs in float32 on the logits of the compute dtype: XLA
        # drops the bf16 rounding between the JAX model's sigmoid and its
        # float32 output cast, so its bf16 maps are not quantized to bf16.
        return torch.sigmoid(out.float())


class GNEasyDecoder(_Decoder):
    """GN-family easy-upsampling decoder: inference_p3d (``wide_pool4``: the
    pool4 deconv gives 1024 channels), inference_p3d_concat (512) and, with
    ``use_sa`` (self-attention on pool2/3/4 before the deconvs),
    inference_p3d_sa_concat.  Linear output."""

    def __init__(self, skip_features: tuple[int, int, int, int], wide_pool4: bool = False,
                 use_sa: bool = False, norm_mode: str = "gn",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5):
        super().__init__(norm_mode, dtype, dropout_rate)
        _, c2, c3, c4 = skip_features
        self.use_sa = use_sa
        if use_sa:
            self.pool2_sa = SelfAttention3D(c2, **self.kw)
            self.pool3_sa = SelfAttention3D(c3, **self.kw)
            self.pool4_sa = SelfAttention3D(c4, **self.kw)
        wide = 1024 if wide_pool4 else 512
        self.deconv_pool3 = TransposeConvNormRelu(c3, 512, 3, 2, **self.kw)
        self.deconv_pool4 = TransposeConvNormRelu(c4, wide, 3, 4, **self.kw)
        self.conv_concat = conv_norm_relu(512 + wide + c2, 1024, 3, 1, **self.kw)
        self.deconv_revise = TransposeConvNormRelu(1024, 256, 3, 2, **self.kw)
        self.predict_revise = head_tconv(256, dtype)

    def forward(self, feats, generator=None) -> torch.Tensor:
        pool2, pool3, pool4 = feats["pool2"], feats["pool3"], feats["pool4"]
        if self.use_sa:
            pool2, pool3, pool4 = (self.pool2_sa(pool2), self.pool3_sa(pool3),
                                   self.pool4_sa(pool4))
        h = self.conv_concat((self.deconv_pool3(pool3), self.deconv_pool4(pool4), pool2))
        h = self._drop(self.deconv_revise(h), generator)
        return self.predict_revise(h)


class GNSAConcat2Decoder(_Decoder):
    """inference_p3d_sa_concat_2: self-attention after the deconvs; the
    concat conv is followed by dropout, then the norm and relu.  Linear
    output."""

    def __init__(self, skip_features: tuple[int, int, int, int], norm_mode: str = "gn",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5):
        super().__init__(norm_mode, dtype, dropout_rate)
        _, c2, c3, c4 = skip_features
        self.pool2_sa = SelfAttention3D(c2, **self.kw)
        self.deconv_pool3 = TransposeConvNormRelu(c3, 256, 3, 2, **self.kw)
        self.deconv_pool3_sa = SelfAttention3D(256, **self.kw)
        self.deconv_pool4 = TransposeConvNormRelu(c4, 512, 3, 4, **self.kw)
        self.deconv_pool4_sa = SelfAttention3D(512, **self.kw)
        self.conv_concat = Conv3d(c2 + 256 + 512, 512, 3, dtype=dtype)
        self.conv_concat_gn = Norm(norm_mode, 512, dtype)
        self.deconv_revise = TransposeConvNormRelu(512, 128, 3, 2, **self.kw)
        self.predict_revise = head_tconv(128, dtype)

    def forward(self, feats, generator=None) -> torch.Tensor:
        pool2_sa = self.pool2_sa(feats["pool2"])
        dp3 = self.deconv_pool3_sa(self.deconv_pool3(feats["pool3"]))
        dp4 = self.deconv_pool4_sa(self.deconv_pool4(feats["pool4"]))
        h = self._drop(self.conv_concat(torch.cat([pool2_sa, dp3, dp4], dim=1)), generator)
        h = F.relu(self.conv_concat_gn(h))
        h = self._drop(self.deconv_revise(h), generator)
        return self.predict_revise(h)


class GNDecoderBlock(_Decoder):
    """Two-stage decoder-block head.  ``use_sa=True``
    (inference_p3d_sa_decoder_block): self-attention on pool2 and on the
    pool3 and pool4 deconvs (256, 512 and 1024 channels on pool2's grid), and
    a dropout after the first stage as well; ``use_sa=False``
    (inference_p3d_decoder_block): narrower deconvs of pool2/3/4, no
    attention.  Linear output (a final 3x3x3 conv to 1 channel)."""

    def __init__(self, skip_features: tuple[int, int, int, int], use_sa: bool = True,
                 norm_mode: str = "gn", dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5):
        super().__init__(norm_mode, dtype, dropout_rate)
        _, c2, c3, c4 = skip_features
        kw = self.kw
        self.use_sa = use_sa
        if use_sa:
            self.pool2_sa = SelfAttention3D(c2, **kw)
            self.deconv_pool3 = TransposeConvNormRelu(c3, 512, (2, 3, 3), 2, **kw)
            self.deconv_pool3_sa = SelfAttention3D(512, **kw)
            self.deconv_pool4 = TransposeConvNormRelu(c4, 1024, (1, 3, 3), 4, **kw)
            self.deconv_pool4_sa = SelfAttention3D(1024, **kw)
            cat = c2 + 512 + 1024
        else:
            self.deconv_pool2 = TransposeConvNormRelu(c2, 128, 3, 1, **kw)
            self.deconv_pool3 = TransposeConvNormRelu(c3, 256, (2, 3, 3), 2, **kw)
            self.deconv_pool4 = TransposeConvNormRelu(c4, 512, (1, 3, 3), 4, **kw)
            cat = 128 + 256 + 512
        self.conv_concat = conv_norm_relu(cat, 1024, 3, 1, **kw)
        self.decoder1_conv1 = conv_norm_relu(1024, 256, 3, 1, **kw)
        self.decoder1_deconv = TransposeConvNormRelu(256, 256, 3, 2, **kw)
        self.decoder1_conv2 = conv_norm_relu(256, 128, 3, 1, **kw)
        self.decoder2_conv1 = conv_norm_relu(128, 32, 3, 1, **kw)
        self.decoder2_deconv = TransposeConvNormRelu(32, 32, 3, 2, **kw)
        self.decoder2_conv2 = conv_norm_relu(32, 16, 3, 1, **kw)
        self.results = Conv3d(16, 1, 3, dtype=dtype)

    def forward(self, feats, generator=None) -> torch.Tensor:
        pool2, pool3, pool4 = feats["pool2"], feats["pool3"], feats["pool4"]
        if self.use_sa:
            parts = (self.pool2_sa(pool2),
                     self.deconv_pool3_sa(self.deconv_pool3(pool3)),
                     self.deconv_pool4_sa(self.deconv_pool4(pool4)))
        else:
            parts = (self.deconv_pool2(pool2), self.deconv_pool3(pool3),
                     self.deconv_pool4(pool4))
        h = self.decoder1_conv1(self.conv_concat(parts))
        h = self.decoder1_conv2(self.decoder1_deconv(h))
        if self.use_sa:  # the SA variant alone drops out here as well
            h = self._drop(h, generator)
        h = self.decoder2_conv2(self.decoder2_deconv(self.decoder2_conv1(h)))
        return self.results(self._drop(h, generator))


_DECODERS = {
    "unet": UNetDecoder,
    "concat": ConcatDecoder,
    "unetpp": UNetPPDecoder,
    "gn_easy": GNEasyDecoder,
    "gn_sa_concat_2": GNSAConcat2Decoder,
    "gn_decoder_block": GNDecoderBlock,
}


class P3DSaliency(nn.Module):
    """Encoder + one of the decoders (``_DECODERS``).  Input
    ``[B, T, H, W, 3]``, output ``[B, T, H, W, 1]`` float32, sigmoid or
    linear as the decoder gives it; the input is cast to the compute dtype.
    In train mode ``generator`` draws the dropout masks (the default
    generator of the device when None).  ``ring_mesh`` (a
    ``core/mesh.make_time_mesh`` mesh) reaches the UNet++ decoder's
    self-attention sites alone; the other decoders ignore it, as in the JAX
    package.  The parameters are the same with and without it, and with and
    without ``bn_reference_quirk`` (``Bottleneck``: the bottleneck BNs on
    batch statistics in eval mode, the stem and decoder BNs on their running
    statistics).

    ``x`` may be a time-sharded clip (``core/mesh.time_shard_batch``): every
    layer then runs on each shard's device and the output is a time-sharded
    [B, T, H, W, 1].  The parameters stay on the model's device, the mesh's
    first; each layer moves them to its shards' devices, and the state dict
    is the same whatever the input."""

    def __init__(self, decoder: str = "unetpp", decoder_kwargs: dict | None = None,
                 norm_mode: str = "bn", backbone_cbam: bool = False,
                 dtype: torch.dtype = torch.float32,
                 stages: tuple = _STAGES, stem_features: int = 64,
                 dropout_rate: float = 0.5, ring_mesh=None,
                 bn_reference_quirk: bool = False):
        super().__init__()
        if decoder not in _DECODERS:
            raise ValueError(f"unknown decoder {decoder!r}; known: {sorted(_DECODERS)}")
        self.dtype = dtype
        self.bn_reference_quirk = bn_reference_quirk
        self.encoder = P3DEncoder(norm_mode, dtype, stages, stem_features,
                                  use_cbam=backbone_cbam,
                                  bn_reference_quirk=bn_reference_quirk)
        skips = (stem_features,) + tuple(p * BLOCK_EXPANSION for p, _ in stages)
        extra = {"ring_mesh": ring_mesh} if ring_mesh is not None and decoder == "unetpp" else {}
        self.decoder = _DECODERS[decoder](skips, **(decoder_kwargs or {}),
                                          norm_mode=norm_mode, dtype=dtype,
                                          dropout_rate=dropout_rate, **extra)

    def forward(self, x, generator: torch.Generator | None = None):
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NDHWC -> NCDHW
        out = self.decoder(self.encoder(x), generator)
        return out.permute(0, 2, 3, 4, 1).float()

    def attention_modules(self) -> list[SelfAttention3D]:
        return [m for m in self.modules() if isinstance(m, SelfAttention3D)]

    def ring_sites(self) -> list[SelfAttention3D]:
        """The self-attention sites that run as rings over ``ring_mesh``."""
        return [m for m in self.attention_modules() if m.ring_mesh is not None]
