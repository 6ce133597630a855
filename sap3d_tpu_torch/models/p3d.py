"""P3D (Pseudo-3D ResNet-199) video-saliency model, BN family, UNet++ head.

Counterpart of ``sap3d_tpu/models/p3d.py`` for the flagship:
``Bottleneck``, ``P3DEncoder``, ``UNetPPDecoder`` (attention 'sa' or 'none',
head 'ds') and ``P3DSaliency``, in eval and train mode (``model.train()``:
batch statistics in every BN, dropout before the head).  The other decoders, the 'nl'
attention, the 'full' head, the GN+CBAM family and the bottleneck BN quirk
port in later slices (ROADMAP A.9, A.10, A.12).

The module tree mirrors the flax variable tree (``encoder/stage1_block0/
reduce``, ``decoder/x_3_1/Conv_0``, ``decoder/x_1_3_sa/f``, ...), so weights
carry across by name (``interop/flax_bridge.py``).  Inside, tensors are
NCDHW; ``P3DSaliency`` takes ``[B, T, H, W, 3]`` and returns
``[B, T, H, W, 1]`` in float32, as the JAX model does.

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

from sap3d_tpu_torch.ops.attention import SelfAttention3D
from sap3d_tpu_torch.ops.layers import (
    Conv3d,
    ConvNormRelu,
    ConvTranspose3d,
    Norm,
    TransposeConvNormRelu,
    max_pool3d,
)

BLOCK_EXPANSION = 4
# (planes, num_blocks) per stage: 3 + 8 + 36 = 47 bottlenecks = P3D-199.
_STAGES = ((64, 3), (128, 8), (256, 36))


class Bottleneck(nn.Module):
    """1x1x1 reduce (spatial stride on stage entry) -> norm -> relu ->
    ST_{A|B|C} -> 1x1x1 expand x4 -> norm; residual optionally projected by
    a strided 1x1x1 conv + norm; add -> relu.  The 1x1x1 convs have no bias,
    the spatial/temporal convs do."""

    def __init__(self, in_features: int, planes: int, st_type: str,
                 spatial_stride: int = 1, project: bool = False,
                 norm_mode: str = "bn", dtype: torch.dtype = torch.float32):
        super().__init__()
        if st_type not in ("A", "B", "C"):
            raise ValueError(f"bad st_type {st_type!r}")
        p, s = planes, spatial_stride
        self.st_type = st_type
        self.reduce = Conv3d(in_features, p, 1, (1, s, s), use_bias=False, dtype=dtype)
        self.reduce_norm = Norm(norm_mode, p, dtype)
        self.conv_s = Conv3d(p, p, (1, 3, 3), dtype=dtype)
        self.conv_t = Conv3d(p, p, (3, 1, 1), dtype=dtype)
        self.s_norm = Norm(norm_mode, p, dtype)
        self.t_norm = Norm(norm_mode, p, dtype)
        self.expand = Conv3d(p, p * BLOCK_EXPANSION, 1, use_bias=False, dtype=dtype)
        self.expand_norm = Norm(norm_mode, p * BLOCK_EXPANSION, dtype)
        if project:
            self.proj = Conv3d(in_features, p * BLOCK_EXPANSION, 1, (1, s, s),
                               use_bias=False, dtype=dtype)
            self.proj_norm = Norm(norm_mode, p * BLOCK_EXPANSION, dtype)
        else:
            self.proj = None

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
        return F.relu(out + residual)


class P3DEncoder(nn.Module):
    """Shared bottleneck encoder; returns the skip features by name
    (conv1, x_1_0, pool1, res1..3, pool2..4), NCDHW."""

    def __init__(self, norm_mode: str = "bn", dtype: torch.dtype = torch.float32,
                 stages: tuple = _STAGES, stem_features: int = 64,
                 in_features: int = 3):
        super().__init__()
        self.stem = Conv3d(in_features, stem_features, (1, 7, 7), (1, 2, 2),
                           use_bias=False, dtype=dtype)
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
                    project=first, norm_mode=norm_mode, dtype=dtype,
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


class UNetPPDecoder(nn.Module):
    """UNet++ nested decoder, attention 'sa' (self-attention at x_4_0, x_3_1,
    x_2_2 and, key/value-subsampled, x_1_3) or 'none'; head 'ds' (a single
    transposed conv straight to 1 channel), after dropout at rate
    ``dropout_rate`` in train mode.  Output is sigmoid-activated, NCDHW.

    The JAX package's phase-layout train head (``fast_tconv.py``) is a TPU
    formulation whose summed loss is the same number; the interleaved head
    runs in both modes here."""

    def __init__(self, skip_features: tuple[int, int, int, int],
                 attention: str = "sa", head: str = "ds", norm_mode: str = "bn",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        if attention == "nl":
            raise NotImplementedError(
                "UNetPPDecoder(attention='nl') ports with NonLocal3D "
                "(ROADMAP A.9, the rest of the BN family)")
        if head == "full":
            raise NotImplementedError(
                "UNetPPDecoder(head='full') ports with the rest of the BN "
                "family (ROADMAP A.9)")
        if attention not in ("sa", "none") or head != "ds":
            raise ValueError(f"unknown attention/head {attention!r}/{head!r}")
        c1, c2, c3, c4 = skip_features  # x_1_0, pool2, pool3, pool4
        kw = dict(norm_mode=norm_mode, dtype=dtype)
        self.sa_sites = []

        def sa(name, ch, **extra):
            if attention == "sa":
                self.add_module(name, SelfAttention3D(ch, **kw, **extra))
                self.sa_sites.append(name)

        sa("x_4_0_sa", c4)
        self.upx_4_0 = TransposeConvNormRelu(c4, 512, (1, 3, 3), 2, **kw)
        self.x_3_1 = ConvNormRelu(c3 + 512, 512, (2, 3, 3), 1, **kw)
        sa("x_3_1_sa", 512)
        self.upx_3_0 = TransposeConvNormRelu(c3, 256, (2, 3, 3), 2, **kw)
        self.x_2_1 = ConvNormRelu(c2 + 256, 256, 3, 1, **kw)
        self.upx_3_1 = TransposeConvNormRelu(512, 256, (2, 3, 3), 2, **kw)
        self.x_2_2 = ConvNormRelu(512, 256, 3, 1, **kw)
        sa("x_2_2_sa", 256)
        self.upx_2_0 = TransposeConvNormRelu(c2, 128, 3, 2, **kw)
        self.x_1_1 = ConvNormRelu(c1 + 128, 128, 3, 1, **kw)
        self.upx_2_1 = TransposeConvNormRelu(256, 128, 3, 2, **kw)
        self.x_1_2 = ConvNormRelu(256, 128, 3, 1, **kw)
        self.upx_2_2 = TransposeConvNormRelu(256, 128, 3, 2, **kw)
        self.x_1_3 = ConvNormRelu(256, 128, 3, 1, **kw)
        sa("x_1_3_sa", 128, subsample=True)
        self.x_0_1 = ConvTranspose3d(128, 1, 3, 2, dtype=dtype)

    def _sa(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return getattr(self, name)(x) if name in self.sa_sites else x

    def _dropout(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """Inverted dropout with a mask drawn from ``generator`` (flax's
        ``nn.Dropout``: keep with probability 1 - rate, scale by its
        inverse in the input's dtype)."""
        keep = 1.0 - self.dropout_rate
        if not self.training or self.dropout_rate == 0.0:
            return x
        if keep <= 0.0:
            return torch.zeros_like(x)
        mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
        return x * mask / keep

    def forward(self, feats: dict[str, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        x_1_0, x_2_0 = feats["x_1_0"], feats["pool2"]
        x_3_0, x_4_0 = feats["pool3"], feats["pool4"]

        x_4_0 = self._sa(x_4_0, "x_4_0_sa")
        up_4_0 = self.upx_4_0(x_4_0)
        x_3_1 = self._sa(self.x_3_1((x_3_0, up_4_0)), "x_3_1_sa")

        up_3_0 = self.upx_3_0(x_3_0)
        x_2_1 = self.x_2_1((x_2_0, up_3_0))
        up_3_1 = self.upx_3_1(x_3_1)
        x_2_2 = self._sa(self.x_2_2((x_2_1, up_3_1)), "x_2_2_sa")

        up_2_0 = self.upx_2_0(x_2_0)
        x_1_1 = self.x_1_1((x_1_0, up_2_0))
        up_2_1 = self.upx_2_1(x_2_1)
        x_1_2 = self.x_1_2((x_1_1, up_2_1))
        up_2_2 = self.upx_2_2(x_2_2)
        x_1_3 = self._sa(self.x_1_3((x_1_2, up_2_2)), "x_1_3_sa")
        x_1_3 = self._dropout(x_1_3, generator)
        # The sigmoid runs in float32 on the logits of the compute dtype: XLA
        # drops the bf16 rounding between the JAX model's sigmoid and its
        # float32 output cast, so its bf16 maps are not quantized to bf16.
        return torch.sigmoid(self.x_0_1(x_1_3).float())


class P3DSaliency(nn.Module):
    """Encoder + UNet++ decoder.  Input ``[B, T, H, W, 3]``, output
    ``[B, T, H, W, 1]`` float32; the input is cast to the compute dtype.
    In train mode ``generator`` draws the dropout mask (the default
    generator of the device when None)."""

    def __init__(self, decoder: str = "unetpp", decoder_kwargs: dict | None = None,
                 norm_mode: str = "bn", dtype: torch.dtype = torch.float32,
                 stages: tuple = _STAGES, stem_features: int = 64,
                 dropout_rate: float = 0.5):
        super().__init__()
        if decoder != "unetpp":
            raise NotImplementedError(
                f"decoder {decoder!r} ports with the rest of the BN family "
                "(ROADMAP A.9) or the GN+CBAM family (ROADMAP A.10)")
        self.dtype = dtype
        self.encoder = P3DEncoder(norm_mode, dtype, stages, stem_features)
        skips = (stem_features,) + tuple(p * BLOCK_EXPANSION for p, _ in stages)
        self.decoder = UNetPPDecoder(skips, **(decoder_kwargs or {}),
                                     norm_mode=norm_mode, dtype=dtype,
                                     dropout_rate=dropout_rate)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NDHWC -> NCDHW
        out = self.decoder(self.encoder(x), generator)
        return out.permute(0, 2, 3, 4, 1).float()

    def attention_modules(self) -> list[SelfAttention3D]:
        return [m for m in self.modules() if isinstance(m, SelfAttention3D)]
