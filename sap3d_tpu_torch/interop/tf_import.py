"""Import the reference's TensorFlow checkpoints into the port.

Counterpart of ``sap3d_tpu/interop/tf_import.py``.  The mapping half is a
copy of the JAX package's numpy-only code (``MapEntry``, the layout
transform, ``_Namer``, the builders, ``variable_mapping``,
``map_tf_variables``, ``_is_non_model_variable``), with the same names,
order and messages: it turns ``{TF name: array}`` into the flax variable
tree ``{'params': ..., 'batch_stats': ...}``.  ``state_dict_from_tf_variables``
then hands that tree to ``interop/flax_bridge.state_dict_from_flax``, so a
transposed conv's kernel takes TF's layout transform (spatial flip and
in/out swap, ``_transform``) and then the bridge's own, exactly as on the
JAX route followed by the bridge.

The checkpoint is read by ``interop/tf_bundle.py`` (numpy only): the GPU
host has no TensorFlow.

The reference graph builders name variables three ways (reference
p3d.py:10-27,86-131, utils/network.py:100-194): explicit ``tf.get_variable``
names for the encoder's conv weights, explicit ``name=`` on most decoder
``tf.layers`` calls, and TF's auto-numbering in graph-creation order for
everything unnamed (every encoder BatchNorm, the U-Net decoder's transposed
convs, the attention output convs).  The builders below walk the
architecture in the reference's creation order, advancing the same per-type
counters TF would.

Kernel layouts: conv3d kernels are ``[kD, kH, kW, in, out]`` in both TF and
flax; conv3d_transpose kernels are ``[kD, kH, kW, out, in]`` in TF and
``[kD, kH, kW, in, out]`` in flax's zero-insertion ConvTranspose, bridged by
``k[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3)``.

Scope: the BN family and the three GN variants whose reference graphs can
be built; the SA GN variants raise in ``variable_mapping``.

    state_dict = import_checkpoint("p3d_unetplusplus_ds", "<dir or prefix>")
    validate_against_model(state_dict, model)
    model.load_state_dict(state_dict, strict=True)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterator

import numpy as np
import torch

from sap3d_tpu_torch.interop.flax_bridge import state_dict_from_flax
from sap3d_tpu_torch.interop.tf_bundle import read_checkpoint

_STAGES = ((64, 3), (128, 8), (256, 36))  # reference p3d.py:290-303

PARAMS = "params"
STATS = "batch_stats"


@dataclasses.dataclass(frozen=True)
class MapEntry:
    tf_name: str          # checkpoint key (without ':0')
    collection: str       # 'params' | 'batch_stats'
    path: tuple           # flax path within the collection
    transform: str = "id"  # 'id' | 'tconv'


def _transform(tag: str, arr: np.ndarray) -> np.ndarray:
    if tag == "id":
        return arr
    if tag == "tconv":
        return np.ascontiguousarray(
            arr[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3)
        )
    raise ValueError(tag)


class _Namer:
    """Reproduce tf.layers auto-numbering: first unnamed layer of a type is
    the bare type name, subsequent ones get ``_1``, ``_2``, ... (per graph /
    per enclosing variable_scope — ``prefix`` models the GN decoder-block
    variants' ``variable_scope('P3D')``, reference gn/p3d_gn.py:434,490)."""

    def __init__(self, prefix: str = ""):
        self.counts: dict[str, int] = {}
        self.prefix = prefix

    def next(self, base: str) -> str:
        n = self.counts.get(base, 0)
        self.counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def scoped(self, name: str) -> str:
        return self.prefix + name


def _norm(namer: _Namer, path: tuple, mode: str = "bn",
          name: str | None = None) -> Iterator[MapEntry]:
    """One reference norm layer -> flax norm under ``path``.

    ``path`` points at the module CONTAINING the norm; flax auto-names it
    'BatchNorm_0' / 'GroupNorm_0' inside our Norm wrapper
    (ops/layers.py:107-140).  BN may carry an explicit TF name (the UNet /
    concat decoders name theirs); every reference GroupNorm is auto-scoped
    'group_norm[_k]' in creation order with tf.Variable gamma/beta
    (reference gn/p3d_gn.py:24-47)."""
    if mode == "gn":
        scope = namer.scoped(namer.next("group_norm"))
        gn_path = path + ("GroupNorm_0",)
        yield MapEntry(f"{scope}/gamma", PARAMS, gn_path + ("scale",))
        yield MapEntry(f"{scope}/beta", PARAMS, gn_path + ("bias",))
        return
    tf_scope = namer.scoped(
        name if name is not None else namer.next("batch_normalization")
    )
    bn_path = path + ("BatchNorm_0",)
    yield MapEntry(f"{tf_scope}/gamma", PARAMS, bn_path + ("scale",))
    yield MapEntry(f"{tf_scope}/beta", PARAMS, bn_path + ("bias",))
    yield MapEntry(f"{tf_scope}/moving_mean", STATS, bn_path + ("mean",))
    yield MapEntry(f"{tf_scope}/moving_variance", STATS, bn_path + ("var",))


_bn = _norm  # BN-family call sites read better with the original name


def _cbam(namer: _Namer, n_s: int, blk: tuple) -> Iterator[MapEntry]:
    """GN-family CBAM on the bottleneck residual (reference gn/p3d_gn.py:175;
    block structure reference utils/cbam.py:51-140 / utils/network.py:198)."""
    scope = namer.scoped(f"cbam_{n_s}")
    cb = blk + ("cbam",)
    for mlp in ("mlp_0", "mlp_1"):
        yield MapEntry(f"{scope}/ch_at/{mlp}/kernel", PARAMS,
                       cb + ("ch_at", mlp, "kernel"))
        yield MapEntry(f"{scope}/ch_at/{mlp}/bias", PARAMS,
                       cb + ("ch_at", mlp, "bias"))
    yield MapEntry(f"{scope}/sp_at/conv3d/kernel", PARAMS,
                   cb + ("sp_at", "conv3d", "kernel"))


def _stem(namer: _Namer, mode: str) -> Iterator[MapEntry]:
    yield MapEntry(namer.scoped("firstconv1"), PARAMS,
                   ("encoder", "stem", "kernel"))
    yield from _norm(namer, ("encoder", "stem_norm"), mode)


def _stage(namer: _Namer, stage_idx: int, mode: str = "bn",
           cbam: bool = False) -> Iterator[MapEntry]:
    """One encoder stage's bottlenecks, in reference creation order
    (reference p3d.py:86-131 Bottleneck.infer; GN twin gn/p3d_gn.py:128-179
    adds CBAM on the residual)."""
    num = _STAGES[stage_idx][1]
    n_s = sum(_STAGES[i][1] for i in range(stage_idx))
    for block_idx in range(num):
        blk = ("encoder", f"stage{stage_idx + 1}_block{block_idx}")
        yield MapEntry(namer.scoped(f"conv3_{n_s}_1"), PARAMS,
                       blk + ("reduce", "kernel"))
        yield from _norm(namer, blk + ("reduce_norm",), mode)
        st = "ABC"[n_s % 3]
        stem = f"ST{st}_{n_s}_2"
        yield MapEntry(namer.scoped(f"{stem}_S"), PARAMS,
                       blk + ("conv_s", "kernel"))
        yield MapEntry(namer.scoped(f"{stem}_S_bias"), PARAMS,
                       blk + ("conv_s", "bias"))
        yield from _norm(namer, blk + ("s_norm",), mode)
        yield MapEntry(namer.scoped(f"{stem}_T"), PARAMS,
                       blk + ("conv_t", "kernel"))
        yield MapEntry(namer.scoped(f"{stem}_T_bias"), PARAMS,
                       blk + ("conv_t", "bias"))
        yield from _norm(namer, blk + ("t_norm",), mode)
        yield MapEntry(namer.scoped(f"conv3_{n_s}_3"), PARAMS,
                       blk + ("expand", "kernel"))
        yield from _norm(namer, blk + ("expand_norm",), mode)
        if block_idx == 0:  # every stage entry projects (64->256 / stride 2)
            yield MapEntry(namer.scoped(f"dw3d_{n_s}"), PARAMS,
                           blk + ("proj", "kernel"))
            yield from _norm(namer, blk + ("proj_norm",), mode)
        if cbam:
            yield from _cbam(namer, n_s, blk)
        n_s += 1


def _encoder(namer: _Namer, mode: str = "bn",
             cbam: bool = False) -> Iterator[MapEntry]:
    """Stem + all 47 bottlenecks back to back (the BN family's layout; the GN
    variants interleave decoder deconvs between stages — see the GN builders)."""
    yield from _stem(namer, mode)
    for stage_idx in range(3):
        yield from _stage(namer, stage_idx, mode, cbam)


def _layers_conv(namer: _Namer, path: tuple, name: str | None = None,
                 transpose: bool = False, bias: bool = True) -> Iterator[MapEntry]:
    """One tf.layers.conv3d[_transpose] (kernel+bias under a name scope)."""
    base = "conv3d_transpose" if transpose else "conv3d"
    scope = namer.scoped(name if name is not None else namer.next(base))
    tag = "tconv" if transpose else "id"
    yield MapEntry(f"{scope}/kernel", PARAMS, path + ("kernel",), tag)
    if bias:
        yield MapEntry(f"{scope}/bias", PARAMS, path + ("bias",))


def _attention(namer: _Namer, tf_name: str, path: tuple) -> Iterator[MapEntry]:
    """Reference utils/network.py:157-193 `attention(x, name, ...)`:
    f/g/h 1x1x1 convs inside variable_scope(name) (auto-named conv3d,
    conv3d_1, conv3d_2 *within* that scope), the output conv OUTSIDE the
    scope (consumes the graph-global conv3d counter), its BN, and the
    gate variable ``gamma{name}``."""
    yield MapEntry(f"{tf_name}/conv3d/kernel", PARAMS, path + ("f", "kernel"))
    yield MapEntry(f"{tf_name}/conv3d/bias", PARAMS, path + ("f", "bias"))
    yield MapEntry(f"{tf_name}/conv3d_1/kernel", PARAMS, path + ("g", "kernel"))
    yield MapEntry(f"{tf_name}/conv3d_1/bias", PARAMS, path + ("g", "bias"))
    yield MapEntry(f"{tf_name}/conv3d_2/kernel", PARAMS, path + ("h", "kernel"))
    yield MapEntry(f"{tf_name}/conv3d_2/bias", PARAMS, path + ("h", "bias"))
    yield from _layers_conv(namer, path + ("out",))
    yield from _bn(namer, path + ("Norm_0",))
    yield MapEntry(f"gamma{tf_name}", PARAMS, path + ("gamma",))


def _cnr(namer: _Namer, tf_name: str, path: tuple, transpose: bool = False,
         mode: str = "bn") -> Iterator[MapEntry]:
    """conv3d/transpose_conv3d helper (reference utils/network.py:100-110;
    GN twins conv3d_layers/deconv3d_layers, reference gn/p3d_gn.py:14-22):
    named tf.layers conv + unnamed norm -> our ConvNormRelu /
    TransposeConvNormRelu (flax auto-names Conv_0/ConvTranspose_0, Norm_0)."""
    sub = "ConvTranspose_0" if transpose else "Conv_0"
    yield from _layers_conv(namer, path + (sub,), name=tf_name,
                            transpose=transpose)
    yield from _norm(namer, path + ("Norm_0",), mode)


def _unetpp_decoder(namer: _Namer, attention: bool,
                    head: str) -> Iterator[MapEntry]:
    """UNet++ decoder (reference p3d.py:308-337 sa / :373-397 ds /
    :434-457 nonsa), in creation order."""
    dec = ("decoder",)

    def sa(name):
        if attention:
            yield from _attention(namer, name, dec + (name,))

    yield from sa("x_4_0_sa")
    yield from _cnr(namer, "upx_4_0", dec + ("upx_4_0",), transpose=True)
    yield from _cnr(namer, "x_3_1", dec + ("x_3_1",))
    yield from sa("x_3_1_sa")
    yield from _cnr(namer, "upx_3_0", dec + ("upx_3_0",), transpose=True)
    yield from _cnr(namer, "x_2_1", dec + ("x_2_1",))
    yield from _cnr(namer, "upx_3_1", dec + ("upx_3_1",), transpose=True)
    yield from _cnr(namer, "x_2_2", dec + ("x_2_2",))
    yield from sa("x_2_2_sa")
    yield from _cnr(namer, "upx_2_0", dec + ("upx_2_0",), transpose=True)
    yield from _cnr(namer, "x_1_1", dec + ("x_1_1",))
    yield from _cnr(namer, "upx_2_1", dec + ("upx_2_1",), transpose=True)
    yield from _cnr(namer, "x_1_2", dec + ("x_1_2",))
    yield from _cnr(namer, "upx_2_2", dec + ("upx_2_2",), transpose=True)
    yield from _cnr(namer, "x_1_3", dec + ("x_1_3",))
    yield from sa("x_1_3_sa")
    if head == "ds":
        # bare tf.layers.conv3d_transpose(name='x_0_1') (reference p3d.py:393)
        yield from _layers_conv(namer, dec + ("x_0_1",), name="x_0_1",
                                transpose=True)
    else:  # 'full' (reference p3d.py:333-336)
        yield from _layers_conv(namer, dec + ("x_0_1",), name="x_0_1",
                                transpose=True)
        yield from sa("x_0_1_sa")
        yield from _layers_conv(namer, dec + ("result",), name="result")


def _unet_decoder(namer: _Namer) -> Iterator[MapEntry]:
    """U-Net decoder (reference p3d.py:196-221): unnamed transpose convs
    (auto-numbered) + NAMED BNs, then an unnamed 1x1x1 conv and an unnamed
    final transpose conv."""
    dec = ("decoder",)
    yield from _layers_conv(namer, dec + ("deconv1", "ConvTranspose_0"),
                            transpose=True)
    yield from _bn(namer, dec + ("deconv1", "Norm_0"), name="deconv1_bn")
    yield from _layers_conv(namer, dec + ("deconv2", "ConvTranspose_0"),
                            transpose=True)
    yield from _bn(namer, dec + ("deconv2", "Norm_0"), name="deconv2_bn")
    yield from _layers_conv(namer, dec + ("deconv3", "ConvTranspose_0"),
                            transpose=True)
    yield from _bn(namer, dec + ("deconv3", "Norm_0"), name="deconv3_bn")
    yield from _layers_conv(namer, dec + ("head_conv",))
    yield from _layers_conv(namer, dec + ("head_tconv",), transpose=True)


def _concat_decoder(namer: _Namer) -> Iterator[MapEntry]:
    """Concat decoder (reference p3d.py:224-276): every layer named."""
    dec = ("decoder",)
    for nm, transpose in [("deconv_pool2", True), ("deconv_pool3", True),
                          ("deconv_pool4", True)]:
        yield from _layers_conv(namer, dec + (nm, "ConvTranspose_0"), name=nm,
                                transpose=True)
        yield from _bn(namer, dec + (nm, "Norm_0"), name=f"{nm}_bn")
    yield from _layers_conv(namer, dec + ("conv_concat", "Conv_0"),
                            name="conv_concat")
    yield from _bn(namer, dec + ("conv_concat", "Norm_0"),
                   name="conv_concat_bn")
    yield from _layers_conv(namer, dec + ("deconv_revise", "ConvTranspose_0"),
                            name="deconv_revise", transpose=True)
    yield from _bn(namer, dec + ("deconv_revise", "Norm_0"),
                   name="deconv1_revise_bn")
    yield from _layers_conv(namer, dec + ("predict_revise",),
                            name="predict_revise", transpose=True)


def _gn_easy(namer: _Namer) -> Iterator[MapEntry]:
    """GN easy-upsampling variants inference_p3d / inference_p3d_concat
    (reference gn/p3d_gn.py:214-258 / :280-324).  The decoder's deconv_pool3
    is created BETWEEN encoder stages 2 and 3 (reference gn/p3d_gn.py:234-236),
    so the group_norm counter interleaves — creation order is exact here.
    The two variants differ only in deconv_pool4 width (1024 vs 512), which
    doesn't affect names."""
    dec = ("decoder",)
    yield from _stem(namer, "gn")
    yield from _stage(namer, 0, "gn", cbam=True)
    yield from _stage(namer, 1, "gn", cbam=True)
    yield from _cnr(namer, "deconv_pool3", dec + ("deconv_pool3",),
                    transpose=True, mode="gn")
    yield from _stage(namer, 2, "gn", cbam=True)
    yield from _cnr(namer, "deconv_pool4", dec + ("deconv_pool4",),
                    transpose=True, mode="gn")
    yield from _cnr(namer, "conv_concat", dec + ("conv_concat",), mode="gn")
    yield from _cnr(namer, "deconv_revise", dec + ("deconv_revise",),
                    transpose=True, mode="gn")
    yield from _layers_conv(namer, dec + ("predict_revise",),
                            name="predict_revise", transpose=True)


def _gn_decoder_block(namer: _Namer) -> Iterator[MapEntry]:
    """inference_p3d_decoder_block (reference gn/p3d_gn.py:489-539): built
    inside variable_scope('P3D') (namer.prefix), deconv_pool2/3/4 interleaved
    between the encoder stages, then the two decoder blocks."""
    dec = ("decoder",)
    yield from _stem(namer, "gn")
    yield from _stage(namer, 0, "gn", cbam=True)
    yield from _cnr(namer, "deconv_pool2", dec + ("deconv_pool2",),
                    transpose=True, mode="gn")
    yield from _stage(namer, 1, "gn", cbam=True)
    yield from _cnr(namer, "deconv_pool3", dec + ("deconv_pool3",),
                    transpose=True, mode="gn")
    yield from _stage(namer, 2, "gn", cbam=True)
    yield from _cnr(namer, "deconv_pool4", dec + ("deconv_pool4",),
                    transpose=True, mode="gn")
    for nm, transpose in [("conv_concat", False), ("decoder1_conv1", False),
                          ("decoder1_deconv", True), ("decoder1_conv2", False),
                          ("decoder2_conv1", False), ("decoder2_deconv", True),
                          ("decoder2_conv2", False)]:
        yield from _cnr(namer, nm, dec + (nm,), transpose=transpose, mode="gn")
    yield from _layers_conv(namer, dec + ("results",), name="results")


_DECODER_BUILDERS: dict[str, Callable[[_Namer], Iterator[MapEntry]]] = {
    "p3d_unet": _unet_decoder,
    "p3d_concat": _concat_decoder,
    "p3d_unetplusplus": lambda n: _unetpp_decoder(n, True, "full"),
    "p3d_unetplusplus_ds": lambda n: _unetpp_decoder(n, True, "ds"),
    "p3d_unetplusplus_nonsa": lambda n: _unetpp_decoder(n, False, "ds"),
}

# GN variants whose reference graphs are actually constructible: the SA GN
# variants call attention(x, ch, name, subsample) from a `network` module the
# reference repo does not contain (gn/p3d_gn.py:2 `from network import *`
# resolves to nothing in-tree; utils/network.py's attention has an
# incompatible signature, utils/network.py:157), so no reference checkpoint
# for them can exist to import.
_GN_BUILDERS: dict[str, Callable[[], Iterator[MapEntry]]] = {
    "inference_p3d": lambda: _gn_easy(_Namer()),
    "inference_p3d_concat": lambda: _gn_easy(_Namer()),
    "inference_p3d_decoder_block": lambda: _gn_decoder_block(_Namer("P3D/")),
}


def variable_mapping(model_name: str) -> list[MapEntry]:
    """Ordered TF-variable -> flax-path mapping for a reference variant."""
    if model_name in _DECODER_BUILDERS:
        namer = _Namer()
        entries = list(_encoder(namer))
        entries += list(_DECODER_BUILDERS[model_name](namer))
        return entries
    if model_name in _GN_BUILDERS:
        return list(_GN_BUILDERS[model_name]())
    raise NotImplementedError(
        f"TF checkpoint import supports {sorted(_DECODER_BUILDERS)} + "
        f"{sorted(_GN_BUILDERS)}.  {model_name!r} has no importable reference "
        f"checkpoint: the SA GN variants (and the unrunnable 'nl' variant) "
        f"depend on an attention module absent from the reference repo "
        f"(gn/p3d_gn.py:2), so their TF graphs cannot be built or trained."
    )


def load_tf_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Every variable of a TF checkpoint (a directory or a prefix), read
    without TensorFlow (``interop/tf_bundle.py``)."""
    return read_checkpoint(path)


def state_dict_from_tf_variables(model_name: str, tf_vars: dict[str, np.ndarray]
                                 ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from an in-memory ``{TF name: array}`` dict:
    ``map_tf_variables``, then the flax bridge."""
    variables = map_tf_variables(model_name, tf_vars)
    return state_dict_from_flax(variables[PARAMS], variables[STATS])


def import_checkpoint(model_name: str, ckpt_path: str) -> dict[str, torch.Tensor]:
    """TF checkpoint -> the port's ``state_dict`` for ``model_name``.

    Raises KeyError with the missing TF variable names if the checkpoint
    doesn't match the expected graph (wrong variant), and ValueError on any
    variable of the model's kind it does not map."""
    return state_dict_from_tf_variables(model_name, load_tf_checkpoint(ckpt_path))


def map_tf_variables(model_name: str, tf_vars: dict[str, np.ndarray]) -> dict:
    """Apply the variable mapping to an in-memory {tf_name: array} dict."""
    entries = variable_mapping(model_name)
    missing = [e.tf_name for e in entries if e.tf_name not in tf_vars]
    if missing:
        raise KeyError(
            f"checkpoint lacks {len(missing)} expected variables for "
            f"{model_name} (first few: {missing[:5]})"
        )
    out: dict = {PARAMS: {}, STATS: {}}
    for e in entries:
        arr = _transform(e.transform, tf_vars[e.tf_name])
        node = out[e.collection]
        for key in e.path[:-1]:
            node = node.setdefault(key, {})
        node[e.path[-1]] = arr
    # Optimizer slots (Adam moments 'xxx/Adam', 'xxx/Adam_1') and TF
    # bookkeeping variables are intentionally ignored — but any OTHER
    # leftover means the modeled naming and the checkpoint disagree
    # (e.g. a py2-era SA checkpoint whose auto-numbered scopes differ from
    # the regeneration): fail loudly with the stranded names.
    mapped = {e.tf_name for e in entries}
    leftovers = [
        name for name in sorted(tf_vars)
        if name not in mapped and not _is_non_model_variable(name)
    ]
    if leftovers:
        raise ValueError(
            f"checkpoint contains {len(leftovers)} model-like variables the "
            f"{model_name} mapping does not cover (naming mismatch?): "
            f"{leftovers[:8]}{' ...' if len(leftovers) > 8 else ''}"
        )
    return out


def _is_non_model_variable(name: str) -> bool:
    """TF optimizer slots / trainer bookkeeping that legitimately live in
    reference checkpoints alongside the model weights
    (reference train.py:168-185: AdamOptimizer slots + Saver).

    Matched by pattern, not exact name: a re-instantiated optimizer in the
    same graph auto-numbers its slots (Adam_2/Adam_3, beta1_power_1, ...),
    and Momentum / EMA shadows are equally benign bookkeeping."""
    last = name.rsplit("/", 1)[-1]
    return bool(
        re.fullmatch(r"Adam(_\d+)?|Momentum(_\d+)?|ExponentialMovingAverage", last)
        or re.fullmatch(r"beta[12]_power(_\d+)?|global_step", name)
    )


def validate_against_model(state_dict: dict[str, torch.Tensor],
                           model: torch.nn.Module) -> None:
    """Assert imported tensors exactly match the model's own ``state_dict``
    (same keys, same shapes): catches mapping drift early and cheaply (no
    forward)."""
    want = model.state_dict()
    extra = sorted(set(state_dict) - set(want))
    lacking = sorted(set(want) - set(state_dict))
    if extra or lacking:
        raise ValueError(
            f"imported tree mismatch: extra={extra[:5]} missing={lacking[:5]} "
            f"(+{max(0, len(extra) - 5) + max(0, len(lacking) - 5)} more)"
        )
    for key in want:
        if tuple(state_dict[key].shape) != tuple(want[key].shape):
            raise ValueError(
                f"{key}: imported shape {tuple(state_dict[key].shape)} != model "
                f"{tuple(want[key].shape)}"
            )
