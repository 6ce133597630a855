"""Model registry: every reference model name -> a P3DSaliency configuration.

A copy of ``sap3d_tpu/models/registry.py``'s tables (the port imports
nothing of ``sap3d_tpu``).  ``build_model`` builds every name: the BN
family (``p3d_unetplusplus_ds`` is the flagship, alias ``unet++``), the
GN + CBAM family and the two debug-scale models.
"""

from __future__ import annotations

from typing import Any

import torch

from sap3d_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from sap3d_tpu_torch.models.p3d import P3DSaliency

# name -> (decoder, decoder_kwargs, norm_mode, backbone_cbam, ...)
MODEL_REGISTRY: dict[str, dict[str, Any]] = {
    # ---- BN family (reference p3d.py) ----
    "p3d_unet": dict(decoder="unet", norm_mode="bn"),
    "p3d_concat": dict(decoder="concat", norm_mode="bn"),
    "p3d_unetplusplus": dict(
        decoder="unetpp",
        decoder_kwargs=dict(attention="sa", head="full"),
        norm_mode="bn",
    ),
    "p3d_unetplusplus_ds": dict(
        decoder="unetpp",
        decoder_kwargs=dict(attention="sa", head="ds"),
        norm_mode="bn",
    ),
    "p3d_unetplusplus_nonsa": dict(
        decoder="unetpp",
        decoder_kwargs=dict(attention="none", head="ds"),
        norm_mode="bn",
    ),
    "p3d_unetplusplus_nl": dict(
        decoder="unetpp",
        decoder_kwargs=dict(attention="nl", head="ds"),
        norm_mode="bn",
    ),
    # ---- GN + CBAM family (reference gn/p3d_gn.py) ----
    "inference_p3d": dict(
        decoder="gn_easy",
        decoder_kwargs=dict(wide_pool4=True),
        norm_mode="gn",
        backbone_cbam=True,
    ),
    "inference_p3d_concat": dict(
        decoder="gn_easy",
        decoder_kwargs=dict(wide_pool4=False),
        norm_mode="gn",
        backbone_cbam=True,
    ),
    "inference_p3d_sa_concat": dict(
        decoder="gn_easy",
        decoder_kwargs=dict(wide_pool4=False, use_sa=True),
        norm_mode="gn",
        backbone_cbam=True,
    ),
    "inference_p3d_sa_concat_2": dict(
        decoder="gn_sa_concat_2",
        norm_mode="gn",
        backbone_cbam=True,
    ),
    "inference_p3d_sa_decoder_block": dict(
        decoder="gn_decoder_block",
        decoder_kwargs=dict(use_sa=True),
        norm_mode="gn",
        backbone_cbam=True,
    ),
    "inference_p3d_decoder_block": dict(
        decoder="gn_decoder_block",
        decoder_kwargs=dict(use_sa=False),
        norm_mode="gn",
        backbone_cbam=True,
    ),
    # ---- debug/CI scale (not a reference variant): the flagship topology
    # at ~1/1000 the parameters
    "p3d_micro": dict(
        decoder="unetpp",
        decoder_kwargs=dict(attention="none", head="ds"),
        norm_mode="bn",
        stages=((4, 1), (4, 1), (4, 1)),
        stem_features=4,
    ),
    # the same, with the flagship's self-attention sites
    "p3d_micro_sa": dict(
        decoder="unetpp",
        decoder_kwargs=dict(attention="sa", head="ds"),
        norm_mode="bn",
        stages=((8, 1), (16, 1), (32, 1)),
        stem_features=8,
    ),
}

# The trainer CLI's --structure values.
STRUCTURE_ALIASES = {
    "unet": "p3d_unet",
    "concat": "p3d_concat",
    "unet++": "p3d_unetplusplus_ds",
    "unet++full": "p3d_unetplusplus",
    "unet++nonsa": "p3d_unetplusplus_nonsa",
    "unet++nl": "p3d_unetplusplus_nl",
    "P3D": "inference_p3d",
    "P3D_CONCAT": "inference_p3d_concat",
    "P3D_SA_CONCAT": "inference_p3d_sa_concat",
    "P3D_SA_CONCAT_2": "inference_p3d_sa_concat_2",
    "P3D_SA_DECODER": "inference_p3d_sa_decoder_block",
    "P3D_DECODER": "inference_p3d_decoder_block",
}

# Variants whose output is linear (no sigmoid).
LINEAR_OUTPUT = {
    "p3d_concat",
    "inference_p3d",
    "inference_p3d_concat",
    "inference_p3d_sa_concat",
    "inference_p3d_sa_concat_2",
    "inference_p3d_sa_decoder_block",
    "inference_p3d_decoder_block",
}


def resolve_name(name: str) -> str:
    if name in MODEL_REGISTRY:
        return name
    if name in STRUCTURE_ALIASES:
        return STRUCTURE_ALIASES[name]
    raise KeyError(
        f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)} "
        f"or aliases {sorted(STRUCTURE_ALIASES)}"
    )


def build_model(name: str, dtype: str | torch.dtype | None = None,
                device: str | torch.device = DEFAULT_DEVICE,
                seed: int = 0, dropout_rate: float = 0.5, ring_mesh=None,
                bn_reference_quirk: bool = False) -> P3DSaliency:
    """The named model in eval mode on ``device``, its parameters made from
    ``seed`` (Glorot-uniform conv kernels, variance-scaling CBAM kernels,
    zero biases, unit norm scales and BN statistics, ``gamma`` = 0, as the
    flax init); ``dropout_rate`` applies in train mode.  ``ring_mesh`` (a
    ``core/mesh.make_time_mesh`` mesh) turns the UNet++ SA decoders'
    attention sites into rings (``ops/ring_attention.py``); the parameters
    are the same with and without it.  ``bn_reference_quirk=True`` gives
    the reference's inference, which the maps of its TF checkpoints need:
    the bottleneck BNs normalize with batch statistics in eval mode too
    (``models/p3d.py:Bottleneck``; BN models only)."""
    name = resolve_name(name)
    dev = resolve_device(device)
    cfg = dict(MODEL_REGISTRY[name])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = P3DSaliency(**cfg, dtype=resolve_dtype(dtype), dropout_rate=dropout_rate,
                            ring_mesh=ring_mesh, bn_reference_quirk=bn_reference_quirk)
    return model.to(dev).eval()
