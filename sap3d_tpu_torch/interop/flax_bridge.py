"""Carry ``sap3d_tpu`` (flax) weights across to the port's ``state_dict``.

The port's module tree mirrors the flax variable tree, so a flax path maps
to a torch key by replacing ``/`` with ``.``:

    params/decoder/x_3_1/Conv_0/kernel          -> decoder.x_3_1.Conv_0.kernel
    params/decoder/x_1_3_sa/gamma               -> decoder.x_1_3_sa.gamma
    batch_stats/encoder/stem_norm/BatchNorm_0/mean
                                                -> encoder.stem_norm.BatchNorm_0.mean

Only kernels change layout:
  * conv kernels go from ``[kd, kh, kw, in, out]`` to ``[out, in, kd, kh, kw]``;
  * transposed-conv kernels (flax ``nn.ConvTranspose``, which does not
    transpose its kernel) are flipped on the three spatial axes, then go to
    ``[in, out, kd, kh, kw]`` (the layout of ``F.conv_transpose3d``);
  * BN scale/bias/mean/var and ``gamma`` go straight across.

Inputs are nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``
of a flax train state); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# Flax module names that are transposed convs: the TransposeConvNormRelu
# submodule and the UNet++ head tconv (sap3d_tpu/models/p3d.py:_tconv).
TCONV_MODULES = frozenset({"ConvTranspose_0", "x_0_1"})


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def convert_leaf(path: str, value: np.ndarray) -> np.ndarray:
    """One flax leaf in the port's layout."""
    parts = path.split("/")
    if parts[-1] != "kernel" or value.ndim != 5:
        return value
    if len(parts) >= 2 and parts[-2] in TCONV_MODULES:
        return np.flip(value, axis=(0, 1, 2)).transpose(3, 4, 0, 1, 2)
    return value.transpose(4, 3, 0, 1, 2)


def state_dict_from_flax(params: Mapping, batch_stats: Mapping | None = None,
                         model: torch.nn.Module | None = None
                         ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from flax ``params`` and ``batch_stats``.

    Every flax leaf becomes one torch entry.  With ``model`` the mapping is
    checked strictly both ways (every flax leaf names a key of the model,
    every key of the model is filled, shapes agree) and a mismatch raises
    ``KeyError``/``ValueError`` listing the offending names."""
    flat = _flatten(params)
    stats = _flatten(batch_stats or {})
    clash = set(flat) & set(stats)
    if clash:
        raise KeyError(f"paths in both params and batch_stats: {sorted(clash)[:5]}")
    flat.update(stats)
    sd = {
        path.replace("/", "."): torch.from_numpy(
            np.array(convert_leaf(path, val), dtype=np.float32, order="C"))
        for path, val in flat.items()
    }
    if model is not None:
        want = model.state_dict()
        unused = sorted(set(sd) - set(want))
        unfilled = sorted(set(want) - set(sd))
        if unused or unfilled:
            raise KeyError(f"flax leaves with no torch key: {unused[:10]} "
                           f"({len(unused)}); torch keys not filled: "
                           f"{unfilled[:10]} ({len(unfilled)})")
        bad = [(k, tuple(sd[k].shape), tuple(want[k].shape))
               for k in sd if sd[k].shape != want[k].shape]
        if bad:
            raise ValueError(f"shape mismatches (flax, torch): {bad[:10]}")
    return sd
