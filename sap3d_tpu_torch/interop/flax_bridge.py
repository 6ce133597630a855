"""Carry ``sap3d_tpu`` (flax) weights and train state across to the port.

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
  * ``nn.Dense`` kernels (the CBAM and SE MLPs) go from ``[in, out]`` to
    ``[out, in]``;
  * BN scale/bias/mean/var, GN scale/bias and ``gamma`` go straight across.

GN models have no ``batch_stats`` tree; pass None or an empty mapping.

``optimizer_state_from_optax`` carries the Adam state as well: optax's
``mu``/``nu`` trees (the parameters' layouts, so the same conversion) and
``count`` become torch Adam's ``exp_avg``/``exp_avg_sq``/``step`` per
parameter, so a JAX train state can continue in the port.

Inputs are nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``
of a flax train state, whose optimizer state stays a tuple of optax's named
tuples); nothing here imports JAX or optax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# Flax module names that are transposed convs: the TransposeConvNormRelu
# submodule and the bare head tconvs (sap3d_tpu/models/p3d.py:_tconv): the
# UNet++ heads' ``x_0_1``, the U-Net head's ``head_tconv`` and the concat
# and GN decoders' ``predict_revise``.
TCONV_MODULES = frozenset({"ConvTranspose_0", "x_0_1", "head_tconv", "predict_revise"})


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
    if parts[-1] != "kernel":
        return value
    if value.ndim == 2:  # nn.Dense
        return value.T
    if value.ndim != 5:
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


def _find_adam_state(opt_state):
    """The element of an optax state that carries ``mu``, ``nu`` and
    ``count`` (``ScaleByAdamState``), searched through tuples and
    ``inner_state`` wrappers (``MaskedState``)."""
    if all(hasattr(opt_state, a) for a in ("mu", "nu", "count")):
        return opt_state
    inner = getattr(opt_state, "inner_state", None)
    children = [inner] if inner is not None else (
        list(opt_state) if isinstance(opt_state, (tuple, list)) else [])
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def optimizer_state_from_optax(opt_state, model: torch.nn.Module
                               ) -> dict[str, dict[str, torch.Tensor]]:
    """torch Adam's per-parameter state, ``{parameter name: {"step",
    "exp_avg", "exp_avg_sq"}}``, from an optax Adam state (``optax.adam``
    or the masked coupled-L2 chain of ``sap3d_tpu.train.state``).  Every
    parameter of ``model`` must be covered, with its shape
    (``train/state.TrainState.load_optimizer_state`` loads the result)."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    mu, nu = _flatten(adam.mu), _flatten(adam.nu)
    params = dict(model.named_parameters())
    if set(mu) != set(nu) or {k.replace("/", ".") for k in mu} != set(params):
        raise KeyError(f"optax moments do not cover the model's parameters: "
                       f"{sorted({k.replace('/', '.') for k in mu} ^ set(params))[:10]}")
    out = {}
    for path in mu:
        name = path.replace("/", ".")
        m, v = (torch.from_numpy(np.array(convert_leaf(path, t[path]), dtype=np.float32,
                                          order="C")) for t in (mu, nu))
        if m.shape != params[name].shape:
            raise ValueError(f"{name}: optax {tuple(m.shape)}, torch "
                             f"{tuple(params[name].shape)}")
        out[name] = {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
    return out
