"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from sap3d_tpu.models import registry as jreg
from sap3d_tpu.models.p3d import P3DSaliency as JaxP3DSaliency
from sap3d_tpu_torch.interop.flax_bridge import state_dict_from_flax
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.models.p3d import P3DSaliency as TorchP3DSaliency

# The encoder width of the registry's p3d_micro_sa, for any decoder (the
# decoders' own widths are fixed: up to 1024 channels in the GN family).
MICRO = dict(stages=((8, 1), (16, 1), (32, 1)), stem_features=8)


def numpy_variables(model, input_shape, seed: int = 0):
    """flax (params, batch_stats) of ``model`` made with numpy from ``seed``.

    Shapes come from ``jax.eval_shape`` (running flax's init on the CPU
    costs tens of seconds).  Kernels are normal with variance 1/fan_in;
    biases, BN scales and statistics and ``gamma`` are random, so every BN
    and every attention site contributes."""
    rng = np.random.default_rng(seed)
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(input_shape), train=False))

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.normal(size=v.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif k == "gamma":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            elif k in ("var", "scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                raise KeyError(f"unexpected leaf {k!r}")
        return out

    return fill(dict(abstract["params"])), fill(dict(abstract.get("batch_stats", {})))


def build_pair(name: str, input_shape, seed: int = 0):
    """The JAX model, its flax variables, and the port's model (CPU, eval)
    carrying the same weights."""
    jm = jreg.build_model(name)
    params, stats = numpy_variables(jm, input_shape, seed)
    tm = treg.build_model(name, device="cpu")
    tm.load_state_dict(state_dict_from_flax(params, stats, model=tm), strict=True)
    return jm, {"params": params, "batch_stats": stats}, tm


def build_micro_pair(name: str, input_shape, seed: int = 0, dropout_rate: float = 0.5):
    """As ``build_pair`` for the registry configuration ``name`` on the
    ``MICRO`` encoder (its own ``stages`` where it names them): the decoder,
    norm mode and CBAM of the name at a width the CPU runs in seconds."""
    cfg = {**MICRO, **jreg.MODEL_REGISTRY[jreg.resolve_name(name)]}
    jm = JaxP3DSaliency(**cfg, dropout_rate=dropout_rate)
    params, stats = numpy_variables(jm, input_shape, seed)
    tm = TorchP3DSaliency(**cfg, dropout_rate=dropout_rate).eval()
    tm.load_state_dict(state_dict_from_flax(params, stats, model=tm), strict=True)
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
    return jm, variables, tm


def record_routes(monkeypatch):
    """Patch the port's ``attention_route`` to record ``((Nq, Nk, d, C),
    route)`` of every gated site call; returns the list it appends to."""
    from sap3d_tpu_torch.ops import attention

    orig, seen = attention.attention_route, []

    def spy(nq, nk, d, c, dtype, train):
        route = orig(nq, nk, d, c, dtype, train)
        seen.append(((nq, nk, d, c), route))
        return route

    monkeypatch.setattr(attention, "attention_route", spy)
    return seen
