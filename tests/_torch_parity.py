"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
paired models, and the limits of a train step against JAX's (the gradient,
the Adam moments and update, the BN statistics; their reasons beside them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sap3d_tpu.models import registry as jreg
from sap3d_tpu.models.p3d import P3DSaliency as JaxP3DSaliency
from sap3d_tpu_torch.interop.flax_bridge import (
    convert_leaf,
    optimizer_state_from_optax,
    state_dict_from_flax,
)
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


# -- a train step against JAX's ----------------------------------------------


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, p) if isinstance(v, dict) else {p: v})
    return out


def assert_stats_close(tm, jstate, steps: int):
    """BN statistics within STAT_TOL[steps] of each tensor's largest value."""
    want = state_dict_from_flax(jstate.params, jstate.batch_stats)
    got = tm.state_dict()
    excess = {name: (got[name] - w).abs().max().item() / (STAT_TOL[steps] * w.abs().max().item())
              for name, w in want.items() if name.endswith((".mean", ".var"))}
    assert excess and max(excess.values()) <= 1, \
        sorted(excess.items(), key=lambda kv: -kv[1])[:3]


# After one step the BN statistics are the forward's (1e-6 measured).  From
# the second step on, the two trajectories part: Adam's first step moves
# every parameter by exactly lr, and about 7e4 of the micro model's
# gradients differ in sign between the packages (they are near zero), so the
# next forward sees parameters up to 2 lr apart; measured BN statistics
# 4e-4 of scale apart after two steps, 2.6e-3 after three.
STAT_TOL = {1: 1e-5, 2: 2e-3, 3: 1e-2}


def snapshot(tm) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in tm.named_parameters()}


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Parameters, buffers and Adam state of a port ``TrainState``, copied."""
    opt = state.optimizer
    out = {f"model.{n}": t.detach().clone() for n, t in state.model.state_dict().items()}
    for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        for k, t in opt.state[p].items():
            out[f"opt.{i}.{k}"] = t.detach().clone()
    return out


def differing(a: dict, b: dict) -> list[str]:
    """The tensors of ``a`` that are not bit for bit those of ``b``."""
    assert a.keys() == b.keys()
    return [n for n in a if not torch.equal(a[n], b[n])]


def jax_params(tm, params) -> dict[str, torch.Tensor]:
    """A JAX parameter tree in the port's layout."""
    sd = state_dict_from_flax(params, {})
    return {n: sd[n] for n, _ in tm.named_parameters()}


# Adam moves a parameter by lr * m_hat / (sqrt(v_hat) + eps): a function of
# its two moments and the step count alone.  The update, (p_before -
# p_after) / lr on each side, is held on the elements whose two moments
# agree to MOMENT_AGREE: there the two updates differ by at most 1.5 times
# that, plus the float32 rounding of the parameters (4 ulps of the parameter
# over lr); UPDATE_TOL allows for both (measured 1.5e-2 at worst).  An lr
# off by 2x moves the update by 100%, a step count off by one by 16-34% (the
# bias corrections at steps 1-3).  Where a step starts from the same
# parameters and moments in both packages, the moments are also held per
# tensor as the gradient is (relative L2 under GRAD_TOL with GRAD_FLOOR;
# v, a square, under twice that), and the update on at least HELD_SHARE of
# the elements (25% and 51% measured: the micro model's float32 gradients
# agree only to ~1e-2 per element, see GRAD_TOL).  From a step that starts
# apart (the trajectories part from step 2, see STAT_TOL) the moments
# differ by more than the gradient's limit and the update is held where
# they still agree (0.3% to 6% of the elements).
MOMENT_AGREE, UPDATE_TOL, HELD_SHARE = 1e-2, 2e-2, 0.2


def optimizer_excess(tm, opt, before, jax_before, jstate, lr: float = 1e-4) -> dict:
    """How far the port's optimizer step, from parameters ``before`` to the
    model's now, is from JAX's, from ``jax_before`` to ``jstate``: each
    measure over its limit (<= 1 agrees), the share of elements whose
    update is held, and the step counts of both."""
    want = optimizer_state_from_optax(jstate.opt_state, tm)
    jax_after = jax_params(tm, jstate.params)
    m_scale = max(w["exp_avg"].abs().max().item() for w in want.values())
    v_scale = max(w["exp_avg_sq"].max().item() for w in want.values())
    moments = update = 0.0
    held_n = total = 0
    steps = set()
    for name, p in tm.named_parameters():
        got, w = opt.state[p], want[name]
        steps.add(float(got["step"]))
        dm, dv = got["exp_avg"] - w["exp_avg"], got["exp_avg_sq"] - w["exp_avg_sq"]
        moments = max(moments,
                      (dm.norm() / (GRAD_TOL * w["exp_avg"].norm() + GRAD_FLOOR * m_scale)).item(),
                      (dv.norm() / (2 * GRAD_TOL * w["exp_avg_sq"].norm()
                                    + GRAD_FLOOR * v_scale)).item())
        held = (dm.abs() <= MOMENT_AGREE * w["exp_avg"].abs()) \
            & (dv.abs() <= MOMENT_AGREE * w["exp_avg_sq"]) & (w["exp_avg_sq"] > 0)
        after = p.detach()
        u = (before[name] - after) / lr
        uj = (jax_before[name] - jax_after[name]) / lr
        mag = torch.stack([before[name], after, jax_before[name], jax_after[name]]).abs().amax(0)
        limit = UPDATE_TOL * uj.abs() + 4 * 2.0 ** -23 * mag / lr
        if held.any():
            update = max(update, ((u - uj).abs() / limit)[held].max().item())
        held_n += int(held.sum())
        total += held.numel()
    jax_step = {float(w["step"]) for w in want.values()}
    return dict(moments=moments, update=update, held=held_n / total, steps=steps,
                jax_steps=jax_step)


def assert_optimizer_close(tm, opt, before, jax_before, jstate, same_start: bool,
                           lr: float = 1e-4):
    """``optimizer_excess`` within its limits; ``same_start``: the step
    began from the same parameters and moments in both packages."""
    ex = optimizer_excess(tm, opt, before, jax_before, jstate, lr)
    assert ex["steps"] == ex["jax_steps"] and len(ex["steps"]) == 1, ex
    assert ex["update"] <= 1 and ex["held"] > 0, ex
    if same_start:
        assert ex["moments"] <= 1 and ex["held"] >= HELD_SHARE, ex


def grad_distance(got: dict, jax_grads) -> tuple[float, dict]:
    """The relative L2 distance of the whole gradient, and per tensor the
    ratio of ||g - w|| to its limit GRAD_TOL ||w|| + GRAD_FLOOR max|w_all|."""
    want = {p.replace("/", "."): torch.from_numpy(np.array(convert_leaf(p, w)))
            for p, w in flat_tree(jax_grads).items()}
    assert set(want) == set(got)
    scale = max(w.abs().max().item() for w in want.values())
    total = sum(((got[n] - w) ** 2).sum() for n, w in want.items()).sqrt() \
        / sum((w ** 2).sum() for w in want.values()).sqrt()
    per = {n: ((got[n] - w).norm() / (GRAD_TOL * w.norm() + GRAD_FLOOR * scale)).item()
           for n, w in want.items()}
    return total.item(), per


# The micro model's train-mode BN sees 8 to 64 samples per channel, which
# makes its gradient ill-conditioned in float32: against the port's float64
# gradient, JAX's float32 one is up to 7e-2 away on single tensors and the
# port's float32 one 2e-2 (x_3_1's gamma, a sum that cancels, 5e-1).  Measured
# port-vs-JAX distances: 1.2e-2 for the whole gradient, per tensor median
# 1.2e-2, worst 2.2e-2 apart from that gamma.  GRAD_FLOOR covers gradients
# that are zero but for rounding (the biases feeding a train-mode BN).
GRAD_TOL, GRAD_FLOOR = 5e-2, 1e-3
