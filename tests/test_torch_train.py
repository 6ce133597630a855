"""Parity of the port's train path (sap3d_tpu_torch/train, train-mode layers)
with the JAX package's, on the CPU.

The same numpy-made inputs go through both packages.  Tolerances:

* loss and smooth-L1: float32 sums of the same terms in another order,
  rtol 1e-5;
* train-mode BN: float32 statistics of the same input; output, running
  statistics and gradients to 1e-5 of their scale (the port normalizes with
  torch's one-pass variance, flax with E[x^2] - E[x]^2);
* Adam: the same update formula, float32, 1e-6 relative;
* the micro train step (fp32, dropout 0): the loss to 1e-5 relative; the
  gradient by relative L2 distance, whole and per tensor, under
  ``GRAD_TOL`` (see there: the micro model's train-mode BN makes it
  ill-conditioned), which a backward without delta fails; after each step
  the Adam moments (held as the gradient is), the step count and the
  update of each parameter (``_optimizer_excess``, held tightly where the
  moments agree; a wrong lr or step count fails it), and the BN statistics
  under ``STAT_TOL``; the later losses to 2e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_parity import build_pair
from sap3d_tpu.models import registry as jreg
from sap3d_tpu.ops.fast_tconv import space_to_depth3d
from sap3d_tpu.ops.layers import smooth_l1_loss as jax_smooth_l1
from sap3d_tpu.train.state import TrainState as JaxTrainState
from sap3d_tpu.train.state import make_optimizer as jax_make_optimizer
from sap3d_tpu.train.steps import loss_fn_saliency as jax_loss_fn
from sap3d_tpu.train.steps import _one_step as jax_one_step
from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from sap3d_tpu_torch.interop.flax_bridge import (
    convert_leaf,
    optimizer_state_from_optax,
    state_dict_from_flax,
)
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.ops.layers import BatchNorm, smooth_l1_loss
from sap3d_tpu_torch.train.state import create_train_state, make_optimizer
from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_train_step
from sap3d_tpu_torch.train.trainer import Trainer

SHAPE = (2, 16, 32, 32, 3)  # p3d_micro_sa at 32 px: x_2_2 (Nq 256) and x_1_3 (2048)
LR = 1e-4  # the trainer's default


def test_smooth_l1_and_saliency_loss_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(-1.0, 3.0, size=(2, 4, 8, 8, 1)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, size=(2, 4, 8, 8)).astype(np.float32)
    # both branches of the switch are taken
    assert 0.1 < (np.abs(pred[..., 0] - target) < 1).mean() < 0.9
    want = float(jax_loss_fn(jnp.asarray(pred), jnp.asarray(target)))
    # the JAX trainer's default phase-layout loss on the same prediction
    phase = space_to_depth3d(jnp.asarray(pred[..., 0]), (2, 2, 2))
    assert phase.shape == (2, 2, 4, 4, 8)
    want_phase = float(jax_loss_fn(phase, jnp.asarray(target)))
    tp = torch.tensor(pred, requires_grad=True)
    got = loss_fn_saliency(tp, torch.tensor(target))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    np.testing.assert_allclose(got.item(), want_phase, rtol=1e-5)
    # the gradient, with the switch factor a constant
    want_g = jax.grad(lambda p: jax_smooth_l1(p, jnp.asarray(target[..., None]), 1.0, 1.0,
                                              sigma=1.0))(jnp.asarray(pred))
    (got_g,) = torch.autograd.grad(
        smooth_l1_loss(tp, torch.tensor(target[..., None])), tp)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 4, 6, 6, 16),   # NDHWC
                                   (1, 1, 7, 7, 32)])  # 49 samples, as at x_4_0
def test_train_mode_batch_norm_matches_flax(dtype, shape):
    rng = np.random.default_rng(1)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 1.5).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3, dtype=jdt)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    xj = jnp.asarray(x).astype(jdt)

    def f(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, xj)

    m = BatchNorm(c, dtype=tdt).train()
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.copy_(torch.from_numpy(mean0))
        m.var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).to(tdt).permute(0, 4, 1, 2, 3).requires_grad_()
    y = m(tx)
    assert y.dtype == tdt
    gx, gs, gb = torch.autograd.grad(
        (y.float() * torch.from_numpy(cot).permute(0, 4, 1, 2, 3)).sum(),
        (tx, m.scale, m.bias))

    def close(got, want, rel):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rel,
                                   atol=rel * np.abs(want).max())

    rel = 1e-5 if dtype == "float32" else 2.0 ** -7  # bf16: one rounding of y
    close(y.permute(0, 2, 3, 4, 1), want_y, rel)
    close(m.mean, want_stats["mean"], 1e-6)
    close(m.var, want_stats["var"], 1e-6)
    close(gs, want_gp["scale"], 1e-5 if dtype == "float32" else 2.0 ** -6)
    close(gb, want_gp["bias"], 1e-5 if dtype == "float32" else 2.0 ** -6)
    close(gx.permute(0, 2, 3, 4, 1), want_gx, 1e-4 if dtype == "float32" else 2.0 ** -6)
    # the biased variance: the unbiased one moves var visibly at 49 samples
    n = x.size // c
    unbiased = 0.99 * var0 + 0.01 * x.reshape(-1, c).var(0, ddof=1)
    assert np.abs(unbiased - m.var.numpy()).max() > 1e-6 * n / (n - 1)


class _Toy(torch.nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.layer = torch.nn.Module()
        self.layer.kernel = torch.nn.Parameter(torch.tensor(kernel))
        self.layer.bias = torch.nn.Parameter(torch.tensor(bias))


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adam_matches_optax(weight_decay):
    """Three steps on fixed gradients; with weight decay, coupled L2 on the
    kernel only."""
    rng = np.random.default_rng(2)
    kernel = rng.normal(size=(3, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    grads = [{"layer": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                        "bias": rng.normal(size=(4,)).astype(np.float32)}} for _ in range(3)]
    tx = jax_make_optimizer(LR, weight_decay)
    params = {"layer": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    opt_state = tx.init(params)
    toy = _Toy(kernel, bias)
    opt = make_optimizer(toy, LR, weight_decay)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, upd)
        toy.layer.kernel.grad = torch.tensor(g["layer"]["kernel"])
        toy.layer.bias.grad = torch.tensor(g["layer"]["bias"])
        opt.step()
    for name in ("kernel", "bias"):
        np.testing.assert_allclose(getattr(toy.layer, name).detach().numpy(),
                                   np.asarray(params["layer"][name]), rtol=1e-6, atol=1e-7)
    if weight_decay:  # the decay reached the kernel and not the bias
        plain = jax_make_optimizer(LR, 0.0)
        p0 = {"layer": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
        s0 = plain.init(p0)
        for g in grads:
            upd, s0 = plain.update(jax.tree.map(jnp.asarray, g), s0, p0)
            p0 = optax.apply_updates(p0, upd)
        assert np.abs(np.asarray(p0["layer"]["kernel"]) - toy.layer.kernel.detach().numpy()
                      ).max() > 1e-5
        np.testing.assert_allclose(toy.layer.bias.detach().numpy(),
                                   np.asarray(p0["layer"]["bias"]), rtol=1e-6, atol=1e-7)


# -- the micro train step against JAX's make_train_step --------------------


@pytest.fixture(scope="module")
def jax_run():
    """JAX: p3d_micro_sa, fp32, dropout 0, three train steps (the body of
    ``make_train_step``) from random numpy weights; the states after each
    step, and step 1's loss and gradients."""
    jm, variables, tm = build_pair("p3d_micro_sa", SHAPE, seed=3)
    jm = jreg.build_model("p3d_micro_sa", dropout_rate=0.0)
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=SHAPE).astype(np.float32) * 0.5,
                rng.uniform(size=SHAPE[:4]).astype(np.float32)) for _ in range(3)]
    tx = jax_make_optimizer(LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)

    def loss_and_grads(state, frames, targets):
        def loss_of(params):
            out, _ = jm.apply({"params": params, "batch_stats": state.batch_stats},
                              frames, train=True, mutable=["batch_stats"])
            return jax_loss_fn(out, targets)
        return jax.value_and_grad(loss_of)(state.params)

    # make_train_step's body and the gradient in one program: one compile
    train_step = jax_one_step(jm)
    fused = jax.jit(lambda st, f, t: (loss_and_grads(st, f, t),
                                      train_step(st, f, t, jax.random.PRNGKey(0))))
    states, losses = [], []
    for f, t in batches:
        (loss, grads), (state, step_loss) = fused(state, jnp.asarray(f), jnp.asarray(t))
        assert float(loss) == float(step_loss)
        if not states:
            loss1, grads1 = float(loss), grads
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(step_loss))
    return dict(tm=tm, variables=variables, batches=batches, loss1=loss1, losses=losses,
                grads1=jax.tree.map(np.asarray, grads1), states=states)


def _port_model(jax_run):
    tm = treg.build_model("p3d_micro_sa", device="cpu", dropout_rate=0.0)
    tm.load_state_dict(jax_run["tm"].state_dict())
    return tm


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _assert_stats_close(tm, jstate, steps: int):
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


def _snapshot(tm) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in tm.named_parameters()}


def _jax_params(tm, params) -> dict[str, torch.Tensor]:
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


def _optimizer_excess(tm, opt, before, jax_before, jstate) -> dict:
    """How far the port's optimizer step, from parameters ``before`` to the
    model's now, is from JAX's, from ``jax_before`` to ``jstate``: each
    measure over its limit (<= 1 agrees), the share of elements whose
    update is held, and the step counts of both."""
    want = optimizer_state_from_optax(jstate.opt_state, tm)
    jax_after = _jax_params(tm, jstate.params)
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
        u = (before[name] - after) / LR
        uj = (jax_before[name] - jax_after[name]) / LR
        mag = torch.stack([before[name], after, jax_before[name], jax_after[name]]).abs().amax(0)
        limit = UPDATE_TOL * uj.abs() + 4 * 2.0 ** -23 * mag / LR
        if held.any():
            update = max(update, ((u - uj).abs() / limit)[held].max().item())
        held_n += int(held.sum())
        total += held.numel()
    jax_step = {float(w["step"]) for w in want.values()}
    return dict(moments=moments, update=update, held=held_n / total, steps=steps,
                jax_steps=jax_step)


def _assert_optimizer_close(tm, opt, before, jax_before, jstate, same_start: bool):
    """``_optimizer_excess`` within its limits; ``same_start``: the step
    began from the same parameters and moments in both packages."""
    ex = _optimizer_excess(tm, opt, before, jax_before, jstate)
    assert ex["steps"] == ex["jax_steps"] and len(ex["steps"]) == 1, ex
    assert ex["update"] <= 1 and ex["held"] > 0, ex
    if same_start:
        assert ex["moments"] <= 1 and ex["held"] >= HELD_SHARE, ex


def _port_grads(jax_run):
    """The port's loss and parameter gradients on the first batch, from
    the fixture's start, and its state after that step."""
    tm = _port_model(jax_run)
    state = create_train_state(tm, lr=LR)
    before = _snapshot(tm)
    f, t = map(torch.from_numpy, jax_run["batches"][0])
    loss = make_train_step(state)(f, t)
    assert loss.dtype == torch.float32 and loss.dim() == 0 and state.step == 1
    return loss.item(), {n: p.grad for n, p in tm.named_parameters()}, state, before


def _grad_distance(got: dict, jax_grads) -> tuple[float, dict]:
    """The relative L2 distance of the whole gradient, and per tensor the
    ratio of ||g - w|| to its limit GRAD_TOL ||w|| + GRAD_FLOOR max|w_all|."""
    want = {p.replace("/", "."): torch.from_numpy(np.array(convert_leaf(p, w)))
            for p, w in _flat(jax_grads).items()}
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


def test_micro_train_step_matches_jax(jax_run):
    loss, grads, state, before = _port_grads(jax_run)
    _assert_stats_close(state.model, jax_run["states"][0], 1)
    _assert_optimizer_close(state.model, state.optimizer, before,
                            _jax_params(state.model, jax_run["variables"]["params"]),
                            jax_run["states"][0], same_start=True)
    np.testing.assert_allclose(loss, jax_run["loss1"], rtol=1e-5)
    np.testing.assert_allclose(loss, jax_run["losses"][0], rtol=1e-5)
    total, per = _grad_distance(grads, jax_run["grads1"])
    assert total <= GRAD_TOL, total
    assert max(per.values()) <= 1, sorted(per.items(), key=lambda kv: -kv[1])[:3]


def test_micro_train_step_limits_fail_a_backward_without_delta(jax_run, monkeypatch):
    """The control: a B3 that leaves out delta moves the gradient far past
    the limits (the whole gradient's distance is about 14)."""
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    def without_delta(q, k, v, o, lse, do):
        p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse[..., None])
        ds = p * torch.bmm(do, v.transpose(1, 2))
        return torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), do)

    monkeypatch.setattr(fb, "flash_backward_reference", without_delta)
    _, grads, _, _ = _port_grads(jax_run)
    total, per = _grad_distance(grads, jax_run["grads1"])
    assert total > 10 * GRAD_TOL


def _steps_from(jax_run, state, first: int, same_start: bool):
    """The port's steps ``first`` + 1 to 3 on the fixture's batches, each
    held to JAX's step from the same step count; ``same_start``: the first
    of them starts from JAX's parameters and moments."""
    tm, step = state.model, make_train_step(state)
    for i in range(first, 3):
        before = _snapshot(tm)
        step(*map(torch.from_numpy, jax_run["batches"][i]))
        _assert_optimizer_close(tm, state.optimizer, before,
                                _jax_params(tm, jax_run["states"][i - 1].params),
                                jax_run["states"][i], same_start and i == first)
    assert state.step == 3


def test_micro_train_steps_match_jax_after_three_steps(jax_run):
    _, _, state, _ = _port_grads(jax_run)
    _steps_from(jax_run, state, 1, same_start=False)
    _assert_stats_close(state.model, jax_run["states"][2], 3)


def test_multi_step_matches_single_steps_and_jax(jax_run, tmp_path):
    """``steps_per_call`` (the JAX trainer's K steps per dispatch) is
    accepted and the trainer runs single steps: three batches through
    ``Trainer.fit`` at K = 3 land where JAX's three single steps do, with a
    loss logged for each step."""
    cfg = Config(model=ModelConfig(name="p3d_micro_sa", dtype="float32", dropout=0.0),
                 train=TrainConfig(batch_size=SHAPE[0], lr=LR, steps_per_call=3, plot_iter=1,
                                   model_dir=str(tmp_path / "model"),
                                   logs_dir=str(tmp_path / "logs")))
    trainer = Trainer(cfg, run="k3", device="cpu")
    trainer.model.load_state_dict(jax_run["tm"].state_dict())
    trainer.fit(iter(jax_run["batches"]))
    trainer.close()
    assert trainer.state.step == 3
    with open(tmp_path / "logs" / "k3" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=2e-3)
    _assert_stats_close(trainer.model, jax_run["states"][2], 3)


def _continue_from_jax(jax_run, lr=LR, count=None):
    """JAX's state after step 1 (weights, BN statistics, Adam moments and
    count through optimizer_state_from_optax) in the port, with ``lr`` and,
    if given, the Adam step count replaced by ``count``."""
    s1 = jax_run["states"][0]
    tm = treg.build_model("p3d_micro_sa", device="cpu", dropout_rate=0.0)
    tm.load_state_dict(state_dict_from_flax(s1.params, s1.batch_stats, model=tm))
    state = create_train_state(tm, lr=lr)
    moments = optimizer_state_from_optax(s1.opt_state, tm)
    if count is not None:
        for entry in moments.values():
            entry["step"] = torch.tensor(float(count))
    state.load_optimizer_state(moments)
    state.step = int(s1.step)
    return state


def test_jax_train_state_continues_in_the_port(jax_run):
    """Two more steps in the port from JAX's state after step 1: each
    where JAX's steps 2 and 3 go."""
    state = _continue_from_jax(jax_run)
    _steps_from(jax_run, state, 1, same_start=True)
    opt_step = {float(s["step"]) for s in state.optimizer.state.values()}
    assert opt_step == {3.0}
    _assert_stats_close(state.model, jax_run["states"][2], 2)


@pytest.mark.parametrize("fault", ["lr_doubled", "step_count_reset"])
def test_optimizer_checks_fail_a_planted_fault(jax_run, fault):
    """The controls of ``_optimizer_excess``: from JAX's state after step 1,
    one port step with twice the lr, or with the Adam step count back at 0
    (bias correction of step 1 where JAX applies step 2's), moves the
    update past its limit."""
    state = (_continue_from_jax(jax_run, lr=2 * LR) if fault == "lr_doubled"
             else _continue_from_jax(jax_run, count=0))
    before = _snapshot(state.model)
    make_train_step(state)(*map(torch.from_numpy, jax_run["batches"][1]))
    ex = _optimizer_excess(state.model, state.optimizer, before,
                           _jax_params(state.model, jax_run["states"][0].params),
                           jax_run["states"][1])
    assert ex["held"] >= HELD_SHARE and ex["moments"] <= 1, ex
    assert ex["update"] > 10, ex
def test_micro_bf16_train_loss_within_jax_bf16_gap(jax_run):
    """bf16 rounds at every layer in both packages: the port's bf16 loss is
    no farther from the float32 loss than twice JAX's bf16 loss is (the two
    bf16 losses may land on either side of the float32 one; measured 0.88
    against JAX's 0.51, of a loss of 1521)."""
    jm16 = jreg.build_model("p3d_micro_sa", dtype="bfloat16", dropout_rate=0.0)
    f, t = jax_run["batches"][0]
    out, _ = jax.jit(lambda v, x: jm16.apply(v, x, train=True, mutable=["batch_stats"]))(
        jax_run["variables"], jnp.asarray(f))
    j16, j32 = float(jax_loss_fn(out, jnp.asarray(t))), jax_run["loss1"]
    tm16 = treg.build_model("p3d_micro_sa", dtype="bfloat16", device="cpu", dropout_rate=0.0)
    tm16.load_state_dict(jax_run["tm"].state_dict())
    got = make_train_step(create_train_state(tm16, lr=LR))(
        torch.from_numpy(f), torch.from_numpy(t)).item()
    assert abs(j16 - j32) > 1e-4 * abs(j32)  # bf16 really moved the loss
    assert abs(got - j32) <= 2 * abs(j16 - j32)

