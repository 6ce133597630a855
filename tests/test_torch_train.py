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
  ``GRAD_TOL`` (see ``_torch_parity.py``: the micro model's train-mode BN makes it
  ill-conditioned), which a backward without delta fails; after each step
  the Adam moments (held as the gradient is), the step count and the
  update of each parameter (``optimizer_excess``, held tightly where the
  moments agree; a wrong lr or step count fails it), and the BN statistics
  under ``STAT_TOL``; the later losses to 2e-3;
* two steps in one call of ``make_multi_train_step`` (the loop path on the
  CPU): the same limits against JAX's steps, and bit for bit the port's two
  single steps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_parity import (
    GRAD_TOL,
    HELD_SHARE,
    assert_optimizer_close,
    assert_stats_close,
    build_pair,
    differing,
    grad_distance,
    jax_params,
    optimizer_excess,
    snapshot,
    state_tensors,
)
from chip_smoke import planted_multi_step_fault
from sap3d_tpu.models import registry as jreg
from sap3d_tpu.ops.fast_tconv import space_to_depth3d
from sap3d_tpu.ops.layers import smooth_l1_loss as jax_smooth_l1
from sap3d_tpu.train.state import TrainState as JaxTrainState
from sap3d_tpu.train.state import make_optimizer as jax_make_optimizer
from sap3d_tpu.train.steps import loss_fn_saliency as jax_loss_fn
from sap3d_tpu.train.steps import _one_step as jax_one_step
from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from sap3d_tpu_torch.interop.flax_bridge import (
    optimizer_state_from_optax,
    state_dict_from_flax,
)
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.ops.layers import BatchNorm, smooth_l1_loss
from sap3d_tpu_torch.train.state import create_train_state, make_optimizer
from sap3d_tpu_torch.train.steps import (
    loss_fn_saliency,
    make_multi_train_step,
    make_train_step,
)
from sap3d_tpu_torch.train.trainer import Trainer

SHAPE = (2, 16, 32, 32, 3)  # p3d_micro_sa at 32 px: x_2_2 (Nq 256) and x_1_3 (2048)
LR = 1e-4  # the trainer's default


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch on two threads: the Tier-1 command's six workers share the
    host's cores, and a worker on every core ran this file's steps 15-20
    times slower than one process alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def _port_grads(jax_run):
    """The port's loss and parameter gradients on the first batch, from
    the fixture's start, and its state after that step."""
    tm = _port_model(jax_run)
    state = create_train_state(tm, lr=LR)
    before = snapshot(tm)
    f, t = map(torch.from_numpy, jax_run["batches"][0])
    loss = make_train_step(state)(f, t)
    assert loss.dtype == torch.float32 and loss.dim() == 0 and state.step == 1
    return loss.item(), {n: p.grad for n, p in tm.named_parameters()}, state, before


def test_micro_train_step_matches_jax(jax_run):
    loss, grads, state, before = _port_grads(jax_run)
    assert_stats_close(state.model, jax_run["states"][0], 1)
    assert_optimizer_close(state.model, state.optimizer, before,
                            jax_params(state.model, jax_run["variables"]["params"]),
                            jax_run["states"][0], same_start=True)
    np.testing.assert_allclose(loss, jax_run["loss1"], rtol=1e-5)
    np.testing.assert_allclose(loss, jax_run["losses"][0], rtol=1e-5)
    total, per = grad_distance(grads, jax_run["grads1"])
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
    total, per = grad_distance(grads, jax_run["grads1"])
    assert total > 10 * GRAD_TOL


def _steps_from(jax_run, state, first: int, same_start: bool):
    """The port's steps ``first`` + 1 to 3 on the fixture's batches, each
    held to JAX's step from the same step count; ``same_start``: the first
    of them starts from JAX's parameters and moments."""
    tm, step = state.model, make_train_step(state)
    for i in range(first, 3):
        before = snapshot(tm)
        step(*map(torch.from_numpy, jax_run["batches"][i]))
        assert_optimizer_close(tm, state.optimizer, before,
                                jax_params(tm, jax_run["states"][i - 1].params),
                                jax_run["states"][i], same_start and i == first)
    assert state.step == 3


def test_micro_train_steps_match_jax_after_three_steps(jax_run):
    _, _, state, _ = _port_grads(jax_run)
    _steps_from(jax_run, state, 1, same_start=False)
    assert_stats_close(state.model, jax_run["states"][2], 3)


def test_multi_step_matches_single_steps_and_jax(jax_run, tmp_path):
    """``steps_per_call`` (the JAX trainer's K steps per dispatch): three
    batches through ``Trainer.fit`` at K = 3 are one call of the
    multi-step, which lands where JAX's three single steps do; by the JAX
    trainer's rule one record is logged, at step 3, with the call's last
    loss, JAX's third."""
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
    logged = [(r["step"], r["loss"]) for r in records if "loss" in r]
    assert [step for step, _ in logged] == [3]
    np.testing.assert_allclose(logged[0][1], jax_run["losses"][2], rtol=2e-3)
    assert_stats_close(trainer.model, jax_run["states"][2], 3)


# K = 2 steps per call (make_multi_train_step) on the fixture's first two
# batches.  JAX's make_multi_train_step is its single steps in a scan (the
# JAX package's test_multi_step_matches_single_steps), so the fixture's
# states after one and two single steps are where JAX's multi-step passes
# and lands.
MULTI_K = 2
MULTI_LOSS_RTOL = (1e-5, 2e-3)  # step 1 from one state; step 2 after Adam parts the two


@pytest.fixture(scope="module")
def port_single_steps(jax_run):
    """The port's first ``MULTI_K`` single steps from the fixture's start:
    the losses, the parameters before the last step and every tensor after
    it."""
    state = create_train_state(_port_model(jax_run), lr=LR)
    step, losses = make_train_step(state), []
    for f, t in jax_run["batches"][:MULTI_K]:
        before_last = snapshot(state.model)
        losses.append(step(torch.from_numpy(f), torch.from_numpy(t)))
    return dict(losses=torch.stack(losses), before_last=before_last,
                tensors=state_tensors(state))


def _multi_step_call(jax_run):
    """A port state from the fixture's start and the stacked batches of
    one call of ``MULTI_K`` steps."""
    batches = jax_run["batches"][:MULTI_K]
    frames, targets = (torch.from_numpy(np.stack(b)) for b in zip(*batches))
    return create_train_state(_port_model(jax_run), lr=LR), frames, targets


def test_multi_step_call_matches_jax_and_its_single_steps(jax_run, port_single_steps):
    """One call of the multi-step (the loop path on the CPU): the losses
    against JAX's, bit for bit the port's single steps (losses, parameters,
    BN statistics, Adam moments and step counts), the second step's update
    held from both packages' states after one step, and the BN statistics
    after two."""
    state, frames, targets = _multi_step_call(jax_run)
    losses = make_multi_train_step(state, MULTI_K)(frames, targets)
    assert losses.dtype == torch.float32 and losses.shape == (MULTI_K,)
    assert state.step == MULTI_K
    for i, rtol in enumerate(MULTI_LOSS_RTOL):
        np.testing.assert_allclose(losses[i].item(), jax_run["losses"][i], rtol=rtol)
    assert torch.equal(losses, port_single_steps["losses"])
    assert not differing(state_tensors(state), port_single_steps["tensors"])
    assert_optimizer_close(state.model, state.optimizer, port_single_steps["before_last"],
                           jax_params(state.model, jax_run["states"][0].params),
                           jax_run["states"][1], same_start=False)
    assert_stats_close(state.model, jax_run["states"][1], MULTI_K)


def test_multi_step_holds_fail_a_call_that_reuses_its_first_batch(jax_run, port_single_steps):
    """The planted fault (``chip_smoke.planted_multi_step_fault
    ("step0_batch")``): every step of the call on its first batch.  Its
    second step is then not the single step's, and its loss is not JAX's."""
    state, frames, targets = _multi_step_call(jax_run)
    with planted_multi_step_fault("step0_batch"):
        losses = make_multi_train_step(state, MULTI_K)(frames, targets)
    singles = port_single_steps
    assert torch.equal(losses[0], singles["losses"][0])  # the first step is unchanged
    assert not torch.equal(losses, singles["losses"])
    assert differing(state_tensors(state), singles["tensors"])
    rel = abs(losses[1].item() - jax_run["losses"][1]) / abs(jax_run["losses"][1])
    assert rel > MULTI_LOSS_RTOL[1], rel


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
    assert_stats_close(state.model, jax_run["states"][2], 2)


@pytest.mark.parametrize("fault", ["lr_doubled", "step_count_reset"])
def test_optimizer_checks_fail_a_planted_fault(jax_run, fault):
    """The controls of ``optimizer_excess``: from JAX's state after step 1,
    one port step with twice the lr, or with the Adam step count back at 0
    (bias correction of step 1 where JAX applies step 2's), moves the
    update past its limit."""
    state = (_continue_from_jax(jax_run, lr=2 * LR) if fault == "lr_doubled"
             else _continue_from_jax(jax_run, count=0))
    before = snapshot(state.model)
    make_train_step(state)(*map(torch.from_numpy, jax_run["batches"][1]))
    ex = optimizer_excess(state.model, state.optimizer, before,
                           jax_params(state.model, jax_run["states"][0].params),
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

