"""K train steps per call (``train/steps.make_multi_train_step``; the JAX
package's ``make_multi_train_step`` and its trainer's K-step loop) on the
CPU, where the multi-step is its loop path.

* The port's multi-step at K = 2 against JAX's ``make_multi_train_step(
  model, 2, donate=False)`` (dropout 0) on the GN micro model
  (``inference_p3d_concat``, JAX's ``test_multi_step_gn_family``, at 16
  px): the two losses (the first to 1e-5 relative, the second to 2e-3:
  Adam's first step parts the trajectories, ``tests/test_torch_train.py``)
  and the Adam step counts; the same call bit for bit the port's two single
  steps.  The BN micro model's call, held to JAX's states and failing its
  planted fault, is in ``tests/test_torch_train.py`` (its fixture's JAX
  steps).
* ``Trainer._macro_batches`` against the JAX trainer's own, called on a
  stub that holds ``steps_per_call``.
* ``Trainer.fit`` at K = 3: the steps it logs, validates and saves follow
  the JAX trainer's rule; long-clip mode at K = 2 against single steps.

Torch runs on two threads here (the Tier-1 command's workers share the
host's cores).
"""

import copy
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import build_micro_pair, differing, state_tensors
from sap3d_tpu.train.state import TrainState as JaxTrainState
from sap3d_tpu.train.state import make_optimizer as jax_make_optimizer
from sap3d_tpu.train.steps import make_multi_train_step as jax_make_multi_train_step
from sap3d_tpu.train.trainer import Trainer as JaxTrainer
from sap3d_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
from sap3d_tpu_torch.models.registry import build_model
from sap3d_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_steps
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import make_multi_train_step, make_train_step
from sap3d_tpu_torch.train.trainer import Trainer

# GN has no batch statistics: one clip at 16 px
SHAPES = {"inference_p3d_concat": (1, 16, 16, 16, 3)}
K = 2
LR = 1e-4
LOSS_RTOL = (1e-5, 2e-3)  # step 1 from one state; step 2 after Adam parts the two


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=list(SHAPES))
def jax_multi(request):
    """JAX: K = 2 steps of ``make_multi_train_step`` from numpy weights."""
    name, shape = request.param, SHAPES[request.param]
    jm, variables, tm = build_micro_pair(name, shape, seed=7, dropout_rate=0.0)
    rng = np.random.default_rng(8)
    frames = (rng.normal(size=(K, *shape)) * 0.5).astype(np.float32)
    targets = rng.uniform(size=(K, *shape[:4])).astype(np.float32)
    tx = jax_make_optimizer(LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables.get("batch_stats", {}),
                          opt_state=tx.init(variables["params"]), tx=tx)
    multi = jax_make_multi_train_step(jm, K, donate=False)
    state, losses = jax.jit(multi)(state, jnp.asarray(frames), jnp.asarray(targets),
                                   jax.random.PRNGKey(0))
    assert int(state.step) == K
    return dict(tm=tm, frames=torch.from_numpy(frames), targets=torch.from_numpy(targets),
                losses=np.asarray(losses))


def _port_state(jax_multi):
    """A train state of the port from the fixture's weights (dropout 0)."""
    model = copy.deepcopy(jax_multi["tm"])
    model.decoder.dropout_rate = 0.0
    return create_train_state(model, lr=LR)


def test_multi_step_matches_jax_and_its_single_steps(jax_multi):
    """The losses against JAX's multi-step and the Adam step counts; the
    call bit for bit the port's K single steps (the loop path runs them:
    losses, parameters, Adam moments and step counts)."""
    f, t = jax_multi["frames"], jax_multi["targets"]
    multi = _port_state(jax_multi)
    losses = make_multi_train_step(multi, K)(f, t)
    assert losses.dtype == torch.float32 and losses.shape == (K,) and multi.step == K
    for i, rtol in enumerate(LOSS_RTOL):
        np.testing.assert_allclose(losses[i].item(), jax_multi["losses"][i], rtol=rtol)
    assert {float(s["step"]) for s in multi.optimizer.state.values()} == {float(K)}
    assert not list(multi.model.buffers())
    singles = _port_state(jax_multi)
    step = make_train_step(singles)
    assert torch.equal(losses, torch.stack([step(f[i], t[i]) for i in range(K)]))
    assert not differing(state_tensors(multi), state_tensors(singles))


# -- the trainer ---------------------------------------------------------------


@pytest.mark.parametrize("k,want", [(1, [1] * 7), (3, [3, 3, 1])])
def test_grouping_matches_the_jax_trainer(k, want):
    """7 batches: at K = 3 two calls and one left over."""
    batches = [(np.full((2, 4), i, np.float32), np.full((2, 3), -i, np.float32))
               for i in range(7)]
    stub = types.SimpleNamespace(steps_per_call=k)
    jax_groups = list(JaxTrainer._macro_batches(stub, iter(batches)))
    port_groups = list(Trainer._macro_batches(stub, iter(batches)))
    assert [g[0] for g in port_groups] == [g[0] for g in jax_groups] == want
    for (_, pf, pt), (_, jf, jt) in zip(port_groups, jax_groups):
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pt, jt)


def _micro_batches(n: int, t: int = 16, size: int = 16, seed: int = 9):
    rng = np.random.default_rng(seed)
    return [((rng.normal(size=(1, t, size, size, 3)) * 0.3).astype(np.float32),
             rng.uniform(size=(1, t, size, size)).astype(np.float32)) for _ in range(n)]


def _records(trainer) -> list[dict]:
    with open(f"{trainer.logs_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_trainer_logs_validates_and_saves_by_the_jax_rule(tmp_path):
    """8 batches at K = 3, max_steps 7: calls end at steps 3 and 6, then the
    two batches left over run as single steps, 7 and (no more: max_steps)
    none.  The JAX rule (``sap3d_tpu/train/trainer.py``: log when ``step <
    10 + k or step % plot_iter < k``, validate when ``step >= valid_iter
    and step % valid_iter < k``, save when ``step >= save_iter and step %
    save_iter < k``, stop when ``step >= max_steps``) with valid_iter 4 and
    save_iter 5 logs at 3, 6, 7, validates at 6 and saves at 6 and, at the
    end, 7; single steps would have validated at 4 and saved at 5."""
    cfg = Config(model=ModelConfig(name="p3d_micro_sa", dtype="float32", dropout=0.0),
                 data=DataConfig(image_size=16),
                 train=TrainConfig(batch_size=1, lr=LR, steps_per_call=3, plot_iter=4,
                                   valid_iter=4, save_iter=5, max_steps=7,
                                   model_dir=str(tmp_path / "model"),
                                   logs_dir=str(tmp_path / "logs")))
    trainer = Trainer(cfg, run="k3", device="cpu")
    valid = _micro_batches(1, seed=10)
    try:
        trainer.fit(iter(_micro_batches(8)), lambda: iter(valid))
    finally:
        trainer.close()
    assert trainer.state.step == 7
    records = _records(trainer)
    assert [r["step"] for r in records if "loss" in r] == [3, 6, 7]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert [r["step"] for r in records if "cc" in r] == [6]
    assert [r["step"] for r in records if "save_dispatch_s" in r] == [6]
    assert checkpoint_steps(trainer.model_dir) == [6, 7]


def test_trainer_time_mode_multi_step_matches_single_steps(tmp_path):
    """Long-clip mode at K = 2 (two time shards of 32 frames, the loop path
    cutting each batch from the host) against the same batches through
    single steps without a time mesh: the call's last loss is the second
    step's (the JAX package's ``test_trainer_time_mode_multi_step``, to
    its 5e-4)."""
    batches = _micro_batches(2, t=32)

    def run(tag: str, time_shards: int, steps_per_call: int) -> list[float]:
        cfg = Config(model=ModelConfig(name="p3d_micro_sa", dtype="float32", dropout=0.0),
                     data=DataConfig(video_length=32, image_size=16),
                     train=TrainConfig(batch_size=1, max_steps=2, time_shards=time_shards,
                                       steps_per_call=steps_per_call, plot_iter=10 ** 6,
                                       valid_iter=10 ** 9, save_iter=10 ** 9,
                                       model_dir=str(tmp_path / tag / "model"),
                                       logs_dir=str(tmp_path / tag / "logs")))
        trainer = Trainer(cfg, run=tag, device="cpu")
        try:
            trainer.fit(iter(batches))
        finally:
            trainer.close()
        return [r["loss"] for r in _records(trainer) if "loss" in r]

    base = run("base", 0, 1)
    sharded = run("sharded", 2, 2)
    assert len(base) == 2 and len(sharded) == 1
    np.testing.assert_allclose(sharded[-1], base[-1], rtol=5e-4)


def test_restore_keeps_the_optimizers_device_flags(tmp_path):
    """A checkpoint written where fused Adam was on and capturable (the
    card) restores into an optimizer whose flags follow its own device, so
    that a resumed run on the card can capture its step whatever wrote the
    checkpoint."""
    model = build_model("p3d_micro", device="cpu", seed=1, dropout_rate=0.0)
    state = create_train_state(model, lr=1e-3)
    rng = np.random.default_rng(0)
    make_train_step(state)(torch.tensor(rng.normal(size=(1, 16, 16, 16, 3)), dtype=torch.float32),
                           torch.tensor(rng.uniform(size=(1, 16, 16, 16)), dtype=torch.float32))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    mgr.close()
    path = tmp_path / "ckpt_1.pt"
    payload = torch.load(path, weights_only=True)
    for group in payload["optimizer"]["param_groups"]:
        group.update(fused=True, capturable=True)
    torch.save(payload, path)
    fresh = create_train_state(build_model("p3d_micro", device="cpu", seed=2), lr=1e-3)
    restored = CheckpointManager(str(tmp_path)).restore(fresh)
    assert all(not g["fused"] and not g["capturable"] for g in restored.optimizer.param_groups)
    assert restored.step == 1
    for name, t in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[name], t), name
