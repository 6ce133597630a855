"""Data parallel in the port (``core/mesh.launch``, one process per device)
against the JAX package's one jitted step over a ``data`` mesh, on the CPU.

One spawn of a 2-rank gloo group (``_torch_dp_ranks.parity_rank``) gives
every reading the parity tests share; the JAX side runs on 2 of the 8
virtual CPU devices (``conftest.py``), as ``tests/test_sharding.py`` does.
``p3d_micro_sa`` (UNet++ SA decoder, BN) at 32 px, global batch 4 (2 per
rank), dropout 0, coupled L2 ``weight_decay`` 1e-3 (so that the gradient's
scale reaches Adam's update).  Limits:

* against JAX's ``make_train_step(model, mesh)``, two steps: the loss to
  rtol 1e-5 after step 1 and 2e-3 after step 2 (``LOSS_RTOL``); the
  parameters, Adam moments and BN running statistics after each step under
  the single-device train test's limits (``_torch_parity.py``:
  ``GRAD_TOL``, ``STAT_TOL``, the update held where the moments agree);
  the quirk eval output against ``make_eval_step(quirk
  model, mesh)`` within 1e-5 of its largest value, the port's eval tests'
  limit (``test_torch_tf_import.py``);
* against the port on one device, the summed gradient (read before the
  update) under ``SUMMED_GRAD_TOL32`` (``GRAD_TOL`` / 10) in float32 and
  ``SUMMED_GRAD_TOL`` in float64, where only summation order and the head's
  float32 output separate the two (the ranks sum x and x^2 for BN's
  statistics, one device takes the batch-norm call's).  Averaged gradients,
  and per-rank BN statistics on a batch whose halves differ (rank 1's
  frames scaled and shifted; float64), fail each limit tenfold;
* after two steps every parameter, buffer and Adam moment is the same on
  both ranks, bit for bit.

Also the loader's partition, the mesh and backend rules, a failing rank,
and ``cli train``/``cli eval --devices 2 --device cpu``.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp_ranks import LR, WEIGHT_DECAY, failing_rank, micro_model, parity_rank
from _torch_parity import (
    GRAD_TOL,
    assert_optimizer_close,
    assert_stats_close,
    build_micro_pair,
    jax_params,
)
from sap3d_tpu.core.mesh import make_mesh as jax_make_mesh
from sap3d_tpu.core.mesh import shard_batch
from sap3d_tpu.models import registry as jreg
from sap3d_tpu.train.state import TrainState as JaxTrainState
from sap3d_tpu.train.state import make_optimizer as jax_make_optimizer
from sap3d_tpu.train.steps import make_eval_step as jax_make_eval_step
from sap3d_tpu.train.steps import make_train_step as jax_make_train_step
from sap3d_tpu_torch import cli
from sap3d_tpu_torch.core import mesh as mesh_lib
from sap3d_tpu_torch.core.mesh import (
    DATA_AXIS,
    DataGroup,
    data_backend,
    launch,
    make_mesh,
)
from sap3d_tpu_torch.data.pipeline import ClipLoader
from sap3d_tpu_torch.ops.layers import set_data_group
from sap3d_tpu_torch.train.state import create_train_state

SHAPE = (4, 16, 32, 32, 3)  # global batch 4: 2 rows per rank
QUIRK_ATOL = 1e-5           # x max|want|, the micro quirk forward's limit
# The summed gradient against one device's, relative L2.  float32: the
# ranks sum their statistics as flax does (sum x, sum x^2) where one device
# takes the batch-norm call's, and convolve 2 rows where one device
# convolves 4; measured 2.7e-3 here, where one device's float32 gradient is
# 3.4e-3 from its float64 one; held to GRAD_TOL / 10.
SUMMED_GRAD_TOL32 = GRAD_TOL / 10
# float64, relative L2: measured 1.3e-14 here (per-rank statistics 1.13).
# The model's head returns float32 (as it does in every dtype), so where the
# two runs' float64 sums differ in order (batch 2 against batch 4) an
# output's float32 rounding can flip; on an H100 that read 1.6e-8
# (tests/test_torch_cuda.py).  Held to 1e-6, far under GRAD_TOL / 10.
SUMMED_GRAD_TOL = 1e-6
# Step 1 starts from the same state in both packages.  Step 2 does not:
# Adam's first step moves each parameter by lr, and the micro model's
# near-zero gradients differ in sign between the packages (STAT_TOL's note
# in _torch_parity.py), so its loss is held as test_torch_train.py holds
# the later losses (measured 6.5e-5).
LOSS_RTOL = (1e-5, 2e-3)


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm = build_micro_pair("p3d_micro_sa", SHAPE, seed=3, dropout_rate=0.0)
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=SHAPE).astype(np.float32) * 0.5,
                rng.uniform(size=SHAPE[:4]).astype(np.float32)) for _ in range(2)]
    skewed = batches[0][0].copy()
    skewed[2:] = 3.0 * skewed[2:] + 1.0  # rank 1's rows
    return dict(jm=jm, variables=variables, weights=tm.state_dict(), batches=batches,
                skewed=skewed)


@pytest.fixture(scope="module")
def spawned(pair):
    """The 2-rank group's run (``parity_rank``), started on a thread so that
    JAX compiles meanwhile (``jax_dp``)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch, make_mesh(2, device="cpu"), parity_rank, pair["weights"],
                          pair["batches"], pair["skewed"])


@pytest.fixture(scope="module")
def ranks(spawned):
    """Both ranks' readings, from one spawn."""
    return spawned.result()


@pytest.fixture(scope="module")
def jax_dp(pair, spawned):
    """JAX's two train steps and the quirk eval over a 2-device data mesh."""
    mesh = jax_make_mesh(2)
    v = pair["variables"]
    tx = jax_make_optimizer(LR, WEIGHT_DECAY)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    quirk = jreg.build_model("p3d_micro_sa", dropout_rate=0.0, bn_reference_quirk=True)
    want_quirk = np.asarray(jax_make_eval_step(quirk, mesh=mesh)(
        state, shard_batch(mesh, jnp.asarray(pair["batches"][0][0]))))
    step = jax_make_train_step(pair["jm"], mesh=mesh, donate=False)
    states, losses = [], []
    for f, t in pair["batches"]:
        state, loss = step(state, *shard_batch(mesh, (jnp.asarray(f), jnp.asarray(t))),
                           jax.random.PRNGKey(0))
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(loss))
    return dict(states=states, losses=losses, quirk=want_quirk)


def _port_state(pair, reading):
    """A port model and optimizer holding rank 0's state after a step."""
    tm = micro_model(pair["weights"])
    tm.load_state_dict(reading["state"])
    state = create_train_state(tm, lr=LR, weight_decay=WEIGHT_DECAY)
    state.load_optimizer_state(reading["moments"])
    return tm, state.optimizer


def test_dp_steps_match_jax_make_train_step_on_a_data_mesh(pair, jax_dp, ranks):
    tm0 = micro_model(pair["weights"])
    before = {n: p.detach().clone() for n, p in tm0.named_parameters()}
    jax_before = jax_params(tm0, pair["variables"]["params"])
    for i, (reading, jstate) in enumerate(zip(ranks[0]["steps"], jax_dp["states"])):
        np.testing.assert_allclose(reading["loss"], jax_dp["losses"][i], rtol=LOSS_RTOL[i])
        tm, opt = _port_state(pair, reading)
        assert_optimizer_close(tm, opt, before, jax_before, jstate, same_start=i == 0, lr=LR)
        assert_stats_close(tm, jstate, i + 1)
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        jax_before = jax_params(tm, jstate.params)


def test_dp_quirk_eval_matches_jax_make_eval_step_on_a_data_mesh(jax_dp, ranks):
    got, want = ranks[0]["quirk"], jax_dp["quirk"]
    assert got.shape == want.shape == SHAPE[:4]
    np.testing.assert_allclose(got, want, atol=QUIRK_ATOL * np.abs(want).max())


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(((got[n] - w) ** 2).sum() for n, w in want.items()).sqrt()
    return (num / sum((w ** 2).sum() for w in want.values()).sqrt()).item()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_summed_gradient_matches_one_device_and_the_controls_fail(ranks, dtype):
    """The summed gradient against one device's at the global batch, under
    ``SUMMED_GRAD_TOL32`` or ``SUMMED_GRAD_TOL``; averaged gradients, and
    per-rank statistics on halves that differ (read in float64, where
    rounding cannot hide them), fail it tenfold."""
    suffix, tol = ("32", SUMMED_GRAD_TOL32) if dtype == "float32" else ("", SUMMED_GRAD_TOL)
    got, want = ranks[0][f"summed{suffix}"], ranks[0][f"one_device{suffix}"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5 if suffix else 1e-12)
    assert _rel_l2(got["grads"], want["grads"]) <= tol
    averaged = {n: g / 2 for n, g in got["grads"].items()}
    assert _rel_l2(averaged, want["grads"]) > 10 * tol
    per_rank = _rel_l2(ranks[0]["per_rank_bn"]["grads"], ranks[0]["one_device"]["grads"])
    assert per_rank > 10 * tol
    for n, g in got["grads"].items():  # the summed gradient is the same on both ranks
        assert torch.equal(ranks[1][f"summed{suffix}"]["grads"][n], g), n


def test_ranks_stay_bit_identical(ranks):
    a, b = ranks[0]["steps"][-1], ranks[1]["steps"][-1]
    assert a["loss"] == b["loss"]
    assert set(a["state"]) == set(b["state"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    for name, entry in a["moments"].items():
        for k, v in entry.items():
            assert torch.equal(v, b["moments"][name][k]), (name, k)


def test_one_rank_or_no_group_keeps_the_one_device_batch_norm():
    """A data group of one rank leaves BN on its one-device path, bit for
    bit, in train mode and in the quirk's eval mode."""
    x = torch.from_numpy((np.random.default_rng(5).normal(size=(2, 16, 32, 32, 3)) * 0.5)
                         .astype(np.float32))
    torch.manual_seed(0)
    from sap3d_tpu_torch.models.registry import build_model

    outs = []
    for group in (None, DataGroup(0, 1, torch.device("cpu"), "gloo")):
        m = build_model("p3d_micro_sa", device="cpu", dropout_rate=0.0, seed=1,
                        bn_reference_quirk=True)
        set_data_group(m, group)
        train_out = m.train()(x)
        with torch.inference_mode():
            eval_out = m.eval()(x)
        outs.append((train_out.detach(), eval_out, m.state_dict()))
    (t0, e0, s0), (t1, e1, s1) = outs
    assert torch.equal(t0, t1) and torch.equal(e0, e1)
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())


# ---- the loader's partition -------------------------------------------------

def _batches(loader) -> list:
    with loader:
        return [tuple(b[0][:, 0].tolist()) for b in loader]


@pytest.mark.parametrize("count", [2, 3])
def test_ranks_k_th_batches_make_the_one_process_k_th_batch(count):
    clips, batch = list(range(41)), 6
    kw = dict(shuffle=True, epochs=2, seed=7, num_threads=2,
              decode_fn=lambda c: (np.array([c], np.int64),))
    whole = _batches(ClipLoader(clips, batch, **kw))
    parts = [_batches(ClipLoader(clips, batch // count, process_index=r,
                                 process_count=count, **kw)) for r in range(count)]
    assert len(whole) == 2 * (41 // 6)
    assert all(len(p) == len(whole) == len(ClipLoader(clips, batch // count,
                                                      process_count=count, **kw))
               for p in parts)
    for k, want in enumerate(whole):
        got = [c for p in parts for c in p[k]]
        assert sorted(got) == sorted(want) and len(set(got)) == batch
    # rank r takes order[k B + r + N j]
    assert [list(p[0]) for p in parts] == [list(whole[0][r::count]) for r in range(count)]
    # one process: the loader as it always was
    assert _batches(ClipLoader(clips, batch, process_index=0, process_count=1, **kw)) == whole
    with pytest.raises(ValueError, match="process_index"):
        ClipLoader(clips, batch, process_index=count, process_count=count)


# ---- the mesh, the backend and the launcher ---------------------------------

def test_data_mesh_and_backend_rules():
    assert make_mesh(device="cpu").devices == (torch.device("cpu"),)
    mesh = make_mesh(3, device="cpu")
    assert mesh.shape == {DATA_AXIS: 3} and data_backend(mesh) == "gloo"
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(2, device="cuda")  # more cards than are visible (none here)
    assert data_backend(make_mesh(devices=["cuda:0", "cuda:1"])) == "nccl"
    assert data_backend(make_mesh(devices=["cuda:0", "cuda:0"])) == "gloo"
    assert make_mesh(1, devices=["cuda", "cuda:1"]).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(3, devices=["cuda:0", "cuda:1"])


def test_a_failing_rank_makes_the_launcher_raise():
    with pytest.raises(RuntimeError, match="a rank of the data mesh failed"):
        launch(make_mesh(2, device="cpu"), failing_rank)


# ---- the command line --------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("dp_synthetic")
    return make_synthetic_dataset(str(root), num_videos=2, frames_per_video=40,
                                  size=(32, 24), with_fixations=True)


@pytest.fixture
def two_threads_per_rank():
    """The launcher gives each CPU rank its share of the caller's threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def test_cli_train_and_eval_on_a_data_mesh(dataset, tmp_path, monkeypatch, capfd,
                                          two_threads_per_rank):
    pytest.importorskip("cv2")
    monkeypatch.chdir(tmp_path)
    data = ["--frames", dataset["frame_dirs"], "--densities", dataset["density_dirs"],
            "--imagesize", "32", "--threads", "2", "--device", "cpu"]
    train = ["train", "--structure", "p3d_micro_sa", "--dtype", "float32", *data,
             "--epoch", "1", "--plotiter", "1", "--saveiter", "2", "--validiter", "2",
             "--max-steps", "2", "--info", "dp", "--devices", "2"]
    assert cli.main([*train, "--batch", "3"]) == 2
    assert "must divide by the data-parallel mesh size 2" in capfd.readouterr().err
    assert cli.main([*train, "--batch", "2"]) == 0
    (run,) = os.listdir(tmp_path / "model")
    assert sorted(os.listdir(tmp_path / "model" / run)) == ["ckpt_2.pt"]
    (log,) = os.listdir(tmp_path / "logs")
    with open(tmp_path / "logs" / log / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "loss" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    (valid,) = [r for r in records if "cc" in r]
    assert all(np.isfinite(valid[k]) for k in ("cc", "sim", "kld", "auc_judd"))
    assert capfd.readouterr().out.count("Training Finished!") == 1

    score = ["eval", "--checkpoint", run, "--bn-quirk", "--fixations", dataset["fixation_dir"],
             "--overlap", "10", *data]
    results = []

    def spy(fn):
        def record(*args):
            out = fn(*args)
            results.append(out)
            return out
        return record

    with monkeypatch.context() as m:
        m.setattr(cli, "_evaluate_runs", spy(cli._evaluate_runs))
        assert cli.main([*score, "--devices", "1", "--batch", "2"]) == 0
    one = capfd.readouterr()
    with monkeypatch.context() as m:
        m.setattr(mesh_lib, "launch", spy(mesh_lib.launch))
        assert cli.main([*score, "--devices", "2", "--batch", "2"]) == 0
    two = capfd.readouterr()
    (want, failures), (got, failures_dp) = results[0], results[1][0]
    assert failures == failures_dp == 0 and got[run]["n"] == want[run]["n"] > 0
    for key in ("cc", "sim", "nss", "auc_judd", "auc_borji"):
        assert got[run][key] == pytest.approx(want[run][key], abs=1e-5), key
    assert one.out.count("Model: ") == two.out.count("Model: ") == 1
    assert "falling back" not in two.err  # the fallback: tests/test_torch_eval.py
