"""The port's trainer, CLI, data pipeline and metrics on the CPU, against the
JAX package where it has a counterpart.

* ``ClipIndex``/``ClipLoader``: the same synthetic dataset indexed and
  decoded by both packages gives the same clips and identical batches
  (shuffle off; the decode is the same cv2 calls).
* ``eval/metrics.py`` against ``sap3d_tpu/eval/metrics_jax.py`` on the same
  maps, AUC-Judd without jitter: float32 reductions in another order, rtol
  1e-5 (1e-4 for KLD, whose log terms of near-zero densities amplify it).
* ``cli train --device cpu`` on the micro model at 32 px: logs, checkpoints
  (keep-last-K), a validation pass, a resume from the run directory, and
  ``cli predict --checkpoint <run>`` on the trained run.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.data.indexer import ClipIndex as JaxClipIndex
from sap3d_tpu.data.pipeline import ClipLoader as JaxClipLoader
from sap3d_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from sap3d_tpu.eval import metrics_jax
from sap3d_tpu_torch import cli
from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from sap3d_tpu_torch.data.indexer import ClipIndex
from sap3d_tpu_torch.data.pipeline import ClipLoader
from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
from sap3d_tpu_torch.eval import metrics
from sap3d_tpu_torch.models.registry import build_model
from sap3d_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_steps
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import make_train_step
from sap3d_tpu_torch.train.trainer import Trainer

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return make_synthetic_dataset(str(root), num_videos=2, frames_per_video=40)


def test_synthetic_dataset_is_the_jax_one(dataset, tmp_path):
    other = jax_make_synthetic(str(tmp_path), num_videos=2, frames_per_video=40)
    for key in ("frame_dirs", "density_dirs"):
        for video in ("video000", "video001"):
            for name in ("frame_1.jpg", "frame_40.jpg"):
                a = cv2.imread(os.path.join(dataset[key], video, name))
                b = cv2.imread(os.path.join(other[key], video, name))
                assert np.array_equal(a, b)


def test_clip_index_and_loader_match_jax(dataset):
    args = ([dataset["frame_dirs"]], [dataset["density_dirs"]])
    mine = ClipIndex(*args).setup(overlap=15, training_props=0.9, seed=0)
    theirs = JaxClipIndex(*args).setup(overlap=15, training_props=0.9, seed=0)
    assert mine.summary() == theirs.summary()
    assert mine.train_tuples == theirs.train_tuples and mine.valid_tuples == theirs.valid_tuples
    assert [c.frames for c in mine.valid_clips()] == [c.frames for c in theirs.valid_clips()]
    kw = dict(size=32, num_threads=2, shuffle=False)
    with ClipLoader(mine.train_clips()[:6], 2, **kw) as a, \
            JaxClipLoader(theirs.train_clips()[:6], 2, **kw) as b:
        got, want = list(a), list(b)
    assert len(got) == len(want) == 3
    for (f, t), (wf, wt) in zip(got, want):
        assert f.shape == (2, 16, 32, 32, 3) and t.shape == (2, 16, 32, 32)
        assert np.array_equal(f, wf) and np.array_equal(t, wt)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(5, 24, 20)).astype(np.float32)
    gt = (rng.uniform(size=(5, 24, 20)) ** 4).astype(np.float32)
    fix = (rng.uniform(size=(5, 24, 20)) > 0.9).astype(np.float32)
    fix[1] = 0.0  # no fixations: NaN in both
    pj, gj, fj = map(jnp.asarray, (pred, gt, fix))
    pt, gt_t, ft = map(torch.from_numpy, (pred, gt, fix))
    np.testing.assert_allclose(metrics.cc(pt, gt_t).numpy(), metrics_jax.cc(pj, gj), rtol=1e-5)
    np.testing.assert_allclose(metrics.sim(pt, gt_t).numpy(), metrics_jax.sim(pj, gj),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics.kldiv(pt, gt_t).numpy(), metrics_jax.kldiv(pj, gj),
                               rtol=1e-4)
    for cap in (4096, 64):  # the full sweep, and a cap some maps exceed
        got = metrics.auc_judd(pt, ft, fix_cap=cap).numpy()
        want = np.asarray(metrics_jax.auc_judd(pj, fj, fix_cap=cap))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert np.isnan(got[1])
    # jitter changes the scores only by breaking ties
    jittered = metrics.auc_judd(pt, ft, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(jittered, metrics.auc_judd(pt, ft).numpy(), atol=1e-3)
    values = [0.5, float("nan"), 1.5]
    assert metrics.nan_filtered_mean(values) == float(metrics_jax.nan_filtered_mean(
        jnp.asarray(values))) == 1.0
    assert np.isnan(metrics.nan_filtered_mean([float("nan")]))


def test_checkpoint_keeps_the_last_k_and_resumes_exactly(tmp_path):
    def fresh():
        m = build_model("p3d_micro", device="cpu", seed=1, dropout_rate=0.0)
        return create_train_state(m, lr=1e-3)

    rng = np.random.default_rng(0)
    batch = (torch.tensor(rng.normal(size=(2, 16, 32, 32, 3)), dtype=torch.float32),
             torch.tensor(rng.uniform(size=(2, 16, 32, 32)), dtype=torch.float32))
    state = fresh()
    step = make_train_step(state)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for _ in range(4):
        step(*batch)
        mgr.save(state)
    mgr.close()
    assert checkpoint_steps(str(tmp_path)) == [3, 4]
    restored = CheckpointManager(str(tmp_path)).restore(fresh())
    assert restored.step == 4
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    # one more step from either lands on the same bits
    step(*batch)
    make_train_step(restored)(*batch)
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("field,value", [("num_devices", 2), ("profile_dir", "trace")])
def test_trainer_raises_on_paths_not_ported(tmp_path, field, value):
    """A data mesh of 2 runs one process per device, so a trainer outside
    such a group refuses it and names the launcher.  ``profile_dir``, which
    raised until traces were ported (ROADMAP A.8), now traces: a micro
    ``fit`` of 4 steps with steps [2, 4) traced writes one Chrome trace, of
    those two steps."""
    trace_dir = str(tmp_path / str(value))
    cfg = Config(model=ModelConfig(name="p3d_micro", dropout=0.0),
                 train=TrainConfig(model_dir=str(tmp_path), logs_dir=str(tmp_path),
                                   **{field: trace_dir if field == "profile_dir" else value},
                                   profile_start=2, profile_steps=2, max_steps=4))
    if field == "num_devices":
        with pytest.raises(ValueError, match="core.mesh.launch"):
            Trainer(cfg, device="cpu")
        return
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(1, 16, 32, 32, 3)).astype(np.float32),
                rng.uniform(size=(1, 16, 32, 32)).astype(np.float32)) for _ in range(4)]
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.fit(iter(batches))
    finally:
        trainer.close()
    assert os.listdir(trace_dir) == ["rank0_steps_2-3.pt.trace.json"]
    with open(os.path.join(trace_dir, "rank0_steps_2-3.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(e["name"] for e in events if e.get("name", "").startswith("train_step "))
    assert steps == ["train_step 2", "train_step 3"]
    assert any(e.get("name") == "aten::convolution" for e in events)


def _train(dataset, *extra):
    """cli train in the current directory (it writes ./model and ./logs)."""
    return cli.main([
        "train", "--structure", "p3d_micro_sa", "--dtype", "float32", "--device", "cpu",
        "--frames", dataset["frame_dirs"], "--densities", dataset["density_dirs"],
        "--imagesize", "32", "--batch", "2", "--epoch", "1", "--threads", "2",
        "--plotiter", "1", "--saveiter", "2", "--validiter", "2", "--info", "t", *extra])


def _records(logs):
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_validates_saves_resumes_and_predicts(dataset, tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert _train(dataset, "--max-steps", "3") == 0
    (run,) = os.listdir(tmp_path / "model")
    assert run.startswith("p3d_micro_sa_2_0.0001_t_")
    run_dir, logs = tmp_path / "model" / run, str(tmp_path / "logs" / run)
    assert checkpoint_steps(str(run_dir)) == [2, 3]
    recs = _records(logs)
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    (valid,) = [r for r in recs if "cc" in r]
    assert valid["step"] == 2
    assert all(np.isfinite(valid[k]) for k in ("cc", "sim", "kld", "auc_judd"))
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(logs))
    assert os.path.exists(os.path.join(logs, "smap_Result", "step_3_pred.jpg"))
    assert "[valid] step 2" in capsys.readouterr().out

    # resume from the run's latest checkpoint: steps 4 and 5 follow step 3
    assert _train(dataset, "--max-steps", "5", "--pretrain", run) == 0
    assert "pretrain restore" in capsys.readouterr().out
    assert checkpoint_steps(str(run_dir)) == [2, 3, 4, 5]
    assert [r["step"] for r in _records(logs) if "loss" in r] == [1, 2, 3, 4, 5]

    # the trained run exports through predict --checkpoint <run>
    out = tmp_path / "pred"
    assert cli.main(["predict", "--structure", "p3d_micro_sa", "--dtype", "float32",
                     "--device", "cpu", "--checkpoint", run,
                     "--model-dir", str(tmp_path / "model"), "--data", dataset["frame_dirs"],
                     "--out", str(out), "--imagesize", "32", "--batch-windows", "8"]) == 0
    assert "exported 2 videos" in capsys.readouterr().out
    assert len(os.listdir(out / "video000")) == 40
