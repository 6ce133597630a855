"""The port's evaluation path against the JAX package's.

* ``eval/metrics.py`` against ``sap3d_tpu/eval/metrics_jax.py``: ``nss`` and
  the range normalization to 1e-5 (float32 reductions in another order);
  the shared Borji / shuffled curve on the same negatives to 1e-5; the whole
  ``auc_borji`` and ``auc_shuffled``, whose negatives come from another
  random stream, per map within 0.02 at n_rep = 100 (the Monte-Carlo spread
  of one map's estimate is about 0.3 / sqrt(n_rep * n_fix), 3e-3 at the
  ~100 fixations drawn here; two estimates differ by sqrt(2) times that).
* ``evaluate_prediction_batches`` against the JAX evaluator on the same
  in-memory batches, forward outputs and ``rng``: the only difference is
  the resize (torch bilinear on the forward's device against
  ``cv2.resize``), held at 1e-5 on the map and 1e-4 on each of the five
  means.
* ``evaluate_saliency_dirs`` on a tree of JPEG maps: the host path equals
  the JAX host path (the same NumPy metrics, the same child seeds); the
  batched path (here on the CPU) matches the JAX device path to 1e-5 in
  cc, sim, kldiv and nss and within the JAX package's own device-vs-host
  limits in the AUCs (0.02 Judd, whose tie-breaking jitter comes from
  another stream, 0.06 Borji, 0.08 shuffled), on blob maps and on dense
  targets with fixations at another resolution.
* ``cli eval`` end to end on ``p3d_micro`` with a saved port checkpoint
  against the JAX package's loader, eval step and evaluator on the same
  weights and data, each mean to 1e-4; ``make-video``, ``inspect`` and
  ``plot`` on tiny inputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sap3d_tpu.eval import evaluator as jev
from sap3d_tpu.eval import metrics_jax as MJ
from sap3d_tpu_torch import cli
from sap3d_tpu_torch.eval import evaluator as tev
from sap3d_tpu_torch.eval import metrics as MD

cv2 = pytest.importorskip("cv2")


def _maps(n=6, h=24, w=32, seed=0, fix_frac=0.1):
    """Smooth random maps, and fixations where they are high; map 0 has no
    fixation and map 1 is constant (both NaN in the sampled AUCs)."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, h // 4, w // 4)).astype(np.float32)
    pred = np.stack([cv2.resize(m, (w, h), interpolation=cv2.INTER_CUBIC) for m in lo])
    pred[1] = 0.5
    noisy = pred + 0.3 * rng.random(pred.shape).astype(np.float32)
    cut = np.quantile(noisy.reshape(n, -1), 1 - fix_frac, axis=1)[:, None, None]
    fix = (noisy > cut).astype(np.float32)
    fix[0] = 0.0
    return pred, fix


def test_nss_and_range_normalization_match_jax():
    pred, fix = _maps()
    want = np.asarray(MJ.nss(jnp.asarray(pred), jnp.asarray(fix)))
    got = MD.nss(torch.from_numpy(pred), torch.from_numpy(fix)).numpy()
    assert np.isnan(want[0]) and np.isnan(got[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    s_want, c_want = MJ._range_normalize_rows(jnp.asarray(pred))
    s_got, c_got = MD._range_normalize_rows(torch.from_numpy(pred))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), atol=1e-6)
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))


def test_sampled_negatives_curve_matches_jax_on_the_same_negatives():
    pred, fix = _maps(seed=1)
    n, p = pred.shape[0], pred[0].size
    s, _ = MD._range_normalize_rows(torch.from_numpy(pred))
    f = torch.from_numpy(fix > 0.5).reshape(n, p)
    n_fix = f.sum(dim=1)
    rng = np.random.default_rng(2)
    cap, n_rep = 128, 10
    idx = rng.integers(0, p, (n, n_rep, cap))
    s_rand = np.take_along_axis(s.numpy()[:, None, :].repeat(n_rep, 1), idx, axis=2)
    live = np.arange(cap)[None, None, :] < n_fix.numpy()[:, None, None]
    s_rand = np.where(live, s_rand, -np.inf).astype(np.float32)
    want = np.asarray(MJ._auc_sampled_negatives(
        jnp.asarray(s.numpy()), jnp.asarray(f.numpy()), jnp.asarray(n_fix.numpy()),
        jnp.asarray(s_rand), 0.1))
    got = MD._auc_sampled_negatives(s, f, n_fix, torch.from_numpy(s_rand), 0.1).numpy()
    np.testing.assert_allclose(got[2:], want[2:], atol=1e-5)


@pytest.mark.parametrize("which", ["auc_borji", "auc_shuffled"])
def test_sampled_aucs_match_jax_within_monte_carlo_noise(which):
    pred, fix = _maps(n=6, h=48, w=64, seed=3, fix_frac=0.04)
    jp, jf = jnp.asarray(pred), jnp.asarray(fix)
    tp, tf = torch.from_numpy(pred), torch.from_numpy(fix)
    gen = torch.Generator().manual_seed(0)
    if which == "auc_borji":
        want = np.asarray(MJ.auc_borji(jp, jf, jax.random.PRNGKey(0)))
        got = MD.auc_borji(tp, tf, gen).numpy()
    else:
        other = np.flatnonzero(np.random.default_rng(4).random(pred[0].shape) < 0.05)
        pad = 1 << (len(other) - 1).bit_length()
        want = np.asarray(MJ.auc_shuffled(
            jp, jf, jnp.asarray(np.pad(other, (0, pad - len(other))), jnp.int32),
            jnp.int32(len(other)), jax.random.PRNGKey(0)))
        got = MD.auc_shuffled(tp, tf, torch.from_numpy(other), gen).numpy()
        assert np.isnan(MD.auc_shuffled(tp, tf, torch.zeros(0, dtype=torch.int64),
                                        gen).numpy()).all()
    assert np.isnan(want[:2]).all() and np.isnan(got[:2]).all()
    np.testing.assert_allclose(got[2:], want[2:], atol=0.02)


def _batches(n=2, b=2, t=16, size=8, gt=(24, 32), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = rng.normal(size=(b, t, size, size, 3)).astype(np.float32)
        densities = rng.random((b, t, *gt)).astype(np.float32)
        fixations = (rng.random((b, t, *gt)) < 0.05).astype(np.float32)
        fixations[:, :, 0, 0] = 1.0
        out.append((frames, densities, fixations))
    return out


def test_evaluate_prediction_batches_matches_jax():
    batches = _batches()

    def forward(frames):  # a map of the input, as a model's forward would give
        return np.abs(frames[..., 0]) + 0.1 * frames[..., 1] ** 2

    want = jev.evaluate_prediction_batches(iter(batches), forward, out_size=(32, 24),
                                           log_every=0, rng=np.random.default_rng(5))
    got = tev.evaluate_prediction_batches(
        iter(batches), lambda f: torch.from_numpy(forward(f)), out_size=(32, 24),
        log_every=0, rng=np.random.default_rng(5))
    assert got["n"] == want["n"] == 4
    for key in ("cc", "sim", "nss", "auc_judd", "auc_borji"):
        assert got[key] == pytest.approx(want[key], abs=1e-4), key
    maps = forward(batches[0][0])[:, -1]
    resized = tev.resize_bilinear(torch.from_numpy(maps), (32, 24)).numpy()
    np.testing.assert_allclose(resized, np.stack([cv2.resize(m, dsize=(32, 24)) for m in maps]),
                               atol=1e-5)


def _blob_tree(root, n_videos=2, n_frames=4, h=24, w=32, seed=0):
    """pred / density / fixation trees in the reference layout: the
    predictions are the density blobs with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    for v in range(n_videos):
        for sub in ("pred", "density", "fixation"):
            (root / sub / f"video{v}").mkdir(parents=True)
        cx, cy = rng.uniform(4, w - 4), rng.uniform(4, h - 4)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0)
        for i in range(1, n_frames + 1):
            noisy = np.clip(blob + rng.random((h, w)) * 0.2, 0, 1)
            cv2.imwrite(str(root / "pred" / f"video{v}" / f"frame_{i}.jpg"),
                        np.uint8(noisy * 255))
            cv2.imwrite(str(root / "density" / f"video{v}" / f"frame_{i}.jpg"),
                        np.uint8(blob * 255))
            fix = np.zeros((h, w), np.uint8)
            pts = np.clip(rng.normal([cy, cx], 2.0, size=(6, 2)).astype(int), 0,
                          [h - 1, w - 1])
            fix[pts[:, 0], pts[:, 1]] = 255
            cv2.imwrite(str(root / "fixation" / f"video{v}" / f"frame_{i}.bmp"), fix)


def _dense_tree(root):
    """One video of dense 96 x 96 density targets (more active pixels than
    the device sweep's cap) with fixations for two frames only, at 48 x 48."""
    rng = np.random.default_rng(11)
    for sub in ("pred", "density", "fixation"):
        (root / sub / "v0").mkdir(parents=True)
    yy, xx = np.mgrid[0:96, 0:96]
    blob = np.exp(-((yy - 48) ** 2 + (xx - 48) ** 2) / (2 * 40.0 ** 2))
    for i in range(1, 5):
        cv2.imwrite(str(root / "pred/v0" / f"frame_{i}.jpg"),
                    np.uint8(np.clip(blob + rng.normal(0, .05, blob.shape), 0, 1) * 255))
        cv2.imwrite(str(root / "density/v0" / f"frame_{i}.jpg"), np.uint8(blob * 255))
        if i <= 2:
            fix = np.zeros((48, 48), np.uint8)
            fix[rng.integers(0, 48, 10), rng.integers(0, 48, 10)] = 255
            cv2.imwrite(str(root / "fixation/v0" / f"frame_{i}.bmp"), fix)


METRICS = ("cc", "sim", "kldiv", "nss", "auc_judd", "auc_borji", "auc_shuffled")
AUC_LIMITS = {"auc_judd": 0.02, "auc_borji": 0.06, "auc_shuffled": 0.08}


@pytest.mark.parametrize("tree", ["blobs", "dense"])
def test_evaluate_saliency_dirs_matches_jax(tmp_path, tree, capsys):
    (_blob_tree if tree == "blobs" else _dense_tree)(tmp_path)
    args = (str(tmp_path / "pred"), str(tmp_path / "density"), str(tmp_path / "fixation"),
            METRICS)
    want_host = jev.evaluate_saliency_dirs(*args, rng=np.random.default_rng(7))
    got_host = tev.evaluate_saliency_dirs(*args, rng=np.random.default_rng(7), device="host")
    assert got_host == want_host
    want_dev = jev.evaluate_saliency_dirs(*args, rng=np.random.default_rng(7), device=True)
    got_dev = tev.evaluate_saliency_dirs(*args, rng=np.random.default_rng(7), device="cpu")
    assert set(got_dev) == set(want_dev)
    for v in want_dev:
        assert set(got_dev[v]) == set(want_dev[v])
        for m, want in want_dev[v].items():
            assert got_dev[v][m] == pytest.approx(want, abs=AUC_LIMITS.get(m, 1e-5)), (v, m)
    if tree == "dense":  # the wider sweep and the host fallback ran, and said so
        assert "dense targets" in capsys.readouterr().out


def _printed_scores(out: str) -> dict[str, dict[str, float]]:
    """``eval-dirs``'s printed lines as {video or "MEAN": {metric: value}}."""
    scores: dict[str, dict[str, float]] = {}
    for line in out.strip().splitlines():
        if line.startswith("MEAN "):
            metric, value = line[len("MEAN "):].split(": ")
            scores.setdefault("MEAN", {})[metric] = float(value)
        else:
            video, rest = line.split(": ", 1)
            scores[video] = {m: float(v) for m, v in
                             (pair.split(": ") for pair in rest.split("  "))}
    return scores


_JAX_EVAL_DIRS: dict[str, str] = {}


@pytest.mark.parametrize("spelling,path", [
    ("true", "card"), ("1", "card"), ("yes", "card"),
    ("false", "host"), ("0", "host"), ("no", "host"), ("host", "host"),
    ("cpu", "batched"),
])
def test_cli_eval_dirs_device_takes_the_jax_spellings(tmp_path, capsys, spelling, path):
    """``eval-dirs --device``: the JAX command line's bool spellings beside
    the port's device names.  True names the card (on a host without one,
    ``resolve_device`` raises); false and ``host`` the per-frame NumPy path,
    whose printed scores equal the JAX ``eval-dirs --device false`` run's on
    the same tree; ``cpu`` the batched metrics, within the device-vs-host
    limits of the JAX device path's printed scores."""
    from sap3d_tpu import cli as jcli

    _blob_tree(tmp_path)
    roots = ["--pred", str(tmp_path / "pred"), "--density", str(tmp_path / "density"),
             "--fixation", str(tmp_path / "fixation"), "--metrics", "cc", "sim", "nss",
             "auc_judd"]
    assert cli.eval_dirs_device(spelling) == {"card": "cuda", "host": "host"}.get(path, spelling)
    if path == "card":
        if torch.cuda.is_available():
            assert cli.main(["eval-dirs", *roots, "--device", spelling]) == 0
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                cli.main(["eval-dirs", *roots, "--device", spelling])
        return
    jax_device = "false" if path == "host" else "true"
    if jax_device not in _JAX_EVAL_DIRS:
        assert jcli.main(["eval-dirs", *roots, "--device", jax_device]) == 0
        _JAX_EVAL_DIRS[jax_device] = capsys.readouterr().out
    want = _JAX_EVAL_DIRS[jax_device]
    capsys.readouterr()
    assert cli.main(["eval-dirs", *roots, "--device", spelling]) == 0
    got = capsys.readouterr().out
    if path == "host":
        assert got == want
        return
    got, want = _printed_scores(got), _printed_scores(want)
    assert set(got) == set(want) == {"video0", "video1", "MEAN"}
    for video, scores in want.items():
        assert set(got[video]) == set(scores)
        for m, value in scores.items():  # printed to 4 decimals
            assert got[video][m] == pytest.approx(value, abs=AUC_LIMITS.get(m, 1e-4)), (video, m)


def test_cli_eval_scores_a_saved_port_checkpoint_as_the_evaluator_does(tmp_path, monkeypatch,
                                                                       capsys):
    """The port's ``cli eval`` (its loader in test mode, the fp32 eval
    forward, the last-frame resize, the scoring) on a saved ``p3d_micro``
    weights file, against the JAX package's loader, eval step and evaluator
    on the same weights and data: each of the five means to 1e-4."""
    from _torch_parity import build_pair

    from sap3d_tpu.data.indexer import ClipIndex
    from sap3d_tpu.data.pipeline import ClipLoader
    from sap3d_tpu.train.state import TrainState
    from sap3d_tpu.train.steps import make_eval_step
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset

    roots = make_synthetic_dataset(str(tmp_path / "data"), num_videos=2, frames_per_video=30,
                                   size=(32, 24), with_fixations=True)
    jm, variables, model = build_pair("p3d_micro", (2, 16, 32, 32, 3), seed=3)
    (tmp_path / "model").mkdir()
    torch.save(model.state_dict(), tmp_path / "model" / "p3d_micro_run.pt")
    data = ["--frames", roots["frame_dirs"], "--densities", roots["density_dirs"],
            "--fixations", roots["fixation_dir"], "--imagesize", "32", "--overlap", "14",
            "--threads", "2", "--model-dir", str(tmp_path / "model"), "--device", "cpu"]
    monkeypatch.chdir(tmp_path)
    results = []

    def spy(*args, **kwargs):
        results.append(evaluate(*args, **kwargs))
        return results[-1]

    evaluate = tev.evaluate_prediction_batches
    monkeypatch.setattr(tev, "evaluate_prediction_batches", spy)
    assert cli.main(["eval", "--checkpoint", "p3d_micro_*.pt", *data]) == 0
    out = capsys.readouterr().out
    (got,) = results

    idx = ClipIndex([roots["frame_dirs"]], [roots["density_dirs"]],
                    fixation_dir=roots["fixation_dir"]).setup(overlap=14, training_props=0.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None, tx=None)
    ev = make_eval_step(jm)
    with ClipLoader(idx.valid_clips(with_fixations=True), 2, size=32, num_threads=2,
                    shuffle=False, test_mode=True) as loader:
        want = jev.evaluate_prediction_batches(iter(loader), lambda f: ev(state, jnp.asarray(f)))
    assert got["n"] == want["n"] > 0
    for key in ("cc", "sim", "nss", "auc_judd", "auc_borji"):
        assert got[key] == pytest.approx(want[key], abs=1e-4), key
    assert "Model: p3d_micro_run.pt (structure p3d_micro)" in out
    assert (f"All: {got['n']}, Metrics: CC: {got['cc']:.3f}  SIM: {got['sim']:.3f}   "
            f"NSS: {got['nss']:.3f}  AUC_Judd: {got['auc_judd']:.3f}   "
            f"AUC_Borji: {got['auc_borji']:.3f}   (compute dtype: float32)") in out
    assert cli.main(["eval", "--checkpoint", "missing", *data]) == 1
    # a batch that does not divide by the data mesh: one device scores it
    capsys.readouterr()
    assert cli.main(["eval", "--devices", "2", "--batch", "3", "--checkpoint",
                     "p3d_micro_*.pt", *data]) == 0
    fallback = capsys.readouterr()
    assert "--batch 3 does not divide by 2 devices; falling back to SINGLE-device eval" \
        in fallback.err
    assert "Model: p3d_micro_run.pt (structure p3d_micro)" in fallback.out
    assert results[-1]["n"] > 0
    assert cli.main(["eval", "--tf-checkpoint", str(tmp_path / "t"), *data]) == 1


def test_make_video_inspect_and_plot(tmp_path, capsys):
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train import inspect_ckpt

    for v in ("a", "b"):
        (tmp_path / "maps" / v).mkdir(parents=True)
        for i in range(1, 10):
            cv2.imwrite(str(tmp_path / "maps" / v / f"frame_{i}.jpg"),
                        np.full((20, 30), 10 * i, np.uint8))
    assert cli.main(["make-video", "--results", str(tmp_path / "maps"),
                     "--out", str(tmp_path / "videos")]) == 0
    assert sorted(os.listdir(tmp_path / "videos")) == ["a.avi", "b.avi"]
    assert "wrote 2 videos" in capsys.readouterr().out

    model = build_model("p3d_micro", device="cpu")
    torch.save(model.state_dict(), tmp_path / "w.pt")
    rows = inspect_ckpt.inspect(str(tmp_path / "w.pt"), "stem")
    assert rows and all("stem" in name for name, _, _ in rows)
    assert ("encoder.stem.kernel", tuple(model.encoder.stem.kernel.shape), "float32") in rows
    assert cli.main(["inspect", str(tmp_path / "w.pt"), "stem"]) == 0
    assert f"-- {len(rows)} tensors" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="no TensorFlow V2 checkpoint"):
        cli.main(["inspect", "--tf", str(tmp_path / "w.pt")])

    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in (
        {"step": 1, "loss": 2.0}, {"step": 2, "loss": 1.5, "cc": 0.3, "sim": 0.2,
                                   "auc_judd": 0.6})))
    assert cli.main(["plot", str(logs)]) == 0
    printed = capsys.readouterr().out.strip()
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert printed == "matplotlib unavailable"
    else:
        assert printed == str(logs / "curves.png") and (logs / "curves.png").exists()
