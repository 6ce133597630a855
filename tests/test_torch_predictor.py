"""The port's sliding-window predictor and ``cli predict`` against the JAX
package's, on the CPU.

The emission protocol is compared exactly, with one deterministic apply
function given to both predictors.  ``cli predict`` runs the micro model
with numpy-made weights on a synthetic dataset and its JPEGs are compared
with the JAX predictor's on the same weights: at most 2 grey levels apart
(the maps agree to ~1e-7 before the x255 quantization and JPEG encode).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import build_pair
from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.data.synthetic import make_synthetic_dataset
from sap3d_tpu.infer.predictor import SlidingWindowPredictor as JaxPredictor
from sap3d_tpu_torch import cli
from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor

cv2 = pytest.importorskip("cv2")

SIZE = 32


def _jax_apply(clips):  # [W, T, H, W, 3] -> [W, T, H, W]; distinct per t
    return clips[..., 0] + 10.0 * jnp.arange(clips.shape[1])[None, :, None, None]


def _torch_apply(clips):
    return clips[..., 0] + 10.0 * torch.arange(clips.shape[1])[None, :, None, None]


@pytest.mark.parametrize("n_frames,batch_windows", [(36, 3), (16, 4), (20, 16), (10, 4)])
def test_emission_protocol_matches_jax(n_frames, batch_windows):
    frames = np.random.default_rng(0).normal(size=(n_frames, 8, 8, 3)).astype(np.float32)
    want = JaxPredictor(_jax_apply, batch_windows=batch_windows,
                        image_size=8).predict_video(frames=frames)
    with SlidingWindowPredictor(_torch_apply, batch_windows=batch_windows,
                                image_size=8, device="cpu") as pred:
        got = pred.predict_video(frames=frames)
        got_t = pred.predict_video(frames=torch.from_numpy(frames))
    assert got.shape == want.shape == ((n_frames, 8, 8) if n_frames >= 16 else (0, 8, 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_t, want)
    if n_frames >= 16:  # window 0 emits frames 1..16, window s frame s+16
        np.testing.assert_array_equal(got[15:, 0, 0], frames[15:, 0, 0, 0] + 150.0)
        np.testing.assert_array_equal(got[:16, 0, 0], frames[:16, 0, 0, 0]
                                      + 10.0 * np.arange(16, dtype=np.float32))


def test_export_video_partial_dir_and_skip_existing(tmp_path):
    roots = make_synthetic_dataset(str(tmp_path / "data"), num_videos=1,
                                   frames_per_video=18, size=(40, 30))
    vdir = os.path.join(roots["frame_dirs"], "video000")
    save = str(tmp_path / "pred" / "video000")
    os.makedirs(save + ".tmp-partial")  # stale partial from a crashed run
    with SlidingWindowPredictor(lambda c: torch.sigmoid(c[..., 0]), batch_windows=2,
                                image_size=SIZE, out_size=(40, 30), device="cpu") as pred:
        assert pred.export_video(vdir, save)
        assert sorted(os.listdir(save)) == sorted(f"frame_{i}.jpg" for i in range(1, 19))
        assert not os.path.exists(save + ".tmp-partial")
        assert not pred.export_video(vdir, save)  # skip existing


def test_cli_predict_matches_jax_predictor(tmp_path):
    roots = make_synthetic_dataset(str(tmp_path / "data"), num_videos=2,
                                   frames_per_video=20, size=(64, 48))
    jm, variables, tm = build_pair("p3d_micro_sa", (4, 16, SIZE, SIZE, 3))
    weights = str(tmp_path / "model" / "micro.pt")
    os.makedirs(os.path.dirname(weights))
    torch.save(tm.state_dict(), weights)

    out = str(tmp_path / "pred_torch")
    rc = cli.main(["predict", "--structure", "p3d_micro_sa", "--dtype", "float32",
                   "--checkpoint", "micro.pt", "--model-dir", str(tmp_path / "model"),
                   "--data", roots["frame_dirs"], "--out", out,
                   "--batch-windows", "4", "--imagesize", str(SIZE), "--device", "cpu"])
    assert rc == 0

    fwd = jax.jit(lambda f: jm.apply(variables, f, train=False)[..., 0])
    want_root = str(tmp_path / "pred_jax")
    JaxPredictor(fwd, batch_windows=4, image_size=SIZE).export_dataset(
        roots["frame_dirs"], want_root)
    for video in ("video000", "video001"):
        names = sorted(os.listdir(os.path.join(out, video)))
        assert names == sorted(os.listdir(os.path.join(want_root, video)))
        assert len(names) == 20
        for name in names:
            got = cv2.imread(os.path.join(out, video, name), cv2.IMREAD_GRAYSCALE)
            want = cv2.imread(os.path.join(want_root, video, name), cv2.IMREAD_GRAYSCALE)
            assert got.shape == (1080, 960)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
