"""The port's TF checkpoint import and the bottleneck BN quirk, against
TensorFlow and the JAX package.

* ``interop/tf_bundle.read_checkpoint`` (numpy only) against
  ``tf.train.load_checkpoint`` on checkpoints TensorFlow writes here: a TF1
  ``Saver`` checkpoint of every dtype the reader takes, with Adam slots and
  ``global_step``, read by directory and by prefix, and a TF2
  ``tf.train.Checkpoint`` with its string entry: names, dtypes, shapes and
  values bitwise.  The committed fixture against its ``.npz`` (no TF).
* ``interop/tf_import``: ``variable_mapping`` equal to the JAX package's,
  entry for entry, for the eight importable names; the unsupported names
  raising alike; full-width seeded TF arrays through the port's
  ``import_checkpoint`` and through the JAX package's followed by
  ``state_dict_from_flax``: bitwise equal ``state_dict``s.
* ``bn_reference_quirk``: the ``p3d_micro`` forward against JAX's, both with
  the quirk, within ``ATOL`` (fp32), every buffer bitwise unchanged.
* The CLI on the CPU: ``predict --tf-checkpoint`` (full-width UNet++ at 32
  px) bitwise equal to the library route, ``eval --tf-checkpoint``, ``eval
  --bn-quirk`` against the evaluator on a quirk model, ``inspect --tf``
  against TensorFlow's own listing.

The tests that write checkpoints need TensorFlow and skip without it.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.interop import tf_import as jti
from sap3d_tpu_torch import cli
from sap3d_tpu_torch.interop import tf_bundle
from sap3d_tpu_torch.interop import tf_import as tti
from sap3d_tpu_torch.interop.flax_bridge import state_dict_from_flax
from sap3d_tpu_torch.models import registry as treg

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "tf1_saver_fixture")
IMPORTABLE = ["p3d_unet", "p3d_concat", "p3d_unetplusplus", "p3d_unetplusplus_ds",
              "p3d_unetplusplus_nonsa", "inference_p3d", "inference_p3d_concat",
              "inference_p3d_decoder_block"]
UNSUPPORTED = sorted(set(treg.MODEL_REGISTRY) - set(IMPORTABLE))
# the micro quirk forward against JAX's (fp32), in units of max|want|
ATOL = 1e-5


@pytest.fixture(scope="module")
def tf1():
    return pytest.importorskip("tensorflow").compat.v1


@functools.lru_cache(maxsize=1)
def _pool() -> np.ndarray:
    """Normals enough for the largest importable kernel (49.5 M values)."""
    return np.random.default_rng(0).standard_normal(1 << 26, dtype=np.float32)


def meta_model(name: str):
    """The full-width registry model on the meta device (shapes only)."""
    with torch.device("meta"):
        return treg.build_model(name, device="meta")


def tf_named_arrays(name: str, model, seed: int = 0,
                    scaled: bool = True) -> dict[str, np.ndarray]:
    """Seeded arrays in TF's layout for every variable of ``name``'s mapping,
    at the shapes of ``model`` (``meta_model(name)``).  A torch conv or
    transposed-conv kernel ``[a, b, kd, kh, kw]`` is TF's ``[kd, kh, kw, b,
    a]``; a dense kernel is transposed.  Values are windows of one pool of
    normals at offsets drawn from ``seed`` (views of it unless ``scaled``;
    scaled, weights a forward can run: kernels by 1/sqrt(fan_in), BN scales
    and variances in (0.5, 1), biases, means and ``gamma`` by 0.1)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    pool, rng = _pool(), np.random.default_rng(seed)
    out = {}
    for e in tti.variable_mapping(name):
        s = shapes[".".join(e.path)]
        shape = (s[2], s[3], s[4], s[1], s[0]) if len(s) == 5 else s[::-1]
        n = int(np.prod(shape))
        start = int(rng.integers(0, pool.size - n))
        window = pool[start:start + n].reshape(shape)
        if not scaled:
            arr = window
        elif e.path[-1] == "kernel":
            arr = window * np.float32(1.0 / np.sqrt(np.prod(shape[:-1])))
        elif e.path[-1] in ("scale", "var"):
            arr = np.float32(0.75) + np.float32(0.25) * np.tanh(window)
        else:
            arr = np.float32(0.1) * window
        out[e.tf_name] = arr
    return out


def with_optimizer_variables(tf_vars: dict) -> dict:
    """``tf_vars`` with the Adam slots of every variable and the trainer's
    bookkeeping, as a reference training checkpoint holds them."""
    out = dict(tf_vars)
    for n, a in tf_vars.items():
        out[f"{n}/Adam"], out[f"{n}/Adam_1"] = a, a
    out.update(beta1_power=np.float32(0.9), beta2_power=np.float32(0.999),
               global_step=np.int64(1234))
    return out


def write_checkpoint(tf1, tf_vars: dict, directory: str) -> str:
    """A V2 checkpoint of ``tf_vars`` under ``directory`` (prefix
    ``model.ckpt``, and the ``checkpoint`` file naming it), written by TF's
    ``SaveV2`` op in graph mode, the op a ``Saver`` runs; its prefix."""
    prefix = os.path.join(directory, "model.ckpt")
    names = list(tf_vars)
    graph = tf1.Graph()
    with graph.as_default():
        phs = [tf1.placeholder(tf1.as_dtype(np.asarray(tf_vars[n]).dtype),
                               np.shape(tf_vars[n])) for n in names]
        save = tf1.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                                  shape_and_slices=[""] * len(names), tensors=phs)
        with tf1.Session(graph=graph) as sess:
            sess.run(save, dict(zip(phs, (tf_vars[n] for n in names))))
    tf1.train.update_checkpoint_state(directory, prefix)
    return prefix


def tf_listing(path: str) -> dict[str, np.ndarray]:
    import tensorflow as tf

    reader = tf.train.load_checkpoint(path)
    return {n: reader.get_tensor(n) for n in reader.get_variable_to_shape_map()}


def assert_same_tensors(got: dict, want: dict):
    """The same names; numeric tensors of the same dtype and shape bit for
    bit; string tensors (TF gives a scalar one as ``bytes``) as object
    arrays of the same ``bytes``."""
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n]
        w = np.array(w, dtype=object) if isinstance(w, bytes) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, n
        if w.dtype == object:
            assert list(g.ravel()) == list(w.ravel()), n
        else:
            assert g.tobytes() == w.tobytes(), n


# ---- (i) the reader against TensorFlow ---------------------------------------

@pytest.fixture(scope="module")
def saver_ckpt(tf1, tmp_path_factory):
    """A TF1 Saver checkpoint of every numeric dtype, one Adam step taken."""
    rng = np.random.default_rng(1)
    values = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "scope/f64": rng.normal(size=(5,)),
        "i32": rng.integers(-2**31, 2**31, (2, 2), dtype=np.int32),
        "u8": rng.integers(0, 256, (6,), dtype=np.uint8),
        "i16": rng.integers(-2**15, 2**15, (3,), dtype=np.int16),
        "i8": rng.integers(-128, 128, (2, 3), dtype=np.int8),
        "i64": rng.integers(-2**62, 2**62, (4,), dtype=np.int64),
        "b": rng.integers(0, 2, (3, 1)).astype(bool),
        "h": rng.normal(size=(2, 3, 1)).astype(np.float16),
        "scalar": np.float32(2.5),
    }
    root = tmp_path_factory.mktemp("saver")
    graph = tf1.Graph()
    with graph.as_default():
        v = {n: tf1.get_variable(n, initializer=tf1.constant(a)) for n, a in values.items()}
        step = tf1.train.get_or_create_global_step()
        loss = tf1.reduce_sum(tf1.square(v["f32"])) + v["scalar"]
        train = tf1.train.AdamOptimizer(1e-2).minimize(loss, global_step=step)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            sess.run(train)
            tf1.train.Saver().save(sess, str(root / "model.ckpt"))
    return root


@pytest.mark.parametrize("by", ["directory", "prefix"])
def test_reader_matches_tf_on_a_saver_checkpoint(saver_ckpt, by):
    path = str(saver_ckpt) if by == "directory" else str(saver_ckpt / "model.ckpt")
    want = tf_listing(path)
    assert {"f32/Adam", "f32/Adam_1", "beta1_power", "global_step"} <= set(want)
    assert want["global_step"].dtype == np.int64 and want["global_step"].shape == ()
    assert_same_tensors(tf_bundle.read_checkpoint(path), want)


def test_reader_matches_tf_on_a_tf2_object_checkpoint(tf1, tmp_path):
    """An object-based checkpoint (``tf.compat.v1.train.Checkpoint`` in graph
    mode, so that the test runs with or without TF2 behaviour): its
    ``_CHECKPOINTABLE_OBJECT_GRAPH`` entry and a string variable come back as
    object arrays of bytes, as TF gives them."""
    graph = tf1.Graph()
    with graph.as_default():
        ckpt = tf1.train.Checkpoint(
            w=tf1.Variable(np.arange(12, dtype=np.float32).reshape(3, 4)),
            words=tf1.Variable(np.array([b"", b"saliency", b"\x00\xff" * 70], object)))
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            prefix = ckpt.save(str(tmp_path / "obj"), session=sess)
    want = tf_listing(prefix)
    assert "_CHECKPOINTABLE_OBJECT_GRAPH" in want
    assert any(np.asarray(a).dtype == object and np.asarray(a).size == 3
               for a in want.values())
    assert_same_tensors(tf_bundle.read_checkpoint(prefix), want)
    assert_same_tensors(tf_bundle.read_checkpoint(str(tmp_path)), want)


@pytest.mark.parametrize("case", ["missing", "v1_single_file", "bad_magic"])
def test_reader_raises_and_names_the_path(tmp_path, case):
    """No TF needed: a missing path, a file with no ``.index`` beside it (a
    V1 single-file checkpoint), an index whose magic has one byte flipped."""
    path = str(tmp_path / "model.ckpt")
    err = FileNotFoundError
    if case == "v1_single_file":
        with open(path, "wb") as f:
            f.write(b"\x00" * 64)
    elif case == "bad_magic":
        index = bytearray(open(os.path.join(FIXTURE, "model.ckpt.index"), "rb").read())
        index[-1] ^= 0x01
        with open(path + ".index", "wb") as f:
            f.write(bytes(index))
        err = tf_bundle.CheckpointFormatError
    with pytest.raises(err, match="model.ckpt"):
        tf_bundle.read_checkpoint(path)


# ---- (ii) the committed fixture, without TF ----------------------------------

def test_committed_fixture_matches_its_npz():
    want = dict(np.load(os.path.join(FIXTURE, "values.npz")))
    assert {"conv3_0_1/Adam", "beta1_power", "global_step", "flags"} <= set(want)
    assert_same_tensors(tf_bundle.read_checkpoint(FIXTURE), want)
    assert_same_tensors(tf_bundle.read_checkpoint(os.path.join(FIXTURE, "model.ckpt")), want)


# ---- (iii) the mapping against the JAX package -------------------------------

@pytest.mark.parametrize("name", IMPORTABLE)
def test_full_width_import_matches_jax_bitwise(name, monkeypatch):
    """The same seeded TF arrays (Adam slots and bookkeeping included)
    through the port's ``import_checkpoint`` and the JAX package's followed
    by the flax bridge: the same keys, every tensor bit for bit.  Both
    loaders return the in-memory arrays (the reader is held to TF above, and
    on a full-width file in the CLI test below)."""
    assert ([dataclasses.astuple(e) for e in tti.variable_mapping(name)]
            == [dataclasses.astuple(e) for e in jti.variable_mapping(name)])
    model = meta_model(name)
    tf_vars = with_optimizer_variables(tf_named_arrays(name, model, scaled=False))
    monkeypatch.setattr(tti, "load_tf_checkpoint", lambda path: tf_vars)
    monkeypatch.setattr(jti, "load_tf_checkpoint", lambda path: tf_vars)
    got = tti.import_checkpoint(name, "in-memory")
    variables = jti.import_checkpoint(name, "in-memory")
    want = state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k
    tti.validate_against_model(got, model)


@pytest.mark.parametrize("name", UNSUPPORTED)
def test_unsupported_names_raise_as_in_jax(name):
    with pytest.raises(NotImplementedError) as want:
        jti.variable_mapping(name)
    with pytest.raises(NotImplementedError) as got:
        tti.variable_mapping(name)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fault", ["missing_variable", "stranded_variable", "wrong_shape"])
def test_mapping_faults_raise(fault):
    """A checkpoint without one expected variable, or with one model-like
    variable the mapping does not cover, raises as the JAX package does; a
    wrong shape fails the validation against the model."""
    name = "p3d_unetplusplus_nonsa"
    model = meta_model(name)
    tf_vars = tf_named_arrays(name, model, scaled=False)
    if fault == "missing_variable":
        del tf_vars["x_1_3/kernel"]
        err, match = KeyError, "lacks 1 expected"
    elif fault == "stranded_variable":
        tf_vars["conv3d_99/kernel"] = np.zeros(3, np.float32)
        err, match = ValueError, "does not cover"
    else:
        tf_vars["upx_4_0/kernel"] = tf_vars["upx_4_0/kernel"].transpose(0, 1, 2, 4, 3)
        err, match = ValueError, "imported shape"
    if fault != "wrong_shape":  # the JAX package checks shapes on a flax model's init
        with pytest.raises(err, match=match):
            jti.map_tf_variables(name, tf_vars)
    with pytest.raises(err, match=match):
        tti.validate_against_model(tti.state_dict_from_tf_variables(name, tf_vars), model)


# ---- (iv) the quirk forward against JAX --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_stats_at_eval_normalizes_as_train_mode_and_moves_nothing(dtype):
    """Under ``inference_mode``, a BatchNorm with ``batch_stats_at_eval`` in
    eval mode gives train mode's output bit for bit (float32 statistics of
    the compute-dtype input) and leaves its running statistics alone."""
    from sap3d_tpu_torch.ops.layers import BatchNorm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 3, 4, 5, generator=gen).to(dtype) * 3 + 1
    bn = BatchNorm(6, dtype, batch_stats_at_eval=True)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(generator=gen)
        bn.mean.normal_(generator=gen)
        bn.var.uniform_(0.5, 1.5, generator=gen)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with torch.inference_mode():
        got = bn.eval()(x)
    assert all(torch.equal(before[k], v) for k, v in bn.state_dict().items())
    want = bn.train()(x)
    assert got.dtype == dtype and torch.equal(got, want)
    with torch.inference_mode():
        running = BatchNorm(6, dtype).eval()
        running.load_state_dict(before)
        assert not torch.allclose(running(x).float(), got.float(), atol=1e-2)


def test_micro_quirk_forward_matches_jax_and_moves_no_buffer():
    """``p3d_micro`` (BN) in fp32, both packages built with the quirk, random
    running statistics (the quirk must ignore the bottlenecks' and use the
    stem's and decoder's): the port's eval step against JAX's eval step with
    the statistics update discarded, within ``ATOL`` x max|want|; every
    buffer bitwise unchanged; the same weights without the quirk give other
    maps."""
    import jax.numpy as jnp
    from _torch_parity import numpy_variables

    from sap3d_tpu.models import registry as jreg
    from sap3d_tpu.train.state import TrainState
    from sap3d_tpu.train.steps import make_eval_step as jax_eval_step
    from sap3d_tpu_torch.train.steps import make_eval_step

    shape = (2, 16, 32, 32, 3)
    jm = jreg.build_model("p3d_micro", bn_reference_quirk=True)
    params, stats = numpy_variables(jm, shape, seed=4)
    tm = treg.build_model("p3d_micro", device="cpu", bn_reference_quirk=True)
    tm.load_state_dict(state_dict_from_flax(params, stats, model=tm), strict=True)
    x = (np.random.default_rng(5).normal(size=shape) * 0.3).astype(np.float32)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=None, tx=None)
    want = np.asarray(jax_eval_step(jm)(state, jnp.asarray(x)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = make_eval_step(tm)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    plain = treg.build_model("p3d_micro", device="cpu")
    plain.load_state_dict(tm.state_dict())
    without = make_eval_step(plain)(torch.from_numpy(x)).numpy()
    assert np.abs(without - want).max() > 100 * ATOL * np.abs(want).max()


# ---- (v) the CLI on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def flagship_ckpt(tf1, tmp_path_factory):
    """A full-width ``p3d_unetplusplus_ds`` (unet++) checkpoint of seeded
    weights, with the trainer's bookkeeping variables; its directory."""
    root = tmp_path_factory.mktemp("flagship_tf")
    name = "p3d_unetplusplus_ds"
    tf_vars = tf_named_arrays(name, meta_model(name), seed=6)
    tf_vars.update(beta1_power=np.float32(0.9), global_step=np.int64(77))
    write_checkpoint(tf1, tf_vars, str(root))
    return str(root)


def test_cli_predict_tf_checkpoint_matches_the_library_route(tmp_path, flagship_ckpt,
                                                             monkeypatch):
    """``cli predict --tf-checkpoint`` (unet++ at 32 px, 2 windows a batch, a
    20-frame video, fp32 on the CPU) writes every frame, and its maps are
    bitwise those of the library route: ``build_model`` with the quirk, the
    weights the JAX package imports from the same file (held bitwise to the
    port's import), the predictor."""
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.train.steps import make_eval_step

    roots = make_synthetic_dataset(str(tmp_path / "data"), num_videos=1,
                                   frames_per_video=20, size=(64, 48))
    maps = []
    predict = SlidingWindowPredictor.predict_video

    def spy(self, *args, **kwargs):
        maps.append(predict(self, *args, **kwargs))
        return maps[-1]

    monkeypatch.setattr(SlidingWindowPredictor, "predict_video", spy)
    out = tmp_path / "pred"
    assert cli.main(["predict", "--structure", "unet++", "--tf-checkpoint", flagship_ckpt,
                     "--data", roots["frame_dirs"], "--out", str(out), "--batch-windows",
                     "2", "--imagesize", "32", "--dtype", "float32", "--device", "cpu"]) == 0
    (video,) = os.listdir(out)
    assert sorted(os.listdir(out / video)) == sorted(f"frame_{i}.jpg" for i in range(1, 21))

    variables = jti.import_checkpoint("p3d_unetplusplus_ds", flagship_ckpt)
    want_sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    got_sd = tti.import_checkpoint("p3d_unetplusplus_ds", flagship_ckpt)
    assert list(got_sd) == list(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    model = treg.build_model("unet++", dtype="float32", device="cpu",
                             bn_reference_quirk=True)
    model.load_state_dict(want_sd, strict=True)
    frames = os.path.join(roots["frame_dirs"], video)
    with SlidingWindowPredictor(make_eval_step(model), batch_windows=2, image_size=32,
                                device="cpu") as pred:
        want = pred.predict_video(pred._video_paths(frames))
    (got,) = maps[:1]
    assert got.shape == (20, 32, 32) and np.isfinite(got).all()
    assert np.array_equal(got, want)


def test_cli_eval_tf_checkpoint_and_inspect_tf(tmp_path, flagship_ckpt, capsys):
    """``cli eval --tf-checkpoint`` scores the full-width checkpoint (rc 0,
    its run named ``tf:<path>``); ``inspect --tf <ckpt> conv`` lists the rows
    TensorFlow's own listing gives."""
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.train.inspect_ckpt import inspect_tf

    roots = make_synthetic_dataset(str(tmp_path / "data"), num_videos=1,
                                   frames_per_video=27, size=(64, 48), with_fixations=True)
    assert cli.main(["eval", "--structure", "unet++", "--tf-checkpoint", flagship_ckpt,
                     "--frames", roots["frame_dirs"], "--densities", roots["density_dirs"],
                     "--fixations", roots["fixation_dir"], "--imagesize", "32",
                     "--overlap", "0", "--batch", "1", "--threads", "2",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"Model: tf:{flagship_ckpt} (structure p3d_unetplusplus_ds)\n All: 1," in out

    want = sorted((n, tuple(a.shape)) for n, a in tf_listing(flagship_ckpt).items()
                  if "conv" in n)
    rows = inspect_tf(flagship_ckpt, "conv")
    assert len(rows) > 40 and rows == want
    assert cli.main(["inspect", "--tf", flagship_ckpt, "conv"]) == 0
    assert f"-- {len(rows)} tensors" in capsys.readouterr().out


def test_cli_eval_bn_quirk_scores_as_the_evaluator_on_a_quirk_model(tmp_path, monkeypatch):
    """``cli eval --bn-quirk`` on a saved ``p3d_micro`` weights file: the
    five means equal the evaluator's on the same weights in a model built
    with the quirk, and differ from a run without it."""
    from sap3d_tpu_torch.data.indexer import ClipIndex
    from sap3d_tpu_torch.data.pipeline import ClipLoader
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.eval import evaluator as tev
    from sap3d_tpu_torch.train.steps import make_eval_step

    roots = make_synthetic_dataset(str(tmp_path / "data"), num_videos=1,
                                   frames_per_video=30, size=(32, 24), with_fixations=True)
    model = treg.build_model("p3d_micro", device="cpu", seed=2)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5 if name.endswith("var")
                      else 0.1 * torch.randn(buf.shape))
    (tmp_path / "model").mkdir()
    torch.save(model.state_dict(), tmp_path / "model" / "p3d_micro_w.pt")
    results = []
    evaluate = tev.evaluate_prediction_batches

    def spy(*args, **kwargs):
        results.append(evaluate(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(tev, "evaluate_prediction_batches", spy)
    args = ["eval", "--checkpoint", "p3d_micro_w.pt", "--frames", roots["frame_dirs"],
            "--densities", roots["density_dirs"], "--fixations", roots["fixation_dir"],
            "--imagesize", "32", "--overlap", "14", "--threads", "2",
            "--model-dir", str(tmp_path / "model"), "--device", "cpu"]
    assert cli.main([*args, "--bn-quirk"]) == 0
    assert cli.main(args) == 0
    quirk, plain = results

    model_q = treg.build_model("p3d_micro", device="cpu", bn_reference_quirk=True)
    model_q.load_state_dict(model.state_dict())
    ev = make_eval_step(model_q)
    idx = ClipIndex([roots["frame_dirs"]], [roots["density_dirs"]],
                    fixation_dir=roots["fixation_dir"]).setup(overlap=14, training_props=0.0)
    with ClipLoader(idx.valid_clips(with_fixations=True), 2, size=32, num_threads=2,
                    shuffle=False, test_mode=True) as loader:
        want = evaluate(iter(loader), lambda f: ev(torch.from_numpy(f)))
    assert quirk["n"] == want["n"] > 0
    for key in ("cc", "sim", "nss", "auc_judd", "auc_borji"):
        assert quirk[key] == want[key], key
    assert any(quirk[k] != plain[k] for k in ("cc", "sim", "nss"))
