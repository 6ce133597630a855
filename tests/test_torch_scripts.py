"""The port's profiling and bench scripts (``sap3d_tpu_torch/scripts``)
against the JAX package's (``scripts/``), on the CPU.

Each JAX script is imported from its file (``jax_script``: its own
directory on ``sys.path`` while it imports, and the compilation-cache
setting it makes when imported restored after), and its functions run on
the same numpy inputs as the port's, at small shapes.  Limits:

* the ring hops, float32: o to 1e-5 of its largest value, the q, k, v
  gradients of the quadratic loss to 1e-4 of theirs (float32 sums in
  another order; the JAX kernel hop in the Pallas interpreter);
* the decoder's sites, float32: the port's layer (its explicit SAME
  padding, the transposed conv's flip and in/out swap) against the JAX
  script's own conv body, y to 1e-5 and dx, dw to 1e-4 of their largest
  values; the FLOP count equal to the JAX script's;
* the encoder's stage-3 products, float32: the port's conv_s and im2col
  against the JAX script's micro_convs bodies to 1e-5 of their largest
  values;
* the step legs: ``no_opt``'s loss against JAX's ``make_step(model,
  optimizer=False)`` on p3d_micro_sa (float32, dropout 0) to 1e-5, no
  parameter moved; every leg's and every GN leg's constructor arguments
  equal to the model JAX's script builds; stage3_thin's parameter shapes at
  full width (the port on the meta device against ``jax.eval_shape``);
* the bench scripts: bench_eval's tree read back equal to JAX's, the JSON
  keys of bench_cli_eval and bench_loader JAX's (the card in place of
  ``platform``), each run at a tiny size on ``--device cpu``.

Every script defaults to CUDA and raises without a GPU; a failed hold or
leg raises (a non-zero exit).
"""

import ast
import contextlib
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import build_pair
from sap3d_tpu.models import registry as jreg
from sap3d_tpu.train.state import TrainState as JaxTrainState
from sap3d_tpu.train.state import make_optimizer as jax_make_optimizer
from sap3d_tpu_torch.models.p3d import P3DSaliency
from sap3d_tpu_torch.ops import ring_attention
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.interop.flax_bridge import convert_leaf
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.scripts import (
    _timing,
    bench_cli_eval,
    bench_eval,
    bench_export,
    bench_loader,
    profile_attention,
    profile_decoder,
    profile_encoder,
    profile_gn,
    profile_ring_hop,
    profile_step,
    profile_tconv,
    profile_tconv2,
    profile_tconv3,
    time_flash_backward,
    time_flash_forward,
    train_step_spread,
)
from sap3d_tpu_torch.train.state import create_train_state

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCRIPTS = (profile_attention, profile_ring_hop, profile_decoder, profile_encoder, profile_step,
           profile_gn, bench_eval, bench_cli_eval, bench_export, bench_loader, profile_tconv,
           profile_tconv2, profile_tconv3)


def jax_script(path: Path):
    """The JAX script at ``path`` as a module, imported with its directory
    on ``sys.path`` (for its ``_scan_timer`` and ``profile_step`` imports);
    the ``jax_compilation_cache_dir`` it sets when imported is restored."""
    cache = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, str(path.parent))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module's micro models: the test runs
    share the host's cores with other workers, and a pool of every core on
    models this small only contends for them (266 s of a worker's time
    under the 6-worker Tier-1 command with the default pool)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: jax_script(REPO / "scripts" / f"{name}.py")
            for name in ("profile_ring_hop", "profile_decoder", "profile_encoder",
                         "profile_step", "profile_gn", "bench_eval")}


def _close(got, want, rtol: float, what: str = ""):
    """|got - want| <= rtol * max|want| everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err, np.abs(want).max())


# ---- the ring hop -----------------------------------------------------------

RING_SHAPE = (1, 256, 256, 16, 128)  # (B, Nq, Nk, d, C)
RING_CHUNK = 128                     # 2 query chunks in the chunked hop


@pytest.mark.parametrize("hop", ["xla", "pallas"])
def test_ring_hop_matches_jax(jax_scripts, monkeypatch, hop):
    """One hop from the explicit (-inf, 0, 0) state: the output acc / den
    and the quadratic loss's q, k, v gradients, the port's hop against the
    JAX script's (its kernel hop in the Pallas interpreter), float32."""
    jrh = jax_scripts["profile_ring_hop"]
    monkeypatch.setattr(ring_attention, "RING_QUERY_CHUNK", RING_CHUNK)
    args = profile_ring_hop.hop_inputs(RING_SHAPE, torch.float32, CPU)
    jargs = [jnp.asarray(a.numpy().copy()) for a in args]  # no buffer shared with torch
    jhop = {"xla": lambda *a: jrh.xla_hop(*a, chunk_q=RING_CHUNK), "pallas": jrh.pallas_hop}[hop]

    def loss(q, k, v):
        _, den, acc = jhop(q, k, v, *jargs[3:])
        out = acc / den[..., None]
        return 0.5 * jnp.sum(out ** 2), out

    with pltpu.force_tpu_interpret_mode():
        (_, want_o), want_g = jax.device_get(jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*jargs[:3]))  # done before the port runs
    port = profile_ring_hop.HOPS[hop]
    _close(profile_ring_hop.hop_output(port, args), want_o, 1e-5, "o")
    for name, g, w in zip("qkv", profile_ring_hop.hop_grads(port, args), want_g):
        assert torch.isfinite(g).all()
        _close(g, w, 1e-4, f"d{name}")


def test_ring_hop_check_holds_and_fails_a_dropped_key_tile(monkeypatch):
    args = profile_ring_hop.hop_inputs((1, 512, 256, 16, 128), torch.float32, CPU)
    check = profile_ring_hop.check_hops(args)
    assert check["excess"] <= 1 and all(check["grads_finite"].values())

    def dropped(q, k, v, *state):  # the kernel hop with its last 64 keys left out
        return ring_attention._pallas_hop(q, k[:, :-64], v[:, :-64], *state)

    monkeypatch.setitem(profile_ring_hop.HOPS, "pallas", dropped)
    with pytest.raises(AssertionError, match="disagrees"):
        profile_ring_hop.check_hops(args)


# ---- the decoder's convolutions ---------------------------------------------


def _jax_flops(in_shape, cout, kernel, strides, batch, transpose):
    """scripts/profile_decoder.py's count, as that file writes it."""
    cin = in_shape[-1]
    if transpose:
        out_sp = tuple(s * st for s, st in zip(in_shape[:-1], strides))
    else:
        out_sp = tuple(-(-s // st) for s, st in zip(in_shape[:-1], strides))
    flops_f = 2 * batch * int(np.prod(out_sp)) * int(np.prod(kernel)) * cin * cout
    if transpose:
        flops_f //= int(np.prod(strides))
        flops_f *= int(np.prod(strides))
    return flops_f


@pytest.mark.parametrize("site", profile_decoder.SITES, ids=lambda s: s[0].split()[0])
def test_decoder_site_matches_jax(jax_scripts, monkeypatch, site):
    """A small version of the site (odd spatial sizes, the site's kernel and
    strides): the JAX script's own conv body and its f+b, captured from its
    ``conv_site``, against the port's layer in float32; the draws equal.
    The FLOP count at full size equal to the JAX script's."""
    name, in_shape, cout, kernel, strides, transpose = site
    jpd = jax_scripts["profile_decoder"]
    captured = []
    monkeypatch.setattr(jpd, "scan_ms", lambda fn, x0, extra=(): captured.append(
        (fn, x0, extra)) or 1.0)
    small = (min(in_shape[0], 3), 5, 5, min(in_shape[3], 6))
    c_small = min(cout, 5)
    with contextlib.redirect_stdout(io.StringIO()):
        jpd.conv_site(name, small, c_small, kernel, strides, batch=2, transpose=transpose)
    (f, jx, (jw,)), (fb, _, _) = captured
    x, w = profile_decoder.site_arrays(small, c_small, kernel, batch=2)
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(np.asarray(jw, np.float32),
                                  np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32))
    x32, w32 = x.astype(np.float32), w.astype(np.float32)
    want_y = f(jnp.asarray(x32), jnp.asarray(w32))
    want_gx, want_gw = fb(jnp.asarray(x32), jnp.asarray(w32))

    layer = profile_decoder.site_layer(w32, strides, transpose, torch.float32, CPU)
    xt = torch.from_numpy(x32).permute(0, 4, 1, 2, 3).contiguous()
    _close(layer(xt).detach().permute(0, 2, 3, 4, 1), want_y, 1e-5, "y")
    dx, dw = profile_decoder.fwd_bwd(layer, xt)
    _close(dx.permute(0, 2, 3, 4, 1), want_gx, 1e-4, "dx")
    _close(dw, profile_decoder.layer_kernel(np.asarray(want_gw), transpose), 1e-4, "dw")
    assert profile_decoder.conv_flops(in_shape, cout, kernel, strides, 16, transpose) == \
        _jax_flops(in_shape, cout, kernel, strides, 16, transpose)


# ---- the encoder's stage-3 products -----------------------------------------


def test_encoder_micro_convs_match_jax(jax_scripts, monkeypatch):
    """The JAX script's micro_convs bodies (conv_s, its im2col product, the
    1x1x1 reduce), captured from its ``chained``, against the port's on the
    same draws in float32; the port's im2col held against its conv."""
    jpe = jax_scripts["profile_encoder"]
    captured = []
    monkeypatch.setattr(jpe, "chained", lambda f, x0, extra=(): captured.append(
        (f, x0, extra)) or 1.0)
    monkeypatch.setattr(jpe, "report", lambda *a: None)
    jpe.micro_convs(batch=1)
    xs, xin, w_s, w_r = (a.astype(np.float32) for a in profile_encoder.micro_arrays(1))
    for (_, jx, (jw,)), (x, w) in zip(captured, ((xs, w_s), (xs, w_s), (xin, w_r))):
        np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                      np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
        np.testing.assert_array_equal(np.asarray(jw, np.float32),
                                      np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32))
    (conv_s, _, _), (im2col, _, _), (reduce_conv, _, _) = captured
    want_conv = conv_s(jnp.asarray(w_s), jnp.asarray(xs))
    layer = profile_encoder.conv_s_layer(w_s, torch.float32, CPU)
    got_conv = layer(torch.from_numpy(xs).permute(0, 4, 1, 2, 3)).detach().permute(0, 2, 3, 4, 1)
    _close(got_conv, want_conv, 1e-5, "conv_s")
    got_im2col = profile_encoder.conv_s_im2col(torch.from_numpy(xs), torch.from_numpy(w_s))
    _close(got_im2col, im2col(jnp.asarray(w_s), jnp.asarray(xs)), 1e-5, "im2col")
    _close(torch.matmul(torch.from_numpy(xin), torch.from_numpy(w_r)),
           reduce_conv(jnp.asarray(w_r), jnp.asarray(xin)), 1e-5, "reduce")
    assert profile_encoder.hold_im2col(got_im2col, got_conv)["excess"] <= 1


def test_im2col_hold_fails_a_planted_fault():
    """bf16: the im2col product holds against cuDNN's conv; with its taps
    in the wrong order (the kernel flipped in W) it fails."""
    xs, _, w_s, _ = profile_encoder.micro_arrays(1)
    x = torch.from_numpy(xs).to(torch.bfloat16)
    w = torch.from_numpy(w_s).to(torch.bfloat16)
    conv = profile_encoder.conv_s_layer(w_s, torch.bfloat16, CPU)
    with torch.no_grad():
        want = conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert profile_encoder.hold_im2col(profile_encoder.conv_s_im2col(x, w), want)["excess"] <= 1
    with pytest.raises(AssertionError, match="disagrees"):
        profile_encoder.hold_im2col(profile_encoder.conv_s_im2col(x, w.flip(2)), want)


# ---- the step legs ------------------------------------------------------------

# The JAX script's name of each leg
JAX_LEG_NAMES = {"full": "full", "no_sa": "no_sa", "no_dropout": "no_dropout",
                 "no_opt": "no_optimizer", "fwd": "fwd_only", "stage1_thin": "stage1_thin (3->1)",
                 "stage2_thin": "stage2_thin (8->2)", "stage3_thin": "stage3_thin (36->12)"}
FIELDS = ("decoder", "decoder_kwargs", "norm_mode", "backbone_cbam", "stages", "stem_features",
          "dropout_rate")


@pytest.fixture(scope="module")
def jax_legs(jax_scripts):
    """leg -> (the model JAX's profile_step builds, whether its step runs the
    optimizer (None: the forward alone)), from its ``main`` with every leg
    named and its timers replaced by a recorder."""
    jps = jax_scripts["profile_step"]
    seen = {}
    saved = jps.timed, jps.fwd_only, sys.argv
    jps.timed = lambda name, model, optimizer=True: seen.__setitem__(name, (model, optimizer))
    jps.fwd_only = lambda model: seen.__setitem__("fwd_only", (model, None))
    sys.argv = ["profile_step.py", *JAX_LEG_NAMES, "no_opt"]
    try:
        jps.main()
    finally:
        jps.timed, jps.fwd_only, sys.argv = saved
    return {leg: seen[jname] for leg, jname in JAX_LEG_NAMES.items()}


def _port_fields(config: dict) -> dict:
    defaults = {k: v.default for k, v in inspect.signature(P3DSaliency).parameters.items()}
    got = {k: config.get(k, defaults[k]) for k in FIELDS}
    got["decoder_kwargs"] = got["decoder_kwargs"] or {}
    return got


def _jax_fields(model) -> dict:
    got = {k: getattr(model, k) for k in FIELDS}
    got["decoder_kwargs"] = dict(got["decoder_kwargs"] or {})
    return got


@pytest.mark.parametrize("leg", list(profile_step.LEGS))
def test_step_leg_matches_jax_constructor(jax_legs, leg):
    jmodel, optimizer = jax_legs[leg]
    assert _port_fields(profile_step.model_config(*profile_step.LEGS[leg])) == \
        _jax_fields(jmodel)
    mode = profile_step.MODES.get(leg, "train")
    assert mode == {True: "train", False: "no_optimizer", None: "forward"}[optimizer]
    assert jnp.dtype(jmodel.dtype) == jnp.bfloat16


@pytest.mark.parametrize("leg", list(profile_gn.LEGS))
def test_gn_leg_matches_jax_constructor(jax_scripts, leg):
    jpg = jax_scripts["profile_gn"]
    assert set(profile_gn.LEGS) == set(jpg.LEGS) and profile_gn.GN_WD == jpg.GN_WD
    jmodel = jpg.LEGS[leg]()
    assert _port_fields(profile_step.model_config(*profile_gn.LEGS[leg])) == _jax_fields(jmodel)


def test_stage3_thin_parameters_at_full_width_match_jax(jax_legs):
    """Every parameter of the stage3_thin leg's model at full width, the
    port's on the meta device against ``jax.eval_shape`` of JAX's init."""
    jmodel, _ = jax_legs["stage3_thin"]
    abstract = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 112, 112, 3)), train=False))
    want = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(abstract[col])[0]:
            p = "/".join(k.key for k in path)
            want[p.replace("/", ".")] = convert_leaf(p, np.broadcast_to(np.float32(0),
                                                                        leaf.shape)).shape
    with torch.device("meta"):
        tm = P3DSaliency(**profile_step.model_config(*profile_step.LEGS["stage3_thin"]))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    assert sum(1 for k in want if ".stage3_block" in k and k.endswith("reduce.kernel")) == 12


def test_no_opt_leg_matches_jax_and_moves_no_parameter(jax_scripts):
    """p3d_micro_sa in float32 at dropout 0 on one batch: the port's
    no-optimizer step's loss against JAX's ``make_step(model,
    optimizer=False)``; every parameter has its gradient and none moved."""
    jps = jax_scripts["profile_step"]
    shape = (2, 16, 16, 16, 3)  # 16 px: JAX's compile of the step is most of the time
    _, variables, tm = build_pair("p3d_micro_sa", shape, seed=3)
    jm = jreg.build_model("p3d_micro_sa", dropout_rate=0.0)
    rng = np.random.default_rng(4)
    frames = rng.normal(size=shape).astype(np.float32) * 0.5
    targets = rng.uniform(size=shape[:4]).astype(np.float32)
    # the step without the optimizer reads no optimizer state
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=None,
                           tx=jax_make_optimizer(1e-4))
    _, want = jps.make_step(jm, optimizer=False)(jstate, jnp.asarray(frames),
                                                  jnp.asarray(targets), jax.random.PRNGKey(1))

    port = treg.build_model("p3d_micro_sa", device="cpu", dropout_rate=0.0)
    port.load_state_dict(tm.state_dict())
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    loss = profile_step.make_step(create_train_state(port), "no_optimizer")(
        torch.from_numpy(frames), torch.from_numpy(targets))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for n, p in port.named_parameters():
        assert p.grad is not None, n
        assert torch.equal(p.detach(), before[n]), n


def test_leg_launch_hold_fails_a_wrong_count(monkeypatch):
    """A leg whose counted launches differ from its routes' raises; on the
    CPU the routes give none (the wrappers run their plain versions)."""
    monkeypatch.setattr(profile_step, "BATCH", 1)
    monkeypatch.setattr(profile_step, "SIZE", 32)
    data = profile_step.data(CPU)
    config = profile_step.model_config("p3d_micro_sa", {})
    row = profile_step.time_leg("micro", config, CPU, 1, data, "forward")
    assert row["kernel_sites"] == 2 and row["launches_per_step"]["B1"] == 0
    monkeypatch.setattr(_timing, "launches_since", lambda before: {"B1": 1, "B2": 0, "B3": 0,
                                                                   "B4": 0})
    with pytest.raises(AssertionError, match="launches per step"):
        profile_step.time_leg("micro", config, CPU, 1, data, "forward")


def test_profile_step_runs_full_again_last(monkeypatch, capsys):
    """Legs in the order asked, then ``full`` again (the drift control),
    each with its mode; the last line is the returned readings."""
    monkeypatch.setattr(profile_step, "BATCH", 1)
    monkeypatch.setattr(profile_step, "SIZE", 16)
    monkeypatch.setattr(profile_step, "LEGS", {"full": ("p3d_micro", {}),
                                               "fwd": ("p3d_micro", {})})
    out = profile_step.main(["fwd", "full", "--device", "cpu", "--repeats", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert list(out["legs"]) == ["fwd", "full", "full_again"]
    assert [row["mode"] for row in out["legs"].values()] == ["forward", "train", "train"]


def test_profile_gn_runs_every_leg_then_raises_for_a_failed_one(monkeypatch, capsys):
    monkeypatch.setattr(profile_step, "BATCH", 1)
    monkeypatch.setattr(profile_step, "SIZE", 16)
    monkeypatch.setattr(profile_gn, "LEGS", {
        "broken": ("p3d_micro", dict(decoder="no_such_decoder")),
        "micro": ("p3d_micro", {})})
    with pytest.raises(RuntimeError, match="broken"):
        profile_gn.main(["--device", "cpu", "--repeats", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last["legs"]) == {"micro"} and set(last["failed"]) == {"broken"}


# ---- profile_attention --------------------------------------------------------


def test_attention_holds_pass_and_fail_a_dropped_key_tile(monkeypatch):
    """At a small site both routes take the kernels; the holds pass on the
    plain versions (the CPU) and fail when B1 drops its last 64 keys."""
    timer = _timing.Timer(CPU)
    rng = np.random.default_rng(0)
    row = profile_attention.profile_site(timer, rng, "small", (4, 16, 16), 64, True, 2, 1)
    assert row["routes"] == {"forward": "flash", "train": "flash"}
    assert len(row["holds"]) == 6 and all(h["excess"] <= 1 for h in row["holds"].values())
    assert set(row["forward_ms"]) == set(row["fwd_bwd_ms"]) == {"kernel", "plain"}
    q, k, v = profile_attention.site_inputs(rng, (4, 16, 16), 64, False, 2, torch.bfloat16, CPU)
    monkeypatch.setattr(fa, "flash_attend_tokens",
                        lambda q, k, v: fa.flash_attend_tokens_reference(q, k[:, :-64], v[:, :-64]))
    with pytest.raises(AssertionError, match="B1 o"):
        profile_attention.hold_kernels("small", q, k, v, row["routes"])


def test_attention_plain_site_times_the_plain_path_alone():
    row = profile_attention.profile_site(_timing.Timer(CPU), np.random.default_rng(0),
                                         "x_4_0", (1, 7, 7), 1024, False, 1, 1)
    assert row["routes"] == {"forward": "plain", "train": "plain"} and "holds" not in row
    assert set(row["forward_ms"]) == set(row["fwd_bwd_ms"]) == {"plain"}


# ---- the bench scripts ---------------------------------------------------------


def test_bench_eval_tree_matches_jax(jax_scripts, tmp_path):
    jax_scripts["bench_eval"].make_tree(tmp_path / "jax", 2, 3, (24, 32))
    bench_eval.make_tree(tmp_path / "port", 2, 3, (24, 32))
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert len(files) == 18
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.*"))
    for f in files:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / f), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED))


def test_bench_eval_runs_on_the_cpu_and_holds_the_means(capsys):
    out = bench_eval.main(["--device", "cpu", "--videos", "2", "--frames", "3", "--size", "24",
                           "32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert set(out["runs"]) == {"workers=1", "workers=auto", "cpu (warmup)", "cpu",
                                "dense-gt host workers=auto", "dense-gt cpu (warmup)",
                                "dense-gt cpu"}
    assert set(out["card_minus_host"]) == {"fixations", "dense"}
    _timing.finite_times(out)
    with pytest.raises(AssertionError, match="not the host's"):
        bench_eval.hold_means("planted", {"cc": 0.5, "sim": 0.5}, {"cc": 0.5, "sim": 0.51})


def _json_keys_of(path: Path) -> set:
    """The keys of the dict literal that the file passes to json.dumps."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" \
                and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps of a dict literal in {path}")


def test_bench_cli_eval_keys_are_jax_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench_cli_eval, "IMAGE_SIZE", 32)
    out = bench_cli_eval.main(["--device", "cpu", "--videos", "1", "--frames", "28", "--size",
                               "32", "24", "--batch", "1", "--structure", "p3d_micro"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    want = _json_keys_of(REPO / "scripts" / "bench_cli_eval.py") - {"platform"}
    assert set(out) == want | {"card", "device", "script"}
    assert out["clips_scored"] == 2 and out["card"]["name"] == "cpu"


def test_bench_export_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench_export, "MODEL", "p3d_micro")
    monkeypatch.setattr(bench_export, "IMAGE_SIZE", 32)
    monkeypatch.setattr(bench_export, "BATCH_WINDOWS", 4)
    monkeypatch.setenv("BENCH_EXPORT_VIDEOS", "2")
    monkeypatch.setenv("BENCH_EXPORT_FRAMES", "16")
    out = bench_export.main(["--device", "cpu"])
    assert set(out) == {"script", "device", "card", "structure", "dtype", "videos",
                        "frames_per_video", "exported", "seconds_s", "frames_per_s", "launches"}
    assert out["exported"] == 2 and out["launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0}


def test_bench_loader_matches_jax(monkeypatch, capsys):
    """The root bench_loader.py and the port's on one tiny tree: the same
    keys (and the card's) and the same clip count."""
    jbl = jax_script(REPO / "bench_loader.py")
    orig = jbl.make_synthetic_dataset
    monkeypatch.setattr(jbl, "make_synthetic_dataset", lambda root, **kw: orig(
        root, num_videos=1, frames_per_video=30, size=(64, 48)))
    jbl.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(bench_loader, "VIDEOS", 1)
    monkeypatch.setattr(bench_loader, "FRAMES", 30)
    monkeypatch.setattr(bench_loader, "SIZE", (64, 48))
    got = bench_loader.main(["--device", "cpu"])
    assert set(got) == set(want) | {"card", "device", "script"}
    assert got["n_clips"] == want["n_clips"] == 4


# ---- every script ----------------------------------------------------------------


# ---- the transposed-conv scripts ---------------------------------------------


@pytest.fixture(scope="module")
def tconv_captures():
    """Each JAX tconv script's main at batch 1 with its ``chained_time``
    replaced: the labels it prints, and the functions and inputs it would
    time, in order."""
    out = {}
    for name in ("profile_tconv", "profile_tconv2", "profile_tconv3"):
        mod = jax_script(REPO / "scripts" / f"{name}.py")
        mod.B = 1
        calls = []

        def stub(fn, *args, calls=calls, **_):
            calls.append((fn, args))
            return 1.0

        mod.chained_time = stub
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        labels = [line.rsplit(" ms", 1)[0].rsplit(None, 1)[0].strip()
                  for line in buf.getvalue().splitlines() if " ms" in line]
        out[name] = dict(labels=[lb.removesuffix(" f+b").strip() for lb in labels],
                         calls=calls)
    return out


def _closure(fn) -> dict:
    """The free variables of a jitted (or grad-wrapped) JAX function's body."""
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    names = inspect.getclosurevars(fn).nonlocals
    return _closure(names["fun"]) if set(names) == {"fun"} else names


def _ndhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(0, 2, 3, 4, 1)


def test_tconv_script_cases_match_jax(tconv_captures):
    """Each case on a small input, with the JAX script's own weights in the
    port's layers, against the JAX function, float32; the labels are the
    JAX script's."""
    cap = tconv_captures["profile_tconv"]
    assert cap["labels"] == list(profile_tconv.LABELS.values())
    mods = profile_tconv.layers(torch.float32, CPU)
    names = {"tconv": "vt", "dense": "vb", "packed": "vp"}
    rng = np.random.default_rng(0)
    xs = {"tconv": rng.normal(size=(1, 2, 5, 6, 256)), "dense": rng.normal(size=(1, 3, 5, 6, 256))}
    xs["packed"] = xs["tconv"]
    for (fn, _), (case, var) in zip(cap["calls"], names.items()):
        w = np.asarray(_closure(fn)[var]["params"]["kernel"])
        with torch.no_grad():
            mods[case].kernel.copy_(torch.from_numpy(np.ascontiguousarray(
                convert_leaf(("x_0_1" if case == "tconv" else "c") + "/kernel", w))))
        want = np.asarray(fn(jnp.asarray(xs[case], jnp.float32)))
        x = torch.from_numpy(xs[case].transpose(0, 4, 1, 2, 3)).float()
        got = _ndhwc(profile_tconv.cases(mods, x, x)[case]())
        _close(got[..., :want.shape[-1]], want, 1e-5, case)  # JAX slices to 256 channels


def test_tconv2_script_gradients_match_jax(tconv_captures):
    cap = tconv_captures["profile_tconv2"]
    assert cap["labels"] == list(profile_tconv2.LABELS)
    mods = profile_tconv.layers(torch.float32, CPU)
    fns = [fn for fn, _ in cap["calls"]]
    for var, case in (("vt", "tconv"), ("vp", "packed")):
        owner = fns[0] if case == "tconv" else fns[1]
        w = np.asarray(_closure(owner)[var]["params"]["kernel"])
        with torch.no_grad():
            mods[case].kernel.copy_(torch.from_numpy(np.ascontiguousarray(
                convert_leaf(("x_0_1" if case == "tconv" else "c") + "/kernel", w))))
    x = np.random.default_rng(1).normal(size=(1, 2, 5, 6, 256))
    for fn, (label, loss) in zip(fns, profile_tconv2.losses(mods).items()):
        want = np.asarray(fn(jnp.asarray(x, jnp.float32)))
        got = profile_tconv2.input_grad(loss, torch.from_numpy(x.transpose(0, 4, 1, 2, 3)).float())
        _close(_ndhwc(got), want, 1e-5, label)


def test_tconv3_script_variants_match_jax(tconv_captures, monkeypatch):
    """The six variants on a small input with the JAX script's weights,
    against its functions: those take bf16 and round their outputs (and
    the affine's product and sum) to bf16, the port computes in float32 on
    the same bf16 values, so the hold is 2^-6 of the output's largest
    value.  The draws at batch 1 are the JAX script's."""
    cap = tconv_captures["profile_tconv3"]
    assert cap["labels"] == list(profile_tconv3.LABELS)
    got_arrays = profile_tconv3.arrays(1)
    free = {}
    for i in (0, 1, 3):  # A's kernel, B's packed kernel, D's affine
        free.update(_closure(cap["calls"][i][0]))
    for k in ("w_t", "w_p", "scale", "shift"):  # the JAX script holds them in bf16
        _close(np.asarray(free[k], np.float32), got_arrays[k], 2.0 ** -8, k)
    _close(np.asarray(cap["calls"][0][1][0], np.float32), got_arrays["x"], 2.0 ** -8, "x")
    x = np.random.default_rng(2).normal(size=(1, 2, 5, 6, 256)).astype(jnp.bfloat16).astype(
        np.float32)
    a = {k: np.asarray(free[k], np.float32) for k in ("w_t", "w_p", "scale", "shift")}
    fns = profile_tconv3.variants(profile_tconv3.tensors(dict(a, x=x), torch.float32, CPU))
    assert list(fns) == list(profile_tconv3.LABELS)
    for (fn, _), (label, port) in zip(cap["calls"], fns.items()):
        want = np.asarray(fn(jnp.asarray(x, jnp.bfloat16)), np.float32)
        _close(_ndhwc(port()), want, 2.0 ** -6, label)


@pytest.mark.parametrize("script", [profile_tconv, profile_tconv2, profile_tconv3],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tconv_scripts_run_on_the_cpu_with_the_jax_fields(script, tconv_captures, monkeypatch,
                                                          capsys):
    """At a tiny size on the CPU, each script's JSON names its cases by the
    labels its JAX counterpart prints, with a finite positive time each."""
    for mod in (profile_tconv, profile_tconv3):
        monkeypatch.setattr(mod, "CIN", 8)
        monkeypatch.setattr(mod, "COUT", 4)
        monkeypatch.setattr(mod, "SMALL", (2, 4, 4))
    monkeypatch.setattr(profile_tconv, "BIG", (4, 8, 8))
    monkeypatch.setattr(script, "BATCH", 1)
    out = script.main(["--device", "cpu", "--repeats", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert list(out["cases"]) == tconv_captures[script.__name__.rsplit(".", 1)[-1]]["labels"]
    _timing.finite_times(out)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_defaults_to_cuda_and_raises_without_a_gpu(script):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        script.main([])


@pytest.mark.parametrize("script", [time_flash_forward, time_flash_backward, train_step_spread],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_timing_scripts_share_card_line(script):
    assert script.card_line is _timing.card_line


def test_script_runs_by_path_and_imports_its_root(tmp_path):
    """Run by its path, a script imports the checkout of ``--root`` (its own
    by default) and prints its JSON last; in a process that imported
    another checkout, asking for a root raises."""
    path = REPO / "sap3d_tpu_torch" / "scripts" / "bench_eval.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(path), "--device", "cpu", "--videos", "1",
                          "--frames", "2", "--size", "24", "32"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["card"]["name"] == "cpu"
    with pytest.raises(SystemExit, match="not the checkout"):
        _timing.import_root(str(tmp_path))
    sys.path.remove(str(tmp_path))


def test_timer_alternates_and_finite_times_catches_a_bad_time():
    calls = []
    timer = _timing.Timer(CPU)
    out = timer.alternating({"a": lambda: calls.append("a"), "b": lambda: calls.append("b")}, 1)
    assert calls == ["a", "a", "b", "b", "b", "b", "a", "a"] and set(out) == {"a", "b"}
    _timing.finite_times({"x_ms": {"kernel": 1.0}, "n": 0, "steady_frames_per_sec": None})
    for bad in ({"x_ms": {"kernel": 0.0}}, {"legs": [{"ms": float("nan")}]}, {"e2e_s": -1.0}):
        with pytest.raises(AssertionError, match="finite positive"):
            _timing.finite_times(bad)
