"""Parity of the port's layout rewrites with the JAX package's, on the CPU.

Each rewrite (``ops/concat_split.py``, ``ops/conv2d_path.py``,
``ops/fast_tconv.py``, ``ops/stem_s2d.py``, ``SAP3D_ATTN_PROJ`` in
``ops/attention.py``, the phase loss in ``train/steps.py``) against its JAX
counterpart, on inputs made with numpy from a seed; then the micro UNet++ SA
model with all six variables set against the JAX micro model with the same
variables, forward and one train step's gradient (one JAX compile); then
composition: the variables on a time-sharded step against the unsharded
step in float64, and what raises.

Tolerances (float32 unless stated):

* ``ATOL`` 1e-4 absolute on O(1) outputs of one layer, and of the largest
  value of a kernel's gradient: both sides compute in float32 and add up to
  a few thousand products in different orders (read: at most 1.9e-6, and
  3.9e-7 of a kernel gradient's largest value).
* ``BF16_TOL``: the self-attention block in bfloat16 against JAX's,
  3e-2 of the output's largest value: both sides round the projections,
  the scores' inputs, the probabilities and the output conv to bfloat16,
  in different places of their sums (read: 4.4e-3 "separate", 5.4e-4 in
  the fused modes).
* The micro model: the eval forward within ``EVAL_ATOL`` 2e-5
  (tests/test_torch_ring.py's limit for this model; read 1.8e-7); the
  train step's loss within 1e-5 relative (read 1.6e-7) and its gradient
  within ``_torch_parity``'s ``GRAD_TOL``/``GRAD_FLOOR`` (the micro model's
  train-mode gradient is ill-conditioned in float32, the reasons are there;
  read: the whole gradient 1.25e-2, the worst tensor 0.47 of its limit).
* Float64 composition: ``REL_TOL`` 1e-10 of each tensor's largest value
  (tests/test_torch_time_shard.py's limit), gradients that are zero but for
  rounding against ``FLOOR`` times the call's largest.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import GRAD_TOL, MICRO, build_micro_pair, grad_distance
from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.ops import attention as ja
from sap3d_tpu.ops import concat_split as jcs
from sap3d_tpu.ops import conv2d_path as jc2
from sap3d_tpu.ops import fast_tconv as jft
from sap3d_tpu.ops import stem_s2d as jss
from sap3d_tpu.train.steps import loss_fn_saliency as jax_loss
from sap3d_tpu_torch.core.mesh import make_time_mesh, time_shard_batch
from sap3d_tpu_torch.interop.flax_bridge import convert_leaf, state_dict_from_flax
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.models.p3d import P3DSaliency
from sap3d_tpu_torch.ops import attention as ta
from sap3d_tpu_torch.ops import concat_split as tcs
from sap3d_tpu_torch.ops import conv2d_path as tc2
from sap3d_tpu_torch.ops import fast_tconv as tft
from sap3d_tpu_torch.ops import layers as tl
from sap3d_tpu_torch.ops import stem_s2d as tss
from sap3d_tpu_torch.ops.time_shard import gather
from sap3d_tpu_torch.train.steps import loss_fn_saliency

ATOL = 1e-4
BF16_TOL = 3e-2
EVAL_ATOL = 2e-5
REL_TOL, FLOOR = 1e-10, 1e-3
F64 = torch.float64
# Every variable set: the JAX package reads the same names
ALL_FLAGS = dict(SAP3D_CONCAT_SPLIT="1", SAP3D_HEAD_PHASE_LOSS="1", SAP3D_CONV3D_VIA_2D="1",
                 SAP3D_STEM_S2D="1", SAP3D_HEAD_TCONV_PS="1", SAP3D_ATTN_PROJ="fused")


def _t(x):  # NDHWC numpy -> NCDHW torch
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 4, 1, 2, 3)))


def _np(y):  # NCDHW torch -> NDHWC numpy
    return y.detach().numpy().transpose(0, 2, 3, 4, 1)


def _conv_kernel(w):  # flax DHWIO -> the port's Conv3d [out, in, kd, kh, kw]
    return torch.from_numpy(np.ascontiguousarray(convert_leaf("c/kernel", w)))


def _tconv_kernel(w):  # flax DHWIO -> the port's ConvTranspose3d (flipped, [in, out, ...])
    return torch.from_numpy(np.ascontiguousarray(convert_leaf("x_0_1/kernel", w)))


def _normal(rng, shape, fan_in=None):
    a = rng.normal(size=shape)
    return (a / np.sqrt(fan_in) if fan_in else a).astype(np.float32)


# ---- concat split -------------------------------------------------------------


@pytest.mark.parametrize("widths", [(64, 128), (128, 128)], ids=["64-128", "128-128"])
@pytest.mark.parametrize("kd,strides", [(3, (1, 1, 1)), (1, (1, 1, 1)), (3, (1, 2, 2)),
                                        (1, (2, 2, 2))], ids=["k3s1", "k1s1", "k3s122", "k1s2"])
def test_concat_split_matches_jax(widths, kd, strides):
    rng = np.random.default_rng(0)
    parts = [_normal(rng, (2, 4, 6, 6, c)) for c in widths]
    k = (kd, 3, 3)
    w = _normal(rng, (*k, sum(widths), 16), fan_in=int(np.prod(k)) * sum(widths))
    b = _normal(rng, (16,))
    want = jcs.conv3d_concat_split([jnp.asarray(p) for p in parts], jnp.asarray(w),
                                   jnp.asarray(b), strides)
    got = tcs.conv3d_concat_split([_t(p) for p in parts], _conv_kernel(w), torch.from_numpy(b),
                                  strides)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    # and the port's eager conv of the concat (the default path)
    layer = tl.Conv3d(sum(widths), 16, k, strides)
    with torch.no_grad():
        layer.kernel.copy_(_conv_kernel(w))
        layer.bias.copy_(torch.from_numpy(b))
        eager = layer(torch.cat([_t(p) for p in parts], 1))
    np.testing.assert_allclose(_np(got), _np(eager), atol=ATOL)


def test_concat_split_composes_with_via_2d_and_rejects_a_mismatch():
    rng = np.random.default_rng(1)
    parts = [_normal(rng, (1, 4, 5, 5, c)) for c in (8, 12)]
    w = _normal(rng, (3, 3, 3, 20, 6), fan_in=540)
    want = jcs.conv3d_concat_split([jnp.asarray(p) for p in parts], jnp.asarray(w), None)
    got = tcs.conv3d_concat_split([_t(p) for p in parts], _conv_kernel(w), None, via_2d=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="input channels"):
        tcs.conv3d_concat_split([_t(p) for p in parts[:1]], _conv_kernel(w), None)


def test_eager_sites_opt_out_per_site(monkeypatch):
    """``SAP3D_CONCAT_EAGER_SITES`` names the sites that stay eager, as the
    JAX reader parses it; the layer's output is the same either way."""
    monkeypatch.setenv("SAP3D_CONCAT_SPLIT", "1")
    monkeypatch.setenv("SAP3D_CONCAT_EAGER_SITES", " x_1_1, x_2_1 ,")
    assert tcs.eager_concat_sites() == jcs.eager_concat_sites() == {"x_1_1", "x_2_1"}
    torch.manual_seed(0)
    eager = tcs.conv_norm_relu(12, 8, site="x_1_1").eval()
    split = tcs.conv_norm_relu(12, 8, site="x_1_2").eval()
    assert eager.split_conv is None and split.split_conv is not None
    split.load_state_dict(eager.state_dict())
    rng = np.random.default_rng(2)
    parts = (_t(_normal(rng, (1, 4, 6, 6, 4))), _t(_normal(rng, (1, 4, 6, 6, 8))))
    with torch.no_grad():
        np.testing.assert_allclose(_np(split(parts)), _np(eager(parts)), atol=ATOL)
    model = P3DSaliency(**MICRO, decoder_kwargs=dict(attention="sa", head="ds"))
    split_sites = {n for n in ("x_3_1", "x_2_1", "x_2_2", "x_1_1", "x_1_2", "x_1_3")
                   if getattr(model.decoder, n).split_conv is not None}
    assert split_sites == {"x_3_1", "x_2_2", "x_1_2", "x_1_3"}
    monkeypatch.delenv("SAP3D_CONCAT_SPLIT")
    assert not tcs.concat_split_enabled() and jcs.concat_split_enabled()  # the defaults differ


# ---- the 2-D conv path ------------------------------------------------------------


@pytest.mark.parametrize("kd,kh,strides,d", [(3, 3, (1, 1, 1), 4), (2, 3, (1, 1, 1), 2),
                                             (1, 3, (1, 2, 2), 4), (3, 1, (1, 1, 1), 3)],
                         ids=["k333", "k233", "k133s2", "k311"])
def test_conv3d_via_2d_matches_jax(kd, kh, strides, d):
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, d, 7, 6, 5))
    w = _normal(rng, (kd, kh, kh, 5, 4), fan_in=kd * kh * kh * 5)
    b = _normal(rng, (4,))
    want = jc2.conv3d_via_2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), strides)
    got = tc2.conv3d_via_2d(_t(x), _conv_kernel(w), torch.from_numpy(b), strides)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="temporal stride"):
        tc2.conv3d_via_2d(_t(x), _conv_kernel(w), None, (2, 1, 1))


def test_conv_norm_relu_takes_the_2d_path_under_its_flag(monkeypatch):
    monkeypatch.setenv("SAP3D_CONV3D_VIA_2D", "1")
    torch.manual_seed(1)
    via = tcs.conv_norm_relu(6, 4).eval()
    strided = tcs.conv_norm_relu(6, 4, strides=(2, 1, 1))
    assert type(via.Conv_0) is tc2.Conv3dVia2D and type(strided.Conv_0) is tl.Conv3d
    monkeypatch.delenv("SAP3D_CONV3D_VIA_2D")
    plain = tcs.conv_norm_relu(6, 4).eval()
    plain.load_state_dict(via.state_dict())
    x = torch.randn(1, 6, 4, 5, 5)
    with torch.no_grad():
        np.testing.assert_allclose(_np(via(x)), _np(plain(x)), atol=ATOL)


# ---- the phase transposed conv ---------------------------------------------------


@pytest.mark.parametrize("strides", [(2, 2, 2), (1, 2, 2)], ids=["s222", "s122"])
def test_phase_tconv_forward_and_gradient_match_jax(strides):
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, 3, 5, 4, 6))
    w = _normal(rng, (3, 3, 3, 6, 3), fan_in=27 * 6)
    dy = _normal(rng, (2, 3 * strides[0], 5 * strides[1], 4 * strides[2], 3))
    want, vjp = jax.vjp(lambda a, k: jft._phase_tconv(a, k, strides), jnp.asarray(x),
                        jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt = _t(x).requires_grad_()
    kt = _tconv_kernel(w).requires_grad_()
    got = tft.phase_tconv(xt, kt, strides)
    dx, dk = torch.autograd.grad(got, (xt, kt), _t(dy))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(_np(dx), np.asarray(want_dx), atol=ATOL)
    want_dk = convert_leaf("x_0_1/kernel", np.asarray(want_dw))
    np.testing.assert_allclose(dk.numpy(), want_dk, atol=ATOL * np.abs(want_dk).max())
    # the phases before their interleave, and the port's plain transposed conv
    pre = tft.phase_tconv_pre_interleave(_t(x), _tconv_kernel(w), strides)
    np.testing.assert_allclose(
        _np(pre), np.asarray(jft.phase_tconv_pre_interleave(jnp.asarray(x), jnp.asarray(w),
                                                            strides)), atol=ATOL)
    plain = tl.ConvTranspose3d(6, 3, 3, strides, use_bias=False)
    with torch.no_grad():
        plain.kernel.copy_(_tconv_kernel(w))
        np.testing.assert_allclose(_np(got), _np(plain(_t(x))), atol=ATOL)


def test_fast_conv_transpose_and_phase_head_match_jax():
    rng = np.random.default_rng(5)
    x = _normal(rng, (1, 4, 6, 6, 8))
    w = _normal(rng, (3, 3, 3, 8, 1), fan_in=216)
    b = _normal(rng, (1,))
    variables = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    want = jft.FastConvTranspose(1, (3, 3, 3), (2, 2, 2)).apply(variables, jnp.asarray(x))
    want_phase = jft.PhaseHeadTConv(1, (3, 3, 3), (2, 2, 2)).apply(variables, jnp.asarray(x))
    fast = tft.FastConvTranspose(8, 1, 3, 2)
    head = tft.PhaseHeadTConv(8, 1, 3, 2).train()
    for m in (fast, head):
        m.load_state_dict({"kernel": _tconv_kernel(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        np.testing.assert_allclose(_np(fast(_t(x))), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(_np(head(_t(x))), np.asarray(want_phase), atol=ATOL)
        np.testing.assert_allclose(_np(head.eval()(_t(x))), np.asarray(want), atol=ATOL)


def test_space_to_depth3d_matches_jax():
    t = np.random.default_rng(6).uniform(size=(2, 6, 8, 4)).astype(np.float32)
    for strides in ((2, 2, 2), (1, 2, 2), (3, 2, 1)):
        np.testing.assert_array_equal(
            tft.space_to_depth3d(torch.from_numpy(t), strides).numpy(),
            np.asarray(jft.space_to_depth3d(jnp.asarray(t), strides)))


def test_phase_loss_and_its_gradient_match_jax():
    """An 8-channel prediction against the space-to-depth'd target: the
    JAX loss, and the interleaved loss of the same terms."""
    rng = np.random.default_rng(7)
    pred = rng.uniform(-1.0, 3.0, size=(2, 2, 4, 4, 8)).astype(np.float32)
    target = rng.uniform(size=(2, 4, 8, 8)).astype(np.float32)
    want, g = jax.value_and_grad(jax_loss)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    got = loss_fn_saliency(p, torch.from_numpy(target))
    (dp,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(dp.numpy(), np.asarray(g), atol=1e-6)
    # the same terms as the interleaved layout's
    inter = tft._interleave(torch.from_numpy(pred).permute(0, 4, 1, 2, 3), (2, 2, 2), 1)
    np.testing.assert_allclose(loss_fn_saliency(inter.permute(0, 2, 3, 4, 1),
                                                torch.from_numpy(target)).item(),
                               got.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="phase-layout"):
        loss_fn_saliency(p, torch.from_numpy(target[:, :2]))


# ---- the space-to-depth stem ------------------------------------------------------


@pytest.mark.parametrize("k", [7, 3])
def test_stem_s2d_matches_jax(k):
    assert tss._dim_pads(7) == (2, 4) and tl.same_pads(112, 7, 2) == (2, 3)
    assert tss._dim_pads(k)[0] == tl.same_pads(16, k, 2)[0] == jss._dim_pads(k)[0]
    rng = np.random.default_rng(8)
    x = _normal(rng, (2, 2, 16, 12, 3))
    w = _normal(rng, (1, k, k, 3, 8), fan_in=k * k * 3)
    dy = _normal(rng, (2, 2, 8, 6, 8))
    want, vjp = jax.vjp(jss.conv_stem_s2d, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt, kt = _t(x).requires_grad_(), _conv_kernel(w).requires_grad_()
    got = tss.conv_stem_s2d(xt, kt)
    dx, dk = torch.autograd.grad(got, (xt, kt), _t(dy))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(_np(dx), np.asarray(want_dx), atol=ATOL)
    want_dk = convert_leaf("c/kernel", np.asarray(want_dw))
    np.testing.assert_allclose(dk.numpy(), want_dk, atol=ATOL * np.abs(want_dk).max())
    stem = tss.StemConv(3, 8, k, s2d=True)
    plain = tl.Conv3d(3, 8, (1, k, k), (1, 2, 2), use_bias=False)
    stem.load_state_dict({"kernel": _conv_kernel(w)})
    plain.load_state_dict(stem.state_dict())
    odd = _t(_normal(rng, (1, 2, 15, 12, 3)))  # odd H: the plain conv
    with torch.no_grad():
        for a in (_t(x), odd):
            np.testing.assert_allclose(_np(stem(a)), _np(plain(a)), atol=ATOL)
    with pytest.raises(ValueError, match="even"):
        tss.conv_stem_s2d(odd, _conv_kernel(w))


# ---- the attention projections ------------------------------------------------------


@pytest.mark.parametrize("mode", ta.PROJ_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_projections_match_jax(mode, dtype, monkeypatch):
    monkeypatch.setenv("SAP3D_ATTN_PROJ", mode)
    rng = np.random.default_rng(9)
    c = 16
    x = rng.normal(size=(2, 2, 12, 12, c)).astype(np.float32)
    fm = ja.SelfAttention3D(use_pallas=False, dtype=getattr(jnp, dtype))
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    params["gamma"] = np.array([0.7], np.float32)
    for name in ("f", "g", "h"):
        params[name]["bias"] = _normal(rng, params[name]["bias"].shape)
    stats = {"Norm_0": {"BatchNorm_0": {"mean": _normal(rng, (c,)) * 0.1,
                                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}}
    want = np.asarray(fm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=False), np.float32)
    tm = ta.SelfAttention3D(c, dtype=getattr(torch, dtype)).eval()
    assert tm.proj_mode == mode
    tm.load_state_dict(state_dict_from_flax(params, stats, model=tm), strict=True)
    with torch.inference_mode():
        got = _np(tm(_t(x)).float())
    tol = ATOL if dtype == "float32" else BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol)


def test_unknown_projection_mode_and_the_model_mesh_raise(monkeypatch):
    monkeypatch.setenv("SAP3D_ATTN_PROJ", "fused_fp8")
    with pytest.raises(ValueError, match="SAP3D_ATTN_PROJ"):
        ta.SelfAttention3D(16)
    monkeypatch.setenv("SAP3D_ATTN_PROJ", "fused")
    sa = ta.SelfAttention3D(16)
    sa.h.model_group = object()  # as core/sharding_rules.apply_state_sharding leaves it
    with pytest.raises(ValueError, match="SAP3D_ATTN_PROJ=fused on a model mesh"):
        sa(torch.randn(1, 16, 2, 4, 4))


# ---- the micro model with every variable set ----------------------------------------


SHAPE = (2, 16, 32, 32, 3)  # p3d_micro_sa at 32 px: x_2_2 (Nq 256) and x_1_3 (2048)


def test_micro_model_with_every_flag_matches_jax(monkeypatch):
    """p3d_micro_sa with the six variables set, against JAX's with the same:
    the eval forward and one train step's loss and gradient (dropout 0; the
    train-mode output is the phase layout on both sides)."""
    for k, v in ALL_FLAGS.items():
        monkeypatch.setenv(k, v)
    jm, variables, tm = build_micro_pair("p3d_micro_sa", SHAPE, seed=3, dropout_rate=0.0)
    rng = np.random.default_rng(4)
    frames = rng.normal(size=SHAPE).astype(np.float32) * 0.5
    targets = rng.uniform(size=SHAPE[:4]).astype(np.float32)

    def run(params, f, t):
        ev = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, f,
                      train=False)

        def loss_of(p):
            out, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, f,
                              train=True, mutable=["batch_stats"])
            return jax_loss(out, t), out.shape
        (loss, shape), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        return ev, loss, grads

    ev, loss, grads = jax.jit(run)(variables["params"], jnp.asarray(frames), jnp.asarray(targets))
    assert isinstance(tm.decoder.x_0_1, tft.PhaseHeadTConv) and tm.decoder.x_0_1.fast
    assert isinstance(tm.encoder.stem, tss.StemConv) and tm.encoder.stem.s2d
    with torch.inference_mode():
        np.testing.assert_allclose(tm.eval()(torch.from_numpy(frames)).numpy(), np.asarray(ev),
                                   atol=EVAL_ATOL)
    tm.train()
    out = tm(torch.from_numpy(frames))
    assert out.shape == (2, 8, 16, 16, 8)
    got = loss_fn_saliency(out, torch.from_numpy(targets))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    total, per = grad_distance({n: p.grad for n, p in tm.named_parameters()},
                               jax.tree.map(np.asarray, grads))
    assert total <= GRAD_TOL, total
    assert max(per.values()) <= 1, sorted(per.items(), key=lambda kv: -kv[1])[:3]


# ---- composition --------------------------------------------------------------------


@contextlib.contextmanager
def _flags(monkeypatch, flags):
    with monkeypatch.context() as m:
        for k, v in flags.items():
            m.setenv(k, v)
        yield


def _float64_micro(flags, monkeypatch):
    """The micro UNet++ SA model in float64 with ``flags`` set while it is
    built, gamma 1 so that every attention site contributes."""
    torch.manual_seed(0)
    with _flags(monkeypatch, flags):
        m = P3DSaliency(**{**MICRO, **treg.MODEL_REGISTRY["p3d_micro_sa"]}, dtype=F64,
                        dropout_rate=0.0).double()
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith("gamma"):
                p.fill_(1.0)
    return m


def _loss_and_grads(model, x, t):
    model.zero_grad()
    loss = loss_fn_saliency(model(x), t)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in model.parameters()]


def _assert_grads_close(got, want):
    scale = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= REL_TOL * max(w.abs().max().item(),
                                                           FLOOR * scale)


@pytest.mark.parametrize("flags", [
    dict(SAP3D_CONCAT_SPLIT="1", SAP3D_HEAD_PHASE_LOSS="1"), ALL_FLAGS],
    ids=["split-phase_loss", "all"])
def test_flags_on_time_shards_match_the_unsharded_step_float64(flags, monkeypatch):
    """The train step's loss and gradient over 2 time shards (the mesh
    names the CPU twice) against the unsharded model with the same flags,
    and against the default model; and the eval forward."""
    model = _float64_micro(flags, monkeypatch)
    default = _float64_micro({}, monkeypatch)
    default.load_state_dict(model.state_dict())
    rng = np.random.default_rng(10)
    x = rng.uniform(size=(1, 32, 16, 16, 3))
    t = rng.uniform(size=(1, 32, 16, 16))
    mesh = make_time_mesh(2, devices=["cpu"] * 2)
    with torch.no_grad():  # eval first: the train steps move the running statistics
        want = default.eval()(torch.from_numpy(x))
        got = gather(model.eval()(time_shard_batch(mesh, (x,))[0]))
    assert (got - want).abs().max().item() <= 4 * 2.0 ** -24 * want.abs().max().item()
    model.train()
    whole = _loss_and_grads(model, torch.from_numpy(x), torch.from_numpy(t))
    sharded = _loss_and_grads(model, *time_shard_batch(mesh, (x, t)))
    base = _loss_and_grads(default.train(), torch.from_numpy(x), torch.from_numpy(t))
    for loss, grads in (sharded, base):
        assert abs(loss - whole[0]) <= REL_TOL * abs(whole[0])
        _assert_grads_close(grads, whole[1])


def test_dropout_masks_do_not_depend_on_the_flags(monkeypatch):
    """A train-mode forward at dropout 0.5 under every flag draws the masks
    the default model draws from the same generator: each rewrite hands
    back the channels-last memory order the default layers keep (the masks
    are drawn in memory order), so the loss is the default's."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(size=(1, 16, 16, 16, 3)))
    t = torch.from_numpy(rng.uniform(size=(1, 16, 16, 16)))
    losses = []
    for flags in ({}, ALL_FLAGS):
        model = _float64_micro(flags, monkeypatch)
        model.decoder.dropout_rate = 0.5
        if losses:
            model.load_state_dict(state)
        state = model.state_dict()
        with torch.no_grad():
            out = model.train()(x, torch.Generator().manual_seed(0))
        losses.append(loss_fn_saliency(out, t).item())
    assert abs(losses[1] - losses[0]) <= REL_TOL * abs(losses[0]), losses

