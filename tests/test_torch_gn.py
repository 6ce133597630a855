"""The GN + CBAM family of the port against the JAX package's, on the CPU in
float32: the CBAM and SE blocks, kernel B5 (``flash_fwd_chunked_bwd``), one
train step of the micro GN SA decoder model, and the trainer, checkpoint and
predictor on a model without BN statistics and with a linear output.

The same numpy-made inputs and weights go through both packages.  Tolerances:

* CBAM, its two halves and SE: 1e-6 absolute on O(1) outputs (float32
  reductions and one small conv in another order);
* B5: its output against the Pallas forward in interpret mode and its
  gradients against ``jax.grad`` through the JAX ``flash_fwd_chunked_bwd``,
  as tests/test_pallas_attention.py holds that function (o: rtol 1e-4, atol
  1e-5; gradients: rtol 2e-3, atol 1e-5), on that test's inputs and on one
  with more than 4096 queries, where two chunks run; the backward the card
  runs, composed of the plain versions of the kernels it launches (the
  row statistics' lse, then B3 on B5's own output), against the same
  ``jax.grad`` in float32 (the same limits) and bf16 (B3's ``TOLERANCE``:
  both round p and the products' operands to bf16, at other points);
* the micro train step (dropout 0): the loss to 1e-6 relative; the
  gradient by relative L2 distance, whole and per tensor, under ``GRAD_TOL``
  (see there).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import build_micro_pair, record_routes
# two torch threads; the steps held to JAX's loss at rtol 1e-6 take the
# default pool, whose order of sums meets it (at two threads one read 1.6e-6)
from _torch_threads import default_threads, two_threads  # noqa: F401
from sap3d_tpu.ops import cbam as jc
from sap3d_tpu.ops.pallas.flash_attention import flash_fwd_chunked_bwd as jax_hybrid
from sap3d_tpu.train.steps import loss_fn_saliency as jax_loss_fn
from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
from sap3d_tpu_torch.interop.flax_bridge import convert_leaf, state_dict_from_flax
from sap3d_tpu_torch.ops import attention as ta
from sap3d_tpu_torch.ops import cbam as tc
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.train import trainer as trainer_module
from sap3d_tpu_torch.train.checkpoint import load_checkpoint
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import make_eval_step, make_train_step

GN_SA = "inference_p3d_sa_decoder_block"
SHAPE = (2, 16, 32, 32, 3)  # pool2's grid is 4x8x8: the SA sites see 256 tokens


def _random_params(tree, rng):
    """Random values for every leaf of a flax params tree (the biases'
    init, zero, would leave them untested)."""
    return jax.tree.map(
        lambda v: (rng.normal(size=v.shape) / np.sqrt(max(1, int(np.prod(v.shape[:-1]))))
                   ).astype(np.float32), tree)


@pytest.mark.parametrize("block", ["CBAM", "ChannelAttention3D", "SpatialAttention3D",
                                   "SEBlock3D"])
def test_cbam_blocks_match_flax(block):
    rng = np.random.default_rng(0)
    c = 32
    x = rng.normal(size=(2, 3, 5, 6, c)).astype(np.float32)
    fm = getattr(jc, block)()
    params = _random_params(
        jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), rng)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = getattr(tc, block)() if block == "SpatialAttention3D" else getattr(tc, block)(c)
    tm.load_state_dict(state_dict_from_flax(params, model=tm), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    with torch.inference_mode():
        got = tm(xt).numpy().transpose(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(want - x).max() > 1e-2  # the block really rescales


def test_dense_kernels_are_transposed_by_the_bridge():
    k = np.arange(6, dtype=np.float32).reshape(2, 3)  # flax [in, out]
    np.testing.assert_array_equal(convert_leaf("cbam/ch_at/mlp_0/kernel", k), k.T)
    np.testing.assert_array_equal(convert_leaf("cbam/ch_at/mlp_0/bias", k[0]), k[0])


# -- kernel B5 ---------------------------------------------------------------


def _hybrid_inputs(b, nq, nk, d, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, nq, d), (b, nk, d), (b, nk, c))]


@pytest.mark.parametrize("b,nq,nk,d,c,seed", [
    (2, 300, 49, 8, 16, 7),    # the inputs of test_hybrid_fwd_chunked_bwd_matches_reference
    (1, 4500, 40, 8, 16, 8),   # more than 4096 queries: two chunks in the backward
], ids=["one_chunk", "two_chunks"])
def test_b5_matches_pallas_hybrid(b, nq, nk, d, c, seed):
    q, k, v = _hybrid_inputs(b, nq, nk, d, c, seed)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want_o = np.asarray(jax_hybrid(jq, jk, jv))
        want_g = jax.grad(lambda *a: jnp.sum(jax_hybrid(*a) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = ta.flash_fwd_chunked_bwd.launches, fa.flash_attend_tokens.launches
    out = ta.flash_fwd_chunked_bwd(tq, tk, tv)
    assert "FlashForwardChunkedBackward" in type(out.grad_fn).__name__
    got_g = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    # CPU tensors: the plain version, no launch counted
    assert (ta.flash_fwd_chunked_bwd.launches, fa.flash_attend_tokens.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), want_o, rtol=1e-4, atol=1e-5)
    for g, w, t in zip(got_g, want_g, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == t.dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=1e-5)


def test_b5_backward_recomputes_chunk_by_chunk(monkeypatch):
    """The forward saves q, k, v and its own output (which the card's
    backward takes for delta), and the plain backward attends to at most
    ``_QUERY_CHUNK`` queries at a time; a backward run on keys whose last 64
    are zeroed (a planted fault) fails the limits the sound one passes."""
    q, k, v = (torch.from_numpy(a) for a in _hybrid_inputs(1, 4500, 200, 8, 16, 9))
    seen = []
    plain = ta._dot_softmax_attend

    def spy(qc, kc, vc):
        seen.append(qc.shape[1])
        return plain(qc, kc, vc)

    monkeypatch.setattr(ta, "_dot_softmax_attend", spy)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ta.flash_fwd_chunked_bwd(tq, tk, tv)
    assert seen == [4500]  # the forward (on the card: the kernel) sees every query
    saved = out.grad_fn.saved_tensors
    assert [t.shape for t in saved] == [q.shape, k.shape, v.shape, out.shape]
    assert saved[3].data_ptr() == out.data_ptr()  # o itself: no copy is kept
    do = torch.from_numpy(np.random.default_rng(10).normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (tq, tk, tv), do)
    assert seen[1:] == [4096, 404]
    monkeypatch.setattr(ta, "_dot_softmax_attend", plain)

    want = torch.autograd.grad(ta.attend_tokens(tq, tk, tv), (tq, tk, tv), do)
    kz = k.clone()
    kz[:, -64:] = 0
    tkz = kz.requires_grad_()
    fault = torch.autograd.grad(ta.attend_tokens(tq, tkz, tv), (tq, tkz, tv), do)
    for g, w, f in zip(got, want, fault):
        assert fa.agreement(g, w)["excess"] <= 1
        assert fa.agreement(f, w)["excess"] > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,d,c,seed", [
    (2, 300, 49, 8, 16, 7),      # ragged Nq and Nk
    (1, 256, 130, 128, 1024, 12),  # the GN deconv_pool4 site's widths
], ids=["narrow", "deconv_pool4_widths"])
def test_b5_card_backward_composed_of_plain_kernels_matches_jax(b, nq, nk, d, c, seed, dtype):
    """What B5's backward launches on the card, in plain versions: the row
    statistics' lse of (q, k), then B3 on (q, k, v, o, lse, do) with B5's
    own forward output o, against ``jax.grad`` (a vjp with cotangent do)
    through the JAX ``flash_fwd_chunked_bwd``."""
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    q, k, v = _hybrid_inputs(b, nq, nk, d, c, seed)
    q, k = q * d ** -0.25, k * d ** -0.25
    do = np.random.default_rng(seed + 1).normal(size=(b, nq, c)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_hybrid, jq, jk, jv)
        want = vjp(jdo)
    tq, tk, tv, tdo = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
                       for a in (jq, jk, jv, jdo))
    o = fa.flash_attend_tokens_reference(tq, tk, tv)
    lse = fa.row_stats_reference(tq, tk, lse=True)
    got = fb.flash_backward_reference(tq, tk, tv, o, lse, tdo)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == t.dtype
        w = torch.tensor(np.asarray(w.astype(jnp.float32)))
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3, atol=1e-5)
        else:
            assert fa.agreement(g, w.to(torch.bfloat16), fb.TOLERANCE)["excess"] <= 1
    # the same with delta left out (o = 0) fails
    bad = fb.flash_backward_reference(tq, tk, tv, torch.zeros_like(o), lse, tdo)
    w = torch.tensor(np.asarray(want[0].astype(jnp.float32))).to(tq.dtype)
    assert fa.agreement(bad[0], w, fb.TOLERANCE)["excess"] > 1


def test_b5_cotangent_is_used_in_the_values_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
               for a in _hybrid_inputs(1, 300, 64, 8, 64, 11))
    out = ta.flash_fwd_chunked_bwd(q, k, v)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)


# -- one train step of the micro GN SA decoder model against JAX ---------------


@pytest.fixture(scope="module")
def gn_pair():
    jm, variables, tm = build_micro_pair(GN_SA, SHAPE, seed=5, dropout_rate=0.0)
    assert "batch_stats" not in variables
    rng = np.random.default_rng(6)
    frames = (rng.normal(size=SHAPE) * 0.5).astype(np.float32)
    targets = rng.uniform(size=SHAPE[:4]).astype(np.float32)

    def loss_of(params):
        out = jm.apply({"params": params}, jnp.asarray(frames), train=True)
        return jax_loss_fn(out, jnp.asarray(targets))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    return dict(tm=tm, frames=frames, targets=targets, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


# GN has no batch statistics, yet at this size the float32 gradient is not
# far tighter than the BN micro model's 1e-2 (tests/test_torch_train.py):
# measured 4.1e-3 for the whole gradient (relative L2), spread evenly over
# the tensors (0.2e-2 to 1e-2 each), and both packages' float32 gradients are
# 3.6e-3 from the port's float64 one: the limit is float32 itself (rounding
# that flips relus and moves GroupNorm statistics of 8 to 64 elements a
# group), not the port.  Per tensor the worst is 0.67 of the limit GRAD_TOL
# ||w|| + GRAD_FLOOR max|w_all|; GRAD_FLOOR covers gradients that are zero
# but for rounding (the conv biases ahead of a GroupNorm whose groups are
# single channels: the norm removes them).  A B3 without delta at the one
# site that takes it moves the whole gradient past the limit (the control).
GRAD_TOL, GRAD_FLOOR = 2e-2, 1e-3


def _grad_distance(got, want_tree):
    want = {p.replace("/", "."): torch.from_numpy(np.array(convert_leaf(p, w)))
            for p, w in _flat(want_tree).items()}
    assert set(want) == set(got)
    scale = max(w.abs().max().item() for w in want.values())
    total = (sum(((got[n] - w) ** 2).sum() for n, w in want.items()).sqrt()
             / sum((w ** 2).sum() for w in want.values()).sqrt()).item()
    per = {n: ((got[n] - w).norm() / (GRAD_TOL * w.norm() + GRAD_FLOOR * scale)).item()
           for n, w in want.items()}
    return total, per


def _port_step(gn_pair):
    tm = gn_pair["tm"]
    state = create_train_state(tm, lr=0.0)  # the gradients, not a moved model
    loss = make_train_step(state)(torch.from_numpy(gn_pair["frames"]),
                                  torch.from_numpy(gn_pair["targets"]))
    return tm, loss


@pytest.mark.parametrize("hybrid", ["0", "1"], ids=["hybrid_off", "hybrid_on"])
def test_gn_micro_train_step_matches_jax(gn_pair, monkeypatch, hybrid, default_threads):
    """With SAP3D_FLASH_HYBRID (the JAX package's hybrid flag) unset or "1"
    every site, the C = 1024 one (d = 128) too, trains through B2 + B3: the
    backward gate takes d <= 128 and C <= 1024, and the port has no hybrid
    route.  The function is the same."""
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", hybrid)
    seen = record_routes(monkeypatch)
    tm, loss = _port_step(gn_pair)
    assert not list(tm.buffers())
    routes = {shape[3]: route for shape, route in seen}
    assert routes == {32: "flash", 512: "flash", 1024: "flash"}
    np.testing.assert_allclose(loss.item(), gn_pair["loss"], rtol=1e-6)
    total, per = _grad_distance({n: p.grad for n, p in tm.named_parameters()},
                                gn_pair["grads"])
    print(f"GN micro step, hybrid {hybrid}: gradient relative L2 {total:.3e}, worst tensor "
          f"{max(per.values()):.3f} of its limit")
    assert total <= GRAD_TOL, total
    assert max(per.values()) <= 1, sorted(per.items(), key=lambda kv: -kv[1])[:3]
    # every attention site's gamma got a gradient: the sites contribute
    assert all(sa.gamma.grad.abs().item() > 0 for sa in tm.attention_modules())


def test_gn_micro_train_step_through_b5_matches_jax(gn_pair, monkeypatch, default_threads):
    """The C = 1024 site sent to B5 (``flash_fwd_chunked_bwd``) in the
    same step: no route of the dispatch reaches B5, so the site's call of
    ``flash_attend`` is given to it here; the gradient is held as above."""
    orig, calls = ta.flash_attend, []
    function = ta._FlashForwardChunkedBackward

    def to_b5(q, k, v):
        if v.shape[2] != 1024:
            return orig(q, k, v)
        calls.append(q.shape)
        return function.apply(q, k, v)

    monkeypatch.setattr(ta, "flash_attend", to_b5)
    tm, loss = _port_step(gn_pair)
    assert len(calls) == 1 and calls[0][2] == 128
    np.testing.assert_allclose(loss.item(), gn_pair["loss"], rtol=1e-6)
    total, per = _grad_distance({n: p.grad for n, p in tm.named_parameters()},
                                gn_pair["grads"])
    assert total <= GRAD_TOL, total
    assert max(per.values()) <= 1, sorted(per.items(), key=lambda kv: -kv[1])[:3]


def test_gn_micro_train_step_limits_fail_a_backward_without_delta(gn_pair, monkeypatch):
    """The control: the plain B3 with delta left out, at the C = 32, 512
    and 1024 sites."""
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    def without_delta(q, k, v, o, lse, do):
        p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse[..., None])
        ds = p * torch.bmm(do, v.transpose(1, 2))
        return torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), do)

    monkeypatch.delenv("SAP3D_FLASH_HYBRID", raising=False)
    monkeypatch.setattr(fb, "flash_backward_reference", without_delta)
    tm, _ = _port_step(gn_pair)
    total, _ = _grad_distance({n: p.grad for n, p in tm.named_parameters()}, gn_pair["grads"])
    assert total > 5 * GRAD_TOL, total


# -- the trainer, checkpoint and predictor on a GN model ------------------------


def test_trainer_checkpoint_and_predictor_take_a_gn_model(gn_pair, monkeypatch, tmp_path):
    """``Trainer.fit`` (validation and side dumps on a linear output, a
    checkpoint without BN statistics), a restore into a second trainer and a
    sliding-window prediction, on the micro GN SA decoder model in place of
    the full-width one the registry builds."""
    import copy

    def micro(name, dtype=None, device="cpu", seed=0, dropout_rate=0.5, ring_mesh=None):
        assert name == "P3D_SA_DECODER" and ring_mesh is None
        model = copy.deepcopy(gn_pair["tm"])
        model.decoder.dropout_rate = dropout_rate
        return model

    monkeypatch.setattr(trainer_module, "build_model", micro)
    cfg = Config(model=ModelConfig(name="P3D_SA_DECODER", dtype="float32", dropout=0.5),
                 train=TrainConfig(batch_size=2, lr=1e-3, weight_decay=5e-4, plot_iter=1,
                                   valid_iter=2, save_iter=2, max_steps=4, seed=0,
                                   model_dir=str(tmp_path / "model"),
                                   logs_dir=str(tmp_path / "logs")))
    batch = (gn_pair["frames"], gn_pair["targets"])
    trainer = trainer_module.Trainer(cfg, run="gn", device="cpu")
    trainer.fit(iter([batch] * 4), lambda: iter([batch]))
    trainer.close()
    with open(tmp_path / "logs" / "gn" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    valid = [r for r in records if "cc" in r]
    # KLD of a linear output with negative values is NaN in both packages
    # (the log of a negative ratio; metrics_jax.kldiv is the same formula)
    assert len(valid) == 2 and all(np.isfinite(valid[-1][k]) for k in ("cc", "sim", "auc_judd"))

    payload = load_checkpoint(trainer.model_dir)
    assert payload["step"] == 4
    assert not any(k.endswith((".mean", ".var")) for k in payload["model"])
    assert any(k.endswith("cbam.ch_at.mlp_0.kernel") for k in payload["model"])
    resumed = trainer_module.Trainer(
        cfg.replace(train=cfg.train.__class__(**{**cfg.train.__dict__, "pretrain": "gn"})),
        run="gn", device="cpu")
    assert resumed.state.step == 4
    for key, val in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], val), key
    resumed.close()

    frames = (np.random.default_rng(12).normal(size=(20, 32, 32, 3)) * 0.3).astype(np.float32)
    with SlidingWindowPredictor(make_eval_step(trainer.model), batch_windows=2,
                                image_size=32, device="cpu") as pred:
        maps = pred.predict_video(frames=frames)
    assert maps.shape == (20, 32, 32) and np.isfinite(maps).all()
    assert maps.std() > 0  # a linear output: not clipped to [0, 1] by the model
