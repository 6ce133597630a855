"""Long-clip ring attention in the port against the JAX package.

* Kernel B2 + B4 (``flash_attend_tokens_lse``: o and lse forward, the
  backward with the lse cotangent) against the JAX ``flash_attend_tokens_lse``
  in the Pallas interpreter, as tests/test_ring_attention.py runs it; the
  port runs the plain versions through its CPU dispatch.
* ``ring_attend_sharded`` on a mesh that names the CPU 4 times, both hops,
  against the JAX ring (``make_time_mesh(4)`` on 4 virtual CPU devices,
  the chunked hop) and ``attend_tokens``.
* A micro UNet++ SA model with a 4-shard ring against the JAX model without
  one; the trainer's time mode (every layer time-sharded,
  tests/test_torch_time_shard.py) against its unsharded run.

Tolerances are those of tests/test_ring_attention.py: values 1e-5 and
gradients 1e-4 (the online softmax reorders the float32 sums), the model's
eval forward 2e-5 and its train-step loss 5e-4 relative; o and lse of one
kernel call 1e-5, its gradients 1e-4.  The CUDA kernels themselves run on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import build_micro_pair
from sap3d_tpu.core.mesh import make_time_mesh as jax_time_mesh
from sap3d_tpu.ops.attention import attend_tokens as jax_attend_tokens
from sap3d_tpu.ops.pallas.flash_attention import (
    flash_attend_tokens_lse as jax_flash_attend_tokens_lse,
)
from sap3d_tpu.ops.ring_attention import ring_attend_sharded as jax_ring_attend_sharded
from sap3d_tpu.train.steps import loss_fn_saliency as jax_loss
from sap3d_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
from sap3d_tpu_torch.core.mesh import TIME_AXIS, make_time_mesh
from sap3d_tpu_torch.models.p3d import P3DSaliency
from sap3d_tpu_torch.ops import attention as ta
from sap3d_tpu_torch.ops import layers
from sap3d_tpu_torch.ops import ring_attention as ra
from sap3d_tpu_torch.ops import time_shard as ts
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
from sap3d_tpu_torch.train.steps import loss_fn_saliency
from sap3d_tpu_torch.train.trainer import Trainer

CPU4 = ["cpu"] * 4


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


# ---- B2 + B4 --------------------------------------------------------------


@pytest.mark.parametrize("nq", [512, 300], ids=["nq512", "ragged300"])
def test_b2_b4_match_pallas_lse(nq):
    """o, lse and the gradients of sum(o w1) + sum(lse w2): the lse
    cotangent reaches delta (B4).  The same loss without the lse term runs
    B3 (autograd gives lse no cotangent), and differs."""
    rng = np.random.default_rng(4)
    b, nk, d, c = 1, 256, 8, 16
    q, k, v = _normal(rng, b, nq, d), _normal(rng, b, nk, d), _normal(rng, b, nk, c)
    w1, w2 = _normal(rng, b, nq, c), _normal(rng, b, nq)

    def jax_loss_of(q_, k_, v_):
        o, lse8 = jax_flash_attend_tokens_lse(q_, k_, v_)
        return jnp.sum(o * w1) + jnp.sum(lse8[:, 0] * w2), (o, lse8[:, 0])

    with pltpu.force_tpu_interpret_mode():
        (_, (want_o, want_lse)), want_g = jax.value_and_grad(
            jax_loss_of, argnums=(0, 1, 2), has_aux=True)(q, k, v)

    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    before = (fa.flash_forward_lse.launches, fb.flash_backward.launches,
              fb.flash_backward.launches_lse)
    o, lse = ta.flash_attend_tokens_lse(qt, kt, vt)
    assert lse.shape == (b, nq) and lse.dtype == torch.float32
    got_g = torch.autograd.grad((o * _t(w1)).sum() + (lse * _t(w2)).sum(), (qt, kt, vt))
    # CPU tensors: the plain versions, no launch counted
    assert (fa.flash_forward_lse.launches, fb.flash_backward.launches,
            fb.flash_backward.launches_lse) == before
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")

    # without the lse term: B3's gradient, which the lse term moves
    o, _ = ta.flash_attend_tokens_lse(qt, kt, vt)
    no_lse = torch.autograd.grad((o * _t(w1)).sum(), (qt, kt, vt))
    o_b3, lse_b3 = fa.flash_forward_lse(qt.detach(), kt.detach(), vt.detach())
    b3 = fb.flash_backward(qt.detach(), kt.detach(), vt.detach(), o_b3, lse_b3,
                           _t(w1).expand_as(o_b3))
    for g, w, full in zip(no_lse, b3, got_g):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert (no_lse[0] - got_g[0]).abs().max() > 1e-2


# ---- the ring op ------------------------------------------------------------


@functools.cache
def _ring_case(chunk_q):
    """Inputs and the JAX ring's (chunked hop) and attend_tokens' values and
    gradients of sum(o^2), on 4 virtual CPU devices."""
    rng = np.random.default_rng(3)
    b, nq, nk, d, c = 2, 256, 64, 8, 16
    q, k, v = _normal(rng, b, nq, d), _normal(rng, b, nk, d), _normal(rng, b, nk, c)
    mesh = jax_time_mesh(4)

    def ring_loss(q_, k_, v_):
        o = jax_ring_attend_sharded(mesh, q_, k_, v_, chunk_q=chunk_q, hop_impl="xla")
        return jnp.sum(o ** 2), o

    def gather_loss(q_, k_, v_):
        o = jax_attend_tokens(q_, k_, v_)
        return jnp.sum(o ** 2), o

    out = {}
    for name, fn in (("ring", ring_loss), ("gather", gather_loss)):
        (_, o), g = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        out[name] = (np.asarray(o), [np.asarray(x) for x in g])
    return (q, k, v), out


@pytest.mark.parametrize("chunk_q", [16, 24], ids=["chunk16", "chunk24_ragged"])
@pytest.mark.parametrize("hop", ["xla", "pallas"])
def test_ring_op_matches_jax_ring_and_gather(hop, chunk_q):
    """4 shards of 64 queries and 16 keys; chunk_q = 24 leaves a ragged last
    chunk (the JAX hop pads it).  The kernel hop on CPU tensors runs the
    plain B2 and B4."""
    (q, k, v), want = _ring_case(chunk_q)
    mesh = make_time_mesh(4, devices=CPU4)
    assert mesh.shape == {TIME_AXIS: 4}
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    got = ra.ring_attend_sharded(mesh, qt, kt, vt, chunk_q=chunk_q, hop_impl=hop)
    grads = torch.autograd.grad(got.square().sum(), (qt, kt, vt))
    for ref in ("ring", "gather"):
        want_o, want_g = want[ref]
        np.testing.assert_allclose(got.detach().numpy(), want_o, rtol=1e-5, atol=1e-5)
        for name, g, w in zip("qkv", grads, want_g):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{ref} d{name}")


def test_ring_dispatch(monkeypatch):
    """One shard is attend_tokens; SAP3D_RING_HOP overrides the automatic
    choice (the chunked hop on CPU devices), read at each call; token counts
    the shards do not divide and an unknown hop raise."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(_normal(rng, 1, n, w)) for n, w in ((64, 8), (32, 8), (32, 16)))
    seen = []
    for impl, (hop, finish) in list(ra._HOPS.items()):
        monkeypatch.setitem(ra._HOPS, impl, (
            lambda *a, hop=hop, impl=impl: seen.append(impl) or hop(*a), finish))
    torch.testing.assert_close(
        ra.ring_attend_sharded(make_time_mesh(1, devices=["cpu"]), q, k, v),
        ta.attend_tokens(q, k, v))
    assert seen == []
    mesh = make_time_mesh(4, devices=CPU4)
    monkeypatch.delenv("SAP3D_RING_HOP", raising=False)
    ra.ring_attend_sharded(mesh, q, k, v)
    assert seen == ["xla"] * 4  # one call per hop: the 4 shards share the CPU
    monkeypatch.setenv("SAP3D_RING_HOP", "pallas")
    ra.ring_attend_sharded(mesh, q, k, v)
    assert seen[4:] == ["pallas"] * 4
    with pytest.raises(ValueError, match="divisible"):
        ra.ring_attend_sharded(mesh, q[:, :62], k, v)
    with pytest.raises(ValueError, match="unknown ring hop_impl"):
        ra.ring_attend_sharded(mesh, q, k, v, hop_impl="mosaic")
    with pytest.raises(ValueError, match="exceeds"):
        make_time_mesh(5, devices=CPU4)


# ---- the model --------------------------------------------------------------


@pytest.mark.parametrize("decoder,kwargs,rings", [
    ("unetpp", dict(attention="sa"), True),
    ("unetpp", dict(attention="none"), False),
    ("gn_decoder_block", dict(use_sa=True), False),
], ids=["unetpp_sa", "unetpp_none", "gn_decoder_block_sa"])
def test_ring_sites_by_decoder(decoder, kwargs, rings):
    """The mesh reaches the UNet++ SA decoder's sites alone, and the model
    says which sites run as rings (the trainer asks it)."""
    model = P3DSaliency(decoder=decoder, decoder_kwargs=kwargs, stages=((16, 1), (32, 1),
                                                                        (64, 1)),
                        stem_features=8, ring_mesh=make_time_mesh(2, devices=["cpu"] * 2))
    assert model.ring_sites() == (model.attention_modules() if rings else [])
    assert model.attention_modules() or decoder == "unetpp"


_MICRO_SA = dict(decoder="unetpp", decoder_kwargs=dict(attention="sa", head="ds"),
                 stages=((8, 1), (16, 1), (32, 1)), stem_features=8, dropout_rate=0.0)


@functools.cache
def _model_case():
    """The JAX micro UNet++ SA model without a ring (gamma 0.7, dropout 0):
    its eval output and train-mode loss at [1, 64, 16, 16, 3], and the
    port's weights for it."""
    shape = (1, 64, 16, 16, 3)
    jm, variables, tm = build_micro_pair("p3d_micro_sa", shape, seed=0, dropout_rate=0.0)
    variables = dict(variables, params=jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.7)
        if jax.tree_util.keystr(path).endswith("'gamma']") else p, variables["params"]))
    with torch.no_grad():
        for sa in tm.attention_modules():
            sa.gamma.fill_(0.7)
    rng = np.random.default_rng(2)
    frames = _normal(rng, *shape) * 0.3
    targets = rng.random(shape[:-1]).astype(np.float32)

    @jax.jit
    def eval_and_loss(f, t):
        out, _ = jm.apply(variables, f, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(9)})
        return jm.apply(variables, f, train=False), jax_loss(out, t)

    want_eval, want_loss = eval_and_loss(frames, targets)
    return tm.state_dict(), frames, targets, np.asarray(want_eval), float(want_loss)


@pytest.mark.parametrize("hop", ["xla", "pallas"])
def test_micro_ring_model_matches_jax(hop, monkeypatch):
    """Every SA site of the micro model (x_4_0 at one query per shard) runs
    as a 4-shard ring: the eval forward and the train-mode loss match the
    JAX model without a ring; the gradient matches the port's own gather
    path.  The gradient is taken with BN on its running statistics: in
    train mode BN normalizes pool4's 4 tokens per channel, and float32
    rounding alone then moves this model's gradient by 4e-4 to 1.2e-3
    (relative L2; either hop against the gather path, the same weights),
    while with the attention sites differentiated as in training and BN
    well conditioned both hops read 1.5e-7.  The parameters are the same
    with and without the mesh."""
    weights, frames, targets, want_eval, want_loss = _model_case()
    ring_op = ra.ring_attend_sharded
    monkeypatch.setattr(ra, "ring_attend_sharded", lambda *a, hop_impl=None, **kw: ring_op(
        *a, hop_impl=hop_impl or hop, **kw))
    ring = P3DSaliency(**_MICRO_SA, ring_mesh=make_time_mesh(4, devices=CPU4)).eval()
    gather = P3DSaliency(**_MICRO_SA).eval()
    assert list(ring.state_dict()) == list(weights)
    ring.load_state_dict(weights)
    gather.load_state_dict(weights)
    x, y = _t(frames), _t(targets)
    calls = []
    monkeypatch.setattr(ta, "attention_route", lambda *a: calls.append(a) or "plain")
    with torch.inference_mode():
        got = ring(x).numpy()
    assert calls == []  # the mesh takes every site past the gate
    np.testing.assert_allclose(got, want_eval, atol=2e-5)

    def loss_and_grad(m, train):
        m.train(train)
        m.zero_grad(set_to_none=True)
        loss = loss_fn_saliency(m(x), y)
        loss.backward()
        m.eval()
        return loss.item(), torch.cat([p.grad.flatten() for p in m.parameters()])

    _, g_ring = loss_and_grad(ring, train=False)
    loss_ring, _ = loss_and_grad(ring, train=True)  # updates BN's running statistics
    np.testing.assert_allclose(loss_ring, want_loss, rtol=5e-4)
    monkeypatch.undo()  # the gather path routes as ever
    _, g_gather = loss_and_grad(gather, train=False)
    assert (g_ring - g_gather).norm() <= 1e-4 * g_gather.norm()


# ---- the trainer ------------------------------------------------------------


def _time_cfg(tmp_path, tag, time_shards, t=32, steps=2):
    return Config(
        model=ModelConfig(name="p3d_micro_sa", dtype="float32", dropout=0.0),
        data=DataConfig(video_length=t, image_size=16),
        train=TrainConfig(batch_size=2, max_steps=steps, time_shards=time_shards,
                          ring_attention=True, plot_iter=10**6, valid_iter=10**9,
                          save_iter=10**9, model_dir=str(tmp_path / tag / "model"),
                          logs_dir=str(tmp_path / tag / "logs")))


def test_trainer_time_mode_matches_unsharded(tmp_path):
    """--time-shards 2 with ring attention on the CPU: two steps' losses as
    the unsharded run's, every SA site on the ring, a checkpoint written;
    every convolution's output in the sharded run is time-sharded over the
    mesh (each of 2 shards on its device), in the encoder and the decoder,
    and no convolution of the unsharded run is; a validation before the
    first step (the sharded eval forward, the last frame from the last
    shard) scores as the unsharded run's."""
    rng = np.random.default_rng(7)
    batches = [((rng.normal(size=(2, 32, 16, 16, 3)) * 0.3).astype(np.float32),
                rng.random((2, 32, 16, 16)).astype(np.float32)) for _ in range(2)]

    def run(tag, time_shards):
        tr = Trainer(_time_cfg(tmp_path, tag, time_shards), run=tag, device="cpu")
        meshes = {sa.ring_mesh for sa in tr.model.attention_modules()}
        outputs = {}  # conv name -> the shard counts of its outputs (0: a whole tensor)
        for name, m in tr.model.named_modules():
            if isinstance(m, (layers.Conv3d, layers.ConvTranspose3d)):
                m.register_forward_hook(lambda m, i, out, name=name: outputs.setdefault(
                    name, set()).add(out.n if isinstance(out, ts.Shards) else 0))
        try:
            valid = tr.validate(0, iter(batches[:1]))
            tr.fit(iter(batches))
        finally:
            tr.close()
        with open(os.path.join(tr.logs_dir, "metrics.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        assert os.listdir(tr.model_dir), "no checkpoint written"
        return losses, meshes, outputs, [valid[k] for k in ("cc", "sim", "kld", "auc_judd")]

    base, base_meshes, base_outputs, base_scores = run("base", 0)
    sharded, meshes, outputs, scores = run("tsharded", 2)
    assert base_meshes == {None}
    assert meshes == {make_time_mesh(2, devices=["cpu"] * 2)}
    assert len(base) == len(sharded) == 2
    np.testing.assert_allclose(sharded, base, rtol=1e-5)
    assert set(outputs) == set(base_outputs)
    assert "encoder.stem" in outputs and "decoder.x_1_3.Conv_0" in outputs
    assert all(n == {0} for n in base_outputs.values())
    assert all(n == {2} for n in outputs.values()), outputs
    # cc, sim, kld, auc: the untrained model's cc is near 0, so the scores
    # are also held absolutely (read: 1.9e-7 apart at most)
    np.testing.assert_allclose(scores, base_scores, rtol=1e-5, atol=1e-6)


def test_trainer_time_mode_guards(tmp_path, monkeypatch):
    """A clip length that is not a multiple of 16 per shard raises; on CUDA
    the mesh holds the visible cards, so 4 shards on one card raise as the
    JAX trainer does on one chip (checked before any model is built)."""
    with pytest.raises(ValueError, match="multiple of 16"):
        Trainer(_time_cfg(tmp_path, "g1", 4, t=32), run="g1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        Trainer(_time_cfg(tmp_path, "g2", 4, t=64), run="g2", device="cuda")
