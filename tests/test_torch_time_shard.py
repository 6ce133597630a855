"""Time-sharded long clips (``ops/time_shard.py``): every layer and the
micro models on a mesh that names the CPU n times, against the same layers
and models on the whole clip, and the micro UNet++ SA model against the JAX
package's GSPMD time-sharded model.

* (a) Every layer that takes a time-sharded clip, in float64, at n = 2 and 4
  shards of 1, 2 and 4 frames on one device, and at 4 shards over two
  devices (``LAYOUTS``): the output, the input gradient, every
  parameter gradient and the running buffers after one call, each within
  ``REL_TOL`` of its tensor's largest value.  The halo cases: the clip's own
  SAME padding at its two ends against the seams (k = 3), the asymmetric
  (0, 1) halo of k = 2, CBAM's 7-frame window across two shards at 1- and
  2-frame shards, the transposed conv's overlap at (3, 2); BN's running
  statistics moved once.  A temporal pool over shards whose length is not a
  multiple of its stride raises instead.
* (b) Two planted faults fail (a) by a wide margin: each shard padded at its
  own ends (no halos), and BN statistics per shard (``chip_smoke.py``'s
  ``planted_time_shard_fault``, which phase 9(e) holds its limits against).
* The float-order change of a sum over shards in float32, within rounding.
* (c) The micro UNet++ SA model, 4 shards of its clip, against JAX's
  time-sharded model (``jax.jit`` with the input under
  ``time_sharding(make_time_mesh(4))`` on conftest's virtual CPU devices,
  as tests/test_time_parallel.py runs it): the eval forward within
  ``EVAL_ATOL`` (tests/test_torch_ring.py's limit for this model), the
  train-mode gradient (dropout 0) within ``_torch_parity``'s ``GRAD_TOL``
  (whole gradient) and ``GRAD_TOL``/``GRAD_FLOOR`` per tensor
  (``grad_distance``), with the ring and with the gathered attention.  Both
  at T = 64: at T = 32 four shards would leave pool4 half a frame each,
  which the port refuses (the trainer's guard, T a multiple of 16 N).
* (d) A GN + CBAM micro model (the decoder-block head with attention) and
  the 'nl' UNet++ at micro stages, and the micro UNet++ SA ring with one
  shard on each of two devices, sharded against unsharded in float64.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from _torch_parity import GRAD_TOL, MICRO, build_micro_pair, grad_distance
from chip_smoke import planted_time_shard_fault
from sap3d_tpu.core.mesh import make_time_mesh as jax_time_mesh
from sap3d_tpu.core.mesh import time_sharding
from sap3d_tpu.train.steps import loss_fn_saliency as jax_loss
from sap3d_tpu_torch.core.mesh import make_time_mesh, time_shard_batch
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.models.p3d import P3DSaliency
from sap3d_tpu_torch.ops import layers
from sap3d_tpu_torch.ops import time_shard as ts
from sap3d_tpu_torch.ops.attention import NonLocal3D, SelfAttention3D
from sap3d_tpu_torch.ops.cbam import CBAM
from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_eval_step

F64 = torch.float64
# (a): max |sharded - unsharded| over the tensor's largest |value|, for every
# output, gradient and buffer in float64 (read: at most 1.3e-11, at the
# subsampled ring site, whose online softmax adds its hops in another
# order; 4.1e-13 and less at every other layer).  A gradient
# that is zero but for rounding (a conv's bias ahead of a train-mode BN,
# which removes it) is held against FLOOR times the call's largest gradient.
REL_TOL, FLOOR = 1e-10, 1e-3
# (b): a planted fault exceeds REL_TOL at least this many times (read: 2.0e9
# to 2.9e10).
FAULT_EXCESS = 1e6
# Float32: BN's output over a clip whose channel means are large against
# their spread, and the loss, summed shard by shard against the whole clip
# (read: 4.7e-7 and 8.9e-8).
FP32_TOL = {"batch_norm": 5e-6, "loss": 1e-6}
# (c): the eval forward against JAX's (tests/test_torch_ring.py's limit for
# this model's eval forward; read 1.2e-7 with the ring, 8.9e-8 gathered).
# The gradient is held by _torch_parity's limits (read: whole gradient
# 1.05e-2 with either attention against GRAD_TOL 5e-2, the worst tensor
# 0.34 of its limit).
EVAL_ATOL = 2e-5
# (d): the models' outputs are float32 by contract (their heads cast), so
# they are held to float32 rounding, 4 ulps of the largest value, and the
# float32 loss to FP32_TOL["loss"]; the float64 gradient (relative L2 of the
# whole) to MODEL_GRAD_TOL, and each BN buffer to REL_TOL.  Read: outputs 0,
# losses 0 to 7.7e-8, gradients 4.1e-13 (GN), 2.2e-13 ('nl') and 1.2e-12
# ('sa' over two devices); an earlier build that summed every BN's
# statistics itself read 3.5e-11 at 'nl' (train-mode BN over the micro
# model's few samples per channel carries float64 rounding that far).
MODEL_OUT_TOL, MODEL_GRAD_TOL = 4 * 2.0 ** -23, 1e-9


# Mesh layouts: n shards on one device (the CPU named n times: one tensor of
# n stacked shards), and 4 shards on two devices in turn, "cpu" and
# "cpu:0" (two device names, so two stacked tensors of two shards each
# that are not neighbours, and every move between them a copy): the
# layout of several cards, where the statistics are summed across
# devices and every halo crosses one.
LAYOUTS = {"n2": ["cpu"] * 2, "n4": ["cpu"] * 4, "n4_two_devices": ["cpu", "cpu:0"] * 2}
TWO_DEVICES_TWO_SHARDS = ["cpu", "cpu:0"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module's small float64 layers and micro
    models: the test runs share the host's cores with other workers, and a
    thread pool of every core on tensors this small only contends for them
    (377 s of a worker's time under the 6-worker Tier-1 command, against
    54 s with two)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mesh(layout):
    """A time mesh of ``LAYOUTS[layout]``, or of a list of device names."""
    devices = LAYOUTS[layout] if isinstance(layout, str) else layout
    return make_time_mesh(len(devices), devices=devices)


def _bn(train=True, quirk=False):
    def make(c):
        m = layers.BatchNorm(c, F64, batch_stats_at_eval=quirk)
        with torch.no_grad():
            m.scale.uniform_(0.5, 1.5), m.bias.normal_(0.0, 0.3)
            m.mean.normal_(0.0, 0.3), m.var.uniform_(0.5, 1.5)
        return m.train(train)
    return make


def _sa(ring=False, **kw):
    def make(c):
        m = SelfAttention3D(c, dtype=F64, **kw)
        with torch.no_grad():
            m.gamma.fill_(0.7)
        return m.train()
    make.ring = ring
    return make


def _pool(fn, stride):
    def make(c):
        return fn
    make.stride = stride
    return make


# name -> (factory of the layer on C channels, C, H = W of its input)
LAYERS = {
    "conv_k1": (lambda c: layers.Conv3d(c, 6, (1, 3, 3), dtype=F64), 4, 5),
    "conv_k2": (lambda c: layers.Conv3d(c, 6, (2, 3, 3), dtype=F64), 4, 5),
    "conv_k3": (lambda c: layers.Conv3d(c, 6, 3, dtype=F64), 4, 5),
    "conv_k7": (lambda c: layers.Conv3d(c, 2, 7, use_bias=False, dtype=F64), 2, 4),
    "conv_stem": (lambda c: layers.Conv3d(c, 4, (1, 7, 7), (1, 2, 2), use_bias=False,
                                          dtype=F64), 3, 8),
    **{f"tconv_k{k}s{s}": ((lambda c, k=k, s=s: layers.ConvTranspose3d(
        c, 3, (k, 3, 3), s, dtype=F64)), 4, 3)
       for k, s in ((1, 2), (2, 2), (3, 1), (3, 2), (3, 4), (1, 4))},
    "maxpool_211": (_pool(lambda x: layers.max_pool3d(x, (2, 1, 1), (2, 1, 1)), 2), 4, 5),
    "maxpool_233": (_pool(lambda x: layers.max_pool3d(x, (2, 3, 3), (2, 2, 2)), 2), 4, 5),
    "pool3d_2": (_pool(lambda x: layers.pool3d(x, 2), 2), 4, 4),
    "pool3d_4": (_pool(lambda x: layers.pool3d(x, 4), 4), 4, 4),
    "bn_train": (_bn(), 4, 4),
    "bn_eval": (_bn(train=False), 4, 4),
    "bn_batch_stats_at_eval": (_bn(train=False, quirk=True), 4, 4),
    "groupnorm": (lambda c: layers.GroupNorm(c, F64).double(), 64, 3),
    "cbam": (lambda c: CBAM(c, dtype=F64).double(), 16, 4),
    "nonlocal": (lambda c: NonLocal3D(c, sub_sample=False, dtype=F64).double().train(), 8, 3),
    "nonlocal_sub": (lambda c: NonLocal3D(c, sub_sample=True, dtype=F64).double().train(), 8, 4),
    "sa_ring": (_sa(ring=True), 16, 3),
    "sa_gathered": (_sa(), 16, 3),
    "sa_ring_subsampled": (_sa(ring=True, subsample=True), 16, 4),
}


def _stride(name) -> int:
    """The temporal stride a layer's pools need each shard's length to be a
    multiple of."""
    make = LAYERS[name][0]
    if name == "nonlocal_sub" or name.endswith("subsampled"):
        return 2
    return getattr(make, "stride", 1)


def _build(name, mesh=None):
    make, c, hw = LAYERS[name]
    torch.manual_seed(0)
    ref = make(c)
    if isinstance(ref, torch.nn.Module):
        ref = ref.double()
        sharded = copy.deepcopy(ref)
        if getattr(make, "ring", False):
            sharded.ring_mesh = mesh
    else:
        sharded = ref
    return ref, sharded, c, hw


def _run(layer, x, w=None, mesh=None):
    """layer(x), and the gradients of sum(layer(x) w) by x and by each
    parameter (w random where not given); on ``mesh``'s shards when given."""
    xl = x.clone().requires_grad_()
    params = list(layer.parameters()) if isinstance(layer, torch.nn.Module) else []
    if mesh is None:
        out = layer(xl)
        w = torch.randn(out.shape, dtype=out.dtype, generator=torch.Generator().manual_seed(1)) \
            if w is None else w
        loss = (out * w).sum()
    else:
        out_sh = layer(ts.shard(mesh, xl))
        assert isinstance(out_sh, ts.Shards) and out_sh.n == len(mesh.devices)
        loss = ts.shard_sums(out_sh * ts.shard(mesh, w)).sum()
        out = ts.gather(out_sh)
    grads = torch.autograd.grad(loss, [xl] + [p for p in params if p.requires_grad],
                                allow_unused=True)
    buffers = [b.clone() for b in layer.buffers()] if params else []
    return out.detach(), w, list(grads), buffers


def _excess(name, layout, frames, batch=2):
    """The largest of (a)'s errors over REL_TOL, and the names of what was
    compared."""
    mesh = _mesh(layout)
    n = len(mesh.devices)
    ref, sharded, c, hw = _build(name, mesh)
    x = torch.randn(batch, c, n * frames, hw, hw, dtype=F64,
                    generator=torch.Generator().manual_seed(2))
    want_out, w, want_g, want_b = _run(ref, x)
    got_out, _, got_g, got_b = _run(sharded, x, w, mesh)
    top = max(g.abs().max().item() for g in want_g if g is not None)
    worst, seen = 0.0, []
    pairs = ([("out", got_out, want_out)]
             + [(f"grad{i}", g, v) for i, (g, v) in enumerate(zip(got_g, want_g))]
             + [(f"buffer{i}", g, v) for i, (g, v) in enumerate(zip(got_b, want_b))])
    for label, got, want in pairs:
        assert (got is None) == (want is None), label
        if got is None:
            continue
        assert got.shape == want.shape and got.dtype == want.dtype == F64, label
        scale = max(want.abs().max().item(), FLOOR * top if label.startswith("grad") else 0.0)
        worst = max(worst, (got - want).abs().max().item() / (scale or 1.0) / REL_TOL)
        seen.append(label)
    return worst, seen


# ---- (a) every sharded layer against the same layer unsharded ----------------


@pytest.mark.parametrize("frames", [1, 2, 4], ids=lambda f: f"frames{f}")
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(LAYERS))
def test_sharded_layer_matches_unsharded(name, layout, frames):
    """Output, input and parameter gradients and buffers in float64 within
    REL_TOL; a pool whose stride does not divide the shard raises."""
    if frames % _stride(name):
        mesh = _mesh(layout)
        _, sharded, c, hw = _build(name, mesh)
        x = torch.zeros(2, c, len(mesh.devices) * frames, hw, hw, dtype=F64)
        with pytest.raises(ValueError, match="halos on shards"):
            sharded(ts.shard(mesh, x))
        return
    worst, seen = _excess(name, layout, frames)
    assert worst <= 1.0, (worst * REL_TOL, seen)
    assert "grad0" in seen  # the input's gradient
    if isinstance(_build(name)[0], torch.nn.Module):
        assert len(seen) > 2  # parameters (and buffers) too


def test_sharded_clip_refuses_layers_without_a_sharded_form():
    """A torch function that has no time-sharded form raises rather than run
    each shard as a clip; so does a data group together with a time mesh."""
    mesh = _mesh("n2")
    x = ts.shard(mesh, torch.zeros(1, 2, 4, 3, 3))
    with pytest.raises(TypeError, match="no time-sharded form"):
        torch.nn.functional.conv3d(x, torch.zeros(2, 2, 3, 3, 3))
    with pytest.raises(TypeError, match="no time-sharded form"):
        torch.nn.functional.avg_pool3d(x, 2)
    with pytest.raises(ValueError, match="spans the batch or time"):
        x * torch.ones(1, 2, 4, 1, 1)
    bn = layers.BatchNorm(2).train()

    class Group:
        world_size = 2

    bn.group = Group()
    with pytest.raises(ValueError, match="data group"):
        bn(x)


def test_sharded_dropout_draws_each_shard_in_order():
    """Train-mode dropout on a time-sharded clip: shard j's mask is the j-th
    draw from the generator, at the shard's shape, as flax's inverted
    dropout (kept values scaled by 1 / keep); a rate of 1 zeroes every
    shard."""
    from sap3d_tpu_torch.models.p3d import _Decoder

    mesh = _mesh("n4_two_devices")
    drop = _Decoder("bn", torch.float32, 0.25).train()
    x = torch.rand(2, 3, 8, 4, 4) + 0.5
    got = ts.gather(drop._drop(ts.shard(mesh, x), torch.Generator().manual_seed(5)))
    gen = torch.Generator().manual_seed(5)
    masks = [torch.empty(2, 3, 2, 4, 4).bernoulli_(0.75, generator=gen) for _ in range(4)]
    torch.testing.assert_close(got, x * torch.cat(masks, 2) / 0.75)
    drop.dropout_rate = 1.0
    assert not ts.gather(drop._drop(ts.shard(mesh, x), None)).any()


# ---- (b) planted faults -----------------------------------------------------


@pytest.mark.parametrize("fault,name,layout", [
    ("own_ends", "conv_k3", "n4"), ("own_ends", "conv_k2", "n4"),
    ("own_ends", "tconv_k3s2", "n4"), ("own_ends", "cbam", "n4"),
    ("own_ends", "conv_k3", "n4_two_devices"),
    ("per_shard_statistics", "bn_train", "n4"), ("per_shard_statistics", "sa_ring", "n4"),
    ("per_shard_statistics", "bn_train", "n4_two_devices"),
])
def test_planted_fault_fails_by_a_wide_margin(fault, name, layout):
    with planted_time_shard_fault(fault):
        worst, _ = _excess(name, layout, 2)
    assert worst > FAULT_EXCESS, worst * REL_TOL


@pytest.mark.parametrize("what", list(FP32_TOL))
def test_float32_shard_sums_reorder_within_rounding(what):
    """In float32 the shards' sums are added in another order than the whole
    clip's: BN's statistics over two devices (on data whose channel means
    are large against their spread, where E[x^2] - E[x]^2 cancels) and the
    loss differ by rounding alone."""
    mesh = _mesh("n4_two_devices")
    gen = torch.Generator().manual_seed(3)
    if what == "batch_norm":
        x = torch.randn(2, 8, 16, 6, 6, generator=gen) + 3.0
        bn = layers.BatchNorm(8).train()
        want, got = bn(x), ts.gather(copy.deepcopy(bn)(ts.shard(mesh, x)))
    else:
        pred = torch.rand(1, 64, 16, 16, 1, generator=gen)
        target = torch.rand(1, 64, 16, 16, generator=gen)
        want = loss_fn_saliency(pred, target)
        got = loss_fn_saliency(ts.shard(mesh, pred, time_dim=1),
                               ts.shard(mesh, target, time_dim=1))
    assert got.dtype == want.dtype == torch.float32
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= FP32_TOL[what], err


# ---- (c) the micro slice against JAX's time-sharded model --------------------


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's micro UNet++ SA model on 4 virtual devices with the clip's time
    axis sharded: its eval output and its train-mode gradient (dropout 0) at
    [1, 64, 16, 16, 3]; the port's weights."""
    shape = (1, 64, 16, 16, 3)
    jm, variables, tm = build_micro_pair("p3d_micro_sa", shape, seed=0, dropout_rate=0.0)
    rng = np.random.default_rng(0)
    frames = (rng.normal(size=shape) * 0.3).astype(np.float32)
    targets = rng.random(shape[:-1]).astype(np.float32)
    mesh = jax_time_mesh(4)
    tsh, repl = time_sharding(mesh), NamedSharding(mesh, PartitionSpec())
    fwd = jax.jit(lambda v, f: jm.apply(v, f, train=False), in_shardings=(repl, tsh))(
        variables, jax.device_put(frames, tsh))

    def loss(params, f, t):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, f,
                          train=True, mutable=["batch_stats"])
        return jax_loss(out, t)

    grads = jax.jit(jax.grad(loss), in_shardings=(repl, tsh, repl))(
        variables["params"], jax.device_put(frames, tsh), targets)
    return dict(weights=tm.state_dict(), frames=frames, targets=targets,
                eval=np.asarray(fwd)[..., 0], grads=jax.device_get(grads))


def _micro_sa(weights, mesh=None):
    cfg = {**MICRO, **treg.MODEL_REGISTRY["p3d_micro_sa"]}
    m = P3DSaliency(**cfg, dropout_rate=0.0, ring_mesh=mesh).eval()
    m.load_state_dict(weights)
    return m


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "gathered"])
def test_micro_sharded_eval_forward_matches_jax_time_sharded(jax_sharded, ring):
    mesh = _mesh("n4")
    model = _micro_sa(jax_sharded["weights"], mesh if ring else None)
    out = make_eval_step(model)(time_shard_batch(mesh, jax_sharded["frames"]))
    assert isinstance(out, ts.Shards) and out.shape == (1, 64, 16, 16)
    np.testing.assert_allclose(ts.gather(out).numpy(), jax_sharded["eval"], atol=EVAL_ATOL)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "gathered"])
def test_micro_sharded_gradient_matches_jax_time_sharded(jax_sharded, ring):
    mesh = _mesh("n4")
    model = _micro_sa(jax_sharded["weights"], mesh if ring else None).train()
    frames, targets = time_shard_batch(mesh, (jax_sharded["frames"], jax_sharded["targets"]))
    loss_fn_saliency(model(frames), targets).backward()
    total, per = grad_distance({n: p.grad for n, p in model.named_parameters()},
                               jax_sharded["grads"])
    assert total <= GRAD_TOL, total
    assert max(per.values()) <= 1, sorted(per.items(), key=lambda kv: -kv[1])[:3]


# ---- (d) micro models, sharded against unsharded in float64 -------------------


MODELS = {
    # the GN + CBAM family's decoder-block head with its three SA sites
    "gn_cbam_decoder_block": (dict(decoder="gn_decoder_block",
                                   decoder_kwargs=dict(use_sa=True), norm_mode="gn",
                                   backbone_cbam=True), "n2", False),
    "unetpp_nl": (dict(decoder="unetpp", decoder_kwargs=dict(attention="nl", head="ds"),
                       norm_mode="bn"), "n2", True),
    "unetpp_sa": (dict(decoder="unetpp", decoder_kwargs=dict(attention="sa", head="ds"),
                       norm_mode="bn"), TWO_DEVICES_TWO_SHARDS, True),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_micro_model_sharded_matches_unsharded_float64(name):
    """One train-mode forward's output, loss, gradient and BN buffers, and
    for the BN models the eval forward (the GN model's is its train-mode
    forward, dropout 0): at n = 2 the GN model's stage-3 shards hold 2
    frames, so CBAM's 7-frame window spans two neighbours on each side."""
    cfg, layout, ring = MODELS[name]
    mesh = _mesh(layout)
    n = len(mesh.devices)
    torch.manual_seed(0)
    ref = P3DSaliency(**cfg, **MICRO, dtype=F64, dropout_rate=0.0).double().eval()
    with torch.no_grad():  # random biases and scales: no relu sits at its kink
        for key, p in ref.named_parameters():
            if key.endswith("bias"):
                p.normal_(0.0, 0.1)
            elif key.endswith(("scale", "gamma")):
                p.uniform_(0.5, 1.5)
    sharded = copy.deepcopy(ref)
    for m in sharded.attention_modules():
        m.ring_mesh = mesh if ring else None
    gen = np.random.default_rng(4)
    t = 16 * n
    frames = (gen.normal(size=(1, t, 16, 16, 3)) * 0.3)
    targets = gen.random((1, t, 16, 16)).astype(np.float32)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    if cfg["norm_mode"] == "bn":
        want = make_eval_step(ref)(torch.from_numpy(frames))
        got = make_eval_step(sharded)(time_shard_batch(mesh, frames))
        assert rel(ts.gather(got), want) <= MODEL_OUT_TOL

    outs, losses, grads = [], [], []
    for model, x, y in ((ref, torch.from_numpy(frames), torch.from_numpy(targets)),
                        (sharded, *time_shard_batch(mesh, (frames, targets)))):
        model.train()
        out = model(x)
        loss = loss_fn_saliency(out, y)
        loss.backward()
        outs.append((ts.gather(out) if isinstance(out, ts.Shards) else out).detach())
        losses.append(loss.item())
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
    assert rel(outs[1], outs[0]) <= MODEL_OUT_TOL
    assert abs(losses[1] - losses[0]) <= FP32_TOL["loss"] * abs(losses[0])
    assert ((grads[1] - grads[0]).norm() / grads[0].norm()).item() <= MODEL_GRAD_TOL
    for (key, b), s in zip(ref.named_buffers(), sharded.buffers()):
        assert rel(s, b) <= REL_TOL, key
