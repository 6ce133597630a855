"""Tensor parallel in the port (``core/sharding_rules.py``, column-parallel
layers on a ``data`` x ``model`` mesh, one process per entry) against the
JAX package's ``state_sharding`` step, on the CPU.

The spec tests need no spawn and no JAX compile: JAX's
``infer_param_specs`` on ``jax.eval_shape`` parameters against the port's
on models built on the meta device.  One spawn of a dp2 x tp2 gloo group
(``_torch_tp_ranks.parity_rank``, one thread a rank) gives every other
reading; JAX runs on 4 of the 8 virtual devices (``conftest.py``)
meanwhile.  ``p3d_micro_sa`` at 16 px, a global batch of 4 (2 rows a data
index), dropout 0, coupled L2 ``weight_decay`` 1e-3, ``min_features`` 128
(22 sharded kernels: every layer kind the flagship shards).  Limits:

* against JAX's ``make_train_step(model, mesh=make_mesh_2d(2, 2),
  state_sharding=state_shardings(state, mesh, 128))``, one float32 step:
  the loss to rtol 1e-5 (``LOSS_RTOL``); the gathered parameters, Adam
  moments and BN running statistics under the single-device train test's
  limits (``_torch_parity.py``: ``assert_optimizer_close``,
  ``assert_stats_close``), as the data-parallel test holds them;
* against the port's one-device step at the global batch, float64: the
  summed gradient (sharded kernels gathered) to relative L2 ``GRAD_TOL64``
  (1e-6; measured 5.9e-13 here, where only the order of sums differs).
  Each planted fault fails it tenfold and more: the replicated gradients
  summed over the world (0.77 measured), the input gradient of a
  column-parallel layer not summed over the model row (0.99);
* after two float32 steps every replicated tensor (parameter, buffer, Adam
  state) is bit-identical on the four ranks, and each kernel slice and its
  moments on the two ranks of its data column; each local kernel holds
  1/2 of its output features;
* the GN + CBAM micro model of ``tests/test_tensor_parallel.py`` (7
  sharded kernels, a CBAM ``mlp_1`` ``Dense`` among them): one float32
  step's loss against the one-device step to JAX's rtol 2e-4 (0 measured),
  and the gathered ``mlp_1`` gradient to relative L2 ``DENSE_GRAD_TOL``
  (``GRAD_TOL`` / 10, the data-parallel test's float32 limit; 1.0e-6
  measured, the one-device step on one thread as each rank runs).  The
  float32 gradient of that kernel is itself only as good as its sums'
  order: the one-device step on two threads reads 1.5e-3 from one thread,
  and on eight 7.5e-3 from the float64 gradient.
"""

from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    GRAD_TOL,
    assert_optimizer_close,
    assert_stats_close,
    build_micro_pair,
    jax_params,
)
from _torch_tp_ranks import (
    GN_CBAM,
    LR,
    MIN_FEATURES,
    WEIGHT_DECAY,
    model_of,
    one_device_step,
    parity_rank,
)
from sap3d_tpu.core import sharding_rules as jsr
from sap3d_tpu.models import registry as jreg
from sap3d_tpu.models.p3d import P3DSaliency as JaxP3DSaliency
from sap3d_tpu.train.state import TrainState as JaxTrainState
from sap3d_tpu.train.state import make_optimizer as jax_make_optimizer
from sap3d_tpu.train.steps import make_train_step as jax_make_train_step
from sap3d_tpu_torch.core import sharding_rules as sr
from sap3d_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_backend,
    grid_ranks,
    launch,
    make_mesh,
)
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.models.p3d import P3DSaliency as TorchP3DSaliency
from sap3d_tpu_torch.ops.cbam import Dense
from sap3d_tpu_torch.ops.layers import Conv3d, ConvTranspose3d
from sap3d_tpu_torch.train.state import create_train_state

SHAPE = (4, 16, 16, 16, 3)  # global batch 4: 2 rows a data index
LOSS_RTOL = 1e-5
GRAD_TOL64 = 1e-6
GN_LOSS_RTOL = 2e-4
DENSE_GRAD_TOL = GRAD_TOL / 10


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm = build_micro_pair("p3d_micro_sa", SHAPE, seed=3, dropout_rate=0.0)
    rng = np.random.default_rng(4)
    frames = (rng.normal(size=SHAPE) * 0.5).astype(np.float32)
    targets = rng.uniform(size=SHAPE[:4]).astype(np.float32)
    with torch.random.fork_rng():
        torch.manual_seed(5)
        gn = TorchP3DSaliency(**GN_CBAM, dropout_rate=0.0).state_dict()
    micro = (dict(treg.MODEL_REGISTRY["p3d_micro_sa"]), tm.state_dict())
    return dict(jm=jm, variables=variables, micro=micro, gn=(GN_CBAM, gn), frames=frames,
                targets=targets)


def _jax_tp_step(pair) -> dict:
    """JAX's tensor-parallel step on a 2 x 2 mesh."""
    mesh = jsr.make_mesh_2d(2, 2)
    v = pair["variables"]
    tx = jax_make_optimizer(LR, WEIGHT_DECAY)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    shardings = jsr.state_shardings(state, mesh, MIN_FEATURES)
    step = jax_make_train_step(pair["jm"], mesh=mesh, donate=False, state_sharding=shardings)
    state, loss = step(jsr.apply_state_sharding(state, shardings),
                       jnp.asarray(pair["frames"]), jnp.asarray(pair["targets"]),
                       jax.random.PRNGKey(0))
    return dict(state=jax.tree.map(np.asarray, jax.device_get(state)), loss=float(loss))


@pytest.fixture(scope="module", autouse=True)
def started(pair):
    """The 4-rank group's run and JAX's step, each started first on a
    thread of its own, so that they and the spec tests overlap."""
    with ThreadPoolExecutor(2) as pool:
        yield dict(ranks=pool.submit(launch, sr.make_mesh_2d(2, 2, device="cpu"), parity_rank,
                                     pair["micro"], pair["gn"], pair["frames"],
                                     pair["targets"]),
                   jax=pool.submit(_jax_tp_step, pair))


@pytest.fixture(scope="module")
def jax_tp(started):
    return started["jax"].result()


@pytest.fixture(scope="module")
def one_device(pair):
    """The port's one-device steps at the global batch: p3d_micro_sa in
    float64, the GN + CBAM model in float32 (on one thread, as each rank
    runs, while the ranks run)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"f64": one_device_step(*pair["micro"], pair["frames"], pair["targets"],
                                       torch.float64),
                "gn": one_device_step(*pair["gn"], pair["frames"], pair["targets"],
                                      torch.float32)}
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(started, one_device):
    """Every rank's readings (after the one-device steps, which run
    meanwhile)."""
    return started["ranks"].result()


# ---- the sharding rule against JAX's ---------------------------------------

def _jax_model(name: str):
    if name == "gn_cbam_micro":
        return JaxP3DSaliency(**GN_CBAM)
    return jreg.build_model(name)


def _torch_model(name: str):
    with torch.device("meta"):
        if name == "gn_cbam_micro":
            return TorchP3DSaliency(**GN_CBAM)
        return treg.build_model(name, device="meta")


_JAX_PARAMS = {}


def _jax_shapes(name: str) -> dict:
    """{flax path: shape} of the JAX model's parameters (``jax.eval_shape``:
    nothing is computed), one evaluation per model."""
    if name not in _JAX_PARAMS:
        model = _jax_model(name)
        abstract = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 112, 112, 3)), train=False))
        _JAX_PARAMS[name] = abstract["params"]
    return _JAX_PARAMS[name]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if isinstance(v, Mapping) else {path: v})
    return out


# The port's kernel layouts: flax's axis of each port axis (interop/flax_bridge.py)
_FLAX_AXIS_OF = {Conv3d: (4, 3, 0, 1, 2), ConvTranspose3d: (3, 4, 0, 1, 2), Dense: (1, 0)}


def spec_mismatches(name: str, min_features: int, n_model: int) -> list:
    """Where the port's specs differ from JAX's: a leaf sharded on one side
    only, or sharded on another dim than the output-feature dim (flax's
    last) in the port's layout."""
    jmesh = jsr.make_mesh_2d(1, n_model)
    jspecs = _flat(jsr.infer_param_specs(_jax_shapes(name), jmesh, min_features))
    jax_sharded = {p.replace("/", ".") for p, s in jspecs.items()
                   if s != jax.sharding.PartitionSpec()}
    model = _torch_model(name)
    specs = sr.infer_param_specs(model, sr.make_mesh_2d(1, n_model, device="cpu"), min_features)
    port_sharded = {n for n, d in specs.items() if d is not None}
    bad = [("only in JAX", n) for n in sorted(jax_sharded - port_sharded)]
    bad += [("only in the port", n) for n in sorted(port_sharded - jax_sharded)]
    modules = dict(model.named_modules())
    for n in sorted(port_sharded & jax_sharded):
        layer = modules[n.rsplit(".", 1)[0]]
        if _FLAX_AXIS_OF[type(layer)][specs[n]] != layer.kernel.dim() - 1:
            bad.append(("not the output-feature dim", n, type(layer).__name__, specs[n]))
    return bad


@pytest.mark.parametrize("name,min_features,n_model,leaves", [
    ("p3d_micro_sa", MIN_FEATURES, 2, 22),
    ("p3d_micro_sa", MIN_FEATURES, 4, 22),
    ("gn_cbam_micro", MIN_FEATURES, 2, 7),
    ("gn_cbam_micro", MIN_FEATURES, 4, 7),
    ("p3d_unetplusplus_ds", 512, 2, 52),
    ("inference_p3d_sa_decoder_block", 512, 2, 97),
    ("p3d_micro_sa", MIN_FEATURES, 3, 0),  # no width of 128 or more divides by 3
])
def test_param_specs_match_jax_leaf_for_leaf(name, min_features, n_model, leaves):
    assert spec_mismatches(name, min_features, n_model) == []
    model = _torch_model(name)
    specs = sr.infer_param_specs(model, sr.make_mesh_2d(1, n_model, device="cpu"),
                                 min_features)
    params = dict(model.named_parameters())
    sharded = {n: d for n, d in specs.items() if d is not None}
    assert len(sharded) == leaves
    assert all(params[n].shape[d] % n_model == 0 for n, d in sharded.items())
    if n_model == 3:  # wide kernels exist, and stay replicated
        assert any(n.endswith("kernel") and max(p.shape[:2]) >= min_features
                   for n, p in params.items())
    millions = {"p3d_unetplusplus_ds": 27.39, "inference_p3d_sa_decoder_block": 81.92}
    if name in millions:
        total = sum(params[n].numel() for n in sharded)
        assert round(total / 1e6, 2) == millions[name]
    if name == "gn_cbam_micro":
        assert any(".cbam.ch_at.mlp_1." in n for n in sharded)


def test_a_transposed_conv_sharded_on_its_input_dim_fails(monkeypatch):
    """A planted rule that shards ``ConvTranspose3d`` on dim 0 (its input
    features in the port's layout) is caught leaf by leaf."""
    monkeypatch.setitem(sr.OUTPUT_FEATURE_DIM, ConvTranspose3d, 0)
    bad = spec_mismatches("p3d_micro_sa", MIN_FEATURES, 2)
    assert any(b[0] == "not the output-feature dim" and b[2] == "ConvTranspose3d"
               for b in bad), bad


def test_widths_that_do_not_divide_stay_replicated():
    layer = torch.nn.Module()
    layer.a = Conv3d(4, 6, 1)
    layer.b = ConvTranspose3d(6, 8, 3, 2)
    layer.c = Dense(8, 2)
    two, four = (sr.make_mesh_2d(1, m, device="cpu") for m in (2, 4))
    assert sr.infer_param_specs(layer, two, 4) == {
        "a.kernel": 0, "a.bias": None, "b.kernel": 1, "b.bias": None, "c.kernel": None,
        "c.bias": None}
    assert sr.infer_param_specs(layer, four, 4)["a.kernel"] is None  # 6 % 4
    assert sr.infer_param_specs(layer, four, 4)["b.kernel"] == 1
    assert set(sr.infer_param_specs(layer, sr.make_mesh_2d(2, 1, device="cpu"), 4).values()) \
        == {None, 0, 1}  # a model axis of 1 divides everything
    one_axis = sr.infer_param_specs(layer, make_mesh(2, device="cpu"), 4)
    assert set(one_axis.values()) == {None}  # a mesh without a model axis


@pytest.mark.parametrize("layer", [Conv3d(4, 4, 1), ConvTranspose3d(4, 4, 3, 2)],
                         ids=["conv", "tconv"])
def test_a_time_sharded_clip_through_a_sliced_layer_raises(layer):
    from sap3d_tpu_torch.core.mesh import DataGroup, make_time_mesh
    from sap3d_tpu_torch.ops import time_shard

    layer.model_group = DataGroup(0, 2, torch.device("cpu"), "gloo")
    clip = time_shard.shard(make_time_mesh(2, devices=["cpu"] * 2), torch.zeros(1, 4, 4, 3, 3))
    with pytest.raises(ValueError, match="time-sharded"):
        layer(clip)


def test_moments_take_their_parameters_shape():
    """``load_optimizer_state`` takes a slice's moments for a slice, and
    refuses a moment of another shape."""
    model = torch.nn.Module()
    model.a = Conv3d(4, 6, 1)
    state = create_train_state(model)
    moments = {n: {"step": torch.tensor(1.0), "exp_avg": torch.ones_like(p),
                   "exp_avg_sq": torch.ones_like(p)} for n, p in model.named_parameters()}
    state.load_optimizer_state(moments)
    moments["a.kernel"]["exp_avg"] = torch.ones(3, 4, 1, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        state.load_optimizer_state(moments)



def _grid_group(n_data=2, n_model=2):
    """Rank 0's group of a data x model mesh, with no process group behind
    it (enough for what raises before any collective)."""
    from sap3d_tpu_torch.core.mesh import DataGroup

    cpu = torch.device("cpu")
    return DataGroup(0, n_data * n_model, cpu, "gloo", data=DataGroup(0, n_data, cpu, "gloo"),
                     model=DataGroup(0, n_model, cpu, "gloo"))


@pytest.mark.parametrize("case", ["grid_without_sharding", "sharding_without_grid",
                                  "sharded_state_without_sharding"])
def test_a_tensor_parallel_step_takes_its_grid_and_its_sharding_together(case):
    from sap3d_tpu_torch.core.mesh import DataGroup
    from sap3d_tpu_torch.train.steps import make_train_step

    model = torch.nn.Module()
    model.a = Conv3d(4, 8, 1)
    state = create_train_state(model)
    sharding = sr.state_shardings(state, sr.make_mesh_2d(2, 2, device="cpu"), 8)
    flat = DataGroup(0, 2, torch.device("cpu"), "gloo")
    args = {"grid_without_sharding": (_grid_group(), None),
            "sharding_without_grid": (flat, sharding),
            "sharded_state_without_sharding": (None, None)}[case]
    if case == "sharded_state_without_sharding":
        state.sharding = sharding
    with pytest.raises(ValueError, match="together|otherwise"):
        make_train_step(state, *args)


def test_specs_of_a_sharded_model_raise():
    model = torch.nn.Module()
    model.a = Conv3d(4, 8, 1)
    model.a.model_group = _grid_group().model
    with pytest.raises(ValueError, match="already a slice"):
        sr.infer_param_specs(model, sr.make_mesh_2d(1, 2, device="cpu"), 4)


# ---- the mesh --------------------------------------------------------------

def test_mesh_2d_rules():
    cards = [f"cuda:{i}" for i in range(6)]
    mesh = sr.make_mesh_2d(2, 3, devices=cards)
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 3}
    assert mesh.devices == tuple(torch.device(c) for c in cards)  # rank r at (r // 3, r % 3)
    assert grid_ranks(6, 3) == ([[0, 3], [1, 4], [2, 5]], [[0, 1, 2], [3, 4, 5]])
    assert grid_ranks(4, 2) == ([[0, 2], [1, 3]], [[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="grid"):
        grid_ranks(6, 4)
    with pytest.raises(ValueError, match="exceeds"):
        sr.make_mesh_2d(2, 2, devices=["cuda:0"] * 3)
    with pytest.raises(ValueError, match="exceeds"):
        sr.make_mesh_2d(2, 2)  # the visible cards: none here
    assert data_backend(sr.make_mesh_2d(2, 2, devices=cards[:4])) == "nccl"
    assert data_backend(sr.make_mesh_2d(2, 2, devices=["cuda:0"] * 4)) == "gloo"
    cpu = sr.make_mesh_2d(2, 2, device="cpu")
    assert cpu.devices == (torch.device("cpu"),) * 4 and data_backend(cpu) == "gloo"
    with pytest.raises(ValueError, match="one process"):
        sr.make_mesh_2d(2, 2, device="cpu", cluster=object())


def test_ranks_sit_on_the_grid(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


# ---- the step against JAX's and against one device -------------------------

def test_tp_step_matches_jax_state_sharding_step(pair, jax_tp, ranks):
    got = ranks[0]["f32"]
    np.testing.assert_allclose(got["losses"][0], jax_tp["loss"], rtol=LOSS_RTOL)
    cfg, weights = pair["micro"]
    tm0 = model_of(cfg, weights)
    before = {n: p.detach().clone() for n, p in tm0.named_parameters()}
    jax_before = jax_params(tm0, pair["variables"]["params"])
    tm = model_of(cfg, weights)
    tm.load_state_dict(got["state"])
    state = create_train_state(tm, lr=LR, weight_decay=WEIGHT_DECAY)
    state.load_optimizer_state(got["moments"])
    assert_optimizer_close(tm, state.optimizer, before, jax_before, jax_tp["state"],
                           same_start=True, lr=LR)
    assert_stats_close(tm, jax_tp["state"], 1)


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(((got[n].double() - w.double()) ** 2).sum() for n, w in want.items()).sqrt()
    return (num / sum((w.double() ** 2).sum() for w in want.values()).sqrt()).item()


@pytest.mark.parametrize("fault", [None, "world_summed_replicated",
                                   "input_gradient_not_reduced"])
def test_float64_gradient_matches_one_device_and_the_faults_fail(ranks, one_device, fault):
    """The summed gradient against one device's under ``GRAD_TOL64``; each
    planted fault at least ten times over it."""
    want = one_device["f64"]
    got = ranks[0][fault or "f64"]
    assert set(got["grads"]) == set(want["grads"])
    assert got["losses"][0] == pytest.approx(want["loss"], rel=1e-12)
    dist = _rel_l2(got["grads"], want["grads"])
    if fault is None:
        assert dist <= GRAD_TOL64
    else:
        assert dist > 10 * GRAD_TOL64


def test_ranks_agree_bit_for_bit_where_the_rules_say(ranks):
    """After two steps: replicated tensors on all four ranks, slices on
    each data column (ranks 0 and 2, 1 and 3); slices of one row differ."""
    sharded = set(ranks[0]["shapes"])
    local = [r["local"] for r in ranks]

    def of_slice(key):
        return any(key == f"model/{n}" or key.startswith(f"optimizer/{n}/") for n in sharded)

    keys = set(local[0])
    assert all(set(x) == keys for x in local)
    replicated = {k for k in keys if not of_slice(k)}
    slices = keys - replicated
    assert len(slices) == 3 * len(sharded) + len(sharded)  # kernel, exp_avg, exp_avg_sq, step
    for x in local[1:]:
        for k in replicated:
            assert torch.equal(x[k], local[0][k]), k
    for a, b in ((0, 2), (1, 3)):
        for k in slices:
            assert torch.equal(local[a][k], local[b][k]), k
    assert not all(torch.equal(local[0][f"model/{n}"], local[1][f"model/{n}"])
                   for n in sharded)


def test_local_kernels_hold_half_their_output_features(pair, ranks):
    full = dict(model_of(*pair["micro"]).named_parameters())
    modules = dict(model_of(*pair["micro"]).named_modules())
    for r in ranks:
        assert len(r["shapes"]) == 22
        for n, shape in r["shapes"].items():
            dim = sr.OUTPUT_FEATURE_DIM[type(modules[n.rsplit(".", 1)[0]])]
            want = list(full[n].shape)
            want[dim] //= 2
            assert list(shape) == want, n


def test_gn_cbam_step_matches_one_device(ranks, one_device):
    got, want = ranks[0]["gn"], one_device["gn"]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=GN_LOSS_RTOL)
    dense = [n for n in ranks[0]["gn"]["shapes"] if ".mlp_1." in n]
    assert dense
    assert _rel_l2({n: got["grads"][n] for n in dense},
                   {n: want["grads"][n] for n in dense}) <= DENSE_GRAD_TOL
