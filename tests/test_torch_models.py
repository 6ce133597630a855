"""Parity of the port's model (sap3d_tpu_torch/models) with the JAX package's.

The micro models (the flagship topology at CI scale) run the whole eval
forward in both packages on the CPU in float32, with the flax weights
carried across by ``state_dict_from_flax``.  Weights, biases, BN
statistics and ``gamma`` are made with numpy from a seed and are random, so
every attention site and every BN contributes.
Tolerance: 1e-5 absolute on the sigmoid output (float32 on both sides; the
observed gap is ~1e-7).

The flagship itself is checked without a forward: the bridge's key and
shape coverage and the parameter count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sap3d_tpu.models import registry as jreg
from _torch_parity import build_micro_pair, build_pair
from sap3d_tpu_torch.interop.flax_bridge import convert_leaf
from sap3d_tpu_torch.models import registry as treg
from sap3d_tpu_torch.train.steps import make_eval_step

ATOL = 1e-5


@pytest.mark.parametrize("name", ["p3d_micro_sa", "p3d_micro"])
def test_micro_eval_forward_matches_flax(name):
    shape = (1, 16, 32, 32, 3)
    jm, variables, tm = build_pair(name, shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, train=False)[..., 0])(
        variables, jnp.asarray(x)))
    got = make_eval_step(tm)(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 16, 32, 32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    sites = tm.attention_modules()
    assert len(sites) == (4 if name == "p3d_micro_sa" else 0)
    if sites:  # gamma matters: zeroing it moves the output well past ATOL
        with torch.no_grad():
            for m in sites:
                m.gamma.zero_()
        moved = make_eval_step(tm)(torch.from_numpy(x)).numpy()
        assert np.abs(moved - want).max() > 1e-3


@pytest.mark.parametrize("name", ["p3d_micro_sa", "p3d_micro"])
def test_micro_bf16_eval_forward_matches_flax_bf16(name):
    """Mixed precision as flax's: the bf16 eval forward of both packages on
    the same weights.  Both round at every layer, so they agree only to bf16
    rounding: the port's output may be no farther from JAX's bf16 output
    (mean and max) than twice JAX's own bf16 output is from its fp32 output
    (observed ratio about 1.0).  Its sigmoid runs in float32, as XLA runs
    the JAX model's: with the sigmoid in bf16 the maximum ratio was 1.2-1.3."""
    shape = (1, 16, 32, 32, 3)
    jm, variables, tm = build_pair(name, shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)

    def jax_forward(model):
        return np.asarray(jax.jit(lambda v, f: model.apply(v, f, train=False)[..., 0])(
            variables, jnp.asarray(x)))

    j32 = jax_forward(jm)
    j16 = jax_forward(jreg.build_model(name, dtype="bfloat16"))
    tm16 = treg.build_model(name, dtype="bfloat16", device="cpu")
    tm16.load_state_dict(tm.state_dict())
    got = make_eval_step(tm16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == j16.shape
    # bf16 really moved both outputs
    assert (got - make_eval_step(tm)(torch.from_numpy(x))).abs().mean() > 1e-5
    gap, jax_gap = np.abs(got.numpy() - j16), np.abs(j16 - j32)
    assert jax_gap.mean() > 1e-4
    assert gap.mean() <= 2 * jax_gap.mean() and gap.max() <= 2 * jax_gap.max()


def test_flagship_bridge_covers_every_key_and_shape():
    """Every flax leaf of the flagship maps to a port key of the converted
    shape and every port key is filled; 84-86 M parameters."""
    jm = jreg.build_model("unet++")
    abstract = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 112, 112, 3)),
                        train=False))
    flax_shapes = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(abstract[col])[0]:
            p = "/".join(k.key for k in path)
            zero = np.broadcast_to(np.float32(0), leaf.shape)  # no memory
            flax_shapes[p.replace("/", ".")] = convert_leaf(p, zero).shape

    with torch.device("meta"):  # no full-width initialization on the CPU first
        tm = treg.build_model("unet++", device="meta")
    torch_shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert flax_shapes == torch_shapes
    n_params = sum(p.numel() for p in tm.parameters())
    n_flax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(abstract["params"]))
    assert n_params == n_flax
    assert 84e6 <= n_params <= 86e6
    assert len(tm.attention_modules()) == 4


def test_registry_tables_match_jax():
    assert treg.MODEL_REGISTRY == jreg.MODEL_REGISTRY
    assert treg.STRUCTURE_ALIASES == jreg.STRUCTURE_ALIASES
    assert treg.LINEAR_OUTPUT == jreg.LINEAR_OUTPUT
    assert treg.resolve_name("unet++") == "p3d_unetplusplus_ds"


# The ten names beyond the flagship's family: the rest of the BN family and
# the GN + CBAM family, each on the micro encoder (the decoders keep their
# own widths, up to 1024 channels).
OTHER_NAMES = ["p3d_unet", "p3d_concat", "p3d_unetplusplus", "p3d_unetplusplus_nl",
               "inference_p3d", "inference_p3d_concat", "inference_p3d_sa_concat",
               "inference_p3d_sa_concat_2", "inference_p3d_sa_decoder_block",
               "inference_p3d_decoder_block"]


@pytest.mark.parametrize("name", OTHER_NAMES)
def test_every_other_name_eval_forward_matches_flax(name):
    """Tolerance, of the output's largest magnitude or of 1 (the
    linear-output decoders are not bounded by a sigmoid): 1e-5 for the BN
    names; 1e-4 for the GN names, whose float32 forward is itself that far
    from exact at this size (GroupNorm over 8 to 64 elements a group: against
    a float64 forward of the port, JAX's float32 output is 2.3e-5 to 3.8e-5
    away and the port's 4e-6 to 1.2e-5, measured on three GN names; the two
    float32 outputs are 1.7e-5 to 3.1e-5 apart)."""
    shape = (1, 16, 32, 32, 3)
    jm, variables, tm = build_micro_pair(name, shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, train=False)[..., 0])(
        variables, jnp.asarray(x)))
    got = make_eval_step(tm)(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 16, 32, 32) and got.dtype == torch.float32
    tol = 1e-4 if treg.MODEL_REGISTRY[name]["norm_mode"] == "gn" else ATOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol * max(1.0, np.abs(want).max()))
    linear = name in treg.LINEAR_OUTPUT
    assert linear == bool(want.min() < 0 or want.max() > 1)  # sigmoid or not
    assert ("batch_stats" in variables) == (treg.MODEL_REGISTRY[name]["norm_mode"] == "bn")
    sites = tm.attention_modules()
    if sites:  # gamma matters: zeroing it moves the output well past the tolerance
        with torch.no_grad():
            for m in sites:
                m.gamma.zero_()
        moved = make_eval_step(tm)(torch.from_numpy(x)).numpy()
        assert np.abs(moved - want).max() > 1e-3 * max(1.0, np.abs(want).max())


def test_every_registry_name_builds():
    """All 14 names build at full width (on the meta device: no memory) and
    every alias names one of them; the GN SA decoder has the parameter count
    of the flax model."""
    assert len(treg.MODEL_REGISTRY) == 14
    with torch.device("meta"):  # no full-width initialization on the CPU first
        for name in treg.MODEL_REGISTRY:
            assert not treg.build_model(name, device="meta").training
        tm = treg.build_model("P3D_SA_DECODER", device="meta")
    assert all(treg.resolve_name(a) in treg.MODEL_REGISTRY for a in treg.STRUCTURE_ALIASES)
    jm = jreg.build_model("P3D_SA_DECODER")
    abstract = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 112, 112, 3)), train=False))
    assert "batch_stats" not in abstract
    n_flax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(abstract["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_flax
    assert not list(tm.buffers())
    assert len(tm.attention_modules()) == 3


def test_bf16_model_keeps_float32_params_and_output():
    tm = treg.build_model("p3d_micro", dtype="bfloat16", device="cpu")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    out = tm(torch.zeros(1, 16, 32, 32, 3))
    assert out.dtype == torch.float32 and out.shape == (1, 16, 32, 32, 1)
