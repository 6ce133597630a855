"""Parity of the port's layers (sap3d_tpu_torch/ops/layers.py) with the JAX
package's, on the CPU in float32.

Inputs and weights are made with numpy from a seed and handed to both.  The
port works NCDHW, the JAX package NDHWC; the tests transpose at the edges.
Tolerance: 1e-5 absolute on O(1) values — both sides compute in float32
and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.ops import layers as jl
from sap3d_tpu_torch.interop.flax_bridge import convert_leaf
from sap3d_tpu_torch.ops import layers as tl

ATOL = 1e-5


def _to_t(x):  # NDHWC numpy -> NCDHW torch
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _to_np(y):  # NCDHW torch -> NDHWC numpy
    return y.detach().numpy().transpose(0, 2, 3, 4, 1)


def _load(module, params, prefix):
    """Copy a flax params tree into a port module through the bridge's leaf
    conversion."""
    sd = {}

    def walk(tree, path):
        for k, v in tree.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                sd[p.replace("/", ".")] = torch.from_numpy(
                    np.ascontiguousarray(convert_leaf(f"{prefix}/{p}", np.asarray(v))))

    walk(params, "")
    module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("n,k,s,want", [
    (112, 7, 2, (2, 3)),   # stem H/W
    (56, 3, 2, (0, 1)),    # stem max-pool H/W
    (2, 2, 1, (0, 1)),     # x_3_1 conv depth
    (16, 1, 1, (0, 0)),
    (8, 3, 1, (1, 1)),
])
def test_same_pads_match_xla(n, k, s, want):
    assert tl.same_pads(n, k, s) == want


# Every (kernel, stride) of a conv on the flagship path.
CONV_CASES = [
    ((1, 7, 7), (1, 2, 2), False),  # stem
    ((1, 1, 1), (1, 1, 1), False),  # reduce / expand / proj
    ((1, 1, 1), (1, 2, 2), False),  # strided reduce / proj on stage entry
    ((1, 3, 3), (1, 1, 1), True),   # conv_s
    ((3, 1, 1), (1, 1, 1), True),   # conv_t
    ((2, 3, 3), (1, 1, 1), True),   # x_3_1
    ((3, 3, 3), (1, 1, 1), True),   # x_2_1 .. x_1_3
]


@pytest.mark.parametrize("kernel,strides,bias", CONV_CASES,
                         ids=[f"k{''.join(map(str, k))}s{''.join(map(str, s))}"
                              for k, s, _ in CONV_CASES])
def test_conv_same_matches_flax(kernel, strides, bias):
    shape = (2, 3, 9, 10, 3)  # odd and even extents
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    cin, cout = shape[-1], 6
    fm = nn.Conv(cout, kernel, strides, padding="SAME", use_bias=bias)
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if bias:
        params = {"kernel": params["kernel"],
                  "bias": rng.normal(size=(cout,)).astype(np.float32)}
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.Conv3d(cin, cout, kernel, strides, use_bias=bias)
    _load(tm, params, "Conv_0")
    got = _to_np(tm(_to_t(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


# Every transposed conv of the flagship decoder, plus k=3 s=1 (crop one on
# each side, the concat decoder's deconv_pool2).
TCONV_CASES = [
    ((1, 3, 3), (2, 2, 2)),  # upx_4_0: k=1 s=2 needs output_padding
    ((2, 3, 3), (2, 2, 2)),  # upx_3_0 / upx_3_1
    ((3, 3, 3), (2, 2, 2)),  # upx_2_* and the x_0_1 head
    ((3, 3, 3), (1, 1, 1)),
]


@pytest.mark.parametrize("kernel,strides", TCONV_CASES,
                         ids=[f"k{''.join(map(str, k))}s{''.join(map(str, s))}"
                              for k, s in TCONV_CASES])
def test_tconv_same_matches_flax(kernel, strides):
    shape = (2, 3, 3, 4, 3)
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    cin, cout = shape[-1], 4
    fm = nn.ConvTranspose(cout, kernel, strides, padding="SAME")
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": rng.normal(size=(cout,)).astype(np.float32)}
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.ConvTranspose3d(cin, cout, kernel, strides)
    _load(tm, params, "ConvTranspose_0")
    got = _to_np(tm(_to_t(x)))
    assert got.shape == want.shape == tuple(
        [shape[0]] + [n * s for n, s in zip(shape[1:4], strides)] + [cout])
    np.testing.assert_allclose(got, want, atol=ATOL)


# The transposed convs the other decoders add; at stride 4 the stride exceeds
# the kernel, so some outputs see no input and hold the bias alone.
WIDE_TCONV_CASES = [
    ((3, 3, 3), (4, 4, 4)),  # deconv_pool4 of the concat and GN easy decoders
    ((1, 3, 3), (4, 4, 4)),  # deconv_pool4 of the GN decoder block: k=1 s=4 in time
    ((3, 3, 3), (1, 1, 1)),  # deconv_pool2
    ((1, 3, 3), (2, 2, 2)),  # k=1 with a temporal stride of 2
]


@pytest.mark.parametrize("kernel,strides", WIDE_TCONV_CASES,
                         ids=[f"k{''.join(map(str, k))}s{''.join(map(str, s))}"
                              for k, s in WIDE_TCONV_CASES])
def test_wide_stride_tconv_matches_flax_per_element(kernel, strides):
    """Tolerance 1e-6: float32 sums of at most 27 * 3 terms in another order."""
    shape = (2, 2, 3, 4, 3)
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    cin, cout = shape[-1], 4
    fm = nn.ConvTranspose(cout, kernel, strides, padding="SAME")
    params = {"kernel": rng.normal(size=(*kernel, cin, cout)).astype(np.float32) * 0.3,
              "bias": rng.normal(size=(cout,)).astype(np.float32)}
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.ConvTranspose3d(cin, cout, kernel, strides)
    _load(tm, params, "ConvTranspose_0")
    got = _to_np(tm(_to_t(x)))
    assert got.shape == want.shape == tuple(
        [shape[0]] + [n * s for n, s in zip(shape[1:4], strides)] + [cout])
    np.testing.assert_allclose(got, want, atol=1e-6)
    bias_only = np.isclose(want, params["bias"], atol=0).all(axis=-1)
    # stride 4 along an axis of kernel 3 (or 1) leaves one (or three) of
    # every four outputs on it with the bias alone
    assert bias_only.any() == any(s > k for k, s in zip(kernel, strides))


@pytest.mark.parametrize("window,strides,padding", [
    ((2, 1, 1), (2, 1, 1), "SAME"),   # temporal pools
    ((2, 3, 3), (2, 2, 2), "SAME"),   # stem pool: -inf padding on the high side
    ((2, 2, 2), (2, 2, 2), "VALID"),  # pool3d(2), the x_1_3 key/value pooling
])
def test_max_pool_matches_jax(window, strides, padding):
    rng = np.random.default_rng(2)
    # negative inputs: a zero pad would win the max where -inf must not
    x = (rng.normal(size=(2, 4, 7, 8, 3)) - 5.0).astype(np.float32)
    want = np.asarray(jl.max_pool3d(jnp.asarray(x), window, strides, padding))
    got = _to_np(tl.max_pool3d(_to_t(x), window, strides, padding))
    np.testing.assert_array_equal(got, want)
    got_p = _to_np(tl.pool3d(_to_t(x), 2))
    np.testing.assert_array_equal(got_p, np.asarray(jl.pool3d(jnp.asarray(x), 2)))


@pytest.mark.parametrize("mode", ["bn", "gn", "none"])
def test_norm_eval_matches_flax(mode):
    rng = np.random.default_rng(3)
    c = 64  # > 32: GroupNorm groups = min(32, C) = 32
    x = rng.normal(size=(2, 2, 3, 3, c)).astype(np.float32)
    fm = jl.Norm(mode)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables)
    want = np.asarray(fm.apply(variables, jnp.asarray(x), train=False))
    tm = tl.Norm(mode, c).eval()
    sd = {}
    for col in variables.values():
        for sub, leaves in col.items():
            for k, v in leaves.items():
                sd[f"{sub}.{k}"] = torch.from_numpy(np.asarray(v))
    tm.load_state_dict(sd, strict=True)
    got = _to_np(tm(_to_t(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv_norm_relu_parts_and_tconv_block_match_flax():
    """ConvNormRelu over a tuple of parts (the decoder's dense skips) and
    TransposeConvNormRelu, with random BN statistics."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(1, 2, 5, 5, 3)).astype(np.float32)
    b = rng.normal(size=(1, 2, 5, 5, 4)).astype(np.float32)

    def randomize(variables):
        return jax.tree.map(
            lambda v: v if v.ndim == 5 else
            rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables)

    def run(fm, tm, x_j, x_t, prefix):
        variables = randomize(fm.init(jax.random.PRNGKey(0), x_j, train=False))
        want = np.asarray(fm.apply(variables, x_j, train=False))
        flat = {}
        for col in ("params", "batch_stats"):
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables[col])[0]:
                p = "/".join(k.key for k in path)
                flat[p.replace("/", ".")] = torch.from_numpy(
                    np.ascontiguousarray(convert_leaf(f"{prefix}/{p}", np.asarray(leaf))))
        tm.load_state_dict(flat, strict=True)
        return want, tm.eval()(x_t)

    want, got = run(jl.ConvNormRelu(6, (2, 3, 3)), tl.ConvNormRelu(7, 6, (2, 3, 3)),
                    (jnp.asarray(a), jnp.asarray(b)), (_to_t(a), _to_t(b)), "x")
    np.testing.assert_allclose(_to_np(got), want, atol=ATOL)
    want, got = run(jl.TransposeConvNormRelu(5, (1, 3, 3), 2),
                    tl.TransposeConvNormRelu(3, 5, (1, 3, 3), 2),
                    jnp.asarray(a), _to_t(a), "x")
    np.testing.assert_allclose(_to_np(got), want, atol=ATOL)


def test_bf16_conv_casts_weights_and_input():
    """Parameters stay float32; the compute dtype applies at call time."""
    tm = tl.Conv3d(3, 4, 3, dtype=torch.bfloat16)
    assert tm.kernel.dtype == torch.float32
    y = tm(torch.randn(1, 3, 2, 4, 4))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 2, 4, 4)
