"""The float32 route of the flash kernels (B1-B4) as split-bf16 products,
on the CPU.

The CUDA kernels take a float32 product as six bf16 products of the
operands' hi, mid and lo planes (``csrc/split_bf16.cuh``).  Here the plain
versions of that arithmetic stand in for them: ``split_bf16x3`` (the
planes) and ``split_product`` (the six products, each exact in float32,
added small first), and below a flash forward and backward built on them
as the kernels are (the scores, P V, dP, dQ, dK and dV each a split
product; the softmax and the row terms in float32).

* the planes give float32 back to within 2^-24 of each value;
* the six-product forward (o, lse) and backward (dq, dk, dv) against the
  JAX package's Pallas kernels in interpret mode, float32, at the bound
  ``test_torch_flash_backward.py`` holds the plain versions to (rtol 1e-4,
  atol 1e-5, scaled to the largest element for the gradients), and
  against the port's plain versions under the kernels' unchanged limits
  (``TOLERANCE``, ``LSE_TOLERANCE``, ``DV_ROW_TOLERANCE``);
* one product of the inputs rounded to bf16 fails those limits, so the
  limits can see a plane that is missing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.ops.pallas.flash_attention import _flash_backward, _flash_forward
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

# ragged Nq (the JAX kernels pad to 256 rows), Nk not a multiple of 64, d != C
SHAPES = [(2, 300, 100, 16, 64), (1, 260, 200, 32, 128)]
ONE_PRODUCT = ((0, 0),)


def _shape_id(shape):
    return "x".join(str(n) for n in shape)


def _inputs(b, nq, nk, d, c, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, d)) * d ** -0.25
    k = rng.normal(size=(b, nk, d)) * d ** -0.25
    v = rng.normal(size=(b, nk, c))
    do = rng.normal(size=(b, nq, c))
    return [torch.tensor(a, dtype=torch.float32) for a in (q, k, v, do)]


def split_forward(q, k, v, products=fa.SPLIT_PRODUCTS):
    """(o, lse) as the kernel computes them: scores and P V as split
    products, the softmax in float32 with p = exp(s - m) unnormalised."""
    s = fa.split_product(q, k.transpose(1, 2), products)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    o = fa.split_product(p, v, products) / lsum
    return o, (m + torch.log(lsum))[..., 0]


def split_backward(q, k, v, o, lse, do, products=fa.SPLIT_PRODUCTS):
    """(dq, dk, dv) as the kernels compute them: every product split."""
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp(fa.split_product(q, k.transpose(1, 2), products) - lse[..., None])
    ds = p * (fa.split_product(do, v.transpose(1, 2), products) - delta)
    return (fa.split_product(ds, k, products),
            fa.split_product(ds.transpose(1, 2), q, products),
            fa.split_product(p.transpose(1, 2), do, products))


@pytest.mark.parametrize("scale", [1.0, 1e30, 1e-30, 0.0], ids=["unit", "large", "tiny", "zero"])
def test_planes_give_float32_back(scale):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * scale
    hi, mid, lo = fa.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = hi.double() + mid.double() + lo.double()
    assert ((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    # each plane holds what the one before it could not: at most half a
    # bf16 ulp of it (2^-8 relative)
    assert (mid.double().abs() <= 2.0 ** -8 * hi.double().abs()).all()
    assert (lo.double().abs() <= 2.0 ** -8 * mid.double().abs()).all()


def test_six_products_are_a_float32_product_and_one_is_not():
    gen = torch.Generator().manual_seed(1)
    a, b = torch.randn(8, 300, 64, generator=gen), torch.randn(8, 64, 200, generator=gen)
    exact = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    six = (fa.split_product(a, b).double() - exact).abs() / scale
    f32 = (torch.matmul(a, b).double() - exact).abs() / scale
    one = (fa.split_product(a, b, ONE_PRODUCT).double() - exact).abs() / scale
    assert six.max() <= 4 * f32.max() and six.max() < 2.0 ** -20
    assert one.max() > 2.0 ** -12


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_six_product_flash_matches_pallas_in_float32(shape):
    """The emulated kernels against ``_flash_forward`` and
    ``_flash_backward`` in the Pallas interpreter, on the same inputs."""
    q, k, v, do = _inputs(*shape)
    j = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = _flash_forward(*j[:3], want_lse=True)
        want = _flash_backward(*j[:3], j[3], jo, jlse)
    o, lse = split_forward(q, k, v)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse[:, 0]), rtol=1e-5, atol=1e-5)
    got = split_backward(q, k, v, torch.tensor(np.asarray(jo)),
                         torch.tensor(np.asarray(jlse[:, 0])), do)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_six_products_pass_the_kernels_float32_limits(shape):
    """The emulated kernels against the port's plain versions under the
    limits the card holds the kernels to."""
    q, k, v, do = _inputs(*shape, seed=2)
    want_o, want_lse = fa.flash_forward_lse_reference(q, k, v)
    o, lse = split_forward(q, k, v)
    assert fa.agreement(o, want_o)["excess"] <= 1
    assert fa.agreement(lse, want_lse, fa.LSE_TOLERANCE)["excess"] <= 1
    want = fb.flash_backward_reference(q, k, v, want_o, want_lse, do)
    got = split_backward(q, k, v, want_o, want_lse, do)
    for i, (g, w) in enumerate(zip(got, want)):
        rows = fb.DV_ROW_TOLERANCE if i == 2 else None
        check = fa.agreement(g, w, fb.TOLERANCE, rows)
        assert check["finite"] and check["excess"] <= 1, (i, check)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_one_bf16_product_fails_the_float32_limits(shape):
    """The same arithmetic with one product of bf16 planes (the inputs
    rounded to bf16): o and each gradient exceed the float32 limits."""
    q, k, v, do = _inputs(*shape, seed=2)
    want_o, want_lse = fa.flash_forward_lse_reference(q, k, v)
    o, _ = split_forward(q, k, v, ONE_PRODUCT)
    assert fa.agreement(o, want_o)["excess"] > 1
    want = fb.flash_backward_reference(q, k, v, want_o, want_lse, do)
    got = split_backward(q, k, v, want_o, want_lse, do, ONE_PRODUCT)
    for i, (g, w) in enumerate(zip(got, want)):
        rows = fb.DV_ROW_TOLERANCE if i == 2 else None
        assert fa.agreement(g, w, fb.TOLERANCE, rows)["excess"] > 1, i
