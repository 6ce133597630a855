"""Kernels B2 (the lse-saving flash forward) and B3 (the flash backward)
against the JAX package's Pallas kernels, and the autograd Function that
joins them.

On the CPU the JAX kernels run in the Pallas interpreter, as
tests/test_pallas_attention.py runs them, and the port runs the plain
versions (``flash_forward_lse_reference``, ``flash_backward_reference``)
through its CPU dispatch.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here their limits
(``flash_attention_bwd.TOLERANCE``) are checked against a sound change of
summation precision and against planted faults.

Tolerances: float32, rtol 1e-4 / atol 1e-5 on o, lse and the gradients
(scaled to the largest element for the gradients, whose ds = p (dp - delta)
cancels), the bound test_pallas_attention.py holds the JAX kernels to.
bf16: both sides round at the same points, so they differ where a float32
sum in another order rounds the other way: one bf16 ulp (2^-8 relative)
on a few elements, 2^-6 allowed against the largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.ops.pallas.flash_attention import (
    LSE_SUBLANES,
    _flash_backward,
    _flash_forward,
    flash_attend_tokens as jax_flash_attend_tokens,
)
from sap3d_tpu_torch.ops import attention
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
from sap3d_tpu_torch.ops.cuda.flash_attention import agreement

# ragged Nq (the JAX kernels pad to 256 rows, the port masks), d != C
B, NQ, NK, D, C = 2, 300, 100, 16, 64
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(dtype, seed=0, b=B, nq=NQ, nk=NK, d=D, c=C):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, d)) * d ** -0.25
    k = rng.normal(size=(b, nk, d)) * d ** -0.25
    v = rng.normal(size=(b, nk, c))
    do = rng.normal(size=(b, nq, c))
    return [torch.tensor(a, dtype=torch.float32).to(dtype) for a in (q, k, v, do)]


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=_JNP[t.dtype])


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got: torch.Tensor, want: np.ndarray, dtype, scale_to_max=False):
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        atol = 1e-5 * (np.abs(want).max() if scale_to_max else 1.0)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4, atol=atol)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_b2_matches_pallas_forward_with_lse(dtype):
    q, k, v, _ = _inputs(dtype)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = _flash_forward(_jax(q), _jax(k), _jax(v), want_lse=True)
    assert want_lse.shape == (B, LSE_SUBLANES, NQ)
    before = fa.flash_forward_lse.launches
    o, lse = fa.flash_forward_lse(q, k, v)  # CPU tensors: the plain version
    assert fa.flash_forward_lse.launches == before
    assert o.dtype == dtype and o.shape == (B, NQ, C)
    assert lse.dtype == torch.float32 and lse.shape == (B, NQ)
    _close(o, _np(want_o), dtype)
    np.testing.assert_allclose(lse.numpy(), _np(want_lse[:, 0]), rtol=1e-5, atol=1e-5)
    # the plain B1 and B2 give the same o
    torch.testing.assert_close(o, fa.flash_attend_tokens_reference(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_b3_matches_pallas_backward(dtype):
    """Identical (q, k, v, o, lse, do), o and lse from the JAX forward."""
    q, k, v, do = _inputs(dtype, seed=1)
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = _flash_forward(_jax(q), _jax(k), _jax(v), want_lse=True)
        want = _flash_backward(_jax(q), _jax(k), _jax(v), _jax(do), jo, jlse)
    o = torch.tensor(_np(jo)).to(dtype)
    lse = torch.tensor(_np(jlse[:, 0]))
    before = fb.flash_backward.launches
    got = fb.flash_backward(q, k, v, o, lse, do)
    assert fb.flash_backward.launches == before
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        _close(g, _np(w), dtype, scale_to_max=True)


def test_autograd_function_matches_jax_grad_of_flash_attend_tokens():
    """float32: the port's flash_attend under autograd (plain B2 + plain B3
    on the CPU) against jax.grad through the Pallas custom_vjp."""
    q, k, v, do = _inputs(torch.float32, seed=2)

    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash_attend_tokens(q_, k_, v_) * _jax(do))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.flash_attend(tq, tk, tv)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), do)
    for g, w in zip(got, want):
        _close(g, _np(w), torch.float32, scale_to_max=True)
    # and against autograd of the plain softmax attention
    ref = torch.autograd.grad(fa.flash_attend_tokens_reference(tq, tk, tv), (tq, tk, tv), do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * r.abs().max().item())


def test_flash_attend_without_autograd_is_b1():
    q, k, v, _ = _inputs(torch.float32, seed=3)
    tq = q.clone().requires_grad_()
    with torch.no_grad():
        out = attention.flash_attend(tq, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa.flash_attend_tokens_reference(q, k, v))


def _reference_in_float64(q, k, v, o, lse, do):
    """The plain B3 with float64 sums and the same rounding points: what a
    kernel that sums in another order can move."""
    f = lambda t: t.double()  # noqa: E731
    delta = (f(do) * f(o)).sum(-1, keepdim=True)
    p = torch.exp(torch.bmm(f(q), f(k).transpose(1, 2)) - f(lse)[..., None])
    ds = (p * (torch.bmm(f(do), f(v).transpose(1, 2)) - delta)).to(k.dtype).double()
    p = p.to(v.dtype).double()
    return (torch.bmm(ds, f(k)).to(q.dtype), torch.bmm(ds.transpose(1, 2), f(q)).to(k.dtype),
            torch.bmm(p.transpose(1, 2), f(do)).to(v.dtype))


def _without_delta(q, k, v, lse, do):
    """A planted fault: B3 with delta left out (ds = p * dp)."""
    p = torch.exp(torch.bmm(q.float(), k.float().transpose(1, 2)) - lse[..., None])
    ds = (p * torch.bmm(do.float(), v.float().transpose(1, 2))).to(k.dtype).float()
    dq = torch.bmm(ds, k.float()).to(q.dtype)
    dk = torch.bmm(ds.transpose(1, 2), q.float()).to(k.dtype)
    dv = torch.bmm(p.to(v.dtype).float().transpose(1, 2), do.float()).to(v.dtype)
    return dq, dk, dv


def _drop_last_key_tile(q, k, v, o, lse, do, tile=64):
    """A planted fault: B3 that skips its last tile of ``tile`` keys."""
    keep = tile * ((k.shape[1] - 1) // tile)
    dq, dk, dv = fb.flash_backward_reference(q, k[:, :keep], v[:, :keep], o, lse, do)
    pad = lambda t, n: torch.cat([t, t.new_zeros(t.shape[0], n, t.shape[2])], 1)  # noqa: E731
    return dq, pad(dk, k.shape[1] - keep), pad(dv, k.shape[1] - keep)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,d,c", [
    (2, 300, 200, 16, 128),  # ragged: the last key tile holds 8 keys
    (1, 392, 392, 64, 512),  # x_3_1
    (1, 256, 1000, 32, 256), # x_2_2 proportions
])
def test_limits_pass_another_summation_and_fail_planted_faults(dtype, b, nq, nk, d, c):
    q, k, v, do = _inputs(dtype, seed=4, b=b, nq=nq, nk=nk, d=d, c=c)
    o, lse = fa.flash_forward_lse_reference(q, k, v)
    want = fb.flash_backward_reference(q, k, v, o, lse, do)
    other = _reference_in_float64(q, k, v, o, lse, do)
    no_delta = _without_delta(q, k, v, lse, do)
    dropped = _drop_last_key_tile(q, k, v, o, lse, do)
    rows = (None, None, fb.DV_ROW_TOLERANCE)
    for i, name in enumerate(("dq", "dk", "dv")):
        sound = agreement(other[i], want[i], fb.TOLERANCE, rows[i])
        assert sound["finite"] and sound["excess"] <= 1, (name, sound)
    for i in (0, 1):  # delta moves dq and dk
        assert agreement(no_delta[i], want[i], fb.TOLERANCE)["excess"] > 2
    # zeroed dv rows
    assert agreement(dropped[2], want[2], fb.TOLERANCE, fb.DV_ROW_TOLERANCE)["excess"] > 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dv_rows_catch_a_dropped_tile_in_a_heavy_tailed_dv(dtype):
    """A few keys that every query attends to carry nearly all of dv, as in
    the flagship's x_1_3 site: the bf16 per-element limits, scaled to the
    largest element, then pass a dv whose last key tile is left at zero;
    the row limit (a zeroed row reads 1 / row_tol) fails it, and passes a
    sound change of summation precision."""
    b, nq, nk, d, c = 1, 512, 200, 16, 128
    q, k, v, do = _inputs(torch.float32, seed=5, b=b, nq=nq, nk=nk, d=d, c=c)
    u = torch.randn(d, generator=torch.Generator().manual_seed(6))
    q = (q + u).to(dtype)
    k[:, :4] = 3 * u / u.norm() ** 2 * 4  # scores of about 12 on four keys
    k, v, do = k.to(dtype), v.to(dtype), do.to(dtype)
    o, lse = fa.flash_forward_lse_reference(q, k, v)
    want = fb.flash_backward_reference(q, k, v, o, lse, do)
    other = _reference_in_float64(q, k, v, o, lse, do)
    dropped = _drop_last_key_tile(q, k, v, o, lse, do)[2]
    norms = want[2][0].float().norm(dim=-1)
    assert norms[:4].min() > 100 * norms[4:].max()  # heavy-tailed
    if dtype == torch.bfloat16:  # the bf16 element limits miss it
        assert agreement(dropped, want[2], fb.TOLERANCE)["excess"] <= 1
    caught = agreement(dropped, want[2], fb.TOLERANCE, fb.DV_ROW_TOLERANCE)
    assert caught["row_excess"] >= 0.99 / fb.DV_ROW_TOLERANCE[dtype]
    assert agreement(other[2], want[2], fb.TOLERANCE, fb.DV_ROW_TOLERANCE)["excess"] <= 1
