"""Kernel B1 (the lse-free flash forward) against the JAX package's Pallas
kernel.

On the CPU the JAX kernel runs in the Pallas interpreter, as
tests/test_pallas_attention.py runs it, and the port runs its plain version
(``flash_attend_tokens_reference``) and its CPU dispatch
(``flash_attend_tokens`` on CPU tensors).  Tolerance: rtol 1e-4 / atol 1e-5
in float32, the bound test_pallas_attention.py holds the JAX kernel to.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
Here its limits (``TOLERANCE``, ``agreement``) are checked against an
emulation of its bf16 rounding and against a planted fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
from sap3d_tpu.ops.pallas.flash_attention import _flash_forward
from sap3d_tpu_torch.ops.cuda.flash_attention import (
    agreement,
    flash_attend_tokens,
    flash_attend_tokens_reference,
)

CASES = [
    (1, 256, 64, 8, 64),    # one exact query block
    (2, 300, 49, 4, 32),    # ragged Nq (the JAX kernel pads, the port masks)
    (1, 512, 100, 16, 128), # x_1_3 proportions: d = C/8 = 16
]


def _inputs(b, nq, nk, d, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, d)).astype(np.float32),
            rng.normal(size=(b, nk, d)).astype(np.float32),
            rng.normal(size=(b, nk, c)).astype(np.float32))


@pytest.mark.parametrize("b,nq,nk,d,c", CASES)
def test_plain_and_cpu_dispatch_match_pallas_kernel(b, nq, nk, d, c):
    q, k, v = _inputs(b, nq, nk, d, c)
    with pltpu.force_tpu_interpret_mode():
        want, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   want_lse=False)
    assert lse is None
    want = np.asarray(want)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = flash_attend_tokens.launches
    plain = flash_attend_tokens_reference(tq, tk, tv)
    dispatched = flash_attend_tokens(tq, tk, tv)
    assert flash_attend_tokens.launches == before  # CPU: no kernel launch
    for got in (plain, dispatched):
        assert got.shape == (b, nq, c) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_plain_bf16_output_dtype_and_rounding():
    """bf16 inputs: fp32 scores, output in v's dtype, within bf16 rounding
    (2^-7 relative to the largest output) of the fp32 result."""
    q, k, v = _inputs(1, 64, 32, 8, 64, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attend_tokens(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = flash_attend_tokens_reference(tq.float(), tk.float(), tv.float())
    tol = 2.0 ** -7 * want.abs().max().item()
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=tol)


def _kernel_rounding_bf16(q, k, v):
    """The bf16 kernel's arithmetic in plain torch: fp32 scores, exp(s - m)
    rounded to bf16 for p.v with fp32 accumulation, the fp32 row sum of the
    unrounded exponentials, the output rounded to bf16 after the division."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.bmm(e.to(torch.bfloat16).float(), v.float())
    return (acc / e.sum(-1, keepdim=True)).to(torch.bfloat16)


def _drop_last_key_tile(q, k, v, tile=64):
    keep = tile * ((k.shape[1] - 1) // tile)
    return flash_attend_tokens_reference(q, k[:, :keep], v[:, :keep])


@pytest.mark.parametrize("b,nq,nk,d,c", [
    (2, 300, 200, 16, 128),  # ragged: the last tile holds 8 keys
    (1, 392, 392, 64, 512),  # x_3_1: the last tile holds 8 keys
    (1, 256, 3136, 32, 256), # x_2_2 keys: 49 full tiles
    (1, 256, 3136, 16, 128), # x_1_3 keys
])
def test_bf16_limits_pass_kernel_rounding_and_fail_a_dropped_key_tile(b, nq, nk, d, c):
    """The bf16 limits hold the kernel's own rounding (probabilities rounded
    before the division instead of after) and fail a kernel that skips its
    last 64-key tile, on unit-variance scores as chip_smoke.py draws them."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(a, dtype=torch.bfloat16) for a in (
        rng.normal(size=(b, nq, d)) * d ** -0.25, rng.normal(size=(b, nk, d)) * d ** -0.25,
        rng.normal(size=(b, nk, c))))
    want = flash_attend_tokens_reference(q, k, v)
    sound = agreement(_kernel_rounding_bf16(q, k, v), want)
    assert sound["finite"] and sound["excess"] <= 1
    assert agreement(_drop_last_key_tile(q, k, v), want)["excess"] > 2


def test_fp32_limits_pass_summation_order_and_fail_a_dropped_key_tile():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 300, 200, 16, 128, seed=3))
    q, k = q * 16 ** -0.25, k * 16 ** -0.25
    want = flash_attend_tokens_reference(q, k, v)
    other_order = flash_attend_tokens_reference(q.double(), k.double(), v.double()).float()
    assert agreement(other_order, want)["excess"] <= 1
    assert agreement(_drop_last_key_tile(q, k, v), want)["excess"] > 2
