"""The row statistics of kernel B6's first pass and kernel B5's backward
(``flash_attention.flash_row_stats``: each query row's max m and 1/l, or
lse = m + log l) against the JAX package's Pallas forward.

On the CPU the JAX kernel runs in the Pallas interpreter, as
tests/test_pallas_attention.py runs it: ``_flash_forward(want_lse=True)``,
whose lse is the log-sum-exp of each row's float32 scores (kernel B2's).
The port runs the plain version ``row_stats_reference`` and its CPU
dispatch.  Tolerance: 1e-5 relative and absolute on lse (both sum the same
float32 exponentials in another order, ~1e-7 relative), as
``flash_attention.LSE_TOLERANCE`` holds the kernel; m + log(1/inv) gives
lse back to float32 rounding.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sap3d_tpu.ops.pallas.flash_attention import _flash_forward
from sap3d_tpu_torch.ops.cuda import flash_attention as fa

CASES = [
    (1, 256, 64, 8),     # one exact query block, one exact key tile
    (2, 300, 49, 16),    # ragged Nq and Nk (the JAX kernel pads, the port masks)
    (1, 300, 200, 64),   # ragged Nq, Nk over several 64-key tiles
    (1, 256, 130, 128),  # d = 128: the GN deconv_pool4 site's width, ragged Nk
]


def _inputs(b, nq, nk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, d)).astype(np.float32) * d ** -0.25,
            rng.normal(size=(b, nk, d)).astype(np.float32) * d ** -0.25,
            rng.normal(size=(b, nk, 16)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,d", CASES)
def test_row_stats_match_the_pallas_lse(b, nq, nk, d, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in _inputs(b, nq, nk, d))
    with pltpu.force_tpu_interpret_mode():
        _, want = _flash_forward(jq, jk, jv, want_lse=True)
    want = np.asarray(want)
    if want.ndim == 3:  # the TPU kernel's [B, 8, Nq] sublane layout
        assert np.all(want == want[:, :1])
        want = want[:, 0]
    tq, tk = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
              for a in (jq, jk))
    before = fa.flash_row_stats.launches
    lse = fa.flash_row_stats(tq, tk, lse=True)
    m, inv = fa.flash_row_stats(tq, tk)
    assert fa.flash_row_stats.launches == before  # CPU: no kernel launch
    assert lse.shape == m.shape == inv.shape == (b, nq)
    assert lse.dtype == m.dtype == inv.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((m - inv.log()).numpy(), want, rtol=1e-5, atol=1e-5)
    # m is each row's largest score, and 1/l lies in [1/Nk, 1]
    s = torch.bmm(tq.float(), tk.float().transpose(1, 2))
    assert torch.equal(m, s.amax(-1))
    assert bool(((inv <= 1) & (inv >= 1.0 / nk - 1e-7)).all())


def test_row_stats_limits_fail_a_dropped_key_tile():
    """lse held to ``LSE_TOLERANCE`` fails a kernel that skips its last
    64-key tile."""
    q, k, _ = (torch.from_numpy(a) for a in _inputs(1, 300, 200, 16, seed=3))
    want = fa.row_stats_reference(q, k, lse=True)
    sound = fa.agreement(fa.flash_row_stats(q, k, lse=True), want, fa.LSE_TOLERANCE)
    fault = fa.agreement(fa.row_stats_reference(q, k[:, :192], lse=True), want,
                         fa.LSE_TOLERANCE)
    assert sound["excess"] <= 1 and fault["excess"] > 1


def test_row_stats_reference_chunks_the_queries(monkeypatch):
    """Over more than one chunk of queries the plain version gives what one
    chunk gives."""
    q, k, _ = (torch.from_numpy(a) for a in _inputs(1, 300, 70, 8, seed=4))
    whole = fa.row_stats_reference(q, k, lse=True)
    monkeypatch.setattr(fa, "_STATS_CHUNK", 128)
    assert torch.equal(fa.row_stats_reference(q, k, lse=True), whole)
