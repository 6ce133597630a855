"""Parity of the port's attention (sap3d_tpu_torch/ops/attention.py) with the
JAX package's, on the CPU in float32.

``gamma`` and the BN statistics are random: with gamma = 0 (its init) the
block is the identity and the attention would go untested.  Tolerance:
1e-4 absolute on O(1) outputs (float32 on both sides; the score matmuls
sum up to C terms in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sap3d_tpu.ops import attention as ja
from sap3d_tpu_torch.interop.flax_bridge import state_dict_from_flax
from sap3d_tpu_torch.ops import attention as ta

ATOL = 1e-4


def test_attend_tokens_chunked_matches_jax():
    """Nq above the 4096 threshold takes the query-chunked path."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 4500, 4)).astype(np.float32)
    k = rng.normal(size=(1, 40, 4)).astype(np.float32)
    v = rng.normal(size=(1, 40, 8)).astype(np.float32)
    want = np.asarray(ja.attend_tokens(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       precision=jax.lax.Precision.HIGHEST))
    got = ta.attend_tokens(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dhw,c,subsample", [
    ((1, 7, 7), 32, False),   # x_4_0-like: Nq = 49 < BLOCK_Q -> attend_tokens
    ((2, 12, 12), 16, False), # Nq = 288 >= BLOCK_Q -> flash_attend_tokens
    ((4, 16, 16), 16, True),  # x_1_3-like: keys/values pooled by 2
])
def test_self_attention_matches_flax(dhw, c, subsample):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *dhw, c)).astype(np.float32)
    fm = ja.SelfAttention3D(subsample=subsample, use_pallas=False)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    params["gamma"] = np.array([0.7], np.float32)
    params["Norm_0"]["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(size=c).astype(np.float32) * 0.1}
    stats = {"Norm_0": {"BatchNorm_0": {
        "mean": rng.normal(size=c).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}}
    want = np.asarray(fm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=False))

    tm = ta.SelfAttention3D(c, subsample=subsample).eval()
    tm.load_state_dict(state_dict_from_flax(params, stats, model=tm), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    with torch.inference_mode():
        got = tm(xt).numpy().transpose(0, 2, 3, 4, 1)
        plain = ta.SelfAttention3D(c, subsample=subsample, use_kernel=False)
        plain.load_state_dict(tm.state_dict())
        got_plain = plain.eval()(xt).numpy().transpose(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got_plain, want, atol=ATOL)
    # the attention really contributes at this gamma
    assert np.abs(want - x).max() > 10 * ATOL
