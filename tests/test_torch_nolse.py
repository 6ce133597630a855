"""Kernel B6 (the lse-free forward that rounds the normalised p) and the
inference bisect, against the JAX package.

On the CPU the JAX lse-free Pallas forward runs in the Pallas interpreter,
as tests/test_pallas_attention.py runs it: ``_flash_forward(want_lse=
False)``, whose kernel body (``_fwd_kernel``) is line for line the body of
``scripts/bisect_infer.py``'s ``_fwd_kernel_nolse`` (local to that script's
``main``).  The port runs its plain version ``flash_nolse_reference`` and
its CPU dispatch.  Tolerances: float32 1e-6 absolute and relative (the two
differ by exp and summation order, 5.4e-7 at most at x_3_1's shape); bf16
one output ulp, except where the two round a p apart (module ``TOLERANCE``
says why), which is held by the kernel's own limits and may touch at most
1e-3 of the elements.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
Here its limits are checked against an emulation of its rounding, against
B1's rounding point and against a planted fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sap3d_tpu.ops.pallas.flash_attention import _flash_forward
from sap3d_tpu_torch.models.registry import build_model
from sap3d_tpu_torch.ops import attention
from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse
from sap3d_tpu_torch.ops.cuda.flash_attention import agreement, flash_attend_tokens
from sap3d_tpu_torch.scripts import bisect_infer
from sap3d_tpu_torch.train.steps import make_eval_step

CASES = [
    (1, 256, 64, 8, 64),     # one exact query block
    (2, 300, 49, 4, 32),     # ragged Nq (the JAX kernel pads, the port masks)
    (1, 300, 200, 16, 128),  # ragged Nq, x_1_3 proportions
    (1, 392, 392, 64, 512),  # x_3_1
]


def _inputs(b, nq, nk, d, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, d)).astype(np.float32) * d ** -0.25,
            rng.normal(size=(b, nk, d)).astype(np.float32) * d ** -0.25,
            rng.normal(size=(b, nk, c)).astype(np.float32))


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = np.frexp(x)
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,d,c", CASES)
def test_plain_matches_the_pallas_lse_free_forward(b, nq, nk, d, c, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in _inputs(b, nq, nk, d, c))
    with pltpu.force_tpu_interpret_mode():
        want, lse = _flash_forward(jq, jk, jv, want_lse=False)
    assert lse is None
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    before = nolse.flash_nolse.launches
    plain = nolse.flash_nolse_reference(tq, tk, tv)
    dispatched = nolse.flash_nolse(tq, tk, tv)
    assert nolse.flash_nolse.launches == before  # CPU: no kernel launch
    assert torch.equal(plain, dispatched)
    assert plain.shape == (b, nq, c) and plain.dtype == tq.dtype
    got = plain.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    beyond_ulp = np.abs(got - want) > _ulp_bf16(np.maximum(np.abs(got), np.abs(want)))
    assert beyond_ulp.mean() <= 1e-3
    check = agreement(plain, torch.tensor(want).to(torch.bfloat16), nolse.TOLERANCE)
    assert check["excess"] <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,d,c", CASES)
def test_pass2_arithmetic_matches_the_pallas_lse_free_forward(b, nq, nk, d, c, dtype):
    """B6's second pass, given each row's m and 1/l from the plain row
    statistics: p = 2^(s log2(e) - m log2(e)) / l in float32, rounded to bf16
    (in float32, s and p v as six products of three bf16 planes), against
    the JAX lse-free forward under the kernel's limits."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in _inputs(b, nq, nk, d, c, 5))
    with pltpu.force_tpu_interpret_mode():
        want, _ = _flash_forward(jq, jk, jv, want_lse=False)
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    m, inv = fa.row_stats_reference(tq, tk)
    got = nolse.pass2_reference(tq, tk, tv, m, inv)
    assert got.shape == (b, nq, c) and got.dtype == tq.dtype
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).to(tq.dtype)
    check = agreement(got, want, nolse.TOLERANCE)
    assert check["finite"] and check["excess"] <= 1, check
    # the same arithmetic on a 1/l 2^-5 too large fails the limits
    bad = nolse.pass2_reference(tq, tk, tv, m, inv * (1 + 2.0 ** -5))
    assert agreement(bad, want, nolse.TOLERANCE)["excess"] > 1


def _kernel_rounding_bf16(q, k, v):
    """B6's arithmetic in plain torch: p = exp(s - m) times 1/l in float32
    (the plain version divides), rounded to bf16, the product summed in
    float64 (another order than the plain version's float32 sum), the
    output rounded to bf16."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e * (1.0 / e.double().sum(-1, keepdim=True).float())).to(torch.bfloat16)
    return torch.bmm(p.double(), v.double()).to(torch.bfloat16)


def _b1_rounding_bf16(q, k, v):
    """B1's rounding point: exp(s - m) rounded to bf16, the sum divided by
    the float32 row sum after the product."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.bmm(e.to(torch.bfloat16).double(), v.double())
    return (acc / e.double().sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("b,nq,nk,d,c", [
    (1, 392, 392, 64, 512),  # x_3_1: the last tile holds 8 keys
    (1, 256, 3136, 32, 256), # x_2_2 keys: 49 full tiles
    (1, 256, 3136, 16, 128), # x_1_3 keys
])
def test_bf16_limits_pass_b6_rounding_and_fail_b1_rounding_and_a_dropped_tile(b, nq, nk, d, c):
    """B6's bf16 limits hold its own rounding and fail both B1's rounding
    point (the normalised p rounded against the unnormalised one) and a
    kernel that skips its last 64-key tile."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(b, nq, nk, d, c, 2))
    want = nolse.flash_nolse_reference(q, k, v)
    sound = agreement(_kernel_rounding_bf16(q, k, v), want, nolse.TOLERANCE)
    assert sound["finite"] and sound["excess"] <= 1
    b1 = agreement(_b1_rounding_bf16(q, k, v), want, nolse.TOLERANCE)
    assert b1["excess"] > 2 and b1["mean_abs_err"] > 10 * sound["mean_abs_err"]
    keep = 64 * ((nk - 1) // 64)
    fault = nolse.flash_nolse_reference(q, k[:, :keep], v[:, :keep])
    assert agreement(fault, want, nolse.TOLERANCE)["excess"] > 2


def test_bisect_swap_routes_the_micro_forward_through_b6_and_restores_b1(monkeypatch):
    """The bisect's swap on ``p3d_micro_sa`` at 64 px in float32 (two sites
    take the forward kernel): under it every such site runs B6 (here its
    plain version), the output is the current route's to 1e-6, and B1 is
    the route again afterwards."""
    calls = []

    def counted(q, k, v):
        calls.append(q.shape)
        return plain(q, k, v)

    plain = nolse.flash_nolse_reference
    monkeypatch.setattr(nolse, "flash_nolse_reference", counted)
    model = build_model("p3d_micro_sa", dtype="float32", device="cpu")
    for sa in model.attention_modules():
        with torch.no_grad():
            sa.gamma.fill_(1.0)
    frames = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 16, 64, 64, 3))
                              .astype(np.float32) * 0.3)
    fwd = make_eval_step(model)
    current = fwd(frames)
    with attention.forward_kernel(nolse.flash_nolse):
        swapped = fwd(frames)
    assert attention.flash_attend_tokens is flash_attend_tokens
    assert [s[1] for s in calls] == [1024, 8192]  # x_2_2, x_1_3
    torch.testing.assert_close(swapped, current, rtol=0, atol=1e-6)
    calls.clear()
    fwd(frames)
    assert not calls


def test_bisect_main_returns_its_four_readings():
    res = bisect_infer.main(device="cpu", batch=1, structure="p3d_micro_sa", size=64,
                            proj_shape=(1, 2, 8, 8, 128), n_small=1, n_large=2, warmup=1)
    readings = ("current_ms", "nolse_ms", "plain_ms", "fused_proj_ms", "separate_proj_ms")
    assert all(np.isfinite(res[r]) for r in readings)
    # CPU tensors launch no kernel: every variant counts 0
    assert res["launches"] == {v: {"B1": 0, "RS": 0, "B6": 0}
                               for v in ("current", "nolse", "after", "plain")}
    assert res["device"] == "cpu" and res["batch"] == 1
