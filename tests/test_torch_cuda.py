"""The port's CUDA kernels on the card (marker ``cuda``).

Each test skips on a host without a GPU, and those of a time mesh over
distinct cards on a host with one.  This file imports nothing of JAX,
so it also runs on the GPU host, which has no JAX; there the repo's
conftest (which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held to its plain version under its module's limits
(``flash_attention.TOLERANCE`` for o, ``LSE_TOLERANCE`` for lse,
``flash_attention_bwd.TOLERANCE`` for dq, dk and dv; per element and on the
mean, scaled to the output; ``agreement`` says why), as chip_smoke.py holds
them.
"""

import numpy as np
import pytest
import torch

from sap3d_tpu_torch.ops import attention as ta
from sap3d_tpu_torch.ops.attention import SelfAttention3D
from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse
from sap3d_tpu_torch.ops.cuda.flash_attention import (
    LSE_TOLERANCE,
    agreement,
    flash_attend_tokens,
    flash_attend_tokens_reference,
    flash_forward_lse,
    flash_forward_lse_reference,
    flash_row_stats,
    row_stats_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, nq, nk, d, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, d)) * d ** -0.25
    k = rng.normal(size=(b, nk, d)) * d ** -0.25
    v = rng.normal(size=(b, nk, c))
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", [
    (3, 300, 200, 16, 128),  # ragged Nq and Nk, two column tiles
    (2, 256, 64, 128, 64),   # the largest d the kernel takes
    (2, 700, 500, 128, 1024),  # the GN decoder's widest site's d and C, ragged Nq and Nk
    (1, 392, 392, 64, 512),  # x_3_1 proportions
    (1, 700, 500, 32, 256),  # x_2_2 proportions
    (2, 1000, 300, 16, 128), # x_1_3 proportions
    (1, 1, 1, 8, 64),        # one query, one key
    (2, 700, 300, 2, 16),    # x_0_1_sa's d and C: rows padded, the narrow column tile
    (1, 300, 100, 6, 48),    # three narrow column tiles
])
def test_kernel_matches_plain(cuda, dtype, b, nq, nk, d, c):
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    before = flash_attend_tokens.launches
    got = flash_attend_tokens(q, k, v)
    torch.cuda.synchronize()
    assert flash_attend_tokens.launches == before + 1
    assert got.shape == (b, nq, c) and got.dtype == dtype
    check = agreement(got, flash_attend_tokens_reference(q, k, v))
    assert check["finite"] and check["excess"] <= 1


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs(1, 8, 8, 8, 40, torch.float32)  # C not a multiple of 16
    with pytest.raises(ValueError):
        flash_attend_tokens(q, k, v)
    q, k, v = _inputs(1, 8, 8, 8, 64, torch.float16)
    with pytest.raises(TypeError):
        flash_attend_tokens(q, k, v)
    q, k, v = _inputs(1, 8, 8, 136, 64, torch.bfloat16)  # d above 128
    with pytest.raises(ValueError):
        flash_attend_tokens(q, k, v)


def test_kernel_takes_unaligned_views(cuda):
    """A view whose data starts off a 16-byte boundary is copied first."""
    q, k, v = _inputs(1, 300, 70, 16, 128, torch.bfloat16)
    qv = torch.cat([q.new_zeros(1), q.flatten()])[1:].view_as(q)
    assert qv.data_ptr() % 16
    got = flash_attend_tokens(qv, k, v)
    assert agreement(got, flash_attend_tokens_reference(q, k, v))["excess"] <= 1


def test_self_attention_kernel_path_matches_plain_path(cuda):
    torch.manual_seed(0)
    sa = SelfAttention3D(128, subsample=True).to(cuda).eval()
    with torch.no_grad():
        sa.gamma.fill_(1.0)
    x = torch.randn(2, 128, 4, 16, 16, device=cuda)
    before = flash_attend_tokens.launches
    with torch.inference_mode():
        got = sa(x)
        sa.use_kernel = False
        want = sa(x)
    assert flash_attend_tokens.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# ragged shapes and the flagship sites' proportions (d = C/8), plus a C
# that is a multiple of 64 but not of 128; then the bf16 backward's paths:
# query splits (``fb.query_split``), dv in the dkdq kernel (C <= 64, and
# 128 at d <= 16) or in column slabs, C's k-steps unrolled (16 ... 512) or
# counted at run time, d zero-filled to 16 / 32 / 64, Nk not a multiple of
# the 64-key tile
_SHAPES = [
    (3, 300, 200, 16, 128),  # ragged Nq and Nk
    (1, 392, 392, 64, 512),  # x_3_1
    (1, 700, 500, 32, 256),  # x_2_2 proportions
    (2, 1000, 300, 16, 128), # x_1_3 proportions
    (2, 130, 70, 24, 192),   # three 64-column slabs of C
    (1, 1, 3, 8, 64),        # one query (with one key, dq and dk are 0)
    (2, 700, 300, 2, 16),    # x_0_1_sa's d and C: rows padded, one narrow slab
    (1, 300, 100, 6, 48),    # three narrow slabs
    (1, 5000, 150, 2, 16),   # 16 query ranges; d 2 zero-filled to 16
    (2, 2000, 100, 8, 64),   # 16 query ranges; d = 8 zero-filled to 16; dv fused
    (2, 300, 130, 64, 512),  # C = 512, ragged Nq and Nk, 5 query ranges
    (1, 200, 100, 8, 32),    # C = 32: dv fused, narrow boxes
    (1, 300, 200, 32, 128),  # C = 128 at d = 32: dv in two 64-column slabs
    (1, 300, 200, 40, 320),  # C = 320: k-steps counted at run time, d to 64
    # the streaming dk and dq kernel in bf16 too: d above 64 (two-box q and
    # k tiles), C above 512
    (2, 700, 500, 128, 1024),  # GN deconv_pool4's d and C: 16 chunks unrolled
    (1, 300, 130, 64, 1024),   # bf16 streams at d_tile 64: C above 512
    (1, 300, 200, 72, 576),    # d padded to 128, 9 chunks counted at run time
    (1, 300, 200, 128, 128),   # d = 128 at a narrow C
    (1, 300, 100, 96, 48),     # d = 96, three 16-column chunks
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", _SHAPES)
def test_b2_matches_plain(cuda, dtype, b, nq, nk, d, c):
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    before = flash_forward_lse.launches
    o, lse = flash_forward_lse(q, k, v)
    torch.cuda.synchronize()
    assert flash_forward_lse.launches == before + 1
    assert o.shape == (b, nq, c) and o.dtype == dtype
    assert lse.shape == (b, nq) and lse.dtype == torch.float32
    want_o, want_lse = flash_forward_lse_reference(q, k, v)
    assert agreement(o, want_o)["excess"] <= 1
    check = agreement(lse, want_lse, LSE_TOLERANCE)
    assert check["finite"] and check["excess"] <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", _SHAPES)
def test_b3_matches_plain(cuda, dtype, b, nq, nk, d, c):
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    do = torch.randn(b, nq, c, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).to(dtype)
    o, lse = flash_forward_lse_reference(q, k, v)
    before = fb.flash_backward.launches
    got = fb.flash_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert fb.flash_backward.launches == before + 1
    want = fb.flash_backward_reference(q, k, v, o, lse, do)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype, name
        rows = fb.DV_ROW_TOLERANCE if name == "dv" else None
        check = agreement(g, w, fb.TOLERANCE, rows)
        assert check["finite"] and check["excess"] <= 1, (name, check)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", _SHAPES)
def test_b4_matches_plain(cuda, dtype, b, nq, nk, d, c):
    """Kernel B4 (B3 with the lse cotangent in delta) against its plain
    version; B3 on the same inputs, the cotangent dropped, fails dq and dk
    (where there is more than one key to spread them over)."""
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(b, nq, c, device="cuda", generator=gen).to(dtype)
    dlse = torch.randn(b, nq, device="cuda", generator=gen)
    o, lse = flash_forward_lse_reference(q, k, v)
    before = fb.flash_backward.launches, fb.flash_backward.launches_lse
    got = fb.flash_backward(q, k, v, o, lse, do, dlse=dlse)
    torch.cuda.synchronize()
    assert (fb.flash_backward.launches, fb.flash_backward.launches_lse) == \
        (before[0], before[1] + 1)
    want = fb.flash_backward_reference(q, k, v, o, lse, do, dlse)
    dropped = fb.flash_backward(q, k, v, o, lse, do)
    for name, g, w, f, t in zip(("dq", "dk", "dv"), got, want, dropped, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype, name
        rows = fb.DV_ROW_TOLERANCE if name == "dv" else None
        check = agreement(g, w, fb.TOLERANCE, rows)
        assert check["finite"] and check["excess"] <= 1, (name, check)
        if name != "dv" and nk > 1:
            assert agreement(f, w, fb.TOLERANCE)["excess"] > 1, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", _SHAPES + [(2, 700, 500, 128, 1024)])
def test_b6_matches_plain(cuda, dtype, b, nq, nk, d, c):
    """B6 against its plain version under its own limits; in bf16 its mean
    error is no larger than B1's on the same inputs (B6 rounds the
    normalised p, as the TPU kernel does)."""
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    before = nolse.flash_nolse.launches, flash_row_stats.launches
    got = nolse.flash_nolse(q, k, v)
    torch.cuda.synchronize()
    # pass 1 (the row statistics) and pass 2, once each
    assert (nolse.flash_nolse.launches, flash_row_stats.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.shape == (b, nq, c) and got.dtype == dtype
    want = nolse.flash_nolse_reference(q, k, v)
    check = agreement(got, want, nolse.TOLERANCE)
    assert check["finite"] and check["excess"] <= 1
    if dtype == torch.bfloat16:
        b1 = agreement(flash_attend_tokens(q, k, v), want, nolse.TOLERANCE)
        assert check["mean_abs_err"] <= b1["mean_abs_err"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", _SHAPES)
def test_row_stats_match_plain(cuda, dtype, b, nq, nk, d, c):
    """The row-stats kernel (B6's first pass, B5's lse) against its plain
    version: lse under ``LSE_TOLERANCE``, which a dropped last key tile
    fails; m, the row's largest score, and m + log l under the same limits."""
    q, k, _ = _inputs(b, nq, nk, d, c, dtype)
    before = flash_row_stats.launches
    lse = flash_row_stats(q, k, lse=True)
    m, inv = flash_row_stats(q, k)
    torch.cuda.synchronize()
    assert flash_row_stats.launches == before + 2
    assert lse.shape == m.shape == inv.shape == (b, nq) and lse.dtype == torch.float32
    want_m, _ = row_stats_reference(q, k)
    want = row_stats_reference(q, k, lse=True)
    check = agreement(lse, want, LSE_TOLERANCE)
    assert check["finite"] and check["excess"] <= 1, check
    assert agreement(m - inv.log(), want, LSE_TOLERANCE)["excess"] <= 1
    assert agreement(m, want_m, LSE_TOLERANCE)["excess"] <= 1
    if nk > 64:
        keep = 64 * ((nk - 1) // 64)
        fault = row_stats_reference(q, k[:, :keep], lse=True)
        assert agreement(fault, want, LSE_TOLERANCE)["excess"] > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", [(2, 700, 500, 128, 1024), (1, 300, 200, 72, 576)])
def test_wide_b3_limits_fail_planted_faults(cuda, dtype, b, nq, nk, d, c):
    """B3 at the widths the streaming kernel takes in both dtypes: its
    output passes its limits, and the plain version with delta left out (dq,
    dk) or with the last key tile's dv rows zeroed fails them."""
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    do = torch.randn(b, nq, c, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(2)).to(dtype)
    o, lse = flash_forward_lse_reference(q, k, v)
    got = fb.flash_backward(q, k, v, o, lse, do)
    want = fb.flash_backward_reference(q, k, v, o, lse, do)
    no_delta = fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)
    dv_dropped = want[2].clone()
    dv_dropped[:, 64 * ((nk - 1) // 64):] = 0
    faults = (no_delta[0], no_delta[1], dv_dropped)
    for name, g, w, f in zip(("dq", "dk", "dv"), got, want, faults):
        rows = fb.DV_ROW_TOLERANCE if name == "dv" else None
        check = agreement(g, w, fb.TOLERANCE, rows)
        assert check["finite"] and check["excess"] <= 1, (name, check)
        assert agreement(f, w, fb.TOLERANCE, rows)["excess"] > 1, name


def test_kernels_launch_from_a_fresh_host_thread(cuda):
    """A backward runs on autograd's device thread, where the runtime may
    have made no call yet: the row statistics (B5's lse), B6 and B3 launch
    from a new host thread as from the main one."""
    import threading

    q, k, v = _inputs(16, 3136, 3136, 32, 256, torch.bfloat16, seed=4)
    do = torch.randn(16, 3136, 256, device="cuda").to(torch.bfloat16)
    o, lse = flash_forward_lse_reference(q, k, v)
    torch.cuda.synchronize()
    out, errors = {}, []

    def run():
        try:
            out["lse"] = flash_row_stats(q, k, lse=True)
            out["b6"] = nolse.flash_nolse(q, k, v)
            out["b3"] = fb.flash_backward(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=600)
    assert not thread.is_alive() and not errors, errors
    assert agreement(out["lse"], lse, LSE_TOLERANCE)["excess"] <= 1
    assert agreement(out["b6"], nolse.flash_nolse_reference(q, k, v), nolse.TOLERANCE)["excess"] <= 1
    for g, w in zip(out["b3"], fb.flash_backward_reference(q, k, v, o, lse, do)):
        assert agreement(g, w, fb.TOLERANCE)["excess"] <= 1


def test_b6_swapped_into_the_micro_forward(cuda):
    """The bisect's swap on the card: every site B1 takes launches B6
    instead, and B1 again afterwards."""
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    model = build_model("p3d_micro_sa", dtype="bfloat16", device=cuda)
    for sa in model.attention_modules():
        with torch.no_grad():
            sa.gamma.fill_(1.0)
    x = torch.randn(2, 16, 64, 64, 3, device=cuda) * 0.3
    fwd = make_eval_step(model)
    b1, b6 = flash_attend_tokens.launches, nolse.flash_nolse.launches
    current = fwd(x)
    assert (flash_attend_tokens.launches - b1, nolse.flash_nolse.launches - b6) == (2, 0)
    with ta.forward_kernel(nolse.flash_nolse):
        swapped = fwd(x)
    assert (flash_attend_tokens.launches - b1, nolse.flash_nolse.launches - b6) == (2, 2)
    assert ta.flash_attend_tokens is flash_attend_tokens
    assert (swapped - current).abs().mean().item() <= 1e-2


# The bf16 forward's launch plan at its edges: Nq below one 64-row tile,
# Nk below one key tile (64 at C > 128 and C <= 32, 128 between) and not a
# multiple of it, C = 16, 48 and 1024, d = 8, 120 and 128
_FORWARD_EDGES = [
    (2, 50, 300, 16, 128),      # Nq below one tile
    (1, 300, 30, 32, 256),      # Nk below one 64-key tile
    (1, 300, 100, 8, 128),      # Nk below one 128-key tile, d = 8
    (2, 700, 130, 16, 128),     # Nk not a multiple of the key tile
    (2, 700, 300, 2, 16),       # C = 16: the narrow instantiation
    (1, 300, 100, 6, 48),       # C = 48: 16 columns of the slab past C
    (2, 700, 500, 128, 1024),   # d = 128, C = 1024: four slabs
    (2, 70, 63, 120, 1024),     # d = 120, one CTA's rows, one ragged key tile
    (1, 20, 129, 8, 32),        # C = 32
    (1, 300, 200, 40, 320),     # C = 320: the second slab narrower than 256
    (16, 392, 392, 128, 128),   # d = 128 at a 128-column slab
    (16, 3136, 3136, 32, 256),  # x_2_2: the plan cuts 64-row CTAs of one warpgroup
]


@pytest.mark.parametrize("b,nq,nk,d,c", _FORWARD_EDGES)
def test_b1_b2_at_the_plans_edges(cuda, b, nq, nk, d, c):
    """B1 and B2 (bf16) against their plain versions at the plan's edge
    shapes; the library's plan is ``launch_plan``'s, and the card holds at
    least the CTAs per SM it counts on."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa

    plan = fa.card_launch_plan(b, nq, nk, d, c)
    assert plan == fa.launch_plan(b, nq, nk, d, c)
    assert fa.card_resident_ctas(b, nq, nk, d, c) >= plan["resident"]
    q, k, v = _inputs(b, nq, nk, d, c, torch.bfloat16)
    got = flash_attend_tokens(q, k, v)
    o, lse = flash_forward_lse(q, k, v)
    torch.cuda.synchronize()
    want_o, want_lse = flash_forward_lse_reference(q, k, v)
    for out in (got, o):
        check = agreement(out, want_o)
        assert check["finite"] and check["excess"] <= 1, check
    check = agreement(lse, want_lse, LSE_TOLERANCE)
    assert check["finite"] and check["excess"] <= 1, check


def test_b3_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs(1, 8, 8, 8, 1088, torch.float32)  # C above 1024
    o, lse = flash_forward_lse_reference(q, k, v)
    with pytest.raises(ValueError):
        fb.flash_backward(q, k, v, o, lse, o)
    q, k, v = _inputs(1, 8, 8, 8, 144, torch.float32)  # above 128, not a multiple of 64
    o, lse = flash_forward_lse_reference(q, k, v)
    with pytest.raises(ValueError):
        fb.flash_backward(q, k, v, o, lse, o)
    q, k, v = _inputs(1, 8, 8, 8, 64, torch.bfloat16)
    o, lse = flash_forward_lse_reference(q, k, v)
    with pytest.raises(TypeError):
        fb.flash_backward(q, k, v, o, lse.half(), o)
    q, k, v = _inputs(1, 8, 8, 136, 512, torch.bfloat16)  # bf16 d above 128
    o, lse = flash_forward_lse_reference(q, k, v)
    with pytest.raises(ValueError, match="d <= 128"):
        fb.flash_backward(q, k, v, o, lse, o)
    q, k, v = _inputs(1, 8, 8, 136, 512, torch.float32)  # float32 d above 128 too
    o, lse = flash_forward_lse_reference(q, k, v)
    with pytest.raises(ValueError, match="d <= 128"):
        fb.flash_backward(q, k, v, o, lse, o)


@pytest.mark.parametrize("d,c", sorted({(d, c) for _, _, _, d, c in _SHAPES}
                                       | {(64, 512), (32, 256), (16, 128), (2, 16)}))
def test_split_rule_knows_the_kernels_residency(cuda, d, c):
    """``fb.resident_ctas``, the split rule's model, against the card's
    occupancy calculator for the kernel the library launches at (d, C)."""
    assert fb.card_resident_ctas(d, c) == fb.resident_ctas(d, c)


# float32 (split bf16, three planes per tile) at the plans' edges: 32-key
# forward tiles (C = 1024, d = 128), two-stage rings, long key ranges (Nk =
# 3136, the flagship's), the dkdq kernel's chunks of C unrolled (C = 16,
# 32, 128, 256, 512) or counted at run time (48, 192, 320), query splits
_F32_EDGES = [
    (2, 700, 500, 128, 1024),   # 32-key forward tiles, eight slabs; one q stage backward
    (1, 300, 3136, 64, 512),    # long keys; C = 512: eight chunks, two stages
    (2, 1000, 3136, 16, 128),   # x_1_3 proportions, long keys
    (1, 4000, 3136, 2, 16),     # x_0_1_sa's d and C, long keys, query splits
    (2, 700, 300, 32, 256),     # four chunks
    (1, 300, 200, 40, 320),     # chunks counted at run time, d to 64
    (2, 130, 70, 24, 192),      # three chunks counted at run time
    (1, 300, 100, 6, 48),       # three 16-column chunks at run time
    (1, 200, 100, 8, 32),       # two 16-column chunks
]


@pytest.mark.parametrize("b,nq,nk,d,c", _F32_EDGES)
def test_float32_kernels_at_the_plans_edges(cuda, b, nq, nk, d, c):
    """B1, B2, B3 and B4 in float32 against their plain versions under the
    float32 limits; the forward's plan is the library's."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa

    dtype = torch.float32
    plan = fa.card_launch_plan(b, nq, nk, d, c, dtype)
    assert plan == fa.launch_plan(b, nq, nk, d, c, dtype)
    assert fa.card_resident_ctas(b, nq, nk, d, c, dtype) >= plan["resident"]
    q, k, v = _inputs(b, nq, nk, d, c, dtype)
    got = flash_attend_tokens(q, k, v)
    o, lse = flash_forward_lse(q, k, v)
    torch.cuda.synchronize()
    want_o, want_lse = flash_forward_lse_reference(q, k, v)
    for out in (got, o):
        check = agreement(out, want_o)
        assert check["finite"] and check["excess"] <= 1, check
    check = agreement(lse, want_lse, LSE_TOLERANCE)
    assert check["finite"] and check["excess"] <= 1, check
    if not fb.backward_viable(max(nq, 256), nk, d, c, dtype):
        return
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(b, nq, c, device="cuda", generator=gen)
    dlse = torch.randn(b, nq, device="cuda", generator=gen)
    for extra in ((), (dlse,)):
        got = fb.flash_backward(q, k, v, want_o, want_lse, do, *extra)
        want = fb.flash_backward_reference(q, k, v, want_o, want_lse, do, *extra)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            rows = fb.DV_ROW_TOLERANCE if name == "dv" else None
            check = agreement(g, w, fb.TOLERANCE, rows)
            assert check["finite"] and check["excess"] <= 1, (name, len(extra), check)


@pytest.mark.parametrize("b,nq,nk,d,c", [(2, 1000, 3136, 16, 128), (1, 392, 392, 64, 512)])
def test_bf16_kernels_on_rounded_inputs_fail_the_float32_limits(cuda, b, nq, nk, d, c):
    """The float32 limits tell the split kernels from bf16 ones: the bf16
    kernels on the float32 inputs rounded to bf16 exceed them, in o and in
    each gradient, where the float32 kernels pass."""
    q, k, v = _inputs(b, nq, nk, d, c, torch.float32)
    do = torch.randn(b, nq, c, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    want_o, want_lse = flash_forward_lse_reference(q, k, v)
    rounded = [t.bfloat16() for t in (q, k, v)]
    assert agreement(flash_attend_tokens(*rounded).float(), want_o)["excess"] > 1
    assert agreement(flash_attend_tokens(q, k, v), want_o)["excess"] <= 1
    want = fb.flash_backward_reference(q, k, v, want_o, want_lse, do)
    got16 = fb.flash_backward(*rounded, want_o.bfloat16(), want_lse, do.bfloat16())
    got32 = fb.flash_backward(q, k, v, want_o, want_lse, do)
    for name, g16, g32, w in zip(("dq", "dk", "dv"), got16, got32, want):
        rows = fb.DV_ROW_TOLERANCE if name == "dv" else None
        assert agreement(g16.float(), w, fb.TOLERANCE, rows)["excess"] > 1, name
        assert agreement(g32, w, fb.TOLERANCE, rows)["excess"] <= 1, name


@pytest.mark.parametrize("d,c", sorted({(d, c) for _, _, _, d, c in _SHAPES}
                                       | {(64, 512), (32, 256), (16, 128), (2, 16)}))
def test_split_rule_knows_the_float32_kernels_residency(cuda, d, c):
    """``fb.resident_ctas`` in float32 against the card's occupancy
    calculator for the split dkdq kernel the library launches at (d, C)."""
    assert fb.card_resident_ctas(d, c, torch.float32) == fb.resident_ctas(d, c, torch.float32)


# The kernel path against B2 with the plain B3 (the same forward; the
# backward's own difference): loss and whole gradient (relative L2).  Read
# on an H100: fp32 4.3e-6, bf16 1.2e-2 (the bf16 backward carries each
# rounding difference far; the control, a B3 without delta, 31 and 21).
# Against the plain B2 and B3 the bf16 gradient is 0.12 away: moving the
# forward's rounding point moves it that far (PERF.md).
_TRAIN_TOL = {torch.float32: (1e-6, 1e-4), torch.bfloat16: (1e-6, 5e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_micro_train_step_kernel_path_matches_plain_path(cuda, dtype, monkeypatch):
    """p3d_micro_sa at 32 px, batch 2, dropout 0: two sites (x_2_2, x_1_3)
    take B2 and B3; x_4_0 and x_3_1 are below one query block."""
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention
    from sap3d_tpu_torch.train.steps import loss_fn_saliency

    # cuDNN's deterministic algorithms: its nondeterministic backward moves
    # this ill-conditioned float32 gradient by 6e-4 to 1.7e-3 in about half
    # the runs of either path, with B3 or its plain version, on an H100
    # (scripts/train_step_spread.py), where B3 repeats itself within 1e-7
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = build_model("p3d_micro_sa", dtype=dtype, device=cuda, seed=0, dropout_rate=0.0)
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.fill_(1.0)  # with gamma = 0 every attention gradient is 0
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 16, 32, 32, 3, device=cuda, generator=gen) * 0.5
    y = torch.rand(2, 16, 32, 32, device=cuda, generator=gen)

    def run(forward=flash_forward_lse, backward=fb.flash_backward):
        monkeypatch.setattr(attention, "flash_forward_lse", forward)
        monkeypatch.setattr(attention, "flash_backward", backward)
        model.train()
        model.zero_grad(set_to_none=True)
        loss = loss_fn_saliency(model(x), y)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()])

    def counts():
        return (flash_forward_lse.launches, fb.flash_backward.launches,
                flash_attend_tokens.launches)

    def without_delta(q, k, v, o, lse, do):
        return fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)

    before = counts()
    loss_k, grad_k = run()
    assert counts() == (before[0] + 2, before[1] + 2, before[2])
    loss_s, grad_s = run(backward=fb.flash_backward_reference)
    _, grad_f = run(backward=without_delta)
    _, grad_r = run(flash_forward_lse_reference, fb.flash_backward_reference)
    loss_tol, grad_tol = _TRAIN_TOL[dtype]
    rel = (grad_k - grad_s).norm().item() / grad_s.norm().item()
    fault = (grad_f - grad_s).norm().item() / grad_s.norm().item()
    print(f"micro train step {dtype}: loss {loss_k} against {loss_s}, gradient relative L2 "
          f"{rel:.3e}, without delta {fault:.3e}; against the plain B2 and B3 "
          f"{(grad_k - grad_r).norm().item() / grad_r.norm().item():.3e}")
    assert abs(loss_k - loss_s) <= loss_tol * abs(loss_s), (loss_k, loss_s)
    assert rel <= grad_tol < fault, (rel, fault)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,d,c", [
    (2, 700, 500, 128, 1024),  # the GN decoder's widest site's d and C: one chunk
    (1, 4500, 300, 64, 512),   # two chunks of queries in the backward
])
def test_b5_matches_the_plain_path(cuda, dtype, b, nq, nk, d, c):
    """Kernel B5: the forward is the B1 kernel (counted as B5's launch, not
    B1's); the backward launches the row-stats kernel and B3 once each, and
    its dq, dk, dv are held to autograd's through ``attend_tokens`` on the
    same inputs; the same computation on a k whose last 64 keys are zeroed
    fails the limits."""
    q, k, v = (t.requires_grad_() for t in _inputs(b, nq, nk, d, c, dtype))
    do = torch.randn(b, nq, c, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).to(dtype)
    before = ta.flash_fwd_chunked_bwd.launches, flash_attend_tokens.launches
    out = ta.flash_fwd_chunked_bwd(q, k, v)
    torch.cuda.synchronize()
    assert (ta.flash_fwd_chunked_bwd.launches, flash_attend_tokens.launches) == \
        (before[0] + 1, before[1])
    want_out = ta.attend_tokens(q, k, v)
    assert agreement(out.detach(), want_out.detach())["excess"] <= 1
    before = flash_row_stats.launches, fb.flash_backward.launches
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_row_stats.launches, fb.flash_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    kz = k.detach().clone()
    kz[:, -64:] = 0
    kz.requires_grad_()
    fault = torch.autograd.grad(ta.flash_fwd_chunked_bwd(q, kz, v), (q, kz, v), do)
    for name, g, w, f, t in zip(("dq", "dk", "dv"), got, want, fault, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype, name
        check = agreement(g, w, fb.TOLERANCE)
        assert check["finite"] and check["excess"] <= 1, (name, check)
        assert agreement(f, w, fb.TOLERANCE)["excess"] > 1, name


def test_gn_site_routes_on_the_card(cuda, monkeypatch):
    """A C = 1024 site: eval runs B1; training runs B2 + B3 with or without
    the JAX package's hybrid flag (the backward gate takes d = 128 and
    C = 1024; the port has no hybrid route); a C = 512 site trains on
    B2 + B3.  An eval-mode site that autograd records is routed as a
    training site."""
    torch.manual_seed(0)
    x = torch.randn(1, 1024, 1, 16, 16, device=cuda, dtype=torch.bfloat16)

    def counts():
        return (flash_attend_tokens.launches, flash_forward_lse.launches,
                fb.flash_backward.launches, ta.flash_fwd_chunked_bwd.launches)

    def run(sa, train, differentiate=None):
        differentiate = train if differentiate is None else differentiate
        sa.train(train)
        before = counts()
        inp = x[:, :sa.h.kernel.shape[0]].clone().requires_grad_(differentiate)
        with torch.set_grad_enabled(differentiate):
            out = sa(inp)
            if differentiate:
                out.float().sum().backward()
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(counts(), before))

    wide = SelfAttention3D(1024, norm_mode="gn", dtype=torch.bfloat16).to(cuda)
    narrow = SelfAttention3D(512, norm_mode="gn", dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        wide.gamma.fill_(1.0)
        narrow.gamma.fill_(1.0)
    monkeypatch.delenv("SAP3D_FLASH_HYBRID", raising=False)
    assert run(wide, False) == (1, 0, 0, 0)
    assert run(wide, True) == (0, 1, 1, 0)
    assert run(narrow, True) == (0, 1, 1, 0)
    assert run(wide, False, differentiate=True) == (0, 1, 1, 0)
    assert run(narrow, False, differentiate=True) == (0, 1, 1, 0)
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", "1")
    assert run(wide, True) == (0, 1, 1, 0)
    assert run(narrow, True) == (0, 1, 1, 0)
    assert run(wide, False, differentiate=True) == (0, 1, 1, 0)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_site_b3_refuses_trains_on_the_plain_path(cuda, dtype, monkeypatch):
    """A C = 144 site (d = 18), which the forward gate takes and B3 does
    not (above 128, not a multiple of 64), with SAP3D_FLASH_HYBRID=1 and
    the dispatch unpatched: a train step launches no kernel and gives the
    gradients of the plain path; B5 called on its tokens raises before it
    launches anything (its card backward is B3)."""
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", "1")
    torch.manual_seed(0)
    sa = SelfAttention3D(144, dtype=dtype).to(cuda)
    with torch.no_grad():
        sa.gamma.fill_(1.0)
    x = torch.randn(1, 144, 1, 16, 16, device=cuda, dtype=dtype)

    def counts():
        return (flash_attend_tokens.launches, flash_forward_lse.launches,
                fb.flash_backward.launches, ta.flash_fwd_chunked_bwd.launches,
                flash_row_stats.launches)

    def step(use_kernel):
        sa.use_kernel = use_kernel
        sa.train()
        sa.zero_grad(set_to_none=True)
        sa(x).float().square().sum().backward()
        torch.cuda.synchronize()
        return torch.cat([p.grad.float().flatten() for p in sa.parameters()])

    before = counts()
    got = step(True)
    assert counts() == before
    assert torch.isfinite(got).all() and got.abs().max() > 0
    # the same plain path again (cuDNN's backward may sum in another order)
    want = step(False)
    assert (got - want).norm() <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * want.norm()
    q, k, v = (torch.randn(1, 256, n, device=cuda, dtype=dtype).requires_grad_()
               for n in (18, 18, 144))
    with pytest.raises(ValueError, match="B5 takes on the card what B3 takes"):
        ta.flash_fwd_chunked_bwd(q, k, v)
    assert counts() == before

@pytest.fixture
def cards(cuda):
    """The visible cards, up to 4: a time mesh over distinct devices."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more CUDA devices; run on a host with several cards")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("placement", ["one_card", "across_cards"])
def test_ring_matches_the_gather_path(request, cuda, placement, dtype):
    """The kernel hop against ``attend_tokens`` and autograd through it, on
    4 shards of one card (one B2 launch per hop in the forward; per hop one
    B2 recompute and one B4 in the backward, no B3) or on one shard per
    visible card (``make_time_mesh`` over 2 to 4 cards: each card launches
    its own shard's kernels, and the key/value shards cross cards between
    hops; the result comes back to cuda:0).  In float32 the values 1e-5
    and gradients 1e-4 of the largest (the CPU tests' limits), in bf16 the
    B2 and B3 limits (``TOLERANCE``)."""
    from sap3d_tpu_torch.core.mesh import make_time_mesh
    from sap3d_tpu_torch.ops.ring_attention import ring_attend_sharded

    if placement == "one_card":
        mesh = make_time_mesh(4, devices=[cuda] * 4)
    else:
        mesh = make_time_mesh(len(request.getfixturevalue("cards")))
    n, cards_used = len(mesh.devices), len(set(mesh.devices))
    q, k, v = (t.requires_grad_() for t in _inputs(2, n * 300, n * 100, 16, 128, dtype))
    do = torch.randn(2, n * 300, 128, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).to(dtype)

    def counts():
        return (flash_attend_tokens.launches, flash_forward_lse.launches,
                fb.flash_backward.launches, fb.flash_backward.launches_lse)

    before = counts()
    out = ring_attend_sharded(mesh, q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    for dev in set(mesh.devices):
        torch.cuda.synchronize(dev)
    # per hop, one launch on each card the mesh uses
    assert tuple(a - b for a, b in zip(counts(), before)) == \
        (0, 2 * n * cards_used, 0, n * cards_used)
    assert out.device == q.device and all(g.device == q.device for g in got)
    want_out = ta.attend_tokens(q, k, v)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, rtol=1e-5,
                                   atol=1e-5 * want_out.abs().max().item())
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())
    else:
        assert agreement(out.detach(), want_out.detach())["excess"] <= 1
        for g, w in zip(got, want):
            assert agreement(g, w, fb.TOLERANCE)["excess"] <= 1


def test_trainer_time_shards_across_cards(cards, tmp_path):
    """``Trainer`` with ``time_shards=2`` on CUDA: the mesh holds cuda:0 and
    cuda:1, the micro SA model's x_2_2 and x_1_3 sites (per shard (1024,
    1024, 32, 256) and (8192, 1024, 16, 128) at 64 px) take the kernel hop,
    and two float32 steps' losses match the unsharded run's.  The limit is
    the CPU test's 1e-5 relative: the first loss is a forward (ring against
    B2 on the whole site, float32 reordering, ~1e-7), the second follows one
    Adam step from gradients that differ by that reordering."""
    import json
    import os

    from sap3d_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
    from sap3d_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(7)
    batches = [((rng.normal(size=(2, 32, 64, 64, 3)) * 0.3).astype(np.float32),
                rng.random((2, 32, 64, 64)).astype(np.float32)) for _ in range(2)]

    def run(tag, time_shards):
        cfg = Config(
            model=ModelConfig(name="p3d_micro_sa", dtype="float32", dropout=0.0),
            data=DataConfig(video_length=32, image_size=64),
            train=TrainConfig(batch_size=2, max_steps=2, time_shards=time_shards,
                              ring_attention=True, plot_iter=10**6, valid_iter=10**9,
                              save_iter=10**9, model_dir=str(tmp_path / tag / "model"),
                              logs_dir=str(tmp_path / tag / "logs")))
        torch.backends.cudnn.deterministic = True
        tr = Trainer(cfg, run=tag, device="cuda")
        before = fb.flash_backward.launches_lse
        try:
            tr.fit(iter(batches))
        finally:
            tr.close()
            torch.backends.cudnn.deterministic = False
        with open(os.path.join(tr.logs_dir, "metrics.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        return losses, tr.time_mesh, fb.flash_backward.launches_lse - before

    base, no_mesh, base_b4 = run("base", 0)
    sharded, mesh, b4 = run("tsharded", 2)
    assert no_mesh is None and base_b4 == 0
    assert mesh.devices == tuple(cards[:2])
    assert b4 == 2 * 2 * 2 * 2  # steps x kernel-hop sites x hops x cards (a launch each)
    assert len(base) == len(sharded) == 2
    np.testing.assert_allclose(sharded, base, rtol=1e-5)


# ---- every layer time-sharded (ops/time_shard.py) ---------------------------

# The micro SA model at 64 px, 64 frames, batch 1, float32, every layer on
# its own of 4 shards of cuda:0 (cuDNN's deterministic algorithms), against
# the unsharded gather step: the eval forward's mean |diff| of the sigmoid
# output, the loss (relative) and the whole gradient (relative L2).  Both
# planted faults of the CPU tests (each shard padded at its own ends; BN
# statistics per shard) must exceed the gradient's limit.  Read on an
# NVIDIA H100 80GB HBM3 at 700.00 W: forward 1.5e-9, loss 0 to 7.6e-7,
# gradient 5.0e-3 to 7.5e-3 (the micro model's train-mode BN over few
# samples a channel is ill-conditioned in float32; the gradient's limit is
# the CPU train tests' GRAD_TOL), the faults 1.64 and 1.21.
_TIME_SHARD_TOL = {"forward": 1e-6, "loss": 1e-5, "grad": 5e-2}
# Each card's peak allocation in the 64-frame bf16 flagship step at batch 4,
# time-sharded over N cards, at most this share of the one-card ring step's
# peak: 1/N of the activations and 0.25 for what stays on cuda:0 (the
# float32 weights, their gradients and Adam's moments, about 1.4 GiB, 14%
# of the ring step's 10.19 GiB).  A run that shards nothing keeps the whole
# clip's activations on cuda:0 and fails.


def _time_shard_share(n: int) -> float:
    return 1.0 / n + 0.25


def test_time_shard_step_matches_the_gather_step(cuda, monkeypatch):
    """The fp32 check of chip_smoke.py phase 9(e)(i) at micro width: the
    sharded eval forward and one train step (the ring on the shards where
    they lie: B2 and B4 on cuda:0) against the unsharded gather step."""
    from chip_smoke import TIME_SHARD_FAULTS, planted_time_shard_fault
    from sap3d_tpu_torch.core.mesh import make_time_mesh, time_shard_batch
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import time_shard as ts
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_eval_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    mesh = make_time_mesh(4, devices=[cuda] * 4)
    models = {}
    for label, ring in (("sharded", mesh), ("gather", None)):
        models[label] = build_model("p3d_micro_sa", dtype="float32", device=cuda, seed=0,
                                    dropout_rate=0.0, ring_mesh=ring)
        with torch.no_grad():
            for sa in models[label].attention_modules():
                sa.gamma.fill_(1.0)
    weights = {k: v.clone() for k, v in models["gather"].state_dict().items()}
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1, 64, 64, 64, 3)) * 0.5).astype(np.float32)
    y = rng.random((1, 64, 64, 64)).astype(np.float32)
    xs, ys = time_shard_batch(mesh, (x, y))
    xd, yd = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    fwd_s = ts.gather(make_eval_step(models["sharded"])(xs))
    fwd_g = make_eval_step(models["gather"])(xd)

    def step(label, inp, tgt):
        m = models[label]
        m.load_state_dict(weights)
        m.train()
        m.zero_grad(set_to_none=True)
        loss = loss_fn_saliency(m(inp), tgt)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), torch.cat([p.grad.flatten() for p in m.parameters()])

    before = (flash_forward_lse.launches, fb.flash_backward.launches,
              fb.flash_backward.launches_lse)
    loss_s, g_s = step("sharded", xs, ys)
    launched = tuple(a - b for a, b in zip((flash_forward_lse.launches, fb.flash_backward.launches,
                                            fb.flash_backward.launches_lse), before))
    loss_g, g_g = step("gather", xd, yd)
    faults = {}
    for fault in TIME_SHARD_FAULTS:
        with planted_time_shard_fault(fault):
            _, g_f = step("sharded", xs, ys)
        faults[fault] = ((g_f - g_g).norm() / g_g.norm()).item()
    fwd = (fwd_s - fwd_g).abs().mean().item()
    rel = ((g_s - g_g).norm() / g_g.norm()).item()
    print(f"time-shard step: forward mean {fwd:.3e}, loss {abs(loss_s - loss_g) / loss_g:.3e}, "
          f"gradient {rel:.3e}, faults {faults}, launches (B2, B3, B4) {launched}")
    assert launched[0] > 0 and launched[1] == 0 and launched[2] > 0
    assert fwd <= _TIME_SHARD_TOL["forward"]
    assert abs(loss_s - loss_g) <= _TIME_SHARD_TOL["loss"] * abs(loss_g)
    assert rel <= _TIME_SHARD_TOL["grad"] < min(faults.values()), (rel, faults)


def test_time_shard_across_cards(cards):
    """The 64-frame bf16 flagship step at batch 4 time-sharded over the
    visible cards (2 to 4, ``make_time_mesh``): every convolution's output
    has one shard on each card, in mesh order, and each card's peak
    allocation is at most ``_time_shard_share(N)`` of the ring step's on
    one card (the whole clip on cuda:0, its sites as 4-shard rings).  The
    median ms of 3 more steps of each is printed, not held."""
    import time

    from sap3d_tpu_torch.core.mesh import make_time_mesh, time_shard_batch
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import layers
    from sap3d_tpu_torch.ops import time_shard as ts
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 64, 112, 112, 3)) * 0.3).astype(np.float32)
    y = rng.random((4, 64, 112, 112)).astype(np.float32)

    def peaks(mesh, inputs):
        model = build_model("unet++", dtype="bfloat16", device=cards[0], seed=0, ring_mesh=mesh)
        step = make_train_step(create_train_state(model, lr=1e-4))
        placed = set()
        for m in model.modules():
            if isinstance(m, (layers.Conv3d, layers.ConvTranspose3d)):
                m.register_forward_hook(lambda m, a, out: placed.add(
                    tuple(str(p.device) for p in out.parts) if isinstance(out, ts.Shards)
                    else (str(out.device),)))
        for dev in cards:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        step(*inputs(mesh))
        for dev in cards:
            torch.cuda.synchronize(dev)
        got = [torch.cuda.max_memory_allocated(dev) for dev in cards]
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(*inputs(mesh))
            for dev in cards:
                torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        del model, step
        torch.cuda.empty_cache()
        return got, placed, sorted(times)[1]

    one_card = make_time_mesh(4, devices=[cards[0]] * 4)
    ring, ring_placed, ring_ms = peaks(one_card, lambda mesh: (
        torch.from_numpy(x).to(cards[0]), torch.from_numpy(y).to(cards[0])))
    mesh = make_time_mesh(len(cards))
    sharded, placed, sharded_ms = peaks(mesh, lambda mesh: time_shard_batch(mesh, (x, y)))
    # read, not held: the ring alone with its hops across the cards
    ring_n, _, ring_n_ms = peaks(mesh, lambda mesh: (torch.from_numpy(x).to(cards[0]),
                                                     torch.from_numpy(y).to(cards[0])))
    limit = _time_shard_share(len(cards)) * ring[0]
    gib = lambda b: [round(p / 2**30, 2) for p in b]  # noqa: E731
    print(f"time-shard across {len(cards)} cards: ring step on one card {ring[0] / 2**30:.2f} "
          f"GiB, {ring_ms:.1f} ms (inputs from the host); sharded step per card "
          f"{gib(sharded)} GiB (limit {limit / 2**30:.2f}), {sharded_ms:.1f} ms; the ring "
          f"alone with its hops across the cards, per card {gib(ring_n)} GiB, {ring_n_ms:.1f} ms")
    assert ring_placed == {(str(cards[0]),)}
    assert placed == {tuple(str(d) for d in mesh.devices)}
    assert max(sharded) <= limit, (sharded, limit)


# ---- data parallel (core/mesh.launch) ---------------------------------------

# The micro model's float32 gradient at 64 px (the registry's weights,
# gamma 1), data parallel against one process: 1.8e-2 apart on an H100
# (relative L2; summation order and the ranks' sums of x and x^2 for BN's
# statistics, carried through this model's ill-conditioned train-mode BN),
# held to the micro model's float32 limit of the CPU train tests (GRAD_TOL,
# 5e-2), which averaged gradients (0.5 away) fail.  In float64 (the plain path) the two
# agree to summation order but for the head's float32 output, whose rounding
# flips where the two runs' sums (batch 2 against batch 4) differ: 1.6e-8
# read on an H100 (1.2e-14 on the CPU, whose sums per clip do not depend on
# the batch); held to 1e-6.
_DP_GRAD_TOL = {"torch.float32": 5e-2, "torch.float64": 1e-6}


@pytest.mark.parametrize("placement", ["one_card_gloo", "across_cards_nccl"])
def test_data_parallel_step_matches_one_process(request, cuda, placement, monkeypatch):
    """Two ranks of ``core/mesh.launch``: on cuda:0 twice over gloo, or on
    cuda:0 and cuda:1 over NCCL.  ``p3d_micro_sa`` at 64 px, a global batch
    of 4 (2 rows a rank), dropout 0: per rank 2 B2 and 2 B3 launches in
    float32 (x_2_2 and x_1_3); the summed gradient against one process's at
    the global batch under ``_DP_GRAD_TOL``, the averaged gradient failing
    the float32 limit; both ranks' gradients and states bit for bit equal."""
    from _torch_dp_ranks import card_rank, micro_model

    from sap3d_tpu_torch.core.mesh import data_backend, launch, make_mesh
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import loss_fn_saliency

    if placement == "one_card_gloo":
        mesh = make_mesh(2, devices=[cuda] * 2)
    else:
        mesh = make_mesh(2, devices=request.getfixturevalue("cards")[:2])
    assert data_backend(mesh) == placement.rsplit("_", 1)[1]
    model = build_model("p3d_micro_sa", device="cpu", seed=0, dropout_rate=0.0)
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.fill_(1.0)  # with gamma = 0 every attention gradient is 0
    weights = model.state_dict()
    rng = np.random.default_rng(8)
    frames = (rng.normal(size=(4, 16, 64, 64, 3)) * 0.5).astype(np.float32)
    targets = rng.uniform(size=(4, 16, 64, 64)).astype(np.float32)
    ranks = launch(mesh, card_rank, weights, frames, targets)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for dtype in (torch.float32, torch.float64):
        one = micro_model(weights, dtype, device=cuda).train()
        loss = loss_fn_saliency(one(torch.from_numpy(frames).to(cuda, dtype)),
                                torch.from_numpy(targets).to(cuda, dtype))
        loss.backward()
        want = {n: p.grad.cpu() for n, p in one.named_parameters()}
        got = [r[str(dtype)] for r in ranks]

        def rel(grads):
            num = sum(((grads[n] - w) ** 2).sum() for n, w in want.items()).sqrt()
            return (num / sum((w ** 2).sum() for w in want.values()).sqrt()).item()

        tol = _DP_GRAD_TOL[str(dtype)]
        print(f"data parallel {placement} {dtype}: loss {got[0]['loss']} against "
              f"{loss.item()}, gradient relative L2 {rel(got[0]['grads']):.3e} (limit {tol:g}), "
              f"averaged {rel({n: g / 2 for n, g in got[0]['grads'].items()}):.3e}")
        assert got[0]["loss"] == pytest.approx(loss.item(), rel=1e-5)
        assert rel(got[0]["grads"]) <= tol
        if dtype == torch.float32:
            assert all(r["launches"] == (2, 2) for r in got)
            assert rel({n: g / 2 for n, g in got[0]["grads"].items()}) > tol
        for r in got[1:]:
            assert all(torch.equal(g, r["grads"][n]) for n, g in got[0]["grads"].items())
            assert all(torch.equal(v, r["state"][k]) for k, v in got[0]["state"].items())


# ---- multi-host (cli train --distributed) -----------------------------------

# The parameters upstream of the encoder's pool1, a max-pool whose windows
# overlap and whose backward (no deterministic version) adds in run order:
# after step 1 only they and Adam's moments of them may differ between two
# sound runs (``chip_smoke.py``'s MH_POOL1_UPSTREAM, read on an H100).
_POOL1_UPSTREAM = ("encoder.stem.", "encoder.stem_norm.")
# Those tensors after step 1 (relative L2 each) and the losses of the later
# steps (|difference| over the loss's fall since step 1): the limits of
# ``chip_smoke.py`` phase 14 (MH_STEM_TOL, MH_LATER_LOSS_TOL), set there from
# repeated runs of the flagship in bf16 on an H100 (at most 1.684e-3 and
# 2.490e-3).  Averaged gradients fail the first (the stem's Adam moments
# half and quarter: 0.75 apart).
_STEM_TOL, _LATER_LOSS_TOL = 1e-2, 2e-2


def _checkpoint_tensors(tree, prefix=""):
    """Every tensor of a checkpoint (model, Adam state) by its path."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    return {k: v for key, sub in items
            for k, v in _checkpoint_tensors(sub, f"{prefix}/{key}").items()}


def _upstream(tensors, names):
    """The paths of ``_POOL1_UPSTREAM``'s parameters, their buffers and
    Adam's state of them (indexed by parameter in ``names``' order)."""
    return {n for n in tensors
            if (n.startswith("/model/") and n[len("/model/"):].startswith(_POOL1_UPSTREAM))
            or (n.startswith("/optimizer/state/")
                and names[int(n.split("/")[3])].startswith(_POOL1_UPSTREAM))}


def _stem_distance(first, want, upstream):
    """The largest relative L2 of an ``upstream`` tensor after step 1."""
    return max(((first[n].double() - want[n].double()).norm()
                / want[n].double().norm()).item() for n in upstream)


def test_distributed_processes_across_cards_match_one_process(cards, tmp_path):
    """``cli train --distributed``: two processes on this host, each seeing
    its own card (``CUDA_VISIBLE_DEVICES``), one NCCL rank each (the
    processes publish the cards' UUIDs, so the backend sees two cards),
    against one process of ``--devices 2`` on the same two cards.
    ``p3d_micro_sa`` at 64 px in float32 (B2 and B3 at x_2_2 and x_1_3),
    global batch 4, dropout 0, shuffle off, 3 steps, a checkpoint each.
    Every rank reports NCCL and a world of 2.  The same two NCCL ranks on
    the same clips: step 1's loss, and every tensor of the checkpoint after
    step 1 but the stem's, bit for bit; the stem's within ``_STEM_TOL`` (the
    averaged gradients' moments failing it), the later losses within
    ``_LATER_LOSS_TOL`` of their fall since step 1."""
    import json
    import os
    import subprocess
    import sys

    from _torch_dp_ranks import RANKS_ENV

    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.models.registry import build_model

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds = make_synthetic_dataset(str(tmp_path / "data"), num_videos=2, frames_per_video=40,
                                size=(64, 64))
    argv = [sys.executable, "-c",
            "import sys, _torch_dp_ranks as r; sys.exit(r.recorded_cli(sys.argv[1:]))",
            "train", "--structure", "p3d_micro_sa", "--dtype", "float32", "--imagesize", "64",
            "--frames", ds["frame_dirs"], "--densities", ds["density_dirs"],
            "--batch", "4", "--epoch", "4", "--max-steps", "3", "--dropout", "0",
            "--shuffle", "false", "--plotiter", "1", "--validiter", "100000",
            "--saveiter", "1", "--threads", "2", "--devices", "2"]
    coordinator = f"127.0.0.1:{_free_port()}"
    runs = {"distributed": [argv + ["--distributed", "true", "--coordinator", coordinator,
                                    "--num-processes", "2", "--process-id", str(i)]
                            for i in (0, 1)],
            "one_process": [argv]}
    visible = {"distributed": ["0", "1"], "one_process": ["0,1"]}
    out = {}
    for name, commands in runs.items():
        (tmp_path / name / "ranks").mkdir(parents=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.path.join(repo, "tests")]),
                   **{RANKS_ENV: str(tmp_path / name / "ranks")})
        procs = [subprocess.Popen(cmd, cwd=tmp_path / name, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=dict(env, CUDA_VISIBLE_DEVICES=vis))
                 for cmd, vis in zip(commands, visible[name])]
        for p in procs:
            log = p.communicate(timeout=600)[0]
            assert p.returncode == 0, log[-4000:]
        (run,) = os.listdir(tmp_path / name / "model")
        with open(tmp_path / name / "logs" / run / "metrics.jsonl") as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        ranks = []
        for r in (0, 1):
            with open(tmp_path / name / "ranks" / f"rank{r}.json") as f:
                ranks.append(json.load(f))
        ckpts = {s: _checkpoint_tensors(torch.load(
            tmp_path / name / "model" / run / f"ckpt_{s}.pt", weights_only=False))
            for s in (1, 3)}
        out[name] = losses, ranks, ckpts
    (got, got_ranks, got_ckpt), (want, want_ranks, want_ckpt) = \
        out["distributed"], out["one_process"]
    names = [n for n, _ in build_model("p3d_micro_sa", device="meta").named_parameters()]
    upstream = _upstream(want_ckpt[1], names)
    differ = [n for n, t in got_ckpt[1].items() if not torch.equal(t, want_ckpt[1][n])]
    stem = _stem_distance(got_ckpt[1], want_ckpt[1], upstream)
    averaged = _stem_distance(
        {n: t * {"exp_avg": 0.5, "exp_avg_sq": 0.25}.get(n.rsplit("/", 1)[1], 1.0)
         for n, t in got_ckpt[1].items()}, want_ckpt[1], upstream)
    later = [abs(a - b) / abs(want[0] - b) for a, b in zip(got[1:], want[1:])]
    num = sum(((got_ckpt[3][n].double() - v.double()) ** 2).sum()
              for n, v in want_ckpt[3].items() if n.startswith("/model/"))
    den = sum((v.double() ** 2).sum() for n, v in want_ckpt[3].items() if n.startswith("/model/"))
    print(f"distributed against one process across cards: ranks {got_ranks} / {want_ranks}; "
          f"losses {got} / {want}; after step 1 {len(differ)} tensors differ, outside the "
          f"stem {[n for n in differ if n not in upstream]}; stem relative L2 {stem:.3e} "
          f"(limit {_STEM_TOL:g}; averaged gradients {averaged:.3e}); later losses "
          f"{[f'{v:.3e}' for v in later]} of their fall (limit {_LATER_LOSS_TOL:g}); after "
          f"step 3 parameters relative L2 {(num / den).sqrt().item():.3e}")
    for ranks in (got_ranks, want_ranks):
        assert [(r["rank"], r["world_size"], r["backend"]) for r in ranks] == \
            [(0, 2, "nccl"), (1, 2, "nccl")]
    assert len(got) == len(want) == 3
    assert got[0] == want[0]
    assert got_ckpt[1].keys() == want_ckpt[1].keys()
    assert [n for n in differ if n not in upstream] == []
    assert stem <= _STEM_TOL < averaged
    assert max(later) <= _LATER_LOSS_TOL


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- tensor parallel (core/sharding_rules.py) -------------------------------

# The float64 tensor-parallel step of p3d_micro_sa (the plain path) against
# one device at the global batch, relative L2 of the summed gradient: the
# same summation-order and float32-head argument as _DP_GRAD_TOL's float64
# limit (1e-6), which each planted fault fails by orders of magnitude.
_TP_GRAD_TOL = 1e-6


@pytest.mark.parametrize("placement", ["dp2_tp2_nccl", "tp2_nccl"])
def test_tensor_parallel_step_matches_one_device(cards, placement):
    """``p3d_micro_sa`` at 32 px, a global batch of 4, dropout 0, its 22
    kernels of 128 output features or more sharded on the model axis:
    on four distinct cards as 2 x 2 (data x model), or on two as 1 x 2,
    over NCCL.  One float64 step's summed gradient (slices gathered)
    against one device's, each planted fault failing; after two steps
    the replicated tensors bit-identical on every rank and each slice on
    its data column."""
    from _torch_tp_ranks import TENSOR_PARALLEL_FAULTS, card_rank, model_of

    from sap3d_tpu_torch.core.mesh import data_backend, launch
    from sap3d_tpu_torch.core.sharding_rules import make_mesh_2d
    from sap3d_tpu_torch.models.registry import MODEL_REGISTRY, build_model
    from sap3d_tpu_torch.train.steps import loss_fn_saliency

    shape = (2, 2) if placement == "dp2_tp2_nccl" else (1, 2)
    if len(cards) < shape[0] * shape[1]:
        pytest.skip(f"needs {shape[0] * shape[1]} CUDA devices; {len(cards)} visible")
    mesh = make_mesh_2d(*shape, devices=cards[:shape[0] * shape[1]])
    assert data_backend(mesh) == "nccl"
    cfg = dict(MODEL_REGISTRY["p3d_micro_sa"])
    model = build_model("p3d_micro_sa", device="cpu", seed=0, dropout_rate=0.0)
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.fill_(1.0)  # with gamma = 0 every attention gradient is 0
    weights = model.state_dict()
    rng = np.random.default_rng(9)
    frames = (rng.normal(size=(4, 16, 32, 32, 3)) * 0.5).astype(np.float32)
    targets = rng.uniform(size=(4, 16, 32, 32)).astype(np.float32)
    runs = launch(mesh, card_rank, cfg, weights, frames, targets)

    torch.backends.cudnn.deterministic = True
    one = model_of(cfg, weights, torch.float64, cards[0]).train()
    loss = loss_fn_saliency(one(torch.from_numpy(frames).to(cards[0], torch.float64)),
                            torch.from_numpy(targets).to(cards[0], torch.float64))
    loss.backward()
    want = {n: p.grad.cpu() for n, p in one.named_parameters()}

    def rel(grads):
        num = sum(((grads[n] - w) ** 2).sum() for n, w in want.items()).sqrt()
        return (num / sum((w ** 2).sum() for w in want.values()).sqrt()).item()

    dist = {k: rel(runs[0][k]["grads"]) for k in ("sound", *TENSOR_PARALLEL_FAULTS)}
    print(f"tensor parallel {placement} float64: loss {runs[0]['sound']['losses']} against "
          f"{loss.item()}, gradient relative L2 {dist} (limit {_TP_GRAD_TOL:g})")
    assert runs[0]["sound"]["losses"][0] == pytest.approx(loss.item(), rel=1e-7)
    assert dist["sound"] <= _TP_GRAD_TOL
    assert all(dist[f] > 10 * _TP_GRAD_TOL for f in TENSOR_PARALLEL_FAULTS)
    sharded = set(runs[0]["sound"]["shapes"])
    assert len(sharded) == 22
    local = [r["sound"]["local"] for r in runs]

    def of_slice(key):
        return any(key == f"model/{n}" or key.startswith(f"optimizer/{n}/") for n in sharded)

    for r, x in enumerate(local):
        for k, v in x.items():
            if not of_slice(k):
                assert torch.equal(v, local[0][k]), (r, k)
            else:  # the same slice on every rank of the data column
                assert torch.equal(v, local[r % shape[1]][k]), (r, k)


def test_profile_scripts_hold_the_kernels_at_the_flagship_shapes(cuda, monkeypatch):
    """profile_ring_hop's check (the kernel hop, B2 and B4, against the
    chunked hop at its long-clip shard shape, bf16; both hops' gradients
    finite from the -inf state; the kernel hop with its last 64 keys
    dropped failing) and profile_attention's holds (B1, B2, B3 against their
    plain versions at the flagship's three kernel sites at batch 16 in bf16,
    on the script's own inputs), as the scripts run them."""
    from sap3d_tpu_torch.ops import ring_attention
    from sap3d_tpu_torch.scripts import profile_attention, profile_ring_hop

    args = profile_ring_hop.hop_inputs(profile_ring_hop.SHAPE, torch.bfloat16, cuda)
    check = profile_ring_hop.check_hops(args)
    assert check["excess"] <= 1 and all(check["grads_finite"].values())
    monkeypatch.setitem(profile_ring_hop.HOPS, "pallas", lambda q, k, v, *state:
                        ring_attention._pallas_hop(q, k[:, :-64], v[:, :-64], *state))
    with pytest.raises(AssertionError, match="disagrees"):
        profile_ring_hop.check_hops(args)

    rng = np.random.default_rng(0)
    held = {}
    for name, dhw, c, sub in profile_attention.SITES:
        q, k, v = profile_attention.site_inputs(rng, dhw, c, sub, profile_attention.B,
                                                torch.bfloat16, cuda)
        (_, nq, d), nk = q.shape, k.shape[1]
        routes = {mode: ta.attention_route(nq, nk, d, c, torch.bfloat16, train)
                  for mode, train in (("forward", False), ("train", True))}
        if "flash" in routes.values():
            held[name] = profile_attention.hold_kernels(name, q, k, v, routes)
    assert set(held) == {"x_3_1", "x_2_2", "x_1_3"}
    assert all(len(h) == 6 and max(a["excess"] for a in h.values()) <= 1 for h in held.values())


# -- K train steps per call: the captured multi-step (train/steps.py) ----------


def test_multi_step_captured_matches_eager_and_planted_faults_fail(cuda):
    """chip_smoke.py phase 17(a): two calls of the captured multi-step at
    K = 4 (a warm-up call, then replays) against 8 eager single steps from
    one state and generator, in fp32 with cuDNN's deterministic algorithms,
    within twice the larger of two more eager runs' distances plus
    ``MS_MICRO_FLOOR``; the generator where the eager run left it; replays
    that skip the batch copy, and one replay fewer, failing that hold.  It
    raises where a hold fails."""
    from chip_smoke import multi_step_micro_hold

    res = multi_step_micro_hold(torch)
    assert res["hold"]["ok"] and res["replays"] > 0
    assert res["captured_launches"]["B2"] > 0 and res["captured_launches"]["B3"] > 0
    assert not any(h["ok"] for h in res["faults"].values())


def test_multi_step_capture_raises_and_recaptures_replaced_state(cuda, monkeypatch):
    """A capture that fails raises (an optimizer that is not capturable);
    nothing steps on in its place.  A call that finds the Adam moments
    replaced (a state dict loaded) warms up and captures again."""
    import copy

    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import CapturedMultiStep, make_multi_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    frames = torch.randn((2, 2, 16, 32, 32, 3), device=cuda, generator=gen) * 0.5
    targets = torch.rand((2, 2, 16, 32, 32), device=cuda, generator=gen)

    def fresh():
        model = build_model("p3d_micro_sa", dtype="float32", device=cuda, seed=0,
                            dropout_rate=0.5)
        return create_train_state(model, lr=1e-4)

    state = fresh()
    for group in state.optimizer.param_groups:
        group["capturable"] = False
    multi = make_multi_train_step(state, 2)
    assert isinstance(multi, CapturedMultiStep)
    with pytest.raises(RuntimeError) as raised:
        multi(frames, targets, gen)
    messages, e = [], raised.value
    while e is not None:  # the capture's end may raise over the optimizer's error
        messages.append(str(e))
        e = e.__context__
    assert any("capturable" in m for m in messages), messages
    assert multi.graph is None and state.step == 2  # the warm-up's two steps, no more

    state = fresh()
    multi = make_multi_train_step(state, 2)
    multi(frames, targets, gen)
    first = multi.graph
    multi(frames, targets, gen)
    assert multi.replays == 2 and multi.graph is first
    # new moment tensors, as a checkpoint restore from host memory makes
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    losses = multi(frames, targets, gen)
    torch.cuda.synchronize()
    assert multi.graph is not first and multi.replays == 2 and state.step == 6
    assert multi.captures == 2
    assert bool(torch.isfinite(losses).all())
    multi(frames, targets, gen)
    assert multi.replays == 4 and state.step == 8
