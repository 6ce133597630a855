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
# that is a multiple of 64 but not of 128
_SHAPES = [
    (3, 300, 200, 16, 128),  # ragged Nq and Nk
    (1, 392, 392, 64, 512),  # x_3_1
    (1, 700, 500, 32, 256),  # x_2_2 proportions
    (2, 1000, 300, 16, 128), # x_1_3 proportions
    (2, 130, 70, 24, 192),   # three 64-column slabs of C
    (1, 1, 3, 8, 64),        # one query (with one key, dq and dk are 0)
    (2, 700, 300, 2, 16),    # x_0_1_sa's d and C: rows padded, one narrow slab
    (1, 300, 100, 6, 48),    # three narrow slabs
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
    before = nolse.flash_nolse.launches
    got = nolse.flash_nolse(q, k, v)
    torch.cuda.synchronize()
    assert nolse.flash_nolse.launches == before + 1
    assert got.shape == (b, nq, c) and got.dtype == dtype
    want = nolse.flash_nolse_reference(q, k, v)
    check = agreement(got, want, nolse.TOLERANCE)
    assert check["finite"] and check["excess"] <= 1
    if dtype == torch.bfloat16:
        b1 = agreement(flash_attend_tokens(q, k, v), want, nolse.TOLERANCE)
        assert check["mean_abs_err"] <= b1["mean_abs_err"]


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


def test_b3_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs(1, 8, 8, 8, 1024, torch.float32)  # C above 512
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
    B1's); dq, dk, dv are autograd's through ``attend_tokens`` on the same
    inputs; the same computation on a k whose last 64 keys are zeroed fails
    the limits."""
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
    got = torch.autograd.grad(out, (q, k, v), do)
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
    """A C = 1024 site: eval runs B1; training runs B5 with the hybrid flag
    and no kernel without it; a C = 512 site trains on B2 + B3.  An eval-mode
    site that autograd records is routed as a training site: its backward
    runs and never reaches B3 at C = 1024."""
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
    assert run(wide, True) == (0, 0, 0, 0)
    assert run(narrow, True) == (0, 1, 1, 0)
    assert run(wide, False, differentiate=True) == (0, 0, 0, 0)
    assert run(narrow, False, differentiate=True) == (0, 1, 1, 0)
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", "1")
    assert run(wide, True) == (0, 0, 0, 1)
    assert run(narrow, True) == (0, 1, 1, 0)
    assert run(wide, False, differentiate=True) == (0, 0, 0, 1)


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
