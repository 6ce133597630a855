"""Parity of the port's attention (sap3d_tpu_torch/ops/attention.py) with the
JAX package's, on the CPU in float32.

``gamma`` and the BN statistics are random: with gamma = 0 (its init) the
block is the identity and the attention would go untested.  Tolerance:
1e-4 absolute on O(1) outputs (float32 on both sides; the score matmuls
sum up to C terms in different orders); 1e-5 of the largest output for the
non-local block, whose scores are divided by the key count instead of
exponentiated.

The dispatch gate (``attention_route``) is held to the routes the port
names for the flagship's four sites, the GN SA decoder's three and the
'full' head's ``x_0_1_sa``, in eval and train mode, with
``SAP3D_FLASH_HYBRID`` unset and "1" (the JAX package's hybrid flag, which
moves no route of the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import record_routes
from _torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)
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


@pytest.mark.parametrize("dhw,c,sub_sample", [
    ((1, 7, 7), 32, False),   # x_4_0_nl
    ((4, 12, 12), 16, True),  # x_1_3_nl: keys and values pooled by 2
])
def test_non_local_matches_flax(dhw, c, sub_sample):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, *dhw, c)).astype(np.float32)
    fm = ja.NonLocal3D(norm_mode="gn", sub_sample=sub_sample)  # w_y's norm stays BN
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(
        lambda v: (rng.normal(size=v.shape) / np.sqrt(max(1, int(np.prod(v.shape[:-1]))))
                   ).astype(np.float32) if v.ndim > 1
        else rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        jax.tree.map(np.asarray, variables["params"]))
    stats = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
                         jax.tree.map(np.asarray, variables["batch_stats"]))
    assert set(stats["Norm_0"]) == {"BatchNorm_0"}
    want = np.asarray(fm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=False))
    tm = ta.NonLocal3D(c, sub_sample).eval()
    tm.load_state_dict(state_dict_from_flax(params, stats, model=tm), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    with torch.inference_mode():
        got = tm(xt).numpy().transpose(0, 2, 3, 4, 1)
    # 1e-5 of the largest output (the random w_y bias and scale make it O(10))
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert np.abs(want - x).max() > 1e-2  # the block contributes
    with pytest.raises(ValueError):
        ta.NonLocal3D(1)


# (Nq, Nk, d, C) of every self-attention site at full width (16-frame
# 112x112 clips) -> its route in (eval, train, train with the JAX package's
# hybrid flag on: the port has no hybrid route)
_ROUTES = {
    "x_4_0": ((49, 49, 128, 1024), ("plain", "plain", "plain")),
    "x_3_1": ((392, 392, 64, 512), ("flash", "flash", "flash")),
    "x_2_2": ((3136, 3136, 32, 256), ("flash", "flash", "flash")),
    "x_1_3": ((25088, 3136, 16, 128), ("flash", "flash", "flash")),
    "gn_pool2": ((3136, 3136, 32, 256), ("flash", "flash", "flash")),
    "gn_deconv_pool3": ((3136, 3136, 64, 512), ("flash", "flash", "flash")),
    "gn_deconv_pool4": ((3136, 3136, 128, 1024), ("flash", "flash", "flash")),
    "x_0_1": ((200704, 3136, 2, 16), ("flash", "flash", "flash")),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("site", sorted(_ROUTES))
def test_gate_gives_each_site_its_route(site, dtype, monkeypatch):
    shape, (eval_route, train_route, hybrid_route) = _ROUTES[site]
    monkeypatch.delenv("SAP3D_FLASH_HYBRID", raising=False)
    assert ta.attention_route(*shape, dtype, train=False) == eval_route
    assert ta.attention_route(*shape, dtype, train=True) == train_route
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", "1")
    assert ta.attention_route(*shape, dtype, train=False) == eval_route
    assert ta.attention_route(*shape, dtype, train=True) == hybrid_route
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", "0")  # the default, spelled out
    assert ta.attention_route(*shape, dtype, train=True) == train_route


def test_gate_follows_the_kernels_own_limits():
    """A site the gate gives to a kernel is one its launcher takes: the
    limits are the kernels' (d <= 128; C a multiple of 16, for the backward
    up to 128 or a multiple of 64 up to 1024; float32 or bfloat16 only; a
    row of q or k shorter than whole 16-byte chunks is padded)."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    ok = (3136, 3136, 64, 512, torch.bfloat16)
    assert fa.forward_viable(*ok) and fb.backward_viable(*ok)
    assert not fa.forward_viable(255, 3136, 64, 512, torch.bfloat16)   # under one block
    assert not fa.forward_viable(3136, 3136, 136, 1088, torch.bfloat16)  # d above 128
    assert not fa.forward_viable(3136, 3136, 5, 40, torch.float32)     # C % 16
    assert fa.forward_viable(3136, 3136, 6, 48, torch.float32)
    assert fa.forward_viable(3136, 3136, 12, 64, torch.bfloat16)       # padded to 16 columns
    assert not fa.forward_viable(*ok[:4], torch.float16)
    assert fa.forward_viable(3136, 3136, 72, 576, torch.bfloat16)
    assert fb.backward_viable(3136, 3136, 72, 576, torch.bfloat16)      # C up to 1024
    assert fa.forward_viable(3136, 3136, 72, 1088, torch.bfloat16)
    assert not fb.backward_viable(3136, 3136, 72, 1088, torch.bfloat16)  # C above 1024
    assert fb.backward_viable(3136, 3136, 16, 128, torch.bfloat16)
    assert fa.forward_viable(3136, 3136, 18, 144, torch.bfloat16)
    assert not fb.backward_viable(3136, 3136, 18, 144, torch.bfloat16)  # C > 128, C % 64
    assert (fa.MAX_D, fa.C_MULTIPLE) == (128, 16)
    assert (fb.MAX_D, fb.MAX_C, fb.C_MULTIPLE, fb.WIDE_C_MULTIPLE, fb.NARROW_MAX_C) == \
        (128, 1024, 16, 64, 128)


@pytest.mark.parametrize("dtype,d,padded", [(torch.bfloat16, 2, 8), (torch.float32, 2, 4),
                                            (torch.bfloat16, 16, 16), (torch.float32, 6, 8)])
def test_launchers_pad_rows_to_whole_chunks(dtype, d, padded):
    """The kernels read rows of q and k in 16-byte chunks: the launchers
    append zero columns, which leave q k^T as it was."""
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa

    q, k = torch.randn(2, 5, d).to(dtype), torch.randn(2, 3, d).to(dtype)
    qp, kp = fa.pad_rows(q), fa.pad_rows(k)
    assert qp.shape == (2, 5, padded) and kp.shape == (2, 3, padded)
    assert (qp is q) == (padded == d)
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    torch.testing.assert_close(torch.bmm(qp.float(), kp.float().transpose(1, 2)),
                               torch.bmm(q.float(), k.float().transpose(1, 2)))


def test_model_routes_follow_the_gate(monkeypatch):
    """In a module the route follows ``training`` at each call, whatever
    ``SAP3D_FLASH_HYBRID`` says, and ``use_kernel=False`` asks the gate
    nothing.  C = 144 (d = 18): the forward takes it, the backward does not
    (above 128, not a multiple of 64), so training goes to the plain path
    with the JAX package's hybrid flag on too; no registry site is such a
    site any more."""
    seen = record_routes(monkeypatch)
    sa = ta.SelfAttention3D(144)
    x = torch.randn(1, 144, 1, 16, 16)  # Nq = 256, d = 18, C = 144
    monkeypatch.delenv("SAP3D_FLASH_HYBRID", raising=False)
    with torch.no_grad():
        sa.eval()(x)
        sa.train()(x)
        monkeypatch.setenv("SAP3D_FLASH_HYBRID", "1")
        sa(x)
        sa.use_kernel = False
        sa(x)
    assert seen == [((256, 256, 18, 144), route) for route in ("flash", "plain", "plain")]


@pytest.mark.parametrize("hybrid", ["0", "1"], ids=["hybrid_off", "hybrid_on"])
def test_eval_mode_site_that_autograd_records_takes_the_backward_gate(monkeypatch, hybrid):
    """An eval-mode module whose tokens autograd records (an input-gradient
    pass, fine-tuning under ``eval()``) is differentiated: a C = 144 site,
    which B3 does not take (the forward does), must not go to B2 + B3; with
    the JAX package's hybrid flag on or off it goes to the plain path."""
    seen = record_routes(monkeypatch)
    monkeypatch.setenv("SAP3D_FLASH_HYBRID", hybrid)
    torch.manual_seed(0)
    sa = ta.SelfAttention3D(144).eval()
    with torch.no_grad():
        sa.gamma.fill_(1.0)
    x = torch.randn(1, 144, 1, 16, 16, requires_grad=True)
    sa(x).square().sum().backward()
    assert seen == [((256, 256, 18, 144), "plain")]
    got = x.grad.clone()
    # the same gradient as the plain path gives
    sa.use_kernel, x.grad = False, None
    sa(x).square().sum().backward()
    torch.testing.assert_close(got, x.grad, rtol=1e-4, atol=1e-5)
    # frozen weights and an input without gradient: nothing records, B1's route
    sa.use_kernel = True
    sa.requires_grad_(False)
    sa(x.detach())
    assert seen[-1][1] == "flash"
