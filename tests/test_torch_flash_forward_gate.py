"""The forward kernel's gate and launch plan (B1, B2), on the CPU.

* Every registry name at full width ([1, 16, 112, 112, 3], built on the
  meta device, so nothing is computed): the route of every self-attention
  site in eval mode, in bf16 and float32, held to the routes the port gives
  today (``attention_route``; ``SAP3D_FLASH_HYBRID`` unset).  Train mode is
  held by ``test_torch_flash_backward_gate.py``, whose table of train-mode
  routes this file reads.
* ``launch_plan`` (the mirror of the kernel's host function ``plan``) at
  every bf16 site the forward gate takes, at the batches the port runs
  them, and at the plan's edge shapes: an instantiation the library
  compiles, CTAs that cover every query row and every column of C (and no
  whole CTA past either), shared memory and threads a CTA may take, and
  the CTAs per SM it counts on fitting in shared memory.  The card tests
  hold the library's own plan equal to it (``tests/test_torch_cuda.py``).
* The same in float32, whose kernel holds three bf16 planes of every tile
  (``csrc/split_bf16.cuh``): at every float32 site, at the edge shapes, and
  at every (d, C) the float32 gate takes, the plan fits one CTA's shared
  memory with its alignment slack.
"""

import pytest
import torch

from sap3d_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from sap3d_tpu_torch.ops import attention
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from test_torch_flash_backward_gate import ROUTES as TRAIN_ROUTES
from test_torch_flash_backward_gate import (GN_DECONV3, GN_DECONV4, GN_POOL2, X_0_1_SA, X_1_3,
                                            X_2_2, X_3_1)

# (Nq, Nk, d, C) -> route of each name's sites in eval mode (the same in
# bf16 and float32): train mode's, now that the backward gate takes every
# site the forward takes (GN deconv_pool4, d = 128 and C = 1024, included)
EVAL_ROUTES = dict(TRAIN_ROUTES, inference_p3d_sa_decoder_block={
    GN_POOL2: "flash", GN_DECONV3: "flash", GN_DECONV4: "flash"})


def test_the_tables_name_every_registry_name():
    assert set(EVAL_ROUTES) == set(TRAIN_ROUTES) == set(MODEL_REGISTRY)
    assert len(EVAL_ROUTES) == 14
    # eval and train agree: the backward gate refuses no registry site the
    # forward gate takes
    assert {n for n in EVAL_ROUTES if EVAL_ROUTES[n] != TRAIN_ROUTES[n]} == set()


@pytest.mark.parametrize("name", sorted(EVAL_ROUTES))
def test_attention_sites_keep_their_routes(name, monkeypatch):
    monkeypatch.delenv("SAP3D_FLASH_HYBRID", raising=False)
    orig, seen = attention.attention_route, {}

    def spy(nq, nk, d, c, dtype, train):
        route = orig(nq, nk, d, c, dtype, train)
        seen[(nq, nk, d, c)] = route
        return "plain"  # meta tensors take the plain path whatever the route

    monkeypatch.setattr(attention, "attention_route", spy)
    for dtype in (torch.bfloat16, torch.float32):
        seen.clear()
        with torch.device("meta"):
            model = build_model(name, dtype=str(dtype).split(".")[-1], device="meta")
        model.eval()
        with torch.no_grad():
            out = model(torch.empty(1, 16, 112, 112, 3, device="meta", dtype=dtype))
        assert tuple(out.shape) == (1, 16, 112, 112, 1)
        assert seen == EVAL_ROUTES[name], dtype
        for (nq, nk, d, c), route in seen.items():
            assert (route == "flash") == fa.forward_viable(nq, nk, d, c, dtype)


def _plan_holds(b, nq, nk, d, c, dtype=torch.bfloat16):
    plan = fa.launch_plan(b, nq, nk, d, c, dtype)
    assert plan["planes"] == fa.PLANES[dtype]
    assert (plan["d_tile"], plan["cw"], plan["planes"]) in fa.INSTANTIATIONS
    assert -(-d // 8) * 8 <= plan["d_tile"]  # d padded to 8 fits the q and k boxes
    rows = fa.WG_ROWS * plan["wgs"]
    gx, gy, gz = plan["grid"]
    assert gx * rows >= nq > (gx - 1) * rows  # every query row, no CTA wholly past nq
    assert gy * plan["cw"] >= c > (gy - 1) * plan["cw"]  # every column of C
    assert gy == plan["slabs"] and gz == b
    assert plan["threads"] == 128 * plan["wgs"] <= 1024
    assert plan["bk"] == fa.key_tile(plan["d_tile"], plan["cw"], dtype) and plan["stages"] >= 2
    assert plan["smem"] <= fa.MAX_CTA_SMEM
    assert plan["resident"] >= 1
    assert plan["resident"] * (plan["smem"] + fa.CTA_SMEM_RESERVE) <= fa.SMEM_PER_SM
    # the tiles the layout holds: Q, and a K and a V tile per stage, each
    # of `planes` bf16 planes, and the alignment slack
    tiles = (plan["wgs"] * fa.WG_ROWS * plan["d_tile"]
             + plan["stages"] * plan["bk"] * (plan["d_tile"] + plan["cw"])) * 2 * plan["planes"]
    assert tiles + fa.SMEM_SLACK < plan["smem"]
    return plan


# (B, Nq, Nk, d, C) of every bf16 site the forward gate takes, at the
# batch the port runs it (16; the zoo's batch 2 for the 'full' head's
# x_0_1_sa, and the zoo's sites at batch 2), -> (d_tile, cw, slabs, bk,
# warpgroups per CTA)
SITE_PLANS = {
    (16,) + X_3_1: (64, 256, 2, 64, 2),       # 128 CTAs: one wave either way
    (16,) + X_2_2: (32, 256, 1, 64, 1),       # 784 CTAs of 64 rows: 3 waves (4 of 128 rows)
    (16,) + X_1_3: (16, 128, 1, 64, 2),       # two CTAs of 256 threads per SM
    (16,) + GN_DECONV3: (64, 256, 2, 64, 1),
    (16,) + GN_DECONV4: (128, 256, 4, 64, 1),
    (2,) + X_0_1_SA: (16, 16, 1, 128, 2),     # the narrow instantiation
    (2,) + X_3_1: (64, 256, 2, 64, 2),
    (2,) + X_2_2: (32, 256, 1, 64, 2),
    (2,) + X_1_3: (16, 128, 1, 64, 2),
    (2,) + GN_DECONV3: (64, 256, 2, 64, 2),
    (2,) + GN_DECONV4: (128, 256, 4, 64, 2),
}


def _shape_id(shape):
    return "x".join(str(n) for n in shape)


@pytest.mark.parametrize("shape", sorted(SITE_PLANS), ids=_shape_id)
def test_launch_plan_at_the_sites(shape):
    b, nq, nk, d, c = shape
    assert fa.forward_viable(nq, nk, d, c, torch.bfloat16)
    plan = _plan_holds(b, nq, nk, d, c)
    assert (plan["d_tile"], plan["cw"], plan["slabs"], plan["bk"], plan["wgs"]) \
        == SITE_PLANS[shape]


def test_the_sites_cover_every_forward_gated_site():
    sites = {s for routes in EVAL_ROUTES.values() for s, r in routes.items() if r == "flash"}
    assert sites == {shape[1:] for shape in SITE_PLANS}


# the plan's edge shapes: Nq below one 64-row tile, Nk below one key tile
# and not a multiple of it, C = 16, 48 and 1024, d = 8, 120 and 128
EDGES = [
    (1, 1, 1, 8, 64),
    (2, 50, 300, 16, 128),      # Nq below one tile
    (1, 300, 30, 32, 256),      # Nk below one key tile (64 at CW = 256)
    (1, 300, 100, 8, 128),      # Nk below one key tile (128)
    (2, 700, 130, 16, 128),     # Nk not a multiple of the key tile
    (2, 700, 300, 2, 16),       # C = 16: the narrow instantiation
    (1, 300, 100, 6, 48),       # C = 48: one 64-column slab, 16 columns past C
    (2, 700, 500, 128, 1024),   # d = 128, C = 1024: four slabs
    (2, 70, 63, 120, 1024),     # d = 120 padded to 128
    (1, 20, 129, 8, 32),
    (2, 130, 70, 24, 192),      # C = 192: one 256-column slab
    (1, 300, 200, 40, 320),     # C = 320: two slabs, the second narrower
    (16, 392, 392, 128, 128),   # d = 128 at CW = 128
    (3, 5000, 3000, 64, 64),
]


@pytest.mark.parametrize("shape", EDGES, ids=_shape_id)
def test_launch_plan_covers_the_edge_shapes(shape):
    b, nq, nk, d, c = shape
    assert fa.forward_viable(max(nq, fa.BLOCK_Q), nk, d, c, torch.bfloat16)
    _plan_holds(b, nq, nk, d, c)


def test_launch_plan_takes_the_wider_cut_on_ties_and_fewer_waves_otherwise():
    # x_2_2 at batch 16: 400 CTAs of 128 rows take 4 waves of 132, 784 of
    # 64 rows 3 waves of 264
    assert fa.launch_plan(16, 3136, 3136, 32, 256)["wgs"] == 1
    # x_1_3: 3136 or 6272 CTAs, 24 waves either way: two warpgroups
    assert fa.launch_plan(16, 25088, 3136, 16, 128)["wgs"] == 2
    # x_0_1_sa: CW = 16 holds two 256-thread CTAs per SM
    plan = fa.launch_plan(2, 200704, 3136, 2, 16)
    assert plan["resident"] == 2 and plan["wgs"] == 2


# (B, Nq, Nk, d, C) -> (d_tile, cw, slabs, bk, warpgroups per CTA, stages)
# in float32: three planes per tile and a second accumulator (each key
# tile's) beside O, so slabs of at most 128 columns, 32-key tiles at
# d = 128, two stages where three do not fit
SITE_PLANS_F32 = {
    (16,) + X_3_1: (64, 128, 4, 64, 2, 2),     # 256 CTAs: 2 waves
    (16,) + X_2_2: (32, 128, 2, 64, 2, 3),     # 800 CTAs: 7 waves (one CTA of 64 rows: 12)
    (16,) + X_1_3: (16, 128, 1, 64, 2, 3),
    (16,) + GN_DECONV3: (64, 128, 4, 64, 2, 2),
    (16,) + GN_DECONV4: (128, 128, 8, 32, 2, 2),
    (2,) + X_0_1_SA: (16, 16, 1, 64, 2, 3),
    (2,) + X_3_1: (64, 128, 4, 64, 2, 2),
    (2,) + X_2_2: (32, 128, 2, 64, 2, 3),
    (2,) + X_1_3: (16, 128, 1, 64, 2, 3),
    (2,) + GN_DECONV3: (64, 128, 4, 64, 2, 2),
    (2,) + GN_DECONV4: (128, 128, 8, 32, 2, 2),
}


@pytest.mark.parametrize("shape", sorted(SITE_PLANS_F32), ids=_shape_id)
def test_launch_plan_at_the_float32_sites(shape):
    b, nq, nk, d, c = shape
    assert fa.forward_viable(nq, nk, d, c, torch.float32)
    plan = _plan_holds(b, nq, nk, d, c, torch.float32)
    # one 256-thread CTA per SM (registers), or two of one warpgroup
    assert plan["resident"] == (1 if plan["wgs"] == 2 else 2)
    assert (plan["d_tile"], plan["cw"], plan["slabs"], plan["bk"], plan["wgs"], plan["stages"]) \
        == SITE_PLANS_F32[shape]


@pytest.mark.parametrize("shape", EDGES, ids=_shape_id)
def test_launch_plan_covers_the_edge_shapes_in_float32(shape):
    b, nq, nk, d, c = shape
    assert fa.forward_viable(max(nq, fa.BLOCK_Q), nk, d, c, torch.float32)
    _plan_holds(b, nq, nk, d, c, torch.float32)


def test_float32_plan_fits_every_gated_shape():
    """Every d and every C (up to 2048) the float32 gate takes has a cut
    whose shared memory, alignment slack included, one CTA may take."""
    for d in range(1, fa.MAX_D + 1):
        for c in range(fa.C_MULTIPLE, 2049, fa.C_MULTIPLE):
            assert fa.forward_viable(fa.BLOCK_Q, 3136, d, c, torch.float32)
            plan = fa.launch_plan(16, 3136, 3136, d, c, torch.float32)
            assert plan["smem"] <= fa.MAX_CTA_SMEM and plan["stages"] >= 2, (d, c)
            assert plan["bk"] == fa.key_tile(plan["d_tile"], plan["cw"], torch.float32)
