"""The backward kernels' gate, query split and build, on the CPU.

* Every registry name at full width ([1, 16, 112, 112, 3], built on the
  meta device, so nothing is computed): the route of every self-attention
  site in train mode, in bf16 and float32, held to the routes the port
  gives today (``attention_route``; ``SAP3D_FLASH_HYBRID`` unset).  Each
  site the backward gate takes reaches kernel B3 (B4 in a ring hop); the
  gate's limits (d <= 128 and C <= 1024, in both dtypes) refuse none of
  them, the GN decoders' C = 1024 site (d = 128) included.
* ``query_split`` and ``resident_ctas`` at the sites the kernel is timed
  at, in bf16 and in float32, and the rule's own bounds; in both dtypes the
  dkdq and dv kernels' shared memory, and the forward plan's, fits one CTA
  at every (d, C) the gate takes.
* ``build._library_path`` hashes the shared headers (``csrc/*.cuh``) and the
  flags beside the source: editing a header names a new library.
"""

import pytest
import torch

from sap3d_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from sap3d_tpu_torch.ops import attention
from sap3d_tpu_torch.ops.cuda import build
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

X_4_0, X_3_1, X_2_2, X_1_3 = ((49, 49, 128, 1024), (392, 392, 64, 512),
                              (3136, 3136, 32, 256), (25088, 3136, 16, 128))
X_0_1_SA = (200704, 3136, 2, 16)
GN_POOL2, GN_DECONV3, GN_DECONV4 = ((3136, 3136, 32, 256), (3136, 3136, 64, 512),
                                    (3136, 3136, 128, 1024))
# (Nq, Nk, d, C) -> route of each name's sites in train mode, as the port
# routes them
ROUTES = {
    "p3d_unet": {},
    "p3d_concat": {},
    "p3d_unetplusplus": {X_4_0: "plain", X_3_1: "flash", X_2_2: "flash", X_1_3: "flash",
                         X_0_1_SA: "flash"},
    "p3d_unetplusplus_ds": {X_4_0: "plain", X_3_1: "flash", X_2_2: "flash", X_1_3: "flash"},
    "p3d_unetplusplus_nonsa": {},
    "p3d_unetplusplus_nl": {X_4_0: "plain", X_3_1: "flash", X_2_2: "flash"},
    "inference_p3d": {},
    "inference_p3d_concat": {},
    "inference_p3d_sa_concat": {X_4_0: "plain", X_3_1: "flash", X_2_2: "flash"},
    "inference_p3d_sa_concat_2": {GN_POOL2: "flash", GN_DECONV3: "flash"},
    "inference_p3d_sa_decoder_block": {GN_POOL2: "flash", GN_DECONV3: "flash",
                                       GN_DECONV4: "flash"},
    "inference_p3d_decoder_block": {},
    "p3d_micro": {},
    "p3d_micro_sa": {(49, 49, 16, 128): "plain", X_3_1: "flash", X_2_2: "flash",
                     X_1_3: "flash"},
}


def test_the_table_names_every_registry_name():
    assert set(ROUTES) == set(MODEL_REGISTRY) and len(ROUTES) == 14


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_backward_gated_sites_keep_their_routes(name, monkeypatch):
    monkeypatch.delenv("SAP3D_FLASH_HYBRID", raising=False)
    orig, seen = attention.attention_route, {}

    def spy(nq, nk, d, c, dtype, train):
        route = orig(nq, nk, d, c, dtype, train)
        seen[(nq, nk, d, c)] = route
        return "plain"  # meta tensors take the plain path whatever the route

    monkeypatch.setattr(attention, "attention_route", spy)
    for dtype in ("bfloat16", "float32"):
        seen.clear()
        with torch.device("meta"):
            model = build_model(name, dtype=dtype, device="meta")
        model.train()
        out = model(torch.empty(1, 16, 112, 112, 3, device="meta", dtype=getattr(torch, dtype)))
        assert tuple(out.shape) == (1, 16, 112, 112, 1)
        assert seen == ROUTES[name], dtype
        for (nq, nk, d, c), route in seen.items():
            assert (route == "flash") == fb.backward_viable(nq, nk, d, c, getattr(torch, dtype))


def test_gate_states_the_bf16_limit_on_d():
    # the limits are the same in float32, where the streaming kernel at d
    # above 64 keeps one q stage and stages dq over the ds^T region
    assert fb.BACKWARD_MAX_D == 128 and fb.MAX_C == 1024
    assert fb.backward_max_d(torch.bfloat16) == 128 and fb.backward_max_d(torch.float32) == 128
    for dtype in (torch.bfloat16, torch.float32):
        assert fb.backward_viable(3136, 3136, 64, 512, dtype)
        assert fb.backward_viable(3136, 3136, 72, 512, dtype)     # d above 64
        assert fb.backward_viable(3136, 3136, 128, 128, dtype)
        assert fb.backward_viable(3136, 3136, 128, 1024, dtype)   # GN deconv_pool4
        assert not fb.backward_viable(3136, 3136, 136, 1024, dtype)  # d above 128
        assert not fb.backward_viable(3136, 3136, 128, 1088, dtype)  # C above 1024
        assert not fb.backward_viable(3136, 3136, 128, 592, dtype)   # not a multiple of 64
    # the bf16 dk and dq kernel keeps V resident up to d = 64 and C = 512
    assert not fb.dkdq_streams(64, 512, torch.bfloat16)
    assert fb.dkdq_streams(72, 512, torch.bfloat16) and fb.dkdq_streams(64, 576, torch.bfloat16)
    assert fb.dkdq_streams(16, 16, torch.float32)


# (B, Nq, Nk, d, C) -> (resident dkdq CTAs per SM, query split S)
SPLITS = {
    (16,) + X_3_1: (1, 1),       # 112 CTAs, one wave: splitting only reloads K and V
    (16,) + X_2_2: (2, 1),       # 784 CTAs, 2.97 waves of 264
    (16,) + X_1_3: (3, 1),       # 784 CTAs, 1.98 waves of 396
    (16,) + GN_POOL2: (2, 1),
    (16,) + GN_DECONV3: (1, 1),  # 224 KB of shared memory: one CTA per SM
    (16,) + GN_DECONV4: (1, 1),  # the streaming kernel, 155 KB: 784 CTAs, 5.94 waves
    (2,) + X_0_1_SA: (4, 16),    # 98 CTAs: 16 ranges make 3 waves of 528
    (1, 5000, 150, 2, 16): (4, 16),
    (2, 2000, 100, 8, 64): (3, 16),
    (2, 300, 130, 64, 512): (1, 5),
    (1, 200, 100, 8, 32): (4, 4),
}


@pytest.mark.parametrize("shape", sorted(SPLITS))
def test_query_split_at_the_sites(shape):
    b, nq, nk, d, c = shape
    resident, split = SPLITS[shape]
    assert fb.resident_ctas(d, c) == resident
    assert fb.query_split(b, nq, nk, d, c) == split
    assert 1 <= split <= min(-(-nq // fb.BLOCK), fb.MAX_SPLIT)


# float32: (B, Nq, Nk, d, C) -> (resident dkdq CTAs per SM, query split S,
# chunk stages of V and do); one 128-thread CTA per SM at 64-column chunks
# (two where the chunks are 16 columns)
SPLITS_F32 = {
    (16,) + X_3_1: (1, 1, 2),       # 112 CTAs, one wave
    (16,) + X_2_2: (1, 1, 3),       # 784 CTAs, 5.94 waves of 132
    (16,) + X_1_3: (1, 1, 3),
    (16,) + GN_DECONV3: (1, 1, 2),
    (16,) + GN_DECONV4: (1, 1, 2),  # one q stage, dq staged over ds^T: 226 KB
    (2,) + X_0_1_SA: (2, 8, 4),     # 98 CTAs: 8 ranges make 3 waves of 264
    (1, 5000, 150, 2, 16): (2, 16, 4),
    (2, 2000, 100, 8, 64): (1, 16, 3),
    (2, 300, 130, 64, 512): (1, 5, 2),
    (1, 200, 100, 8, 32): (2, 4, 4),
}


@pytest.mark.parametrize("shape", sorted(SPLITS_F32))
def test_query_split_at_the_sites_in_float32(shape):
    b, nq, nk, d, c = shape
    resident, split, stages = SPLITS_F32[shape]
    assert fb.resident_ctas(d, c, torch.float32) == resident
    assert fb.query_split(b, nq, nk, d, c, torch.float32) == split
    assert fb.split_chunk_stages(d, c) == stages
    grid = fb.launch_grid(b, nq, nk, d, c, torch.float32)
    assert grid["split"] == split and grid["dv_ctas"] > 0  # dv is never the dkdq kernel's


def test_float32_kernels_fit_every_gated_shape():
    """The float32 dkdq and dv kernels' shared memory, with its 1 KB of
    alignment, fits one CTA at every (d, C) the backward gate takes (d up
    to 128, C up to 1024)."""
    cs = [c for c in range(16, fb.MAX_C + 1, 16) if fb.backward_c_ok(c)]
    assert max(cs) == 1024
    for d in range(1, fb.BACKWARD_MAX_D + 1):
        for c in cs:
            assert fb.backward_viable(3136, 3136, d, c, torch.float32)
            assert fb.dkdq_smem_bytes(d, c, torch.float32) <= fa.MAX_CTA_SMEM, (d, c)
            assert fb.dv_smem_bytes(d, c, torch.float32) <= fa.MAX_CTA_SMEM, (d, c)
            assert c % fb.dv_slab(c, torch.float32, d) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "float32"])
def test_backward_and_forward_plans_fit_every_gated_shape(dtype):
    """At every (d, C) the backward gate takes (d <= 128, C <= 1024): the
    dkdq kernel (resident or streaming) and the dv kernel fit one CTA, the
    streaming layout keeps at least two chunk stages, and the forward's
    plan (B2, and B1 in B5 and B6) fits and covers C."""
    cs = [c for c in range(16, fb.MAX_C + 1, 16) if fb.backward_c_ok(c)]
    for d in (8, 16, 24, 32, 40, 64, 72, 96, 128):
        for c in cs:
            assert fb.backward_viable(3136, 3136, d, c, dtype)
            assert fb.dkdq_smem_bytes(d, c, dtype) <= fa.MAX_CTA_SMEM, (d, c)
            assert fb.dv_smem_bytes(d, c, dtype) <= fa.MAX_CTA_SMEM, (d, c)
            if fb.dkdq_streams(d, c, dtype):
                assert fb.split_chunk_stages(d, c, dtype) >= 2
            assert fb.resident_ctas(d, c, dtype) >= 1
            plan = fa.launch_plan(16, 3136, 3136, d, c, dtype)
            assert plan["smem"] <= fa.MAX_CTA_SMEM and plan["slabs"] * plan["cw"] >= c


def test_query_split_never_exceeds_the_query_tiles():
    for nq in (1, 63, 64, 65, 200):
        assert fb.query_split(1, nq, 64, 16, 16) <= -(-nq // fb.BLOCK)
    assert fb.query_split(1, 1, 1, 8, 64) == 1


def test_library_path_hashes_headers_and_flags(tmp_path, monkeypatch):
    """No nvcc needed: the path is a hash of what would be compiled."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    first = build._library_path("k")[1]
    assert build._library_path("k")[1] == first  # unchanged: the same library
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = build._library_path("k")[1]
    assert edited != first
    (tmp_path / "other.cuh").write_text("// new\n")
    added = build._library_path("k")[1]
    assert added not in (first, edited)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._library_path("k")[1] not in (first, edited, added)
