"""The port's CUDA kernels on the card (marker ``cuda``).

Each test skips on a host without a GPU.  This file imports nothing of JAX,
so it also runs on the GPU host, which has no JAX; there the repo's
conftest (which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel is held to its plain version under ``flash_attention.TOLERANCE``
(per element and on the mean, scaled to the output; ``agreement`` says
why), as chip_smoke.py holds it.
"""

import numpy as np
import pytest
import torch

from sap3d_tpu_torch.ops.attention import SelfAttention3D
from sap3d_tpu_torch.ops.cuda.flash_attention import (
    agreement,
    flash_attend_tokens,
    flash_attend_tokens_reference,
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
    (1, 392, 392, 64, 512),  # x_3_1 proportions
    (1, 700, 500, 32, 256),  # x_2_2 proportions
    (2, 1000, 300, 16, 128), # x_1_3 proportions
    (1, 1, 1, 8, 64),        # one query, one key
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
    q, k, v = _inputs(1, 8, 8, 8, 48, torch.float32)  # C not a multiple of 64
    with pytest.raises(ValueError):
        flash_attend_tokens(q, k, v)
    q, k, v = _inputs(1, 8, 8, 8, 64, torch.float16)
    with pytest.raises(TypeError):
        flash_attend_tokens(q, k, v)
    q, k, v = _inputs(1, 8, 8, 12, 64, torch.bfloat16)  # bf16 needs d % 8 == 0
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
