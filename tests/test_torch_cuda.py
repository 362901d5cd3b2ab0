"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; every test skips on a machine without a CUDA card. This
file imports no JAX, so it runs where the port runs:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(S, H, KVH, D, bs, max_len, dtype, seed, device):
    rng = np.random.default_rng(seed)
    mb = -(-max_len // bs)
    lengths = rng.integers(1, max_len + 1, size=S).astype(np.int32)
    lengths[S // 2] = 0
    n_blocks = S * mb + 5
    tables = rng.permutation(n_blocks)[: S * mb].reshape(S, mb).astype(np.int32)
    k = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    v = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    q = rng.standard_normal((S, H, D), dtype=np.float32)
    to = lambda a, dt=dtype: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return to(q), to(k), to(v), to(tables, torch.int32), to(lengths, torch.int32)


@pytest.mark.parametrize("S,H,KVH,D,bs,max_len", [
    (8, 32, 8, 128, 16, 512),  # llama3-8b heads
    (32, 32, 8, 128, 16, 128),  # many lanes
    (4, 32, 8, 64, 16, 300),  # llama3.2-1b heads
    (4, 4, 2, 16, 8, 70),  # tiny preset heads
    (2, 20, 2, 256, 16, 64),  # 10 query heads per kv head (two head groups), D=256
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, S, H, KVH, D, bs, max_len, dtype):
    args = _case(S, H, KVH, D, bs, max_len, dtype, 0, cuda)
    before = paged_decode_attention.launches
    o, m, l = paged_decode_attention(*args, return_stats=True)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    po, pm, pl = paged_decode_attention_plain(*args, return_stats=True)
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
        torch.testing.assert_close(m, pm, atol=1e-5, rtol=0)
        torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(m, pm, atol=0, rtol=1e-3)
        torch.testing.assert_close(l, pl, atol=0, rtol=1e-3)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, t, n = _case(2, 4, 2, 16, 8, 16, torch.float32, 1, cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(q.half(), k.half(), v.half(), t, n)
    with pytest.raises(ValueError):
        paged_decode_attention(q, k, v, t.long(), n)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :, :8].contiguous(), k[..., :8].contiguous(),
                               v[..., :8].contiguous(), t, n)  # D=8 has no kernel
