"""The kernel wrappers refuse the head dims their kernels are not built
for, naming the head dim, before the library is touched and with no plain
fallback on the launch path.

The paged kernel takes head dims 32, 64 and 128; the flash kernels 64,
128 and 256 in float32, bfloat16 and float16. On the CPU the launch path
is reached through `paged_attention._launch` and
`flash_attention._check_kernel_args` (a CPU tensor handed to the public
wrappers takes the plain version). The `cuda`-marked tests make the same
calls with CUDA tensors on the card (skipped without CUDA; run there with
`python -m pytest --noconftest -m cuda tests/test_torch_kernel_guards.py`;
this file does not import JAX).
"""
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

H = 2


def _paged_operands(d, device="cpu"):
    q = torch.ones((1, 1, H, d), device=device)
    pool = torch.ones((3, 8, H, d), device=device)
    tables = torch.ones((1, 2), dtype=torch.int32, device=device)
    pos = torch.zeros((1,), dtype=torch.int32, device=device)
    return q, pool, tables, pos


def test_supported_head_dims_and_dtypes():
    assert pa.SUPPORTED_HEAD_DIMS == (32, 64, 128)
    assert fa.SUPPORTED_HEAD_DIMS == (64, 128, 256)
    assert set(fa._DTYPES) == {torch.float32, torch.bfloat16, torch.float16}


@pytest.mark.parametrize("d", [16, 48, 96, 256])
def test_paged_launch_refuses_other_head_dims(d):
    q, pool, tables, pos = _paged_operands(d)
    before = pa.launch_counts()
    with pytest.raises(ValueError, match=f"head_dim {d} not in"):
        pa._launch(q, pool, pool, tables, pos, d ** -0.5, None, None, 127.0,
                   False, [q, pool, pool, tables, pos])
    assert pa.launch_counts() == before


@pytest.mark.parametrize("d", [16, 32, 96, 512])
def test_flash_launch_refuses_other_head_dims(d):
    t = torch.zeros((1, 128, d), dtype=torch.float16)
    with pytest.raises(ValueError, match=f"head_dim {d} is not built"):
        fa._check_kernel_args("fwd", t, t, t, None, ())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 256])
def test_cuda_paged_wrapper_refuses_other_head_dims(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, pool, tables, pos = _paged_operands(d, "cuda")
    before = pa.launch_counts()
    with pytest.raises(ValueError, match=f"head_dim {d} not in"):
        pa.paged_attention(q, pool, pool, tables, pos)
    assert pa.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 512])
def test_cuda_flash_wrapper_refuses_other_head_dims(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros((1, 2, 128, d), dtype=torch.float16, device="cuda")
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    with pytest.raises(ValueError, match=f"head_dim {d} is not built"):
        fa.flash_attention_bhsd(q, q, q, causal=True)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
