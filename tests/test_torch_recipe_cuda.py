"""The custom-op recipe's hand-written kernel
(`paddle_tpu_torch/utils/cpp_extension/recipe/scale_shift.cu`) on the
card: built by the port's `cpp_extension.load`, held bit for bit to its
plain version `x * a + b` in float32 and bfloat16 (the kernel rounds the
multiply and the add separately, as the plain version does), at sizes
that leave a ragged tail and at offsets that are not 16-byte aligned (the
scalar path), with the gradient `g * a` and one launch a call.

Every test is `cuda`-marked and skips without a card. Run them on the
card with `python -m pytest --noconftest -m cuda
tests/test_torch_recipe_cuda.py` (this file does not import JAX; the
repo's conftest does).
"""
import pytest
import torch

from paddle_tpu_torch.utils.cpp_extension import recipe


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    recipe.build(build_directory=str(tmp_path_factory.mktemp("recipe")))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (4099, 0), (4099, 1),
                                      (1 << 20, 0), (1 << 20, 3)])
def test_kernel_equals_plain(card, dtype, n, offset):
    g = torch.Generator(device=card).manual_seed(n + offset)
    base = torch.randn(n + offset, generator=g, device=card).to(dtype)
    x = base[offset:]
    before = recipe.launches
    got = recipe.scale_shift_raw(x, -1.75, 0.3)
    torch.cuda.synchronize()
    assert recipe.launches == before + 1
    want = recipe.scale_shift_plain(x, -1.75, 0.3)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_gradient(card):
    x = torch.randn(257, 129, device=card, requires_grad=True)
    out = recipe.scale_shift_raw(x, 2.5, -1.0)
    (out * out).sum().backward()
    assert torch.equal(x.grad, 2 * out.detach() * 2.5)


@pytest.mark.cuda
def test_kernel_refuses_float16(card):
    before = recipe.launches
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        recipe.scale_shift_raw(torch.ones(8, device=card,
                                          dtype=torch.float16), 1.0, 0.0)
    assert recipe.launches == before
