"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the repo's conftest, so that they run on
a machine with a CUDA device and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA device they skip. Tolerance 1e-4 (relative and absolute, on
outputs of order one): the kernels and the plain versions take their fp32
sums in different orders.
"""

import pytest
import torch

from encdiff_tpu_torch.nn.kernels import plain_path
from encdiff_tpu_torch.nn.kernels.attention import (attention_core,
                                                    attention_core_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import groupnorm_silu

CARD_TOL = dict(rtol=1e-4, atol=1e-4)


def _gn_inputs(gen, device, b, c, h, w, film):
    x = torch.randn(b, c, h, w, generator=gen, device=device) * 2.0 + 0.5
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    beta = 0.2 * torch.randn(c, generator=gen, device=device)
    scale = 0.2 * torch.randn(b, c, generator=gen, device=device) if film else None
    shift = 0.2 * torch.randn(b, c, generator=gen, device=device) if film else None
    return x, gamma, beta, scale, shift


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,film", [
    ((160, 64, 16, 16), 1e-5, True), ((160, 512, 2, 2), 1e-5, False),
    ((160, 64, 64, 64), 1e-6, False), ((3, 96, 5, 7), 1e-5, True)])
def test_groupnorm_silu_kernel_matches_plain(cuda_device, shape, eps, film):
    gen = torch.Generator(cuda_device).manual_seed(3)
    args = _gn_inputs(gen, cuda_device, *shape, film)
    before = groupnorm_silu.launches
    out = groupnorm_silu(*args, eps=eps)
    torch.cuda.synchronize()
    assert groupnorm_silu.launches == before + 1
    with plain_path():
        ref = groupnorm_silu(*args, eps=eps)
    torch.testing.assert_close(out, ref, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dh", [
    (160, 8, 256, 256, 8), (160, 8, 256, 20, 8), (160, 8, 64, 20, 16),
    (160, 8, 4, 4, 32), (160, 1, 256, 256, 128), (2, 3, 33, 45, 64)])
def test_attention_core_kernel_matches_plain(cuda_device, b, h, n, m, dh):
    gen = torch.Generator(cuda_device).manual_seed(4)
    q = torch.randn(b, h, n, dh, generator=gen, device=cuda_device)
    k = torch.randn(b, h, m, dh, generator=gen, device=cuda_device)
    v = torch.randn(b, h, m, dh, generator=gen, device=cuda_device)
    before = attention_core.launches
    out = attention_core(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    torch.testing.assert_close(out, attention_core_plain(q, k, v, dh ** -0.5),
                               **CARD_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(2, 64, 4, 4, device=cuda_device)
    g = torch.ones(64, device=cuda_device)
    with pytest.raises(ValueError):
        groupnorm_silu(x.transpose(2, 3), g, g)
    with pytest.raises(ValueError):
        groupnorm_silu(x.double(), g.double(), g.double())
    q = torch.zeros(2, 2, 8, 24, device=cuda_device)
    with pytest.raises(ValueError):
        attention_core(q, q, q, 0.2)
