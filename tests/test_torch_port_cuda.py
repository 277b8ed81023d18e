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
from encdiff_tpu_torch.nn.kernels.attention import (
    attention_core, attention_core_bwd, attention_core_bwd_plain,
    attention_core_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    groupnorm_silu, groupnorm_silu_bwd_plain, gn_silu_bwd)

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


def _heads_view(gen, device, b, length, h, dh):
    """(B, H, L, dh) view of a (B, L, H, dh) buffer: the callers' layout."""
    return torch.randn(b, length, h, dh, generator=gen,
                       device=device).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dh", [
    (128, 8, 256, 256, 8), (128, 8, 256, 20, 8), (128, 8, 64, 64, 16),
    (128, 8, 64, 20, 16), (128, 8, 16, 16, 32), (128, 8, 16, 20, 32),
    (128, 8, 4, 4, 32), (128, 8, 4, 20, 32), (2, 3, 600, 45, 8),
    (2, 3, 33, 700, 16)])
def test_attention_core_bwd_kernel_matches_plain(cuda_device, b, h, n, m, dh):
    gen = torch.Generator(cuda_device).manual_seed(5)
    q = _heads_view(gen, cuda_device, b, n, h, dh)
    k = _heads_view(gen, cuda_device, b, m, h, dh)
    v = _heads_view(gen, cuda_device, b, m, h, dh)
    do = _heads_view(gen, cuda_device, b, n, h, dh)
    before = attention_core_bwd.launches
    grads = attention_core_bwd(q, k, v, do, dh ** -0.5)
    torch.cuda.synchronize()
    assert attention_core_bwd.launches == before + 1
    for got, ref in zip(grads, attention_core_bwd_plain(q, k, v, do,
                                                         dh ** -0.5)):
        torch.testing.assert_close(got, ref, **CARD_TOL)


@pytest.mark.cuda
def test_attention_core_autograd_runs_both_kernels(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(6)
    q, k, v = (_heads_view(gen, cuda_device, 4, 64, 8, 16).requires_grad_()
               for _ in range(3))
    do = torch.randn(4, 8, 64, 16, generator=gen, device=cuda_device)
    fwd, bwd = attention_core.launches, attention_core_bwd.launches
    grads = torch.autograd.grad(attention_core(q, k, v, 0.25), (q, k, v), do)
    torch.cuda.synchronize()
    assert (attention_core.launches, attention_core_bwd.launches) == (
        fwd + 1, bwd + 1)
    ref = torch.autograd.grad(attention_core_plain(q, k, v, 0.25), (q, k, v),
                              do)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,film", [
    ((128, 64, 16, 16), 1e-5, True), ((128, 512, 2, 2), 1e-5, True),
    ((128, 1024, 2, 2), 1e-5, True), ((128, 192, 16, 16), 1e-5, True),
    ((3, 96, 5, 7), 1e-6, False)])
def test_gn_silu_bwd_kernel_matches_plain(cuda_device, shape, eps, film):
    gen = torch.Generator(cuda_device).manual_seed(7)
    args = _gn_inputs(gen, cuda_device, *shape, film)
    g = torch.randn(shape, generator=gen, device=cuda_device)
    before = gn_silu_bwd.launches
    grads = gn_silu_bwd(g, *args, eps=eps)
    torch.cuda.synchronize()
    assert gn_silu_bwd.launches == before + 1
    ref = groupnorm_silu_bwd_plain(g, *args, eps=eps)
    for got, want in zip(grads, ref):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
def test_groupnorm_silu_autograd_runs_both_kernels(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(8)
    args = [t.requires_grad_() for t in
            _gn_inputs(gen, cuda_device, 4, 128, 8, 8, True)]
    g = torch.randn(4, 128, 8, 8, generator=gen, device=cuda_device)
    fwd, bwd = groupnorm_silu.launches, gn_silu_bwd.launches
    grads = torch.autograd.grad(groupnorm_silu(*args), args, g)
    torch.cuda.synchronize()
    assert (groupnorm_silu.launches, gn_silu_bwd.launches) == (fwd + 1,
                                                               bwd + 1)
    with plain_path():
        ref = torch.autograd.grad(groupnorm_silu(*args), args, g)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, **CARD_TOL)
