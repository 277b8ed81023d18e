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
    attention_core_bwd_vjp, attention_core_plain)
from encdiff_tpu_torch.nn.kernels.flash_attention import (
    flash_attention, flash_attention_dkdv, flash_attention_dkdv_plain,
    flash_attention_dq, flash_attention_dq_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from encdiff_tpu_torch.nn.kernels.fused_attention import (
    fused_attention, fused_attention_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    gn_silu_bwd3, gn_silu_bwd3_plan, gn_silu_bwd_bwd, gn_silu_bwd_bwd_plan,
    gn_silu_bwd_plan, gn_silu_plan, groupnorm_silu,
    groupnorm_silu_bwd3_plain, groupnorm_silu_bwd_bwd_plain,
    groupnorm_silu_bwd_plain, groupnorm_silu_plain, gn_silu_bwd, kernel_plan)

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


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("n", [4, 16, 64, 256])
@pytest.mark.parametrize("m", [4, 16, 20, 64, 256])
def test_attention_core_tensor_core_forward_at_every_length(cuda_device, m, n,
                                                           dh):
    """The 3xTF32 forward at every query and key length the serving and
    train paths run and every head size, on (B, N, H, dh)-backed views:
    slices packed a block (N 4, 16), ragged key tiles (M 4, 20) and the
    K/V ring (M 256)."""
    gen = torch.Generator(cuda_device).manual_seed(13)
    q = _heads_view(gen, cuda_device, 3, n, 2, dh)
    k = _heads_view(gen, cuda_device, 3, m, 2, dh)
    v = _heads_view(gen, cuda_device, 3, m, 2, dh)
    before = attention_core.launches
    out = attention_core(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    torch.testing.assert_close(out, attention_core_plain(q, k, v, dh ** -0.5),
                               **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dh", [
    (4, 1, 256, 256, 128), (4, 8, 64, 64, 32), (4, 8, 256, 20, 8),
    (8, 8, 4, 4, 32)])
def test_attention_core_holds_logits_of_30(cuda_device, b, h, n, m, dh):
    """q and k scaled so that the scaled scores reach ±30: one tf32 pass
    would put errors of order 1e-3 into the output; the 3xTF32 split must
    stay within CARD_TOL of the fp32 plain version."""
    gen = torch.Generator(cuda_device).manual_seed(14)
    q = _heads_view(gen, cuda_device, b, n, h, dh) * 3.0
    k = _heads_view(gen, cuda_device, b, m, h, dh) * 3.0
    v = _heads_view(gen, cuda_device, b, m, h, dh)
    scale = dh ** -0.5
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    assert logits.abs().max().item() >= 25.0
    out = attention_core(q, k, v, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_core_plain(q, k, v, scale),
                               **CARD_TOL)


@pytest.mark.cuda
def test_attention_core_takes_more_than_65535_slices(cuda_device):
    """B * H = 70,000 at N = M = 4: the forward puts the slices on
    gridDim.x (the backward too: test_attention_core_bwd_takes_more_than_65535_slices)."""
    gen = torch.Generator(cuda_device).manual_seed(15)
    q, k, v = (_heads_view(gen, cuda_device, 8750, 4, 8, 32)
               for _ in range(3))
    out = attention_core(q, k, v, 32 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_core_plain(q, k, v, 32 ** -0.5),
                               **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dh", [(64, 64, 32), (256, 20, 8), (16, 16, 128)])
def test_attention_core_rows_off_16_bytes(cuda_device, n, m, dh):
    """q, k and v whose rows do not start on 16 bytes (a view one float into
    its buffer) take the kernel's 4-byte copies, with the same result."""
    gen = torch.Generator(cuda_device).manual_seed(16)

    def shifted(length):
        flat = torch.randn(2 * length * 3 * dh + 1, generator=gen,
                           device=cuda_device)
        return flat[1:].view(2, length, 3, dh).transpose(1, 2)
    q, k, v = shifted(n), shifted(m), shifted(m)
    assert q.data_ptr() % 16 != 0
    before = attention_core.launches
    out = attention_core(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    torch.testing.assert_close(out, attention_core_plain(q, k, v, dh ** -0.5),
                               **CARD_TOL)


def _optin(device):
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,film,cluster", [
    ((2, 32, 256, 256), 1e-6, False, 2),    # a 256 KB group: a cluster of 2
    ((2, 32, 256, 256), 1e-5, True, 2),
    ((1, 32, 512, 512), 1e-6, True, 8),     # a 1 MB group: a cluster of 8
    ((2, 64, 128, 128), 1e-6, False, 1),    # 128 KB: one block
    ((160, 64, 16, 16), 1e-5, True, 1),     # 2 KB: 8 groups a block
    ((160, 64, 16, 16), 1e-6, False, 1),
    ((160, 256, 2, 2), 1e-5, True, 1),      # 128 bytes
    ((3, 96, 5, 7), 1e-5, False, 1),        # cg * HW = 105: 4-byte copies
    ((2, 128, 3, 3), 1e-6, True, 1),        # float4s across channels
    ((70000, 32, 2, 2), 1e-5, True, 1)])    # B above 65,535
def test_groupnorm_silu_forward_paths(cuda_device, shape, eps, film, cluster):
    b, c, h, w = shape
    assert gn_silu_plan(b, c, h * w, 32, _optin(cuda_device)).cluster == cluster
    gen = torch.Generator(cuda_device).manual_seed(17)
    args = _gn_inputs(gen, cuda_device, *shape, film)
    before = groupnorm_silu.launches
    out = groupnorm_silu(*args, eps=eps)
    torch.cuda.synchronize()
    assert groupnorm_silu.launches == before + 1
    torch.testing.assert_close(out, groupnorm_silu_plain(*args, eps=eps),
                               **CARD_TOL)


@pytest.mark.cuda
def test_groupnorm_silu_input_off_16_bytes(cuda_device):
    """x one float into its buffer takes the 4-byte copies."""
    gen = torch.Generator(cuda_device).manual_seed(18)
    _, gamma, beta, scale, shift = _gn_inputs(gen, cuda_device, 2, 64, 16, 16,
                                              True)
    x = torch.randn(2 * 64 * 16 * 16 + 1, generator=gen,
                    device=cuda_device)[1:].view(2, 64, 16, 16)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    out = groupnorm_silu(x, gamma, beta, scale, shift)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, groupnorm_silu_plain(x, gamma, beta, scale, shift), **CARD_TOL)


@pytest.mark.cuda
def test_gn_silu_plan_is_the_kernel_plan(cuda_device):
    """The Python copy of the forward's plan gives what the CUDA source
    computes, at the configured shapes' (C, H * W) and at the test shapes,
    for this card's shared memory and for a smaller limit."""
    shapes = {(c, hw) for c in (32, 64, 96, 128, 192, 256, 384, 512)
              for hw in (4, 9, 16, 35, 64, 256, 1024, 4096, 16384, 65536)}
    shapes.add((32, 262144))
    for limit in (_optin(cuda_device), 48 * 1024):
        for c, hw in sorted(shapes):
            try:
                want = tuple(gn_silu_plan(1, c, hw, 32, limit))[:5]
            except ValueError:
                want = None
            assert kernel_plan(c, hw, 32, limit) == want, (c, hw, limit)


def _heads_view(gen, device, b, length, h, dh):
    """(B, H, L, dh) view of a (B, L, H, dh) buffer: the callers' layout."""
    return torch.randn(b, length, h, dh, generator=gen,
                       device=device).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dh", [
    (128, 8, 256, 256, 8), (128, 8, 256, 20, 8), (128, 8, 64, 64, 16),
    (128, 8, 64, 20, 16), (128, 8, 16, 16, 32), (128, 8, 16, 20, 32),
    (128, 8, 4, 4, 32), (128, 8, 4, 20, 32), (2, 3, 600, 45, 8),
    (2, 3, 33, 700, 16),
    # the faces micro-step's: M = 20 with N = 4,096 splits dk/dv's query
    # rows over blocks
    (8, 8, 4096, 20, 8), (8, 8, 1024, 20, 16), (8, 8, 256, 256, 32),
    (8, 8, 256, 20, 32), (8, 8, 64, 64, 32), (8, 8, 64, 20, 32),
    # dh 64 and 128 (the VQ mid block's one head of 128 at N = M = 256)
    (4, 2, 256, 256, 64), (3, 2, 37, 53, 64), (16, 1, 256, 256, 128),
    (2, 2, 70, 23, 128), (2, 1, 5, 300, 128)])
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
@pytest.mark.parametrize("b,h,n,m,dh", [
    (4, 8, 256, 256, 8), (4, 8, 256, 20, 8), (4, 8, 64, 64, 16),
    (4, 8, 4096, 20, 8), (4, 2, 256, 256, 64), (4, 1, 256, 256, 128)])
def test_attention_core_bwd_holds_logits_of_30(cuda_device, b, h, n, m, dh):
    """q and k scaled so that the scaled scores reach ±30: the 3xTF32 split
    and the per-tile partial sums must hold CARD_TOL against the fp32 plain
    version."""
    gen = torch.Generator(cuda_device).manual_seed(21)
    q = _heads_view(gen, cuda_device, b, n, h, dh) * 3.0
    k = _heads_view(gen, cuda_device, b, m, h, dh) * 3.0
    v = _heads_view(gen, cuda_device, b, m, h, dh)
    do = _heads_view(gen, cuda_device, b, n, h, dh)
    scale = dh ** -0.5
    logits = torch.matmul(q[:1, :1] * scale, k[:1, :1].transpose(-1, -2))
    assert logits.abs().max().item() >= 25.0
    grads = attention_core_bwd(q, k, v, do, scale)
    torch.cuda.synchronize()
    for got, ref in zip(grads, attention_core_bwd_plain(q, k, v, do, scale)):
        torch.testing.assert_close(got, ref, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dh", [
    (8, 8, 4096, 20, 8), (128, 8, 256, 256, 8), (2, 1, 256, 256, 128)])
def test_attention_core_bwd_repeats_bit_for_bit(cuda_device, b, h, n, m, dh):
    """No atomics: two identical calls give identical bits, also where the
    dk/dv query rows split over blocks (M = 20, N = 4,096)."""
    gen = torch.Generator(cuda_device).manual_seed(22)
    q, do = (_heads_view(gen, cuda_device, b, n, h, dh) for _ in range(2))
    k, v = (_heads_view(gen, cuda_device, b, m, h, dh) for _ in range(2))
    first = attention_core_bwd(q, k, v, do, dh ** -0.5)
    second = attention_core_bwd(q, k, v, do, dh ** -0.5)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_attention_core_bwd_refuses_rows_off_16_bytes(cuda_device):
    """The backward copies rows 16 bytes at a time: a q, k, v or do whose
    rows do not start on 16 bytes is refused, not quietly copied."""
    q = torch.zeros(1, 2, 64, 16, device=cuda_device)
    shifted = torch.zeros(2 * 64 * 16 + 1,
                          device=cuda_device)[1:].view(1, 2, 64, 16)
    for args in ((shifted, q, q, q), (q, shifted, q, q), (q, q, shifted, q),
                 (q, q, q, shifted)):
        with pytest.raises(ValueError, match="16 bytes"):
            attention_core_bwd(*args, 0.25)


@pytest.mark.cuda
def test_attention_core_bwd_takes_more_than_65535_slices(cuda_device):
    """B * H = 70,000 at N = M = 4: both backward launches put B * H on
    gridDim.x."""
    gen = torch.Generator(cuda_device).manual_seed(19)
    q, k, v, do = (_heads_view(gen, cuda_device, 8750, 4, 8, 32)
                   for _ in range(4))
    grads = attention_core_bwd(q, k, v, do, 32 ** -0.5)
    torch.cuda.synchronize()
    for got, ref in zip(grads, attention_core_bwd_plain(q, k, v, do,
                                                         32 ** -0.5)):
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
    ((3, 96, 5, 7), 1e-6, False),
    ((70000, 32, 2, 2), 1e-5, True),     # B above 65,535: B on gridDim.x
    # faces-sized groups: 32 KB to 192 KB of x + g in one block, 6 channels
    # a group
    ((8, 64, 64, 64), 1e-5, True), ((8, 128, 64, 64), 1e-5, False),
    ((8, 192, 64, 64), 1e-5, True), ((8, 512, 8, 8), 1e-6, False),
    # more than 8 channels a group: two register passes
    ((2, 320, 4, 4), 1e-5, True)])
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
@pytest.mark.parametrize("shape,eps,film,cluster", [
    ((32, 32, 256, 256), 1e-6, False, 8),   # the VQ decoder's 256x256 level
    ((2, 384, 32, 32), 1e-5, True, 1),      # 96 KB of x + g: one block
    ((2, 32, 128, 128), 1e-6, True, 2),     # 128 KB: two blocks of 64 KB
    ((2, 64, 128, 128), 1e-6, False, 4),    # 256 KB: a cluster of 4
    ((2, 64, 256, 256), 1e-6, False, 8),    # 1 MB: 8 blocks of 128 KB
    ((1, 32, 256, 512), 1e-6, True, 8)])
def test_gn_silu_bwd_on_clusters(cuda_device, shape, eps, film, cluster):
    """Groups whose x + g exceed half an SM's shared memory split over a
    thread-block cluster, the blocks' sums exchanged in rank order."""
    b, c, h, w = shape
    assert gn_silu_bwd_plan(b, c, h * w, 32, _optin(cuda_device)).cluster == (
        cluster)
    gen = torch.Generator(cuda_device).manual_seed(23)
    args = _gn_inputs(gen, cuda_device, *shape, film)
    g = torch.randn(shape, generator=gen, device=cuda_device)
    grads = gn_silu_bwd(g, *args, eps=eps)
    torch.cuda.synchronize()
    ref = groupnorm_silu_bwd_plain(g, *args, eps=eps)
    for got, want in zip(grads, ref):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, **CARD_TOL)
    assert torch.equal(grads[0], gn_silu_bwd(g, *args, eps=eps)[0])


@pytest.mark.cuda
def test_gn_silu_bwd_inputs_off_16_bytes(cuda_device):
    """x and g one float into their buffers take the 4-byte copies."""
    gen = torch.Generator(cuda_device).manual_seed(24)
    _, gamma, beta, scale, shift = _gn_inputs(gen, cuda_device, 2, 64, 16, 16,
                                              True)
    x, g = (torch.randn(2 * 64 * 16 * 16 + 1, generator=gen,
                        device=cuda_device)[1:].view(2, 64, 16, 16)
            for _ in range(2))
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    grads = gn_silu_bwd(g, x, gamma, beta, scale, shift)
    torch.cuda.synchronize()
    for got, want in zip(grads, groupnorm_silu_bwd_plain(g, x, gamma, beta,
                                                         scale, shift)):
        torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
def test_gn_silu_bwd_plan_is_the_kernel_plan(cuda_device):
    """The Python copy of the backward's plan gives what the CUDA source
    computes, at the shapes of test_gn_silu_plan_is_the_kernel_plan."""
    shapes = {(c, hw) for c in (32, 64, 96, 128, 192, 256, 384, 512)
              for hw in (4, 9, 16, 35, 64, 256, 1024, 4096, 16384, 65536)}
    shapes.add((32, 262144))
    for limit in (_optin(cuda_device), 48 * 1024):
        for c, hw in sorted(shapes):
            try:
                want = tuple(gn_silu_bwd_plan(1, c, hw, 32, limit))[:5]
            except ValueError:
                want = None
            assert kernel_plan(c, hw, 32, limit, bwd=True) == want, (c, hw,
                                                                     limit)


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


def _flash_inputs(gen, device, b, h, n, dh, gain=1.0):
    """q, k, v, dO as the callers' (B, N, H, dh)-backed views (those of
    CrossAttention's projections, and of the gradient of its head merge),
    q and k times ``gain``, and the saved lse and delta of the plain
    forward."""
    q, k, v, do = (_heads_view(gen, device, b, n, h, dh) for _ in range(4))
    q, k = q * gain, k * gain
    o, lse = flash_attention_fwd_plain(q, k, v, dh ** -0.5)
    delta = (do * o).sum(dim=-1).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh", [
    (2, 2, 256, 8), (1, 4, 1024, 16), (2, 1, 1024, 128), (1, 3, 333, 8),
    (1, 1, 77, 128), (8, 8, 4096, 8), (2, 8, 1000, 16), (1, 1, 4100, 128)])
def test_flash_attention_fwd_kernel_matches_plain(cuda_device, b, h, n, dh):
    gen = torch.Generator(cuda_device).manual_seed(9)
    q, k, v, _, _, _ = _flash_inputs(gen, cuda_device, b, h, n, dh)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert o.transpose(1, 2).is_contiguous() and lse.is_contiguous()
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, dh ** -0.5)
    torch.testing.assert_close(o, o_ref, **CARD_TOL)
    torch.testing.assert_close(lse, lse_ref, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh", [(2, 1, 1024, 128), (4, 8, 4096, 8)])
def test_flash_attention_fwd_holds_logits_of_30(cuda_device, b, h, n, dh):
    """q and k scaled so that the scaled scores reach ±30: one tf32 pass
    (11 significant bits) would put errors of order 1e-3 into o; the
    kernel's 3xTF32 split must stay within CARD_TOL of the fp32 plain
    version."""
    gen = torch.Generator(cuda_device).manual_seed(12)
    q, k, v = (_heads_view(gen, cuda_device, b, n, h, dh) for _ in range(3))
    q, k = q * 2.5, k * 2.5
    scale = dh ** -0.5
    o, lse = flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    logits = torch.matmul(q[:1, :1] * scale, k[:1, :1].transpose(-1, -2))
    assert logits.abs().max().item() >= 25.0
    torch.testing.assert_close(o, o_ref, **CARD_TOL)
    torch.testing.assert_close(lse, lse_ref, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("h,dh", [(1, 128), (8, 8), (8, 16)])
def test_flash_attention_fwd_sums_4096_keys_in_fp32(cuda_device, h, dh):
    """4,096 keys with nearly flat scores, so that o averages v's common
    part over every key: the faces VQ's mid block (one head of 128) and the
    faces UNet's head sizes. A running sum fed by every mma of the 4,096
    keys drifts by about 1e-4 of its size (the tensor cores truncate each
    mma's sum); summed a tile at a time from zero, o stays within fp32's
    few ulps of the plain version."""
    gen = torch.Generator(cuda_device).manual_seed(13)
    q, k, v = (_heads_view(gen, cuda_device, 8, 4096, h, dh)
               for _ in range(3))
    q, k = q * 0.3, k * 0.3
    v = v * 0.01 + 1.0
    o, lse = flash_attention_fwd(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, dh ** -0.5)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh,gain", [
    (2, 2, 256, 8, 1.0), (1, 4, 1024, 16, 1.0), (1, 3, 333, 8, 1.0),
    (2, 2, 130, 16, 1.0),
    (8, 8, 4096, 8, 1.0), (8, 8, 1024, 16, 1.0),   # the faces micro-step's
    (1, 2, 7, 8, 1.0), (2, 3, 40, 16, 1.0),        # N below one tile
    (4, 8, 4096, 8, 2.5), (2, 8, 1024, 16, 2.5),   # logits of ±30
    # dh 128: the faces VQ's mid blocks, another shape, N below one tile
    # and not a multiple of it, logits of ±30
    (8, 1, 4096, 128, 1.0), (2, 2, 1024, 128, 1.0), (1, 1, 20, 128, 1.0),
    (2, 1, 333, 128, 1.0), (1, 2, 1000, 128, 1.0), (2, 1, 1024, 128, 2.5)])
def test_flash_attention_bwd_kernels_match_plain(cuda_device, b, h, n, dh,
                                                 gain):
    """dq and dk/dv against their plain versions on the callers' strided
    views. At gain 2.5 the scaled logits reach ±30, where one tf32 pass
    would miss CARD_TOL: the 3xTF32 split must hold it."""
    gen = torch.Generator(cuda_device).manual_seed(10)
    args = _flash_inputs(gen, cuda_device, b, h, n, dh, gain)
    if gain > 1.0:
        q, k = args[0][:1, :1], args[1][:1, :1]
        logits = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
        assert logits.abs().max().item() >= 25.0
    before = flash_attention_dq.launches, flash_attention_dkdv.launches
    dq = flash_attention_dq(*args, dh ** -0.5)
    dk, dv = flash_attention_dkdv(*args, dh ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkdv.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(dq, flash_attention_dq_plain(*args, dh ** -0.5),
                               **CARD_TOL)
    for got, want in zip((dk, dv),
                         flash_attention_dkdv_plain(*args, dh ** -0.5)):
        torch.testing.assert_close(got, want, **CARD_TOL)
    # no atomics: a second run repeats bit for bit
    assert torch.equal(dk, flash_attention_dkdv(*args, dh ** -0.5)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh", [(8750, 8, 7, 8), (8750, 8, 20, 16),
                                      (17500, 4, 7, 128)])
def test_flash_attention_bwd_takes_more_than_65535_slices(cuda_device, b, h,
                                                          n, dh):
    """B * H = 70,000: both backward kernels put B * H on gridDim.x."""
    gen = torch.Generator(cuda_device).manual_seed(20)
    args = _flash_inputs(gen, cuda_device, b, h, n, dh)
    dq = flash_attention_dq(*args, dh ** -0.5)
    dk, dv = flash_attention_dkdv(*args, dh ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(dq, flash_attention_dq_plain(*args, dh ** -0.5),
                               **CARD_TOL)
    for got, want in zip((dk, dv),
                         flash_attention_dkdv_plain(*args, dh ** -0.5)):
        torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
def test_flash_attention_autograd_runs_all_three_kernels(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(11)
    q, k, v = (_heads_view(gen, cuda_device, 2, 1024, 4, 16).requires_grad_()
               for _ in range(3))
    do = torch.randn(2, 4, 1024, 16, generator=gen, device=cuda_device)
    before = (flash_attention_fwd.launches, flash_attention_dq.launches,
              flash_attention_dkdv.launches)
    grads = torch.autograd.grad(flash_attention(q, k, v, 0.25), (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_dq.launches,
            flash_attention_dkdv.launches) == tuple(n + 1 for n in before)
    with plain_path():
        ref = torch.autograd.grad(flash_attention(q, k, v, 0.25), (q, k, v),
                                  do)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attention_core", "flash_attention",
                                  "flash_attention_dh128", "groupnorm_silu"])
def test_backward_from_out_sum(cuda_device, name):
    """out.sum().backward() hands each Function an expanded cotangent of
    strides 0; the backward kernels run on it and match the plain path."""
    gen = torch.Generator(cuda_device).manual_seed(25)
    if name == "groupnorm_silu":
        leaves = [t.requires_grad_() for t in
                  _gn_inputs(gen, cuda_device, 4, 128, 8, 8, True)]
        fn, wrapper = groupnorm_silu, gn_silu_bwd
    else:
        flash = name.startswith("flash_attention")
        h, dh = (1, 128) if name == "flash_attention_dh128" else (4, 16)
        leaves = [_heads_view(gen, cuda_device, 2, 1024 if flash else 64, h,
                              dh).requires_grad_() for _ in range(3)]
        fn = lambda *a: (flash_attention if flash
                         else attention_core)(*a, dh ** -0.5)
        wrapper = flash_attention_dq if flash else attention_core_bwd
    before = wrapper.launches
    fn(*leaves).sum().backward()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    with plain_path():
        fn(*leaves).sum().backward()
    for a, want in zip(got, leaves):
        torch.testing.assert_close(a, want.grad, **CARD_TOL)


@pytest.mark.cuda
def test_flash_wrappers_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 2, 256, 16, device=cuda_device)
    lse = torch.zeros(1, 2, 256, device=cuda_device)
    shifted = torch.zeros(2 * 256 * 16 + 1,
                          device=cuda_device)[1:].view(1, 2, 256, 16)
    bad = [
        lambda: flash_attention_fwd(*(torch.zeros(
            1, 2, 16, 256, device=cuda_device).transpose(2, 3),) * 3, 0.3),
        lambda: flash_attention_fwd(q.double(), q.double(), q.double(), 0.3),
        lambda: flash_attention_fwd(q, q[:, :, :128], q[:, :, :128], 0.3),
        lambda: flash_attention_fwd(*(torch.zeros(1, 2, 256, 32,
                                                  device=cuda_device),) * 3,
                                    0.3),
        # a head size the backward kernels do not take
        lambda: flash_attention_dq(*(torch.zeros(1, 1, 256, 32,
                                                 device=cuda_device),) * 4,
                                   lse[:, :1], lse[:, :1], 0.3),
        lambda: flash_attention_dkdv(*(torch.zeros(1, 1, 256, 64,
                                                   device=cuda_device),) * 4,
                                     lse[:, :1], lse[:, :1], 0.3),
        lambda: flash_attention_dq(q, q, q, q, lse.transpose(1, 2)
                                   .contiguous().transpose(1, 2), lse, 0.3),
        lambda: flash_attention_dkdv(q, q, q, q, lse, lse[:, :, :128], 0.3),
        lambda: flash_attention_dkdv(q, q, q.cpu(), q, lse, lse, 0.3),
        # rows that do not start on 16 bytes (every kernel copies 16 bytes)
        lambda: flash_attention_fwd(*(shifted,) * 3, 0.3),
        lambda: flash_attention_dq(q, q, q, shifted, lse, lse, 0.3),
        lambda: flash_attention_dq(shifted, q, q, q, lse, lse, 0.3),
        lambda: flash_attention_dkdv(q, shifted, q, q, lse, lse, 0.3),
        lambda: flash_attention_dkdv(q, q, q, shifted, lse, lse, 0.3),
        # rows 4 bytes apart from 16: a row stride not a multiple of 4
        lambda: flash_attention_dkdv(q, q, torch.zeros(
            1, 2, 256, 18, device=cuda_device)[..., :16], q, lse, lse, 0.3),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def _fused_inputs(gen, device, b, n, c, m, d, heads, dim_head, c_out=None):
    """x, ctx, and the weights as the call site passes them: transposed
    views of nn.Linear weights (out, in), so (in, out) with strides
    (1, in)."""
    inner = heads * dim_head
    c_out = c if c_out is None else c_out
    rand = lambda *s: torch.randn(*s, generator=gen, device=device)
    x, ctx = rand(b, n, c), rand(b, m, d)
    wq, wk, wv = (rand(inner, cin).t() * cin ** -0.5
                  for cin in (c, d, d))
    wo = rand(c_out, inner).t() * inner ** -0.5
    return x, ctx, wq, wk, wv, wo, 0.1 * rand(c_out)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,m,d,heads,dim_head,self_attn", [
    (32, 4096, 64, 20, 16, 8, 8, False),     # faces, 64x64 latents
    (32, 1024, 128, 20, 16, 8, 16, False),   # faces, 32x32 latents
    (5, 100, 64, 20, 16, 8, 8, False),       # ragged row tile, per head
    (160, 256, 256, 20, 16, 8, 32, False),   # flagship, 16x16 at 256 ch
    (160, 4, 256, 20, 16, 8, 32, False),     # flagship, 2x2 mid block
    (2, 64, 32, 64, 32, 4, 8, True),         # the JAX test's self-attention
    (3, 45, 40, 7, 12, 3, 16, False),        # ragged row tile, odd sizes
    (64, 256, 256, 20, 16, 8, 32, False),    # faces FID batch, 16x16
    (64, 1024, 128, 20, 16, 8, 16, False),   # faces FID batch, 32x32
    (2, 33, 37, 5, 9, 2, 8, False)])         # C and D not multiples of 4
def test_fused_attention_kernel_matches_plain(cuda_device, b, n, c, m, d,
                                              heads, dim_head, self_attn):
    gen = torch.Generator(cuda_device).manual_seed(6)
    x, ctx, wq, wk, wv, wo, bo = _fused_inputs(gen, cuda_device, b, n, c, m,
                                               d, heads, dim_head)
    if self_attn:
        ctx = x
    before = fused_attention.launches
    out = fused_attention(x, ctx, wq, wk, wv, wo, bo, heads=heads,
                          dim_head=dim_head)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = fused_attention_plain(x, ctx, wq, wk, wv, wo, bo, heads=heads,
                                dim_head=dim_head)
    torch.testing.assert_close(out, ref, **CARD_TOL)
    # the same weights as contiguous (in, out) arrays give the same output
    dense = [w.contiguous() for w in (wq, wk, wv, wo)]
    again = fused_attention(x, ctx, *dense, bo, heads=heads,
                            dim_head=dim_head)
    torch.testing.assert_close(again, out, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c_out", [130, 300])
def test_fused_attention_output_wider_than_one_pass(cuda_device, c_out):
    """An output projection wider than the kernel's columns per pass (64 at
    2 heads of 8, 256 at 8 heads of 32) runs in several passes."""
    heads, dim_head = (2, 8) if c_out == 130 else (8, 32)
    gen = torch.Generator(cuda_device).manual_seed(10)
    args = _fused_inputs(gen, cuda_device, 3, 70, 48, 20, 16, heads,
                         dim_head, c_out)
    kw = dict(heads=heads, dim_head=dim_head)
    out = fused_attention(*args, **kw)
    torch.cuda.synchronize()
    assert out.shape == (3, 70, c_out)
    torch.testing.assert_close(out, fused_attention_plain(*args, **kw),
                               **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(160, 16), (160, 4)])
def test_fused_attention_packs_batch_rows(cuda_device, b, n):
    """The flagship's 4x4 and 2x2 levels, where one tile packs the query
    rows of several batch rows: against the plain version, and dropping
    the first batch row (which moves every packing boundary) leaves each
    remaining row's output as it was."""
    gen = torch.Generator(cuda_device).manual_seed(9)
    args = _fused_inputs(gen, cuda_device, b, n, 256, 20, 16, 8, 32)
    kw = dict(heads=8, dim_head=32)
    out = fused_attention(*args, **kw)
    tail = fused_attention(args[0][1:], args[1][1:], *args[2:], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fused_attention_plain(*args, **kw),
                               **CARD_TOL)
    torch.testing.assert_close(tail, out[1:], **CARD_TOL)


@pytest.mark.cuda
def test_fused_attention_wrapper_refusals(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(7)
    args = _fused_inputs(gen, cuda_device, 2, 16, 32, 20, 16, 4, 8)
    kw = dict(heads=4, dim_head=8)
    x, ctx, wq, wk, wv, wo, bo = args
    with pytest.raises(ValueError, match="forward only"):
        fused_attention(x.requires_grad_(), *args[1:], **kw)
    x.requires_grad_(False)
    with pytest.raises(ValueError, match="forward only"):
        fused_attention(*args[:5], wo.detach().requires_grad_(), bo, **kw)
    with pytest.raises(ValueError, match="dtype"):
        fused_attention(*(t.double() for t in args), **kw)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_attention(x, ctx.cpu(), *args[2:], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_attention(*(t.to("meta") for t in args), **kw)
    # k and v of one batch row: 2 x 1,000 x 256 floats do not fit
    big = _fused_inputs(gen, cuda_device, 1, 8, 32, 1000, 16, 8, 32)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(*big, heads=8, dim_head=32)
    wide = _fused_inputs(gen, cuda_device, 1, 8, 32, 20, 16, 8, 64)
    with pytest.raises(ValueError, match="exceeds"):
        fused_attention(*wide, heads=8, dim_head=64)
    odd = _fused_inputs(gen, cuda_device, 1, 8, 32, 20, 16, 3, 24)
    with pytest.raises(ValueError, match="head size"):
        fused_attention(*odd, heads=3, dim_head=24)


@pytest.mark.cuda
def test_fused_attention_counts_launches_and_plain_calls(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(8)
    args = _fused_inputs(gen, cuda_device, 4, 64, 64, 20, 16, 8, 8)
    launches, plain = fused_attention.launches, fused_attention.plain_calls
    for _ in range(3):
        out = fused_attention(*args, heads=8, dim_head=8)
    with plain_path():
        ref = fused_attention(*args, heads=8, dim_head=8)
    torch.cuda.synchronize()
    assert fused_attention.launches == launches + 3
    assert fused_attention.plain_calls == plain + 1
    torch.testing.assert_close(out, ref, **CARD_TOL)


#: the flagship VQ decoder's GN-SiLU inputs at B = 128 (the MCL step's
#: second order runs the double backward at each), then a faces-sized group
#: on a cluster of 8, groups of 1 to 8 channels and a shape whose rows are
#: not a multiple of 4 (4-byte copies)
BWD_BWD_SHAPES = [
    ((128, 128, 16, 16), 1), ((128, 128, 32, 32), 1), ((128, 64, 32, 32), 1),
    ((128, 64, 64, 64), 1), ((128, 32, 64, 64), 1), ((2, 32, 256, 256), 8),
    ((4, 256, 8, 8), 1), ((3, 96, 5, 7), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cluster", BWD_BWD_SHAPES)
@pytest.mark.parametrize("params", [False, True])
def test_gn_silu_bwd_bwd_kernel_matches_plain(cuda_device, shape, cluster,
                                              params):
    b, c, h, w = shape
    assert gn_silu_bwd_bwd_plan(b, c, h * w, 32,
                                _optin(cuda_device)).cluster == cluster
    gen = torch.Generator(cuda_device).manual_seed(31)
    x, gamma, beta, _, _ = _gn_inputs(gen, cuda_device, *shape, False)
    g, du = (torch.randn(shape, generator=gen, device=cuda_device)
             for _ in range(2))
    bars = (dict(dgamma_bar=torch.randn(c, generator=gen, device=cuda_device),
                 dbeta_bar=torch.randn(c, generator=gen, device=cuda_device))
            if params else {})
    before = gn_silu_bwd_bwd.launches
    got = gn_silu_bwd_bwd(du, g, x, gamma, beta, eps=1e-6,
                          param_grads=params, **bars)
    torch.cuda.synchronize()
    assert gn_silu_bwd_bwd.launches == before + 1
    want = groupnorm_silu_bwd_bwd_plain(du, g, x, gamma, beta, eps=1e-6,
                                        param_grads=params, **bars)
    for a, r in zip(got, want):
        if r is None:
            assert a is None
        else:
            torch.testing.assert_close(a, r, **CARD_TOL)
    again = gn_silu_bwd_bwd(du, g, x, gamma, beta, eps=1e-6,
                            param_grads=params, **bars)
    assert all(a is None or torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.cuda
def test_gn_silu_bwd_bwd_plan_is_the_kernel_plan(cuda_device):
    shapes = {(c, hw) for c in (32, 64, 128, 256, 512)
              for hw in (4, 9, 16, 35, 256, 1024, 4096, 16384, 65536)}
    for limit in (_optin(cuda_device), 48 * 1024):
        for c, hw in sorted(shapes):
            try:
                want = tuple(gn_silu_bwd_bwd_plan(1, c, hw, 32, limit))[:5]
            except ValueError:
                want = None
            assert kernel_plan(c, hw, 32, limit, bwd_bwd=True) == want, (
                c, hw, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dh", [(128, 1, 256, 256, 128),
                                        (4, 8, 64, 20, 16)])
def test_attention_core_bwd_vjp_matches_autograd_of_plain(cuda_device, b, h,
                                                          n, m, dh):
    gen = torch.Generator(cuda_device).manual_seed(32)
    q, k, v, do, dq_bar, dk_bar, dv_bar = (
        torch.randn(b, h, length, dh, generator=gen, device=cuda_device)
        for length in (n, m, m, n, n, m, m))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, do)]
    want = torch.autograd.grad(
        attention_core_bwd_plain(*leaves, dh ** -0.5), leaves,
        (dq_bar, dk_bar, dv_bar))
    before = attention_core_bwd_vjp.calls
    got = attention_core_bwd_vjp(q, k, v, do, dq_bar, dk_bar, dv_bar,
                                 dh ** -0.5)
    assert attention_core_bwd_vjp.calls == before + 1
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **CARD_TOL)


#: the third-order kernel at the same shapes: four staged arrays put the
#: VQ decoder's 64x64 level on clusters of 2
BWD3_SHAPES = [(shape, 2 if shape == (128, 64, 64, 64) else cluster)
               for shape, cluster in BWD_BWD_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cluster", BWD3_SHAPES)
def test_gn_silu_bwd3_kernel_matches_plain(cuda_device, shape, cluster):
    b, c, h, w = shape
    assert gn_silu_bwd3_plan(b, c, h * w, 32,
                             _optin(cuda_device)).cluster == cluster
    gen = torch.Generator(cuda_device).manual_seed(38)
    x, gamma, beta, _, _ = _gn_inputs(gen, cuda_device, *shape, False)
    g, du, dx_bar = (torch.randn(shape, generator=gen, device=cuda_device)
                     for _ in range(3))
    before = gn_silu_bwd3.launches
    got = gn_silu_bwd3(du, dx_bar, g, x, gamma, beta, eps=1e-6)
    torch.cuda.synchronize()
    assert gn_silu_bwd3.launches == before + 1
    want = groupnorm_silu_bwd3_plain(du, dx_bar, g, x, gamma, beta, eps=1e-6)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **CARD_TOL)
    again = gn_silu_bwd3(du, dx_bar, g, x, gamma, beta, eps=1e-6)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.cuda
def test_gn_silu_bwd3_plan_is_the_kernel_plan(cuda_device):
    shapes = {(c, hw) for c in (32, 64, 128, 256, 512)
              for hw in (4, 9, 16, 35, 256, 1024, 4096, 16384, 65536)}
    for limit in (_optin(cuda_device), 48 * 1024):
        for c, hw in sorted(shapes):
            try:
                want = tuple(gn_silu_bwd3_plan(1, c, hw, 32, limit))[:5]
            except ValueError:
                want = None
            assert kernel_plan(c, hw, 32, limit, bwd3=True) == want, (
                c, hw, limit)


def _third_order(route, kind, shape, device):
    """A third order through one kernel Function, on ``route``: the
    fisher_sm pattern (a score d/dx <f(x), w>, its Hutchinson term d/dx
    <score, v>, then the gradient of <score, score> + <hvp, v> in x)."""
    gen = torch.Generator(device).manual_seed(39)
    if kind == "gn":
        x, gamma, beta, _, _ = _gn_inputs(gen, device, *shape, False)
        leaves = [x.requires_grad_()]
        fn = lambda: groupnorm_silu(x, gamma, beta, eps=1e-6)
    else:
        b, h, n, dh = shape
        leaves = [_heads_view(gen, device, b, n, h, dh).requires_grad_()
                  for _ in range(3)]
        fn = lambda: attention_core(*leaves, dh ** -0.5)
    with route():
        y = fn()
        w, v = (torch.randn(y.shape, generator=gen, device=device)
                for _ in range(2))
        score = torch.autograd.grad((y * w).sum(), leaves, create_graph=True)
        hvp = torch.autograd.grad(sum((s * v).sum() for s in score), leaves,
                                  create_graph=True)
        loss = sum((s * s).sum() + (t * v).sum() for s, t in zip(score, hvp))
        return torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("gn", (2, 64, 8, 8)), ("gn", (4, 64, 64, 64)),
    ("attn", (2, 1, 16, 32)), ("attn", (4, 1, 256, 128))])
def test_third_order_matches_plain_path(cuda_device, kind, shape):
    """fisher_sm's third order through groupnorm_silu (``_GNSiLUBwdBwd``:
    one gn_silu_bwd3 launch) and attention_core (its recorded VJP) on the
    kernel route equals the plain route's."""
    import contextlib
    launches = gn_silu_bwd3.launches
    got = _third_order(contextlib.nullcontext, kind, shape, cuda_device)
    torch.cuda.synchronize()
    assert gn_silu_bwd3.launches - launches == (kind == "gn")
    want = _third_order(plain_path, kind, shape, cuda_device)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **CARD_TOL)


def _decoder_du(device, route, order=2):
    """d/du of <dec(z, u) . r> differentiated in z once more: the flagship
    VQ decoder at B = 4 from a seeded init, g = d/dz sum(dec(z, u) w), then
    the gradient of sum(g v) in u and z. With ``order`` 3, fisher_sm's
    pattern: h = d/dz sum(g v) recorded, then the gradient of sum(g²) +
    sum(h v) in u and z. Returns the two gradients."""
    from encdiff_tpu_torch.configs import FLAGSHIP
    from encdiff_tpu_torch.core.device import resolve_device
    from encdiff_tpu_torch.models.autoencoder import (VQModelInterface,
                                                      init_fresh)
    resolve_device(device)  # the port's fp32 convolutions (TF32 off)
    model = VQModelInterface(**FLAGSHIP["first_stage_config"]).to(device)
    init_fresh(model, torch.Generator(device).manual_seed(33))
    model.requires_grad_(False)
    gen = torch.Generator(device).manual_seed(34)
    z = torch.randn(4, 3, 16, 16, generator=gen, device=device)
    u = torch.randn(4, 20, generator=gen, device=device)
    wts = torch.randn(4, 3, 64, 64, generator=gen, device=device)
    v = torch.randn(4, 3, 16, 16, generator=gen, device=device)
    z, u = z.requires_grad_(), u.requires_grad_()
    with route():
        out = model.decode(z, disentangled_repr=u)
        g, = torch.autograd.grad((out * wts).sum(), z, create_graph=True)
        if order == 2:
            return torch.autograd.grad((g * v).sum(), (u, z))
        h, = torch.autograd.grad((g * v).sum(), z, create_graph=True)
        return torch.autograd.grad((g * g).sum() + (h * v).sum(), (u, z))


@pytest.mark.cuda
def test_double_backward_through_the_decoder_reaches_u(cuda_device):
    """The second order through the decoder's GN-SiLU and attention kernels
    on the card equals the plain path's (the backward kernels' outputs are
    differentiable): 23 double-backward GN-SiLU launches and one attention
    VJP, and d/du, which no path but the second order reaches, matches."""
    import contextlib
    counts = (gn_silu_bwd_bwd.launches, attention_core_bwd_vjp.calls)
    got = _decoder_du(cuda_device, contextlib.nullcontext)
    torch.cuda.synchronize()
    assert (gn_silu_bwd_bwd.launches - counts[0],
            attention_core_bwd_vjp.calls - counts[1]) == (23, 1)
    want = _decoder_du(cuda_device, plain_path)
    for a, r in zip(got, want):
        assert torch.linalg.vector_norm(r) > 0
        rel = torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r)
        assert rel < 1e-3, rel


@pytest.mark.cuda
def test_third_order_through_the_decoder(cuda_device):
    """fisher_sm's third order through the flagship decoder on the card
    equals the plain path's: one gn_silu_bwd3 launch a GN-SiLU site (23)."""
    import contextlib
    launches = gn_silu_bwd3.launches
    got = _decoder_du(cuda_device, contextlib.nullcontext, order=3)
    torch.cuda.synchronize()
    assert gn_silu_bwd3.launches - launches == 23
    want = _decoder_du(cuda_device, plain_path, order=3)
    for a, r in zip(got, want):
        assert torch.linalg.vector_norm(r) > 0
        rel = torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r)
        assert rel < 1e-3, rel


@pytest.mark.cuda
def test_second_order_refusals(cuda_device):
    """FiLM rows in the double backward raise on the card; so do a fourth
    order through groupnorm_silu, and gamma's gradient or FiLM rows under a
    third. The third orders themselves run:
    ``test_third_order_matches_plain_path`` holds them at (2, 64, 8, 8) and
    at the decoder's (4, 64, 64, 64)."""
    gen = torch.Generator(cuda_device).manual_seed(35)
    x, gamma, beta, scale, shift = _gn_inputs(gen, cuda_device, 2, 64, 8, 8,
                                              True)
    g = torch.randn_like(x)
    with pytest.raises(NotImplementedError, match=r"\(2, 64, 8, 8\)"):
        gn_silu_bwd_bwd(g, g, x, gamma, beta, scale, shift)
    xr = x.clone().requires_grad_()
    y = groupnorm_silu(xr, gamma, beta)
    d, = torch.autograd.grad(y.sum(), xr, create_graph=True)
    h, = torch.autograd.grad((d * d).sum(), xr, create_graph=True)
    with pytest.raises(NotImplementedError, match=r"fourth.*\(2, 64, 8, 8\)"):
        torch.autograd.grad((h * h).sum(), xr, create_graph=True)
    gr = gamma.clone().requires_grad_()
    d, = torch.autograd.grad(groupnorm_silu(xr, gr, beta).sum(), xr,
                             create_graph=True)
    with pytest.raises(NotImplementedError, match=r"gamma.*\(2, 64, 8, 8\)"):
        torch.autograd.grad((d * d).sum(), xr, create_graph=True)
    d, = torch.autograd.grad(groupnorm_silu(xr, gamma, beta, scale,
                                            shift).sum(), xr,
                             create_graph=True)
    with pytest.raises(NotImplementedError, match=r"FiLM.*\(2, 64, 8, 8\)"):
        torch.autograd.grad((d * d).sum(), xr, create_graph=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh", [(2, 1, 1024, 8), (1, 1, 4096, 128)])
def test_flash_second_order_refused(cuda_device, b, h, n, dh):
    """A second order through the flash attention (autograd recording
    inside its backward) raises on the card: the dq and dk/dv kernels'
    outputs have no grad_fn, so the attention's terms would otherwise drop
    out of the second derivative as constants. The first order still
    runs; the plain route still records a second one."""
    gen = torch.Generator(cuda_device).manual_seed(36)
    q, k, v = (_heads_view(gen, cuda_device, b, n, h, dh).requires_grad_()
               for _ in range(3))
    o = flash_attention(q, k, v, dh ** -0.5)
    d, = torch.autograd.grad(o.sum(), q)
    assert torch.isfinite(d).all()
    with pytest.raises(NotImplementedError, match=rf"\({b}, {h}, {n}, {dh}\)"):
        torch.autograd.grad(flash_attention(q, k, v, dh ** -0.5).sum(), q,
                            create_graph=True)
    with plain_path():
        d, = torch.autograd.grad(flash_attention(q, k, v, dh ** -0.5).sum(),
                                 q, create_graph=True)
        assert d.grad_fn is not None


@pytest.mark.cuda
def test_flash_attention_fwd_at_the_faces_latent_cache(cuda_device):
    """The flash forward at (128, 1, 4096, 128): the faces VQ encoder's mid
    block over a latent-cache chunk of 128 faces at 256 px. The plain
    version runs in slices of 16 rows (1 GiB of scores each)."""
    gen = torch.Generator(cuda_device).manual_seed(37)
    b, h, n, dh = 128, 1, 4096, 128
    q, k, v = (_heads_view(gen, cuda_device, b, n, h, dh) for _ in range(3))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    for i in range(0, b, 16):
        part = slice(i, i + 16)
        o_ref, lse_ref = flash_attention_fwd_plain(q[part], k[part], v[part],
                                                   dh ** -0.5)
        torch.testing.assert_close(o[part], o_ref, **CARD_TOL)
        torch.testing.assert_close(lse[part], lse_ref, **CARD_TOL)
