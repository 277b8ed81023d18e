"""The port's backward kernels held against the JAX package, on the CPU.

On the CPU each backward wrapper runs its plain PyTorch version:
``attention_core_bwd_plain`` (a copy of the Pallas ``_attn_core_bwd_kernel``)
and ``groupnorm_silu_bwd_plain`` (the GN-SiLU VJP in closed form). These
tests feed them, and autograd through the port's differentiable wrappers,
the same numpy inputs as the Pallas backward in interpret mode and
``jax.vjp`` of the Pallas forwards. ``tests/test_torch_port_cuda.py`` holds
the CUDA kernels against the plain versions on the card.

Tolerance 1e-5 (relative and absolute): both sides compute in fp32 with
sums in another order, on gradients of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.nn.pallas.attention import _attn_core_bwd_call
from encdiff_tpu.nn.pallas.attention import attention_core as jax_attention_core
from encdiff_tpu.nn.pallas.groupnorm_silu import gn_silu
from encdiff_tpu_torch.nn.kernels.attention import (attention_core,
                                                    attention_core_bwd,
                                                    attention_core_bwd_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    groupnorm_silu, groupnorm_silu_bwd_plain, gn_silu_bwd)

TOL = dict(rtol=1e-5, atol=1e-5)

#: the (N, M, dh) of every UNet attention at the flagship's levels 16², 8²,
#: 4² and the 2² mid block: self-attention, then cross-attention
TRAIN_ATTN_SHAPES = [(256, 256, 8), (256, 20, 8), (64, 64, 16), (64, 20, 16),
                     (16, 16, 32), (16, 20, 32), (4, 4, 32), (4, 20, 32)]
#: the head sizes of the VQ first stage's mid block (one head of 128), which
#: the backward kernel takes since its tensor-core redesign, at small N, M
WIDE_HEAD_SHAPES = [(16, 20, 64), (32, 32, 128)]


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n,m,dh", TRAIN_ATTN_SHAPES + WIDE_HEAD_SHAPES)
def test_attention_core_bwd_plain_matches_pallas(n, m, dh):
    rs = np.random.RandomState(n * 1000 + m + dh)
    q, k, v = _randn(rs, 1, 2, n, dh), _randn(rs, 1, 2, m, dh), _randn(rs, 1, 2, m, dh)
    do = _randn(rs, 1, 2, n, dh)
    ref = _attn_core_bwd_call(*(jnp.asarray(a) for a in (q, k, v, do)),
                              interpret=True)
    before = attention_core_bwd.launches
    got = attention_core_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)),
                             dh ** -0.5)
    assert attention_core_bwd.launches == before  # the CPU takes the plain path
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}",
                                   **TOL)


@pytest.mark.parametrize("n,m,dh", [(64, 20, 16), (16, 16, 32)])
def test_attention_core_autograd_matches_jax_vjp(n, m, dh):
    """Autograd through the port's ``attention_core`` (its Function, on the
    callers' strided head layout) against ``jax.vjp`` of the Pallas
    ``attention_core``."""
    rs = np.random.RandomState(n + m + dh)
    b, h = 2, 3
    q, k, v = _randn(rs, b, n, h, dh), _randn(rs, b, m, h, dh), _randn(rs, b, m, h, dh)
    do = _randn(rs, b, h, n, dh)
    heads = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    out, vjp = jax.vjp(lambda *a: jax_attention_core(*a, interpret=True),
                       heads(q), heads(k), heads(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = attention_core(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2), dh ** -0.5)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **TOL)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(do))
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a.transpose(1, 2).numpy(), np.asarray(r),
                                   err_msg=f"d{name}", **TOL)


def _gn_case(seed, b, h, w, c, film):
    rs = np.random.RandomState(seed)
    x = _randn(rs, b, h, w, c) * 2.0 + 0.5
    gamma = 1.0 + 0.2 * _randn(rs, c)
    beta = 0.2 * _randn(rs, c)
    scale = 0.2 * _randn(rs, b, c) if film else np.zeros((b, c), np.float32)
    shift = 0.2 * _randn(rs, b, c) if film else np.zeros((b, c), np.float32)
    g = _randn(rs, b, h, w, c)
    return x, gamma, beta, scale, shift, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm_silu_bwd_plain_matches_jax_vjp(film, eps):
    """All five cotangents of the closed form against ``jax.vjp`` of the
    JAX package's ``gn_silu`` (Pallas forward in interpret mode, reference
    recompute backward); without FiLM the JAX function takes zero rows and
    the port takes None, and returns None for their gradients."""
    x, gamma, beta, scale, shift, g = _gn_case(3, 2, 6, 5, 64, film)
    _, vjp = jax.vjp(lambda *a: gn_silu(*a, 32, eps, True),
                     *(jnp.asarray(a) for a in (x, gamma, beta, scale, shift)))
    dx, dgamma, dbeta, dscale, dshift = vjp(jnp.asarray(g))
    t = lambda a: torch.from_numpy(a) if film else None
    before = gn_silu_bwd.launches
    got = gn_silu_bwd(_nchw(g), _nchw(x), torch.from_numpy(gamma),
                      torch.from_numpy(beta), t(scale), t(shift), eps=eps)
    assert gn_silu_bwd.launches == before
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(dgamma), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dbeta), **TOL)
    if film:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(dscale), **TOL)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(dshift), **TOL)
    else:
        assert got[3] is None and got[4] is None


def test_groupnorm_silu_autograd_runs_the_closed_form():
    """Autograd through the port's ``groupnorm_silu`` goes through its
    Function, whose backward returns the closed form's gradients."""
    x, gamma, beta, scale, shift, g = _gn_case(4, 2, 4, 4, 64, True)
    ins = [_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
           torch.from_numpy(scale), torch.from_numpy(shift)]
    ins = [a.requires_grad_() for a in ins]
    out = groupnorm_silu(*ins)
    assert type(out.grad_fn).__name__ == "_GNSiLUBackward"
    ref = groupnorm_silu_bwd_plain(_nchw(g), *[a.detach() for a in ins])
    got = torch.autograd.grad(out, ins, _nchw(g))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=0)
