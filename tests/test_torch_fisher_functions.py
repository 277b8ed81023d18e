"""The third order of the GN-SiLU and attention backward Functions, held
against three nested ``jax.vjp`` of the XLA references on the CPU: what
``fisher_sm``'s Hutchinson divergence asks of the frozen decoder.

- ``_GNSiLUBwdBwd`` (reached from ``_GNSiLUBwd``'s backward when autograd
  records inside it): the gradients with respect to (du, g, x) of its (dg,
  dx) for cotangents (a, c), against ``jax.vjp`` of ``jax.vjp`` of
  ``jax.vjp`` of ``reference_groupnorm_silu``, NHWC there; on the CPU the
  Function's kernels take their plain versions.
- ``_AttentionCoreBwd`` recording its backward: the gradients with respect
  to (q, k, v, do) and the second order's cotangents, against three nested
  ``jax.vjp`` of softmax(q kᵀ s) v.
- The refusals: a fourth order through GN-SiLU, and under a third order
  FiLM rows, gradients of gamma or beta and cotangents of dgamma or dbeta,
  each raise ``NotImplementedError`` naming the shape.

Tolerance: 1e-4 relative L2 on every output (fp32, sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.nn.pallas.groupnorm_silu import reference_groupnorm_silu
from encdiff_tpu_torch.nn.kernels.attention import _AttentionCoreBwd
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (_GNSiLUBwd,
                                                         gn_silu_bwd3)

REL = 1e-4
GN_SHAPES = [(2, 64, 4, 4), (3, 32, 5, 3)]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _gn_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32) * 2 + 0.5
    g, du, a, c = (rs.randn(*shape).astype(np.float32) for _ in range(4))
    gamma = (1 + 0.2 * rs.randn(shape[1])).astype(np.float32)
    beta = (0.2 * rs.randn(shape[1])).astype(np.float32)
    return x, g, du, a, c, gamma, beta


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_silu_third_order_matches_jax(shape):
    """(du, g, x) gradients of the double backward's (dg, dx) for the
    cotangents (a, c), through ``_GNSiLUBwd`` -> ``_GNSiLUBwdBwd``."""
    x, g, du, a, c, gamma, beta = _gn_inputs(shape, 77)
    eps = 1e-6

    def bwd(gg, xx):
        return jax.vjp(lambda t: reference_groupnorm_silu(
            t, gamma, beta, groups=32, eps=eps), xx)[1](gg)[0]

    def bwd_bwd(uu, gg, xx):
        return jax.vjp(bwd, gg, xx)[1](uu)

    want = jax.vjp(bwd_bwd, _nhwc(du), _nhwc(g), _nhwc(x))[1](
        (_nhwc(a), _nhwc(c)))
    gl, xl, ul = (torch.from_numpy(t).requires_grad_() for t in (g, x, du))
    dx = _GNSiLUBwd.apply(gl, xl, torch.from_numpy(gamma),
                          torch.from_numpy(beta), None, None, 32, eps)[0]
    second = torch.autograd.grad(dx, (gl, xl), ul, create_graph=True)
    assert all(t.grad_fn is not None for t in second)
    got = torch.autograd.grad(second, (ul, gl, xl),
                              (torch.from_numpy(a), torch.from_numpy(c)))
    for i, (t, w) in enumerate(zip(got, want)):
        assert _rel(_nhwc(t.numpy()), w) <= REL, (i, _rel(_nhwc(t.numpy()), w))


def test_gn_silu_bwd3_is_the_third_order_in_g_and_x():
    """``gn_silu_bwd3``'s plain version (the CPU's): the gradients in g and
    x of the double backward's dx for a cotangent, against the same nested
    ``jax.vjp`` with the cotangent of dg zero."""
    x, g, du, _, c, gamma, beta = _gn_inputs((2, 64, 4, 4), 78)

    def dx2(gg, xx):
        def bwd(g2, x2):
            return jax.vjp(lambda t: reference_groupnorm_silu(
                t, gamma, beta, groups=32, eps=1e-5), x2)[1](g2)[0]
        return jax.vjp(bwd, gg, xx)[1](_nhwc(du))[1]

    want = jax.vjp(dx2, _nhwc(g), _nhwc(x))[1](_nhwc(c))
    got = gn_silu_bwd3(*(torch.from_numpy(t) for t in (du, c, g, x, gamma,
                                                       beta)))
    for t, w in zip(got, want):
        assert _rel(_nhwc(t.numpy()), w) <= REL


def test_attention_third_order_matches_jax():
    """``_AttentionCoreBwd`` with its backward recorded: the gradients of
    its VJP's (dq, dk, dv, ddo) for four cotangents, with respect to q, k,
    v, do and the second order's cotangents."""
    rs = np.random.RandomState(79)
    b, h, n, m, dh = 2, 2, 6, 5, 8
    scale = dh ** -0.5
    lengths = (n, m, m, n, n, m, m)
    ins = [rs.randn(b, h, length, dh).astype(np.float32)
           for length in lengths]
    cots = [rs.randn(b, h, length, dh).astype(np.float32)
            for length in (n, m, m, n)]

    def attn(qq, kk, vv):
        p = jax.nn.softmax(jnp.einsum("bhnd,bhmd->bhnm", qq, kk) * scale,
                           axis=-1)
        return jnp.einsum("bhnm,bhmd->bhnd", p, vv)

    def bwd(qq, kk, vv, dd):
        return jax.vjp(attn, qq, kk, vv)[1](dd)

    def bwd_bwd(qq, kk, vv, dd, qb, kb, vb):
        return jax.vjp(bwd, qq, kk, vv, dd)[1]((qb, kb, vb))

    want = jax.vjp(bwd_bwd, *ins)[1](tuple(cots))
    leaves = [torch.from_numpy(t).requires_grad_() for t in ins]
    outs = _AttentionCoreBwd.apply(*leaves[:4], scale)
    second = torch.autograd.grad(outs, leaves[:4], leaves[4:],
                                 create_graph=True)
    got = torch.autograd.grad(second, leaves,
                              [torch.from_numpy(t) for t in cots])
    for i, (t, w) in enumerate(zip(got, want)):
        assert _rel(t.numpy(), w) <= REL, (i, _rel(t.numpy(), w))


def test_fourth_order_raises():
    x, g, du, _, c, gamma, beta = _gn_inputs((2, 64, 4, 4), 80)
    gl, xl, ul = (torch.from_numpy(t).requires_grad_() for t in (g, x, du))
    dx = _GNSiLUBwd.apply(gl, xl, torch.from_numpy(gamma),
                          torch.from_numpy(beta), None, None, 32, 1e-5)[0]
    _, dx2 = torch.autograd.grad(dx, (gl, xl), ul, create_graph=True)
    with pytest.raises(NotImplementedError,
                       match=r"fourth.*\(2, 64, 4, 4\)"):
        torch.autograd.grad((dx2 * torch.from_numpy(c)).sum(), xl,
                            create_graph=True)


@pytest.mark.parametrize("case", ["film", "gamma", "dgamma_bar"])
def test_third_order_refusals(case):
    """What no third-order path has: FiLM rows, gradients of gamma or beta,
    a cotangent of dgamma."""
    x, g, du, _, _, gamma, beta = _gn_inputs((2, 64, 4, 4), 81)
    rs = np.random.RandomState(82)
    gl, xl, ul = (torch.from_numpy(t).requires_grad_() for t in (g, x, du))
    ga, be = torch.from_numpy(gamma), torch.from_numpy(beta)
    film = (torch.from_numpy(0.2 * rs.randn(2, 64).astype(np.float32)),) * 2
    if case == "gamma":
        ga = ga.clone().requires_grad_()
    outs = _GNSiLUBwd.apply(gl, xl, ga, be,
                            *(film if case == "film" else (None, None)),
                            32, 1e-5)
    picked = [outs[0]] + ([outs[1]] if case == "dgamma_bar" else [])
    cots = [ul] + ([torch.ones(64)] if case == "dgamma_bar" else [])
    with pytest.raises(NotImplementedError, match=r"\(2, 64, 4, 4\)"):
        torch.autograd.grad(picked, xl, cots, create_graph=True)
