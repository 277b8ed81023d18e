"""The port's kernels held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests feed the
same numpy inputs to that version and to the Pallas kernel in interpret mode
(and to its jnp reference). ``tests/test_torch_port_cuda.py`` holds the CUDA
kernels against the plain versions on the card.

Tolerance: both sides compute in fp32 with sums taken in another order, so
the outputs (O(1) after the normalisation or the softmax) agree to a few
fp32 ulps times the reduction length: 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.nn.pallas.attention import attention_core as jax_attention_core
from encdiff_tpu.nn.pallas.groupnorm_silu import (
    groupnorm_silu as jax_groupnorm_silu, reference_groupnorm_silu)
from encdiff_tpu_torch.nn.kernels.attention import (attention_core,
                                                    attention_core_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import groupnorm_silu

CPU_TOL = dict(rtol=2e-5, atol=2e-5)


def _gn_inputs(seed, b, h, w, c, film):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32) * 2.0 + 0.5
    gamma = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    beta = (0.2 * rs.randn(c)).astype(np.float32)
    scale = (0.2 * rs.randn(b, c)).astype(np.float32) if film else None
    shift = (0.2 * rs.randn(b, c)).astype(np.float32) if film else None
    return x, gamma, beta, scale, shift


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm_silu_plain_matches_pallas(film, eps):
    x, gamma, beta, scale, shift = _gn_inputs(0, 2, 8, 8, 64, film)
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = reference_groupnorm_silu(j(x), j(gamma), j(beta), j(scale), j(shift),
                                   groups=32, eps=eps)
    pallas = jax_groupnorm_silu(j(x), j(gamma), j(beta), j(scale), j(shift),
                                groups=32, eps=eps, interpret=True)
    before = groupnorm_silu.launches
    out = groupnorm_silu(_nchw(x), _t(gamma), _t(beta), _t(scale), _t(shift),
                         groups=32, eps=eps)
    assert groupnorm_silu.launches == before  # CPU tensors take the plain path
    out = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **CPU_TOL)
    np.testing.assert_allclose(out, np.asarray(pallas), **CPU_TOL)


def _qkv(seed, b, h, n, m, dh):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, n, dh).astype(np.float32),
            rs.randn(b, h, m, dh).astype(np.float32),
            rs.randn(b, h, m, dh).astype(np.float32))


@pytest.mark.parametrize("dh", [8, 32, 128])
@pytest.mark.parametrize("m", ["self", 20])
def test_attention_core_plain_matches_pallas(dh, m):
    n = 64
    m = n if m == "self" else m
    q, k, v = _qkv(1, 2, 2, n, m, dh)
    pallas = jax_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                interpret=True)
    before = attention_core.launches
    out = attention_core(_t(q), _t(k), _t(v), dh ** -0.5)
    assert attention_core.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **CPU_TOL)


def test_attention_core_takes_strided_heads():
    """The callers pass (B, N, H, dh) projections viewed as (B, H, N, dh)."""
    rs = np.random.RandomState(2)
    b, n, h, dh = 2, 16, 4, 8
    q = torch.from_numpy(rs.randn(b, n, h, dh).astype(np.float32))
    kv = torch.from_numpy(rs.randn(b, 20, h, dh).astype(np.float32))
    out = attention_core(q.transpose(1, 2), kv.transpose(1, 2),
                         kv.transpose(1, 2), 0.3)
    ref = attention_core_plain(q.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous(), 0.3)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=0)
