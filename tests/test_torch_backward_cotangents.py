"""The port's three backward Functions take whatever cotangent autograd hands
them, on the CPU.

``out.sum().backward()`` hands a custom Function's backward an expanded
cotangent whose strides are all 0. The CUDA wrappers behind
``_AttentionCore``, ``_FlashAttention`` and ``_GNSiLU`` read rows 16 bytes at
a time (or, for GN-SiLU, a contiguous gradient) and raise on anything else,
so each Function makes such a cotangent contiguous before it calls them.
Here each wrapper is replaced by a recorder that notes what it received and
then runs the real wrapper, which on the CPU takes its plain version; the
gradients are held against autograd through the plain forward. A cotangent
that is already a head-strided view with contiguous rows, as the train path's
are, reaches the attention wrappers as it is: no copy.

Tolerance 1e-5 (relative and absolute): fp32 on both sides, the closed-form
backward against autograd's, on gradients of order one.
"""

import numpy as np
import pytest
import torch

from encdiff_tpu_torch.nn.kernels import attention as kattn
from encdiff_tpu_torch.nn.kernels import flash_attention as kflash
from encdiff_tpu_torch.nn.kernels import groupnorm_silu as kgn

TOL = dict(rtol=1e-5, atol=1e-5)


def _record(monkeypatch, module, name, position):
    """Replace ``module.name`` by a recorder of argument ``position`` that
    calls the original; returns the list of what it received."""
    seen = []
    original = getattr(module, name)

    def recorder(*args, **kwargs):
        seen.append(args[position])
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, recorder)
    return seen


def _leaves(rs, *shapes):
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)).requires_grad_()
            for s in shapes]


def _heads(x):
    """(B, N, H, dh) -> the callers' (B, H, N, dh) view."""
    return x.transpose(1, 2)


def _case(name, rs):
    """(leaves, the Function's forward, the plain forward, [(module,
    wrapper name, position of the cotangent)])."""
    if name == "groupnorm_silu":
        b, c, hw = 2, 64, 5
        leaves = _leaves(rs, (b, c, hw, hw), (c,), (c,), (b, c), (b, c))
        with torch.no_grad():
            leaves[1].add_(1.0)
            for t in leaves[1:]:
                t.mul_(0.2)
        return (leaves, kgn.groupnorm_silu, kgn.groupnorm_silu_plain,
                [(kgn, "gn_silu_bwd", 0)])
    b, n, h, dh = 2, 24, 3, 8
    leaves = _leaves(rs, *[(b, n, h, dh)] * 3)
    scale = dh ** -0.5
    plain = lambda q, k, v: kattn.attention_core_plain(
        _heads(q), _heads(k), _heads(v), scale)
    if name == "attention_core":
        fn = lambda q, k, v: kattn.attention_core(_heads(q), _heads(k),
                                                  _heads(v), scale)
        return leaves, fn, plain, [(kattn, "attention_core_bwd", 3)]
    fn = lambda q, k, v: kflash.flash_attention(_heads(q), _heads(k),
                                                _heads(v), scale)
    return leaves, fn, plain, [(kflash, "flash_attention_dq", 3),
                               (kflash, "flash_attention_dkdv", 3)]


@pytest.mark.parametrize("name", ["attention_core", "flash_attention",
                                  "groupnorm_silu"])
def test_backward_from_out_sum_hands_the_wrapper_a_contiguous_cotangent(
        name, monkeypatch):
    leaves, fn, plain, wrappers = _case(name, np.random.RandomState(7))
    seen = [_record(monkeypatch, *w) for w in wrappers]
    fn(*leaves).sum().backward()
    got = [t.grad.clone() for t in leaves]
    for received in seen:
        assert len(received) == 1
        assert received[0].is_contiguous(), received[0].stride()
    for t in leaves:
        t.grad = None
    plain(*leaves).sum().backward()
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, **TOL)


@pytest.mark.parametrize("name", ["attention_core", "flash_attention"])
def test_head_strided_cotangent_reaches_the_wrapper_uncopied(name,
                                                             monkeypatch):
    """The train path's cotangent: the gradient of a (B, N, H, dh) buffer
    seen through the (B, H, N, dh) view, whose rows are contiguous."""
    rs = np.random.RandomState(8)
    leaves, fn, plain, wrappers = _case(name, rs)
    seen = [_record(monkeypatch, *w) for w in wrappers]
    out = fn(*leaves)
    upstream = torch.from_numpy(rs.randn(*out.transpose(1, 2).shape)
                                .astype(np.float32))
    (out.transpose(1, 2) * upstream).sum().backward()
    got = [t.grad.clone() for t in leaves]
    for received in seen:
        do = received[0]
        assert not do.is_contiguous() and do.stride(-1) == 1, do.stride()
    for t in leaves:
        t.grad = None
    (plain(*leaves).transpose(1, 2) * upstream).sum().backward()
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, **TOL)
