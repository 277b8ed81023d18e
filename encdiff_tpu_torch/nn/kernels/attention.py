"""softmax(q kᵀ·scale) v: the CUDA kernels ``csrc/attention_core.cu``
(forward and backward) and their plain PyTorch versions.

Counterpart of ``encdiff_tpu/nn/pallas/attention.py`` (``attention_core``
and its custom VJP): ``attention_core`` is differentiable through
``_AttentionCore``, whose backward is the recompute-P kernel. The
projections around it stay in PyTorch, as the JAX package left them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from encdiff_tpu_torch.nn.kernels import (build, check_cuda_tensor,
                                          head_strides, launch_stream,
                                          raise_on_error, takes_plain)

#: head sizes the kernels take (csrc/attention_core.cu): forward, backward
HEAD_SIZES = (8, 16, 32, 64, 128)
BWD_HEAD_SIZES = (8, 16, 32)


def attention_core_plain(q, k, v, scale: float):
    """fp32 scores and softmax in plain PyTorch: q (B, H, N, dh),
    k and v (B, H, M, dh) -> (B, H, N, dh)."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(sim, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_core_bwd_plain(q, k, v, do, scale: float):
    """(dq, dk, dv) of ``attention_core_plain`` for the cotangent ``do``:
    a line-for-line copy of the Pallas ``_attn_core_bwd_kernel``."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    sim = torch.matmul(q, k.transpose(-1, -2)) * scale
    sim = sim - sim.amax(dim=-1, keepdim=True)
    p = torch.exp(sim)
    p = p / p.sum(dim=-1, keepdim=True)                  # (B, H, N, M)
    dv = torch.matmul(p.transpose(-1, -2), do)           # (B, H, M, dh)
    dp = torch.matmul(do, v.transpose(-1, -2))           # (B, H, N, M)
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - row) * scale
    dq = torch.matmul(ds, k)                             # (B, H, N, dh)
    dk = torch.matmul(ds.transpose(-1, -2), q)           # (B, H, M, dh)
    return dq, dk, dv


@functools.cache
def _fn():
    fn = build.load("attention_core").attention_core_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p] + [i] * 17 + [ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _bwd_fn():
    fn = build.load("attention_core").attention_core_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 5 + [ctypes.POINTER(i), ctypes.c_float, p]
    fn.restype = i
    return fn


class _AttentionCore(torch.autograd.Function):
    """``attention_core`` with the recompute-P backward: only q, k and v are
    saved, as the JAX custom VJP saves them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _attention_core_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_core_bwd(q, k, v, do, ctx.scale)
        return dq, dk, dv, None


def attention_core(q, k, v, scale: float):
    """softmax(q kᵀ·scale) v. q: (B, H, N, dh); k, v: (B, H, M, dh); fp32,
    any batch / head / row strides, last dimension contiguous. Returns
    (B, H, N, dh), on CUDA as a view of a (B, N, H, dh) buffer so that
    merging the heads back costs no copy. Differentiable: when autograd
    records, the backward runs ``attention_core_bwd``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise on an input it does not take."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionCore.apply(q, k, v, scale)
    return _attention_core_fwd(q, k, v, scale)


def _attention_core_fwd(q, k, v, scale: float):
    if takes_plain(attention_core, q):
        return attention_core_plain(q, k, v, scale)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention_core: q, k, v must be 4-d (B, H, L, dh)")
    b, h, n, dh = q.shape
    m = k.shape[2]
    if dh not in HEAD_SIZES:
        raise ValueError(f"attention_core: head size {dh} not in {HEAD_SIZES}")
    check_cuda_tensor("q", q, q.device)
    check_cuda_tensor("k", k, q.device, (b, h, m, dh))
    check_cuda_tensor("v", v, q.device, (b, h, m, dh))
    out = torch.empty((b, n, h, dh), device=q.device).transpose(1, 2)
    strides = head_strides("attention_core", (("q", q), ("k", k), ("v", v),
                                              ("out", out)))
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, h, n, m, dh, *strides, scale, launch_stream(q.device))
    raise_on_error("attention_core_fwd", rc)
    attention_core.launches += 1
    return out


attention_core.launches = 0
attention_core.plain_calls = 0


def attention_core_bwd(q, k, v, do, scale: float):
    """(dq, dk, dv) of ``attention_core`` for the cotangent ``do`` (B, H, N,
    dh). Same layout rules as the forward; on CUDA the gradients are views
    of (B, L, H, dh) buffers, like the forward's output.

    CPU tensors take the plain version; CUDA tensors launch the two kernels
    of ``attention_core_bwd`` on the current stream, or raise on an input
    they do not take."""
    if takes_plain(attention_core_bwd, q):
        return attention_core_bwd_plain(q, k, v, do, scale)
    if any(t.dim() != 4 for t in (q, k, v, do)):
        raise ValueError("attention_core_bwd: q, k, v, do must be 4-d")
    b, h, n, dh = q.shape
    m = k.shape[2]
    if dh not in BWD_HEAD_SIZES:
        raise ValueError(f"attention_core_bwd: head size {dh} not in "
                         f"{BWD_HEAD_SIZES}")
    check_cuda_tensor("q", q, q.device)
    check_cuda_tensor("k", k, q.device, (b, h, m, dh))
    check_cuda_tensor("v", v, q.device, (b, h, m, dh))
    check_cuda_tensor("do", do, q.device, (b, h, n, dh))
    dq = torch.empty((b, n, h, dh), device=q.device).transpose(1, 2)
    dk = torch.empty((b, m, h, dh), device=q.device).transpose(1, 2)
    dv = torch.empty((b, m, h, dh), device=q.device).transpose(1, 2)
    stats = torch.empty((2, b * h, n), device=q.device)  # logsumexp, delta
    strides = head_strides("attention_core_bwd", (
        ("q", q), ("k", k), ("v", v), ("do", do), ("dq", dq), ("dk", dk),
        ("dv", dv)))
    c_strides = (ctypes.c_int * len(strides))(*strides)
    rc = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   stats[0].data_ptr(), stats[1].data_ptr(), b, h, n, m, dh,
                   c_strides, scale, launch_stream(q.device))
    raise_on_error("attention_core_bwd", rc)
    attention_core_bwd.launches += 1
    return dq, dk, dv


attention_core_bwd.launches = 0
attention_core_bwd.plain_calls = 0
