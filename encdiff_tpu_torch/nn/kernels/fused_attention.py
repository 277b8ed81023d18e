"""Multi-head attention with its four projections in one kernel: the CUDA
kernel ``csrc/fused_attention.cu`` and its plain PyTorch version.

Counterpart of ``encdiff_tpu/nn/pallas/attention.py:fused_attention``, with
its signature: x (B, N, C), ctx (B, M, D), the weights in the JAX (in, out)
layout (wq (C, H·dh), wk and wv (D, H·dh), wo (H·dh, C_out)), bo (C_out,),
keywords ``heads`` and ``dim_head``; returns (B, N, C_out). The weights may
be any strided views: the kernel reads a caller's ``nn.Linear`` weights
transposed (an (in, out) view whose ``in`` index is contiguous) in place,
and the wrapper copies a weight in any other layout into that one.

Forward only, as the TPU kernel is (it has no VJP): the wrapper raises on
any input that requires grad rather than give a gradient that is silently
wrong. ``nn.attention.CrossAttention`` routes here only where autograd will
not need one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from encdiff_tpu_torch.nn.kernels import (build, check_cuda_tensor,
                                          launch_stream, raise_on_error,
                                          takes_plain)

#: the most heads · dim_head the kernel takes (its columns per lane)
MAX_INNER = 256
#: the head sizes the kernel is built for (the UNet's)
HEAD_SIZES = (8, 16, 32)


def fused_attention_plain(x, ctx, wq, wk, wv, wo, bo, *, heads: int,
                          dim_head: int):
    """Plain PyTorch, a line-for-line copy of the JAX
    ``reference_attention``."""
    b, n, _ = x.shape
    m = ctx.shape[1]
    q = (x @ wq).reshape(b, n, heads, dim_head).permute(0, 2, 1, 3)
    k = (ctx @ wk).reshape(b, m, heads, dim_head).permute(0, 2, 1, 3)
    v = (ctx @ wv).reshape(b, m, heads, dim_head).permute(0, 2, 1, 3)
    sim = torch.einsum("bhid,bhjd->bhij", q, k).float() * dim_head ** -0.5
    p = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhij,bhjd->bhid", p, v).to(q.dtype)
    out = out.permute(0, 2, 1, 3).reshape(b, n, heads * dim_head)
    return out @ wo + bo


@functools.cache
def _fns():
    lib = build.load("fused_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = lib.fused_attention_fwd
    fwd.argtypes = [p] * 8 + [i] * 8 + [ctypes.POINTER(ll), ctypes.c_float, p]
    fwd.restype = i
    smem = lib.fused_attention_smem
    smem.argtypes = [i] * 5 + [ctypes.POINTER(ll)] * 2
    smem.restype = i
    return fwd, smem


def _shared_memory(m: int, c: int, d: int, heads: int, dim_head: int):
    """(bytes one block needs at the least, bytes a block may have) on the
    current CUDA device; the library reads each device's limit once."""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    rc = _fns()[1](m, c, d, heads, dim_head, ctypes.byref(need),
                   ctypes.byref(limit))
    raise_on_error("fused_attention_smem", rc)
    return need.value, limit.value


def fused_attention(x, ctx, wq, wk, wv, wo, bo, *, heads: int,
                    dim_head: int):
    """y = softmax-attention of x over ctx with the four projections, as the
    JAX ``fused_attention`` computes it; fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise on an input it does not take: one that
    requires grad, another dtype or device, heads · dim_head above
    ``MAX_INNER``, dim_head not in ``HEAD_SIZES``, a last dimension of x or ctx that is not contiguous, or k
    and v of one batch row too large for a block's shared memory."""
    args = {"x": x, "ctx": ctx, "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "bo": bo}
    grads = [name for name, t in args.items() if t.requires_grad]
    if grads:
        raise ValueError(f"fused_attention is forward only: {grads} require "
                         "grad")
    if takes_plain(fused_attention, x):
        return fused_attention_plain(x, ctx, wq, wk, wv, wo, bo, heads=heads,
                                     dim_head=dim_head)
    if x.dim() != 3 or ctx.dim() != 3:
        raise ValueError("fused_attention: x and ctx must be 3-d (B, L, C)")
    b, n, c = x.shape
    m, d = ctx.shape[1:]
    inner = heads * dim_head
    c_out = wo.shape[-1]
    if inner > MAX_INNER:
        raise ValueError(f"fused_attention: heads * dim_head = {inner} "
                         f"exceeds {MAX_INNER}")
    if dim_head not in HEAD_SIZES:
        raise ValueError(f"fused_attention: head size {dim_head} not in "
                         f"{HEAD_SIZES}")
    for name, t, shape in (("x", x, None), ("ctx", ctx, (b, m, d)),
                           ("wq", wq, (c, inner)), ("wk", wk, (d, inner)),
                           ("wv", wv, (d, inner)), ("wo", wo, (inner, c_out)),
                           ("bo", bo, (c_out,))):
        check_cuda_tensor(name, t, x.device, shape)
    if x.stride(2) != 1 or ctx.stride(2) != 1 or bo.stride(0) != 1:
        raise ValueError("fused_attention: x, ctx and bo need a contiguous "
                         "last dimension")
    need, limit = _shared_memory(m, c, d, heads, dim_head)
    if need > limit:
        raise ValueError(
            f"fused_attention: k and v of one batch row (M = {m}, heads * "
            f"dim_head = {inner}) with the x tile (C = {c}) need {need} bytes "
            f"of shared memory, more than the {limit} a block may have")
    # the kernel reads each weight as its transpose with contiguous rows:
    # an (in, out) view whose `in` index is contiguous, as the callers'
    # transposed nn.Linear weights are; others are copied into that layout
    wq, wk, wv, wo = (w if w.stride(0) == 1 else w.t().contiguous().t()
                      for w in (wq, wk, wv, wo))
    y = torch.empty((b, n, c_out), device=x.device)
    strides = (*x.stride()[:2], *ctx.stride()[:2], *y.stride()[:2],
               *wq.stride(), *wk.stride(), *wv.stride(), *wo.stride())
    rc = _fns()[0](x.data_ptr(), ctx.data_ptr(), wq.data_ptr(),
                   wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                   y.data_ptr(), b, n, m, c, d, heads, dim_head, c_out,
                   (ctypes.c_longlong * 14)(*strides), dim_head ** -0.5,
                   launch_stream(x.device))
    raise_on_error("fused_attention", rc)
    fused_attention.launches += 1
    return y


fused_attention.launches = 0
fused_attention.plain_calls = 0
