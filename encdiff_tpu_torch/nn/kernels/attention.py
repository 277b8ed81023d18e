"""softmax(q kᵀ·scale) v: the CUDA kernels ``csrc/attention_core.cu``
(forward and backward) and their plain PyTorch versions.

Counterpart of ``encdiff_tpu/nn/pallas/attention.py`` (``attention_core``
and its custom VJP): ``attention_core`` is differentiable through
``_AttentionCore``, whose backward is the recompute-P kernel. When autograd
records inside that backward (``create_graph=True``: the MCL losses
differentiate the frozen decoder's mid-block attention twice), the backward
runs as ``_AttentionCoreBwd``: the same kernel's values, and a backward
written in PyTorch ops (``attention_core_bwd_vjp``), which the JAX package
takes from XLA's autodiff of its VJP. When autograd records inside that
backward too (``fisher_sm``'s Hutchinson divergence: a third order), it
records those ops, which keep their graph. On the plain route (CPU tensors,
``plain_path()``) autograd records the plain backward's own ops instead.
The projections around it stay in PyTorch, as the JAX package left them to
XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from encdiff_tpu_torch.nn.kernels import (build, check_cuda_tensor,
                                          check_rows_aligned, head_strides,
                                          kernel_rows, launch_stream,
                                          plain_route, raise_on_error,
                                          takes_plain)

#: head sizes the kernels take (csrc/attention_core.cu), forward and backward
HEAD_SIZES = (8, 16, 32, 64, 128)
BWD_HEAD_SIZES = HEAD_SIZES


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
    fn.argtypes = ([p] * 8 + [ctypes.c_longlong] + [i] * 5
                   + [ctypes.POINTER(i), ctypes.c_float, p])
    fn.restype = i
    return fn


@functools.cache
def _scratch_fn():
    fn = build.load("attention_core").attention_core_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn


def attention_core_bwd_vjp(q, k, v, do, dq_bar, dk_bar, dv_bar,
                           scale: float):
    """The gradients (of q, k, v, do) of <dq_bar, dq> + <dk_bar, dk> +
    <dv_bar, dv>, where (dq, dk, dv) = ``attention_core_bwd(q, k, v, do)``:
    the backward of the attention backward, in PyTorch ops (matmuls and a
    softmax) on any device. No TPU kernel computes it: the JAX package
    takes it from XLA's autodiff of its VJP. The MCL step runs it once, at
    the VQ decoder's (B, 1, 256, 256, 128).

    With S = scale q kᵀ, P = softmax(S) by rows, dP = do vᵀ, D =
    rowsum(P ∘ dP) and dS = P ∘ (dP - D), the backward is dq = scale dS k,
    dk = scale dSᵀ q, dv = Pᵀ do. Its scalar is <dS, W> + <P, do dv_barᵀ>
    with W = scale (dq_bar kᵀ + q dk_barᵀ); with E = rowsum(P ∘ W):

    - through dS, dP gets dP̄ = P ∘ (W - E) and P gets (dP - D) ∘ W - E dP;
      with <P, do dv_barᵀ>, P̄ = (dP - D) ∘ W - E dP + do dv_barᵀ, and
      through the softmax S̄ = P ∘ (P̄ - rowsum(P ∘ P̄));
    - q: scale (S̄ k + dS dk_bar)   (S, and dk = scale dSᵀ q);
    - k: scale (S̄ᵀ q + dSᵀ dq_bar) (S, and dq = scale dS k);
    - v: dP̄ᵀ do                    (dP = do vᵀ);
    - do: dP̄ v + P dv_bar          (dP, and dv = Pᵀ do).

    Counted in ``attention_core_bwd_vjp.calls``."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(do, v.transpose(-1, -2))
    dpc = dp - (p * dp).sum(dim=-1, keepdim=True)       # dP - D
    ds = p * dpc
    w = scale * (torch.matmul(dq_bar, k.transpose(-1, -2))
                 + torch.matmul(q, dk_bar.transpose(-1, -2)))
    e = (p * w).sum(dim=-1, keepdim=True)
    dp_bar = p * (w - e)
    p_bar = dpc * w - e * dp + torch.matmul(do, dv_bar.transpose(-1, -2))
    s_bar = p * (p_bar - (p * p_bar).sum(dim=-1, keepdim=True))
    gq = scale * (torch.matmul(s_bar, k) + torch.matmul(ds, dk_bar))
    gk = scale * (torch.matmul(s_bar.transpose(-1, -2), q)
                  + torch.matmul(ds.transpose(-1, -2), dq_bar))
    gv = torch.matmul(dp_bar.transpose(-1, -2), do)
    gdo = torch.matmul(dp_bar, v) + torch.matmul(p, dv_bar)
    attention_core_bwd_vjp.calls += 1
    return gq, gk, gv, gdo


attention_core_bwd_vjp.calls = 0


class _AttentionCore(torch.autograd.Function):
    """``attention_core`` with the recompute-P backward: only q, k and v are
    saved, as the JAX custom VJP saves them. When autograd records inside
    the backward (``create_graph``), the backward is ``_AttentionCoreBwd``:
    the same kernel, differentiable once more; on the plain route autograd
    records the plain backward's ops."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _attention_core_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled() and not plain_route(do):
            dq, dk, dv = _AttentionCoreBwd.apply(*ctx.saved_tensors, do,
                                                 ctx.scale)
        else:
            dq, dk, dv = _attention_bwd(*ctx.saved_tensors, do, ctx.scale)
        return dq, dk, dv, None


def _attention_bwd(q, k, v, do, scale):
    # the backward kernels read rows 16 bytes at a time; the forward took
    # any rows, and the cotangent is whatever autograd hands over
    q, k, v, do = (kernel_rows(t) for t in (q, k, v, do))
    return attention_core_bwd(q, k, v, do, scale)


class _AttentionCoreBwd(torch.autograd.Function):
    """The attention backward as a differentiable function of (q, k, v,
    do): its values from ``attention_core_bwd``, its backward
    ``attention_core_bwd_vjp``. When autograd records inside this backward
    (the Hutchinson divergence of ``fisher_sm``: a third order), it records
    the VJP's PyTorch ops on the saved q, k, v and do, so that every higher
    order follows from them."""

    @staticmethod
    def forward(ctx, q, k, v, do, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, do)
        return _attention_bwd(q, k, v, do, scale)

    @staticmethod
    def backward(ctx, dq_bar, dk_bar, dv_bar):
        q, k, v, do = ctx.saved_tensors
        return (*attention_core_bwd_vjp(q, k, v, do, dq_bar, dk_bar, dv_bar,
                                        ctx.scale), None)


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
    dh). Same layout rules as the forward, and on CUDA the rows of q, k, v
    and do must start on 16 bytes; on CUDA the gradients are views of
    (B, L, H, dh) buffers, like the forward's output.

    CPU tensors take the plain version; CUDA tensors launch the kernels of
    ``attention_core_bwd`` on the current stream, or raise on an input they
    do not take."""
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
    strides = head_strides("attention_core_bwd", (
        ("q", q), ("k", k), ("v", v), ("do", do), ("dq", dq), ("dk", dk),
        ("dv", dv)))
    check_rows_aligned("attention_core_bwd", (("q", q), ("k", k), ("v", v),
                                              ("do", do)))
    # the logsumexp and delta of every row, and where dk/dv splits its
    # query rows over blocks, their partial sums
    size = _scratch_fn()(b, h, n, m, dh)
    if size < 0:
        raise ValueError(f"attention_core_bwd: shape {(b, h, n, m, dh)} "
                         "not taken")
    scratch = torch.empty(size, device=q.device)
    c_strides = (ctypes.c_int * len(strides))(*strides)
    rc = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   scratch.data_ptr(), size, b, h, n, m, dh, c_strides, scale,
                   launch_stream(q.device))
    raise_on_error("attention_core_bwd", rc)
    attention_core_bwd.launches += 1
    return dq, dk, dv


attention_core_bwd.launches = 0
attention_core_bwd.plain_calls = 0
