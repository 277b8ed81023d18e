"""Flash self-attention: the CUDA kernels ``csrc/flash_attention.cu``
(forward, dq, dk/dv) and their plain PyTorch versions.

Counterpart of ``encdiff_tpu/nn/pallas/flash_attention.py``. The forward
returns o and the logsumexp lse, in units of the scaled scores (the scale is
folded into q, as the TPU kernels fold it); ``flash_attention`` is
differentiable through ``_FlashAttention``, which saves q, k, v, o and lse
as ``_flash_core_fwd`` does and runs the dq and dk/dv kernels in its
backward. delta = rowsum(dO ∘ o) is plain PyTorch, as the JAX package
computes it outside its kernels. Layouts: q, k, v (B, H, N, dh) with any
batch / head / row strides and a contiguous last dimension; lse and delta
(B, H, N) contiguous; on CUDA o, dq, dk and dv are views of (B, N, H, dh)
buffers, so that merging the heads costs no copy.
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

#: head sizes the kernels take (csrc/flash_attention.cu)
FWD_HEAD_SIZES = (8, 16, 128)
BWD_HEAD_SIZES = (8, 16, 128)


def flash_attention_fwd_plain(q, k, v, scale: float):
    """(o, lse) in plain PyTorch: the arithmetic of the Pallas
    ``_fwd_kernel`` over one block of all N keys. q, k, v (B, H, N, dh) ->
    o (B, H, N, dh), lse (B, H, N) fp32."""
    qs = q.float() * scale
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _p_and_ds(q, k, v, do, lse, delta, scale):
    qs = q.float() * scale
    p = torch.exp(torch.matmul(qs, k.float().transpose(-1, -2))
                  - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return qs, p, p * (dp - delta[..., None])


def flash_attention_dq_plain(q, k, v, do, lse, delta, scale: float):
    """dq of the Pallas ``_dq_kernel`` in plain PyTorch, from the saved lse
    and delta (B, H, N)."""
    _, _, ds = _p_and_ds(q, k, v, do, lse, delta, scale)
    return torch.matmul(ds, k.float()) * scale


def flash_attention_dkdv_plain(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of the Pallas ``_dkv_kernel`` in plain PyTorch; dk comes
    out scaled through q, as there."""
    qs, p, ds = _p_and_ds(q, k, v, do, lse, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk, dv


@functools.cache
def _fn(name: str, n_ptrs: int):
    fn = getattr(build.load("flash_attention"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * n_ptrs + [i] * 4
                   + [ctypes.POINTER(i), ctypes.c_float, p])
    fn.restype = i
    return fn


def _check(name, sizes, q, k, v, *rest):
    """(b, h, n, dh) after checking the inputs a kernel takes: fp32 on one
    CUDA device, self-attention shapes, a head size it was built for, a
    contiguous last dimension; ``rest`` holds (name, tensor, shape)
    triples."""
    if any(t.dim() != 4 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be 4-d (B, H, N, dh)")
    b, h, n, dh = q.shape
    if dh not in sizes:
        raise ValueError(f"{name}: head size {dh} not in {sizes}")
    check_cuda_tensor("q", q, q.device)
    check_cuda_tensor("k", k, q.device, (b, h, n, dh))
    check_cuda_tensor("v", v, q.device, (b, h, n, dh))
    for tname, t, shape in rest:
        check_cuda_tensor(tname, t, q.device, shape)
        if len(shape) == 3 and not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    return b, h, n, dh


def _heads_view(b, h, n, dh, device):
    return torch.empty((b, n, h, dh), device=device).transpose(1, 2)


def flash_attention_fwd(q, k, v, scale: float):
    """(o, lse) of softmax(q kᵀ·scale) v for self-attention: q, k, v
    (B, H, N, dh), dh in ``FWD_HEAD_SIZES``. CPU tensors take the plain
    version; CUDA tensors launch the forward kernel on the current stream,
    or raise on an input it does not take (among them rows of q, k or v
    that do not start on 16 bytes)."""
    if takes_plain(flash_attention_fwd, q):
        return flash_attention_fwd_plain(q, k, v, scale)
    b, h, n, dh = _check("flash_attention_fwd", FWD_HEAD_SIZES, q, k, v)
    check_rows_aligned("flash_attention_fwd", (("q", q), ("k", k), ("v", v)))
    o = _heads_view(b, h, n, dh, q.device)
    lse = torch.empty((b, h, n), device=q.device)
    strides = head_strides("flash_attention_fwd",
                           (("q", q), ("k", k), ("v", v), ("o", o)))
    rc = _fn("flash_attention_fwd", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, n, dh, (ctypes.c_int * 12)(*strides), scale,
        launch_stream(q.device))
    raise_on_error("flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.plain_calls = 0


def flash_attention_dq(q, k, v, do, lse, delta, scale: float):
    """dq from q, k, v, dO (B, H, N, dh) and the saved lse and delta
    (B, H, N); dh in ``BWD_HEAD_SIZES``. CPU tensors take the plain version;
    CUDA tensors launch the dq kernel, or raise on an input it does not take
    (among them rows of q, k, v or dO that do not start on 16 bytes)."""
    if takes_plain(flash_attention_dq, q):
        return flash_attention_dq_plain(q, k, v, do, lse, delta, scale)
    b, h, n, dh = _check(
        "flash_attention_dq", BWD_HEAD_SIZES, q, k, v,
        ("do", do, q.shape), ("lse", lse, q.shape[:3]),
        ("delta", delta, q.shape[:3]))
    check_rows_aligned("flash_attention_dq",
                       (("q", q), ("k", k), ("v", v), ("do", do)))
    dq = _heads_view(b, h, n, dh, q.device)
    strides = head_strides("flash_attention_dq", (
        ("q", q), ("k", k), ("v", v), ("do", do), ("dq", dq)))
    rc = _fn("flash_attention_dq", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, n, dh,
        (ctypes.c_int * 15)(*strides), scale, launch_stream(q.device))
    raise_on_error("flash_attention_dq", rc)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.plain_calls = 0


def flash_attention_dkdv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) from the same inputs as ``flash_attention_dq``. CPU tensors
    take the plain version; CUDA tensors launch the key-parallel dk/dv
    kernel, or raise, as ``flash_attention_dq`` does."""
    if takes_plain(flash_attention_dkdv, q):
        return flash_attention_dkdv_plain(q, k, v, do, lse, delta, scale)
    b, h, n, dh = _check(
        "flash_attention_dkdv", BWD_HEAD_SIZES, q, k, v,
        ("do", do, q.shape), ("lse", lse, q.shape[:3]),
        ("delta", delta, q.shape[:3]))
    check_rows_aligned("flash_attention_dkdv",
                       (("q", q), ("k", k), ("v", v), ("do", do)))
    dk = _heads_view(b, h, n, dh, q.device)
    dv = _heads_view(b, h, n, dh, q.device)
    strides = head_strides("flash_attention_dkdv", (
        ("q", q), ("k", k), ("v", v), ("do", do), ("dk", dk), ("dv", dv)))
    rc = _fn("flash_attention_dkdv", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        n, dh, (ctypes.c_int * 18)(*strides), scale, launch_stream(q.device))
    raise_on_error("flash_attention_dkdv", rc)
    flash_attention_dkdv.launches += 1
    return dk, dv


flash_attention_dkdv.launches = 0
flash_attention_dkdv.plain_calls = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the saved-lse backward: q, k, v, o and lse
    are saved, as the JAX ``_flash_core_fwd`` saves them. The dq and dk/dv
    kernels' outputs have no ``grad_fn``, so a second order (autograd
    recording inside the backward, ``create_graph``) raises
    ``NotImplementedError`` on the kernel route rather than treating the
    attention's terms as constants; the plain route, which the CPU takes,
    records the plain backward's ops."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if torch.is_grad_enabled() and not plain_route(do):
            raise NotImplementedError(
                "a second derivative through the flash attention "
                "(create_graph) is not ported to the card (ROADMAP queue 1 "
                f"#12); q {tuple(q.shape)}")
        do = kernel_rows(do)
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_attention_dkdv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float):
    """softmax(q kᵀ·scale) v for self-attention, q, k, v (B, H, N, dh):
    the output (B, H, N, dh), on CUDA a view of a (B, N, H, dh) buffer.
    Differentiable: when autograd records, the backward runs the dq and
    dk/dv kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]
