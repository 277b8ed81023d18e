"""softmax(q kᵀ·scale) v: the CUDA kernel ``csrc/attention_core.cu`` and its
plain PyTorch version.

Counterpart of ``encdiff_tpu/nn/pallas/attention.py`` (``attention_core``),
forward only. The projections around it stay in PyTorch, as the JAX package
left them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from encdiff_tpu_torch.nn.kernels import (build, check_cuda_tensor,
                                          launch_stream, raise_on_error,
                                          takes_plain)

#: head sizes the kernel takes (csrc/attention_core.cu, attention_core_fwd)
HEAD_SIZES = (8, 16, 32, 64, 128)
_INT_MAX = 2**31 - 1


def attention_core_plain(q, k, v, scale: float):
    """fp32 scores and softmax in plain PyTorch: q (B, H, N, dh),
    k and v (B, H, M, dh) -> (B, H, N, dh)."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(sim, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


@functools.cache
def _fn():
    fn = build.load("attention_core").attention_core_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p] + [i] * 17 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def attention_core(q, k, v, scale: float):
    """softmax(q kᵀ·scale) v. q: (B, H, N, dh); k, v: (B, H, M, dh); fp32,
    any batch / head / row strides, last dimension contiguous. Returns
    (B, H, N, dh), on CUDA as a view of a (B, N, H, dh) buffer so that
    merging the heads back costs no copy.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise on an input it does not take."""
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
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"attention_core: {name} needs a contiguous last "
                             f"dimension, strides {t.stride()}")
        if max(t.stride()) > _INT_MAX:
            raise ValueError(f"attention_core: {name} strides exceed int32")
        strides += t.stride()[:3]
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, h, n, m, dh, *strides, scale, launch_stream(q.device))
    raise_on_error("attention_core_fwd", rc)
    attention_core.launches += 1
    return out


attention_core.launches = 0
attention_core.plain_calls = 0
