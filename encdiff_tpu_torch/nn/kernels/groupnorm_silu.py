"""GroupNorm (+ FiLM) + SiLU: the CUDA kernel ``csrc/groupnorm_silu.cu`` and
its plain PyTorch version.

Counterpart of ``encdiff_tpu/nn/pallas/groupnorm_silu.py``
(``groupnorm_silu``), forward only, on NCHW tensors. Groups are contiguous
runs of ``C // groups`` channels; statistics are fp32 and two-pass (mean,
then mean squared deviation) in both versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from encdiff_tpu_torch.nn.kernels import (build, check_cuda_tensor,
                                          launch_stream, raise_on_error,
                                          takes_plain)


def groupnorm_silu_plain(x, gamma, beta, scale=None, shift=None, *,
                         groups: int = 32, eps: float = 1e-5):
    """SiLU(FiLM(GroupNorm(x))) in plain PyTorch. x: (B, C, H, W);
    gamma, beta: (C,); scale, shift: (B, C) or None."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=2, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    y = xn * gamma[None, :, None, None] + beta[None, :, None, None]
    if scale is not None:
        y = y * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]
    return (y * torch.sigmoid(y)).to(x.dtype)


@functools.cache
def _fn():
    fn = build.load("groupnorm_silu").gn_silu_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn


def groupnorm_silu(x, gamma, beta, scale=None, shift=None, *,
                   groups: int = 32, eps: float = 1e-5):
    """SiLU(FiLM(GroupNorm(x))). x: (B, C, H, W) contiguous fp32; gamma,
    beta: (C,); scale, shift: (B, C) contiguous, or both None.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise on an input it does not take."""
    if takes_plain(groupnorm_silu, x):
        return groupnorm_silu_plain(x, gamma, beta, scale, shift,
                                    groups=groups, eps=eps)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"groupnorm_silu: x must be contiguous (B, C, H, W), "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"groupnorm_silu: C={c} not divisible by {groups}")
    check_cuda_tensor("x", x, x.device)
    check_cuda_tensor("gamma", gamma, x.device, (c,))
    check_cuda_tensor("beta", beta, x.device, (c,))
    if (scale is None) != (shift is None):
        raise ValueError("groupnorm_silu: pass both scale and shift, or neither")
    if scale is not None:
        for name, t in (("scale", scale), ("shift", shift)):
            check_cuda_tensor(name, t, x.device, (b, c))
            if not t.is_contiguous():
                raise ValueError(f"groupnorm_silu: {name} must be contiguous")
    if not (gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("groupnorm_silu: gamma and beta must be contiguous")
    out = torch.empty_like(x)
    film = scale is not None
    rc = _fn()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
               scale.data_ptr() if film else None,
               shift.data_ptr() if film else None,
               out.data_ptr(), b, c, h * w, groups, eps,
               launch_stream(x.device))
    raise_on_error("gn_silu_fwd", rc)
    groupnorm_silu.launches += 1
    return out


groupnorm_silu.launches = 0
groupnorm_silu.plain_calls = 0
