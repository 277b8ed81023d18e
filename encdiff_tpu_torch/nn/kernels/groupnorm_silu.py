"""GroupNorm (+ FiLM) + SiLU: the CUDA kernels ``csrc/groupnorm_silu.cu``
(forward and backward) and their plain PyTorch versions.

Counterpart of ``encdiff_tpu/nn/pallas/groupnorm_silu.py`` (``gn_silu``, a
Pallas forward whose custom VJP recomputes through the jnp reference), on
NCHW tensors. ``groupnorm_silu`` is differentiable through ``_GNSiLU``, whose
backward is the ``gn_silu_bwd`` kernel: gradients reach x, gamma, beta and
the FiLM rows. Groups are contiguous runs of ``C // groups`` channels;
statistics are fp32 and two-pass (mean, then mean squared deviation) in
every version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


def groupnorm_silu_bwd_plain(g, x, gamma, beta, scale=None, shift=None, *,
                             groups: int = 32, eps: float = 1e-5):
    """(dx, dgamma, dbeta, dscale, dshift) of ``groupnorm_silu_plain`` for
    the cotangent ``g``, in closed form with the kernel's math; dscale and
    dshift are None without FiLM."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(dim=2, keepdim=True) + eps)
    xn = ((xf - mean) * rstd).reshape(b, c, h, w)
    y = xn * gamma[None, :, None, None] + beta[None, :, None, None]
    sc1 = 1.0 if scale is None else 1.0 + scale[:, :, None, None]
    z = y if scale is None else y * sc1 + shift[:, :, None, None]
    sig = torch.sigmoid(z)
    dz = g.float() * sig * (1.0 + z * (1.0 - sig))
    dy = dz * sc1
    dgamma = (dy * xn).sum(dim=(0, 2, 3))
    dbeta = dy.sum(dim=(0, 2, 3))
    dscale = dshift = None
    if scale is not None:
        dscale = (dz * y).sum(dim=(2, 3))
        dshift = dz.sum(dim=(2, 3))
    dxn = (dy * gamma[None, :, None, None]).reshape(b, groups, -1)
    xng = xn.reshape(b, groups, -1)
    dx = rstd * (dxn - dxn.mean(dim=2, keepdim=True)
                 - xng * (dxn * xng).mean(dim=2, keepdim=True))
    return dx.reshape(b, c, h, w).to(x.dtype), dgamma, dbeta, dscale, dshift


#: the kernels' block size, the most floats a thread takes before a group
#: gets more threads, the largest cluster, and the floats of shared memory a
#: block holds beside its groups, forward and backward
#: (csrc/groupnorm_silu.cu)
PLAN_THREADS = 256
PLAN_FLOATS_PER_THREAD = 16
PLAN_MAX_CLUSTER = 8
PLAN_EXTRA_FLOATS = PLAN_THREADS // 32 + 8
PLAN_BWD_EXTRA_FLOATS = PLAN_THREADS + 66


class GNSiLUPlan(NamedTuple):
    """How a kernel runs one shape: ``team`` threads take a group,
    ``per_block`` groups share a block, a group spans ``cluster`` blocks of
    a thread-block cluster, each staging ``slice`` floats of it (of x, and
    in the backward of the gradient too) in ``smem`` bytes of shared memory;
    ``blocks`` is the grid."""
    team: int
    per_block: int
    cluster: int
    slice: int
    smem: int
    blocks: int


def gn_silu_plan(B: int, C: int, HW: int, G: int,
                 smem_bytes: int) -> GNSiLUPlan:
    """The forward kernel's plan (``gn_silu_fwd_plan`` in
    csrc/groupnorm_silu.cu, which the card tests hold to this copy) for x
    (B, C, HW) in G groups and ``smem_bytes`` of shared memory a block may
    use: the fewest threads a group (32 to 256) that give each at most 16
    floats, and the smallest cluster of 1, 2, 4 or 8 blocks whose slices of
    a group fit. Raises ValueError where even 8 blocks do not."""
    return _plan(B, C, HW, G, smem_bytes, bwd=False)


def gn_silu_bwd_plan(B: int, C: int, HW: int, G: int,
                     smem_bytes: int) -> GNSiLUPlan:
    """The backward kernel's plan (``gn_silu_bwd_plan`` in
    csrc/groupnorm_silu.cu): the forward's team rule, with x and the
    gradient both staged, and the smallest cluster whose blocks fit two an
    SM (``smem_bytes // 2`` each); only where none does, the smallest that
    fits ``smem_bytes``. The VQ decoder's 65,536-float groups (512 KB of
    x + g) run on clusters of 8 blocks of 64 KB."""
    return _plan(B, C, HW, G, smem_bytes, bwd=True)


def _plan(B, C, HW, G, smem_bytes, bwd):
    cg = C // G
    n = cg * HW
    team = 32
    while team < PLAN_THREADS and team * PLAN_FLOATS_PER_THREAD < n:
        team *= 2
    per_block = PLAN_THREADS // team
    for target in ((smem_bytes // 2, smem_bytes) if bwd else (smem_bytes,)):
        cluster = 1
        while cluster <= PLAN_MAX_CLUSTER:
            slice_ = (-(-n // cluster) + 3) // 4 * 4
            if bwd:
                smem = 4 * (per_block * 2 * slice_ + PLAN_BWD_EXTRA_FLOATS)
            else:
                smem = 4 * (per_block * (slice_ + 2 * cg) + PLAN_EXTRA_FLOATS)
            if smem <= target:
                blocks = -(-B * G // per_block) * cluster
                return GNSiLUPlan(team, per_block, cluster, slice_, smem,
                                  blocks)
            cluster *= 2
    raise ValueError(f"groupnorm_silu: a group of {n} floats does not fit "
                     f"{PLAN_MAX_CLUSTER} blocks of {smem_bytes} bytes")


@functools.cache
def _plan_fn(name: str):
    fn = getattr(build.load("groupnorm_silu"), name)
    i = ctypes.c_int
    fn.argtypes = [i, i, i, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = i
    return fn


def kernel_plan(C: int, HW: int, G: int, smem_bytes: int, bwd: bool = False):
    """The CUDA source's own plan (team, per_block, cluster, slice, smem) of
    the forward (or with ``bwd`` the backward) at a shape, for comparison
    with ``gn_silu_plan`` (``gn_silu_bwd_plan``) on the card; None where it
    refuses the shape."""
    out = (ctypes.c_longlong * 5)()
    name = "gn_silu_bwd_plan" if bwd else "gn_silu_fwd_plan"
    rc = _plan_fn(name)(C, HW, G, smem_bytes, out)
    return None if rc else tuple(out)


@functools.cache
def _fn():
    fn = build.load("groupnorm_silu").gn_silu_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _bwd_fn():
    fn = build.load("groupnorm_silu").gn_silu_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 13 + [i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn


class _GNSiLU(torch.autograd.Function):
    """``groupnorm_silu`` with the ``gn_silu_bwd`` backward; saves the
    inputs, as the JAX custom VJP does, and recomputes the statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, gamma, beta, scale, shift)
        return _groupnorm_silu_fwd(x, gamma, beta, scale, shift, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, scale, shift = ctx.saved_tensors
        # the kernel reads g contiguous; autograd may hand over any layout
        # (the expanded all-stride-0 gradient of out.sum())
        grads = gn_silu_bwd(g.contiguous(), x, gamma, beta, scale, shift,
                            groups=ctx.groups, eps=ctx.eps)
        return (*grads, None, None)


def _check_inputs(name, x, gamma, beta, scale, shift, groups):
    """Raise unless the tensors are what the CUDA kernels take: x contiguous
    fp32 (B, C, H, W), gamma and beta (C,), FiLM rows (B, C) or both None,
    all contiguous and on x's device."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (B, C, H, W), "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"{name}: C={c} not divisible by {groups}")
    check_cuda_tensor("x", x, x.device)
    check_cuda_tensor("gamma", gamma, x.device, (c,))
    check_cuda_tensor("beta", beta, x.device, (c,))
    if (scale is None) != (shift is None):
        raise ValueError(f"{name}: pass both scale and shift, or neither")
    if scale is not None:
        for tname, t in (("scale", scale), ("shift", shift)):
            check_cuda_tensor(tname, t, x.device, (b, c))
            if not t.is_contiguous():
                raise ValueError(f"{name}: {tname} must be contiguous")
    if not (gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError(f"{name}: gamma and beta must be contiguous")


def groupnorm_silu(x, gamma, beta, scale=None, shift=None, *,
                   groups: int = 32, eps: float = 1e-5):
    """SiLU(FiLM(GroupNorm(x))). x: (B, C, H, W) contiguous fp32; gamma,
    beta: (C,); scale, shift: (B, C) contiguous, or both None.
    Differentiable: when autograd records, the backward runs
    ``gn_silu_bwd``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise on an input it does not take."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, beta, scale, shift)):
        return _GNSiLU.apply(x, gamma, beta, scale, shift, groups, eps)
    return _groupnorm_silu_fwd(x, gamma, beta, scale, shift, groups, eps)


def _groupnorm_silu_fwd(x, gamma, beta, scale, shift, groups, eps):
    if takes_plain(groupnorm_silu, x):
        return groupnorm_silu_plain(x, gamma, beta, scale, shift,
                                    groups=groups, eps=eps)
    _check_inputs("groupnorm_silu", x, gamma, beta, scale, shift, groups)
    b, c, h, w = x.shape
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


def gn_silu_bwd(g, x, gamma, beta, scale=None, shift=None, *,
                groups: int = 32, eps: float = 1e-5):
    """(dx, dgamma, dbeta, dscale, dshift) of ``groupnorm_silu`` for the
    cotangent ``g`` (B, C, H, W), contiguous like x; dscale and dshift are
    None without FiLM.

    CPU tensors take the plain version; CUDA tensors launch the kernels of
    ``gn_silu_bwd`` on the current stream, or raise on an input they do
    not take."""
    if takes_plain(gn_silu_bwd, x):
        return groupnorm_silu_bwd_plain(g, x, gamma, beta, scale, shift,
                                        groups=groups, eps=eps)
    _check_inputs("gn_silu_bwd", x, gamma, beta, scale, shift, groups)
    check_cuda_tensor("g", g, x.device, x.shape)
    if not g.is_contiguous():
        raise ValueError(f"gn_silu_bwd: the gradient must be contiguous, "
                         f"strides {g.stride()}")
    b, c, h, w = x.shape
    film = scale is not None
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    dscale = torch.empty_like(scale) if film else None
    dshift = torch.empty_like(shift) if film else None
    parts = torch.empty((2, b, c), device=x.device)  # dgamma, dbeta per sample
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _bwd_fn()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   ptr(scale), ptr(shift), g.data_ptr(), dx.data_ptr(),
                   dgamma.data_ptr(), dbeta.data_ptr(), ptr(dscale),
                   ptr(dshift), parts[0].data_ptr(), parts[1].data_ptr(),
                   b, c, h * w, groups, eps, launch_stream(x.device))
    raise_on_error("gn_silu_bwd", rc)
    gn_silu_bwd.launches += 1
    return dx, dgamma, dbeta, dscale, dshift


gn_silu_bwd.launches = 0
gn_silu_bwd.plain_calls = 0
