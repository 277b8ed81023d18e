"""Batch-independence penalties on the concept scalars u.

A copy of ``encdiff_tpu/losses/indep.py:47-110`` in PyTorch: ``decorr``
(mean squared off-diagonal batch correlation) and ``hsic`` (mean pairwise
unbiased HSIC with an RBF kernel on per-code standardised scalars; Song et
al., JMLR 2012, eq. 5). Both are pure functions of the (B, U) scalar batch
and differentiable; the unbiased estimator needs B >= 4.
"""

from __future__ import annotations

import torch

INDEP_TYPES = ("decorr", "hsic", "hsic+decorr")


def _standardize(u):
    # 1e-4 floors the per-code std: a dead (near-constant) code standardizes
    # to ~0 instead of amplified float noise with huge std-gradients
    u = u.float()
    mu = u.mean(dim=0, keepdim=True)
    sd = u.std(dim=0, unbiased=False, keepdim=True)
    return (u - mu) / (sd + 1e-4)


def decorr_penalty(u):
    """Mean squared off-diagonal entry of the batch correlation matrix of
    the (B, U) codes."""
    b, d = u.shape
    s = _standardize(u)
    c = (s.t() @ s) / b
    off = c - torch.diag(torch.diag(c))
    return (off ** 2).sum() / (d * (d - 1))


def hsic_penalty(u):
    """Mean pairwise unbiased HSIC between codes: for RBF kernel matrices
    K_i (bandwidth 1, the flagship's) with zeroed diagonals,
    [tr(Ki Kj) + (1'Ki 1)(1'Kj 1)/((m-1)(m-2)) - 2/(m-2) 1'Ki Kj 1]
    / (m (m-3)), over all U(U-1) ordered pairs."""
    b, d = u.shape
    s = _standardize(u)                        # (B, U)
    diff = s[:, None, :] - s[None, :, :]       # (B, B, U)
    k = torch.exp(-0.5 * diff ** 2)
    k = k.permute(2, 0, 1)                     # (U, B, B)
    k = k * (1.0 - torch.eye(b, dtype=k.dtype, device=k.device))
    m = float(b)
    t = torch.einsum("iab,jab->ij", k, k)      # tr(Ki Kj)
    ssum = k.sum(dim=(1, 2))                   # 1'Ki 1
    r = k.sum(dim=2)                           # (U, B): Ki 1
    rr = r @ r.t()                             # 1'Ki Kj 1
    hsic = (t + torch.outer(ssum, ssum) / ((m - 1.0) * (m - 2.0))
            - 2.0 * rr / (m - 2.0)) / (m * (m - 3.0))
    mask = 1.0 - torch.eye(d, dtype=hsic.dtype, device=hsic.device)
    return (hsic * mask).sum() / (d * (d - 1))


def indep_penalty(indep_type: str, u):
    """Dispatch on ``indep_type``; ``u`` is the (B, latent_unit) batch."""
    if indep_type == "decorr":
        return decorr_penalty(u)
    if indep_type == "hsic":
        return hsic_penalty(u)
    if indep_type == "hsic+decorr":
        return hsic_penalty(u) + decorr_penalty(u)
    raise ValueError(f"Unknown indep_type: {indep_type!r} "
                     f"(expected one of {INDEP_TYPES})")
