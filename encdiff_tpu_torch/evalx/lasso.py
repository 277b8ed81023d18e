"""Lasso: sklearn's ``Lasso(alpha=0.1)`` in torch, float64, on ``device``.

UDR's correlation matrix is ``|Lasso(alpha=0.1).fit(z_i, z_j).coef_|``
(``encdiff_tpu/evalx/udr.py:74-92``). sklearn 1.9 (``linear_model/
_coordinate_descent.py``, ``_cd_fast.pyx:enet_coordinate_descent``) fits
it as follows:

* ``X`` and every target column are centred (the intercept), and each
  target column gets a fit of its own;
* cyclic coordinate descent minimises ``0.5 ||y - X w||^2 + a ||w||_1``
  with ``a = alpha n``;
* each sweep is followed by a duality-gap check when its largest update is
  at most ``tol`` (1e-4) of the largest coefficient (or at its last
  sweep), and the fit stops when the gap is at most ``tol ||y||^2``;
* the gap-safe screening rule drops features at the start and after each
  check (they stay dropped), and ``max_iter`` is 1000 sweeps.

Here the target columns' fits run together: one coordinate's update is one
step over every column still fitting, each with its own active set and its
own stop. Dot products are torch's, so the result equals sklearn's within
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHA = 0.1
TOL = 1e-4
MAX_ITER = 1000


class Lasso:
    """``sklearn.linear_model.Lasso`` (cyclic, dense, no warm start)."""

    def __init__(self, alpha=ALPHA, tol=TOL, max_iter=MAX_ITER,
                 device="cpu"):
        self.alpha, self.tol, self.max_iter = alpha, tol, max_iter
        self.device = torch.device(device)

    def fit(self, X, y):
        x = torch.as_tensor(np.asarray(X, np.float64)).to(self.device)
        y = np.asarray(y, np.float64)
        single = y.ndim == 1
        yt = torch.as_tensor(y.reshape(len(y), -1)).to(self.device)
        x_offset, y_offset = x.mean(0), yt.mean(0)
        coef, self.dual_gap_, self.n_iter_ = coordinate_descent(
            x - x_offset, (yt - y_offset).T.contiguous(),
            self.alpha * x.shape[0], self.tol, self.max_iter)
        intercept = y_offset - coef @ x_offset
        self.coef_ = coef.cpu().numpy()
        self.intercept_ = intercept.cpu().numpy()
        if single:
            self.coef_, self.intercept_ = self.coef_[0], self.intercept_[0]
        return self


def _gap(x, y, w, r, a):
    """``gap_enet`` (beta 0): the duality gap of every target and its
    dual norm ``max |X^T R|``."""
    xta = r @ x                                                # (T, F)
    dual_norm = xta.abs().amax(1)
    r_norm2 = (r * r).sum(1)
    ry = (r * y).sum(1)
    primal = 0.5 * r_norm2 + a * w.abs().sum(1)
    scale = torch.where(dual_norm > a, a / dual_norm,
                        torch.ones_like(dual_norm))
    dual = -0.5 * scale ** 2 * r_norm2 + scale * ry
    return primal - dual, xta, dual_norm


def _screen(x_norm2, xta, dual_norm, gap, a, keep):
    """The gap-safe rule over the features still in ``keep``: a feature
    stays when (1 - |X_j^T theta|) / ||X_j|| <= sqrt(2 gap) / a."""
    theta = xta / torch.clamp(dual_norm, min=a)[:, None]
    d = (1 - theta.abs()) / torch.sqrt(x_norm2)[None, :]
    return keep & (d <= (torch.sqrt(2 * gap) / a)[:, None])


def coordinate_descent(x, y, a, tol, max_iter):
    """Minimise ``0.5 ||y_t - x w_t||^2 + a ||w_t||_1`` for each row y_t of
    ``y`` (targets, samples) over centred ``x`` (samples, features).
    Returns (w (targets, features), the final gaps, the sweeps of each)."""
    T, F = y.shape[0], x.shape[1]
    dev = x.device
    x_norm2 = (x * x).sum(0)
    w = torch.zeros(T, F, dtype=torch.float64, device=dev)
    r = y.clone()
    d_w_tol = tol
    tol_t = tol * (y * y).sum(1)
    gap, xta, dual_norm = _gap(x, y, w, r, a)
    done = gap <= tol_t
    n_iter = torch.zeros(T, dtype=torch.long, device=dev)
    keep = (x_norm2 != 0)[None, :].expand(T, F).clone()
    keep = _screen(x_norm2, xta, dual_norm, gap, a, keep)
    # a dropped feature's weight is 0 from the start (w = 0)
    for it in range(max_iter):
        if bool(done.all()):
            break
        live = ~done
        w_max = torch.zeros(T, dtype=torch.float64, device=dev)
        d_w_max = torch.zeros_like(w_max)
        for j in range(F):
            upd = keep[:, j] & live
            w_j = w[:, j]
            tmp = r @ x[:, j] + w_j * x_norm2[j]
            new = torch.sign(tmp) * torch.clamp(tmp.abs() - a, min=0) / \
                x_norm2[j]
            new = torch.where(upd, new, w_j)
            r = r + (w_j - new)[:, None] * x[:, j][None, :]
            d_w_max = torch.maximum(d_w_max, (new - w_j).abs())
            w_max = torch.where(upd, torch.maximum(w_max, new.abs()), w_max)
            w[:, j] = new
        n_iter = torch.where(live, it + 1, n_iter)
        check = live & ((w_max == 0) | (d_w_max / w_max <= d_w_tol)
                        | (it == max_iter - 1))
        if not bool(check.any()):
            continue
        g, xta, dual_norm = _gap(x, y, w, r, a)
        gap = torch.where(check, g, gap)
        stop = check & (g <= tol_t)
        done = done | stop
        rescreen = check & ~stop
        kept = _screen(x_norm2, xta, dual_norm, g, a, keep)
        dropped = rescreen[:, None] & keep & ~kept
        # a dropped feature gives its part of the fit back to the residual
        r = r + (torch.where(dropped, w, torch.zeros_like(w)) @ x.T)
        w = torch.where(dropped, torch.zeros_like(w), w)
        keep = torch.where(rescreen[:, None], kept, keep)
    return w, gap.cpu().numpy(), n_iter.cpu().numpy()
