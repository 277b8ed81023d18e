"""Logistic regression: sklearn's ``LogisticRegression()`` at its defaults,
with the loss and its gradient in torch on the device of the data.

The JAX package's β-VAE metric fits ``linear_model.LogisticRegression(
random_state=...)`` (``encdiff_tpu/evalx/metrics/beta_vae.py:49``): L2
with C 1, an intercept, the multinomial loss for three classes or more and
the binomial one for two, lbfgs with ``max_iter`` 100 and ``tol`` 1e-4. As
sklearn 1.9's ``linear_model/_logistic.py`` (``_logistic_regression_path``)
and ``_linear_loss.py`` (``LinearModelLoss.loss_gradient``) do, the
objective is the mean pointwise loss plus ``0.5 / (C n) ||w||^2`` (the
intercept unpenalised), minimised by ``scipy.optimize.minimize(method=
"L-BFGS-B")`` from zeros with sklearn's options (``maxiter`` 100, ``maxls``
50, ``gtol`` tol, ``ftol`` 64 eps). The coefficients are laid out as
sklearn's (classes of one feature contiguous). ``random_state`` is
accepted and unused, as lbfgs draws nothing.

Everything runs in float64. sklearn keeps float32 input in float32; on
float64 input the two minimise the same function.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from encdiff_tpu_torch.evalx.metrics.gbt import _exp

C = 1.0
TOL = 1e-4
MAX_ITER = 100


class LogisticRegression:
    """``sklearn.linear_model.LogisticRegression`` (lbfgs, L2), fitted on
    ``device``."""

    def __init__(self, random_state=None, device="cpu"):
        self.random_state = random_state
        self.device = device

    def _x(self, X) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X, np.float64) if not isinstance(
            X, torch.Tensor) else X).to(torch.device(self.device),
                                        torch.float64)

    def fit(self, X, y):
        x = self._x(X)
        y = np.asarray(y).ravel()
        self.classes_, enc = np.unique(y, return_inverse=True)
        K = len(self.classes_)
        if K < 2:
            raise ValueError(f"needs samples of at least 2 classes, got {K}")
        n, d = x.shape
        l2 = 1.0 / (C * n)
        dev = x.device
        if K == 2:
            target = torch.from_numpy((enc == 1).astype(np.float64)).to(dev)
            w0 = np.zeros(d + 1)
            func = lambda w: _binomial(w, x, target, l2)  # noqa: E731
        else:
            onehot = torch.zeros(n, K, dtype=torch.float64, device=dev)
            onehot[torch.arange(n, device=dev),
                   torch.from_numpy(enc).to(dev)] = 1.0
            w0 = np.zeros(K * (d + 1))
            func = lambda w: _multinomial(w, x, onehot, l2)  # noqa: E731
        res = scipy.optimize.minimize(
            func, w0, method="L-BFGS-B", jac=True,
            options={"maxiter": MAX_ITER, "maxls": 50, "gtol": TOL,
                     "ftol": 64 * np.finfo(float).eps})
        if K == 2:
            self.coef_ = res.x[None, :-1]
            self.intercept_ = res.x[-1:]
        else:
            w = res.x.reshape((K, -1), order="F")
            self.coef_ = w[:, :-1].copy()
            self.intercept_ = w[:, -1].copy()
        return self

    def _scores(self, X) -> torch.Tensor:
        x = self._x(X)
        coef = torch.from_numpy(self.coef_).to(x.device)
        scores = x @ coef.T + torch.from_numpy(self.intercept_).to(x.device)
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, X) -> np.ndarray:
        scores = self._scores(X)
        idx = (scores > 0).long() if scores.ndim == 1 else scores.argmax(1)
        return self.classes_[idx.cpu().numpy()]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y).ravel()))


def _binomial(w, x, target, l2):
    """``LinearModelLoss.loss_gradient`` over ``HalfBinomialLoss``: the
    Cython loss's four branches of log(1 + exp(raw))."""
    n, d = x.shape
    wt = torch.from_numpy(w).to(x.device)
    weights, intercept = wt[:-1], wt[-1]
    raw = x @ weights + intercept
    y = target
    lo = raw <= -37
    mid = (raw > -37) & (raw <= -2)
    hi = raw > 18
    e_pos = _exp(torch.where(raw <= -2, raw, 0.0))
    e_neg = _exp(torch.where(raw > -2, -raw, 0.0))
    loss = torch.where(
        lo, e_pos - y * raw,
        torch.where(mid, torch.log1p(e_pos) - y * raw,
                    torch.where(hi, e_neg + (1 - y) * raw,
                                torch.log1p(e_neg) + (1 - y) * raw)))
    grad = torch.where(
        lo, e_pos - y,
        torch.where(raw <= -2, ((1 - y) * e_pos - y) / (1 + e_pos),
                    ((1 - y) - y * e_neg) / (1 + e_neg)))
    value = float(loss.sum() / n) + float(0.5 * l2 * (weights @ weights))
    grad = grad / n
    out = torch.empty(d + 1, dtype=torch.float64, device=x.device)
    out[:d] = x.T @ grad + l2 * weights
    out[d] = grad.sum()
    return value, out.cpu().numpy()


def _multinomial(w, x, onehot, l2):
    """``LinearModelLoss.loss_gradient`` over ``HalfMultinomialLoss``:
    log-sum-exp less the true class's raw prediction; the gradient
    softmax less the one-hot, per sample then through X."""
    n, d = x.shape
    K = onehot.shape[1]
    wt = torch.from_numpy(w.reshape((K, d + 1), order="F").copy()).to(
        x.device)
    weights, intercept = wt[:, :d], wt[:, d]
    raw = x @ weights.T + intercept
    top = raw.amax(1, keepdim=True)
    e = _exp(raw - top)
    sum_exps = e.cumsum(1)[:, -1:]
    loss = (torch.log(sum_exps) + top)[:, 0] - (raw * onehot).sum(1)
    grad = (e / sum_exps - onehot) / n
    value = float(loss.sum() / n) + float(
        0.5 * l2 * (weights.reshape(-1) @ weights.reshape(-1)))
    out = torch.empty(K, d + 1, dtype=torch.float64, device=x.device)
    out[:, :d] = grad.T @ x + l2 * weights
    out[:, d] = grad.sum(0)
    return value, out.cpu().numpy().ravel(order="F")
