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

The fit keeps the input's dtype, as sklearn does. Float64 input runs in
float64. Float32 input follows sklearn's float32 path:

* the starting point is float32 zeros, so scipy's ``ScalarFunction``
  hands the loss float32 coefficients at every call;
* the raw predictions are float32 products of float32 ``X`` and the
  coefficients;
* each sample's loss and gradient are computed in double from those
  float32 values (the Cython losses; torch's exp, whose last bit of a
  double does not reach the float32 it is stored as) and stored as
  float32 (the
  multinomial one keeps its exponentials, their sum, the division and the
  true class's subtraction in float32, as ``CyHalfMultinomialLoss`` does);
* the mean loss is a float32 sum, and the penalty and the gradient are
  float32;
* ``coef_`` and ``intercept_`` are float32.

On the CPU the products and sums of that path are numpy's own calls on the
arrays sklearn builds, so the fit equals sklearn's; on the card they are
torch's, which round otherwise. Torch's calls on the CPU would not do
there: on ``tests/test_torch_posthoc_repairs.py``'s 500 float32 points of
5 classes they leave the intercepts 2.8e-6 from sklearn's (coefficients
8.9e-7, probabilities 8.6e-7), outside that test's 1e-6, where numpy's
calls land on sklearn's exactly.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import scipy.special
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

    def _x(self, X, dtype=None) -> torch.Tensor:
        if dtype is None:
            dtype = (torch.float32 if getattr(X, "dtype", None) in (
                np.float32, torch.float32) else torch.float64)
        if not isinstance(X, torch.Tensor):
            X = torch.from_numpy(np.ascontiguousarray(
                X, np.float32 if dtype == torch.float32 else np.float64))
        return X.to(torch.device(self.device), dtype).contiguous()

    def fit(self, X, y):
        x = self._x(X)
        y = np.asarray(y).ravel()
        self.classes_, enc = np.unique(y, return_inverse=True)
        K = len(self.classes_)
        if K < 2:
            raise ValueError(f"needs samples of at least 2 classes, got {K}")
        n, d = x.shape
        l2 = 1.0 / (C * n)
        dev, dt = x.device, x.dtype
        f32 = dt == torch.float32
        if K == 2:
            target = torch.from_numpy((enc == 1).astype(
                np.float32 if f32 else np.float64)).to(dev)
            w0 = np.zeros(d + 1, np.float32 if f32 else np.float64)
            func = ((lambda w: _binomial32(w, x, target, l2)) if f32 else
                    (lambda w: _binomial(w, x, target, l2)))
        else:
            onehot = torch.zeros(n, K, dtype=dt, device=dev)
            onehot[torch.arange(n, device=dev),
                   torch.from_numpy(enc).to(dev)] = 1.0
            w0 = np.zeros(K * (d + 1), np.float32 if f32 else np.float64)
            func = ((lambda w: _multinomial32(w, x, onehot, l2)) if f32 else
                    (lambda w: _multinomial(w, x, onehot, l2)))
        res = scipy.optimize.minimize(
            func, w0, method="L-BFGS-B", jac=True,
            options={"maxiter": MAX_ITER, "maxls": 50, "gtol": TOL,
                     "ftol": 64 * np.finfo(float).eps})
        out = np.float32 if f32 else np.float64
        if K == 2:
            self.coef_ = res.x[None, :-1].astype(out)
            self.intercept_ = res.x[-1:].astype(out)
        else:
            w = res.x.reshape((K, -1), order="F")
            self.coef_ = w[:, :-1].astype(out)
            self.intercept_ = w[:, -1].astype(out)
        return self

    def decision_function(self, X) -> torch.Tensor:
        """``X @ coef_.T + intercept_`` in the coefficients' dtype, (n,)
        for two classes, else (n, K)."""
        dt = torch.float32 if self.coef_.dtype == np.float32 else \
            torch.float64
        x = self._x(X, dt)
        if x.device.type == "cpu":
            scores = torch.from_numpy(
                x.numpy() @ self.coef_.T + self.intercept_)
        else:
            scores = (x @ torch.from_numpy(self.coef_).to(x.device).T
                      + torch.from_numpy(self.intercept_).to(x.device))
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, X) -> np.ndarray:
        scores = self.decision_function(X)
        idx = (scores > 0).long() if scores.ndim == 1 else scores.argmax(1)
        return self.classes_[idx.cpu().numpy()]

    def predict_proba(self, X) -> np.ndarray:
        """Class probabilities in ``classes_``'s order: ``[1 - p, p]`` with
        p the expit of the decision for two classes, else the softmax of
        the decisions (sklearn's ``_predict_proba_lr`` and ``softmax``)."""
        scores = self.decision_function(X)
        if scores.device.type == "cpu":
            s = scores.numpy().copy()
            if s.ndim == 1:
                p = scipy.special.expit(s)
                return np.stack([1 - p, p], axis=1)
            s -= np.max(s, axis=1).reshape(-1, 1)
            np.exp(s, out=s)
            s /= np.sum(s, axis=1).reshape(-1, 1)
            return s
        if scores.ndim == 1:
            p = torch.sigmoid(scores)
            return torch.stack([1 - p, p], 1).cpu().numpy()
        return torch.softmax(scores, 1).cpu().numpy()

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y).ravel()))


def _binomial(w, x, target, l2):
    """``LinearModelLoss.loss_gradient`` over ``HalfBinomialLoss``: the
    Cython loss's four branches of log(1 + exp(raw))."""
    n, d = x.shape
    wt = torch.from_numpy(w).to(x.device)
    weights, intercept = wt[:-1], wt[-1]
    raw = x @ weights + intercept
    loss, grad = _binomial_pointwise(raw, target)
    value = float(loss.sum() / n) + float(0.5 * l2 * (weights @ weights))
    grad = grad / n
    out = torch.empty(d + 1, dtype=torch.float64, device=x.device)
    out[:d] = x.T @ grad + l2 * weights
    out[d] = grad.sum()
    return value, out.cpu().numpy()


def _binomial_pointwise(raw, y, exp=_exp):
    """The Cython ``closs_grad_half_binomial``, in the dtype of ``raw``."""
    lo = raw <= -37
    mid = (raw > -37) & (raw <= -2)
    hi = raw > 18
    e_pos = exp(torch.where(raw <= -2, raw, 0.0))
    e_neg = exp(torch.where(raw > -2, -raw, 0.0))
    loss = torch.where(
        lo, e_pos - y * raw,
        torch.where(mid, torch.log1p(e_pos) - y * raw,
                    torch.where(hi, e_neg + (1 - y) * raw,
                                torch.log1p(e_neg) + (1 - y) * raw)))
    grad = torch.where(
        lo, e_pos - y,
        torch.where(raw <= -2, ((1 - y) * e_pos - y) / (1 + e_pos),
                    ((1 - y) - y * e_neg) / (1 + e_neg)))
    return loss, grad


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


# --- the float32 path ---------------------------------------------------------
def _host(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _binomial32(w, x, target, l2):
    """sklearn's float32 ``loss_gradient`` over ``HalfBinomialLoss``: ``w``
    is the float32 point scipy hands the loss."""
    n, d = x.shape
    weights, intercept = w[:-1], w[-1]
    if _host(x):
        raw = torch.from_numpy(x.numpy() @ weights + intercept)
    else:
        raw = x @ torch.from_numpy(weights).to(x.device) + float(intercept)
    loss64, grad64 = _binomial_pointwise(raw.double(), target.double(),
                                         torch.exp)
    loss, grad = loss64.float(), grad64.float()
    grad = grad / np.float32(n)
    out = np.empty_like(w)
    if _host(x):
        value = float(np.sum(loss.numpy()) / n)
        out[:d] = x.numpy().T @ grad.numpy() + l2 * weights
        out[d] = np.sum(grad.numpy())
    else:
        value = float(loss.sum() / n)
        out[:d] = (x.T @ grad).cpu().numpy() + l2 * weights
        out[d] = grad.sum().item()
    value += float(0.5 * l2 * (weights @ weights))
    return value, out


def _multinomial32(w, x, onehot, l2):
    """sklearn's float32 ``loss_gradient`` over ``HalfMultinomialLoss``:
    ``CyHalfMultinomialLoss.loss_gradient`` keeps its exponentials in
    float32 (exp in double of the float32 raw less the row's largest),
    sums them in double, and divides, subtracts the true class's raw value
    and forms the gradient in float32."""
    n, d = x.shape
    K = onehot.shape[1]
    coef = w.reshape((K, -1), order="F")
    weights, intercept = coef[:, :-1], coef[:, -1]
    w32 = np.asarray(weights, dtype=np.float32)
    if _host(x):
        raw = torch.from_numpy(x.numpy() @ w32.T + intercept)
    else:
        raw = (x @ torch.from_numpy(np.ascontiguousarray(w32)).to(x.device).T
               + torch.from_numpy(np.ascontiguousarray(intercept)).to(
                   x.device))
    top = raw.amax(1, keepdim=True)
    p = torch.exp(raw.double() - top.double()).float()
    sum_exps = p.double().cumsum(1)[:, -1:].float()
    loss = (torch.log(sum_exps.double()) + top.double()).float()[:, 0]
    loss = loss - (raw * onehot).sum(1)
    grad = p / sum_exps - onehot
    grad = grad / np.float32(n)
    out = np.empty((K, d + 1), dtype=np.float32, order="F")
    if _host(x):
        g = grad.numpy()
        value = float(np.sum(loss.numpy()) / n)
        out[:, :d] = g.T @ x.numpy() + l2 * weights
        out[:, d] = np.sum(g, axis=0)
    else:
        value = float(loss.sum() / n)
        out[:, :d] = (grad.T @ x).cpu().numpy() + l2 * weights
        out[:, d] = grad.sum(0).cpu().numpy()
    flat = np.ravel(weights, order="K")
    value += float(0.5 * l2 * np.dot(flat, flat))
    return value, out.ravel(order="F")
