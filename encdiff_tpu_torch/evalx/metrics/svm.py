"""The linear SVM of SAP's discrete path: sklearn's ``LinearSVC(C=0.01,
class_weight="balanced")`` on one code at a time, every code of a factor in
one batch, in torch on ``device``.

sklearn 1.9's ``LinearSVC`` at these settings (``svm/_classes.py``,
``svm/_base.py:_fit_liblinear``, ``src/liblinear/linear.cpp``): the
squared hinge with L2, the intercept a feature of value
``intercept_scaling`` 1 whose weight is penalised like the others, and
``dual="auto"``, which takes liblinear's primal solver when there are more
samples than features (here always: one feature and a bias). Per problem
it minimises

    0.5 ||w||^2 + sum_i C_i max(0, 1 - y_i w . (x_i, 1))^2

with y_i = ±1. Two classes make one problem, the second class positive,
its samples at C times its balanced weight and the first's at C times
theirs; more classes make one problem a class against the rest, the class
at C times its weight and the rest at C (liblinear's ``train``). The
balanced weight of a class is n / (classes x its count).

liblinear's trust-region Newton stops at a gradient norm of 1e-4 times
its first (scaled by the smaller side's share); here each problem, a
convex piecewise quadratic in two unknowns, is solved to convergence by
Newton steps with a backtracking line search, so its decisions may differ
from liblinear's only for a test point within that tolerance of the
boundary. Each fit draws liblinear's seed from numpy's global
``RandomState`` as sklearn does (``rnd.randint(np.iinfo("i").max)``); the
primal solver uses none of it.
"""

from __future__ import annotations

import numpy as np
import torch

C = 0.01
INTERCEPT_SCALING = 1.0
MAX_NEWTON = 100
GRAD_TOL = 1e-12
ARMIJO = 1e-4
MAX_HALVINGS = 40


def draw_seed() -> int:
    """The seed sklearn draws from the global state for liblinear."""
    return int(np.random.mtrand._rand.randint(np.iinfo("i").max))


class OneFeatureSVC:
    """``LinearSVC(C=0.01, class_weight="balanced")`` fitted on each row
    of ``x`` (codes, samples) against the labels ``y`` (samples,): one
    fit per code, as the codes' one-column fits one after the other."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def fit(self, x, y):
        x = torch.as_tensor(np.asarray(x, np.float64)).to(self.device)
        y = np.asarray(y).ravel()
        self.classes_, enc = np.unique(y, return_inverse=True)
        K = len(self.classes_)
        if K < 2:
            raise ValueError("This solver needs samples of at least 2 classes"
                             f" in the data, but the data contains only one "
                             f"class: {self.classes_[0]!r}")
        n = len(y)
        weight = n / (K * np.bincount(enc).astype(np.float64))
        if K == 2:
            pos = (enc == 1)[None, :]
            cost = np.where(pos, C * weight[1], C * weight[0])
        else:
            pos = enc[None, :] == np.arange(K)[:, None]
            cost = np.where(pos, C * weight[:, None], C)
        sign = torch.from_numpy(np.where(pos, 1.0, -1.0)).to(self.device)
        cost = torch.from_numpy(cost).to(self.device)
        self.coef_, self.intercept_ = _newton(x, sign, cost)
        return self

    def decision_function(self, x) -> torch.Tensor:
        """(codes, problems, samples) decisions."""
        x = torch.as_tensor(np.asarray(x, np.float64)).to(self.device)
        return (self.coef_[:, :, None] * x[:, None, :]
                + self.intercept_[:, :, None])

    def predict(self, x) -> np.ndarray:
        """(codes, samples) predicted labels."""
        dec = self.decision_function(x)
        idx = (dec[:, 0] > 0).long() if dec.shape[1] == 1 else dec.argmax(1)
        return self.classes_[idx.cpu().numpy()]


def _objective(w0, w1, x, sign, cost):
    d = (1 - sign * (w0[:, :, None] * x[:, None, :] + w1[:, :, None])
         ).clamp_min(0)
    return 0.5 * (w0 * w0 + w1 * w1) + (cost * d * d).sum(-1)


def _newton(x, sign, cost):
    """Minimise every (code, problem) objective; ``x`` (codes, samples),
    ``sign`` and ``cost`` (problems, samples). Returns (coef, intercept),
    each (codes, problems)."""
    D, P = x.shape[0], sign.shape[0]
    w0 = torch.zeros(D, P, dtype=torch.float64, device=x.device)
    w1 = torch.zeros_like(w0)
    xs = INTERCEPT_SCALING
    g_first = None
    for _ in range(MAX_NEWTON):
        z = w0[:, :, None] * x[:, None, :] + w1[:, :, None] * xs
        d = 1 - sign * z
        act = (d > 0).to(x.dtype) * cost                    # C_i on the active
        r = act * sign * d                                   # C_i y_i d_i
        g0 = w0 - 2 * (r * x[:, None, :]).sum(-1)
        g1 = w1 - 2 * xs * r.sum(-1)
        gnorm = torch.sqrt(g0 * g0 + g1 * g1)
        if g_first is None:
            g_first = gnorm.clamp_min(1e-300)
        if bool((gnorm <= GRAD_TOL * g_first).all()):
            break
        h00 = 1 + 2 * (act * x[:, None, :] ** 2).sum(-1)
        h01 = 2 * xs * (act * x[:, None, :]).sum(-1)
        h11 = 1 + 2 * xs * xs * act.sum(-1)
        det = h00 * h11 - h01 * h01
        s0 = -(h11 * g0 - h01 * g1) / det
        s1 = -(h00 * g1 - h01 * g0) / det
        f0 = _objective(w0, w1, x, sign, cost)
        slope = g0 * s0 + g1 * s1
        step = torch.ones_like(w0)
        todo = gnorm > GRAD_TOL * g_first
        for _ in range(MAX_HALVINGS):
            f = _objective(w0 + step * s0, w1 + step * s1, x, sign, cost)
            ok = f <= f0 + ARMIJO * step * slope
            if bool((ok | ~todo).all()):
                break
            step = torch.where(ok | ~todo, step, step / 2)
        step = torch.where(todo, step, torch.zeros_like(step))
        w0 = w0 + step * s0
        w1 = w1 + step * s1
    return w0, w1 * xs
