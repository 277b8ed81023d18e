"""UDR: Unsupervised Disentanglement Ranking across model seeds.

A port of ``encdiff_tpu/evalx/udr.py`` (``compute_udr``, the Lasso and
Spearman correlation matrices, the relative-strength disentanglement). The
Lasso is ``lasso.py``'s, fitted on ``device`` in float64; the Spearman
matrix and the scores are numpy on the host. Representation functions map
observations (integer indices for the index-lookup datasets) to (B, D)
codes, or to (codes, kl_vector).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from encdiff_tpu_torch.evalx.lasso import Lasso


def relative_strength_disentanglement(corr_matrix: np.ndarray) -> float:
    """(max^2 / sum) down both axes, averaged."""
    with np.errstate(invalid="ignore", divide="ignore"):
        score_x = np.nanmean(np.nan_to_num(
            np.power(corr_matrix.max(axis=0), 2) / corr_matrix.sum(axis=0),
            nan=0.0))
        score_y = np.nanmean(np.nan_to_num(
            np.power(corr_matrix.max(axis=1), 2) / corr_matrix.sum(axis=1),
            nan=0.0))
    return (score_x + score_y) / 2


def spearman_correlation_matrix(vec1: np.ndarray,
                                vec2: np.ndarray) -> np.ndarray:
    """|spearman| between all latent pairs, vectorized over columns."""
    assert vec1.shape == vec2.shape

    def rank(x):
        order = np.argsort(x, axis=0)
        ranks = np.empty_like(order, dtype=np.float64)
        np.put_along_axis(ranks, order,
                          np.arange(x.shape[0], dtype=np.float64)[:, None],
                          axis=0)
        return ranks

    r1, r2 = rank(vec1), rank(vec2)
    r1 = (r1 - r1.mean(axis=0)) / (r1.std(axis=0) + 1e-12)
    r2 = (r2 - r2.mean(axis=0)) / (r2.std(axis=0) + 1e-12)
    corr = r1.T @ r2 / vec1.shape[0]
    return np.abs(corr)


def lasso_correlation_matrix(vec1, vec2, random_state=None,
                             device="cpu") -> np.ndarray:
    """|Lasso(alpha=0.1) coefficients|, (features of vec1, columns of
    vec2). ``random_state`` is accepted and unused: the cyclic descent
    draws nothing."""
    del random_state
    model = Lasso(alpha=0.1, device=device)
    model.fit(vec1, vec2)
    return np.transpose(np.absolute(model.coef_))


def compute_udr(ground_truth_data,
                representation_functions: Sequence[Callable],
                random_state: np.random.RandomState,
                batch_size: int = 64,
                num_data_points: int = 1000,
                correlation_matrix: str = "lasso",
                filter_low_kl: bool = True,
                include_raw_correlations: bool = True,
                kl_filter_threshold: float = 0.01,
                device="cpu") -> dict:
    """``compute_udr_sklearn``: pairwise correlation matrices of the
    models' standardised codes, the Lasso's on ``device``."""
    assert num_data_points % batch_size == 0
    reps: list[list] = [[] for _ in representation_functions]
    kls: list[list] = [[] for _ in representation_functions]
    for _ in range(num_data_points // batch_size):
        obs = ground_truth_data.sample_observations(batch_size, random_state)
        for j, fn in enumerate(representation_functions):
            out = fn(obs)
            if isinstance(out, tuple):
                r, kl = out
            else:
                r, kl = out, np.ones(np.asarray(out).shape[1])
            reps[j].append(np.asarray(r))
            kls[j].append(np.asarray(kl))
    model_reps = [np.concatenate(r, axis=0) for r in reps]
    kl = [np.mean(np.stack(k), axis=0) for k in kls]

    num_models = len(model_reps)
    latent_dim = model_reps[0].shape[1]
    corr_all = np.zeros((num_models, num_models, latent_dim, latent_dim))
    kl_mask = []
    for i in range(num_models):
        mu = model_reps[i].mean(axis=0)
        sd = model_reps[i].std(axis=0) + 1e-12
        model_reps[i] = (model_reps[i] - mu) / sd
        model_reps[i] = model_reps[i] * np.greater(kl[i],
                                                   kl_filter_threshold)
        kl_mask.append(kl[i] > kl_filter_threshold)

    disentanglement = np.zeros((num_models, num_models, 1))
    for i in range(num_models):
        for j in range(num_models):
            if i == j:
                continue
            if correlation_matrix == "lasso":
                cm = lasso_correlation_matrix(model_reps[i], model_reps[j],
                                              random_state=0, device=device)
            else:
                cm = spearman_correlation_matrix(model_reps[i], model_reps[j])
            corr_all[i, j] = cm
            if filter_low_kl:
                cm = cm[kl_mask[i], ...][..., kl_mask[j]]
            disentanglement[i, j] = relative_strength_disentanglement(cm)

    scores: dict = {}
    if include_raw_correlations:
        scores["raw_correlations"] = corr_all.tolist()
    scores["pairwise_disentanglement_scores"] = disentanglement.tolist()
    scores["model_scores"] = [
        float(np.median(np.delete(disentanglement[:, i], i)))
        for i in range(num_models)]
    return scores
