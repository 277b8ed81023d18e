"""TAD (Total AUROC Difference): how many binary attributes one latent each
captures, and how exclusively.

Counterpart of ``encdiff_tpu/evalx/tad.py`` (``aurocs_all``,
``attribute_mi_matrix``, ``tad_score``, ``CELEBA_ATTRS``), in numpy with the
JAX functions' float32 arithmetic: every (threshold, latent, attribute)
confusion count of the threshold classifiers comes from one contraction of
the thresholded predictions (T, N, D) with the targets (N, A), and each
AUROC is the reference's sorted right-rectangle integration.
"""

from __future__ import annotations

import numpy as np

# CelebA's 40 attribute names (standard order)
CELEBA_ATTRS = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
]

_F32 = np.float32


def aurocs_all(z, targ, num_thresholds: int = 11,
               min_range: float = 0.2) -> np.ndarray:
    """(A, D) AUROCs of every (attribute, latent) threshold classifier:
    the larger of the positive-direction and negative-direction AUROC over
    ``num_thresholds`` thresholds spread over each latent's range. z (N, D)
    codes, targ (N, A) binary attributes. A latent whose range is at most
    ``min_range`` stays at 0.5."""
    z = np.asarray(z, _F32)
    targ = np.asarray(targ, _F32)
    n = z.shape[0]
    hi, lo = z.max(axis=0), z.min(axis=0)
    # jnp.linspace's float32 values: i * (1 / (T - 1)), the last one 1
    ts = np.arange(num_thresholds, dtype=_F32) * (
        _F32(1.0) / _F32(num_thresholds - 1))
    ts[-1] = 1.0
    thr = ts[:, None] * (hi - lo)[None, :] + lo[None, :]          # (T, D)
    preds = (z[None] >= thr[:, None, :]).astype(_F32)            # (T, N, D)
    pos = targ.sum(axis=0)                                       # (A,)
    neg = _F32(n) - pos
    tp = np.einsum("tnd,na->tda", preds, targ)
    fp = np.einsum("tnd,na->tda", preds, _F32(1.0) - targ)
    pos_d = np.maximum(pos, _F32(1.0))[None, None, :]
    neg_d = np.maximum(neg, _F32(1.0))[None, None, :]
    p_tpr, p_fpr = tp / pos_d, fp / neg_d
    # the negative direction: (z < thr) = 1 - preds
    n_tpr = (pos[None, None, :] - tp) / pos_d
    n_fpr = (neg[None, None, :] - fp) / neg_d

    def area(fpr, tpr):
        # the reference sorts fpr and tpr each on its own, then sums right
        # rectangles (ae_utils_exp.py:195-203)
        fpr, tpr = np.sort(fpr, axis=0), np.sort(tpr, axis=0)
        return np.sum(tpr[1:] * (fpr[1:] - fpr[:-1]), axis=0)   # (D, A)

    auroc = np.maximum(area(p_fpr, p_tpr), area(n_fpr, n_tpr)).T  # (A, D)
    alive = (hi - lo) > min_range
    return np.where(alive[None, :], auroc, _F32(0.5)).astype(_F32)


def attribute_mi_matrix(targ) -> np.ndarray:
    """(A, A) mutual information between binary attributes; the diagonal
    is each attribute's entropy."""
    targ = np.asarray(targ, _F32)
    n = targ.shape[0]
    p = targ.mean(axis=0, dtype=_F32)
    total = np.zeros((targ.shape[1],) * 2, _F32)
    for xi, pi in ((_F32(1.0) - targ, _F32(1.0) - p), (targ, p)):
        for yj, pj in ((_F32(1.0) - targ, _F32(1.0) - p), (targ, p)):
            jp = np.einsum("na,nb->ab", xi, yj) / _F32(n)
            denom = pi[:, None] * pj[None, :]
            ok = (jp > 0) & (denom > 0)
            ratio = np.where(ok, jp / np.maximum(denom, _F32(1e-12)), 1.0)
            total += np.where(ok, jp * np.log(ratio), _F32(0.0))
    return total


def tad_score(z, targ, auroc_thresh: float = 0.75,
              ent_red_thresh: float = 0.2) -> dict:
    """The TAD protocol (``celeba_tad.py:54-129``): for each attribute the
    best latent's AUROC minus the next best's, summed over the attributes
    that some latent captures (AUROC at least ``auroc_thresh``) and that
    are not redundant with another attribute (entropy-reduction proportion
    at most ``ent_red_thresh``). Returns the score with its diagnostics."""
    au = aurocs_all(z, targ)                                      # (A, D)
    max_aur = au.max(axis=1)
    argmax_aur = au.argmax(axis=1)
    n_attr = au.shape[0]
    aurs_diffs = np.zeros(n_attr)
    norm_diffs = np.zeros(n_attr)
    for i in range(n_attr):
        rest = au[i].copy()
        rest[argmax_aur[i]] = 0.0
        aurs_diffs[i] = max_aur[i] - rest.max()
        norm = (au[i] - 0.5) / max(max_aur[i] - 0.5, 1e-12)
        norm[argmax_aur[i]] = 0.0
        norm_diffs[i] = 1.0 - norm.max()

    mi_mat = attribute_mi_matrix(targ)
    mi_maxes = (mi_mat * (1 - np.eye(n_attr))).max(axis=1)
    diag = np.maximum(np.diag(mi_mat), 1e-12)
    ent_red_prop = 1.0 - (diag - mi_maxes) / diag

    captured = (max_aur >= auroc_thresh) & (ent_red_prop <= ent_red_thresh)
    return {
        "tad_score": float(aurs_diffs[captured].sum()),
        "attributes_captured": int(captured.sum()),
        "max_auroc": max_aur,
        "argmax_latent": argmax_aur,
        "aurs_diffs": aurs_diffs,
        "norm_diffs": norm_diffs,
        "ent_red_prop": ent_red_prop,
    }
