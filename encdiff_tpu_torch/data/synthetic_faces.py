"""Procedural 256 px face grid, the faces configuration's training data.

A copy of ``render_faces`` and ``face_factors`` (with their colour tables)
from ``encdiff_tpu/data/synthetic_faces.py``, so that the port makes the
faces configuration's images without importing the JAX package. The full
grid ``FACE_FACTOR_SIZES`` is 34,560 images, 6.8 GB of uint8 at 256 px;
callers render a sub-grid through ``factor_sizes`` instead: ``TRAIN_GRID``
= 512 images (100 MB), drawn in batches by
``data.synthetic_shapes.epoch_batches``.

Factor order: background, skin, hair_color, hair_length, face_width, smile,
eye_size.
"""

from __future__ import annotations

import numpy as np

FACE_FACTOR_SIZES = [8, 5, 6, 4, 4, 3, 3]
#: the sub-grid the port trains on: 512 images, every geometry extreme
TRAIN_GRID = (4, 2, 2, 4, 2, 2, 2)

_BG = np.array([[90, 120, 200], [200, 120, 90], [120, 200, 120],
                [200, 200, 120], [150, 90, 180], [90, 190, 200],
                [220, 160, 200], [140, 140, 140]], np.float32)
_SKIN = np.array([[255, 224, 196], [240, 200, 160], [210, 160, 120],
                  [170, 120, 80], [120, 80, 50]], np.float32)
_HAIR = np.array([[25, 20, 20],      # black
                  [110, 70, 40],     # brown
                  [220, 190, 120],   # blond
                  [170, 60, 40],     # red
                  [180, 180, 180],   # gray
                  [70, 60, 140]],    # dyed blue
                 np.float32)


def _aa(d: np.ndarray, edge: float = 1.5) -> np.ndarray:
    """Signed distance -> anti-aliased coverage in [0, 1]."""
    return np.clip(0.5 - d / edge, 0.0, 1.0)


def render_faces(size: int = 256, factor_sizes=None) -> np.ndarray:
    """(N, size, size, 3) uint8 images of the grid ``factor_sizes`` (the
    full grid by default), in ``face_factors`` index order."""
    fs = list(FACE_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    n_bg, n_skin, n_hair, n_len, n_wid, n_smile, n_eye = fs
    n_images = int(np.prod(fs))
    s = size / 256.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx, cy = size / 2.0, size * 0.54

    # ---- geometry block over (hair_length, face_width, smile, eye_size) --
    n_geo = n_len * n_wid * n_smile * n_eye
    face_a = np.empty((n_geo, size, size), np.float32)   # face coverage
    hair_a = np.empty_like(face_a)                       # hair behind face
    fringe_a = np.empty_like(face_a)                     # scalp hair on face
    feat_a = np.empty_like(face_a)                       # dark features
    white_a = np.empty_like(face_a)                      # eye whites
    g = 0
    for ln in range(n_len):
        for wd in range(n_wid):
            rx = (62 + 14 * wd / max(n_wid - 1, 1)) * s
            ry = 88 * s
            d_face = (np.sqrt(((xx - cx) / rx) ** 2 +
                              ((yy - cy) / ry) ** 2) - 1.0) * min(rx, ry)
            # hair: outer ellipse above the brow line, sides extend down
            # with hair_length
            hr = rx + 14 * s
            top = cy - ry * 0.55
            drop = cy + ry * (0.1 + 0.45 * ln / max(n_len - 1, 1))
            d_hair = (np.sqrt(((xx - cx) / hr) ** 2 +
                              ((yy - top) / (ry * 0.9)) ** 2) - 1.0) * hr
            hair_mask = _aa(d_hair, 2.0) * _aa(yy - drop, 8.0)
            # bald = hair_length 0: no hair at all
            if ln == 0:
                hair_mask *= 0.0
            face_mask = _aa(d_face, 2.0)
            # scalp fringe: hair drawn OVER the face only above the
            # hairline (the rest of the cap sits behind the face)
            hairline = cy - ry * 0.45
            fringe = hair_mask * face_mask * _aa(yy - hairline, 6.0)
            for sm in range(n_smile):
                curve = (sm / max(n_smile - 1, 1) - 0.5) * 2.0  # -1..1
                for ey in range(n_eye):
                    er = (7 + 4 * ey / max(n_eye - 1, 1)) * s
                    exo = rx * 0.42
                    eyy = cy - ry * 0.15
                    d_el = np.sqrt((xx - (cx - exo)) ** 2 +
                                   (yy - eyy) ** 2) - er
                    d_er = np.sqrt((xx - (cx + exo)) ** 2 +
                                   (yy - eyy) ** 2) - er
                    eyes = np.maximum(_aa(d_el), _aa(d_er))
                    pupil = np.maximum(_aa(d_el + er * 0.5),
                                       _aa(d_er + er * 0.5))
                    # brows: thin bars above the eyes
                    by = eyy - er - 8 * s
                    brows = (_aa(np.abs(yy - by) - 2.5 * s) *
                             np.maximum(
                                 _aa(np.abs(xx - (cx - exo)) - er * 1.3),
                                 _aa(np.abs(xx - (cx + exo)) - er * 1.3)))
                    # nose: vertical line
                    nose = (_aa(np.abs(xx - cx) - 1.8 * s) *
                            _aa(np.abs(yy - (cy + ry * 0.12)) - 14 * s))
                    # mouth: parabola, curvature = smile
                    my = cy + ry * 0.45
                    mx = (xx - cx) / (rx * 0.45)
                    arc = my - curve * 10.0 * s * (mx ** 2 - 0.5)
                    mouth = (_aa(np.abs(yy - arc) - 3.0 * s) *
                             _aa(np.abs(mx) - 1.0, 0.05))
                    feat_a[g] = np.clip(pupil + brows + 0.6 * nose + mouth,
                                        0, 1)
                    white_a[g] = np.clip(eyes - pupil, 0, 1)
                    face_a[g] = face_mask
                    hair_a[g] = hair_mask
                    fringe_a[g] = fringe
                    g += 1
    assert g == n_geo

    # face shading (fixed light from upper-left)
    shade = 1.04 - 0.22 * np.clip(
        np.sqrt((xx - cx + 30 * s) ** 2 + (yy - cy + 40 * s) ** 2)
        / (120.0 * s), 0, 1.4)

    face_a = face_a[..., None]
    hair_a = hair_a[..., None]
    fringe_a = fringe_a[..., None]
    feat_a = feat_a[..., None]
    white_a = white_a[..., None]
    shade = shade[..., None]

    out = np.empty((n_images, size, size, 3), np.uint8)
    idx = 0
    dark = np.array([30, 25, 25], np.float32)
    white = np.array([245, 245, 245], np.float32)
    for bg in range(n_bg):
        base = np.broadcast_to(_BG[bg], (size, size, 3))
        for sk in range(n_skin):
            face_rgb = _SKIN[sk] * shade
            for hc in range(n_hair):
                hair_rgb = _HAIR[hc] * shade
                img = (1.0 - hair_a) * base + hair_a * hair_rgb
                img = (1.0 - face_a) * img + face_a * face_rgb
                img = (1.0 - fringe_a) * img + fringe_a * hair_rgb
                img = (1.0 - white_a) * img + white_a * white
                img = (1.0 - feat_a) * img + feat_a * dark
                np.copyto(out[idx:idx + n_geo],
                          np.clip(img, 0, 255).astype(np.uint8))
                idx += n_geo
    assert idx == n_images
    return out


def face_factors(n: int | None = None, factor_sizes=None) -> np.ndarray:
    """(N, 7) integer factor values in index order."""
    fs = list(FACE_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    n = n or int(np.prod(fs))
    bases = np.concatenate([np.cumprod(fs[::-1])[::-1][1:], [1]]).astype(
        np.int64)
    idx = np.arange(n, dtype=np.int64)
    return np.stack([(idx // bases[i]) % fs[i] for i in range(len(fs))],
                    axis=1)
