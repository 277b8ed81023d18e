"""Procedural 256 px face grid, the faces configuration's training data.

A copy of ``render_faces`` and ``face_factors`` (with their colour tables)
from ``encdiff_tpu/data/synthetic_faces.py``, so that the port makes the
faces configuration's images without importing the JAX package. The full
grid ``FACE_FACTOR_SIZES`` is 34,560 images, 6.8 GB of uint8 at 256 px:
``SyntheticFacesTrain``, the faces VQ-GAN's train and validation data
(``-b faces_vq``). The stage-2 train step renders a sub-grid through
``factor_sizes`` instead: ``TRAIN_GRID`` = 512 images (100 MB), drawn in
batches by ``data.synthetic_shapes.epoch_batches``.

``render_faces`` draws the 144 geometry masks of the grid with numpy, as
the JAX function does, then composes each (background, skin, hair colour)
block over them: with numpy by default, or with torch on ``device``, the
same elementwise float32 operations in the same order (each one rounds as
numpy's does, and the clip and the cast to uint8 truncate the same way),
which gives the same bytes in a fraction of the time: one host thread takes
about 7 minutes for the 240 blocks of the full grid.

Factor order: background, skin, hair_color, hair_length, face_width, smile,
eye_size.

``face_attributes`` and ``write_eval_npz`` are copies of the JAX module's
(:176-200, :291-304): the 18 CelebA-style binary attributes of each face,
and the eval file of the TAD protocol (``data`` images, ``targ``
attributes, ``attr_names``) drawn from the full grid, which
``python -m encdiff_tpu_torch.tad`` reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

FACE_FACTOR_SIZES = [8, 5, 6, 4, 4, 3, 3]
N_FACES = int(np.prod(FACE_FACTOR_SIZES))  # 34,560
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


def render_faces(size: int = 256, factor_sizes=None,
                 device=None) -> np.ndarray:
    """(N, size, size, 3) uint8 images of the grid ``factor_sizes`` (the
    full grid by default), in ``face_factors`` index order; the colour
    blocks composed with numpy, or with torch on ``device`` (the same
    bytes)."""
    fs = list(FACE_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    masks, shade = _geometry(size, fs)
    if device is not None:
        return _compose_torch(size, fs, masks, shade, torch.device(device))
    face_a, hair_a, fringe_a, feat_a, white_a = masks
    n_bg, n_skin, n_hair = fs[:3]
    n_geo = len(face_a)
    n_images = int(np.prod(fs))
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


def _compose_torch(size, fs, masks, shade, device) -> np.ndarray:
    """``render_faces``'s colour blocks with torch on ``device``: each
    operation of the numpy loop, on the same float32 operands, in the same
    order; each block is copied into the host array as it is done."""
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    face_a, hair_a, fringe_a, feat_a, white_a = (on(m) for m in masks)
    shade = on(shade)
    bgs, skins, hairs = on(_BG), on(_SKIN), on(_HAIR)
    dark = on(np.array([30, 25, 25], np.float32))
    white = on(np.array([245, 245, 245], np.float32))
    n_bg, n_skin, n_hair = fs[:3]
    n_geo = len(face_a)
    out = np.empty((int(np.prod(fs)), size, size, 3), np.uint8)
    host = torch.from_numpy(out)
    idx = 0
    for bg in range(n_bg):
        base = bgs[bg]  # broadcast over the pixels, as np.broadcast_to
        for sk in range(n_skin):
            face_rgb = skins[sk] * shade
            for hc in range(n_hair):
                hair_rgb = hairs[hc] * shade
                img = (1.0 - hair_a) * base + hair_a * hair_rgb
                img = (1.0 - face_a) * img + face_a * face_rgb
                img = (1.0 - fringe_a) * img + fringe_a * hair_rgb
                img = (1.0 - white_a) * img + white_a * white
                img = (1.0 - feat_a) * img + feat_a * dark
                host[idx:idx + n_geo].copy_(img.clamp(0, 255).to(torch.uint8))
                idx += n_geo
    return out


def _geometry(size: int, fs):
    """The coverage masks of the geometry block (hair_length, face_width,
    smile, eye_size): face, hair behind the face, scalp fringe, dark
    features and eye whites, each (n_geo, size, size, 1) float32; and the
    face shading (size, size, 1)."""
    n_bg, n_skin, n_hair, n_len, n_wid, n_smile, n_eye = fs
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

    masks = tuple(m[..., None] for m in (face_a, hair_a, fringe_a, feat_a,
                                         white_a))
    return masks, shade[..., None]


def face_factors(n: int | None = None, factor_sizes=None) -> np.ndarray:
    """(N, 7) integer factor values in index order."""
    fs = list(FACE_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    n = n or int(np.prod(fs))
    bases = np.concatenate([np.cumprod(fs[::-1])[::-1][1:], [1]]).astype(
        np.int64)
    idx = np.arange(n, dtype=np.int64)
    return np.stack([(idx // bases[i]) % fs[i] for i in range(len(fs))],
                    axis=1)


_HAIR_NAMES = ["Black_Hair", "Brown_Hair", "Blond_Hair", "Red_Hair",
               "Gray_Hair", "Dyed_Hair"]
#: binary attribute names (CelebA-style) derived from the factor grid
FACE_ATTR_NAMES = _HAIR_NAMES + [
    "Bald", "Long_Hair", "Short_Hair", "Wide_Face", "Narrow_Face",
    "Smiling", "Frowning", "Big_Eyes", "Small_Eyes", "Pale_Skin",
    "Dark_Skin", "Cool_Background",
]


def face_attributes(n: int | None = None, factor_sizes=None) -> np.ndarray:
    """(N, 18) float32 binary attributes (``FACE_ATTR_NAMES``) of the grid's
    images in index order, for the TAD protocol. The geometry factors'
    extremes name the attributes of the full grid's sizes."""
    f = face_factors(n, factor_sizes)
    bg, sk, hc, ln, wd, sm, ey = (f[:, i] for i in range(7))
    cols = [hc == i for i in range(6)]  # hair colours
    cols += [ln == 0, ln == 3, ln == 1, wd == 3, wd == 0,
             sm == 2, sm == 0, ey == 2, ey == 0, sk == 0, sk == 4,
             np.isin(bg, [0, 2, 5])]
    return np.stack(cols, axis=1).astype(np.float32)


_CACHE: dict[tuple, np.ndarray] = {}


class SyntheticFaces:
    """The face grid at ``factor_sizes`` (the full 34,560-image grid), the
    counterpart of ``encdiff_tpu/data/synthetic_faces.py:197-227``:
    ``images`` (N, S, S, 3) uint8 in ``face_factors`` order, rendered once
    per process (6.8 GB on the host at 256 px), its colour blocks composed
    on ``device`` (``render_faces``'s: the harness passes its own; None
    composes them with numpy; the bytes are the same on any device).
    ``render_s`` holds the seconds of the render. The JAX class also keeps
    a disk cache; this one writes no file."""

    factor_sizes = FACE_FACTOR_SIZES

    def __init__(self, image_size: int = 256, device=None, **kwargs):
        del kwargs
        key = (image_size, tuple(self.factor_sizes))
        self.render_s = 0.0
        if key not in _CACHE:
            t0 = time.perf_counter()
            _CACHE[key] = render_faces(image_size, self.factor_sizes,
                                       device=device)
            self.render_s = time.perf_counter() - t0
            print(f"[data] face grid {list(self.factor_sizes)}: "
                  f"{len(_CACHE[key])} images at {image_size} px rendered "
                  f"in {self.render_s:.3f}s (masks on the host, colour "
                  f"blocks on {device or 'the host by numpy'})", flush=True)
        self.images = _CACHE[key]

    def __len__(self) -> int:
        return len(self.images)


class SyntheticFacesTrain(SyntheticFaces):
    pass


def write_eval_npz(path: str, image_size: int = 256, num: int = 4096,
                   seed: int = 0, device=None) -> str:
    """Write the TAD protocol's eval file (``test_celeba.npz``'s format:
    ``data`` uint8 images, ``targ`` binary attributes, ``attr_names``):
    ``num`` faces drawn with ``RandomState(seed).choice`` from the grid of
    ``SyntheticFaces`` (composed on ``device``), in index order."""
    rs = np.random.RandomState(seed)
    ds = SyntheticFaces(image_size, device=device)
    sel = np.sort(rs.choice(len(ds.images), size=min(num, len(ds.images)),
                            replace=False))
    targ = face_attributes(factor_sizes=ds.factor_sizes)[sel]
    np.savez(path, data=ds.images[sel], targ=targ,
             attr_names=np.array(FACE_ATTR_NAMES))
    return path
