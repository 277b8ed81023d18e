"""Procedural Shapes3D stand-in renderer (fourth generation), and batches.

A copy of ``_hue_rgb`` and ``render_all_v4`` from
``encdiff_tpu/data/synthetic_shapes.py``, so that the port can make the
flagship's images without importing the JAX package. The flagship trains on
the full grid ``FULL_FACTOR_SIZES`` (480,000 images, 5.9 GB of uint8), the
harness's dataset ``SyntheticShapes3DV4FullTrain``; the other entry points
render a small ``factor_sizes`` grid: ``(2, 2, 2, 2, 2, 2)`` = 64 images
for swap inputs, ``TRAIN_GRID`` = 4,096 images (50 MB) for the batches of
``train_steps``, drawn by ``epoch_batches``.

Factor order: floor_hue, wall_hue, object_hue, scale, shape, orientation.
"""

from __future__ import annotations

import colorsys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from encdiff_tpu_torch.data.datasets import RENDER_THREADS
from encdiff_tpu_torch.train.data import epoch_order

FACTOR_SIZES = [6, 6, 6, 4, 4, 8]
#: the exact Shapes3D factor grid the flagship was trained on
FULL_FACTOR_SIZES = [10, 10, 10, 8, 4, 15]
#: the sub-grid the port trains on: 4 values of every factor, 4,096 images
TRAIN_GRID = (4, 4, 4, 4, 4, 4)
#: rendered grids of this process, by (image_size, factor sizes)
_CACHE: dict = {}


def epoch_batches(n: int, batch_size: int, seed: int, epoch: int = 0):
    """Index arrays of one epoch's batches over ``n`` images: a permutation
    seeded with ``seed + epoch``, cut into ``n // batch_size`` full batches
    (the order of ``encdiff_tpu/train/data.py:epoch_loader``, and the
    harness's ``train.data.epoch_order``)."""
    return list(epoch_order(seed, epoch, n, batch_size, n).reshape(
        -1, batch_size))


def _hue_rgb(i: int, n: int, s: float = 0.85, v: float = 0.95) -> np.ndarray:
    r, g, b = colorsys.hsv_to_rgb(i / n, s, v)
    return np.array([r, g, b], np.float32) * 255.0



def render_all_v4(size: int = 64, horizon: float = 0.55,
                  factor_sizes=None) -> np.ndarray:
    """Shapes3D-faithful renderer, fourth generation: v3 + scale/shape
    decoupling inside the object region.

    The v3 480k run's DCI importance matrix (demo_artifacts/round3/v3_run)
    shows the ONLY residually entangled codes are scale<->shape mixtures
    (codes at 0.86/0.12, 0.90/0.10, 0.66/0.33 splits; every other code is
    >=0.98 pure). Cause: with flat-filled silhouettes, the single most
    informative object statistic — covered area — depends on *both* scale
    (radius) and shape (square 4r^2 vs triangle 2r^2 ...), so codes that
    track area are inherently mixed. Real ray-traced Shapes3D separates the
    pair with interior shading: a sphere's radial falloff looks nothing like
    a cube's flat facets at any size. v4 adds exactly the two object-local
    cues, touching no floor/wall/orientation pixels:

    - **equal-area shape family**: per-shape radius rescale so every shape
      covers the same pixel area at the same scale value — area becomes a
      pure scale cue, boundary form a pure shape cue.
    - **shape-specific interior shading** (rotates with the silhouette,
      mean-normalized per mask so average brightness leaks neither factor):
      square -> two flat facets, circle -> offset radial falloff (sphere),
      triangle -> apex-to-base gradient (cone), diamond -> diagonal ramp.
      Multiplicative on the object hue, so channel ratios (hue) stay exact.
    """
    fs = list(FACTOR_SIZES if factor_sizes is None else factor_sizes)
    f_floor, f_wall, f_obj, f_scale, f_shape, f_orient = fs
    n_images = int(np.prod(fs))
    hy = int(size * horizon)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)

    floor_colors = np.stack([_hue_rgb(i, f_floor) for i in range(f_floor)])
    wall_colors = np.stack([_hue_rgb(i, f_wall, s=0.6, v=0.8)
                            for i in range(f_wall)])
    obj_colors = np.stack([_hue_rgb(i, f_obj, s=1.0, v=1.0)
                           for i in range(f_obj)])

    az = np.array([np.deg2rad(-30.0 + 60.0 * (o / max(f_orient - 1, 1)))
                   for o in range(f_orient)], np.float32)
    edge = 1.2  # px anti-aliasing width

    # wall: two-tone corner whose x position tracks azimuth (as v3)
    corner_x = size * (0.5 + 0.55 * np.sin(az))
    wall_blend = np.clip(
        (xx[None, :hy, :] - corner_x[:, None, None]) / edge + 0.5, 0.0, 1.0)
    wall_shade_l, wall_shade_r = 0.8, 1.0
    wall_mix = (wall_shade_l + (wall_shade_r - wall_shade_l)
                * wall_blend)[..., None]

    # equal-area radius multipliers: area(shape, k*r) == area(circle, r)
    #   square (2kr)^2 = pi r^2, triangle 2(kr)^2 = pi r^2,
    #   diamond 2(1.3kr)^2 = pi r^2
    k_shape = [np.sqrt(np.pi) / 2.0,          # square  0.886
               1.0,                            # circle
               np.sqrt(np.pi / 2.0),           # triangle 1.253
               np.sqrt(np.pi / 3.38)]          # diamond 0.964

    # 0.57 vs v3's 0.62: the equal-area triangle is taller, and its rotated
    # base corner plus the AA skirt must clear the bottom row even at max
    # scale — y_max = cy + (cos+sin)(10.5deg)*k_tri*R + AA ~= cy + 1.46*R,
    # which needs cy < 62.5 - 1.46*16.5 = 38.4 with margin.
    cy = size * 0.57
    n_geo = f_scale * f_shape * f_orient
    alpha = np.empty((n_geo, size, size, 1), np.float32)
    shade = np.empty((n_geo, size, size, 1), np.float32)
    g = 0
    for sc in range(f_scale):
        # 8..16.5 px (vs v3's 8..17) and parallax 0.13 (vs 0.16): the
        # equal-area rescale makes the triangle ~25% wider than v3's, and
        # the extreme (max scale, triangle, |az|=30°) must stay fully inside
        # the frame — a clipped silhouette would couple orientation into
        # scale/shape, the exact interaction v4 removes.
        base_r = 8.0 + 8.5 * (sc / max(f_scale - 1, 1))
        for sh in range(f_shape):
            r = base_r * k_shape[sh % 4]
            for o in range(f_orient):
                cx = size / 2.0 + size * 0.13 * np.sin(az[o])  # parallax
                dx, dy = xx - cx, yy - cy
                ang = 0.35 * az[o]
                ca, sa = np.cos(ang), np.sin(ang)
                rx, ry = ca * dx + sa * dy, -sa * dx + ca * dy
                if sh % 4 == 0:    # square: Chebyshev signed distance
                    d = np.maximum(np.abs(rx), np.abs(ry)) - r
                    # cube facets: flat two-tone split along the (rotated)
                    # vertical axis, AA seam
                    s = 0.84 + 0.16 * np.clip(rx / edge + 0.5, 0.0, 1.0)
                elif sh % 4 == 1:  # circle (sphere)
                    d = np.sqrt(dx * dx + dy * dy) - r
                    rr = np.sqrt((dx + 0.35 * r) ** 2
                                 + (dy + 0.35 * r) ** 2) / max(r, 1.0)
                    s = 1.05 - 0.28 * np.clip(rr, 0.0, 1.6)
                elif sh % 4 == 2:  # triangle (cone): apex-to-base ramp
                    d = 0.5 * np.maximum(np.abs(rx) * 2.0 - (ry + r),
                                         np.abs(ry) - r)
                    s = 1.04 - 0.26 * np.clip((ry + r) / (2.0 * r), 0.0, 1.0)
                else:              # diamond: diagonal ramp
                    d = (np.abs(rx) + np.abs(ry) - r * 1.3) * 0.7071
                    s = 0.82 + 0.26 * np.clip(
                        (rx + ry) / (2.6 * r) + 0.5, 0.0, 1.0)
                a = np.clip(0.5 - d / edge, 0.0, 1.0)
                alpha[g, :, :, 0] = a
                # normalize mean interior brightness so neither scale nor
                # shape leaks through average intensity
                m = a > 0.5
                mean_s = float(s[m].mean()) if m.any() else 1.0
                shade[g, :, :, 0] = s * (0.92 / max(mean_s, 1e-6))
                g += 1

    geo_orient = (np.arange(n_geo) % f_orient)

    out = np.empty((n_images, size, size, 3), np.uint8)

    def compose(block):
        # the n_geo images of one (floor, wall, object) hue, in grid order
        fl, wa, ob = np.unravel_index(block, (f_floor, f_wall, f_obj))
        floor_rgb = np.broadcast_to(floor_colors[fl],
                                    (size - hy, size, 3)).astype(np.float32)
        wall_rgb = wall_mix * wall_colors[wa]
        col = obj_colors[ob] * shade   # (n_geo, size, size, 3)
        blk = np.empty((n_geo, size, size, 3), np.float32)
        blk[:, :hy] = wall_rgb[geo_orient]
        blk[:, hy:] = floor_rgb
        blk = alpha * col + (1.0 - alpha) * blk
        np.copyto(out[block * n_geo:(block + 1) * n_geo],
                  np.clip(blk, 0, 255).astype(np.uint8))

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        list(pool.map(compose, range(f_floor * f_wall * f_obj)))
    return out


class SyntheticShapes3DV4Full:
    """The 480,000-image grid of ``render_all_v4`` at ``FULL_FACTOR_SIZES``
    (``encdiff_tpu/data/synthetic_shapes.py:593-627``), the flagship's
    train and validation data: ``images`` (N, S, S, 3) uint8 in the order
    of the ground truth's factor bases, rendered once per process (5.9 GB
    on the host; the hue blocks composed on ``RENDER_THREADS`` host
    threads). The JAX class also keeps a disk cache; this one writes no
    file."""

    factor_sizes = FULL_FACTOR_SIZES

    def __init__(self, image_size: int = 64, **kwargs):
        del kwargs
        key = (image_size, tuple(self.factor_sizes))
        if key not in _CACHE:
            _CACHE[key] = render_all_v4(image_size,
                                        factor_sizes=self.factor_sizes)
        self.images = _CACHE[key]

    def __len__(self) -> int:
        return len(self.images)


class SyntheticShapes3DV4FullTrain(SyntheticShapes3DV4Full):
    pass
