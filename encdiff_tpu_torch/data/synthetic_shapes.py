"""Procedural Shapes3D stand-in renderers (v1 to v4, and the bands
control), their grids, and batches.

Copies of ``_hue_rgb``, ``_shape_mask``, ``render_all`` (v1),
``render_all_v2``, ``render_all_v3``, ``render_all_v4`` and
``render_bands`` from ``encdiff_tpu/data/synthetic_shapes.py``, so that
the port can make every grid of the shapes family without importing the
JAX package. Each renderer gives the JAX renderer's bytes; the v1 to v4
renderers compose their (floor, wall, object) hue blocks, and the bands
renderer its chunks of rows, on ``RENDER_THREADS`` host threads, each
block into its own disjoint slice of the output, so the bytes do not
depend on the thread count.

The flagship trains on the full v4 grid at ``FULL_FACTOR_SIZES`` (480,000
images, 5.9 GB of uint8), the harness's dataset
``SyntheticShapes3DV4FullTrain``; the other run configs of the family take
the v1 grid at ``FACTOR_SIZES`` (27,648 images) or at the full sizes, the
v2 and v3 grids at the full sizes, and the bands grid at either. The other
entry points render a small ``factor_sizes`` grid of v4: ``(2, 2, 2, 2, 2,
2)`` = 64 images for swap inputs, ``TRAIN_GRID`` = 4,096 images (50 MB)
for the batches of ``train_steps``, drawn by ``epoch_batches``.

A grid is rendered once per process and kept by (renderer, image size,
factor sizes) until ``clear_cache``; no grid is written to disk (the JAX
v2, v3 and v4 classes keep ``.npy`` files under ``$ENCDIFF_DATA_CACHE``).

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
#: fixed base hue per factor band for the independence-control renderer
_BAND_HUES = [0.0, 0.33, 0.62, 0.12, 0.5, 0.83]
#: rows a chunk of ``render_bands``, images a chunk of a v2 to v4 hue block
_BAND_CHUNK = 4096
_GEO_CHUNK = 32
#: rendered grids of this process, by (renderer, image_size, factor sizes)
_CACHE: dict = {}


def _on_threads(fn, n: int) -> None:
    """``fn(i)`` for i in range(n) on ``RENDER_THREADS`` host threads."""
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        list(pool.map(fn, range(n)))


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


def _shape_mask(shape_idx: int, scale_idx: int, orient_idx: int,
                size: int = 64, factor_sizes=None) -> np.ndarray:
    """Boolean mask of the v1 object for one geometry combination, its
    geometry a fraction along each factor axis (8..17 px radius, +-11.2 px
    of horizontal position at any grid density)."""
    fs = FACTOR_SIZES if factor_sizes is None else factor_sizes
    n_scale, n_orient = fs[3], fs[5]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    radius = 8.0 + 9.0 * (scale_idx / max(n_scale - 1, 1))     # 8..17 px
    cx = size / 2 + (orient_idx - (n_orient - 1) / 2) * (
        22.4 / max(n_orient - 1, 1))
    cy = size * 0.62
    dx, dy = xx - cx, yy - cy
    if shape_idx == 0:      # square
        return (np.abs(dx) < radius) & (np.abs(dy) < radius)
    if shape_idx == 1:      # circle
        return dx**2 + dy**2 < radius**2
    if shape_idx == 2:      # triangle (pointing up)
        return (dy < radius) & (dy > -radius) & \
               (np.abs(dx) < (dy + radius) / 2)
    # diamond
    return np.abs(dx) + np.abs(dy) < radius * 1.3


def _palettes(f_floor: int, f_wall: int, f_obj: int):
    """The floor, wall and object hue colours (float32 RGB in 0..255)."""
    return (np.stack([_hue_rgb(i, f_floor) for i in range(f_floor)]),
            np.stack([_hue_rgb(i, f_wall, s=0.6, v=0.8)
                      for i in range(f_wall)]),
            np.stack([_hue_rgb(i, f_obj, s=1.0, v=1.0)
                      for i in range(f_obj)]))


def _blend_blocks(fs, size: int, hy: int, alpha, walls, floor_of,
                  object_of) -> np.ndarray:
    """The grid (N, size, size, 3) uint8 of the v2 to v4 renderers: each
    (floor, wall, object) hue block is its ``n_geo`` images, a wall strip
    (``walls[wall_hue]`` (f_orient, hy, size, 3) at each image's
    orientation) above the floor (``floor_of(floor_hue)``) with the object
    (``object_of(object_hue, geometry slice)``) blended in by ``alpha``
    (n_geo, size, size, 1), clipped and truncated to uint8. A block is
    composed ``_GEO_CHUNK`` images at a time, whose float32 temporaries
    stay in the core's cache."""
    f_floor, f_wall, f_obj, f_scale, f_shape, f_orient = fs
    n_geo = f_scale * f_shape * f_orient
    geo_orient = np.arange(n_geo) % f_orient
    out = np.empty((int(np.prod(fs)), size, size, 3), np.uint8)

    def compose(block):
        fl, wa, ob = np.unravel_index(block, (f_floor, f_wall, f_obj))
        floor = floor_of(fl)
        for g0 in range(0, n_geo, _GEO_CHUNK):
            sl = slice(g0, min(g0 + _GEO_CHUNK, n_geo))
            blk = np.empty((sl.stop - g0, size, size, 3), np.float32)
            blk[:, :hy] = walls[wa][geo_orient[sl]]
            blk[:, hy:] = floor
            blk = alpha[sl] * object_of(ob, sl) + (1.0 - alpha[sl]) * blk
            np.copyto(out[block * n_geo + g0:block * n_geo + sl.stop],
                      np.clip(blk, 0, 255).astype(np.uint8))

    _on_threads(compose, f_floor * f_wall * f_obj)
    return out


def render_all(size: int = 64, horizon: float = 0.55,
               factor_sizes=None) -> np.ndarray:
    """The v1 grid (N, size, size, 3) uint8: flat floor and wall colours
    split by a horizon, one flat-filled object (square, circle, triangle,
    diamond) whose radius tracks scale and whose horizontal position tracks
    orientation; each (floor, wall, object) hue block is its background
    with the object's colour copied in where the geometry masks are set
    (the bytes of the JAX renderer's ``np.where``)."""
    fs = list(FACTOR_SIZES if factor_sizes is None else factor_sizes)
    f_floor, f_wall, f_obj, f_scale, f_shape, f_orient = fs
    n_images = int(np.prod(fs))
    floor_colors, wall_colors, obj_colors = _palettes(f_floor, f_wall, f_obj)
    hy = int(size * horizon)
    # geometry masks, row-major over (scale, shape, orientation): the
    # layout of the trailing 3 index digits
    n_geo = f_scale * f_shape * f_orient
    masks = np.zeros((n_geo, size, size, 1), bool)
    g = 0
    for sc in range(f_scale):
        for sh in range(f_shape):
            for orient in range(f_orient):
                masks[g, :, :, 0] = _shape_mask(sh, sc, orient, size, fs)
                g += 1

    out = np.empty((n_images, size, size, 3), np.uint8)

    def compose(block):
        fl, wa, ob = np.unravel_index(block, (f_floor, f_wall, f_obj))
        blk = out[block * n_geo:(block + 1) * n_geo]
        blk[:, :hy] = wall_colors[wa].astype(np.uint8)
        blk[:, hy:] = floor_colors[fl].astype(np.uint8)
        np.copyto(blk, obj_colors[ob].astype(np.uint8), where=masks)

    _on_threads(compose, f_floor * f_wall * f_obj)
    return out


def render_all_v2(size: int = 64, horizon: float = 0.55,
                  factor_sizes=None) -> np.ndarray:
    """Shapes3D-faithful renderer, second generation: orientation is the
    camera azimuth (it slides the wall-corner line and rotates the centred
    silhouette in place), anti-aliased signed-distance masks, and shading
    (a two-tone wall corner, a vertical floor gradient, a radial highlight
    on the object)."""
    fs = list(FACTOR_SIZES if factor_sizes is None else factor_sizes)
    f_floor, f_wall, f_obj, f_scale, f_shape, f_orient = fs
    hy = int(size * horizon)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    floor_colors, wall_colors, obj_colors = _palettes(f_floor, f_wall, f_obj)

    # the wall corner's x position per orientation, the blend of its two
    # faces (f_orient, hy, size), the floor's depth gradient
    corner_x = np.array([
        size * (0.2 + 0.6 * (o / max(f_orient - 1, 1)))
        for o in range(f_orient)], np.float32)
    edge = 1.2  # px soft edge (anti-aliasing width)
    wall_blend = np.clip(
        (xx[None, :hy, :] - corner_x[:, None, None]) / edge + 0.5, 0.0, 1.0)
    floor_shade = (0.82 + 0.18 * (yy[hy:, :] - hy) / max(size - hy, 1))
    wall_shade_l, wall_shade_r = 0.78, 1.0

    # the object's alpha and shade over (scale, shape, orientation)
    cx, cy = size / 2.0, size * 0.62
    dx, dy = xx - cx, yy - cy
    n_geo = f_scale * f_shape * f_orient
    alpha = np.empty((n_geo, size, size, 1), np.float32)
    shade_obj = np.empty((n_geo, size, size, 1), np.float32)
    g = 0
    for sc in range(f_scale):
        radius = 8.0 + 9.0 * (sc / max(f_scale - 1, 1))
        for sh in range(f_shape):
            for o in range(f_orient):
                # in-place rotation by azimuth (the object stays centred)
                ang = 0.5 * np.pi * (o / max(f_orient, 1))
                ca, sa = np.cos(ang), np.sin(ang)
                rx, ry = ca * dx + sa * dy, -sa * dx + ca * dy
                if sh == 0:      # square: Chebyshev signed distance
                    d = np.maximum(np.abs(rx), np.abs(ry)) - radius
                elif sh == 1:    # circle (rotation-invariant, like spheres)
                    d = np.sqrt(dx * dx + dy * dy) - radius
                elif sh == 2:    # triangle (pointing up), approximate sdf
                    d = np.maximum(np.abs(rx) * 2.0 - (ry + radius),
                                   np.abs(ry) - radius)
                    d = d * 0.5
                else:            # diamond (L1 ball)
                    d = (np.abs(rx) + np.abs(ry) - radius * 1.3) * 0.7071
                alpha[g, :, :, 0] = np.clip(0.5 - d / edge, 0.0, 1.0)
                # radial highlight toward the upper left
                rr = np.sqrt((dx + 0.35 * radius) ** 2 +
                             (dy + 0.35 * radius) ** 2) / max(radius, 1.0)
                shade_obj[g, :, :, 0] = 1.05 - 0.25 * np.clip(rr, 0, 1.6)
                g += 1

    obj_cols = obj_colors[:, None, None, :]  # (f_obj, 1, 1, 3)
    wall_mix = (wall_shade_l + (wall_shade_r - wall_shade_l)
                * wall_blend)[..., None]      # (f_orient, hy, size, 1)
    return _blend_blocks(
        fs, size, hy, alpha, wall_mix * wall_colors[:, None, None, None],
        lambda fl: floor_shade[..., None] * floor_colors[fl],
        lambda ob, sl: obj_cols[ob] * shade_obj[sl])


def render_all_v3(size: int = 64, horizon: float = 0.55,
                  factor_sizes=None) -> np.ndarray:
    """Shapes3D-faithful renderer, third generation: flat-coloured floor and
    object, a fixed two-tone wall corner whose position tracks the camera
    azimuth (orientation, +-30 degrees), which also shifts the object by
    parallax and rotates it mildly (0.35 of the azimuth); anti-aliased
    signed-distance masks."""
    fs = list(FACTOR_SIZES if factor_sizes is None else factor_sizes)
    f_floor, f_wall, f_obj, f_scale, f_shape, f_orient = fs
    hy = int(size * horizon)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    floor_colors, wall_colors, obj_colors = _palettes(f_floor, f_wall, f_obj)

    # camera azimuth per orientation value: +-30 degrees
    az = np.array([np.deg2rad(-30.0 + 60.0 * (o / max(f_orient - 1, 1)))
                   for o in range(f_orient)], np.float32)
    edge = 1.2  # px anti-aliasing width

    # the wall: a two-tone corner whose x position tracks the azimuth
    corner_x = size * (0.5 + 0.55 * np.sin(az))          # (f_orient,)
    wall_blend = np.clip(
        (xx[None, :hy, :] - corner_x[:, None, None]) / edge + 0.5, 0.0, 1.0)
    wall_shade_l, wall_shade_r = 0.8, 1.0
    wall_mix = (wall_shade_l + (wall_shade_r - wall_shade_l)
                * wall_blend)[..., None]                 # (f_orient,hy,size,1)

    # the object: anti-aliased alpha, parallax shift and mild rotation
    cy = size * 0.62
    n_geo = f_scale * f_shape * f_orient
    alpha = np.empty((n_geo, size, size, 1), np.float32)
    g = 0
    for sc in range(f_scale):
        radius = 8.0 + 9.0 * (sc / max(f_scale - 1, 1))
        for sh in range(f_shape):
            for o in range(f_orient):
                cx = size / 2.0 + size * 0.16 * np.sin(az[o])  # parallax
                dx, dy = xx - cx, yy - cy
                ang = 0.35 * az[o]                  # at most 10.5 degrees
                ca, sa = np.cos(ang), np.sin(ang)
                rx, ry = ca * dx + sa * dy, -sa * dx + ca * dy
                if sh == 0:      # square: Chebyshev signed distance
                    d = np.maximum(np.abs(rx), np.abs(ry)) - radius
                elif sh == 1:    # circle (rotation-invariant, like spheres)
                    d = np.sqrt(dx * dx + dy * dy) - radius
                elif sh == 2:    # triangle (pointing up), approximate sdf
                    d = np.maximum(np.abs(rx) * 2.0 - (ry + radius),
                                   np.abs(ry) - radius)
                    d = d * 0.5
                else:            # diamond (L1 ball)
                    d = (np.abs(rx) + np.abs(ry) - radius * 1.3) * 0.7071
                alpha[g, :, :, 0] = np.clip(0.5 - d / edge, 0.0, 1.0)
                g += 1

    return _blend_blocks(
        fs, size, hy, alpha, wall_mix * wall_colors[:, None, None, None],
        lambda fl: floor_colors[fl], lambda ob, sl: obj_colors[ob])


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
    hy = int(size * horizon)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)

    floor_colors, wall_colors, obj_colors = _palettes(f_floor, f_wall, f_obj)

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

    return _blend_blocks(
        fs, size, hy, alpha, wall_mix * wall_colors[:, None, None, None],
        lambda fl: floor_colors[fl], lambda ob, sl: obj_colors[ob] * shade[sl])


def render_bands(size: int = 64, factor_sizes=None) -> np.ndarray:
    """Independence-control renderer: 6 disjoint horizontal bands, band *i*
    coloured by factor *i* alone (a fixed hue whose brightness ramps with
    the factor's value): no pixel interaction between factors. Rows are
    drawn in chunks of ``_BAND_CHUNK``."""
    fs = list(FACTOR_SIZES if factor_sizes is None else factor_sizes)
    n_images = int(np.prod(fs))
    bases = np.concatenate([np.cumprod(fs[::-1])[::-1][1:], [1]]).astype(
        np.int64)
    bounds = [round(size * i / len(fs)) for i in range(len(fs) + 1)]
    colors = []
    for i, n in enumerate(fs):
        ramp = 0.15 + 0.80 * (np.arange(n) / max(n - 1, 1))
        colors.append(np.stack([
            np.array(colorsys.hsv_to_rgb(_BAND_HUES[i], 0.85, v),
                     np.float32) * 255.0 for v in ramp
        ]).astype(np.uint8))                                  # (n, 3)
    out = np.empty((n_images, size, size, 3), np.uint8)

    def draw(chunk):
        idx = np.arange(chunk * _BAND_CHUNK,
                        min((chunk + 1) * _BAND_CHUNK, n_images),
                        dtype=np.int64)
        for i, n in enumerate(fs):
            vals = (idx // bases[i]) % n
            out[idx[0]:idx[-1] + 1, bounds[i]:bounds[i + 1]] = \
                colors[i][vals][:, None, None, :]

    _on_threads(draw, -(-n_images // _BAND_CHUNK))
    return out


#: each renderer by the name a grid's cache key and class give it
RENDERERS = {"v1": render_all, "v2": render_all_v2, "v3": render_all_v3,
             "v4": render_all_v4, "bands": render_bands}


def get_images(renderer: str, size: int = 64, factor_sizes=None) -> np.ndarray:
    """The grid of ``renderer`` (a ``RENDERERS`` name) at ``factor_sizes``,
    rendered once per process."""
    key = (renderer, size, tuple(FACTOR_SIZES if factor_sizes is None
                                 else factor_sizes))
    if key not in _CACHE:
        _CACHE[key] = RENDERERS[renderer](size, factor_sizes=list(key[2]))
    return _CACHE[key]


def clear_cache() -> None:
    """Drop the grids this process holds (5.9 GB each at the full sizes)."""
    _CACHE.clear()


class _Grid:
    """A grid of ``renderer`` at ``factor_sizes``: ``images`` (N, S, S, 3)
    uint8 in the order of the ground truth's factor bases (``get_images``),
    and ``len``. ``image_size`` is the side S; other keyword arguments (the
    harness's ``device``) are taken and unused: the grid stays on the host
    until the harness uploads it."""

    renderer = "v4"
    factor_sizes = FULL_FACTOR_SIZES

    def __init__(self, image_size: int = 64, **kwargs):
        del kwargs
        self.images = get_images(self.renderer, image_size,
                                 self.factor_sizes)

    def __len__(self) -> int:
        return len(self.images)


class SyntheticShapes3D(_Grid):
    """The v1 grid at ``FACTOR_SIZES``: 27,648 images (pair with
    ``eval_name: synthetic_shapes``)."""

    renderer = "v1"
    factor_sizes = FACTOR_SIZES


class SyntheticShapes3DTrain(SyntheticShapes3D):
    pass


class SyntheticShapes3DFull(_Grid):
    """The v1 grid at ``FULL_FACTOR_SIZES``: 480,000 images (pair with
    ``eval_name: synthetic_shapes_full``)."""

    renderer = "v1"


class SyntheticShapes3DFullTrain(SyntheticShapes3DFull):
    pass


class SyntheticShapes3DV2Full(_Grid):
    """The 480,000-image grid of ``render_all_v2``. The JAX class also keeps
    a disk cache; this one writes no file."""

    renderer = "v2"


class SyntheticShapes3DV2FullTrain(SyntheticShapes3DV2Full):
    pass


class SyntheticShapes3DV3Full(_Grid):
    """The 480,000-image grid of ``render_all_v3``. The JAX class also keeps
    a disk cache; this one writes no file."""

    renderer = "v3"


class SyntheticShapes3DV3FullTrain(SyntheticShapes3DV3Full):
    pass


class SyntheticShapes3DV4Full(_Grid):
    """The 480,000-image grid of ``render_all_v4``
    (``encdiff_tpu/data/synthetic_shapes.py:593-627``), the flagship's
    train and validation data (5.9 GB on the host). The JAX class also
    keeps a disk cache; this one writes no file."""

    renderer = "v4"


class SyntheticShapes3DV4FullTrain(SyntheticShapes3DV4Full):
    pass


class SyntheticBands(_Grid):
    """The bands control at ``FACTOR_SIZES``: 27,648 images (pair with
    ``eval_name: synthetic_shapes``)."""

    renderer = "bands"
    factor_sizes = FACTOR_SIZES


class SyntheticBandsTrain(SyntheticBands):
    pass


class SyntheticBandsFull(_Grid):
    """The bands control at ``FULL_FACTOR_SIZES``: 480,000 images, the
    ground truth of ``SyntheticShapes3DFull`` (pair with ``eval_name:
    synthetic_shapes_full``)."""

    renderer = "bands"


class SyntheticBandsFullTrain(SyntheticBandsFull):
    pass
