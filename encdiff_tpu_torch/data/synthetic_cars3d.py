"""Procedural Cars3D grid: the Cars3D configuration's training data.

A copy of ``encdiff_tpu/data/synthetic_cars3d.py`` (``_object_params``,
``render_cars3d_all``, the two dataset classes), so that the port makes the
Cars3D chain's images (``-b cars3d_vq``, ``-b cars3d``) without importing
the JAX package. Real Cars3D's three factors in index order,

    elevation(4) x azimuth(24) x object(183)  ->  N = 17,568 images,

drawn as a parameterised car on a white background: per-object colour and
proportions from a ``RandomState(1830)`` lattice (identity recoverable
across views), azimuth as foreshortening and heading (a windshield and a
tail light break the 180 degree ambiguity), elevation as pitch. Index =
dot(factors, bases), the order of ``evalx.ground_truth.datasets.Cars3D``
(``eval_name: cars3d``).

The grid is small (216 MB of uint8 at 64 px) and renders with numpy on the
host, as the JAX function does, its 96 (elevation, azimuth) blocks on
``RENDER_THREADS`` threads; ``get_cars3d_images`` keeps it for the
process (the JAX module also keeps a disk cache; this one writes no file).
``SyntheticCars3DFullTrain`` repeats it ten times an epoch, as the
reference's loader does: ``len`` is 175,680 and a row index is taken modulo
17,568.
"""

from __future__ import annotations

import colorsys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from encdiff_tpu_torch.data.datasets import RENDER_THREADS, ArrayDataset

#: real Cars3D factor sizes in the real index order
CARS3D_FACTOR_SIZES = [4, 24, 183]
N_IMAGES_CARS3D = int(np.prod(CARS3D_FACTOR_SIZES))  # 17,568


def _object_params(n_obj: int = 183):
    """Deterministic per-object appearance parameters. A 183-point lattice
    over (hue-ish RGB mix, body proportions) + hashed jitter: every object
    distinct, appearance stable across views."""
    rng = np.random.RandomState(1830)
    i = np.arange(n_obj)
    # color lattice: 3 coarse value bands x 61 hue steps, plus jitter
    h = (i % 61) / 61.0
    v = 0.45 + 0.25 * (i // 61)
    body_rgb = np.stack([
        np.array(colorsys.hsv_to_rgb(h[k], 0.75 + 0.2 * rng.rand(), v[k]),
                 np.float32) * 255.0 for k in range(n_obj)])
    length = 0.66 + 0.18 * rng.rand(n_obj)        # body half-length (x r_ref)
    height = 0.16 + 0.08 * rng.rand(n_obj)        # body half-height
    cabin_h = 0.10 + 0.07 * rng.rand(n_obj)       # cabin extra height
    cabin_w = 0.45 + 0.20 * rng.rand(n_obj)       # cabin length fraction
    cabin_off = -0.08 + 0.16 * rng.rand(n_obj)    # cabin center offset
    wheel_r = 0.07 + 0.05 * rng.rand(n_obj)
    return {"rgb": body_rgb, "length": length, "height": height,
            "cabin_h": cabin_h, "cabin_w": cabin_w, "cabin_off": cabin_off,
            "wheel_r": wheel_r}


def render_cars3d_all(size: int = 64, factor_sizes=None) -> np.ndarray:
    """(N, size, size, 3) uint8 images of the grid ``factor_sizes`` (the
    full grid by default) in index order; the (elevation, azimuth) blocks
    render on a pool of threads (numpy releases the GIL in its loops), each
    as the JAX function renders it."""
    fs = list(CARS3D_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    f_el, f_az, f_ob = fs
    n_images = int(np.prod(fs))
    p = _object_params(f_ob)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    edge = 1.1
    r_ref = size * 0.62                      # reference half-extent in px

    az = 2.0 * np.pi * np.arange(f_az) / f_az
    elev_frac = np.arange(f_el) / max(f_el - 1, 1)

    out = np.empty((n_images, size, size, 3), np.uint8)
    white = 248.0

    def block(el: int, a: int) -> None:
        vsq = 1.0 - 0.35 * elev_frac[el]     # vertical squash with pitch
        cy = size * (0.56 - 0.06 * elev_frac[el])
        roof_vis = 0.12 + 0.55 * elev_frac[el]
        c = np.cos(az[a])
        w_frac = 0.30 + 0.70 * abs(c)        # foreshortened length
        heading = 1.0 if c >= 0 else -1.0
        # vectorize over all the objects at once
        L = (p["length"] * w_frac * r_ref)[:, None, None]   # (O,1,1)
        H = (p["height"] * vsq * r_ref)[:, None, None]
        cx = size * 0.5
        dx = xx[None] - cx                                   # (O,S,S)
        dy = yy[None] - cy

        # body: rounded box
        d_body = np.maximum(np.abs(dx) - L, np.abs(dy) - H) - 1.5
        a_body = np.clip(0.5 - d_body / edge, 0.0, 1.0)

        # cabin: narrower box on top, offset toward heading
        Lc = L * p["cabin_w"][:, None, None]
        Hc = (p["cabin_h"] * vsq * r_ref)[:, None, None]
        ox = heading * (p["cabin_off"] * w_frac * r_ref)[:, None, None]
        d_cab = np.maximum(np.abs(dx - ox) - Lc,
                           np.abs(dy + H + Hc * 0.9) - Hc)
        a_cab = np.clip(0.5 - d_cab / edge, 0.0, 1.0)

        # wheels: two dark ellipses under the body, squashed by |cos|
        Wr = (p["wheel_r"] * r_ref)[:, None, None]
        wx = 0.62 * L
        wy = H + 0.35 * Wr
        d_w1 = (np.sqrt(((dx - wx) / np.maximum(0.35 + 0.65 * abs(c),
                                                1e-3)) ** 2
                        + (dy - wy) ** 2) - Wr)
        d_w2 = (np.sqrt(((dx + wx) / np.maximum(0.35 + 0.65 * abs(c),
                                                1e-3)) ** 2
                        + (dy - wy) ** 2) - Wr)
        a_wh = np.clip(0.5 - np.minimum(d_w1, d_w2) / edge, 0.0, 1.0)

        # windshield (dark, heading side of cabin) / tail light (red, rear
        # end of body): break the az ~ az+180 ambiguity
        d_ws = np.maximum(np.abs(dx - ox - heading * Lc * 0.8) - Lc * 0.28,
                          np.abs(dy + H + Hc * 0.9) - Hc * 0.8)
        a_ws = np.clip(0.5 - d_ws / edge, 0.0, 1.0) * a_cab
        d_tl = np.maximum(np.abs(dx + heading * L) - 2.2,
                          np.abs(dy + H * 0.3) - 2.2)
        a_tl = np.clip(0.5 - d_tl / edge, 0.0, 1.0) * a_body

        # roof ellipse (visible with elevation): slightly darker body
        d_rf = (np.sqrt((dx / np.maximum(L, 1e-3)) ** 2
                        + ((dy + H) / np.maximum(
                            roof_vis * H + 2.0, 1e-3)) ** 2) - 1.0)
        a_rf = np.clip(0.5 - d_rf / 0.08, 0.0, 1.0)

        rgb = p["rgb"][:, None, None, :]                    # (O,1,1,3)
        img = np.full((f_ob, size, size, 3), white, np.float32)
        a_car = np.maximum(a_body, a_cab)
        img = (1 - a_car[..., None]) * img + a_car[..., None] * rgb
        img = (1 - a_rf[..., None]) * img + a_rf[..., None] * rgb * 0.8
        img = (1 - a_wh[..., None]) * img + a_wh[..., None] * np.array(
            [45, 45, 48], np.float32)
        img = ((1 - a_ws[..., None]) * img + a_ws[..., None] * np.array(
            [60, 80, 105], np.float32))
        img = ((1 - a_tl[..., None]) * img + a_tl[..., None] * np.array(
            [200, 40, 40], np.float32))
        # shadow under the car grounds it (as the real renders have)
        d_sh = (np.sqrt((dx / np.maximum(L * 1.1, 1e-3)) ** 2
                        + ((dy - H - 3.0) / 3.5) ** 2) - 1.0)
        a_sh = np.clip(0.5 - d_sh / 0.15, 0.0, 1.0) * 0.25
        img = (1 - a_sh[..., None]) * img

        # index order: index = (el*24 + az)*183 + obj
        idx = (el * f_az + a) * f_ob
        np.copyto(out[idx:idx + f_ob], np.clip(img, 0, 255).astype(np.uint8))

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        list(pool.map(lambda ea: block(*ea),
                      [(el, a) for el in range(f_el) for a in range(f_az)]))
    return out


#: rendered grids of this process, by (image_size, factor sizes)
_CACHE: dict[tuple, np.ndarray] = {}


def get_cars3d_images(size: int = 64, factor_sizes=None) -> np.ndarray:
    """The grid at ``factor_sizes``, rendered once per process."""
    fs = tuple(CARS3D_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    key = (size, fs)
    if key not in _CACHE:
        t0 = time.perf_counter()
        _CACHE[key] = render_cars3d_all(size, factor_sizes=list(fs))
        print(f"[data] cars3d grid {list(fs)}: {len(_CACHE[key])} images at "
              f"{size} px rendered on the host in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
    return _CACHE[key]


class SyntheticCars3DFull(ArrayDataset):
    """The full 17,568-image grid in index order (pair with ``eval_name:
    cars3d``): the validation data, whose sweep covers the ground truth's
    index table. ``device`` (the harness passes its own) is accepted and
    not used: the grid renders on the host."""

    factor_sizes = CARS3D_FACTOR_SIZES

    def __init__(self, image_size: int = 64, factor_sizes=None, **kwargs):
        del kwargs
        if factor_sizes is not None:
            self.factor_sizes = list(factor_sizes)
        super().__init__(get_cars3d_images(image_size, self.factor_sizes),
                         with_idx=True)


class SyntheticCars3DFullTrain(SyntheticCars3DFull):
    """The training view with the reference's x10 epoch repeat: one epoch
    cycles the grid ten times. Its rows are the validation view's array."""

    repeat = 10

    def __init__(self, image_size: int = 64, **kwargs):
        super().__init__(image_size=image_size, **kwargs)
        self.length = len(self.images) * self.repeat

    def __getitem__(self, index: int):
        return super().__getitem__(index % len(self.images))

    def batch_uint8(self, indices: np.ndarray) -> np.ndarray:
        return super().batch_uint8(np.asarray(indices) % len(self.images))
