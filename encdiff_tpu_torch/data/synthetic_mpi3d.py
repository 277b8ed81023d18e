"""Procedural MPI3D grid: the MPI3D configuration's training data.

A copy of ``encdiff_tpu/data/synthetic_mpi3d.py`` (``_shape_sdf_and_shade``,
``render_mpi3d_all``, the two dataset classes), so that the port makes the
MPI3D chain's images (``-b mpi3d_vq``, ``-b mpi3d``) without importing the
JAX package. Real MPI3D's seven factors in index order,

    object_color(6) x object_shape(6) x object_size(2) x camera_height(3)
    x background_color(3) x horizontal_axis(40) x vertical_axis(40)
    ->  N = 1,036,800 images, 64x64x3 (12,740,198,400 B of uint8),

drawn as an articulated arm on a stage whose tip, carrying the object,
follows the two 40-level DOFs. Index = dot(factors, bases), the order of
``evalx.ground_truth.datasets.MPI3D`` (``eval_name: mpi3d``).

``render_mpi3d_all`` draws the geometry with numpy, as the JAX function
does, on a pool of threads: the arm's coverage for each camera height and
the object's coverage and shading for each of the 36 (shape, size, camera
height), each a block over the 1,600 (horizontal, vertical) combinations.
It then composes the 648
(colour, shape, size, camera, background) blocks over them: with numpy by
default, or with torch on ``device``, the same elementwise float32
operations in the same order (each one rounds as numpy's does, and the
clip and the cast to uint8 truncate the same way), which gives the same
bytes. On a card the composed grid stays there: the dataset's ``images``
is then the device tensor, which ``train.harness.device_images`` takes as
it is, so the card holds one copy and the host none.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from encdiff_tpu_torch.data.datasets import RENDER_THREADS, ArrayDataset
from encdiff_tpu_torch.data.synthetic_shapes import _hue_rgb

#: real MPI3D factor sizes in the real index order
MPI3D_FACTOR_SIZES = [6, 6, 2, 3, 3, 40, 40]
N_IMAGES_MPI3D = int(np.prod(MPI3D_FACTOR_SIZES))  # 1,036,800


def _shape_sdf_and_shade(sh: int, rx, ry, r):
    """Signed distance + interior shading for shape family ``sh`` on
    rotated-frame coords (rx, ry), radius r. Equal-area radii and
    mean-normalized shade: area is a pure size cue, interior pattern a pure
    shape cue."""
    if sh == 0:      # square, two flat facets
        d = np.maximum(np.abs(rx), np.abs(ry)) - r * 0.886
        s = 0.84 + 0.16 * np.clip(rx / 1.2 + 0.5, 0.0, 1.0)
    elif sh == 1:    # circle (sphere): offset radial falloff
        d = np.sqrt(rx * rx + ry * ry) - r
        rr = np.sqrt((rx + 0.35 * r) ** 2 + (ry + 0.35 * r) ** 2) / max(r, 1.0)
        s = 1.05 - 0.28 * np.clip(rr, 0.0, 1.6)
    elif sh == 2:    # triangle (cone): apex-to-base ramp
        k = r * 1.253
        d = 0.5 * np.maximum(np.abs(rx) * 2.0 - (ry + k), np.abs(ry) - k)
        s = 1.04 - 0.26 * np.clip((ry + k) / (2.0 * k), 0.0, 1.0)
    elif sh == 3:    # diamond: diagonal ramp
        d = (np.abs(rx) + np.abs(ry) - r * 1.253) * 0.7071
        s = 0.82 + 0.26 * np.clip((rx + ry) / (2.6 * r) + 0.5, 0.0, 1.0)
    elif sh == 4:    # hexagon: concentric ring shading
        ax, ay = np.abs(rx), np.abs(ry)
        k = r * 1.05
        d = np.maximum(ax * 0.866 + ay * 0.5, ay) - k
        s = 0.85 + 0.24 * np.clip(np.maximum(ax, ay) / k, 0.0, 1.0)
    else:            # cross/plus: checker-free two-arm shading
        k = r * 1.35
        bar = np.minimum(np.maximum(np.abs(rx) - 0.4 * k, np.abs(ry) - k),
                         np.maximum(np.abs(rx) - k, np.abs(ry) - 0.4 * k))
        d = bar
        s = 0.88 + 0.22 * np.clip((np.abs(rx) - np.abs(ry)) / k + 0.5,
                                  0.0, 1.0)
    return d, s


def _geometry(size: int, fs):
    """The geometry pass: ``arm_alpha`` by camera height and ``geo_alpha``,
    ``geo_shade`` by (shape, size, camera height), each (1600, size, size,
    1) float32 over the (horizontal, vertical) combinations; the blocks are
    drawn on a pool of threads (numpy releases the GIL in its loops), each
    as the JAX function draws it."""
    f_col, f_shp, f_siz, f_cam, f_bg, f_hor, f_ver = fs
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    edge = 1.2
    # arm geometry: pivot at bottom-center; tip sweeps an arc
    th_h = np.deg2rad(-55.0 + 110.0 * (np.arange(f_hor) /
                                       max(f_hor - 1, 1))).astype(np.float32)
    th_v = (np.arange(f_ver) / max(f_ver - 1, 1)).astype(np.float32)
    radii_obj = [5.0, 8.0][:f_siz] if f_siz <= 2 else [
        4.0 + 5.0 * i / max(f_siz - 1, 1) for i in range(f_siz)]

    def tips(cam: int):
        """The pivot and the (HV,) tip positions at camera height ``cam``:
        the horizontal axis sets azimuth (x), the vertical axis how far up
        the arc the arm reaches (y + slight x foreshortening)."""
        pivot_y = size * (0.97 - 0.06 * cam)
        pivot_x = size * 0.5
        arm_len = size * (0.62 - 0.05 * cam)
        reach = 0.35 + 0.62 * th_v                       # (V,)
        tx = (pivot_x + arm_len * np.sin(th_h)[:, None]
              * (0.75 + 0.25 * reach[None, :]))          # (H, V)
        ty = pivot_y - arm_len * reach[None, :] * np.cos(
            0.5 * th_h)[:, None]                         # (H, V)
        return pivot_x, pivot_y, tx.reshape(-1), ty.reshape(-1)

    def arm(cam: int) -> np.ndarray:
        """Distance from each pixel to the pivot->tip segment (vectorized
        over the HV block), 1.6 px half-width."""
        pivot_x, pivot_y, tx, ty = tips(cam)
        px = xx[None] - pivot_x                          # (1, S, S)
        py = yy[None] - pivot_y
        vx = (tx - pivot_x)[:, None, None]               # (HV, 1, 1)
        vy = (ty - pivot_y)[:, None, None]
        vv = vx * vx + vy * vy
        t = np.clip((px * vx + py * vy) / np.maximum(vv, 1e-6), 0.0, 1.0)
        dist = np.sqrt((px - t * vx) ** 2 + (py - t * vy) ** 2)
        return np.clip(0.5 - (dist - 1.6) / edge,
                       0.0, 1.0)[..., None].astype(np.float32)

    def obj(cam: int, sh: int, sz: int):
        _, _, tx, ty = tips(cam)
        r = radii_obj[sz]
        dx = xx[None] - tx[:, None, None]                # (HV, S, S)
        dy = yy[None] - ty[:, None, None]
        # slight in-plane rotation with the horizontal DOF (the object turns
        # as the arm swings, like the real rig)
        ang = 0.3 * np.repeat(th_h, f_ver)[:, None, None]
        ca, sa = np.cos(ang), np.sin(ang)
        rx, ry = ca * dx + sa * dy, -sa * dx + ca * dy
        d, s = _shape_sdf_and_shade(sh % 6, rx, ry, r)
        a = np.clip(0.5 - d / edge, 0.0, 1.0)
        # mean-normalize shading inside each mask so brightness leaks
        # neither size nor shape
        m = a > 0.5
        cnt = np.maximum(m.sum(axis=(1, 2)), 1)
        mean_s = (s * m).sum(axis=(1, 2)) / cnt
        s = s * (0.92 / np.maximum(mean_s, 1e-6))[:, None, None]
        return a[..., None].astype(np.float32), s[..., None].astype(np.float32)

    keys = [(sh, sz, cam) for cam in range(f_cam) for sh in range(f_shp)
            for sz in range(f_siz)]
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        arms = list(pool.map(arm, range(f_cam)))
        objs = list(pool.map(lambda k: obj(k[2], k[0], k[1]), keys))
    arm_alpha = dict(enumerate(arms))
    geo_alpha = {k: a for k, (a, _) in zip(keys, objs)}
    geo_shade = {k: s for k, (_, s) in zip(keys, objs)}
    return arm_alpha, geo_alpha, geo_shade


#: the stage's muted background tones (real MPI3D: gray-green/gray-blue)
_BG_TONES = np.array([[168, 168, 168], [150, 168, 150], [150, 158, 172]],
                     np.float32)
_ARM_COLOR = np.array([70, 70, 74], np.float32)


def _floor_line(size: int, cam: int) -> int:
    """The first row below the floor line, which tracks camera height."""
    return int(size * (0.80 - 0.05 * cam))


def render_mpi3d_all(size: int = 64, factor_sizes=None, device=None,
                     timings: dict | None = None):
    """The complete grid ``factor_sizes`` (the full grid by default): (N,
    size, size, 3) uint8 in MPI3D's index order, a numpy array, or with
    ``device`` a torch tensor on it (the same bytes). ``timings``, where
    given, receives the seconds of the geometry pass (``geometry_s``) and,
    on a device, of the geometry's upload (``upload_s``) and of the
    composition (``compose_s``)."""
    fs = list(MPI3D_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    arm_alpha, geo_alpha, geo_shade = _geometry(size, fs)
    timings["geometry_s"] = time.perf_counter() - t0
    if device is not None:
        return _compose_torch(size, fs, arm_alpha, geo_alpha, geo_shade,
                              torch.device(device), timings)
    f_col, f_shp, f_siz, f_cam, f_bg, f_hor, f_ver = fs
    n_hv = f_hor * f_ver
    obj_colors = np.stack([_hue_rgb(i, f_col, s=0.95, v=0.95)
                           for i in range(f_col)])
    out = np.empty((int(np.prod(fs)), size, size, 3), np.uint8)
    # composition pass in index order: col, shp, siz, cam, bg | hor, ver
    idx = 0
    for col in range(f_col):
        for sh in range(f_shp):
            for sz in range(f_siz):
                for cam in range(f_cam):
                    a_obj = geo_alpha[(sh, sz, cam)]
                    col_obj = obj_colors[col] * geo_shade[(sh, sz, cam)]
                    a_arm = arm_alpha[cam]
                    for bg in range(f_bg):
                        blk = np.empty((n_hv, size, size, 3), np.float32)
                        blk[:] = _BG_TONES[bg]
                        blk[:, _floor_line(size, cam):] *= 0.82
                        blk = (1.0 - a_arm) * blk + a_arm * _ARM_COLOR
                        blk = (1.0 - a_obj) * blk + a_obj * col_obj
                        np.copyto(out[idx:idx + n_hv],
                                  np.clip(blk, 0, 255).astype(np.uint8))
                        idx += n_hv
    assert idx == len(out)
    return out


def _compose_torch(size, fs, arm_alpha, geo_alpha, geo_shade, device,
                   timings) -> torch.Tensor:
    """``render_mpi3d_all``'s composition with torch on ``device``: each
    operation of the numpy loop, on the same float32 operands, in the same
    order, into one uint8 tensor on ``device``. The geometry goes up once
    (1.9 GB at the full grid: 36 object and 3 arm blocks) and is released
    at the end."""
    f_col, f_shp, f_siz, f_cam, f_bg, f_hor, f_ver = fs
    n_hv = f_hor * f_ver
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    arm = {k: on(v) for k, v in arm_alpha.items()}
    alpha = {k: on(v) for k, v in geo_alpha.items()}
    shade = {k: on(v) for k, v in geo_shade.items()}
    obj_colors = on(np.stack([_hue_rgb(i, f_col, s=0.95, v=0.95)
                              for i in range(f_col)]))
    bg_tones, arm_color = on(_BG_TONES), on(_ARM_COLOR)
    sync()
    t1 = time.perf_counter()
    timings["upload_s"] = t1 - t0
    out = torch.empty((int(np.prod(fs)), size, size, 3), dtype=torch.uint8,
                      device=device)
    idx = 0
    for col in range(f_col):
        for sh in range(f_shp):
            for sz in range(f_siz):
                for cam in range(f_cam):
                    a_obj = alpha[(sh, sz, cam)]
                    col_obj = obj_colors[col] * shade[(sh, sz, cam)]
                    a_arm = arm[cam]
                    for bg in range(f_bg):
                        blk = bg_tones[bg].expand(n_hv, size, size,
                                                  3).clone()
                        blk[:, _floor_line(size, cam):] *= 0.82
                        blk = (1.0 - a_arm) * blk + a_arm * arm_color
                        blk = (1.0 - a_obj) * blk + a_obj * col_obj
                        out[idx:idx + n_hv] = blk.clamp(0, 255).to(
                            torch.uint8)
                        idx += n_hv
    del arm, alpha, shade
    sync()
    timings["compose_s"] = time.perf_counter() - t1
    return out


#: rendered grids of this process, by (image_size, factor sizes, device)
_CACHE: dict[tuple, object] = {}


def get_mpi3d_images(size: int = 64, factor_sizes=None, device=None,
                     timings: dict | None = None):
    """The grid at ``factor_sizes``, rendered once per process and device:
    a numpy array without ``device``, else a tensor on it. ``timings``
    receives the render's seconds when this call renders."""
    fs = tuple(MPI3D_FACTOR_SIZES if factor_sizes is None else factor_sizes)
    key = (size, fs, None if device is None else str(torch.device(device)))
    if key not in _CACHE:
        timings = {} if timings is None else timings
        _CACHE[key] = render_mpi3d_all(size, list(fs), device=device,
                                       timings=timings)
        print(f"[data] mpi3d grid {list(fs)}: {len(_CACHE[key])} images at "
              f"{size} px, geometry on the host, composed on "
              f"{device or 'the host by numpy'}: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in timings.items()), flush=True)
    return _CACHE[key]


def clear_cache() -> None:
    """Drop the grids this process holds (a card's memory included)."""
    on_card = any(isinstance(v, torch.Tensor) and v.is_cuda
                  for v in _CACHE.values())
    _CACHE.clear()
    if on_card:
        torch.cuda.empty_cache()


class SyntheticMPI3DFull(ArrayDataset):
    """The full 1,036,800-image grid in index order (pair with
    ``eval_name: mpi3d``), composed on ``device`` (the harness passes its
    own; None composes with numpy on the host). ``render_timings`` holds
    the render's seconds when this instance rendered it, else is empty.
    The JAX class keeps the grid on the host and the JAX harness streams
    it (its device gate is 8e9 bytes); the port keeps it on the card."""

    factor_sizes = MPI3D_FACTOR_SIZES

    def __init__(self, image_size: int = 64, factor_sizes=None, device=None,
                 **kwargs):
        del kwargs
        if factor_sizes is not None:
            self.factor_sizes = list(factor_sizes)
        self.render_timings: dict = {}
        super().__init__(get_mpi3d_images(image_size, self.factor_sizes,
                                          device, self.render_timings),
                         with_idx=True)


class SyntheticMPI3DFullTrain(SyntheticMPI3DFull):
    """The training view of the grid. ``subset_frac`` draws a seeded
    uniform subset of the combinations, as the JAX class does
    (``np.random.default_rng(subset_seed).choice``, sorted), and holds it
    contiguous: a copy beside the full grid. At 1.0 (the config's) the
    view's rows are the validation view's array."""

    def __init__(self, image_size: int = 64, factor_sizes=None,
                 subset_frac: float = 1.0, subset_seed: int = 0, **kwargs):
        super().__init__(image_size, factor_sizes, **kwargs)
        if subset_frac < 1.0:
            n = len(self.images)
            k = int(n * subset_frac)
            sel = np.sort(np.random.default_rng(subset_seed).choice(
                n, size=k, replace=False))
            if isinstance(self.images, torch.Tensor):
                self.images = self.images[torch.from_numpy(sel).to(
                    self.images.device)]
            else:
                self.images = np.ascontiguousarray(self.images[sel])
            self.length = k
