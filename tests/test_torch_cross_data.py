"""The port's MPI3D and Cars3D grids held against the JAX renderers, on the
CPU.

- ``render_mpi3d_all`` gives the JAX renderer's bytes at reduced factor
  sizes, through the numpy composition and through the torch composition
  on ``device="cpu"`` (the same float32 operations in the same order as on
  the card); ``render_cars3d_all`` (numpy) gives the JAX renderer's bytes.
- The first nine (camera, background) blocks of a grid are the render of
  the sub-grid with one colour, shape and size: ``chip_smoke.py`` holds
  the card's grid against that numpy render.
- ``SyntheticMPI3DFullTrain(subset_frac=0.25)`` selects the JAX class's
  rows, on the host and as a tensor.
- ``SyntheticCars3DFullTrain``'s ``len``, ``__getitem__`` and
  ``batch_uint8`` wrap as the JAX class's do (the x10 repeat).
- The train and validation views of one grid hold one array, and the
  harness's device cache uploads it once for both.
- The two modules import nothing of JAX or of the JAX package.
"""

import pathlib

import numpy as np
import pytest
import torch

from encdiff_tpu.data import synthetic_cars3d as jcars
from encdiff_tpu.data import synthetic_mpi3d as jmpi
from encdiff_tpu_torch.data import synthetic_cars3d as cars
from encdiff_tpu_torch.data import synthetic_mpi3d as mpi
from encdiff_tpu_torch.evalx.ground_truth import datasets as gt
from encdiff_tpu_torch.train import harness
from test_torch_port_slice import BANNED, _imports
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
MPI_GRIDS = ([2, 2, 2, 2, 2, 5, 4], [2, 3, 2, 3, 3, 4, 4])
CARS_GRIDS = ([2, 4, 7], [3, 5, 4])
MPI_TINY = [2, 2, 2, 2, 2, 5, 4]   # 640 images
CARS_TINY = [2, 4, 7]              # 56 images


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    """The JAX classes' disk cache under ``tmp_path``; every in-process
    cache emptied before and after."""
    monkeypatch.setenv("ENCDIFF_DATA_CACHE", str(tmp_path))
    for m in (jmpi, jcars, mpi, cars):
        m._CACHE.clear()
    yield
    for m in (jmpi, jcars, mpi, cars):
        m._CACHE.clear()
    harness.clear_device_cache()


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("fs", MPI_GRIDS, ids=str)
def test_mpi3d_render_matches_jax(fs, device):
    want = jmpi.render_mpi3d_all(32, factor_sizes=fs)
    timings = {}
    got = mpi.render_mpi3d_all(32, fs, device=device, timings=timings)
    if device is None:
        assert isinstance(got, np.ndarray)
        assert sorted(timings) == ["geometry_s"]
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert sorted(timings) == ["compose_s", "geometry_s", "upload_s"]
        got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fs", CARS_GRIDS, ids=str)
def test_cars3d_render_matches_jax(fs):
    want = jcars.render_cars3d_all(32, factor_sizes=fs)
    np.testing.assert_array_equal(cars.render_cars3d_all(32, fs), want)


def test_first_blocks_are_the_one_object_sub_grid():
    """Colour 0, shape 0 and size 0 render alike at any count of colours,
    shapes and sizes, so the grid's first f_cam x f_bg blocks are the
    sub-grid (1, 1, 1, f_cam, f_bg, f_hor, f_ver)."""
    fs = [3, 2, 2, 3, 3, 4, 4]
    sub = mpi.render_mpi3d_all(32, [1, 1, 1, *fs[3:]])
    full = mpi.render_mpi3d_all(32, fs, device="cpu")
    assert len(sub) == 9 * 16
    np.testing.assert_array_equal(full[:len(sub)].numpy(), sub)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_mpi3d_subset_selects_the_jax_rows(jax_cache, device):
    want = jmpi.SyntheticMPI3DFullTrain(image_size=32, factor_sizes=MPI_TINY,
                                        subset_frac=0.25, subset_seed=5)
    got = mpi.SyntheticMPI3DFullTrain(image_size=32, factor_sizes=MPI_TINY,
                                      subset_frac=0.25, subset_seed=5,
                                      device=device)
    assert len(got) == len(want) == 160
    images = (got.images.numpy() if device else got.images)
    np.testing.assert_array_equal(images, want.images)
    assert images.flags["C_CONTIGUOUS"]
    rows = np.array([0, 17, 159])
    np.testing.assert_array_equal(got.batch_uint8(rows),
                                  want.batch_uint8(rows))
    np.testing.assert_array_equal(got[7]["image"], want[7]["image"])
    assert got[7]["idx"] == want[7]["idx"] == 7


def test_cars3d_repeat_wraps_as_jax(jax_cache):
    class Tiny(cars.SyntheticCars3DFullTrain):
        factor_sizes = CARS_TINY

    class JTiny(jcars.SyntheticCars3DFullTrain):
        factor_sizes = CARS_TINY

    got, want = Tiny(image_size=32), JTiny(image_size=32)
    n = int(np.prod(CARS_TINY))
    assert len(got) == len(want) == 10 * n
    for i in (0, 5, n, n + 5, 10 * n - 1):
        item, ref = got[i], want[i]
        np.testing.assert_array_equal(item["image"], ref["image"])
        assert item["image"].dtype == ref["image"].dtype == np.float32
        assert item["idx"] == ref["idx"] == i % n
    rows = np.array([1, n + 1, 3 * n + 1, 10 * n - 2])
    np.testing.assert_array_equal(got.batch_uint8(rows),
                                  want.batch_uint8(rows))
    full = cars.SyntheticCars3DFull(image_size=32, factor_sizes=CARS_TINY)
    assert len(full) == n


@pytest.mark.parametrize("which", ["mpi3d host", "mpi3d tensor", "cars3d"])
def test_train_and_validation_views_share_one_array(jax_cache, which):
    if which == "cars3d":
        kw = dict(image_size=32, factor_sizes=CARS_TINY)
        train = cars.SyntheticCars3DFullTrain(**kw)
        val = cars.SyntheticCars3DFull(**kw)
    else:
        kw = dict(image_size=32, factor_sizes=MPI_TINY,
                  device="cpu" if which == "mpi3d tensor" else None)
        train = mpi.SyntheticMPI3DFullTrain(**kw)
        val = mpi.SyntheticMPI3DFull(**kw)
        assert train.render_timings and not val.render_timings
    assert train.images is val.images
    first = harness.device_images(train.images, "cpu")
    assert harness.device_images(val.images, "cpu") is first
    if which == "mpi3d tensor":  # taken as it is, no copy
        assert first is train.images


def test_factor_tables_match_the_ground_truth():
    assert mpi.MPI3D_FACTOR_SIZES == jmpi.MPI3D_FACTOR_SIZES
    assert cars.CARS3D_FACTOR_SIZES == jcars.CARS3D_FACTOR_SIZES
    assert mpi.N_IMAGES_MPI3D == gt.MPI3D.N == 1_036_800
    assert cars.N_IMAGES_CARS3D == gt.Cars3D.N == 17_568
    assert gt.MPI3D().factors_num_values == mpi.MPI3D_FACTOR_SIZES
    assert gt.Cars3D().factors_num_values == cars.CARS3D_FACTOR_SIZES


@pytest.mark.parametrize("module", ["datasets", "synthetic_mpi3d",
                                    "synthetic_cars3d"])
def test_modules_import_no_jax(module):
    path = ROOT / "encdiff_tpu_torch" / "data" / f"{module}.py"
    names = list(_imports(path))
    assert names
    for name in names:
        for banned in BANNED:
            assert not (name == banned or name.startswith(banned + ".")), name
