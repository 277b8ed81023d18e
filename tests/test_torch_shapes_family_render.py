"""The port's v1, v2, v3 and bands renderers and the shapes family's grids,
held against the JAX package's, on the CPU.

- Each renderer (``data/synthetic_shapes.py``) gives the JAX renderer's
  bytes at small grids with several blocks (or chunks of rows) of every
  hue factor, on one host thread and on eight (v4:
  ``tests/test_torch_shapes_render.py``).
- Every dataset class of the family has the JAX class's factor sizes, and
  at a small grid (both packages' classes patched alike) its length and its
  first and last rows.
- The in-process cache is keyed on the renderer too: the v1 and v4 grids
  at the same sizes are different arrays in one process, and
  ``clear_cache`` drops both.
- The v1 ground truth (``eval_name: synthetic_shapes``, 27,648 rows) has
  the JAX table's factor sizes, bases and indices.
"""

import numpy as np
import pytest

from encdiff_tpu.data import synthetic_shapes as jshapes
from encdiff_tpu.evalx.ground_truth import named_data as jnamed
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.evalx.ground_truth import named_data

JAX_RENDERERS = {"v1": jshapes.render_all, "v2": jshapes.render_all_v2,
                 "v3": jshapes.render_all_v3, "bands": jshapes.render_bands}
#: several blocks of every hue factor (one shape in the second); with
#: ``_BAND_CHUNK`` and ``_GEO_CHUNK`` patched to 7, chunks of rows and of
#: a hue block's images end inside a block and at its end
GRIDS = ([3, 2, 2, 2, 4, 3], [2, 3, 4, 2, 1, 2], [2, 1, 2, 3, 4, 5])
CLASSES = ["SyntheticShapes3D", "SyntheticShapes3DTrain",
           "SyntheticShapes3DFull", "SyntheticShapes3DFullTrain",
           "SyntheticShapes3DV2Full", "SyntheticShapes3DV2FullTrain",
           "SyntheticShapes3DV3Full", "SyntheticShapes3DV3FullTrain",
           "SyntheticBands", "SyntheticBandsTrain", "SyntheticBandsFull",
           "SyntheticBandsFullTrain"]
TINY = [2, 2, 3, 2, 2, 3]


@pytest.fixture
def empty_caches(tmp_path, monkeypatch):
    """Both packages' in-process caches emptied before and after, the JAX
    classes' disk cache under ``tmp_path``."""
    monkeypatch.setenv("ENCDIFF_DATA_CACHE", str(tmp_path))
    jshapes._CACHE.clear()
    synthetic_shapes.clear_cache()
    yield
    jshapes._CACHE.clear()
    synthetic_shapes.clear_cache()


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("fs", GRIDS, ids=str)
@pytest.mark.parametrize("renderer", sorted(JAX_RENDERERS))
def test_renderer_matches_jax(renderer, fs, threads, monkeypatch):
    monkeypatch.setattr(synthetic_shapes, "RENDER_THREADS", threads)
    monkeypatch.setattr(synthetic_shapes, "_BAND_CHUNK", 7)
    monkeypatch.setattr(synthetic_shapes, "_GEO_CHUNK", 7)
    got = synthetic_shapes.RENDERERS[renderer](64, factor_sizes=fs)
    want = JAX_RENDERERS[renderer](64, factor_sizes=fs)
    assert got.dtype == np.uint8 and got.shape == (int(np.prod(fs)), 64,
                                                   64, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CLASSES)
def test_dataset_class_matches_jax(name, empty_caches, monkeypatch):
    ours, theirs = getattr(synthetic_shapes, name), getattr(jshapes, name)
    assert list(ours.factor_sizes) == list(theirs.factor_sizes)
    full = "Full" in name
    assert list(ours.factor_sizes) == (jshapes.FULL_FACTOR_SIZES if full
                                       else jshapes.FACTOR_SIZES)
    monkeypatch.setattr(ours, "factor_sizes", TINY)
    monkeypatch.setattr(theirs, "factor_sizes", TINY)
    got, want = ours(image_size=32, device="cpu"), theirs(image_size=32)
    assert len(got) == len(want) == int(np.prod(TINY))
    assert isinstance(got.images, np.ndarray)
    for i in (0, len(want) - 1):
        np.testing.assert_array_equal(got.images[i],
                                      np.asarray(want.images)[i])
    # the train and validation views of one grid hold one array
    assert ours(image_size=32).images is got.images


def test_the_cache_tells_the_renderers_apart(empty_caches):
    fs = [2, 2, 2, 2, 2, 2]
    v1 = synthetic_shapes.get_images("v1", 32, fs)
    v4 = synthetic_shapes.get_images("v4", 32, fs)
    bands = synthetic_shapes.get_images("bands", 32, fs)
    assert not np.array_equal(v1, v4) and not np.array_equal(v1, bands)
    np.testing.assert_array_equal(v1, jshapes.render_all(32, factor_sizes=fs))
    np.testing.assert_array_equal(v4, jshapes.render_all_v4(
        32, factor_sizes=fs))
    assert synthetic_shapes.get_images("v1", 32, fs) is v1
    assert len(synthetic_shapes._CACHE) == 3
    synthetic_shapes.clear_cache()
    assert synthetic_shapes._CACHE == {}
    assert synthetic_shapes.get_images("v1", 32, fs) is not v1


def test_full_v1_and_v4_classes_hold_different_grids(empty_caches,
                                                     monkeypatch):
    """The fault this slice repairs: the cache was keyed on the sizes
    alone, so the v1 full grid came back as the v4 grid's array."""
    for cls in (synthetic_shapes.SyntheticShapes3DFull,
                synthetic_shapes.SyntheticShapes3DV4Full,
                synthetic_shapes.SyntheticBandsFull):
        monkeypatch.setattr(cls, "factor_sizes", [2, 1, 2, 2, 2, 2])
    v4 = synthetic_shapes.SyntheticShapes3DV4FullTrain(image_size=32).images
    v1 = synthetic_shapes.SyntheticShapes3DFullTrain(image_size=32).images
    bands = synthetic_shapes.SyntheticBandsFullTrain(image_size=32).images
    assert v1 is not v4 and not np.array_equal(v1, v4)
    assert not np.array_equal(v1, bands)


def test_v1_ground_truth_matches_jax():
    ours = named_data.get_index_dataset("synthetic_shapes")
    theirs = jnamed.get_index_dataset("synthetic_shapes")
    assert len(ours.images) == len(theirs.images) == 27_648
    assert ours.factors_num_values == theirs.factors_num_values == \
        jshapes.FACTOR_SIZES
    np.testing.assert_array_equal(ours.factor_bases, theirs.factor_bases)
    rs = np.random.RandomState(0)
    factors = ours.sample_factors(64, rs)
    np.testing.assert_array_equal(ours.factors_to_index(factors),
                                  theirs.factors_to_index(factors))
    # the grid's row i has the factors whose index is i
    np.testing.assert_array_equal(
        ours.factors_to_index(np.stack(np.unravel_index(
            np.arange(27_648), jshapes.FACTOR_SIZES), 1)),
        np.arange(27_648))
