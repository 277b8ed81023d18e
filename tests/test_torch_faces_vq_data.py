"""The faces VQ-GAN's data: the port's face grid byte for byte, on the CPU.

- ``render_faces`` with its colour blocks composed by torch (``device``;
  here on the CPU, on the card in ``chip_smoke.py``) gives the bytes of its
  numpy composite, on ``TRAIN_GRID`` at 256 px and on the full grid's first
  block (every geometry of the full grid, the first background, skin and
  hair colour: the first 144 images of the 34,560).
- The port's ``render_faces`` gives the bytes of the JAX package's on a
  sub-grid.
- ``SyntheticFacesTrain`` holds the grid of its ``factor_sizes``, rendered
  once per process, with the seconds the render took.
"""

import numpy as np
import pytest

from encdiff_tpu.data.synthetic_faces import render_faces as jax_render_faces
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.data.synthetic_faces import (FACE_FACTOR_SIZES,
                                                    TRAIN_GRID, render_faces)

FIRST_BLOCK = [1, 1, 1, *FACE_FACTOR_SIZES[3:]]


@pytest.mark.parametrize("grid", [TRAIN_GRID, FIRST_BLOCK],
                         ids=["train_grid", "full_grid_first_block"])
def test_torch_composite_gives_numpy_bytes(grid):
    want = render_faces(256, grid)
    got = render_faces(256, grid, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (int(np.prod(grid)), 256,
                                                   256, 3)
    assert np.array_equal(got, want)


def test_render_gives_the_jax_bytes():
    grid = (2, 2, 2, 2, 2, 2, 2)
    want = jax_render_faces(64, grid)
    assert np.array_equal(render_faces(64, grid), want)
    assert np.array_equal(render_faces(64, grid, device="cpu"), want)


def test_synthetic_faces_train_holds_its_grid(monkeypatch):
    grid = (2, 1, 2, 1, 2, 1, 2)
    monkeypatch.setattr(synthetic_faces.SyntheticFaces, "factor_sizes", grid)
    monkeypatch.setattr(synthetic_faces, "_CACHE", {})
    ds = synthetic_faces.SyntheticFacesTrain(image_size=32)
    assert len(ds) == 16 and ds.render_s > 0
    assert np.array_equal(ds.images, render_faces(32, grid))
    again = synthetic_faces.SyntheticFacesTrain(image_size=32)
    assert again.images is ds.images and again.render_s == 0.0
