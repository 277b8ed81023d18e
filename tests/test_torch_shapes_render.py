"""The port's v4 shapes renderer (``data/synthetic_shapes.py``), whose hue
blocks are composed on ``RENDER_THREADS`` host threads, ``_GEO_CHUNK``
images at a time: byte for byte the JAX package's ``render_all_v4`` at
small grids with several blocks of every hue factor, on one thread and on
many, with chunks (patched to 7 images) that end inside a block and at its
end."""

import numpy as np
import pytest

from encdiff_tpu.data.synthetic_shapes import render_all_v4 as jax_render
from encdiff_tpu_torch.data import synthetic_shapes


@pytest.mark.parametrize("factor_sizes", [(3, 2, 2, 2, 4, 3),
                                          (2, 3, 4, 2, 1, 2),
                                          (2, 1, 2, 3, 4, 5)])
@pytest.mark.parametrize("threads", [1, 8])
def test_render_all_v4_matches_jax(factor_sizes, threads, monkeypatch):
    monkeypatch.setattr(synthetic_shapes, "RENDER_THREADS", threads)
    monkeypatch.setattr(synthetic_shapes, "_GEO_CHUNK", 7)
    got = synthetic_shapes.render_all_v4(64, factor_sizes=factor_sizes)
    want = jax_render(64, factor_sizes=factor_sizes)
    assert got.shape == (int(np.prod(factor_sizes)), 64, 64, 3)
    np.testing.assert_array_equal(got, want)
