"""``chip_smoke.py``'s digests of the shapes family's grids, derived again
from the JAX package's renderers on the CPU.

``SHAPES_DIGESTS`` holds, for each grid that shapes-render and
harness-data render on the card's host (the v1 and bands grids at 27,648
images; the v1, v2, v3, v4 and bands grids at 480,000), ``grid_digest`` of
the JAX renderer's bytes at 64 px. Each case renders one grid with the JAX
renderer on one core (up to about 4 minutes and 5.9 GB for a full grid)
and recomputes its digest. Marked ``slow``: run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_shapes_digests.py \\
        -m slow
"""

import importlib.util
from pathlib import Path

import pytest

from encdiff_tpu.data import synthetic_shapes as jshapes

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

JAX_RENDERERS = {"v1": jshapes.render_all, "v2": jshapes.render_all_v2,
                 "v3": jshapes.render_all_v3, "v4": jshapes.render_all_v4,
                 "bands": jshapes.render_bands}


@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(chip_smoke.SHAPES_DIGESTS), ids=str)
def test_digest_is_the_jax_renderers(key):
    renderer, factor_sizes = key
    images = JAX_RENDERERS[renderer](64, factor_sizes=list(factor_sizes))
    assert chip_smoke.grid_digest(images) == chip_smoke.SHAPES_DIGESTS[key]
