"""The index-backed ground-truth factor datasets.

A copy of the index-backed classes of
``encdiff_tpu/evalx/ground_truth/datasets.py:25-111``, whose factor tables
are the reference's:

  Shapes3D             [10,10,10,8,4,15]            N=480000
  MPI3D                [6,6,2,3,3,40,40]            N=1036800
  Cars3D               [4,24,183]                   N=17568
  DSprites             [1,3,6,40,32,32], latents 1-5 N=737280
  SmallNORB            [5,10,9,18,6], latents 0,2,3,4
  SyntheticShapes      [6,6,6,4,4,8]                N=27648
  SyntheticShapesFull  [10,10,10,8,4,15]            N=480000 (the flagship)

Each is built over ``np.arange(N)`` by default, for the
representation-lookup trick.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset


class Shapes3D(IndexBackedDataset):
    """floor hue / wall hue / object hue / scale / shape / azimuth."""

    N = 480_000

    def __init__(self, images=None):
        if images is None:
            images = np.arange(self.N)
        super().__init__(images, [10, 10, 10, 8, 4, 15],
                         observation_shape=(64, 64, 3))


class MPI3D(IndexBackedDataset):
    """object color/shape/size, camera height, bg color, DOF1, DOF2."""

    N = 1_036_800

    def __init__(self, images=None):
        if images is None:
            images = np.arange(self.N)
        super().__init__(images, [6, 6, 2, 3, 3, 40, 40],
                         observation_shape=(64, 64, 3))


class Cars3D(IndexBackedDataset):
    """elevation / azimuth / object type."""

    N = 17_568

    def __init__(self, images=None):
        if images is None:
            images = np.arange(self.N)
        super().__init__(images, [4, 24, 183], observation_shape=(64, 64, 3))


class DSprites(IndexBackedDataset):
    """color(1) / shape / scale / orientation / posX / posY; color excluded
    from the latents like the reference default."""

    N = 737_280

    def __init__(self, images=None, latent_factor_indices=(1, 2, 3, 4, 5)):
        if images is None:
            images = np.arange(self.N)
        super().__init__(images, [1, 3, 6, 40, 32, 32],
                         latent_factor_indices=list(latent_factor_indices),
                         observation_shape=(64, 64, 1))


class SmallNORB(IndexBackedDataset):
    """category / instance / elevation / azimuth / lighting; instance is a
    nuisance factor."""

    def __init__(self, images=None):
        sizes = [5, 10, 9, 18, 6]
        n = int(np.prod(sizes))
        if images is None:
            images = np.arange(n)
        super().__init__(images, sizes, latent_factor_indices=[0, 2, 3, 4],
                         observation_shape=(64, 64, 1))


class SyntheticShapes(IndexBackedDataset):
    """The procedural Shapes3D-style demo grid: floor/wall/object hue,
    scale, shape, orientation."""

    N = 27_648

    def __init__(self, images=None):
        if images is None:
            images = np.arange(self.N)
        super().__init__(images, [6, 6, 6, 4, 4, 8],
                         observation_shape=(64, 64, 3))


class SyntheticShapesFull(IndexBackedDataset):
    """The procedural grid at Shapes3D's factor sizes [10,10,10,8,4,15]:
    480,000 images, the flagship's ``eval_name``."""

    N = 480_000

    def __init__(self, images=None):
        if images is None:
            images = np.arange(self.N)
        super().__init__(images, [10, 10, 10, 8, 4, 15],
                         observation_shape=(64, 64, 3))
