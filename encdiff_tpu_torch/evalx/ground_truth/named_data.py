"""The dataset-name registry of the ground-truth datasets.

A copy of ``encdiff_tpu/evalx/ground_truth/named_data.py:12-39`` for the
index-backed datasets (a model config's ``eval_name``).
"""

from __future__ import annotations

from encdiff_tpu_torch.evalx.ground_truth import datasets

_REGISTRY = {
    "shapes3d": datasets.Shapes3D,
    "3dshapes": datasets.Shapes3D,
    "mpi3d": datasets.MPI3D,
    "cars3d": datasets.Cars3D,
    "dsprites": datasets.DSprites,
    "dsprites_full": datasets.DSprites,
    "smallnorb": datasets.SmallNORB,
    "synthetic_shapes": datasets.SyntheticShapes,
    "synthetic_shapes_full": datasets.SyntheticShapesFull,
}


def get_named_ground_truth_data(name: str, images=None):
    name = name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"Unknown ground-truth dataset {name!r}; "
                         f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](images)


def get_index_dataset(name: str):
    """Dataset over np.arange(N): observations are representation indices."""
    return get_named_ground_truth_data(name, images=None)
