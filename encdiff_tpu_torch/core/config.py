"""``{target, params}`` config nodes -> objects.

Counterpart of ``instantiate_from_config`` (``encdiff_tpu/core/config.py``)
for the port's dict configs. A target must name an object of this package:
a config that names the JAX package's classes is refused rather than
imported.
"""

from __future__ import annotations

import importlib

PACKAGE = "encdiff_tpu_torch."


def get_obj_from_str(target: str):
    if not target.startswith(PACKAGE):
        raise ValueError(f"target {target!r} is not in {PACKAGE[:-1]}")
    module, name = target.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: dict, **extra_kwargs):
    """``get_obj_from_str(config["target"])(**config["params"], **extra)``."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = {**(config.get("params") or {}), **extra_kwargs}
    return get_obj_from_str(config["target"])(**params)
