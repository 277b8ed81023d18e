"""Loader of the compact ``.npz`` checkpoints.

A copy of the loading half of ``encdiff_tpu/core/compact_ckpt.py``
(``_unflatten``, ``load_compact``) and of the ``.npz`` branch of
``encdiff_tpu/train/checkpoint_io.py`` (``load_model_variables``). A compact
checkpoint is one ``.npz`` whose keys are ``/``-joined paths of the flax
variable tree, with weights stored as float16.
"""

from __future__ import annotations

import numpy as np

_SEP = "/"


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        node[parts[-1]] = arr
    return tree


def load_compact(path: str) -> dict:
    """Returns the nested {state, frozen} dict (float32 restored)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def load_model_variables(path: str) -> tuple[dict, float]:
    """(variables, scale_factor) from a compact ``.npz``.

    ``variables`` is the JAX package's layout, as nested numpy dicts:
    ``{unet: {params}, cond: {params, batch_stats}, first_stage: {params},
    ema: params | None}``. The compact files carry no ``ema`` subtree, so
    ``ema`` is None and sampling uses the raw UNet params, as
    ``encdiff_tpu/evalx/swap.py:_unet_vars`` does.
    """
    if not path.endswith(".npz"):
        raise ValueError(f"expected a compact .npz checkpoint, got {path!r}")
    tree = load_compact(path)
    state, frozen = tree["state"], tree["frozen"]
    ema = state.get("ema")
    variables = {
        "unet": {"params": state["params"]["unet"]},
        "cond": {"params": state["params"]["cond"],
                 "batch_stats": state.get("batch_stats") or {}},
        "first_stage": frozen["first_stage"],
        "ema": ema["params"] if isinstance(ema, dict) else None,
    }
    return variables, float(np.asarray(state["scale_factor"]))
