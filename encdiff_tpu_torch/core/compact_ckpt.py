"""The compact ``.npz`` checkpoints: load and save.

A copy of ``encdiff_tpu/core/compact_ckpt.py`` (``_flatten``,
``_unflatten``, ``save_compact``, ``save_compact_vq``, ``load_compact``)
and of the ``.npz``
branch of ``encdiff_tpu/train/checkpoint_io.py`` (``load_model_variables``).
A compact checkpoint is one ``.npz`` whose keys are ``/``-joined paths of
the flax variable tree, with weight tensors stored as float16 and scalars
(step, scale_factor) exact; it holds no optimizer state. The port writes
the archive's members stored, where the JAX package deflates them: deflate
shrinks float16 weights by under a tenth (the flagship's 80.8 MiB to 74.7)
for seconds of host time a save, and ``np.load`` reads both alike.
"""

from __future__ import annotations

import os

import numpy as np

_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    arr = np.asarray(tree)
    # narrow weight tensors only; scalars (step, scale_factor) stay exact
    if arr.dtype in (np.float32, np.float64) and arr.size > 1:
        arr = arr.astype(np.float16)
    out[prefix[:-1]] = arr
    return out


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


#: the compact file of a harness checkpoint directory
#: (``train.checkpoint_io``)
MODEL_FILE = "model.npz"


def checkpoint_npz(path: str) -> str:
    """The compact ``.npz`` of ``path``: ``path`` itself, or a harness
    checkpoint directory's ``model.npz`` (``checkpoints/last``,
    ``checkpoints/<monitor>``)."""
    return os.path.join(path, MODEL_FILE) if os.path.isdir(path) else path


def load_model_variables(path: str) -> tuple[dict, float]:
    """(variables, scale_factor) from a compact ``.npz``.

    ``variables`` is the JAX package's layout, as nested numpy dicts:
    ``{unet: {params}, cond: {params, batch_stats}, first_stage: {params},
    ema: params | None, mcl: {critic, Pi_g, Pi_u} | None}``. Files without
    an ``ema`` subtree give None, and sampling then uses the raw UNet
    params, as ``encdiff_tpu/evalx/swap.py:_unet_vars`` does; files of a
    run without MCL give no ``mcl``.
    """
    if not path.endswith(".npz"):
        raise ValueError(f"expected a compact .npz checkpoint, got {path!r}")
    return model_variables(load_compact(path))


def model_variables(tree: dict) -> tuple[dict, float]:
    """(variables, scale_factor) of a loaded compact tree."""
    state, frozen = tree["state"], tree["frozen"]
    ema = state.get("ema")
    variables = {
        "unet": {"params": state["params"]["unet"]},
        "cond": {"params": state["params"]["cond"],
                 "batch_stats": state.get("batch_stats") or {}},
        "first_stage": frozen["first_stage"],
        "ema": ema["params"] if isinstance(ema, dict) else None,
        "mcl": state["params"].get("mcl"),
    }
    return variables, float(np.asarray(state["scale_factor"]))


def save_compact(path: str, state: dict, frozen: dict) -> str:
    """Write ``{state: {params, batch_stats, scale_factor, step, ema},
    frozen}`` (nested numpy dicts, the JAX package's layout) as one fp16
    ``.npz`` that both packages' loaders read."""
    tree = {
        "state": {
            "params": state["params"],
            "batch_stats": state.get("batch_stats") or {},
            "scale_factor": np.float32(np.asarray(state["scale_factor"])),
            "step": np.asarray(state["step"]),
            "ema": {"params": state["ema"]},
        },
        "frozen": frozen,
    }
    np.savez(path, **_flatten(tree))
    return path


def save_compact_vq(path: str, state: dict) -> str:
    """Write the VQ-GAN trainer's state (``convert.vq_flax_state``: the
    generator's and discriminator's params, the batch statistics, the LPIPS
    variables and the step; no Adam state) as one fp16 ``.npz`` under
    ``state/``, the keys of ``demo_artifacts/round5/v4vq_fp16.npz``, which
    the JAX ``load_compact`` and ``VQModel.load_reference_checkpoint``
    read."""
    tree = {"state": {
        "gen_params": state["gen_params"],
        "disc_params": state.get("disc_params") or {},
        "disc_batch_stats": state.get("disc_batch_stats") or {},
        "loss_vars": state.get("loss_vars") or {},
        "step": np.asarray(state.get("step") or 0),
    }}
    np.savez(path, **_flatten(tree))
    return path
