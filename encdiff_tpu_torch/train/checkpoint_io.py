"""Train checkpoints: the compact ``.npz`` and the sidecar that resumes.

Counterpart of the harness's ``save_checkpoint`` / ``restore_checkpoint``
(``encdiff_tpu/train/harness.py:268-341``) and of the compact files of
``encdiff_tpu/core/compact_ckpt.py``. The JAX harness saves its whole train
state as an orbax tree, which the port cannot write, and mirrors it as a
compact ``.npz`` that both packages read. A checkpoint of the port is a
directory:

- ``model.npz``: the compact file (fp16 weights; UNet, Encoder4 with its
  batch statistics, the MCL heads under ``params/mcl`` where the model has
  them, EMA, scale factor and step; the frozen first stage),
  on the JAX package's paths where the run was restored from one of its
  files, so that ``encdiff_tpu``'s loaders read it;
- ``train_state.pt``: what the compact file lacks to resume bit for bit:
  the fp32 weights (the frozen first stage's too: a fresh init's are not
  fp16 values), the AdamW moments and update count (which key the LR), the
  accumulation buffers and the fp32 EMA with its update count.

The restore is lenient, as the JAX one: a leaf that the checkpoint lacks,
or holds at another shape, keeps its value from the seeded init, and the
count of such leaves is printed (an MCL fine-tune from a file of a run
without MCL, such as ``v4purify_final_fp16.npz``, keeps its fresh heads). A compact ``.npz`` alone restores weights,
step and scale factor; the optimizer starts afresh (the LR warmup starts
again, as in the JAX package), and the EMA keeps its init unless the file
holds one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from encdiff_tpu_torch import convert
from encdiff_tpu_torch.core.compact_ckpt import (MODEL_FILE, checkpoint_npz,
                                                 load_compact, model_variables,
                                                 save_compact)
from encdiff_tpu_torch.train.loop import trainable_parameters

STATE_FILE = "train_state.pt"
_STATS = ("running_mean", "running_var", "num_batches_tracked")


def fresh_variables(model) -> dict:
    """The variable tree of ``model``'s current weights on the paths the
    port gives a model it initialised (``convert.state_dict_tree``: without
    the flax wrappers' inner levels; the first stage and the MCL heads with
    them, ``convert.flax_variables``), as the save template of a run that
    was not restored from a JAX file."""
    cond = model.cond_stage_model.state_dict()
    params = convert.state_dict_tree(
        {k: v for k, v in cond.items() if not k.endswith(_STATS)})
    params["warp"] = params.pop("warp_mlps")
    out = {
        "unet": {"params": convert.state_dict_tree(model.unet.state_dict())},
        "cond": {"params": params, "batch_stats": convert.state_dict_tree(
            {k: v for k, v in cond.items() if k.endswith(_STATS[:2])})},
        # with the flax wrapper levels, as the MCL heads below: the JAX
        # loaders apply the first stage's tree as it is saved
        "first_stage": {"params": convert.flax_variables(
            model.first_stage_model)[0]},
    }
    if model.mcl is not None:
        # with the flax wrapper levels: the JAX restore merges by path
        out["mcl"] = {head: {"params": convert.flax_variables(
            model.mcl[head])[0]} for head in convert.MCL_HEADS}
    return out


def save_checkpoint(path: str, model, state, variables: dict) -> str:
    """The trained UNet, Encoder4 (params and batch statistics), MCL heads,
    EMA, scale factor and step, under the paths of ``variables``, with its
    frozen first stage, as one compact ``.npz``; no optimizer state, as the
    JAX package's compact files."""
    unet_tree = variables["unet"]["params"]
    cond, stats = convert.encoder4_to_flax(
        model.cond_stage_model.state_dict(), variables["cond"]["params"],
        variables["cond"]["batch_stats"])
    params = {"unet": convert.state_dict_to_flax(model.unet.state_dict(),
                                                 unet_tree),
              "cond": cond}
    if model.mcl is not None:
        params["mcl"] = convert.mcl_to_flax(model.mcl.state_dict(),
                                            variables["mcl"])
    train_state = {
        "params": params,
        "batch_stats": stats,
        "scale_factor": float(state.scale_factor),
        "step": state.step,
        "ema": convert.state_dict_to_flax(state.ema.params, unet_tree),
    }
    return save_compact(path, train_state,
                        {"first_stage": variables["first_stage"]})


def save_train_checkpoint(path: str, model, state, variables: dict) -> str:
    """Write the checkpoint directory ``path``: ``model.npz``
    (``save_checkpoint``) and ``train_state.pt``."""
    os.makedirs(path, exist_ok=True)
    save_checkpoint(os.path.join(path, MODEL_FILE), model, state, variables)
    params = trainable_parameters(model)
    opt = state.optimizer
    torch.save({
        "unet": model.unet.state_dict(),
        "cond": model.cond_stage_model.state_dict(),
        "first_stage": model.first_stage_model.state_dict(),
        "mcl": model.mcl.state_dict() if model.mcl is not None else None,
        "adamw": {k: opt.state[p] for k, p in params.items()
                  if p in opt.state},
        "updates": state.updates,
        "mini_step": state.mini_step,
        "acc_grads": (None if state.acc_grads is None else
                      dict(zip(params, state.acc_grads))),
        "ema": state.ema.params,
        "ema_updates": state.ema.num_updates,
    }, os.path.join(path, STATE_FILE))
    return path


def _merge(target: dict, loaded: dict, what: str, kept: list) -> bool:
    """Copy each tensor of ``loaded`` into the tensor of ``target`` (name ->
    tensor, in place) that has its name and shape; the other names of
    ``target`` keep their values and go to ``kept``. True if none did."""
    before = len(kept)
    with torch.no_grad():
        for k, v in target.items():
            src = loaded.get(k)
            if src is None or tuple(src.shape) != tuple(v.shape):
                kept.append(f"{what}/{k}")
                continue
            v.copy_(src)
    return len(kept) == before


def restore_train_checkpoint(path: str, model, state) -> dict:
    """Restore ``model`` (UNet, Encoder4, first stage, MCL heads) and
    ``state`` (step, scale factor, EMA and, from a checkpoint directory's
    sidecar, the fp32 weights, AdamW, its count, the accumulation buffers)
    from ``path``: a checkpoint directory or a compact ``.npz``. Returns the
    variable tree a later save should use as its template: the file's own
    paths for the UNet, Encoder4 and the MCL heads wherever it covered
    every leaf, the port's elsewhere."""
    npz = checkpoint_npz(path)
    sidecar = os.path.join(path, STATE_FILE) if os.path.isdir(path) else None
    tree = load_compact(npz)
    variables, scale_factor = model_variables(tree)
    template = fresh_variables(model)
    kept: list[str] = []

    unet = convert.flax_to_state_dict(variables["unet"]["params"])
    if _merge(model.unet.state_dict(), unet, "unet", kept):
        template["unet"] = variables["unet"]
    cond = variables["cond"]
    if _merge(model.cond_stage_model.state_dict(),
              convert.encoder4_state_dict(cond["params"],
                                          cond["batch_stats"]),
              "cond", kept):
        template["cond"] = cond
    _merge(model.first_stage_model.state_dict(),
           convert.first_stage_state_dict(variables["first_stage"]["params"]),
           "first_stage", kept)
    template["first_stage"] = variables["first_stage"]
    if model.mcl is not None and _merge(
            model.mcl.state_dict(),
            convert.mcl_state_dict(variables["mcl"] or {}), "mcl", kept):
        template["mcl"] = variables["mcl"]
    if variables["ema"] is not None:
        _merge(state.ema.params, convert.flax_to_state_dict(variables["ema"]),
               "ema", kept)
    else:
        kept.extend(f"ema/{k}" for k in state.ema.params)

    state.step = int(np.asarray(tree["state"].get("step", 0)))
    state.scale_factor = torch.tensor(scale_factor, dtype=torch.float32,
                                      device=model.device)
    model.scale_factor = scale_factor
    params = trainable_parameters(model)
    if sidecar is not None and os.path.exists(sidecar):
        side = torch.load(sidecar, map_location="cpu", weights_only=True)
        kept = [k for k in kept if not k.startswith(
            ("unet/", "cond/", "first_stage/", "ema/", "mcl/"))]
        _merge(model.unet.state_dict(), side["unet"], "unet", kept)
        _merge(model.cond_stage_model.state_dict(), side["cond"], "cond", kept)
        _merge(model.first_stage_model.state_dict(), side["first_stage"],
               "first_stage", kept)
        if model.mcl is not None:
            _merge(model.mcl.state_dict(), side.get("mcl") or {}, "mcl", kept)
        _merge(state.ema.params, side["ema"], "ema", kept)
        state.ema.num_updates = side["ema_updates"]
        for name, p in params.items():
            moments = side["adamw"].get(name)
            if moments is None or any(
                    v.dim() and tuple(v.shape) != tuple(p.shape)
                    for v in moments.values()):
                kept.append(f"adamw/{name}")
                continue
            # the moments go to the parameter's device; AdamW's step count
            # stays on the host, where the optimizer keeps it
            state.optimizer.state[p] = {
                k: v.to(p.device) if v.dim() else v
                for k, v in moments.items()}
        state.updates = side["updates"]
        state.mini_step = side["mini_step"]
        if side["acc_grads"] is not None:
            state.acc_grads = [side["acc_grads"][k].to(p.device)
                               for k, p in params.items()]
    else:
        kept.extend(f"adamw/{name}" for name in params)
    if kept:
        print(f"[harness] restore kept {len(kept)} init leaves "
              f"(strict=False); e.g. {kept[:3]}", flush=True)
    print(f"[harness] restored from {path} at step {state.step}", flush=True)
    return template
