"""Flax variable trees (nested numpy dicts) <-> the port's ``state_dict``s.

The port's modules carry the flax module names, so most leaves map by path:

- the flax wrappers' inner ``Conv_0`` / ``Dense_0`` / ``GroupNorm_0``
  levels drop out;
- conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
- GroupNorm / LayerNorm / BatchNorm ``scale`` -> ``weight``;
- BatchNorm statistics ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var`` (plus torch's ``num_batches_tracked``).

Two leaves of Encoder4 need more: the warp MLPs live under ``warp_mlps``
(``warp`` is a method), and the fc rows, flattened HWC by the JAX model,
are permuted to the CHW flatten of an NCHW tensor.

``inception_state_dict`` maps the FID Inception's flax variables the same way.
``vq_state_dicts`` maps a JAX VQ-GAN train state (``VQTrainState`` or the
``state`` of a compact ``.npz`` such as ``v4vq_fp16.npz``): the generator,
the discriminator's params and batch statistics, the LPIPS variables and,
where the state holds them, both Adam states (``adam_state``).

The inverse (``state_dict_to_flax``, ``encoder4_to_flax``) walks the tree
a state dict was converted from, so that a trained model is saved under the
JAX package's paths. A model initialised in the port has no such tree:
``state_dict_tree`` makes one without the wrappers' inner levels, which the
port's loader drops anyway, and ``flax_variables`` one with them, from the
modules' types, which the JAX loaders that merge by path need.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_WRAPPERS = ("Conv_0", "Dense_0", "GroupNorm_0")
_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: tuple) -> tuple[str, bool]:
    """(state_dict key, whether the leaf is a kernel) of a flax leaf path."""
    parts = [p for p in path if p not in _WRAPPERS]
    leaf = parts[-1]
    kernel = leaf == "kernel"
    leaf = "weight" if kernel else _LEAVES.get(leaf, leaf)
    return ".".join(parts[:-1] + [leaf]), kernel


def flax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Map every leaf of a flax params (or batch_stats) tree by path."""
    out = {}
    for path, arr in _leaves(tree):
        key, kernel = _torch_key(path)
        if kernel:
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def state_dict_to_flax(sd: dict, template: dict) -> dict:
    """The flax tree of ``template``'s paths, valued from the state dict
    ``sd`` (the inverse of ``flax_to_state_dict``), as float32 numpy."""
    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, prefix + (k,))
                continue
            key, kernel = _torch_key(prefix + (k,))
            arr = sd[key].detach().float().cpu().numpy()
            if kernel:
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            out[k] = np.ascontiguousarray(arr)
        return out
    return walk(template, ())


def state_dict_tree(sd: dict) -> dict:
    """A flax-layout tree of ``sd`` without the flax wrappers' inner levels,
    as float32 numpy: kernels transposed back, norm ``weight`` -> ``scale``,
    ``running_mean`` / ``running_var`` -> ``mean`` / ``var``;
    ``num_batches_tracked`` is dropped. ``flax_to_state_dict`` inverts it."""
    names = {v: k for k, v in _LEAVES.items()}
    tree: dict = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight" and arr.ndim > 1:
            leaf = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[names.get(leaf, leaf)] = np.ascontiguousarray(arr)
    return tree


def encoder4_state_dict(params: dict, batch_stats: dict
                        ) -> dict[str, torch.Tensor]:
    sd = {}
    for k, v in {**flax_to_state_dict(params),
                 **flax_to_state_dict(batch_stats)}.items():
        sd["warp_mlps" + k[4:] if k.startswith("warp.") else k] = v
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    if "fc.weight" not in sd or "conv4.weight" not in sd:
        return sd  # a partial tree (a lenient restore keeps what it lacks)
    # fc input rows: flax (h, w, c) flatten -> torch (c, h, w) flatten
    d = sd["conv4.weight"].shape[0]
    w = sd["fc.weight"]                       # (U, h*w*d), HWC columns
    side = int(round((w.shape[1] // d) ** 0.5))
    sd["fc.weight"] = (w.reshape(-1, side, side, d).permute(0, 3, 1, 2)
                       .reshape(w.shape[0], -1).contiguous())
    return sd


def encoder4_to_flax(sd: dict, params: dict, batch_stats: dict
                     ) -> tuple[dict, dict]:
    """(params, batch_stats) flax trees of an Encoder4 state dict, on the
    paths of the given trees: the inverse of ``encoder4_state_dict``."""
    sd = {("warp." + k[len("warp_mlps."):] if k.startswith("warp_mlps.")
           else k): v for k, v in sd.items()}
    d = sd["conv4.weight"].shape[0]
    w = sd["fc.weight"]                       # (U, c*h*w), CHW columns
    side = int(round((w.shape[1] // d) ** 0.5))
    sd["fc.weight"] = (w.reshape(-1, d, side, side).permute(0, 2, 3, 1)
                       .reshape(w.shape[0], -1))
    return state_dict_to_flax(sd, params), state_dict_to_flax(sd, batch_stats)


def first_stage_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The VQ model: encoder, quant_conv, codebook, post_quant_conv and
    decoder."""
    keep = {k: params[k] for k in ("encoder", "quant_conv", "quantize",
                                   "post_quant_conv", "decoder")
            if k in params}
    return flax_to_state_dict(keep)


def inception_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """The FID Inception's flax variables (``params`` and ``batch_stats``,
    as ``encdiff_tpu.evalx.fid.init_fid_variables`` makes them) -> the
    state dict of ``evalx.fid.InceptionV3FID``, whose names are
    pytorch-fid's."""
    return {**flax_to_state_dict(variables["params"]),
            **flax_to_state_dict(variables["batch_stats"])}


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def flax_variables(module) -> tuple[dict, dict]:
    """(params, batch_stats) of ``module`` as flax trees with the JAX
    package's wrapper levels, as float32 numpy: a convolution's leaves under
    ``Conv_0`` (kernel HWIO), a GroupNorm's or GN-SiLU's under
    ``GroupNorm_0`` (``scale``, ``bias``), a BatchNorm's ``scale`` and
    ``bias`` in place and its ``mean`` and ``var`` in ``batch_stats``, the
    codebook's ``embedding`` in place. Raises on another module that holds
    parameters."""
    from encdiff_tpu_torch.nn.encoder4 import BatchNorm
    from encdiff_tpu_torch.nn.layers import GNSiLU
    from encdiff_tpu_torch.nn.quantize import VectorQuantizer

    params: dict = {}
    stats: dict = {}

    def node(tree, name):
        for part in name.split(".") if name else ():
            tree = tree.setdefault(part, {})
        return tree

    for name, m in module.named_modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, nn.Conv2d):
            leaf = node(params, name).setdefault("Conv_0", {})
            leaf["kernel"] = _np(m.weight).transpose(2, 3, 1, 0)
            if m.bias is not None:
                leaf["bias"] = _np(m.bias)
        elif isinstance(m, (GNSiLU, nn.GroupNorm)):
            node(params, name)["GroupNorm_0"] = {"scale": _np(m.weight),
                                                 "bias": _np(m.bias)}
        elif isinstance(m, BatchNorm):
            node(params, name).update(scale=_np(m.weight), bias=_np(m.bias))
            node(stats, name).update(mean=_np(m.running_mean),
                                     var=_np(m.running_var))
        elif isinstance(m, VectorQuantizer):
            node(params, name)["embedding"] = _np(m.embedding)
        elif own:
            raise TypeError(f"{name}: no flax layout for {type(m).__name__}")
    return params, stats


def adam_state(opt_state):
    """(count, mu, nu) of the ``optax.scale_by_adam`` state inside an optax
    optimizer state (``optax.adam``'s chain, or ``MultiSteps`` around it);
    None if it holds none."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return int(np.asarray(opt_state.count)), opt_state.mu, opt_state.nu
    children = (opt_state if isinstance(opt_state, (tuple, list)) else
                [getattr(opt_state, f) for f in getattr(opt_state,
                                                        "_fields", ())])
    for child in children:
        found = adam_state(child)
        if found is not None:
            return found
    return None


def vq_state_dicts(state) -> dict:
    """The state dicts of a JAX VQ-GAN state: ``state`` is a
    ``VQTrainState`` or a dict of its fields (the ``state`` of a compact
    ``.npz``), values numpy. Returns ``{"generator", "discriminator",
    "lpips"}`` (the LPIPS entry only if the state holds its variables), and
    ``"step"``; with the optimizer states, also ``"gen_opt"`` and
    ``"disc_opt"``, each (count, mu state dict, nu state dict)."""
    field = (state.get if isinstance(state, dict)
             else lambda name: getattr(state, name, None))
    out = {"generator": flax_to_state_dict(field("gen_params")),
           "discriminator": {**flax_to_state_dict(field("disc_params")),
                             **flax_to_state_dict(
                                 field("disc_batch_stats") or {})},
           "step": int(np.asarray(field("step") or 0))}
    lpips = (field("loss_vars") or {}).get("lpips")
    if lpips:
        out["lpips"] = flax_to_state_dict(lpips["params"])
    for name in ("gen_opt", "disc_opt"):
        found = adam_state(field(name)) if field(name) is not None else None
        if found is not None:
            count, mu, nu = found
            out[name] = (count, flax_to_state_dict(mu),
                         flax_to_state_dict(nu))
    return out


def vq_flax_state(model, step: int) -> dict:
    """The JAX ``VQTrainState`` fields of a port ``VQModel`` (trained with
    its loss), as numpy flax trees without the optimizer states:
    ``gen_params``, ``disc_params``, ``disc_batch_stats``,
    ``loss_vars`` ({"lpips": {"params"}} when LPIPS is on) and ``step``."""
    from encdiff_tpu_torch.models.autoencoder import GENERATOR

    gen = {name: flax_variables(getattr(model, name))[0]
           for name in GENERATOR}
    disc, stats = flax_variables(model.loss.discriminator)
    lpips = model.loss.lpips
    return {"gen_params": gen, "disc_params": disc,
            "disc_batch_stats": stats,
            "loss_vars": ({"lpips": {"params": flax_variables(lpips)[0]}}
                          if lpips is not None else {}),
            "step": np.asarray(step, np.int32)}
