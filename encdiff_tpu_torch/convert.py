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

The inverse (``state_dict_to_flax``, ``encoder4_to_flax``) walks the tree
a state dict was converted from, so that a trained model is saved under the
JAX package's paths. A model initialised in the port has no such tree:
``state_dict_tree`` makes one without the wrappers' inner levels, which the
port's loader drops anyway.
"""

from __future__ import annotations

import numpy as np
import torch

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
                                   "post_quant_conv", "decoder")}
    return flax_to_state_dict(keep)


def inception_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """The FID Inception's flax variables (``params`` and ``batch_stats``,
    as ``encdiff_tpu.evalx.fid.init_fid_variables`` makes them) -> the
    state dict of ``evalx.fid.InceptionV3FID``, whose names are
    pytorch-fid's."""
    return {**flax_to_state_dict(variables["params"]),
            **flax_to_state_dict(variables["batch_stats"])}
