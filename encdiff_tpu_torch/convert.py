"""Flax variable trees (nested numpy dicts) -> the port's ``state_dict``s.

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


def flax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Map every leaf of a flax params (or batch_stats) tree by path."""
    out = {}
    for path, arr in _leaves(tree):
        parts = [p for p in path if p not in _WRAPPERS]
        leaf = parts[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight"
        else:
            leaf = _LEAVES.get(leaf, leaf)
        key = ".".join(parts[:-1] + [leaf])
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


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


def first_stage_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The decoding side of the VQ model: decoder, post_quant_conv and the
    codebook. The encoder and quant_conv are not in the port yet."""
    keep = {k: params[k] for k in ("decoder", "post_quant_conv", "quantize")}
    return flax_to_state_dict(keep)
