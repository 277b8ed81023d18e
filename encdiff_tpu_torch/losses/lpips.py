"""LPIPS perceptual distance (the VGG16 variant), NCHW.

Counterpart of ``encdiff_tpu/losses/lpips.py``: a frozen VGG16 trunk tapped
at relu{1_2, 2_2, 3_3, 4_3, 5_3}, each tap unit-normalised over channels,
squared differences, one 1x1 ``lin`` head per tap, the spatial mean, the sum
over taps. The convolutions are cuDNN's (``torch.nn.functional.conv2d``):
the JAX package computes them outside any Pallas kernel too.

No pretrained weights ship with the repo. ``load_torch_lpips`` reads
torchvision's ``vgg16`` state dict (``features.*``) and taming's
``lin{k}.model.1.weight`` heads; ``LPIPS`` loads them when
``ENCDIFF_LPIPS_VGG`` and ``ENCDIFF_LPIPS_LIN`` name the two files.
Otherwise it runs the calibrated random-features metric of the JAX package:
a random trunk with the JAX laws (U(±1/√fan_in) for weights and biases)
drawn from ``torch.Generator().manual_seed(1830)``, and the heads at 1/C,
so that the distance is the mean unit-normalised feature distance. That
trunk cannot equal the JAX package's draw from ``PRNGKey(1830)`` number for
number: a run that must match a JAX run carries the JAX variables across
(``convert.flax_to_state_dict`` of ``loss_vars["lpips"]["params"]``).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.nn.layers import TorchConv

#: channel widths of the five tapped VGG16 stages, and convs per stage
VGG_CHANNELS = (64, 128, 256, 512, 512)
STAGE_CONVS = (2, 2, 3, 3, 3)
#: torchvision's ``vgg16().features`` index of each of the 13 convolutions
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
#: the fixed seed of the random-features trunk
TRUNK_SEED = 1830

# the input scaling layer (taming lpips.ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 conv trunk; ``forward`` returns the five relu taps."""

    def __init__(self):
        super().__init__()
        cin, k = 3, 0
        for stage, n_convs in enumerate(STAGE_CONVS):
            for _ in range(n_convs):
                self.add_module(f"conv_{k}", TorchConv(
                    cin, VGG_CHANNELS[stage], 3, padding=1))
                cin, k = VGG_CHANNELS[stage], k + 1

    def forward(self, x):
        taps, k = [], 0
        for stage, n_convs in enumerate(STAGE_CONVS):
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv_{k}")(x))
                k += 1
            taps.append(x)
            if stage < len(STAGE_CONVS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


def unit_normalize(feat, eps: float = 1e-10):
    """``feat`` over the L2 norm of its channels (dim 1), plus ``eps``."""
    return feat / (torch.sqrt((feat ** 2).sum(1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """The JAX ``LPIPSModule`` and its ``LPIPS`` orchestrator in one
    module: lpips(x, y) per sample: (B,) for images (B, 3, H, W) in [-1, 1].
    Built frozen; the trunk and heads come from the two files named by
    ``ENCDIFF_LPIPS_VGG`` / ``ENCDIFF_LPIPS_LIN`` if both are set, else
    from ``calibrate_random_features``."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for k, c in enumerate(VGG_CHANNELS):
            self.add_module(f"lin{k}", TorchConv(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None],
                             persistent=False)
        vgg_path = os.environ.get("ENCDIFF_LPIPS_VGG")
        lin_path = os.environ.get("ENCDIFF_LPIPS_LIN")
        if vgg_path and lin_path:
            load_torch_lpips(self, torch.load(vgg_path, map_location="cpu"),
                             torch.load(lin_path, map_location="cpu"))
        else:
            calibrate_random_features(self)
        self.requires_grad_(False)

    def forward(self, x, y):
        fx = self.vgg((x - self.shift) / self.scale)
        fy = self.vgg((y - self.shift) / self.scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            d = (unit_normalize(a) - unit_normalize(b)) ** 2
            total = total + getattr(self, f"lin{k}")(d).mean(dim=(1, 2, 3))
        return total


@torch.no_grad()
def calibrate_random_features(lpips: LPIPS) -> LPIPS:
    """The random-features metric: the trunk drawn with the JAX laws from
    ``torch.Generator().manual_seed(TRUNK_SEED)`` (the same trunk in every
    run, whatever the caller's seed), the heads at 1/C."""
    gen = torch.Generator().manual_seed(TRUNK_SEED)
    for k in range(sum(STAGE_CONVS)):
        conv = getattr(lpips.vgg, f"conv_{k}")
        bound = conv.weight[0].numel() ** -0.5
        for t in (conv.weight, conv.bias):
            t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                                  generator=gen))
    for k, c in enumerate(VGG_CHANNELS):
        getattr(lpips, f"lin{k}").weight.fill_(1.0 / c)
    return lpips


@torch.no_grad()
def load_torch_lpips(lpips: LPIPS, vgg_state: dict, lin_state: dict) -> LPIPS:
    """Copy torchvision's ``vgg16`` ``features.<i>.weight`` / ``.bias`` and
    taming's ``lin{k}.model.1.weight`` (1, C, 1, 1) into ``lpips``. The
    layouts are torch's already, so nothing is transposed."""
    for k, tvi in enumerate(TORCHVISION_CONVS):
        conv = getattr(lpips.vgg, f"conv_{k}")
        conv.weight.copy_(torch.as_tensor(vgg_state[f"features.{tvi}.weight"]))
        conv.bias.copy_(torch.as_tensor(vgg_state[f"features.{tvi}.bias"]))
    for k in range(len(VGG_CHANNELS)):
        getattr(lpips, f"lin{k}").weight.copy_(
            torch.as_tensor(lin_state[f"lin{k}.model.1.weight"]))
    return lpips
