"""FID: the pytorch-fid InceptionV3 up to its pool3 features, and the
Fréchet distance.

Counterpart of ``encdiff_tpu/evalx/fid.py:31-283`` (``InceptionV3FID``,
``compute_activations``, ``activation_statistics``, ``frechet_distance``,
``compute_fid``) without the attribute probe. The FID variant of the
network: InceptionA/C/E average pools that do not count the padding, and
the last InceptionE block's max pool. Submodule and parameter names are
pytorch-fid's (``Mixed_5b.branch1x1.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ...), which the flax tree mirrors,
so a ``pt_inception-2015-12-05`` state_dict loads through
``load_pt_inception``. No such weights are in the repository: without them
the features come from ``init_parameters``' seeded draw with the flax
init's distributions, and scores are uncalibrated.

Inputs are NHWC in [0, 1] (uint8 is divided by 255); ``normalize_input``
maps them to [-1, 1], and ``resize_input`` resizes bilinearly to 299 first.
Inside, the network runs NCHW, BatchNorms on their running statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    """Bias-free conv -> BatchNorm (eps 1e-3, running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x):
    """3x3 stride-1 average pool over the cells inside the image."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class FIDInceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)],
                         dim=1)


class FIDInceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], dim=1)


class FIDInceptionE(nn.Module):
    """``use_max_pool`` selects the last block's variant (E_2)."""

    def __init__(self, cin: int, use_max_pool: bool):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1) if self.use_max_pool
              else _avg_pool_3x3(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         dim=1)


def resize_bilinear(x, size: int = 299):
    """NCHW bilinear resize with half-pixel centres. Where it upsamples
    (64 or 256 px to 299) it equals ``jax.image.resize(..., "bilinear")``:
    JAX renormalises the triangle weights over the pixels inside the image,
    and at the edges that leaves the edge pixel alone, which is what
    clamping the source coordinate gives."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=False)


class InceptionV3FID(nn.Module):
    """Pool3 (2048-d) feature extractor: NHWC images in [0, 1] -> (B, 2048).
    Built in eval mode and frozen."""

    def __init__(self, normalize_input: bool = True,
                 resize_input: bool = True):
        super().__init__()
        self.normalize_input = normalize_input
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = FIDInceptionA(192, 32)
        self.Mixed_5c = FIDInceptionA(256, 64)
        self.Mixed_5d = FIDInceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = FIDInceptionC(768, 128)
        self.Mixed_6c = FIDInceptionC(768, 160)
        self.Mixed_6d = FIDInceptionC(768, 160)
        self.Mixed_6e = FIDInceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = FIDInceptionE(1280, False)
        self.Mixed_7c = FIDInceptionE(2048, True)
        self.eval().requires_grad_(False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax init's distributions, drawn from ``generator``: conv
        kernels lecun-normal (a normal truncated at ±2 standard deviations,
        scaled to variance 1/fan_in), BatchNorm scale 1, bias 0, running
        mean 0, variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.resize_input and x.shape[-1] != 299:
            x = resize_bilinear(x)
        if self.normalize_input:
            x = 2 * x - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def fid_inception(device="cuda", seed: int = 0,
                  state_dict: dict | None = None) -> InceptionV3FID:
    """The Inception of the FID on ``device``: with a pt_inception
    ``state_dict``, its weights; else a seeded init (uncalibrated)."""
    model = InceptionV3FID()
    if state_dict is None:
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        load_pt_inception(model, state_dict)
    return model.to(device)


def load_pt_inception(model: InceptionV3FID, state_dict: dict) -> None:
    """Load a pt_inception-2015-12-05 (pytorch-fid) state_dict, leaving out
    its classifier (``fc``, ``AuxLogits``)."""
    kept = {k: v for k, v in state_dict.items()
            if not k.startswith(("fc.", "AuxLogits."))}
    model.load_state_dict(kept, strict=False)
    missing = set(model.state_dict()) - set(kept)
    if any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"state_dict lacks {sorted(missing)[:4]}")


@torch.no_grad()
def compute_activations(model: InceptionV3FID, images,
                        batch_size: int = 64) -> np.ndarray:
    """images (N, H, W, 3), float in [0, 1] or uint8 -> (N, 2048) pool3
    features, in batches on the model's device."""
    device = next(model.parameters()).device
    images = np.asarray(images)
    outs = []
    for i in range(0, len(images), batch_size):
        chunk = images[i:i + batch_size]
        if chunk.dtype == np.uint8:
            chunk = chunk.astype(np.float32) / 255.0
        x = torch.as_tensor(chunk, dtype=torch.float32, device=device)
        outs.append(model(x).cpu().numpy())
    return np.concatenate(outs, axis=0)


def activation_statistics(acts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians: scipy's sqrtm, retried with
    ``eps`` on the diagonals where it is not finite (a copy of the JAX
    package's, without sqrtm's ``disp`` argument, which newer scipy
    releases no longer take; the square root is the same)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component in matrix sqrt")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(model: InceptionV3FID, images_a, images_b,
                batch_size: int = 64) -> float:
    mu1, s1 = activation_statistics(
        compute_activations(model, images_a, batch_size))
    mu2, s2 = activation_statistics(
        compute_activations(model, images_b, batch_size))
    return frechet_distance(mu1, s1, mu2, s2)
