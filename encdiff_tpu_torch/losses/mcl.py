"""MCL (Mechanism Contrastive Learning) auxiliary losses: the fork's five
objectives that tie the frozen VQ decoder's "mechanism" to the 20 concept
scalars u.

Counterpart of ``encdiff_tpu/losses/mcl.py:26-192`` (``MLPProj``,
``MechanismCritic``, ``build_mcl_modules``, ``info_nce_from_qk``,
``_bce_with_logits``, ``mcl_loss``). The modules run NCHW; the critic's
``z_fc`` and ``Pi_g`` read z and the mechanism features flattened in the
JAX package's (h, w, c) order, so that flax weights carry over as they are.
``jax.grad`` and ``jax.vjp`` become ``torch.autograd.grad(...,
create_graph=True)``: the loss is differentiated once more by the train
step's backward, which then runs through the decoder's backward kernels
(``nn.kernels``: ``_GNSiLUBwd``, ``_AttentionCoreBwd``).

The random draws are arguments (``draw``): the permutation of
``nce_logistic``, ε of ``fisher_sm`` and ``denoise_sm`` (z's shape, NCHW),
v of ``jacobian_vjp_infonce`` (the decoded image's shape, NCHW). Where a
type needs one and none is given, it is drawn from ``generator``; tests
inject the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.nn.layers import TorchConv

MCL_LOSS_TYPES = ("nce_logistic", "infonce_mechgrad", "fisher_sm",
                  "denoise_sm", "jacobian_vjp_infonce")


def flat_hwc(x):
    """(B, C, H, W) -> (B, H*W*C), the JAX package's NHWC flatten order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class MLPProj(nn.Module):
    """Linear-ReLU-Linear projection head (``fc1``, ``fc2``). The JAX
    module's ``layernorm`` option, which no config sets, is not ported."""

    def __init__(self, in_dim: int, out_dim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, out_dim)
        self.fc2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class MechanismCritic(nn.Module):
    """Scalar critic s(x_hat, z, u): a conv trunk on the decoded image
    (4x4 stride-2 convs to 64 and 128 channels, ReLU, spatial mean), linear
    embeds of z (flattened h, w, c) and u, summed with the image features
    zero-padded to ``hidden``, then ReLU and a linear to one scalar a
    sample."""

    def __init__(self, z_flat: int, u_dim: int, hidden: int = 256,
                 in_channels: int = 3):
        super().__init__()
        self.hidden = hidden
        self.img_conv1 = TorchConv(in_channels, 64, 4, stride=2, padding=1)
        self.img_conv2 = TorchConv(64, 128, 4, stride=2, padding=1)
        self.z_fc = nn.Linear(z_flat, hidden)
        self.u_fc = nn.Linear(u_dim, hidden)
        self.out = nn.Linear(hidden, 1)

    def forward(self, x_hat, z, u):
        h = F.relu(self.img_conv2(F.relu(self.img_conv1(x_hat))))
        img = h.mean(dim=(2, 3))
        d = img.shape[1]
        img = (F.pad(img, (0, self.hidden - d)) if d < self.hidden
               else img[:, :self.hidden])
        h = F.relu(self.z_fc(flat_hwc(z)) + self.u_fc(u) + img)
        return self.out(h)[:, 0]


def build_mcl_modules(z_shape, u_dim: int, proj_dim: int = 128
                      ) -> nn.ModuleDict:
    """``critic``, ``Pi_g`` and ``Pi_u`` for latents of ``z_shape`` (h, w,
    c, as the JAX package gives it) and ``u_dim`` scalars."""
    z_flat = int(z_shape[0]) * int(z_shape[1]) * int(z_shape[2])
    return nn.ModuleDict({
        "critic": MechanismCritic(z_flat, u_dim),
        "Pi_g": MLPProj(z_flat, proj_dim),
        "Pi_u": MLPProj(u_dim, proj_dim),
    })


def _l2norm(x, eps: float = 1e-8):
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + eps)


def info_nce_from_qk(q, k, tau: float = 0.1):
    """Diagonal-positive InfoNCE: the mean of -log softmax(q kᵀ / tau)
    over the diagonal."""
    logp = torch.log_softmax((q @ k.t()) / (tau + 1e-12), dim=-1)
    return -logp.diagonal().mean()


def _bce_with_logits(logits, target: float):
    """Binary cross-entropy with logits against a constant target."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def _differentiable(z):
    """z itself where autograd already tracks it (a caller that wants the
    loss's gradient in z), else a leaf that requires grad: the mechanism
    features differentiate in z either way."""
    return z if z.requires_grad else z.detach().requires_grad_()


def mcl_loss(loss_type: str, decoder_G: Callable, z, u_key,
             modules: nn.ModuleDict, *, tau: float = 0.1,
             sigma: float = 0.1, neg_mode: str = "shuffle_u", draw=None,
             generator: torch.Generator | None = None):
    """The MCL loss of ``loss_type`` (a scalar tensor). ``decoder_G(z, u)``
    maps latents (B, C, h, w) and scalars (B, U) to images (B, 3, H, W),
    differentiable in both; ``draw`` is the type's random draw (see the
    module's note) or None to draw it from ``generator``. The JAX
    function's ``u_for_G``, which no caller passes, is not ported: the
    decoder reads u."""
    u = uG = u_key if u_key.dim() == 2 else u_key.reshape(u_key.shape[0], -1)
    critic, Pi_g, Pi_u = modules["critic"], modules["Pi_g"], modules["Pi_u"]

    def normal(shape):
        return draw if draw is not None else torch.randn(
            shape, generator=generator, device=z.device)

    def critic_sum(zz):
        return critic(decoder_G(zz, uG), zz, uG).sum()

    if loss_type == "nce_logistic":
        x_pos = decoder_G(z, uG)
        logit_pos = critic(x_pos, z, uG)
        perm = draw if draw is not None else torch.randperm(
            uG.shape[0], generator=generator, device=z.device)
        if neg_mode == "shuffle_u":
            z_neg, u_neg = z, uG[perm]
        elif neg_mode == "shuffle_z":
            z_neg, u_neg = z[perm], uG
        else:
            raise ValueError("neg_mode must be 'shuffle_u' or 'shuffle_z'")
        logit_neg = critic(decoder_G(z_neg, u_neg), z_neg, u_neg)
        return (_bce_with_logits(logit_pos, 1.0)
                + _bce_with_logits(logit_neg, 0.0))

    if loss_type == "infonce_mechgrad":
        # mechanism-gradient features: g = d/dz sum critic(G(z, u), z, u)
        zz = _differentiable(z)
        g, = torch.autograd.grad(critic_sum(zz), zz, create_graph=True)
        q = _l2norm(Pi_g(flat_hwc(g)))
        k = _l2norm(Pi_u(u))
        return info_nce_from_qk(q, k, tau=tau)

    if loss_type == "fisher_sm":
        # Hyvärinen score matching with a Hutchinson divergence estimate:
        # a third derivative through the decoder
        zz = _differentiable(z)
        score, = torch.autograd.grad(critic_sum(zz), zz, create_graph=True)
        score_norm = 0.5 * (flat_hwc(score) ** 2).sum(dim=1)
        eps = normal(z.shape)
        hvp, = torch.autograd.grad((score * eps).sum(), zz,
                                   create_graph=True)
        div = flat_hwc(hvp * eps).sum(dim=1)
        return torch.mean(score_norm + div)

    if loss_type == "denoise_sm":
        eps = normal(z.shape)
        z_t = _differentiable(z + sigma * eps)
        score, = torch.autograd.grad(critic_sum(z_t), z_t, create_graph=True)
        target = -(eps / (sigma + 1e-12))
        return torch.mean((score - target) ** 2)

    if loss_type == "jacobian_vjp_infonce":
        # decoder-Jacobian VJP with a random probe v as mechanism features
        zz = _differentiable(z)
        x_hat = decoder_G(zz, uG)
        v = normal(x_hat.shape)
        mechfeat, = torch.autograd.grad(x_hat, zz, v, create_graph=True)
        q = _l2norm(Pi_g(flat_hwc(mechfeat)))
        k = _l2norm(Pi_u(u))
        return info_nce_from_qk(q, k, tau=tau)

    raise ValueError(f"Unknown loss_type: {loss_type}")
