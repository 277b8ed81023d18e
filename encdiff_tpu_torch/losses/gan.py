"""The VQ-GAN losses: PatchGAN discriminator, LPIPS and the adaptive GAN
weight, NCHW.

Counterpart of ``encdiff_tpu/losses/gan.py:31-262``
(``NLayerDiscriminator``, the hinge and vanilla discriminator losses,
``adopt_weight``, ``measure_perplexity``, ``adaptive_gan_weight`` and
``VQLPIPSWithDiscriminator``). As there, ``generator_loss`` and
``discriminator_loss`` stand for the reference's ``optimizer_idx`` 0 and 1,
and the trainer (``train.vq_trainer``) routes the gradients.

Three rules of the JAX package that PyTorch would break by default:

- the generator pass scores the fakes with the discriminator's BatchNorms
  in train mode, on batch statistics, and discards their running-statistics
  update (``update_stats=False``); a ``BatchNorm`` in train mode would
  update its buffers in place;
- the discriminator pass updates them twice, on the real batch and then on
  the fakes;
- the adaptive weight is ||∂nll/∂w|| / (||∂g/∂w|| + 1e-4) for the decoder's
  last convolution kernel w, clamped to [0, 1e4] and detached. It is taken
  with ``torch.autograd.grad`` on w, as the reference torch code does
  (``vqperceptual.py:86-94``); the JAX package takes the same gradients as
  a VJP of the sown pre-``conv_out`` activation, which does not depend on w.

``LPIPSWithDiscriminator`` (the KL autoencoder's loss) is not ported: no
config of the repo trains an ``AutoencoderKL``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.losses.lpips import LPIPS
from encdiff_tpu_torch.nn.encoder4 import BatchNorm
from encdiff_tpu_torch.nn.layers import TorchConv
from encdiff_tpu_torch.nn.quantize import code_frequencies


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4x4 convs, a stride-2 pyramid, flax-rule BatchNorms (eps
    1e-5; ``nn.encoder4.BatchNorm``), LeakyReLU(0.2). In train mode the
    BatchNorms normalise with batch statistics, and update their running
    statistics unless ``update_stats`` is False."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = TorchConv(input_nc, ndf, 4, stride=2, padding=1)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", TorchConv(
                cin, cout, 4, stride=2 if n < n_layers else 1, padding=1,
                bias=False))
            self.add_module(f"bn{n}", BatchNorm(cout, eps=1e-5))
            cin = cout
        self.conv_out = TorchConv(cin, 1, 4, stride=1, padding=1)

    def forward(self, x, update_stats: bool = True):
        h = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"bn{n}")(h, update_stats), 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def adopt_weight(weight, global_step, threshold=0, value=0.0):
    """``value`` before ``threshold`` (``disc_start``), else ``weight``."""
    return value if global_step < threshold else weight


def measure_perplexity(indices, n_embed: int):
    """(perplexity, codes in use) of ``indices``."""
    p = code_frequencies(indices, n_embed)
    return (torch.exp(-(p * torch.log(p + 1e-10)).sum()),
            (p > 0).sum().float())


def adaptive_gan_weight(nll_loss, g_loss, last_layer,
                        discriminator_weight=1.0, eps=1e-4):
    """||∂nll/∂w|| / (||∂g/∂w|| + eps) for the kernel ``last_layer``,
    clamped to [0, 1e4], detached, times ``discriminator_weight``. The
    graphs of both losses are kept for the step's backward."""
    nll_grad, = torch.autograd.grad(nll_loss, last_layer, retain_graph=True)
    g_grad, = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
    d_weight = torch.clamp(torch.linalg.vector_norm(nll_grad)
                           / (torch.linalg.vector_norm(g_grad) + eps),
                           0.0, 1e4)
    return d_weight.detach() * discriminator_weight


@contextlib.contextmanager
def _mode(module: nn.Module, train: bool):
    was = module.training
    module.train(train)
    try:
        yield module
    finally:
        module.train(was)


class VQLPIPSWithDiscriminator(nn.Module):
    """The constructor of ``vqperceptual.py:43-84``; the LPIPS module is
    built only when ``perceptual_weight`` > 0. ``pixelloss_weight`` and
    ``disc_conditional`` are taken and unused, as in the JAX package."""

    def __init__(self, disc_start, codebook_weight=1.0, pixelloss_weight=1.0,
                 disc_num_layers=3, disc_in_channels=3, disc_factor=1.0,
                 disc_weight=1.0, perceptual_weight=1.0, use_actnorm=False,
                 disc_conditional=False, disc_ndf=64, disc_loss="hinge",
                 n_classes=None, perceptual_loss="lpips", pixel_loss="l1"):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r}: hinge or vanilla")
        if use_actnorm:
            raise NotImplementedError("the actnorm discriminator is not ported")
        if perceptual_loss != "lpips":
            raise NotImplementedError(f"perceptual_loss {perceptual_loss!r}")
        if pixel_loss not in ("l1", "l2"):
            raise ValueError(f"pixel_loss {pixel_loss!r}: l1 or l2")
        self.codebook_weight = codebook_weight
        self.pixel_weight = pixelloss_weight
        self.perceptual_weight = perceptual_weight
        self.pixel_loss = pixel_loss
        self.discriminator = NLayerDiscriminator(
            input_nc=disc_in_channels, ndf=disc_ndf, n_layers=disc_num_layers)
        self.discriminator_iter_start = disc_start
        self.disc_loss = (hinge_d_loss if disc_loss == "hinge"
                          else vanilla_d_loss)
        self.disc_factor = disc_factor
        self.discriminator_weight = disc_weight
        self.disc_conditional = disc_conditional
        self.n_classes = n_classes
        self.lpips = LPIPS() if perceptual_weight > 0 else None

    def rec_loss(self, x, xrec):
        """(per-element reconstruction loss with the per-sample LPIPS term
        added, the batch's mean LPIPS)."""
        rec = (x - xrec).abs() if self.pixel_loss == "l1" else (x - xrec) ** 2
        if self.lpips is None:
            return rec, torch.zeros((), device=x.device)
        p = self.lpips(x, xrec)
        return rec + self.perceptual_weight * p[:, None, None, None], p.mean()

    def generator_loss(self, codebook_loss, x, xrec, global_step,
                       last_layer=None, split="train",
                       predicted_indices=None):
        """optimizer_idx 0 (``vqperceptual.py:105-149``): (loss, log). With
        ``last_layer`` (the decoder's ``conv_out.weight``) the GAN weight is
        adaptive; without it, ``disc_weight``."""
        rec, p_mean = self.rec_loss(x, xrec)
        nll_loss = rec.mean()
        with _mode(self.discriminator, True) as disc:
            logits_fake = disc(xrec, update_stats=False)
        g_loss = -logits_fake.mean()
        if last_layer is not None:
            d_weight = adaptive_gan_weight(nll_loss, g_loss, last_layer,
                                           self.discriminator_weight)
        else:
            d_weight = torch.tensor(float(self.discriminator_weight),
                                    device=x.device)
        disc_factor = adopt_weight(self.disc_factor, global_step,
                                   self.discriminator_iter_start)
        quant_loss = codebook_loss.mean()
        loss = (nll_loss + d_weight * disc_factor * g_loss
                + self.codebook_weight * quant_loss)
        log = {f"{split}/total_loss": loss, f"{split}/quant_loss": quant_loss,
               f"{split}/nll_loss": nll_loss, f"{split}/rec_loss": rec.mean(),
               f"{split}/p_loss": p_mean, f"{split}/d_weight": d_weight,
               f"{split}/disc_factor": torch.tensor(
                   float(disc_factor), device=x.device),
               f"{split}/g_loss": g_loss}
        if predicted_indices is not None and self.n_classes is not None:
            perplexity, cluster_use = measure_perplexity(predicted_indices,
                                                         self.n_classes)
            log[f"{split}/perplexity"] = perplexity
            log[f"{split}/cluster_usage"] = cluster_use
        return loss, {k: v.detach() for k, v in log.items()}

    def discriminator_loss(self, x, xrec, global_step, split="train",
                           train=True):
        """optimizer_idx 1 (``vqperceptual.py:151-168``): (loss, log), on
        detached inputs. ``train``: batch statistics, the running ones
        updated on the real batch and then on the fakes; else the running
        statistics."""
        x, xrec = x.detach(), xrec.detach()
        with _mode(self.discriminator, train) as disc:
            logits_real = disc(x)
            logits_fake = disc(xrec)
        disc_factor = adopt_weight(self.disc_factor, global_step,
                                   self.discriminator_iter_start)
        d_loss = disc_factor * self.disc_loss(logits_real, logits_fake)
        log = {f"{split}/disc_loss": d_loss,
               f"{split}/logits_real": logits_real.mean(),
               f"{split}/logits_fake": logits_fake.mean()}
        return d_loss, {k: v.detach() for k, v in log.items()}
