"""The VQ-GAN trainer's modules held against the JAX package, on the CPU.

Inputs and weights are drawn from numpy seeds (``_seeded`` of
``test_torch_vq_step.py``: kernels N(0, 1/fan_in), norm scales
1 + N(0, 0.1²), BatchNorm variances above 1, every other leaf N(0, 0.1²))
and carried across with
``encdiff_tpu_torch.convert``; the JAX side runs on the CPU, where the
Pallas kernels are off and its modules take their jnp reference.

- the quantizer: loss, indices, perplexity, and the gradients of the
  straight-through output and the codebook loss with respect to z and the
  codebook, against ``jax.grad``;
- LPIPS at 32 px, B = 2, on the JAX random-features variables (the JAX
  ``LPIPSModule.init`` at ``PRNGKey(1830)`` and
  ``calibrate_random_features``), and ``load_torch_lpips`` of one
  synthesized torchvision-layout state dict in both packages;
- the PatchGAN discriminator: logits in train mode (real, then fake, each
  updating the batch statistics) and in eval mode, the new statistics, and
  the generator pass's train mode that leaves them as they are;
- ``generator_loss`` with the adaptive GAN weight (the port's
  ``autograd.grad`` on the conv_out kernel against the JAX conv VJP of the
  sown activation) and ``discriminator_loss``: every logged value;
- ``flax_variables`` of a port ``VQModel`` on the JAX VQVAE's paths;
- ``FLAGSHIP_VQ_RUN`` equal to the YAML.

Tolerance: ``REL`` 1e-5 relative (fp32 sums in another order), with an
absolute floor of 1e-6 for values near 0.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from encdiff_tpu.losses import gan as jgan
from encdiff_tpu.losses import lpips as jlpips
from encdiff_tpu.models.autoencoder import VQModel as JVQModel
from encdiff_tpu.nn.layers import TorchConv as JTorchConv
from encdiff_tpu.nn.quantize import VectorQuantizer as JVectorQuantizer
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FLAGSHIP_VQ_RUN
from encdiff_tpu_torch.losses import gan as tgan
from encdiff_tpu_torch.losses import lpips as tlpips
from encdiff_tpu_torch.models.autoencoder import VQModel
from encdiff_tpu_torch.nn.quantize import VectorQuantizer
from test_torch_harness import _port_target
from test_torch_vq_step import _seeded

ROOT = pathlib.Path(__file__).resolve().parents[1]
VQ_YAML = ROOT / "configs/demo/synthetic-shapes-v4-full-vq.yaml"
REL = 1e-5
ABS = 1e-6
DD = dict(double_z=False, z_channels=3, resolution=32, in_channels=3,
          out_ch=3, ch=32, ch_mult=[1, 2], num_res_blocks=1,
          attn_resolutions=[], dropout=0.0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _close(got, want, err=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=REL,
                               atol=ABS, err_msg=err)


def _images(seed, b=2, s=32):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, s, s, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def lpips_vars():
    """The JAX random-features LPIPS variables (``LPIPS.init_variables``
    without the weight files: ``LPIPSModule.init`` at ``PRNGKey(1830)``,
    jitted, and ``calibrate_random_features``)."""
    module = jlpips.LPIPSModule()
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = jax.jit(module.init)(jax.random.PRNGKey(1830), x, x)
    return jax.tree.map(np.asarray, jlpips.calibrate_random_features(
        variables))


@pytest.fixture(scope="module")
def disc_vars():
    disc = jgan.NLayerDiscriminator()
    shapes = jax.eval_shape(lambda: disc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    return _seeded(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                dict(shapes)), 3)


def _port_disc(disc_vars):
    disc = tgan.NLayerDiscriminator()
    disc.load_state_dict({**convert.flax_to_state_dict(disc_vars["params"]),
                          **convert.flax_to_state_dict(
                              disc_vars["batch_stats"])}, strict=False)
    return disc


def test_quantizer_loss_indices_perplexity_and_gradients():
    rs = np.random.RandomState(0)
    z = rs.randn(2, 6, 5, 3).astype(np.float32)
    emb = (0.5 * rs.randn(16, 3)).astype(np.float32)
    w = rs.randn(2, 6, 5, 3).astype(np.float32)
    jq = JVectorQuantizer(16, 3)

    def jf(z, emb):
        zq, loss, (perp, _, idx) = jq.apply({"params": {"embedding": emb}}, z)
        return jnp.sum(zq * w) + 3.0 * loss, (zq, loss, perp, idx)

    (_, (jzq, jloss, jperp, jidx)), (jgz, jgemb) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(z, emb)

    q = VectorQuantizer(16, 3)
    with torch.no_grad():
        q.embedding.copy_(torch.from_numpy(emb))
    tz = _nchw(z).requires_grad_(True)
    zq, loss, (perp, _, idx) = q(tz)
    (torch.sum(zq * _nchw(w)) + 3.0 * loss).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(idx.numpy())) > 4
    _close(zq.detach().permute(0, 2, 3, 1).numpy(), jzq, "z_q")
    _close(loss.item(), float(jloss), "loss")
    _close(perp.item(), float(jperp), "perplexity")
    _close(tz.grad.permute(0, 2, 3, 1).numpy(), jgz, "grad z")
    _close(q.embedding.grad.numpy(), jgemb, "grad codebook")


def test_lpips_random_features_match_jax(lpips_vars):
    x, y = _images(1), _images(2)
    want = jlpips.LPIPSModule().apply(lpips_vars, x, y)
    port = tlpips.LPIPS()
    port.load_state_dict(convert.flax_to_state_dict(lpips_vars["params"]))
    got = port(_nchw(x), _nchw(y))
    assert got.shape == (2,)
    _close(got.detach().numpy(), want, "lpips")
    # the port's own trunk: the JAX laws, not the JAX draw; the heads alike
    own = tlpips.LPIPS()
    w = own.vgg.conv_3.weight
    assert float(w.abs().max()) <= (64 * 9) ** -0.5
    assert not np.allclose(w.detach().numpy(), convert.flax_to_state_dict(
        lpips_vars["params"])["vgg.conv_3.weight"].numpy())
    for k, c in enumerate(tlpips.VGG_CHANNELS):
        assert torch.equal(getattr(own, f"lin{k}").weight,
                           getattr(port, f"lin{k}").weight)
        assert float(getattr(own, f"lin{k}").weight[0, 0]) == \
            pytest.approx(1.0 / c)


def test_load_torch_lpips_matches_jax(lpips_vars):
    rs = np.random.RandomState(4)
    vgg_state, cin, k = {}, 3, 0
    for stage, n in enumerate(tlpips.STAGE_CONVS):
        for _ in range(n):
            c = tlpips.VGG_CHANNELS[stage]
            tvi = tlpips.TORCHVISION_CONVS[k]
            vgg_state[f"features.{tvi}.weight"] = (
                rs.randn(c, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
            vgg_state[f"features.{tvi}.bias"] = (
                0.1 * rs.randn(c)).astype(np.float32)
            cin, k = c, k + 1
    lin_state = {f"lin{k}.model.1.weight": np.abs(
        rs.randn(1, c, 1, 1)).astype(np.float32) / c
        for k, c in enumerate(tlpips.VGG_CHANNELS)}
    jvars = jlpips.load_torch_lpips(lpips_vars, vgg_state, lin_state)
    port = tlpips.load_torch_lpips(
        tlpips.LPIPS(), {k: torch.from_numpy(v) for k, v in vgg_state.items()},
        {k: torch.from_numpy(v) for k, v in lin_state.items()})
    x, y = _images(5), _images(6)
    want = jlpips.LPIPSModule().apply(jvars, x, y)
    _close(port(_nchw(x), _nchw(y)).detach().numpy(), want, "lpips")


def test_discriminator_batch_statistics_match_jax(disc_vars):
    jdisc = jgan.NLayerDiscriminator()
    x, y = _images(7), _images(8)
    jr, mut = jdisc.apply(disc_vars, x, train=True, mutable=["batch_stats"])
    jf, mut = jdisc.apply({"params": disc_vars["params"], **mut}, y,
                          train=True, mutable=["batch_stats"])
    je = jdisc.apply(disc_vars, x, train=False)

    port = _port_disc(disc_vars)
    stats0 = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    # the generator pass: train mode, batch statistics, no update
    _close(port(_nchw(y), update_stats=False).detach().permute(
        0, 2, 3, 1).numpy(), jdisc.apply(disc_vars, y, train=True,
                                         mutable=["batch_stats"])[0], "g pass")
    assert all(torch.equal(v, stats0[k]) for k, v in port.state_dict().items())
    # the discriminator pass: real, then fake, both updating
    _close(port(_nchw(x)).detach().permute(0, 2, 3, 1).numpy(), jr, "real")
    _close(port(_nchw(y)).detach().permute(0, 2, 3, 1).numpy(), jf, "fake")
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray,
                                                   mut["batch_stats"]))
    for key, v in want.items():
        _close(port.state_dict()[key].numpy(), v.numpy(), key)
    port.load_state_dict(stats0)
    port.eval()
    _close(port(_nchw(x)).detach().permute(0, 2, 3, 1).numpy(), je, "eval")


def test_generator_and_discriminator_losses_match_jax(lpips_vars, disc_vars):
    """The adaptive weight through both routes, and every logged value."""
    kw = dict(disc_start=0, disc_weight=0.75, codebook_weight=1.0,
              perceptual_weight=1.0, n_classes=16)
    jloss = jgan.VQLPIPSWithDiscriminator(**kw)
    rs = np.random.RandomState(9)
    x = _images(10)
    pre = rs.randn(2, 32, 32, 32).astype(np.float32)
    w = {"Conv_0": {"kernel": (rs.randn(3, 3, 32, 3) / np.sqrt(288)).astype(
        np.float32), "bias": (0.1 * rs.randn(3)).astype(np.float32)}}
    qloss = np.float32(0.37)
    ind = rs.randint(0, 16, (2, 8, 8))
    conv_out = JTorchConv(3, 3, padding=1)
    apply = lambda p, h: conv_out.apply({"params": p}, h)
    xrec = apply(w, pre)
    loss_vars = {"lpips": lpips_vars}
    _, jlog = jloss.generator_loss(
        loss_vars, disc_vars["params"], qloss, x, xrec, 0,
        conv_out_params=w, pre_conv_out=pre, conv_out_apply=apply,
        predicted_indices=ind, disc_batch_stats=disc_vars["batch_stats"])
    _, jev = jloss.generator_loss(
        loss_vars, disc_vars["params"], qloss, x, xrec, 0, split="val",
        predicted_indices=ind, disc_batch_stats=disc_vars["batch_stats"])
    _, jd, jstats = jloss.discriminator_loss(
        disc_vars["params"], x, xrec, 0,
        disc_batch_stats=disc_vars["batch_stats"], train=True)
    _, jdv, _ = jloss.discriminator_loss(
        disc_vars["params"], x, xrec, 0,
        disc_batch_stats=disc_vars["batch_stats"], train=False, split="val")

    port = tgan.VQLPIPSWithDiscriminator(**kw)
    port.discriminator = _port_disc(disc_vars)
    port.lpips.load_state_dict(convert.flax_to_state_dict(
        lpips_vars["params"]))
    weight = torch.from_numpy(np.ascontiguousarray(
        w["Conv_0"]["kernel"].transpose(3, 2, 0, 1))).requires_grad_(True)
    txrec = F.conv2d(_nchw(pre), weight, torch.from_numpy(w["Conv_0"]["bias"]),
                     padding=1)
    _, log = port.generator_loss(torch.tensor(qloss), _nchw(x), txrec, 0,
                                 last_layer=weight,
                                 predicted_indices=torch.from_numpy(ind))
    with torch.no_grad():
        _, ev = port.generator_loss(torch.tensor(qloss), _nchw(x), txrec, 0,
                                    split="val",
                                    predicted_indices=torch.from_numpy(ind))
        _, dv = port.discriminator_loss(_nchw(x), txrec, 0, split="val",
                                        train=False)
        _, d = port.discriminator_loss(_nchw(x), txrec, 0)
    for got, want in ((log, jlog), (ev, jev), (d, jd), (dv, jdv)):
        assert set(got) == set(want)
        for k in want:
            _close(got[k].item(), float(want[k]), k)
    assert 0.0 < log["train/d_weight"].item() < 0.75 * 1e4
    assert ev["val/d_weight"].item() == 0.75
    stats = convert.flax_to_state_dict(jax.tree.map(np.asarray, jstats))
    for key, v in stats.items():
        _close(port.discriminator.state_dict()[key].numpy(), v.numpy(), key)


def test_flax_variables_on_the_jax_paths():
    jvq = JVQModel(ddconfig=DD, n_embed=64, embed_dim=3)
    shapes = jax.eval_shape(lambda: jvq.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    model = VQModel(DD, n_embed=64, embed_dim=3)
    model.init_parameters(torch.Generator().manual_seed(0))
    params = {name: convert.flax_variables(getattr(model, name))[0]
              for name in ("encoder", "quant_conv", "quantize",
                           "post_quant_conv", "decoder")}
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.tree.map(lambda s: 0, dict(shapes)))
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree.leaves(shapes)):
        assert got.shape == want.shape, path
    # and back: flax_to_state_dict inverts it
    sd = convert.flax_to_state_dict(params["decoder"])
    for k, v in model.decoder.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_flagship_vq_run_matches_yaml():
    with open(VQ_YAML) as f:
        ref = yaml.safe_load(f)
    assert FLAGSHIP_VQ_RUN == _port_target(ref)
