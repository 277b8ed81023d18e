"""The port's ``LatentDiffusion.loss_fn`` with MCL held against the JAX one.

At the small flagship of ``tests/test_train_loop.py`` (``_flagship_config``
with UNet model_channels 32, channel_mult (1, 2), one res block; VQ ch 32,
ch_mult (1, 2) at 32 px, so 16x16x3 latents; Encoder4 d 128) with the
MCL fine-tune's keys (``infonce_mechgrad``, λ 0.05, τ 0.1, projections of
32), both packages start from the same seeded flax parameters, converted
with ``encdiff_tpu_torch.convert``, and evaluate the loss on the same uint8
batch with the t and the noise the JAX ``loss_fn`` draws from its key:
the loss, ``loss_simple``, ``loss_mcl``, the ratio, and the gradient of
every trainable leaf (UNet, Encoder4, critic, Pi_g, Pi_u). The MCL term
decodes through the quantizer: the test first holds the two packages' code
indices equal.

Tolerance: 1e-5 relative on the losses; 1e-4 relative L2 per gradient leaf.
Leaves whose exact gradient is zero (Encoder4's conv biases before a
BatchNorm; the critic's biases and ``u_fc.weight``, which reach the
mechanism gradient only through a ReLU's mask) hold rounding and are held
within 1e-6 of the global gradient norm instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train.loop import trainable_parameters

B = 4
REL = 1e-4
MCL = {"use_mcl": True, "lambda_mcl": 0.05, "mcl_type": "infonce_mechgrad",
       "mcl_tau": 0.1, "mcl_sigma": 0.1, "mcl_neg_mode": "shuffle_u",
       "mcl_proj_dim": 32}
SCHEDULER = {"warm_up_steps": [10], "cycle_lengths": [10000000000000],
             "f_start": [0.5], "f_max": [1.0], "f_min": [1.0]}
LR = 2e-3  # Adam moves a leaf by lr = 1e-3 at step 0: its update resolves in fp32


def jax_config():
    cfg = _flagship_config(model_channels=32, num_res_blocks=1, vq_ch=32,
                           channel_mult=(1, 2), vq_ch_mult=(1, 2),
                           resolution=32)
    cfg["params"].update(MCL)
    cfg["params"]["scheduler_config"] = {
        "target": "encdiff_tpu.core.lr_scheduler.LambdaLinearScheduler",
        "params": SCHEDULER}
    return cfg


def port_config():
    """The same model as the port's flat dict: the sub-configs' params,
    and what ``train.loop.create_train_state`` reads."""
    params = dict(jax_config()["params"])
    for key in ("unet_config", "first_stage_config", "cond_stage_config"):
        params[key] = params[key]["params"]
    params["scheduler_config"] = SCHEDULER
    return {**params, "base_learning_rate": LR / B, "batch_size": B}


def seeded(shapes, seed):
    """Kernels N(0, 1/fan_in), norm scales and BatchNorm variances
    1 + N(0, 0.1²) (variances kept above 1), other leaves N(0, 0.1²)."""
    rs = np.random.RandomState(seed)

    def walk(t, path=()):
        if hasattr(t, "items"):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        noise = rs.randn(*t.shape).astype(np.float32)
        if path[-1] == "kernel":
            return noise / np.sqrt(np.prod(t.shape[:-1]))
        if path[-1] == "scale":
            return 1.0 + 0.1 * noise
        if path[-1] == "var":
            return 1.0 + 0.1 * np.abs(noise)
        return 0.1 * noise
    return walk(shapes)


def jax_model_and_variables(seed=80):
    jmodel = instantiate_from_config(jax_config())
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=32),
        jax.random.PRNGKey(0))
    return jmodel, seeded(shapes, seed)


def port_model(variables, scale_factor):
    tmodel = LatentDiffusion(port_config(), device="cpu")
    tmodel.load_variables({**variables, "ema": None}, scale_factor,
                          use_ema=False)
    return tmodel


def batch(seed):
    return np.random.RandomState(seed).randint(0, 256, (B, 32, 32, 3),
                                               dtype=np.uint8)


def t_and_noise(rng):
    """What the JAX loss_fn draws from its key (the MCL type draws
    nothing)."""
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    return np.asarray(t), np.asarray(jax.random.normal(n_rng, (B, 16, 16, 3)))


def torch_tree(tree):
    """A JAX {unet, cond, mcl} tree by the port's trainable-leaf names."""
    tree = jax.device_get(tree)
    out = {f"unet.{k}": v for k, v in
           convert.flax_to_state_dict(tree["unet"]).items()}
    out.update({f"cond.{k}": v for k, v in
                convert.encoder4_state_dict(tree["cond"], {}).items()})
    out.update({f"mcl.{k}": v for k, v in
                convert.mcl_state_dict(tree["mcl"]).items()})
    return out


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def split_leaves(grads: dict):
    """(leaves whose gradient is zero up to rounding, the others, the
    global norm)."""
    total = np.sqrt(sum(np.sum(np.square(np.asarray(v), dtype=np.float64))
                        for v in grads.values()))
    zero = {k for k, v in grads.items()
            if np.linalg.norm(np.asarray(v)) <= 1e-6 * total}
    return zero, set(grads) - zero, total


def check_codes(jmodel, fs_vars, tmodel, x, sf):
    """The two packages quantize the batch's latents, scaled and unscaled
    as the MCL decoder takes them, to the same codes, each in its own
    arithmetic."""
    xf = jnp.asarray(x, jnp.float32) / 127.5 - 1.0
    zj = (1.0 / sf) * (jnp.float32(sf) * jmodel.encode_first_stage(fs_vars,
                                                                   xf))
    jind = jmodel.first_stage_model.module.apply(
        fs_vars, zj, method=lambda m, h: m.quantize(h)[2][2])
    zt = tmodel.encode_first_stage(tmodel.split_batch(x)[0])
    zt = zt.permute(0, 3, 1, 2) * torch.tensor(sf) * (1.0 / torch.tensor(sf))
    tind = tmodel.first_stage_model.quantize(zt)[2][2]
    np.testing.assert_array_equal(tind.numpy(),
                                  np.asarray(jind).reshape(tind.shape))


@pytest.fixture(scope="module")
def losses():
    jmodel, variables = jax_model_and_variables()
    params = jax.tree.map(jnp.asarray, {"unet": variables["unet"]["params"],
                                        "cond": variables["cond"]["params"],
                                        "mcl": variables["mcl"]})
    frozen = {"first_stage": jax.tree.map(jnp.asarray,
                                          variables["first_stage"]),
              "cond_batch_stats": jax.tree.map(
                  jnp.asarray, variables["cond"]["batch_stats"])}
    sf = 0.8
    x = batch(81)
    rng = jax.random.PRNGKey(82)

    def loss(p):
        out, (ld, _) = jmodel.loss_fn(p, frozen, jnp.asarray(x), rng,
                                      jnp.float32(sf), train=True)
        return out, ld
    (jloss, jdict), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    tmodel = port_model(variables, sf)
    check_codes(jmodel, frozen["first_stage"], tmodel, x, sf)
    for p in trainable_parameters(tmodel).values():
        p.requires_grad_(True)
    t, noise = t_and_noise(rng)
    tloss, tdict = tmodel.loss_fn(x, t, noise, torch.tensor(sf))
    tloss.backward()
    tgrads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
              .numpy() for k, p in trainable_parameters(tmodel).items()}
    return dict(jdict=jax.device_get(jdict), tdict=tdict,
                jgrads=torch_tree(jgrads), tgrads=tgrads)


def test_losses(losses):
    jd, td = losses["jdict"], losses["tdict"]
    for k in ("train/loss", "train/loss_simple", "train/loss_mcl",
              "train/mcl_diffusion_ratio"):
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(jd["train/loss_mcl"]) > 0


def test_gradient_of_every_trainable_leaf(losses):
    want = {k: v.numpy() for k, v in losses["jgrads"].items()}
    got = losses["tgrads"]
    assert set(got) == set(want)
    assert any(k.startswith("mcl.critic.") for k in got)
    zero, live, total = split_leaves(want)
    # the critic's weights reach the loss through the decoder's second
    # order; Encoder4 through the decoder's concat, u_fc and Pi_u
    for k in ("mcl.critic.img_conv1.weight", "mcl.critic.img_conv2.weight",
              "mcl.critic.z_fc.weight", "mcl.critic.out.weight"):
        assert k in live, k
    worst = max((rel_l2(got[k], want[k]), k) for k in live)
    assert worst[0] <= REL, worst
    for k in zero:
        assert np.linalg.norm(got[k] - want[k]) <= 1e-6 * total, k
