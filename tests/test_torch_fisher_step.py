"""One whole ``fisher_sm`` MCL train step of the port held against the JAX
``build_train_step``.

The small flagship of ``test_torch_mcl_loss.py`` with ``mcl_type``
``fisher_sm`` (λ 0.05): both packages from the same seeded parameters, one
step from global step 0 on the same uint8 batch with the t, the noise and
the Hutchinson ε that the JAX step draws from its key. The port's step
runs twice: on the plain route (the CPU's: autograd records the plain
backward's ops, every order) and through the card's autograd Functions
(``_GNSiLUBwd`` -> ``_GNSiLUBwdBwd``, ``_AttentionCoreBwd`` recording its
VJP), whose kernels take their plain versions on the CPU: the third order
through the frozen decoder that the card runs.

Tolerance, as ``test_torch_mcl_step.py``'s: 1e-4 relative on the losses,
the gradient norm and the scale factor; 1e-4 relative L2 per leaf on the
parameters and the update over the elements whose gradient is above 1e-3
of its leaf's RMS; the other elements, and the leaves whose exact gradient
is zero, are held to a step of at most lr (Adam's first step, ±lr, on a
gradient within rounding of zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core import ema as jema
from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.train import loop as jloop
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn.kernels import _ROUTE
from encdiff_tpu_torch.nn.kernels import attention as kattn
from encdiff_tpu_torch.nn.kernels import groupnorm_silu as kgn
from encdiff_tpu_torch.train.loop import (create_train_state,
                                          trainable_parameters, train_step)
from test_torch_mcl_loss import (LR, batch, jax_config, port_config,
                                 rel_l2, seeded, t_and_noise, torch_tree)

REL = 1e-4


def fisher(cfg):
    cfg["params"]["mcl_type"] = "fisher_sm"
    return cfg


@pytest.fixture(scope="module")
def jax_step():
    jmodel = instantiate_from_config(fisher(jax_config()))
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=32),
        jax.random.PRNGKey(0))
    variables = seeded(shapes, 93)
    params = jax.tree.map(jnp.asarray, {"unet": variables["unet"]["params"],
                                        "cond": variables["cond"]["params"],
                                        "mcl": variables["mcl"]})
    tx = jloop.build_optimizer(jmodel, LR)
    jstate = jloop.TrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray,
                                 variables["cond"]["batch_stats"]),
        opt_state=tx.init(params), ema=jema.init(params["unet"]),
        scale_factor=jnp.asarray(1.0, jnp.float32))
    frozen = {"first_stage": jax.tree.map(jnp.asarray,
                                          variables["first_stage"])}
    x, rng = batch(94), jax.random.PRNGKey(95)
    new, jm = jloop.build_train_step(jmodel, tx, donate=False)(
        jstate, frozen, jnp.asarray(x), rng)
    # the Hutchinson ε: loss_fn's third key, at z's (NHWC) shape
    eps = jax.random.normal(jax.random.split(rng, 3)[2], (len(x), 16, 16, 3),
                            jnp.float32)
    return dict(variables=variables, x=x, rng=rng, eps=np.asarray(eps),
                metrics=jax.device_get(jm), after=new)


def port_step(js, functions, monkeypatch):
    """The port's step from the JAX start; ``functions``: the backward
    Functions' route (the card's) on the CPU."""
    if functions:
        for mod in (kgn, kattn):
            monkeypatch.setattr(mod, "plain_route",
                                lambda x: _ROUTE["plain"])
    config = {**port_config(), "mcl_type": "fisher_sm"}
    tmodel = LatentDiffusion(config, device="cpu")
    tmodel.load_variables({**js["variables"], "ema": None}, 1.0,
                          use_ema=False)
    state = create_train_state(tmodel, config, step=0)
    before = {k: p.detach().clone().numpy()
              for k, p in trainable_parameters(tmodel).items()}
    t, noise = t_and_noise(js["rng"])
    counts = (kgn.gn_silu_bwd3.plain_calls, kgn.gn_silu_bwd3.launches)
    calls = kgn.groupnorm_silu_bwd3_plain
    seen = []
    monkeypatch.setattr(kgn, "groupnorm_silu_bwd3_plain",
                        lambda *a, **k: seen.append(1) or calls(*a, **k))
    m = train_step(tmodel, state, js["x"], t=t, noise=noise,
                   mcl_draw=js["eps"])
    assert (kgn.gn_silu_bwd3.plain_calls, kgn.gn_silu_bwd3.launches) == counts
    # the third-order kernel's (plain) version runs on the Functions' route
    # alone: one call a decoder GN-SiLU site
    assert bool(seen) == functions
    return dict(
        metrics={k: float(v) for k, v in m.items()}, before=before,
        grads={k: p.grad.numpy().copy()
               for k, p in trainable_parameters(tmodel).items()},
        params={k: p.detach().numpy().copy()
                for k, p in trainable_parameters(tmodel).items()},
        scale_factor=float(state.scale_factor))


@pytest.mark.parametrize("functions", [False, True],
                         ids=["plain_route", "card_functions"])
def test_fisher_sm_step_matches_jax(jax_step, functions, monkeypatch):
    got = port_step(jax_step, functions, monkeypatch)
    jm, m = jax_step["metrics"], got["metrics"]
    for k in ("train/loss", "train/loss_simple", "train/loss_mcl",
              "train/mcl_diffusion_ratio", "grad_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=REL, err_msg=k)
    np.testing.assert_allclose(got["scale_factor"],
                               float(jax_step["after"].scale_factor),
                               rtol=REL)
    after = torch_tree(jax_step["after"].params)
    params, before, grads = got["params"], got["before"], got["grads"]
    assert set(params) == set(after)
    total = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                        for g in grads.values()))
    lr = m["lr"]
    masks, zero = {}, []
    for k, g in grads.items():
        if np.linalg.norm(g) <= 1e-6 * total:
            zero.append(k)
        else:
            masks[k] = np.abs(g) >= 1e-3 * np.sqrt(np.mean(np.square(g)))
    kept = sum(mk.sum() for mk in masks.values())
    assert kept >= 0.95 * sum(mk.size for mk in masks.values())
    # the critic's weights reach the loss through the decoder's third order
    for k in ("mcl.critic.img_conv1.weight", "mcl.critic.z_fc.weight"):
        assert k in masks, k
    for k, mk in masks.items():
        want = after[k].numpy()
        assert rel_l2(params[k][mk], want[mk]) <= REL, k
        assert rel_l2(params[k][mk] - before[k][mk],
                      want[mk] - before[k][mk]) <= REL, k
        for p in (params[k], want):
            assert np.abs(p - before[k])[~mk].max(initial=0) <= 1.01 * lr, k
    for k in zero:
        for p in (params[k], after[k].numpy()):
            assert np.abs(p - before[k]).max() <= 1.01 * lr, k
