"""One whole MCL train step of the port held against the JAX
``build_train_step``.

The small flagship with the MCL keys of ``test_torch_mcl_loss.py``, both
packages from the same seeded parameters, one step from global step 0
(scale_by_std sets the scale factor) on the same uint8 batch with the t
and the noise the JAX step draws: the losses, ``loss_mcl``, the gradient
norm, the scale factor, every trainable leaf after AdamW (the MCL heads
among them, weight decay 1e-2 on every leaf as ``optax.adamw``), the EMA
(the UNet's alone) and Encoder4's batch statistics.

Tolerance: 1e-4 relative on the losses, the gradient norm and the scale
factor; 1e-4 relative L2 per leaf on the parameters, the update and the
EMA, over the elements whose gradient is above 1e-3 of its leaf's RMS. The
sign of a gradient within rounding of zero, and so of Adam's first step,
±lr, on it, is rounding noise: those elements, and the leaves whose exact
gradient is zero, are held to a step of at most lr (plus the decay).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core import ema as jema
from encdiff_tpu.train import loop as jloop
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.train.loop import (create_train_state,
                                          trainable_parameters, train_step)
from test_torch_mcl_loss import (B, LR, batch, jax_model_and_variables,
                                 port_config, port_model, rel_l2,
                                 t_and_noise, torch_tree)

REL = 1e-4


@pytest.fixture(scope="module")
def step():
    jmodel, variables = jax_model_and_variables(90)
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
    x, rng = batch(91), jax.random.PRNGKey(92)
    new, jm = jloop.build_train_step(jmodel, tx, donate=False)(
        jstate, frozen, jnp.asarray(x), rng)

    tmodel = port_model(variables, 1.0)
    state = create_train_state(tmodel, port_config(), step=0)
    before = {k: p.detach().clone().numpy()
              for k, p in trainable_parameters(tmodel).items()}
    t, noise = t_and_noise(rng)
    m = train_step(tmodel, state, x, t=t, noise=noise)
    return dict(
        jax_metrics=jax.device_get(jm), jax_after=new,
        before=before, metrics={k: float(v) for k, v in m.items()},
        grads={k: p.grad.numpy().copy()
               for k, p in trainable_parameters(tmodel).items()},
        params={k: p.detach().numpy().copy()
                for k, p in trainable_parameters(tmodel).items()},
        ema={f"unet.{k}": v.numpy().copy() for k, v in state.ema.params.items()},
        stats={k: v.numpy().copy() for k, v in
               tmodel.cond_stage_model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))},
        scale_factor=float(state.scale_factor))


def test_losses_grad_norm_and_scale_factor(step):
    jm, m = step["jax_metrics"], step["metrics"]
    for k in ("train/loss", "train/loss_simple", "train/loss_mcl",
              "train/mcl_diffusion_ratio", "grad_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=REL, err_msg=k)
    np.testing.assert_allclose(step["scale_factor"],
                               float(step["jax_after"].scale_factor), rtol=REL)
    assert abs(step["scale_factor"] - 1.0) > 0.01  # scale_by_std at step 0
    assert m["lr"] == pytest.approx(0.5 * LR, rel=1e-6)


def test_every_leaf_after_adamw_and_the_ema(step):
    after = torch_tree(step["jax_after"].params)
    got, before, grads = step["params"], step["before"], step["grads"]
    assert set(got) == {k: v for k, v in after.items()}.keys()
    assert any(k.startswith("mcl.") for k in got)
    total = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                        for g in grads.values()))
    lr = step["metrics"]["lr"]
    masks, zero = {}, []
    for k, g in grads.items():
        if np.linalg.norm(g) <= 1e-6 * total:
            zero.append(k)
        else:
            masks[k] = np.abs(g) >= 1e-3 * np.sqrt(np.mean(np.square(g)))
    kept = sum(mk.sum() for mk in masks.values())
    assert kept >= 0.95 * sum(mk.size for mk in masks.values())
    for k, mk in masks.items():
        want = after[k].numpy()
        assert rel_l2(got[k][mk], want[mk]) <= REL, k
        assert rel_l2(got[k][mk] - before[k][mk],
                      want[mk] - before[k][mk]) <= REL, k
        # elements within rounding of a zero gradient: at most Adam's ±lr
        for p in (got[k], want):
            assert np.abs(p - before[k])[~mk].max(initial=0) <= 1.01 * lr, k
    for k in zero:
        for p in (got[k], after[k].numpy()):
            assert np.abs(p - before[k]).max() <= 1.01 * lr, k
    # every MCL head leaf moved (AdamW's decay moves a zero-gradient leaf)
    moved = [k for k in got if k.startswith("mcl.")
             and not np.array_equal(got[k], before[k])]
    assert len(moved) == sum(k.startswith("mcl.") for k in got)
    jema_after = {f"unet.{k}": v for k, v in convert.flax_to_state_dict(
        jax.device_get(step["jax_after"].ema.params)).items()}
    assert set(step["ema"]) == set(jema_after)
    for k, v in jema_after.items():
        mk = masks.get(k)
        if mk is not None:
            assert rel_l2(step["ema"][k][mk], v.numpy()[mk]) <= REL, k
    stats = convert.flax_to_state_dict(
        jax.device_get(step["jax_after"].batch_stats))
    for k, v in stats.items():
        np.testing.assert_allclose(step["stats"][k], v.numpy(), rtol=REL,
                                   atol=1e-6, err_msg=k)
