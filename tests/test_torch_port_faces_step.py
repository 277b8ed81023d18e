"""The port's faces train step with gradient accumulation held against the
JAX ``build_train_step`` with ``optax.MultiSteps``, and the faces CLI.

A faces-shaped model at a small width (128 px images on 32x32 latents, so
that the UNet's top level and the VQ encoder's mid block reach the flash
route; UNet model_channels 32, channel_mult (1, 2), one res block,
attention at the top level, 4 heads; VQ ch 32, ch_mult (1, 2, 4); Encoder4
d 32) starts in both packages from the same flax-initialised parameters,
valued from a numpy seed so that no zero-initialised output conv hides a
path, and takes micro-batches of 2 with 2-way accumulation: 4 micro-batches,
2 optimizer updates, with the t and the noise the JAX step draws from its
key. The first micro-batch is at global step 0, where scale_by_std sets the
scale factor. The LR schedule starts at half its peak so that AdamW's
update is visible against the tolerance. The JAX step runs on its XLA path
(``ENCDIFF_PALLAS=off``); ``test_torch_port_faces.py`` holds the flash
kernels to the Pallas ones in interpret mode.

After every micro-batch: the loss, the micro-batch's gradient norm, the
scale factor and the LR to 1e-4 relative; the parameters, the AdamW update,
the EMA and the batch statistics to 1e-4 relative L2 per leaf (from the
first update on, the statistics come from parameters that differ by
rounding, and some entries are near 0),
with the exact-zero rule of ``test_torch_port_train_step.py``: leaves whose
exact gradient is zero, and elements whose gradient is within rounding of
zero, are checked apart, since the sign of Adam's step on them is rounding
noise. Between updates the parameters stand still in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from encdiff_tpu.core import ema as jema
from encdiff_tpu.core import lr_scheduler as jlr
from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.train import loop as jloop
from encdiff_tpu_torch import convert, train_steps
from encdiff_tpu_torch.configs import FACES_TRAIN
from encdiff_tpu_torch.core.compact_ckpt import load_compact
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as tattn
from encdiff_tpu_torch.train.loop import (create_train_state,
                                          trainable_parameters, train_step)
from torch_threads import one_thread  # noqa: F401

REL = 1e-4
B, ACC, MICRO = 2, 2, 4
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

SMALL_UNET = dict(image_size=32, in_channels=3, out_channels=3,
                  model_channels=32, attention_resolutions=[1],
                  num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
                  use_scale_shift_norm=True, resblock_updown=True,
                  use_spatial_transformer=True, context_dim=16,
                  latent_unit=20)
FIRST_STAGE = {
    "embed_dim": 3, "n_embed": 64, "use_disentangled_concat": True,
    "disentangled_dim": 20,
    "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 128,
                 "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2, 4],
                 "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}
COND = {"d": 32, "context_dim": 16, "latent_unit": 20}
SCHEDULER = {"warm_up_steps": [10], "cycle_lengths": [10000000000000],
             "f_start": [0.5], "f_max": [1.0], "f_min": [1.0]}
SMALL = {
    "timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0155,
    "image_size": 32, "channels": 3, "loss_type": "l1", "scale_by_std": True,
    "unet_config": SMALL_UNET, "first_stage_config": FIRST_STAGE,
    "cond_stage_config": COND, "base_learning_rate": 2e-3 / (B * ACC),
    "batch_size": B, "accumulate_grad_batches": ACC,
    "scheduler_config": SCHEDULER, "seed": 23,
}
JAX_CONFIG = {
    "target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
    "params": {
        "timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0155,
        "image_size": 32, "channels": 3, "loss_type": "l1",
        "scale_by_std": True, "cond_stage_trainable": True,
        "concat_mode": False, "conditioning_key": "crossattn",
        "use_ema": True,
        "scheduler_config": {
            "target": "encdiff_tpu.core.lr_scheduler.LambdaLinearScheduler",
            "params": SCHEDULER},
        "unet_config": {"target": "encdiff_tpu.nn.unet.UNetModel",
                        "params": SMALL_UNET},
        "first_stage_config": {
            "target": "encdiff_tpu.models.autoencoder.VQModelInterface",
            "params": {**FIRST_STAGE,
                       "lossconfig": {"target": "torch.nn.Identity"}}},
        "cond_stage_config": {"target": "encdiff_tpu.nn.encoder4.Encoder4",
                              "params": COND}}}


def _seeded(shapes, seed):
    """Values from a numpy seed for a flax tree of shapes: kernels
    N(0, 1/fan_in), norm scales and BatchNorm variances 1 + N(0, 0.1^2)
    (variances kept above 1), every other leaf N(0, 0.1^2)."""
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


def _batch(seed):
    return np.random.RandomState(seed).randint(0, 256, (B, 128, 128, 3),
                                               dtype=np.uint8)


def _t_and_noise(rng):
    """What the JAX loss_fn draws from its key."""
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    return np.asarray(t), np.asarray(jax.random.normal(n_rng, (B, 32, 32, 3)))


def _torch_tree(tree):
    """A JAX {unet, cond} tree as the port's trainable-parameter names."""
    out = {f"unet.{k}": v.numpy() for k, v in
           convert.flax_to_state_dict(jax.device_get(tree["unet"])).items()}
    out.update({f"cond.{k}": v.numpy() for k, v in convert.encoder4_state_dict(
        jax.device_get(tree["cond"]), {}).items()})
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_leaves(got: dict, want: dict, tol: float, what: str):
    assert set(got) == set(want), what
    worst = max((_rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= tol, f"{what}: {worst[1]} off by {worst[0]:.2e}"


@pytest.fixture(scope="module")
def micro_steps():
    """Four micro-batches in both packages from the same parameters: per
    micro-batch the JAX state after it, its metrics and the LR its schedule
    gives, the port's snapshots, and the mean gradients of the port's
    updates so far."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ENCDIFF_PALLAS", "off")
        jmodel = instantiate_from_config(JAX_CONFIG)
        shapes = jax.eval_shape(
            lambda k: jmodel.init_variables(k, image_resolution=128),
            jax.random.PRNGKey(0))
        variables = _seeded(shapes, 70)
        params = jax.tree.map(jnp.asarray,
                              {"unet": variables["unet"]["params"],
                               "cond": variables["cond"]["params"]})
        stats = jax.tree.map(jnp.asarray, variables["cond"]["batch_stats"])
        frozen = {"first_stage": jax.tree.map(jnp.asarray,
                                              variables["first_stage"])}
        lr = jloop.scaled_learning_rate(SMALL["base_learning_rate"], B, 1, ACC)
        tx = jloop.build_optimizer(jmodel, lr, accumulate=ACC)
        schedule = jlr.as_optax_schedule(
            jlr.LambdaLinearScheduler(**SCHEDULER), lr)
        jstate = jloop.TrainState(
            step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), ema=jema.init(params["unet"]),
            scale_factor=jnp.asarray(1.0, jnp.float32))

        # the same program, compiled with XLA's cheaper CPU backend passes:
        # half the compile time on one core
        step_fn = jloop.build_train_step(jmodel, tx, donate=False).lower(
            jstate, frozen, jnp.asarray(_batch(80)),
            jax.random.PRNGKey(80)).compile(FAST_COMPILE)

        tmodel = LatentDiffusion(SMALL, device="cpu")
        tmodel.load_variables({**variables, "ema": None}, 1.0, use_ema=False)
        state = create_train_state(tmodel, SMALL)
        # the mean gradient each AdamW step is given
        means = []
        named = trainable_parameters(tmodel)
        state.optimizer.register_step_pre_hook(lambda *_: means.append(
            {k: p.grad.numpy().copy() for k, p in named.items()}))
        out = [{"jax_after": jstate, "port": {"params": _snapshot(tmodel)}}]
        for i in range(MICRO):
            rng, batch = jax.random.PRNGKey(80 + i), _batch(80 + i)
            jax_lr = float(schedule(jstate.opt_state.gradient_step))
            jstate, jm = step_fn(jstate, frozen, jnp.asarray(batch), rng)
            t, noise = _t_and_noise(rng)
            m = train_step(tmodel, state, batch, t=t, noise=noise)
            out.append(dict(
                jax_after=jstate, jax_metrics=jax.device_get(jm),
                jax_lr=jax_lr, update_grads=list(means),
                port={"metrics": {k: float(v) for k, v in m.items()},
                      "params": _snapshot(tmodel),
                      "ema": {f"unet.{k}": v.numpy().copy()
                              for k, v in state.ema.params.items()},
                      "stats": {k: v.numpy().copy() for k, v in
                                tmodel.cond_stage_model.state_dict().items()
                                if k.endswith(("running_mean",
                                               "running_var"))},
                      "scale_factor": float(state.scale_factor),
                      "step": state.step, "updates": state.updates,
                      "adam_steps": int(state.optimizer.state.get(
                          next(iter(trainable_parameters(tmodel).values())),
                          {}).get("step", 0))}))
    return out


def _snapshot(tmodel):
    return {k: p.detach().clone().numpy()
            for k, p in trainable_parameters(tmodel).items()}


def _split_leaves(grads: dict):
    """(leaves whose gradient is zero up to rounding, {leaf: mask of the
    elements whose gradient is above rounding}), as in
    ``test_torch_port_train_step.py``."""
    total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                        for v in grads.values()))
    zero, masks = set(), {}
    for k, g in grads.items():
        if np.linalg.norm(g) <= 1e-6 * total:
            zero.add(k)
        else:
            masks[k] = np.abs(g) >= 1e-3 * np.sqrt(np.mean(np.square(g)))
    return zero, masks


def _update_masks(micro_steps, i):
    """The exact-zero leaves and the element masks of every update up to
    micro-batch ``i``: an element is compared only where the mean gradient
    of each update so far is above rounding. The mean gradients are the
    port's (they match the JAX ones to 1e-4, which decides no mask)."""
    zero = set()
    masks = {k: np.ones(v.shape, bool)
             for k, v in micro_steps[0]["port"]["params"].items()}
    for grads in micro_steps[i]["update_grads"]:
        z, m = _split_leaves(grads)
        zero |= z
        masks = {k: masks[k] & v for k, v in m.items()}
    return zero, {k: v for k, v in masks.items() if k not in zero}


@pytest.mark.parametrize("i", range(1, MICRO + 1))
def test_loss_grad_norm_scale_factor_and_lr(micro_steps, i):
    r = micro_steps[i]
    port, jm = r["port"], r["jax_metrics"]
    for k in ("train/loss", "train/loss_simple", "grad_norm"):
        np.testing.assert_allclose(port["metrics"][k], float(jm[k]), rtol=REL,
                                   err_msg=k)
    sf = float(r["jax_after"].scale_factor)
    np.testing.assert_allclose(port["scale_factor"], sf, rtol=REL)
    assert abs(sf - 1.0) > 0.01  # scale_by_std set it at global step 0
    assert port["scale_factor"] == micro_steps[1]["port"]["scale_factor"]
    np.testing.assert_allclose(port["metrics"]["lr"], r["jax_lr"], rtol=1e-6)
    updates = i // ACC
    assert (port["step"], port["updates"], port["adam_steps"]) == (
        i, updates, updates)
    assert (int(r["jax_after"].step),
            int(r["jax_after"].opt_state.gradient_step)) == (i, updates)


@pytest.mark.parametrize("i", range(1, MICRO + 1))
def test_params_update_ema_and_batch_stats(micro_steps, i):
    r, before = micro_steps[i], micro_steps[i - 1]
    port = r["port"]
    jax_after = _torch_tree(r["jax_after"].params)
    jax_before = _torch_tree(before["jax_after"].params)
    if i % ACC:  # no update: the parameters stand still in both packages
        for k, v in port["params"].items():
            np.testing.assert_array_equal(v, before["port"]["params"][k])
            np.testing.assert_array_equal(jax_after[k], jax_before[k])
    zero, masks = _update_masks(micro_steps, i)
    kept = sum(m.sum() for m in masks.values())
    assert kept >= 0.95 * sum(m.size for m in masks.values())
    pick = lambda d: {k: np.asarray(d[k])[m] for k, m in masks.items()
                      if k in d}
    _assert_leaves(pick(port["params"]), pick(jax_after), REL, "parameters")
    if i % ACC == 0:
        _assert_leaves(
            {k: port["params"][k][m] - before["port"]["params"][k][m]
             for k, m in masks.items()},
            {k: jax_after[k][m] - jax_before[k][m] for k, m in masks.items()},
            REL, "AdamW update")
    ema = {f"unet.{k}": v.numpy() for k, v in convert.flax_to_state_dict(
        jax.device_get(r["jax_after"].ema.params)).items()}
    _assert_leaves(pick(port["ema"]), pick(ema), REL, "EMA")
    lr = max(micro_steps[j]["port"]["metrics"]["lr"] for j in range(1, i + 1))
    start = micro_steps[0]["port"]["params"]
    for k in zero:  # Adam's steps are at most lr each (plus the decay)
        for p in (port["params"][k], jax_after[k]):
            assert np.abs(p - start[k]).max() <= 1.01 * lr * (i // ACC), k
    stats = convert.flax_to_state_dict(
        jax.device_get(r["jax_after"].batch_stats))
    _assert_leaves(port["stats"], {k: v.numpy() for k, v in stats.items()},
                   REL, "batch statistics")


def test_faces_cli_at_a_small_width(tmp_path, capsys, monkeypatch):
    """``train_steps --config faces`` from a fresh init, 2 micro-batches of
    2 with 2-way accumulation on the CPU, saved and read back, with the
    faces configuration's LR fields at the small width; the UNet at 32x32
    latents and the VQ mid block take the flash route."""
    small = {**SMALL, **{k: FACES_TRAIN[k] for k in (
        "base_learning_rate", "scheduler_config", "accumulate_grad_batches",
        "batch_size")}}
    monkeypatch.setattr(train_steps, "FACES_TRAIN", small)
    monkeypatch.setattr(synthetic_faces, "TRAIN_GRID", (2, 1, 1, 2, 1, 1, 1))
    flash = []  # the UNet's top level (3 sites) and the VQ mid block

    def record(q, k, v, scale, _fn=tattn.flash_attention):
        flash.append(tuple(q.shape))
        return _fn(q, k, v, scale)
    monkeypatch.setattr(tattn, "flash_attention", record)
    out = tmp_path / "faces.npz"
    train_steps.main(["--config", "faces", "--steps", "2", "--accumulate",
                      "2", "--batch_size", "2", "--device", "cpu",
                      "--out", str(out)])
    printed = capsys.readouterr().out
    assert "fresh init from seed 23" in printed and "accumulate 2" in printed
    lines = [ln for ln in printed.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["1", "2"]
    for ln in lines:
        values = [float(v) for v in ln.split()[3::2]]
        assert np.isfinite(values).all(), ln
        # the LR rule: accumulate x batch x base_lr, at the warmup's start
        assert values[-1] == pytest.approx(2 * 2 * 2e-6 * 1e-6, rel=1e-6)
    assert sorted(set(flash)) == [(2, 1, 1024, 128), (2, 4, 1024, 8)]
    assert len(flash) == 2 * 4
    tree = load_compact(str(out))
    assert int(tree["state"]["step"]) == 2
    assert "ema" in tree["state"]
    model = LatentDiffusion.from_checkpoint(str(out), device="cpu",
                                            config=small)
    assert model.scale_factor != 1.0  # set by scale_by_std at step 0
    eps = model.apply_model(np.zeros((1, 32, 32, 3), np.float32), [500],
                            np.zeros((1, 320), np.float32))
    assert eps.shape == (1, 32, 32, 3) and torch.isfinite(eps).all()
