"""The port's VQ-GAN train step held against the JAX
``vq_trainer.build_vq_train_step``, on the CPU.

At a narrow width (VQ ch 32, ch_mult (1, 2), one res block, 64 codes,
32 px, B = 2), both packages start from the same weights: the generator and
the discriminator drawn from a numpy seed (``_seeded``), the JAX
random-features LPIPS variables, fresh Adam states at LR 1e-3 so that an
update shows against the tolerance. They take a step on a uint8 batch from
global step 0; then the port takes the JAX state after it across (weights,
batch statistics, both Adam states and counts: ``convert.vq_state_dicts``,
``vq_trainer.load_adam``) and both take a second step on another batch.
After each step every logged value is held to ``LOG_REL`` (1e-5 relative),
and every generator and discriminator leaf, Adam moment and batch
statistic to ``LEAF_REL`` (1e-4 relative L2). The eval step's metrics on
the JAX state after the second step, carried across, are held to
``LOG_REL`` too. From the same start, both take the two batches as micro-
batches of a 2-way accumulation (``optax.MultiSteps`` against
``train.loop.accumulate_grads``): the logs of each, no weight moved after
the first, and the leaves after the second, at the same tolerances. A last
test holds the generator pass away from the discriminator: no gradient,
no update and no batch-statistic move reaches it before its own pass.

Adam's first step on an element is ±lr whatever the size of its gradient,
so an element whose gradient is zero up to rounding (a bias that feeds only
GroupNorms of one channel a group, the attention's key bias, a code no
latent picks) moves by a rounding-noise sign: such elements (below 1e-3 of
their leaf's RMS gradient), and whole leaves below 1e-6 of the global
gradient norm, are held to move by at most 2·lr on both sides instead
(``_split``). That is also why the second step starts from one state: the
sign noise of the first would move the second step's logs by about 1e-3
(the adaptive weight is a ratio of two gradient norms).

``test_torch_vq_flagship.py`` runs the same comparison at full flagship
width from ``v4vq_fp16.npz``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.losses import lpips as jlpips
from encdiff_tpu.models.autoencoder import VQModel as JVQModel
from encdiff_tpu.train import vq_trainer as jvq
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.models.autoencoder import VQModel
from encdiff_tpu_torch.train import vq_trainer

LOG_REL = 1e-5
LEAF_REL = 1e-4
LR = 1e-3
B = 2
DD = dict(double_z=False, z_channels=3, resolution=32, in_channels=3,
          out_ch=3, ch=32, ch_mult=[1, 2], num_res_blocks=1,
          attn_resolutions=[], dropout=0.0)
LOSS = dict(disc_conditional=False, disc_in_channels=3, disc_start=0,
            disc_weight=0.75, codebook_weight=1.0, perceptual_weight=1.0)


def _seeded(shapes, seed):
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
        if path[-1] == "embedding":
            return 0.3 * noise
        return 0.1 * noise
    return walk(shapes)


def jax_state(jmodel, gen, disc, stats, lpips_params, step=0, accumulate=1):
    """A JAX ``VQTrainState`` of the given numpy trees, fresh Adam states."""
    gen_tx, disc_tx = jvq.make_optimizers(LR, lr_g_factor=jmodel.lr_g_factor,
                                          accumulate=accumulate)
    state = jvq.VQTrainState(
        step=jnp.asarray(step, jnp.int32), gen_params=gen, disc_params=disc,
        disc_batch_stats=stats, loss_vars={"lpips": {"params": lpips_params}},
        gen_opt=gen_tx.init(gen), disc_opt=disc_tx.init(disc))
    return state, gen_tx, disc_tx


def port_from_jax(ddconfig, n_embed, state, accumulate=1):
    """A port ``VQModel`` with its loss, holding ``state``'s weights, and a
    fresh ``VQTrainState`` at the same step."""
    model = VQModel(ddconfig, lossconfig={
        "target": "encdiff_tpu_torch.losses.gan.VQLPIPSWithDiscriminator",
        "params": LOSS}, n_embed=n_embed, embed_dim=3)
    model.load_vq_state(convert.vq_state_dicts(jax.tree.map(np.asarray,
                                                            state)))
    return model, vq_trainer.create_vq_train_state(
        model, LR, accumulate=accumulate, step=int(state.step))


def carry(model, pstate, jstate):
    """Load the JAX state ``jstate`` (weights, batch statistics, both Adam
    states and the step) into the port's model and state."""
    sds = convert.vq_state_dicts(jax.tree.map(np.asarray, jstate))
    model.load_vq_state(sds)
    for name, opt, params in (
            ("gen_opt", pstate.gen_opt, model.generator_parameters()),
            ("disc_opt", pstate.disc_opt,
             dict(model.loss.discriminator.named_parameters()))):
        vq_trainer.load_adam(opt, params, *sds[name])
    pstate.step = sds["step"]


def port_leaves(model, state) -> dict:
    """The port's state on the names ``convert.vq_state_dicts`` gives."""
    gen = model.generator_parameters()
    disc = dict(model.loss.discriminator.named_parameters())
    out = {"generator": {k: p.detach().clone() for k, p in gen.items()},
           "discriminator": {k: v.clone() for k, v in
                             model.loss.discriminator.state_dict().items()}}
    for name, opt, params in (("gen_opt", state.gen_opt, gen),
                              ("disc_opt", state.disc_opt, disc)):
        def moment(p, m, opt=opt):
            return (opt.state[p][m].clone() if opt.state[p]
                    else torch.zeros_like(p.detach()))
        out[name] = (vq_trainer.optimizer_count(opt),
                     {k: moment(p, "exp_avg") for k, p in params.items()},
                     {k: moment(p, "exp_avg_sq") for k, p in params.items()})
    return out


def _split(mu: dict):
    """(leaves whose gradient is zero up to rounding, {leaf: mask of the
    elements whose gradient is above rounding}), from Adam's first moment
    after one step (0.5 of the gradient)."""
    total = np.sqrt(sum(np.sum(np.square(v.numpy(), dtype=np.float64))
                        for v in mu.values()))
    zero, masks = set(), {}
    for k, v in mu.items():
        g = v.numpy()
        if np.linalg.norm(g) <= 1e-6 * total:
            zero.add(k)
        else:
            masks[k] = np.abs(g) >= 1e-3 * np.sqrt(np.mean(np.square(g)))
    return zero, masks, total


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def compare(port, want, before, split, rel=LEAF_REL):
    """Every leaf of ``port`` against ``want`` (both ``port_leaves``-shaped;
    ``before`` the weights before the first step), to ``rel`` relative L2.
    Returns the faults."""
    faults = []
    for part, opt in (("generator", "gen_opt"), ("discriminator", "disc_opt")):
        zero, masks, total = split[part]
        pc, pmu, pnu = port[opt]
        wc, wmu, wnu = want[opt]
        if pc != wc:
            faults.append(f"{opt} count {pc} vs {wc}")
        for k, w in want[part].items():
            got = port[part][k].numpy()
            w = w.numpy()
            if k.endswith(("running_mean", "running_var")) or (
                    k not in zero and masks[k].all()):
                if _rel(got, w) > rel:
                    faults.append(f"{part} {k}: {_rel(got, w):.3e}")
                continue
            free = (np.ones_like(w, bool) if k in zero else ~masks[k])
            moved = 2 * LR
            b = before[part][k].numpy()
            if np.abs(got - b)[free].max() > moved or \
                    np.abs(w - b)[free].max() > moved:
                faults.append(f"{part} {k}: rounding-zero elements moved "
                              "more than 2 lr a step")
            if k not in zero and _rel(got[~free], w[~free]) > rel:
                faults.append(f"{part} {k}: {_rel(got[~free], w[~free]):.3e}")
        for i, (name, got_m, want_m) in enumerate((("mu", pmu, wmu),
                                                   ("nu", pnu, wnu))):
            for k, w in want_m.items():
                # a zero-gradient leaf's moment is rounding noise unless an
                # earlier step left a real one there, which carries over
                bound = (1e-6 * total) ** (1 + i)
                if k in zero and before[opt][1 + i][k].abs().max() <= bound:
                    if max(w.abs().max(), got_m[k].abs().max()) > bound:
                        faults.append(f"{opt} {name} {k}: zero-gradient "
                                      "leaf above rounding")
                elif _rel(got_m[k].numpy(), w.numpy()) > rel:
                    faults.append(f"{opt} {name} {k}: "
                                  f"{_rel(got_m[k].numpy(), w.numpy()):.3e}")
    return faults


def compare_logs(port, want, rtol=LOG_REL):
    assert set(port) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(port[k].item(), float(v), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def run_both(jmodel, state, gen_tx, disc_tx, model, pstate, batches):
    """The JAX and the port steps on each batch, the port carrying the JAX
    state across before each step but the first; per step (port logs, JAX
    logs, port leaves, JAX leaves, leaves before the step), and the last
    JAX state."""
    step = jvq.build_vq_train_step(jmodel, jmodel.loss, gen_tx, disc_tx,
                                   donate=False)
    out = []
    for i, batch in enumerate(batches):
        if i:
            carry(model, pstate, state)
        before = port_leaves(model, pstate)
        state, jlog = step(state, batch)
        log = vq_trainer.train_step(model, pstate, torch.from_numpy(batch))
        want = convert.vq_state_dicts(jax.tree.map(np.asarray, state))
        out.append((log, jlog, port_leaves(model, pstate), want, before))
    return out, state


@pytest.fixture(scope="module")
def narrow():
    jmodel = JVQModel(ddconfig=DD, n_embed=64, embed_dim=3,
                      lossconfig={"target": "encdiff_tpu.losses.gan."
                                            "VQLPIPSWithDiscriminator",
                                  "params": LOSS})
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    gen_shapes = jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                                x)["params"]
    disc_shapes = jax.eval_shape(lambda: jmodel.loss.discriminator.init(
        jax.random.PRNGKey(0), x, train=False))
    zeros = lambda t: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(t))
    gen = _seeded(zeros(gen_shapes), 0)
    dvars = _seeded(zeros(disc_shapes), 1)
    lpips = jlpips.calibrate_random_features(jax.jit(
        jlpips.LPIPSModule().init)(jax.random.PRNGKey(1830), x, x))
    state, gen_tx, disc_tx = jax_state(
        jmodel, gen, dvars["params"], dvars["batch_stats"],
        jax.tree.map(np.asarray, lpips["params"]))
    model, pstate = port_from_jax(DD, 64, state)
    rs = np.random.RandomState(2)
    batches = [rs.randint(0, 256, (B, 32, 32, 3), dtype=np.uint8)
               for _ in range(2)]
    steps, jstate = run_both(jmodel, state, gen_tx, disc_tx, model, pstate,
                             batches)
    jeval = jvq.build_vq_eval_step(jmodel, jmodel.loss)(jstate, batches[0])
    carry(model, pstate, jstate)
    peval = vq_trainer.eval_step(model, pstate, torch.from_numpy(batches[0]))

    # 2-way accumulation from the same start: optax.MultiSteps against
    # train.loop.accumulate_grads; the first micro-step updates no weight
    # (only the batch statistics), so the second needs no carry
    state, gen_tx, disc_tx = jax_state(
        jmodel, gen, dvars["params"], dvars["batch_stats"],
        jax.tree.map(np.asarray, lpips["params"]), accumulate=2)
    model, pstate = port_from_jax(DD, 64, state, accumulate=2)
    before = port_leaves(model, pstate)
    step = jvq.build_vq_train_step(jmodel, jmodel.loss, gen_tx, disc_tx,
                                   donate=False)
    logs = []
    for batch in batches:
        state, jlog = step(state, batch)
        logs.append((vq_trainer.train_step(model, pstate,
                                           torch.from_numpy(batch)), jlog))
        if not logs[1:]:
            first = port_leaves(model, pstate)
    accumulated = (logs, first, port_leaves(model, pstate),
                   convert.vq_state_dicts(jax.tree.map(np.asarray, state)),
                   before)
    return steps, peval, jeval, accumulated


@pytest.mark.parametrize("step", [0, 1])
def test_logs_match_jax(narrow, step):
    log, jlog, _, _, _ = narrow[0][step]
    compare_logs(log, jlog)
    assert 0.0 < log["train/d_weight"].item() < 0.75 * 1e4


@pytest.mark.parametrize("step", [0, 1])
def test_leaves_moments_and_statistics_match_jax(narrow, step):
    port, want, before = narrow[0][step][2:]
    check_leaves(port, want, before)
    # every generator and discriminator leaf and statistic has moved
    assert unmoved(port, before, "generator") == []
    assert unmoved(port, before, "discriminator") == []


def check_leaves(port, want, before, rel=LEAF_REL):
    """``compare`` with the split of this step's gradients, which Adam's
    first moments give: mu' = 0.5 mu + 0.5 g, so g = 2 mu' - mu."""
    split = {}
    for part, opt in (("generator", "gen_opt"), ("discriminator", "disc_opt")):
        grads = {k: 2.0 * v - before[opt][1][k]
                 for k, v in want[opt][1].items()}
        split[part] = _split(grads)
    assert compare(port, want, before, split, rel) == []


def unmoved(port, before, part) -> list:
    """The leaves of ``part`` that the step left as they were."""
    return [k for k, v in port[part].items() if torch.equal(v, before[part][k])
            and not k.endswith("num_batches_tracked")]


def test_eval_step_matches_jax(narrow):
    _, peval, jeval, _ = narrow
    compare_logs(peval, jeval)


@pytest.mark.parametrize("micro", [0, 1])
def test_accumulation_logs_match_jax(narrow, micro):
    port, jax_log = narrow[3][0][micro]
    compare_logs(port, jax_log)


def test_accumulation_updates_on_the_second_micro_step(narrow):
    _, first, port, want, before = narrow[3]
    # the first micro-step moved the batch statistics and no weight
    for part in ("generator", "discriminator"):
        for k, v in first[part].items():
            if not k.endswith(("running_mean", "running_var")):
                assert torch.equal(v, before[part][k]), k
    assert first["gen_opt"][0] == first["disc_opt"][0] == 0
    # the second moved them with the mean of both gradients: one Adam count
    check_leaves(port, want, before)
    assert unmoved(port, before, "generator") == []


def test_generator_pass_leaves_the_discriminator_alone():
    """The generator's loss scores the fakes through the discriminator,
    but no gradient of it reaches the discriminator's parameters and its
    update touches none of them; its train-mode BatchNorms leave their
    running statistics as they are. Only the discriminator pass moves them
    (twice: real, then fake)."""
    model = VQModel(DD, lossconfig={
        "target": "encdiff_tpu_torch.losses.gan.VQLPIPSWithDiscriminator",
        "params": LOSS}, n_embed=64, embed_dim=3)
    model.init_parameters(torch.Generator().manual_seed(0))
    state = vq_trainer.create_vq_train_state(model, LR)
    disc = model.loss.discriminator
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    seen = {}
    d_loss = model.loss.discriminator_loss

    def at_disc_pass(*args, **kwargs):
        seen["grads"] = [p.grad for p in disc.parameters()]
        seen["state"] = {k: v.clone() for k, v in disc.state_dict().items()}
        return d_loss(*args, **kwargs)

    model.loss.discriminator_loss = at_disc_pass
    batch = np.random.RandomState(3).randint(0, 256, (B, 32, 32, 3),
                                             dtype=np.uint8)
    vq_trainer.train_step(model, state, torch.from_numpy(batch))
    assert all(g is None for g in seen["grads"])
    assert all(torch.equal(v, before[k]) for k, v in seen["state"].items())
    moved = {k for k, v in disc.state_dict().items()
             if not torch.equal(v, before[k])}
    # the discriminator's own update moves each parameter its loss has a
    # gradient for (the hinge gives the last bias none while every logit is
    # inside the margin), and both passes' statistics
    stats = {f"bn{n}.{s}" for n in (1, 2, 3)
             for s in ("running_mean", "running_var")}
    with_grad = {k for k, p in disc.named_parameters() if p.grad.any()}
    assert moved == with_grad | stats
    assert len(with_grad) >= len(list(disc.parameters())) - 1
