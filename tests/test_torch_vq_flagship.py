"""One VQ-GAN step at full flagship width, port against JAX, on the CPU.

The flagship's VQ-GAN config (``configs/demo/synthetic-shapes-v4-full-vq.yaml``:
ch 32, ch_mult (1, 2, 4), two res blocks, 2,048 codes, 64 px, the
full-width PatchGAN and LPIPS) from ``demo_artifacts/round5/v4vq_fp16.npz``:
the generator, the discriminator with its batch statistics and the LPIPS
trunk and heads all read from the file, fresh Adam states at LR 1e-3, one
step at B = 2 on two images of the v4 renderer, at the tolerances and with
the rounding-zero rule of ``test_torch_vq_step.py``: the logs to 1e-5
relative, every leaf, Adam moment and batch statistic to 1e-4 relative L2.
"""

import pathlib

import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu_torch.configs import FLAGSHIP_VQ_RUN
from encdiff_tpu_torch.core.compact_ckpt import load_compact
from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
from test_torch_vq_step import (check_leaves, compare_logs, jax_state,
                                port_from_jax, run_both, unmoved)
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
VQ_NPZ = ROOT / "demo_artifacts/round5/v4vq_fp16.npz"
VQ_YAML = ROOT / "configs/demo/synthetic-shapes-v4-full-vq.yaml"


@pytest.fixture(scope="module")
def flagship_step():
    with open(VQ_YAML) as f:
        ref = yaml.safe_load(f)["model"]
    jmodel = instantiate_from_config(ref)
    tree = load_compact(str(VQ_NPZ))["state"]
    state, gen_tx, disc_tx = jax_state(
        jmodel, tree["gen_params"], tree["disc_params"],
        tree["disc_batch_stats"], tree["loss_vars"]["lpips"]["params"],
        step=int(tree["step"]))
    params = FLAGSHIP_VQ_RUN["model"]["params"]
    model, pstate = port_from_jax(params["ddconfig"], params["n_embed"],
                                  state)
    grid = render_all_v4(64, factor_sizes=(2, 2, 2, 2, 2, 2))
    batch = grid[np.random.RandomState(0).choice(len(grid), 2, replace=False)]
    (step,), _ = run_both(jmodel, state, gen_tx, disc_tx, model, pstate,
                          [batch])
    return step


def test_flagship_step_logs_match_jax(flagship_step):
    log, jlog = flagship_step[:2]
    compare_logs(log, jlog)
    assert 0.0 < log["train/d_weight"].item() < 0.75 * 1e4


def test_flagship_step_leaves_match_jax(flagship_step):
    port, want, before = flagship_step[2:]
    check_leaves(port, want, before)
    assert unmoved(port, before, "generator") == []


def test_flagship_saturated_discriminator_stays(flagship_step):
    """The trained discriminator separates this batch beyond the hinge's
    margin (real logits above 1, fakes below -1): its loss and gradient are
    0, so Adam leaves its parameters exactly as they were on both sides,
    and only its batch statistics move."""
    log, jlog, port, want, before = flagship_step
    assert float(jlog["train/disc_loss"]) == log["train/disc_loss"].item() == 0
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k, v in before["discriminator"].items():
        if not k.endswith(stats):
            assert torch.equal(port["discriminator"][k], v), k
            assert torch.equal(want["discriminator"][k], v), k
    assert sorted(unmoved(port, before, "discriminator")) == sorted(
        k for k in before["discriminator"] if not k.endswith(stats))


def test_flagship_port_config_reads_the_file(flagship_step):
    """The port's model of ``FLAGSHIP_VQ_RUN`` took every leaf of the file:
    its generator has the published size."""
    port = flagship_step[2]
    n_gen = sum(v.numel() for v in port["generator"].values())
    n_disc = sum(v.numel() for k, v in port["discriminator"].items()
                 if not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked")))
    assert (n_gen, n_disc) == (3478078, 2765633)
