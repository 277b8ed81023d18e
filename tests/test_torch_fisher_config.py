"""``fisher_sm`` through the harness, on the CPU.

- ``-b flagship_mcl model.params.mcl_type=fisher_sm
  model.params.lambda_mcl=0.01`` (the command of the ``fisher`` configs
  under ``configs/mcl/``, as ``scripts/run_mcl_sweep.py`` passes each
  cell's type) reaches the model: ``LatentDiffusion.mcl_type`` and
  ``lambda_mcl``.
- A tiny harness run of ``fisher_sm`` with ``--accumulate_grad_batches 2``
  (the sweep's prescription for the double-grad types where B does not
  fit): ``run_metadata.json`` logs the type, λ and the accumulation; the LR
  is accumulate x B x base LR; the parameters move on every 2nd micro-step
  alone, and the LR follows AdamW's own count; the EMA stands still until
  the first update and moves on every micro-step from it (the MultiSteps
  rules).
"""

import json
import pathlib

import numpy as np
import torch

from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train import harness
from test_torch_harness import TINY, _write, tiny  # noqa: F401
from test_torch_mcl_config import MCL_TINY_PARAMS
from torch_threads import one_thread  # noqa: F401

OVERRIDES = ["model.params.mcl_type=fisher_sm", "model.params.lambda_mcl=0.01"]


def test_dotlist_reaches_the_model():
    cfg = harness.load_configs(["flagship_mcl"], OVERRIDES)
    params = cfg["model"]["params"]
    assert params["mcl_type"] == "fisher_sm" and params["lambda_mcl"] == 0.01
    model = LatentDiffusion(params, device="cpu")
    assert model.use_mcl and model.mcl_type == "fisher_sm"
    assert model.lambda_mcl == 0.01


def test_tiny_fisher_run_with_accumulation(tiny, monkeypatch):
    cfg = json.loads(json.dumps(TINY))
    cfg["model"]["params"].update(MCL_TINY_PARAMS)
    step_fn, seen = harness.train_step, []

    def watched(model, state, batch, **kwargs):
        unet = {k: p.detach().clone() for k, p in model.unet.named_parameters()}
        ema = {k: v.clone() for k, v in state.ema.params.items()}
        out = step_fn(model, state, batch, **kwargs)
        seen.append(dict(
            moved=any(not torch.equal(p, unet[k])
                      for k, p in model.unet.named_parameters()),
            ema_moved=any(not torch.equal(v, ema[k])
                          for k, v in state.ema.params.items()),
            lr=float(out["lr"]), updates=state.updates,
            loss_mcl=float(out["train/loss_mcl"])))
        return out
    monkeypatch.setattr(harness, "train_step", watched)
    trainer = harness.main(["-b", _write(tiny, cfg), "-t", "--max_steps", "4",
                            "--accumulate_grad_batches", "2", "--no-test",
                            "-l", str(tiny / "logs"), "--device", "cpu",
                            *OVERRIDES])
    assert trainer.model.mcl_type == "fisher_sm"
    meta = json.loads((pathlib.Path(trainer.logdir)
                       / "run_metadata.json").read_text())
    assert meta["mcl_type"] == "fisher_sm" and meta["lambda_mcl"] == 0.01
    assert meta["accumulate_grad_batches"] == 2
    assert trainer.learning_rate == 2 * trainer.batch_size * 1e-4
    assert [s["moved"] for s in seen] == [False, True, False, True]
    assert [s["ema_moved"] for s in seen] == [False, True, True, True]
    assert [s["updates"] for s in seen] == [0, 1, 1, 2]
    lr_fn = trainer.state.lr_fn
    assert [s["lr"] for s in seen] == [float(lr_fn(n)) for n in (0, 0, 1, 1)]
    assert all(np.isfinite(s["loss_mcl"]) for s in seen)
