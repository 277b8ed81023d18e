"""The faces serving CLIs and the swap's chunks on the CPU (split from
``test_torch_port_faces_serve.py``):

- at eta 1 with x_T and the per-step noises injected, DDIM chunks of 16,
  16 and 8 give what one chunk of 40 gives (1e-5);
- the ``generate_swap --config faces`` and ``fid`` CLIs from a fresh init
  at a small width (``CLI_FACES``) on a 4-image grid.
"""

import json

import numpy as np
import torch

from encdiff_tpu_torch import fid as fid_cli
from encdiff_tpu_torch import generate_swap
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.evalx.swap import swap_sample
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from test_torch_port_faces_serve import CLI_FACES, _randn
from torch_threads import one_thread  # noqa: F401


def test_swap_chunks_slice_injected_noise(monkeypatch):
    """At eta 1 with x_T and the per-step noises injected, 40 samples in
    DDIM chunks of 16, 16 and 8 give what one chunk of 40 gives: each chunk
    takes its own slice of both."""
    from encdiff_tpu_torch.evalx import swap as tswap
    tiny = {**CLI_FACES, "image_size": 16,
            "unet_config": {**CLI_FACES["unet_config"], "image_size": 16},
            "first_stage_config": {
                **CLI_FACES["first_stage_config"],
                "ddconfig": {**CLI_FACES["first_stage_config"]["ddconfig"],
                             "resolution": 64}}}
    model = LatentDiffusion(tiny, device="cpu")
    model.init_parameters(torch.Generator().manual_seed(50))
    with torch.no_grad():  # no zero output convolution: ε is not 0
        gen = torch.Generator().manual_seed(51)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    images = np.tanh(_randn(52, 2, 64, 64, 3))
    x_T = _randn(53, 40, 16, 16, 3)
    noises = _randn(54, 2, 40, 16, 16, 3)
    calls = []
    sample = model.sample_ddim

    def record(tokens, **kw):
        calls.append(len(tokens))
        return sample(tokens, **kw)
    monkeypatch.setattr(model, "sample_ddim", record)
    whole = swap_sample(model, images, ddim_steps=2, eta=1.0, x_T=x_T,
                        noises=noises)
    monkeypatch.setattr(tswap, "TOKEN_BUDGET", 16 * 16 * 16)
    chunked = swap_sample(model, images, ddim_steps=2, eta=1.0, x_T=x_T,
                          noises=noises)
    assert calls == [40, 16, 16, 8]
    assert chunked.shape == (40, 64, 64, 3)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_faces_serving_clis_at_a_small_width(tmp_path, capsys, monkeypatch):
    """``generate_swap --config faces`` and ``fid`` from a fresh init on
    the CPU, on a faces-shaped config at a small width and a 4-image grid
    (the swap's inputs are drawn from ``TRAIN_GRID``, the FID's real images
    from the face grid of ``SyntheticFaces``)."""
    monkeypatch.setitem(generate_swap.CONFIGS, "faces", CLI_FACES)
    monkeypatch.setattr(synthetic_faces, "TRAIN_GRID", (2, 1, 1, 2, 1, 1, 1))
    monkeypatch.setattr(synthetic_faces.SyntheticFaces, "factor_sizes",
                        (2, 1, 1, 2, 1, 1, 1))
    generate_swap.main(["--config", "faces", "--num_samples", "2",
                        "--ddim_steps", "2", "--device", "cpu",
                        "--out", str(tmp_path)])
    grid = np.load(tmp_path / "swap_full_grid.npy")
    assert grid.shape == (42, 128, 128, 3)
    assert np.isfinite(grid).all()
    corr = json.loads((tmp_path / "factor_correspondence.json").read_text())
    assert len(corr) == 20

    out = tmp_path / "fid.json"
    result = fid_cli.main(["--config", "faces", "--num", "4",
                           "--batch_size", "2", "--ddim_steps", "2",
                           "--device", "cpu", "--out", str(out)])
    assert result["mode"] == "random_features"
    assert result["calibrated"] is False and result["num"] == 4
    assert np.isfinite(result["fid"])
    assert json.loads(out.read_text()) == result
    assert "uncalibrated" in capsys.readouterr().out
