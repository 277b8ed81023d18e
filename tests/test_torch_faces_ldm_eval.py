"""The faces eval chain (``scripts/round3_faces_eval.sh``) on the CPU,
against the JAX package.

- TAD: ``tad_score``, ``aurocs_all`` and ``attribute_mi_matrix`` against
  ``encdiff_tpu/evalx/tad.py`` on seeded codes and attributes, the faces'
  18 attributes among them (1e-6).
- The eval file: ``face_attributes`` equal to the JAX function's, and
  ``write_eval_npz`` against the JAX one at 64 faces of 16 px: the same
  members, dtypes, shapes and bytes. 16 px keeps the whole grid, which both
  draw from, at 26 MB; the grid is never composed at 256 px here.
- FID: the real images' rows are ``RandomState(0).choice(34560, num)``, the
  script's, and at 16 px they equal the JAX renderer's at those rows.
- ``-r <harness checkpoint directory>`` in ``generate_swap``, ``fid`` and
  ``tad`` at a small width (32 px faces on 16x16 latents, a 16-face grid):
  each loads the directory's ``model.npz``; ``tad`` scores what
  ``tad_score`` gives on Encoder4's codes of the file's images, scalars and
  warped tokens.
- ``faces_eval`` on that directory runs the chain: the eval file, ``tad``,
  ``fid`` and ``generate_swap`` (at 2 DDIM steps) with its ``--tad_num``
  and ``--fid_num``, and writes each step's wall.
"""

import json
import os

import numpy as np
import pytest
import torch

from encdiff_tpu.data import synthetic_faces as jfaces
from encdiff_tpu.evalx import tad as jtad
from encdiff_tpu_torch import faces_eval
from encdiff_tpu_torch import fid as fid_cli
from encdiff_tpu_torch import generate_swap
from encdiff_tpu_torch import tad as tad_cli
from encdiff_tpu_torch.configs import FACES_TRAIN
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.evalx import tad
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train.checkpoint_io import (fresh_variables,
                                                   save_train_checkpoint)
from encdiff_tpu_torch.train.loop import create_train_state
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
GRID = (2, 1, 2, 1, 2, 1, 2)  # 16 faces
#: faces-shaped at a small width: 32 px faces on 16x16x3 latents
SMALL = {
    **FACES_TRAIN, "image_size": 16,
    "unet_config": {**FACES_TRAIN["unet_config"], "image_size": 16,
                    "model_channels": 32, "channel_mult": [1, 2],
                    "num_res_blocks": 1, "attention_resolutions": [1, 2],
                    "num_heads": 4},
    "first_stage_config": {
        **FACES_TRAIN["first_stage_config"], "n_embed": 64,
        "ddconfig": {**FACES_TRAIN["first_stage_config"]["ddconfig"],
                     "resolution": 32, "ch_mult": [1, 2],
                     "num_res_blocks": 1}},
    "cond_stage_config": {"d": 32, "context_dim": 16, "latent_unit": 20},
}


def _codes_and_attributes(seed, n=600, d=20):
    """Seeded codes, two of them near-constant (below TAD's range floor),
    and the faces' attributes of ``n`` grid rows, three of them tied to
    codes."""
    rs = np.random.RandomState(seed)
    z = rs.randn(n, d).astype(np.float32)
    z[:, 3] *= 0.01
    z[:, 7] = 0.05
    rows = rs.choice(synthetic_faces.N_FACES, n, replace=False)
    targ = synthetic_faces.face_attributes()[rows]
    for a, lat in ((2, 0), (9, 5), (15, 11)):
        z[:, lat] += 2.0 * targ[:, a]
    return z, targ


@pytest.mark.parametrize("seed,d", [(3, 20), (4, 320)])
def test_tad_matches_jax(seed, d):
    z, targ = _codes_and_attributes(seed, d=d)
    np.testing.assert_allclose(tad.aurocs_all(z, targ),
                               np.asarray(jtad.aurocs_all(z, targ)), **TOL)
    np.testing.assert_allclose(tad.attribute_mi_matrix(targ),
                               np.asarray(jtad.attribute_mi_matrix(targ)),
                               **TOL)
    got, want = tad.tad_score(z, targ), jtad.tad_score(z, targ)
    assert set(got) == set(want)
    assert got["attributes_captured"] == want["attributes_captured"] >= 3
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), **TOL)


def test_eval_npz_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ENCDIFF_DATA_CACHE", str(tmp_path / "cache"))
    np.testing.assert_array_equal(synthetic_faces.face_attributes(),
                                  jfaces.face_attributes())
    assert synthetic_faces.FACE_ATTR_NAMES == jfaces.FACE_ATTR_NAMES
    port = synthetic_faces.write_eval_npz(str(tmp_path / "port.npz"),
                                          image_size=16, num=64, seed=5)
    ref = jfaces.write_eval_npz(str(tmp_path / "jax.npz"), image_size=16,
                                num=64, seed=5)
    with np.load(port) as a, np.load(ref) as b:
        assert a.files == b.files == ["data", "targ", "attr_names"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        assert a["data"].shape == (64, 16, 16, 3)


def test_fid_draws_the_scripts_rows_of_the_full_grid(monkeypatch):
    num = 48
    want = np.random.RandomState(0).choice(34560, size=num, replace=False)
    np.testing.assert_array_equal(fid_cli.real_indices(num, 34560), want)
    small = {**generate_swap.CONFIGS["faces"], "first_stage_config": {
        **generate_swap.CONFIGS["faces"]["first_stage_config"],
        "ddconfig": {**generate_swap.CONFIGS["faces"]["first_stage_config"]
                     ["ddconfig"], "resolution": 16}}}
    monkeypatch.setitem(generate_swap.CONFIGS, "faces", small)
    real = fid_cli.real_images(num, "faces", device="cpu")
    assert real.shape == (num, 16, 16, 3) and real.dtype == np.uint8
    grid = jfaces.render_faces(16)
    assert len(grid) == 34560
    np.testing.assert_array_equal(real[:6], grid[want[:6]])
    np.testing.assert_array_equal(real[-2:], grid[want[-2:]])


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """A harness checkpoint directory of ``SMALL`` from a seeded init with
    every trainable leaf moved off it (a fresh init's zero output
    convolutions would make every sample the same)."""
    model = LatentDiffusion(SMALL, device="cpu")
    model.init_parameters(torch.Generator().manual_seed(61))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(62)
        for p in [*model.unet.parameters(),
                  *model.cond_stage_model.parameters()]:
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    state = create_train_state(model, SMALL)
    path = str(tmp_path_factory.mktemp("ckpt") / "last")
    save_train_checkpoint(path, model, state, fresh_variables(model))
    return path


@pytest.fixture
def small_faces(monkeypatch):
    monkeypatch.setitem(generate_swap.CONFIGS, "faces", SMALL)
    monkeypatch.setattr(synthetic_faces, "TRAIN_GRID", GRID)
    monkeypatch.setattr(synthetic_faces.SyntheticFaces, "factor_sizes", GRID)


def test_clis_take_a_checkpoint_directory(checkpoint_dir, small_faces,
                                          tmp_path, monkeypatch):
    model = generate_swap.load_model("faces", checkpoint_dir, 0, "cpu")
    ref = LatentDiffusion.from_checkpoint(
        os.path.join(checkpoint_dir, "model.npz"), device="cpu",
        config=SMALL)
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        assert torch.equal(a, b), k

    generate_swap.main(["--config", "faces", "-r", checkpoint_dir,
                        "--num_samples", "2", "--ddim_steps", "2",
                        "--device", "cpu", "--out", str(tmp_path / "swap")])
    grid = np.load(tmp_path / "swap" / "swap_full_grid.npy")
    assert grid.shape == (42, 32, 32, 3) and np.isfinite(grid).all()

    # the Fréchet distance of 2,048 features (12 s of scipy's sqrtm here)
    # is held in test_faces_serving_clis_at_a_small_width and against JAX
    # in test_torch_port_faces_fid; here a recorder takes what the CLI
    # hands it
    fed = []
    monkeypatch.setattr(fid_cli.fid_lib, "compute_fid",
                        lambda net, real, gen, **kw: fed.append(
                            (real, gen)) or 1.0)
    result = fid_cli.main(["--config", "faces", "-r", checkpoint_dir,
                           "--num", "4", "--batch_size", "2",
                           "--ddim_steps", "2", "--device", "cpu"])
    assert result["num"] == 4 and result["fid"] == 1.0
    (real, gen), = fed
    images = synthetic_faces.SyntheticFaces(32).images
    rows = fid_cli.real_indices(4, len(images))
    np.testing.assert_array_equal(
        real, images[rows].astype(np.float32) / 255.0)
    assert gen.shape == (4, 32, 32, 3) and np.isfinite(gen).all()

    npz = synthetic_faces.write_eval_npz(str(tmp_path / "eval.npz"),
                                         image_size=32, num=12, seed=1)
    with np.load(npz) as f:
        data, targ = f["data"], f["targ"]
    for tokens in (False, True):
        out = str(tmp_path / f"tad_{tokens}.json")
        got = tad_cli.main(["--config", "faces", "-r", checkpoint_dir,
                            "--eval_npz", npz, "--batch_size", "5",
                            "--device", "cpu", "--out", out]
                           + (["--use_tokens"] if tokens else []))
        x = torch.from_numpy(data).float() / 127.5 - 1.0
        z = ref.cond_encoding(x)
        if tokens:
            z = ref.cond_warp(z).reshape(len(z), -1)
        want = tad.tad_score(z.numpy(), targ)
        assert got["tad_score"] == pytest.approx(want["tad_score"],
                                                 abs=1e-6)
        with open(out) as f:
            assert json.load(f) == {
                "TAD SCORE: ": got["tad_score"],
                "Attributes Captured: ": got["attributes_captured"]}


def test_faces_eval_runs_the_chain(checkpoint_dir, small_faces, tmp_path,
                                   monkeypatch):
    monkeypatch.setattr(fid_cli.fid_lib, "compute_fid",
                        lambda net, real, gen, **kw: 1.0)
    monkeypatch.setattr(faces_eval, "DDIM_STEPS", 2)
    out = tmp_path / "eval"
    result = faces_eval.main(["-r", checkpoint_dir, "--out", str(out),
                              "--tad_num", "12", "--fid_num", "4",
                              "--device", "cpu"])
    assert sorted(result["walls_s"]) == ["eval_npz", "fid", "swap", "tad"]
    assert all(w > 0 for w in result["walls_s"].values())
    with open(out / "walls.json") as f:
        assert json.load(f) == result

    want = synthetic_faces.write_eval_npz(str(tmp_path / "want.npz"),
                                          image_size=32, num=12)
    with np.load(out / "test_faces.npz") as got, np.load(want) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k])
    with open(out / "tad.json") as f:
        tad_r = json.load(f)
    alone = tad_cli.main(["--config", "faces", "-r", checkpoint_dir,
                          "--eval_npz", want, "--device", "cpu"])
    assert tad_r == {"TAD SCORE: ": alone["tad_score"],
                     "Attributes Captured: ": alone["attributes_captured"]}
    with open(out / "fid.json") as f:
        assert json.load(f)["num"] == 4
    grid = np.load(out / "swap" / "swap_full_grid.npy")
    assert grid.shape == (84, 32, 32, 3) and np.isfinite(grid).all()
