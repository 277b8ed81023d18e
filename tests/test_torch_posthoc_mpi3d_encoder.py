"""The JAX-trained MPI3D checkpoint (``demo_artifacts/round5/
mpi3d_best_dci_fp16.npz``, step 6075) read by the port's Encoder4 and by
the JAX one: the codes of 64 seeded MPI3D images agree within
``CODE_TOL`` (1e-4, as the harness's network tests hold fp32 networks
summed in another order). The port's reader is ``udr_eval.load_encoder``
under ``-b mpi3d``'s model config, the one the card's milestone and UDR
phases use; the images come from the MPI3D renderer on a sub-grid with
every object, camera and background value (2 of the 40 arm positions on
each axis).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import torch

from encdiff_tpu.nn.encoder4 import Encoder4 as JEncoder4
from encdiff_tpu_torch import udr_eval
from encdiff_tpu_torch.configs import MPI3D_RUN
from encdiff_tpu_torch.data.synthetic_mpi3d import render_mpi3d_all
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
NPZ = ROOT / "demo_artifacts/round5/mpi3d_best_dci_fp16.npz"
CODE_TOL = dict(rtol=1e-4, atol=1e-4)
SUB_GRID = (6, 6, 2, 3, 3, 2, 2)


def _jax_variables():
    out = {"params": {}, "batch_stats": {}}
    with np.load(NPZ) as z:
        step = int(z["state/step"])
        for key in z.files:
            for prefix, coll in (("state/params/cond/", "params"),
                                 ("state/batch_stats/", "batch_stats")):
                if key.startswith(prefix):
                    node = out[coll]
                    parts = key[len(prefix):].split("/")
                    for p in parts[:-1]:
                        node = node.setdefault(p, {})
                    node[parts[-1]] = z[key].astype(np.float32)
    return out, step


def test_mpi3d_checkpoint_codes_match_jax():
    variables, step = _jax_variables()
    assert step == 6075
    images = render_mpi3d_all(64, factor_sizes=SUB_GRID)
    pick = np.random.RandomState(0).choice(len(images), 64, replace=False)
    x = images[pick].astype(np.float32) / 127.5 - 1.0
    cfg = MPI3D_RUN["model"]["params"]["cond_stage_config"]
    jenc = JEncoder4(d=cfg["d"], context_dim=cfg["context_dim"],
                     latent_unit=cfg["latent_unit"])
    want = np.asarray(jenc.apply(variables, jnp.asarray(x),
                                 method=JEncoder4.encoding))
    enc = udr_eval.load_encoder(MPI3D_RUN["model"]["params"], str(NPZ),
                                "cpu")
    got = udr_eval.code_fn(enc, torch.from_numpy(images))(pick)
    assert got.shape == want.shape == (64, 20)
    np.testing.assert_allclose(got, want, **CODE_TOL)
    assert float(np.std(want, axis=0).min()) > 1e-3
