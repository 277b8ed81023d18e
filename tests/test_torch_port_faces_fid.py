"""The faces configuration's FID pieces held against the JAX package, on
the CPU: the Inception features from converted flax variables, the
bilinear resize, the Fréchet distance on rank-deficient statistics and a
pytorch-fid-named state_dict through both packages (split from
``test_torch_port_faces_serve.py``). Inputs are made with numpy from a
seed; tolerances as stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.evalx import fid as jfid
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.evalx import fid as tfid
from test_torch_port_faces_serve import _t


@pytest.fixture(scope="module")
def fid_variables():
    return jax.tree.map(np.asarray,
                        jfid.init_fid_variables(jax.random.PRNGKey(0)))


def _features(variables, images, **kw):
    return np.asarray(jfid.InceptionV3FID(**kw).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images)))


def test_inception_features_match_jax(fid_variables):
    images = np.random.RandomState(40).rand(2, 75, 75, 3).astype(np.float32)
    ref = _features(fid_variables, images, resize_input=False)
    model = tfid.InceptionV3FID(resize_input=False)
    model.load_state_dict(convert.inception_state_dict(fid_variables),
                          strict=False)
    out = model(_t(images)).numpy()
    assert out.shape == (2, 2048)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("side", [64, 256])
def test_bilinear_resize_matches_jax(side):
    x = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                      method="bilinear"))
    out = tfid.resize_bilinear(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_frechet_distance_rank_deficient():
    """10 samples of 32 features: both covariances have rank 9, and the
    square root of their product comes out complex (its real part is
    kept)."""
    rs = np.random.RandomState(41)
    a, b = rs.randn(10, 32), rs.randn(10, 32) * 1.5 + 0.3
    stats = [*tfid.activation_statistics(a), *tfid.activation_statistics(b)]
    assert np.linalg.matrix_rank(stats[1]) == 9
    got = tfid.frechet_distance(*stats)
    want = jfid.frechet_distance(*jfid.activation_statistics(a),
                                 *jfid.activation_statistics(b))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-10)


def test_pytorch_fid_state_dict_loads_into_both(fid_variables):
    """A state_dict under pytorch-fid's names (with its classifier, without
    num_batches_tracked) loads into the port and, through
    ``load_torch_fid_inception``, into the JAX tree: the same features."""
    model = tfid.InceptionV3FID()
    model.init_parameters(torch.Generator().manual_seed(42))
    rs = np.random.RandomState(43)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if ".bn." in k:  # non-trivial BatchNorm statistics and affine
            noise = torch.from_numpy(rs.rand(*v.shape).astype(np.float32))
            v = 0.5 + noise if k.endswith(("running_var", "weight")) \
                else 0.2 * noise - 0.1
        sd[k] = v.clone()
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    port = tfid.fid_inception("cpu", state_dict=sd)
    jvars = jfid.load_torch_fid_inception(fid_variables, sd)
    images = rs.rand(2, 64, 64, 3).astype(np.float32)
    ref = _features(jvars, images)
    out = port(_t(images)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    with pytest.raises(KeyError):
        tfid.load_pt_inception(tfid.InceptionV3FID(),
                               {k: v for k, v in sd.items()
                                if "Mixed_7c" not in k})
