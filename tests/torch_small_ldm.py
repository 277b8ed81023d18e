"""A small EncDiff model in both packages with the same weights.

The JAX ``LatentDiffusion`` of ``test_torch_port_slice.SMALL`` (model
channels 32, channel_mult (1, 2), 8x8x3 latents, 16 px images; Encoder4
initialised on the 16 px images the first stage reads) with every leaf drawn
from a numpy seed (``test_torch_port_slice._seeded``: no zero-initialised
output conv hides a path), and the port's model loaded from the same
variables. ``config`` overrides keys of SMALL (``timesteps``,
``log_every_t``); ``ema`` adds an EMA tree of the UNet drawn from another
seed.
"""

import jax
import jax.numpy as jnp

from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.core.ema import EmaState
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from test_torch_port_slice import SMALL, _jax_ldm_config, _seeded

SCALE_FACTOR = 1.7


def small_ldm_pair(seed: int = 20, ema: bool = False, **config):
    """(JAX model, its variables as jax arrays, the port's model, the
    port's ``EmaState`` of the EMA tree or None)."""
    cfg = {**SMALL, **config}
    jcfg = _jax_ldm_config(cfg)
    if "log_every_t" in config:
        jcfg["params"]["log_every_t"] = config["log_every_t"]
    jmodel = instantiate_from_config(jcfg)
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=16),
        jax.random.PRNGKey(0))
    variables = {**_seeded(shapes, seed), "ema": None}
    state = None
    if ema:
        variables["ema"] = _seeded(shapes["unet"]["params"], seed + 1)
        sd = convert.flax_to_state_dict(variables["ema"])
        state = EmaState(params=dict(sd), num_updates=1)
    jmodel.scale_factor = SCALE_FACTOR
    jvars = {k: None if v is None else jax.tree.map(jnp.asarray, v)
             for k, v in variables.items()}
    tmodel = LatentDiffusion(cfg, device="cpu")
    tmodel.load_variables({**variables, "ema": None}, SCALE_FACTOR)
    return jmodel, jvars, tmodel, state
