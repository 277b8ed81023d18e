from encdiff_tpu_torch.evalx.metrics.beta_vae import compute_beta_vae_sklearn
from encdiff_tpu_torch.evalx.metrics.dci import compute_dci
from encdiff_tpu_torch.evalx.metrics.factor_vae import compute_factor_vae
from encdiff_tpu_torch.evalx.metrics.mig import compute_mig

__all__ = [
    "compute_beta_vae_sklearn", "compute_dci", "compute_factor_vae",
    "compute_mig",
]
