from encdiff_tpu_torch.evalx.metrics.beta_vae import compute_beta_vae_sklearn
from encdiff_tpu_torch.evalx.metrics.dci import compute_dci
from encdiff_tpu_torch.evalx.metrics.factor_vae import compute_factor_vae
from encdiff_tpu_torch.evalx.metrics.mig import compute_mig
from encdiff_tpu_torch.evalx.metrics.sap_score import compute_sap
from encdiff_tpu_torch.evalx.metrics.irs import compute_irs
from encdiff_tpu_torch.evalx.metrics.modularity_explicitness import (
    compute_modularity_explicitness)
from encdiff_tpu_torch.evalx.metrics.unsupervised_metrics import (
    unsupervised_metrics)
from encdiff_tpu_torch.evalx.metrics.downstream_task import (
    compute_downstream_task, compute_reduced_downstream_task)
from encdiff_tpu_torch.evalx.metrics.fairness import compute_fairness
from encdiff_tpu_torch.evalx.metrics.med import compute_med

__all__ = [
    "compute_beta_vae_sklearn", "compute_dci", "compute_factor_vae",
    "compute_mig", "compute_sap", "compute_irs",
    "compute_modularity_explicitness", "unsupervised_metrics",
    "compute_downstream_task", "compute_reduced_downstream_task",
    "compute_fairness", "compute_med",
]
