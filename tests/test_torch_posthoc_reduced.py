"""The port's reduced downstream task held against the JAX package on the
CPU (the setting of ``test_torch_posthoc_trees.py``): for each factor the
code its predictor finds most important is dropped and every factor's
predictor is trained again. The port draws the JAX loop's tree seeds up
front, factor by factor (the removal's fit, then the retrained ones), so
that the removals of every factor grow together; the scores are equal and
the global state ends where the JAX run leaves it. Two removals a factor
take both of the port's routes: the first removal of every factor in one
batch, the second factor by factor.
"""

from encdiff_tpu.evalx.metrics import downstream_task as jdt
from encdiff_tpu_torch.evalx.metrics import downstream_task as dt
from test_torch_posthoc_trees import both
from torch_threads import one_thread  # noqa: F401


def test_reduced_downstream_task_equals_jax():
    ours, theirs = both(jdt.compute_reduced_downstream_task,
                        dt.compute_reduced_downstream_task,
                        num_factors_to_remove=2, num_train=(90,),
                        num_test=60)
    assert ours == theirs
    assert theirs["90:mean_test_accuracy_other_factors"] > 0.3
