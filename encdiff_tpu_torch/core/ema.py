"""EMA of model parameters.

Counterpart of ``encdiff_tpu/core/ema.py:19-46``: the shadow moves as
``shadow <- shadow - (1 - d)(shadow - param)`` with the reference's decay
warmup ``d = min(decay, (1 + n) / (10 + n))``, n the update count after it
is incremented. The JAX state is an immutable pytree; here the shadow
tensors are updated in place, which saves one copy of the parameters per
step. ``applied`` puts the shadow into the model for sampling, as the JAX
package samples from the EMA's params. The decay is computed in float32,
as the JAX package computes it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class EmaState:
    params: dict          # name -> shadow tensor
    num_updates: int


def init(named_params: dict) -> EmaState:
    """A shadow copy of ``named_params`` (name -> tensor)."""
    return EmaState(
        params={k: p.detach().clone() for k, p in named_params.items()},
        num_updates=0)


@torch.no_grad()
def update(state: EmaState, named_params: dict, decay: float) -> None:
    """One EMA step towards ``named_params``, in place."""
    n = state.num_updates + 1
    nf = np.float32(n)
    d = min(np.float32(decay), (np.float32(1.0) + nf) / (np.float32(10.0) + nf))
    w = float(np.float32(1.0) - d)
    shadows = list(state.params.values())
    params = [named_params[k].detach() for k in state.params]
    diffs = torch._foreach_sub(shadows, params)
    torch._foreach_mul_(diffs, w)
    torch._foreach_sub_(shadows, diffs)
    state.num_updates = n


@contextlib.contextmanager
def applied(state: EmaState, named_params: dict):
    """Within the block, the parameters ``named_params`` hold the EMA's
    values; their own come back after it."""
    saved = {k: named_params[k].detach().clone() for k in state.params}
    with torch.no_grad():
        for k, v in state.params.items():
            named_params[k].copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in saved.items():
                named_params[k].copy_(v)


def maybe_applied(state: EmaState | None, module):
    """``applied`` to ``module``'s parameters where ``state`` is given, else
    a block that changes nothing."""
    if state is None:
        return contextlib.nullcontext()
    return applied(state, dict(module.named_parameters()))
