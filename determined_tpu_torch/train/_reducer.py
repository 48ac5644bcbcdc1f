"""Validation-metric reducers: how per-batch metrics combine across the
validation sweep.

A copy of ``determined_tpu/train/_reducer.py`` written on tensors: a reducer
is an (init, accumulate, finalize) triple; ``accumulate`` runs on the device
per batch, so reducing costs no host sync, and ``finalize`` runs once on the
host.  Built-ins: mean/avg, sum, min, max, last.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Union

import torch


@dataclasses.dataclass(frozen=True)
class MetricReducer:
    """Across-batch combine for one validation metric.

    ``accumulate(carry, value) -> carry`` runs per batch on device tensors;
    ``finalize(carry, n_batches) -> value`` runs once, host-side.
    """

    init: float
    accumulate: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    finalize: Callable[[float, float], float] = lambda carry, n: carry


MEAN = MetricReducer(
    init=0.0,
    accumulate=lambda c, v: c + v,
    finalize=lambda c, n: c / max(n, 1.0),
)
SUM = MetricReducer(init=0.0, accumulate=lambda c, v: c + v)
MIN = MetricReducer(init=float("inf"), accumulate=torch.minimum)
MAX = MetricReducer(init=float("-inf"), accumulate=torch.maximum)
LAST = MetricReducer(init=0.0, accumulate=lambda c, v: v)

_BUILTINS: Dict[str, MetricReducer] = {
    "mean": MEAN,
    "avg": MEAN,
    "sum": SUM,
    "min": MIN,
    "max": MAX,
    "last": LAST,
}

ReducerSpec = Union[str, MetricReducer]


def get_reducer(spec: ReducerSpec) -> MetricReducer:
    if isinstance(spec, MetricReducer):
        return spec
    try:
        return _BUILTINS[str(spec).lower()]
    except KeyError:
        raise ValueError(
            f"unknown reducer {spec!r}; builtins: {sorted(_BUILTINS)}"
        ) from None
