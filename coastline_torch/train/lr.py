"""ReduceLROnPlateau as a pure function (counterpart of `coastline/train/lr.py`).

torch's `ReduceLROnPlateau(mode='min', threshold=1e-4, threshold_mode='rel',
cooldown=0)` written as a state and an update, so the trainer can
checkpoint it with the rest of its state: the lr is multiplied by `factor`
once `num_bad` exceeds `patience`. The JAX package keeps the state as
float32 scalars; here they are Python floats holding the same float32
values, and every comparison and product is taken in float32 as there, so
the two agree exactly.
"""

from dataclasses import dataclass

import numpy as np

_F32 = np.float32


@dataclass(frozen=True)
class PlateauState:
    lr: float  # current learning rate
    best: float  # best metric seen
    num_bad: int  # epochs without improvement


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=float(_F32(lr)), best=float("inf"), num_bad=0)


def plateau_update(state: PlateauState, metric, patience: int, factor: float = 0.5,
                   threshold: float = 1e-4, min_lr: float = 0.0) -> PlateauState:
    metric = _F32(metric)
    with np.errstate(over="ignore", invalid="ignore"):
        improved = bool(metric < _F32(state.best) * _F32(1.0 - threshold))
    best = metric if improved else _F32(state.best)
    num_bad = 0 if improved else state.num_bad + 1
    lr = _F32(state.lr)
    if num_bad > patience:
        lr = max(lr * _F32(factor), _F32(min_lr))
        num_bad = 0
    return PlateauState(lr=float(lr), best=float(best), num_bad=num_bad)
