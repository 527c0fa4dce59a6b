"""TrainState: params and optimiser state, with sharding-spec companions.
Counterpart of ``repro/train/state.py``."""

from __future__ import annotations

import dataclasses
from typing import Any

from ..models import sharding as shd
from ..optim import adamw


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict


def init_train_state(params: Any) -> TrainState:
    return TrainState(params=params, opt=adamw.init_state(params))


def train_state_specs(params_shape: Any, *, zero: bool = True,
                      axis_sizes: dict | None = None) -> TrainState:
    """Sharding specs for a TrainState. ``zero=True`` spreads optimizer
    moments over the data axis too (ZeRO-1)."""
    pspec = shd.param_specs(params_shape, axis_sizes)
    mspec = shd.zero_specs(params_shape, axis_sizes=axis_sizes) \
        if zero else pspec
    return TrainState(params=pspec,
                      opt={"step": shd.Spec(), "m": mspec, "v": mspec})
