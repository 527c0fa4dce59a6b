"""TrainState: params and optimiser state. Counterpart of
``repro/train/state.py`` on one device (its sharding specs come with the
multi-device substrate)."""

from __future__ import annotations

import dataclasses
from typing import Any

from ..optim import adamw


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict


def init_train_state(params: Any) -> TrainState:
    return TrainState(params=params, opt=adamw.init_state(params))
