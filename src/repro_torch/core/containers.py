"""listenv analogue: a container whose slots may hold futures and resolve on
access (promise semantics of %<-%, paper §Future assignment construct)."""

from __future__ import annotations

from typing import Any, Iterator

from .future import Future


class ListEnv:
    """``vs[i] = future(...); vs[i]`` resolves on read — R's listenv +
    %<-% promise behaviour, minus the operator (Python has no %<-%)."""

    def __init__(self, n: int = 0):
        self._slots: list[Any] = [None] * n

    def __setitem__(self, i: int, v: Any) -> None:
        if i == len(self._slots):
            self._slots.append(v)           # listenv auto-grows by one
        else:
            self._slots[i] = v

    def __getitem__(self, i: int) -> Any:
        v = self._slots[i]
        if isinstance(v, Future):
            v = v.value()
            self._slots[i] = v              # promise: resolve once
        return v

    def __len__(self) -> int:
        return len(self._slots)

    def __iter__(self) -> Iterator[Any]:
        return (self[i] for i in range(len(self)))

    def as_list(self) -> list:
        return list(self)
