"""Backend-invariant parallel RNG streams (paper §Proper parallel RNG).

The paper mandates L'Ecuyer-CMRG streams so that ``future(rnorm(3),
seed=TRUE)`` is *fully reproducible regardless of backend and worker count*.
Here every stream key is a counter-based ``numpy.random.SeedSequence``:
every future receives ``SeedSequence(session_seed, spawn_key=(counter,))``
and every map-reduce **element** receives ``SeedSequence(session_seed,
spawn_key=(element_index,))`` — indexed by element, never by worker or
chunk, so results are invariant to chunking and scheduling. Keys are
picklable and seed a ``torch.Generator`` (:func:`generator`). The draws are
not JAX's threefry draws; the contract is the same.

Like the paper, an RNG draw inside a future that did *not* declare ``seed=``
triggers an informative :class:`RNGMisuseWarning` (detection is cheap: we
count draws through this module's helpers).
"""

from __future__ import annotations

import threading
import warnings
from typing import Iterator

import numpy as np
import torch

from .errors import RNGMisuseWarning

_lock = threading.Lock()
_session_seed: int = 0
_future_counter: int = 0


def set_session_seed(seed: int) -> None:
    """Set the process-wide session seed (analogue of R's set.seed())."""
    global _session_seed, _future_counter
    with _lock:
        _session_seed = int(seed)
        _future_counter = 0


def next_stream_index() -> int:
    global _future_counter
    with _lock:
        idx = _future_counter
        _future_counter += 1
        return idx


def stream_key(index: int) -> np.random.SeedSequence:
    """Deterministic per-stream key: (session seed, index)."""
    return np.random.SeedSequence(_session_seed, spawn_key=(index,))


def element_keys(n: int, *, base_index: int = 0
                 ) -> Iterator[np.random.SeedSequence]:
    """Per-element keys for map-reduce — invariant to chunking/backends."""
    for i in range(n):
        yield np.random.SeedSequence(_session_seed,
                                     spawn_key=(base_index + i,))


def generator(key: np.random.SeedSequence,
              device: "str | torch.device" = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key.generate_state(1, np.uint64)[0]))
    return g


# --------------------------------------------------------------------------
# Misuse detection
# --------------------------------------------------------------------------

class _RngFlag(threading.local):
    def __init__(self):
        self.declared: bool | None = None   # None = not inside a future
        self.touched: bool = False


_FLAG = _RngFlag()


class rng_scope:
    """Context manager installed by the evaluation harness around a future
    body. ``declared`` records whether the future was created with seed=."""

    def __init__(self, declared: bool):
        self.declared = declared

    def __enter__(self):
        self._prev = (_FLAG.declared, _FLAG.touched)
        _FLAG.declared, _FLAG.touched = self.declared, False
        return self

    def __exit__(self, *exc):
        touched = _FLAG.touched
        _FLAG.declared, _FLAG.touched = self._prev
        if touched and not self.declared:
            warnings.warn(
                "a future drew random numbers via repro_torch.core.rng "
                "without declaring seed=; results may not be reproducible "
                "across backends (pass seed=True to future())",
                RNGMisuseWarning, stacklevel=2)
        return False


def mark_rng_use() -> None:
    if _FLAG.declared is not None:
        _FLAG.touched = True


# Convenience draw helpers that participate in misuse detection. A future's
# body receives its stream key as the argument `key` when seed= is declared.

def normal(key: np.random.SeedSequence, shape=(),
           dtype=torch.float32) -> torch.Tensor:
    mark_rng_use()
    return torch.randn(shape, generator=generator(key), dtype=dtype)


def uniform(key: np.random.SeedSequence, shape=(), dtype=torch.float32,
            minval=0., maxval=1.) -> torch.Tensor:
    mark_rng_use()
    u = torch.rand(shape, generator=generator(key), dtype=dtype)
    return u * (maxval - minval) + minval


def randint(key: np.random.SeedSequence, shape, minval, maxval,
            dtype=torch.int32) -> torch.Tensor:
    mark_rng_use()
    return torch.randint(minval, maxval, shape, generator=generator(key),
                         dtype=dtype)
