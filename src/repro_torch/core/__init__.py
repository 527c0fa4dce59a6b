"""repro_torch.core — the in-process Future API of the port.

    from repro_torch.core import future, value, resolved, plan

    plan("threads", workers=4)
    f = future(lambda: slow_fcn(x))
    ...
    v = value(f)

Backends: "sequential" (default), "threads", "processes" (the paper's
multisession: spawned worker processes, globals shipped content-addressed,
a dying worker raising ``WorkerDiedError`` while the pool heals),
"cluster" (the paper's PSOCK cluster: workers the driver launches, dialing
back over TCP with a token and optionally TLS; large results stay on the
worker that made them, and continuations run where they are), "asyncio"
and "cuda_async" (futures resolved by CUDA events on the card's stream;
``device="cpu"`` makes it synchronous, for tests). The copy of ``repro.core`` keeps its
semantics (snapshot at creation, relaying, lazy futures, continuation
combinators); only the RNG keys change, to counter-based ``SeedSequence``
keys that seed a ``torch.Generator`` (see ``rng.py``).

``await f`` works on every backend; ``plan("asyncio")`` additionally runs
``async def`` bodies on one event loop. The map-reduce frontends
(``future_map``, ``future_lapply``, ``future_either``, ``retry``) are sugar
over the streaming frontend, and ``state`` is the shared, versioned
key-value service task bodies talk through::

    from repro_torch.core import state, stream

    total = stream(huge_generator()).map(score, seed=True).reduce(add)
"""

from . import rng                                            # noqa: F401
from . import state                                          # noqa: F401
from .backends import base as _base                          # noqa: F401
from .backends import sequential as _sequential              # noqa: F401
from .backends import threads as _threads                    # noqa: F401
from .backends import processes as _processes                # noqa: F401
from .backends import cluster as _cluster                    # noqa: F401
from .backends import cuda_async as _cuda_async              # noqa: F401
from .backends import asyncio_loop as _asyncio_loop          # noqa: F401
from .backends.launchers import (CommandLauncher, Launcher,  # noqa: F401
                                 LocalLauncher, SSHLauncher, WorkerProc)
from .conditions import (CapturedRun, ImmediateCondition, message,  # noqa: F401
                         signal_progress)
from .containers import ListEnv                              # noqa: F401
from .errors import (ChannelError, FutureCancelledError,  # noqa: F401
                     FutureError, GlobalsError, LineageExhaustedError,
                     NonExportableObjectError, RNGMisuseWarning,
                     WorkerDiedError)
from .future import (AsyncWaiter, Future, Waiter, as_completed,  # noqa: F401
                     as_completed_async, first, first_successful, future,
                     gather, merge, resolve, resolved, value, wait_any)
from .mapreduce import (future_either, future_lapply, future_map,  # noqa: F401
                        future_map_chunked_lazy, retry, retry_future)
from .stream import Stream, stream                           # noqa: F401
from .planning import (active_backend, available_cores, plan,  # noqa: F401
                       shutdown, spec, tweak)
from .rng import set_session_seed                            # noqa: F401

__all__ = [
    "future", "value", "resolved", "resolve", "as_completed",
    "as_completed_async", "wait_any",
    "merge", "Future", "Waiter", "AsyncWaiter", "gather", "first",
    "first_successful",
    "plan", "spec", "tweak", "shutdown", "available_cores", "active_backend",
    "Launcher", "LocalLauncher", "SSHLauncher", "CommandLauncher",
    "WorkerProc",
    "future_map", "future_lapply", "future_either", "retry", "retry_future",
    "future_map_chunked_lazy", "stream", "Stream", "state",
    "FutureError", "WorkerDiedError", "ChannelError", "FutureCancelledError",
    "LineageExhaustedError",
    "GlobalsError", "NonExportableObjectError", "RNGMisuseWarning",
    "signal_progress", "message", "ListEnv", "set_session_seed",
    "CapturedRun", "ImmediateCondition",
]
