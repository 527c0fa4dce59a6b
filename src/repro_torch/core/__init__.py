"""repro_torch.core — the in-process Future API of the port.

    from repro_torch.core import future, value, resolved, plan

    plan("threads", workers=4)
    f = future(lambda: slow_fcn(x))
    ...
    v = value(f)

Backends: "sequential" (default) and "threads". ``await f`` works on both.
The copy of ``repro.core`` keeps its semantics (snapshot at creation,
relaying, lazy futures, continuation combinators); only the RNG keys
change, to counter-based ``SeedSequence`` keys that seed a
``torch.Generator`` (see ``rng.py``).
"""

from . import rng                                            # noqa: F401
from .backends import base as _base                          # noqa: F401
from .backends import sequential as _sequential              # noqa: F401
from .backends import threads as _threads                    # noqa: F401
from .conditions import (CapturedRun, ImmediateCondition, message,  # noqa: F401
                         signal_progress)
from .containers import ListEnv                              # noqa: F401
from .errors import (FutureCancelledError, FutureError,  # noqa: F401
                     GlobalsError, RNGMisuseWarning)
from .future import (AsyncWaiter, Future, Waiter, as_completed,  # noqa: F401
                     as_completed_async, first, first_successful, future,
                     gather, merge, resolve, resolved, value, wait_any)
from .planning import (active_backend, available_cores, plan,  # noqa: F401
                       shutdown, spec, tweak)
from .rng import set_session_seed                            # noqa: F401

__all__ = [
    "future", "value", "resolved", "resolve", "as_completed",
    "as_completed_async", "wait_any",
    "merge", "Future", "Waiter", "AsyncWaiter", "gather", "first",
    "first_successful",
    "plan", "spec", "tweak", "shutdown", "available_cores", "active_backend",
    "FutureError", "FutureCancelledError", "GlobalsError", "RNGMisuseWarning",
    "signal_progress", "message", "ListEnv", "set_session_seed",
    "CapturedRun", "ImmediateCondition",
]
