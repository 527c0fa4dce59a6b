"""Error hierarchy for the Future API.

The paper distinguishes two kinds of errors:

* *evaluation errors* — raised by the future's own expression; these are
  captured on the worker and re-raised **as-is** at ``value()`` so that code
  using futures behaves identically to code that does not (paper §Exception
  handling).

* *infrastructure errors* — crashed workers, broken channels, lost pods.
  These are "of a different kind" and signalled as ``FutureError`` so callers
  can handle them specifically, e.g. by restarting workers or re-dispatching
  the future elsewhere (paper §Future work: ``restart(f)`` / ``retry``).
"""

from __future__ import annotations


class FutureError(RuntimeError):
    """Infrastructure failure while resolving a future (not an evaluation
    error). Examples: worker process died, communication channel broke,
    pod preempted. Carries enough context for a supervisor to re-dispatch."""

    def __init__(self, message: str, *, future_label: str | None = None,
                 worker: object | None = None):
        super().__init__(message)
        self.future_label = future_label
        self.worker = worker


class FutureCancelledError(FutureError):
    """The future was cancelled before it resolved (e.g. the losing branches
    of ``future_either`` or an elastic down-scale)."""


class GlobalsError(ValueError):
    """A global required by the future expression could not be identified or
    snapshotted (paper §Globals and packages)."""


class RNGMisuseWarning(UserWarning):
    """A future produced random numbers without declaring ``seed=``.

    The paper emits an informative warning when an undeclared RNG draw is
    detected because it risks statistically unsound, irreproducible results.
    """
