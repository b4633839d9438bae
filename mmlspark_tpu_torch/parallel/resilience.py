"""Train-step hooks — the port's copy of the step boundary of the JAX
package's ``parallel/resilience.py``.

The boosting loop calls :func:`step_start` before the work of each
iteration and :func:`step_end` after it, as the JAX trainer does. The
one thing a step boundary runs here is the step throttle
(:func:`install_step_throttle`): the streaming refresh loop installs one
for a low-priority refit that shares the process (and the card) with a
server, and it yields while the server's queue sits past its high-water
mark (``io/refresh.py``). With no throttle installed each hook is a
single ``is None`` check. The train-step watchdog, stall attribution and
elastic resume of the reference wait for ROADMAP A8b.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["install_step_throttle", "step_start", "step_end"]

_step_throttle: Optional[Callable[[Any], None]] = None


def install_step_throttle(fn: Optional[Callable[[Any], None]]
                          ) -> Optional[Callable[[Any], None]]:
    """Install (``None`` clears) a callable invoked at every train-step
    boundary with the step's tag (its iteration number, counting the
    trees of a warm start) — the refit admission-control hook of
    ``io/refresh.py``. Returns the previous throttle so callers can
    restore it."""
    global _step_throttle
    prev = _step_throttle
    _step_throttle = fn
    return prev


def step_start(tag: Any = None) -> None:
    """A train step begins. Free when no throttle is installed."""
    if _step_throttle is not None:
        _step_throttle(tag)


def step_end() -> None:
    """A train step ended: the watchdog's span closes here in the
    reference (ROADMAP A8b); the port keeps the call site."""
