"""Retry/backoff policy (port of ``apex_tpu/resilience/retry.py``).

One policy object wraps every host-side call that can transiently fail
(checkpoint I/O, the train step) with exponential backoff and jitter, a
total attempt budget, per-exception-class budgets and an optional
wall-clock :class:`Deadline`. Every retry and give-up lands as a
``resilience/*`` counter in the port's metric registry.

The module has no device code. The jitter draws from
``random.Random(seed)``, so one seed gives the same backoff sequence in
both packages.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["Deadline", "Policy", "DEFAULT_RETRYABLE"]

#: Exception classes retried by default: filesystem/RPC-shaped failures.
#: (Includes the injected TornWrite/DiskFull via their OSError base.)
DEFAULT_RETRYABLE = (OSError, ConnectionError, TimeoutError)


class Deadline:
    """An absolute wall-clock budget shared across retries.

    ``clock`` is injectable (tests pass a fake); the default is
    ``time.monotonic`` — immune to NTP steps mid-backoff.
    """

    def __init__(self, seconds: float, clock: Callable[[], float] = None):
        self.seconds = float(seconds)
        self._clock = clock or time.monotonic
        self._until = self._clock() + self.seconds

    def remaining(self) -> float:
        return max(0.0, self._until - self._clock())

    def expired(self) -> bool:
        return self._clock() >= self._until

    def __repr__(self):
        return f"Deadline({self.remaining():.3f}s remaining)"


class Policy:
    """Exponential backoff + jitter with attempt/class/deadline budgets.

    - ``max_attempts``: total tries (first call included) per
      :meth:`call`.
    - ``rules``: ``{ExceptionClass: attempts}`` — a tighter (or looser)
      budget for specific classes; the first matching class in
      insertion order wins. ``{SomeError: 1}`` means "never retry
      SomeError".
    - ``no_retry``: classes re-raised immediately even if they match
      ``retry_on`` (e.g. ``KeyboardInterrupt`` is never caught anyway —
      only ``Exception`` subclasses are).
    - ``deadline_s``: per-:meth:`call` wall-clock budget; backoff sleeps
      are clamped to it and a retry is abandoned once it expires.
    - ``seed``: makes the jitter sequence deterministic (chaos tests).
    - ``sleep``: injectable for tests (``lambda s: None``).

    On give-up the LAST exception is re-raised unchanged — callers'
    ``except OSError`` clauses keep working — after the
    ``resilience/give_ups`` counter fires.
    """

    def __init__(self, max_attempts: int = 4,
                 initial_backoff: float = 0.05, max_backoff: float = 2.0,
                 multiplier: float = 2.0, jitter: float = 0.25,
                 retry_on=DEFAULT_RETRYABLE, no_retry=(),
                 rules: Optional[dict] = None,
                 deadline_s: Optional[float] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: Optional[int] = None, name: str = "",
                 registry=None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        self.max_attempts = max_attempts
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.multiplier = multiplier
        self.jitter = jitter
        self.retry_on = tuple(retry_on)
        self.no_retry = tuple(no_retry)
        self.rules = dict(rules or {})
        self.deadline_s = deadline_s
        self.name = name or "default"
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._registry = registry

    # ------------------------------------------------------------ parts

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from apex_tpu_torch.observability import get_registry
        return get_registry()

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based): capped
        exponential, jittered by ±``jitter`` fraction."""
        base = min(self.max_backoff,
                   self.initial_backoff * self.multiplier ** (attempt - 1))
        return max(0.0, base * (1.0 + self.jitter
                                * self._rng.uniform(-1.0, 1.0)))

    def budget_for(self, exc: BaseException) -> int:
        """Attempt budget for this exception (first matching rule in
        insertion order, else ``max_attempts``)."""
        for cls, attempts in self.rules.items():
            if isinstance(exc, cls):
                return int(attempts)
        return self.max_attempts

    # ------------------------------------------------------------- call

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy."""
        deadline = (Deadline(self.deadline_s)
                    if self.deadline_s is not None else None)
        reg = self._reg()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.no_retry:
                raise
            except self.retry_on as e:
                out_of_attempts = attempt >= self.budget_for(e)
                out_of_time = deadline is not None and deadline.expired()
                if out_of_attempts or out_of_time:
                    reg.counter("resilience/give_ups",
                                scope=self.name).inc()
                    reg.event("resilience_give_up", scope=self.name,
                              attempts=attempt, error=repr(e)[:200],
                              deadline_expired=bool(out_of_time))
                    raise
                reg.counter("resilience/retries", scope=self.name).inc()
                delay = self.backoff(attempt)
                if deadline is not None:
                    delay = min(delay, deadline.remaining())
                self._sleep(delay)

    def wrap(self, fn):
        """Decorator form: ``saver = policy.wrap(save_checkpoint)``."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped
