"""A registry of named metrics instruments plus pull-time producers (the
port's own copy of ``repro.obs.metrics``).

Design constraints, in order:

  hot-path cost   every writer that matters (queue put/get, socket
                  frame receive, inference flush, learner update) is
                  already serialized by its own lock. Instruments
                  therefore do NOT take a lock per write — ``inc`` is a
                  plain ``+=`` and the *caller's* existing lock is the
                  write serialization, exactly as the raw ``self.pushed
                  += 1`` counters worked before the registry existed.
  torn reads      ``collect()`` may run concurrently with writers (the
                  /metrics HTTP thread against the learner loop). Ints
                  and floats are replaced atomically under the GIL, so
                  scalar reads are never torn; histogram dict copies
                  can race a concurrent insert, so they retry.
  one data source the end-of-run ``telemetry_snapshot()`` and the live
                  ``/metrics`` endpoint both read ``collect()`` — a
                  counter cannot drift between the two because there is
                  only one of it.

*Producers* cover state that already has an owner with a snapshot
method (a transport's wire counters, the inference service, a gradient
exchange): ``register_producer("queue", q.snapshot)`` makes
``collect()["queue"]`` that snapshot, evaluated at pull time.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Optional


class Counter:
    """A monotonically increasing (or explicitly adjusted) integer.
    Writers serialize themselves (see module docstring)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A point-in-time value; ``set`` replaces it atomically."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class IntHistogram:
    """An integer-keyed histogram: exactly the ``collections.Counter``
    shape the runtime's lag / batch-size histograms always used. The
    ``counts`` Counter is exposed directly so existing code paths
    (``hist[k] += 1``, ``dict(sorted(hist.items()))``, ``max(hist)``)
    keep working on the registry's storage — the hot-path write IS the
    registry write."""

    __slots__ = ("name", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts: collections.Counter = collections.Counter()

    def observe(self, k: int, n: int = 1) -> None:
        self.counts[k] += n


def safe_copy(d: Dict) -> Dict:
    """Copy a dict that a writer may be growing concurrently: a plain
    ``dict(d)`` can raise RuntimeError mid-iteration, so retry a few
    times and fall back to an item-by-item best effort."""
    for _ in range(4):
        try:
            return dict(d)
        except RuntimeError:
            continue
    out = {}
    for k in list(d):
        try:
            out[k] = d[k]
        except KeyError:
            pass
    return out


class Registry:
    """Create-or-get instruments by name, plus pull-time producers.

    The name is the identity: asking twice for ``counter("q.pushed")``
    returns the same object, so a component and its telemetry reader
    never hold different counters. Asking for an existing name with a
    different instrument type raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}
        self._producers: Dict[str, Callable[[], Optional[Dict]]] = {}

    # ------------------------------------------------------------------

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def int_histogram(self, name: str) -> IntHistogram:
        return self._get(name, IntHistogram)

    def register_producer(self, name: str,
                          fn: Callable[[], Optional[Dict]]) -> None:
        """``collect()[name]`` becomes ``fn()`` evaluated at pull time.
        A producer returning None is omitted from the collection (the
        hook for optional sections like ``inference``). Re-registering
        a name replaces the producer — components are rebuilt per run."""
        with self._lock:
            self._producers[name] = fn

    # ------------------------------------------------------------------

    def collect(self) -> Dict[str, Any]:
        """One flat pull of everything: instrument values by name,
        producer dicts by name. Producer exceptions are captured as an
        ``error`` entry instead of killing the telemetry reader — a
        metrics pull must never take down the run it is observing."""
        with self._lock:
            instruments = list(self._instruments.items())
            producers = list(self._producers.items())
        out: Dict[str, Any] = {}
        for name, inst in instruments:
            if isinstance(inst, IntHistogram):
                out[name] = safe_copy(inst.counts)
            else:
                out[name] = inst.value
        for name, fn in producers:
            try:
                val = fn()
            except Exception as e:
                val = {"error": repr(e)}
            if val is not None:
                out[name] = val
        return out
