"""Versioned parameter store (``repro.distributed.paramstore``): the
learner publishes, actors pull.

This is what makes policy lag a *measured* quantity: every pull returns
``(params, version)``, the actor stamps the version into the trajectory
it produces, and the learner computes ``lag = current_version -
trajectory.param_version`` when it consumes it (paper §4.2).

Thread-safety: one mutex guards the (params, version, ready) triple, so a
pull never observes a torn publish. The port's optimizer updates its
working parameters in place, so what is published must be a tree that no
later update writes: the learner publishes a copy (``Learner``).
``ready`` is the CUDA event recorded on the learner's stream after that
tree was written; an actor on another stream waits for it before it
reads the tree. It is None on the CPU, where every op has finished when
it returns.

Serialized pulls for actor processes (``pull_serialized``) come with the
process pools (ROADMAP.md, Queue 1 item 10): ``serialized_wire_bytes``
and ``serialized_raw_bytes`` stay 0, as they do on the JAX package's
in-process path.
"""
from __future__ import annotations

import threading
from typing import Any, Tuple

PyTree = Any

WIRE_CODECS = ("none", "bf16", "int8")


class ParameterStore:
    """Lock-guarded (params, version) cell with monotonically increasing
    versions. Version 0 is the initial (pre-training) parameter set."""

    def __init__(self, params: PyTree, version: int = 0,
                 wire_codec: str = "none", ready: Any = None):
        if wire_codec not in WIRE_CODECS:
            raise ValueError(f"unsupported wire codec {wire_codec!r} "
                             f"(this side speaks {', '.join(WIRE_CODECS)})")
        self._lock = threading.Lock()
        self._params = params
        self._version = version
        self._ready = ready
        self.wire_codec = wire_codec
        self.publishes = 0
        self.pulls = 0
        self.serialized_wire_bytes = 0
        self.serialized_raw_bytes = 0

    def publish(self, params: PyTree, ready: Any = None) -> int:
        """Install new params; returns the new version."""
        with self._lock:
            self._params = params
            self._ready = ready
            self._version += 1
            self.publishes += 1
            return self._version

    def publish_at(self, params: PyTree, version: int,
                   ready: Any = None) -> int:
        """Install new params at an externally assigned version (the
        learner group's designated publisher numbers the rounds).
        Non-monotonic delegation is a protocol bug: it raises."""
        with self._lock:
            if version <= self._version:
                raise ValueError(
                    f"delegated version {version} is not newer than "
                    f"current {self._version} (versions must be "
                    f"monotonic)")
            self._params = params
            self._ready = ready
            self._version = version
            self.publishes += 1
            return self._version

    def pull(self) -> Tuple[PyTree, int]:
        """Returns the current (params, version) snapshot."""
        with self._lock:
            self.pulls += 1
            return self._params, self._version

    def pull_ready(self) -> Tuple[PyTree, int, Any]:
        """``pull`` plus the event to wait for before reading the params
        on another stream (None: nothing to wait for)."""
        with self._lock:
            self.pulls += 1
            return self._params, self._version, self._ready

    @property
    def version(self) -> int:
        with self._lock:
            return self._version
