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

Actor *processes* cannot share the live tree, so the store also has a
serialized subscribe path: ``pull_serialized(have_version)`` returns a
serde-encoded buffer only when something newer than ``have_version`` is
published (else None, a cheap "you're current"). The encode runs at most
once per published version and is cached, so N subscribing children
cost one device-to-host copy per update, not N. That copy runs on the
store's own CUDA stream after it waited for the publish's ``ready``
event (the tree is written on the learner's stream; a plain ``.cpu()``
on the caller's thread could read it half-written), into pinned buffers
reused from version to version.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.distributed import serde
from repro_torch.params import tree_leaves, tree_unflatten_like

PyTree = Any


class ParameterStore:
    """Lock-guarded (params, version) cell with monotonically increasing
    versions. Version 0 is the initial (pre-training) parameter set."""

    def __init__(self, params: PyTree, version: int = 0,
                 wire_codec: str = "none", ready: Any = None):
        self._lock = threading.Lock()
        self._params = params
        self._version = version
        self._ready = ready
        self.wire_codec = serde.check_codec(wire_codec)
        self.publishes = 0
        self.pulls = 0
        self.serialized_pulls = 0
        self.serialized_encodes = 0
        self.serialized_wire_bytes = 0   # last encode: bytes on the wire
        self.serialized_raw_bytes = 0    # last encode: raw leaf bytes
        self._ser_cache: Optional[Tuple[int, bytes]] = None
        # one encoder at a time (the param server thread, or the socket
        # transport's connection threads): it owns the pinned buffers
        self._ser_lock = threading.Lock()
        self._pinned: Optional[List[torch.Tensor]] = None
        self._copy_stream = None

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

    def pull_serialized(self, have_version: int = -1
                        ) -> Optional[Tuple[bytes, int]]:
        """(encoded params, version) if anything newer than
        ``have_version`` is published, else None. Encoded once per
        version, outside the publish lock."""
        with self._lock:
            self.serialized_pulls += 1
            version = self._version
            if version <= have_version:
                return None
            params, ready = self._params, self._ready
            cached = self._ser_cache
        if cached is not None and cached[0] == version:
            return cached[1], version
        with self._ser_lock:
            cached = self._ser_cache
            if cached is not None and cached[0] >= version:
                return cached[1], cached[0]
            buf = serde.encode_tree(self._host_view(params, ready),
                                    codec=self.wire_codec)
            self.serialized_encodes += 1
            self._ser_cache = (version, buf)
            self.serialized_wire_bytes = len(buf)
            self.serialized_raw_bytes = serde.tree_nbytes(params)
        return buf, version

    def _host_view(self, params: PyTree, ready: Any) -> PyTree:
        """``params`` readable on the host: CPU trees as they are; a tree
        on the card copied into the store's pinned buffers on its own
        stream, after ``ready``, and waited for. Called under
        ``_ser_lock``."""
        leaves = tree_leaves(params)
        if not any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in leaves):
            return params
        if self._pinned is None or [tuple(p.shape) for p in self._pinned] \
                != [tuple(x.shape) for x in leaves]:
            self._pinned = [torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True) for x in leaves]
            self._copy_stream = torch.cuda.Stream(leaves[0].device)
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            for dst, x in zip(self._pinned, leaves):
                dst.copy_(x.detach(), non_blocking=True)
        # ``params`` stays referenced until the copies finished, so the
        # allocator cannot hand its blocks to another stream meanwhile
        stream.synchronize()
        return tree_unflatten_like(params, self._pinned)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version
