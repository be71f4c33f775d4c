"""Restart seeding and the kill-safe stop flag
(``repro.distributed.supervise``). The ``Supervisor`` itself is not
ported yet (ROADMAP.md, Queue 1 item 13: supervision)."""
from __future__ import annotations

import time
from typing import Any, Optional

_SEED_FOLD_PRIME = 1_000_003


class KillSafeEvent:
    """Minimal ``multiprocessing.Event`` stand-in that survives a
    SIGKILLed sharer.

    ``mp.Event`` guards its flag with a semaphore lock and every
    ``is_set()`` acquires it, so a child killed mid-check dies holding the
    lock, and the parent's own teardown ``set()`` then blocks forever.
    This flag is one shared byte, read and written without locking (a
    single aligned byte store is atomic). ``wait`` polls: fine for a
    once-per-run latch, wrong for anything high-frequency.

    Implements the surface the runtime uses of the real thing: ``is_set``
    / ``set`` / ``clear`` / ``wait(timeout)``. Picklable to ``spawn``
    children as a ``Process`` argument like any sharedctypes object."""

    _POLL_S = 0.05

    def __init__(self, ctx: Optional[Any] = None):
        if ctx is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
        self._flag = ctx.RawValue("b", 0)

    def is_set(self) -> bool:
        return self._flag.value != 0

    def set(self) -> None:
        self._flag.value = 1

    def clear(self) -> None:
        self._flag.value = 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not self.is_set():
            if deadline is None:
                time.sleep(self._POLL_S)
                continue
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            time.sleep(min(self._POLL_S, left))
        return True


def fold_restart_seed(seed: int, epoch: int) -> int:
    """Deterministic seed for restart epoch ``epoch`` of a child that
    was originally seeded with ``seed``. Epoch 0 is the first spawn and
    returns ``seed`` unchanged (bit-compatible with unsupervised runs)."""
    if epoch == 0:
        return int(seed)
    return int(seed + epoch * _SEED_FOLD_PRIME) % (2 ** 31 - 1)
