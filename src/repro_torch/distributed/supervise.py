"""Restart seeding (``repro.distributed.supervise.fold_restart_seed``).
The ``Supervisor`` itself is not ported yet (ROADMAP.md, Queue 1 item
13)."""
from __future__ import annotations

_SEED_FOLD_PRIME = 1_000_003


def fold_restart_seed(seed: int, epoch: int) -> int:
    """Deterministic seed for restart epoch ``epoch`` of a child that
    was originally seeded with ``seed``. Epoch 0 is the first spawn and
    returns ``seed`` unchanged (bit-compatible with unsupervised runs)."""
    if epoch == 0:
        return int(seed)
    return int(seed + epoch * _SEED_FOLD_PRIME) % (2 ** 31 - 1)
