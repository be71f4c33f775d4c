"""What flows through a transport (``repro.distributed.serde``'s
``TrajectoryItem``). Encoding items into byte buffers, and the wire
codecs, come with the process and socket transports (ROADMAP.md, Queue 1
item 10)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

PyTree = Any


@dataclasses.dataclass
class TrajectoryItem:
    """The trajectory tree plus the provenance needed for measured lag and
    per-actor accounting.

    ``host`` holds the leaves the learner reads on the host (``rewards``
    and ``done``, for the episode returns) as numpy arrays, copied by the
    actor while it finished the trajectory, so the learner's thread never
    waits on the device for them; None when ``data`` is on the host
    already. ``trace`` is the flight recorder's stamp dict (None: not
    sampled)."""
    data: PyTree
    param_version: int
    actor_id: int
    produced_at: float
    trace: Optional[Dict[str, float]] = None
    host: Optional[Dict[str, np.ndarray]] = None
