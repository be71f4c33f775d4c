"""Prioritized trajectory replay (paper §5.2.2, Ape-X / IMPACT hybrid),
``repro.core.replay``.

A circular host-side buffer of *completed trajectories*. Each stored
trajectory is one contiguous spec-described ``serde`` buffer (the layout
the JAX package stores, byte for byte): one compact allocation per item,
structure/dtype round-trip (lstm-state tuples included) for free, and
decode is zero-copy views into the stored bytes.

Sampling is proportional prioritization per Distributed Prioritized
Experience Replay: ``priority='pertd'`` draws items with probability
proportional to their stored priority (the V-trace advantage magnitude
of the last training pass, set on insert, updated after every replayed
step); ``priority='uniform'`` is the paper's §5.2.2 uniform mix.
``reuse_limit`` caps how many times one trajectory may be consumed in
total (the IMPACT-style K), after which the slot is retired.

The sample stream is numpy's ``default_rng(fold_replay_seed(seed,
learner_id))``, as in the JAX package, so the two draw the same indices.
Everything here stays on the host: ``sample``/``sample_items`` return
numpy trees; trajectories of torch tensors (on the card too) are copied
to the host on insert. ``mix_batches`` concatenates tensor leaves with
``torch.cat`` on the online batch's device.
"""
from __future__ import annotations

import collections
import math
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch.distributed import serde

PyTree = Any

# the fold prime shared with supervise.fold_restart_seed: replay RNG
# streams are (seed, learner_id)-deterministic, never the hardcoded
# default_rng(0) every replica used to share
_SEED_FOLD_PRIME = 1_000_003

PRIORITY_MODES = ("uniform", "pertd")


def fold_replay_seed(seed: int, learner_id: int) -> int:
    """Fold a learner id into the run seed (same discipline as
    ``supervise.fold_restart_seed``): learner 0 of a group — and the
    single-learner run — keeps the raw seed; every other replica gets
    its own deterministic stream."""
    if learner_id == 0:
        return seed
    return (seed + learner_id * _SEED_FOLD_PRIME) % (2 ** 31 - 1)


class _Slot:
    """One stored trajectory: the encoded serde buffer + sampling
    state. ``uid`` is a monotonically increasing insert id, so a
    priority update that arrives after the slot was overwritten (FIFO)
    or retired (reuse-exhausted) is dropped instead of retagging an
    unrelated trajectory."""

    __slots__ = ("buf", "uid", "version", "priority", "uses")

    def __init__(self, buf: bytes, uid: int, version: int,
                 priority: float, uses: int):
        self.buf = buf
        self.uid = uid
        self.version = version
        self.priority = priority
        self.uses = uses


class ReplaySample:
    """What ``sample_items`` hands back per draw: the decoded item plus
    the bookkeeping the learner needs to update the priority after the
    replayed step."""

    __slots__ = ("item", "uid", "priority", "version")

    def __init__(self, item: serde.TrajectoryItem, uid: int,
                 priority: float, version: int):
        self.item = item
        self.uid = uid
        self.priority = priority
        self.version = version


def _stack_trees(trees: List[PyTree]) -> PyTree:
    """np.stack a list of structurally identical trees (recursion
    mirroring serde's node kinds)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_stack_trees([t[i] for t in trees])
               for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    return np.stack([np.asarray(t) for t in trees])


def _host_tree(tree: PyTree) -> PyTree:
    """Every leaf as a numpy array (one device-to-host copy per leaf for
    tensors on the card)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_host_tree(v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _index_tree(tree: PyTree, i: int) -> PyTree:
    """tree[i] along the leading axis of every (host) leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_index_tree(v, i) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree[i]


def _tree_leading_dim(tree: PyTree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        for v in tree.values():
            n = _tree_leading_dim(v)
            if n:
                return n
        return 0
    if isinstance(tree, (list, tuple)):
        for v in tree:
            n = _tree_leading_dim(v)
            if n:
                return n
        return 0
    shape = getattr(tree, "shape", None)    # no copy for tensor leaves
    if shape is None:
        shape = np.asarray(tree).shape
    return shape[0] if shape else 0


class ReplayBuffer:
    """Circular prioritized trajectory replay (module docstring).

    Identity of the sample stream is ``(seed, learner_id)`` — pass
    ``seed`` (+ ``learner_id`` under a group) or an explicit ``rng``;
    there is deliberately no default generator, because a hardcoded one
    made every replica (and every run) draw identical indices.
    """

    def __init__(self, capacity: int,
                 rng: Optional[np.random.Generator] = None, *,
                 seed: Optional[int] = None, learner_id: int = 0,
                 reuse_limit: int = 0, priority: str = "pertd",
                 priority_eps: float = 1e-3):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if priority not in PRIORITY_MODES:
            raise ValueError(f"priority must be one of {PRIORITY_MODES}, "
                             f"got {priority!r}")
        if rng is None:
            if seed is None:
                raise ValueError(
                    "ReplayBuffer needs an explicit rng or seed: a "
                    "default generator would give every learner replica "
                    "the identical sample-index stream")
            rng = np.random.default_rng(fold_replay_seed(seed, learner_id))
        self.capacity = capacity
        self.reuse_limit = int(reuse_limit)
        self.priority_mode = priority
        self.priority_eps = float(priority_eps)
        self._rng = rng
        self._slots: List[Optional[_Slot]] = []
        self._next = 0
        self._live = 0
        self._next_uid = 0
        self._max_priority = 1.0
        # honest accounting (the satellite fix): everything that enters,
        # leaves, or is displaced around this buffer is counted
        self.added = 0
        self.sampled = 0
        self.displaced = 0
        self.evicted_fifo = 0
        self.evicted_exhausted = 0
        self.starved = 0
        self.staleness_hist: collections.Counter = collections.Counter()

    # ------------------------------------------------------------------
    # insert

    def add_item(self, item: serde.TrajectoryItem,
                 priority: Optional[float] = None, uses: int = 0) -> int:
        """Store one trajectory; returns its uid. ``priority=None``
        means "not yet trained on" — Ape-X's max-priority default, so a
        never-scored trajectory is sampled eagerly rather than starved.
        ``uses`` pre-counts consumptions (a trajectory that already had
        its online pass enters with ``uses=1``)."""
        if priority is None:
            priority = self._max_priority
        else:
            priority = float(priority)
            self._max_priority = max(self._max_priority, priority)
        if item.trace is not None:
            # replayed items must not re-enter the trace recorder's
            # lifecycle accounting; store them unstamped
            item = serde.TrajectoryItem(item.data, item.param_version,
                                        item.actor_id, item.produced_at)
        slot = _Slot(serde.encode_item(item), self._next_uid,
                     int(item.param_version), priority, int(uses))
        self._next_uid += 1
        if self.reuse_limit and slot.uses >= self.reuse_limit:
            # nothing left to consume; don't occupy a ring slot
            self.added += 1
            self.evicted_exhausted += 1
            return slot.uid
        if len(self._slots) < self.capacity:
            self._slots.append(slot)
        else:
            if self._slots[self._next] is not None:
                self.evicted_fifo += 1
                self._live -= 1
            self._slots[self._next] = slot
            self._next = (self._next + 1) % self.capacity
        self._live += 1
        self.added += 1
        return slot.uid

    def add_batch(self, traj_batch: PyTree, param_version: int = 0,
                  priority: Optional[float] = None) -> List[int]:
        """Split a batched trajectory pytree (leading batch dim) into
        per-env trajectories and store each — the sync driver's insert
        path. Handles lstm-state tuples etc. through the serde layout."""
        b = _tree_leading_dim(traj_batch)
        host = _host_tree(traj_batch)
        return [
            self.add_item(serde.TrajectoryItem(
                _index_tree(host, i), param_version, 0, 0.0),
                priority=priority)
            for i in range(b)
        ]

    def note_displaced(self, n: int) -> None:
        """Count trajectories a ``mix_batches`` call displaced from an
        online batch (they live in this buffer; their online pass was
        traded for replayed rows)."""
        self.displaced += int(n)

    # ------------------------------------------------------------------
    # sample

    def __len__(self) -> int:
        return self._live

    def num_sampleable(self) -> int:
        return self._live

    def _live_slots(self) -> List[_Slot]:
        return [s for s in self._slots if s is not None]

    def sampling_probs(self) -> Dict[int, float]:
        """uid -> draw probability under the current priorities (the
        testable core of the prioritization math)."""
        live = self._live_slots()
        if not live:
            return {}
        p = self._probs(live)
        return {s.uid: float(q) for s, q in zip(live, p)}

    def _probs(self, live: List[_Slot]) -> np.ndarray:
        if self.priority_mode == "uniform":
            return np.full(len(live), 1.0 / len(live))
        w = np.array([max(s.priority, 0.0) + self.priority_eps
                      for s in live], np.float64)
        return w / w.sum()

    def sample_items(self, n: int, version_now: Optional[int] = None
                     ) -> Optional[List[ReplaySample]]:
        """Draw ``n`` distinct trajectories (proportional or uniform);
        None when occupancy can't cover the request (the caller trains
        pure-online that round). Decoded leaves are host numpy views of
        the stored buffer — no device materialization here."""
        if n < 1:
            return []
        live = self._live_slots()
        if len(live) < n:
            self.starved += 1
            return None
        idx = self._rng.choice(len(live), size=n, replace=False,
                               p=self._probs(live))
        out = []
        for i in idx:
            s = live[int(i)]
            s.uses += 1
            self.sampled += 1
            if version_now is not None:
                self.staleness_hist[max(0, version_now - s.version)] += 1
            out.append(ReplaySample(serde.decode_item(s.buf), s.uid,
                                    s.priority, s.version))
        if self.reuse_limit:
            self._retire_exhausted()
        return out

    def sample(self, n: int) -> Optional[PyTree]:
        """Batch draw: ``n`` trajectories stacked along a fresh leading
        axis as host numpy (``np.stack``); None under occupancy."""
        samples = self.sample_items(n)
        if samples is None:
            return None
        return _stack_trees([s.item.data for s in samples])

    def _retire_exhausted(self) -> None:
        for j, s in enumerate(self._slots):
            if s is not None and s.uses >= self.reuse_limit:
                self._slots[j] = None
                self._live -= 1
                self.evicted_exhausted += 1

    # ------------------------------------------------------------------
    # priorities

    def update_priorities(self, uids: List[int], priorities) -> int:
        """Re-score trajectories after a replayed (or first online)
        pass; stale uids — already overwritten or retired — are
        silently skipped. Returns how many updates landed."""
        by_uid = {s.uid: s for s in self._slots if s is not None}
        hit = 0
        for uid, p in zip(uids, priorities):
            s = by_uid.get(int(uid))
            if s is None:
                continue
            s.priority = float(p)
            self._max_priority = max(self._max_priority, s.priority)
            hit += 1
        return hit

    # ------------------------------------------------------------------
    # telemetry

    def priority_histogram(self) -> Dict[int, int]:
        """log2-bucketed histogram of live priorities (bucket k counts
        priorities in [2^k, 2^(k+1)))."""
        hist: collections.Counter = collections.Counter()
        for s in self._slots:
            if s is not None:
                hist[int(math.floor(math.log2(max(s.priority,
                                                  self.priority_eps))))] += 1
        return dict(sorted(hist.items()))

    def snapshot(self) -> Dict[str, Any]:
        stale = dict(sorted(self.staleness_hist.items()))
        n_stale = sum(stale.values())
        return {
            "capacity": self.capacity,
            "occupancy": self._live,
            "added": self.added,
            "sampled": self.sampled,
            "displaced": self.displaced,
            "evicted_fifo": self.evicted_fifo,
            "evicted_exhausted": self.evicted_exhausted,
            "starved": self.starved,
            "reuse_limit": self.reuse_limit,
            "priority_mode": self.priority_mode,
            "priority_hist": self.priority_histogram(),
            "staleness": {
                "hist": stale,
                "mean": (sum(k * v for k, v in stale.items()) / n_stale
                         if n_stale else 0.0),
                "max": max(stale) if stale else 0,
                "measured": n_stale,
            },
        }


# ---------------------------------------------------------------------------
# batch mixing


def plan_mix(num_fresh: int, max_total: int, fraction: float,
             available: int) -> int:
    """How many replayed trajectories to add to ``num_fresh`` online
    ones: the largest power-of-two total batch <= ``max_total`` whose
    replayed share ``total - num_fresh`` stays within ``round(fraction
    * total)`` and within the buffer's ``available`` stock. Returns the
    replayed count (0 = train pure online).

    This is the learner-side *top-up* shape of the paper's 50% mix:
    fresh consumption per update shrinks by (1 - fraction) while the
    trained batch stays bucket-sized — that is where the
    frames-to-return win comes from."""
    if num_fresh < 1 or fraction <= 0.0 or available < 1:
        return 0
    best = 0
    total = 1
    while total < num_fresh:
        total *= 2
    while total <= max_total:
        n_rep = total - num_fresh
        if 0 < n_rep <= min(int(round(fraction * total)), available):
            best = n_rep
        total *= 2
    return best


def mix_batches(online: PyTree, replayed: Optional[PyTree],
                replay_fraction: float,
                buffer: Optional[ReplayBuffer] = None) -> PyTree:
    """Replace the first ``replay_fraction`` of the online batch with
    replayed trajectories (paper: 50% from replay). Host numpy batches
    stay host numpy (np.concatenate); tensor leaves concatenate with
    ``torch.cat`` on the online leaf's device, the replayed rows moved
    there first. The ``k`` displaced online trajectories are counted into
    ``buffer`` (``replay.displaced``) — they were stored there by the
    caller's ``add_batch`` and get their training pass via a later
    sample, so frame accounting stays honest."""
    if replayed is None or replay_fraction <= 0:
        return online
    b = _tree_leading_dim(online)
    n_rep = _tree_leading_dim(replayed)
    k = min(int(round(b * replay_fraction)), n_rep)
    if k == 0:
        return online
    if buffer is not None:
        buffer.note_displaced(k)

    def cat(o, r):
        if isinstance(o, np.ndarray) and isinstance(r, np.ndarray):
            return np.concatenate([r[:k], o[k:]], axis=0)
        rows = torch.as_tensor(r[:k]).to(o.device, non_blocking=True)
        return torch.cat([rows, o[k:]], dim=0)

    def walk(o, r):
        if o is None:
            return None
        if isinstance(o, dict):
            return {key: walk(o[key], r[key]) for key in o}
        if isinstance(o, (list, tuple)):
            out = [walk(x, y) for x, y in zip(o, r)]
            return tuple(out) if isinstance(o, tuple) else out
        return cat(o, r)

    return walk(online, replayed)
