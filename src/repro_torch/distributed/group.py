"""Sharded multi-learner training (``repro.distributed.group``): a group
of N learner worker processes, each owning a disjoint shard of the actor
slots, exchanging gradients over the framed channel (paper §3's *several
learners, each owning a shard of actors*, in the data-parallel form
TorchBeast and IMPACT use: every learner holds a full parameter replica,
backward passes run on the local shard's trajectories, and the replicas
stay identical by applying the exchanged mean gradient).

Topology (one machine; on the card every worker opens its own CUDA
context on the same device)::

     actors 0..a-1          actors a..n-1          (global slot ids: an
        |  shard 0             |  shard 1           actor's seed does not
        v                      v                    depend on the shards)
    +-----------+         +-----------+
    | learner 0 |         | learner 1 |   per-learner transport,
    | Transport |         | Transport |   dynamic batching, telemetry
    |  Learner  |         |  Learner  |
    +-----+-----+         +-----+-----+
          |   grads (KIND_GRAD frames)
          +<------------------>+          synchronous all-reduce over
          |   mean + version       one CRC-framed TCP channel
          v (KIND_GRAD_MEAN)
     learner 0 (the hub) numbers the rounds; every learner's
     ParameterStore publishes at that version, so all actors observe ONE
     monotonic version stream.

The exchange is *synchronous with a stale-grad drop rule*: the hub waits
for every live learner's round-t contribution, but never longer than
``stale_after_s``; past the deadline it reduces over what arrived, and a
contribution landing after its round was reduced is dropped (counted,
never averaged). The laggard still receives and applies every broadcast
mean in order, so its replica follows the group's parameter trajectory.
A learner whose connection dies leaves the expected set.

The frames, the handshake and the payloads are the JAX package's: a port
spoke and a JAX hub (or the reverse) exchange the same bytes. Workers are
spawned, never forked (the parent may hold a CUDA context), and on the
card the parent builds the kernels before it spawns, so every worker only
loads the built library. A worker's kernel launch counters come back with
its result (``run_group_training(kernel_counts=...)``), not in the
telemetry, whose key set is the JAX package's.

With ``obs.metrics_port`` the parent serves one ``/metrics`` for the whole
group: the ``merge_telemetry`` of the snapshots the workers ship up their
pipes, each learner's under a ``learner="k"`` label.

Supervised (``run_group_training(supervise=True)``), a dead spoke is
respawned and catches up from the hub's replayed means, and a dead hub
fails over to the lowest live learner (``ResilientExchange``). Not
ported yet: the SPMD learner (``CollectiveExchange``, ROADMAP.md Queue 1
item 15C), which raises, naming the item.
"""
from __future__ import annotations

import collections
import json
import multiprocessing as mp
import socket
import sys
import threading
import time
import traceback
import zlib
from multiprocessing import connection as mp_connection
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed import serde
from repro_torch.distributed.socket_transport import (CTRL_BYE,
                                                      CTRL_REFUSED,
                                                      CTRL_STOP,
                                                      Disconnected,
                                                      FrameChannel,
                                                      KIND_CTRL, KIND_GRAD,
                                                      KIND_GRAD_MEAN,
                                                      KIND_HELLO)
from repro_torch.distributed.supervise import (KillSafeEvent, RestartPolicy,
                                               Supervisor,
                                               fold_restart_seed)

PyTree = Any
Address = Tuple[str, int]

# how many reduced rounds the hub keeps for replay to late-registering
# spokes (a spoke that dialed after its round was reduced still needs the
# mean to stay on the group's parameter trajectory)
MEAN_HISTORY = 64

# how long the parent waits for its workers to exit after the last
# result (or a failure) before it terminates them
_JOIN_TIMEOUT_S = 60.0


def shard_slots(num_actors: int, num_learners: int
                ) -> List[Tuple[int, int]]:
    """Split ``num_actors`` global slots into ``num_learners``
    contiguous shards: [(base, count), ...]. The remainder goes to the
    first learners, and every learner gets at least one slot."""
    if num_learners < 1:
        raise ValueError(f"num_learners must be >= 1, got {num_learners}")
    if num_actors < num_learners:
        raise ValueError(f"need at least one actor per learner: "
                         f"{num_actors} actors < {num_learners} learners")
    base_count, extra = divmod(num_actors, num_learners)
    shards, base = [], 0
    for k in range(num_learners):
        count = base_count + (1 if k < extra else 0)
        shards.append((base, count))
        base += count
    return shards


def params_digest(host_tree: PyTree) -> int:
    """``zlib.crc32`` of ``serde.encode_tree`` of a host numpy tree in the
    JAX layout (``params.to_jax``): equal parameters give the JAX
    package's digest."""
    return zlib.crc32(serde.encode_tree(host_tree))


# ---------------------------------------------------------------------------
# gradient exchange


class GradientExchange:
    """What sits between a ``Learner``'s backward pass and its optimizer:
    ``allreduce(leaves, round_idx)`` takes the local gradient leaves
    (numpy, flatten order) and returns the group-mean leaves plus the
    *delegated publish version* for the round, or None when the group is
    shutting down."""

    learner_id: int = 0
    num_learners: int = 1

    def allreduce(self, leaves: List[np.ndarray], round_idx: int
                  ) -> Optional[Tuple[List[np.ndarray], int]]:
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__,
                "learner_id": self.learner_id,
                "num_learners": self.num_learners}

    def close(self) -> None:
        pass


class NullExchange(GradientExchange):
    """The one-learner exchange: the mean of one gradient is itself, and
    the delegated version is round + 1."""

    def __init__(self):
        self.rounds = 0

    def allreduce(self, leaves, round_idx):
        self.rounds += 1
        return list(leaves), round_idx + 1

    def snapshot(self):
        snap = super().snapshot()
        snap["rounds"] = self.rounds
        return snap


def _mean_leaves(contribs: Dict[int, List[np.ndarray]]
                 ) -> List[np.ndarray]:
    """Element-wise mean over per-learner leaf lists, accumulated in a
    fixed (sorted-by-learner) order so the result is deterministic."""
    order = sorted(contribs)
    n = len(order)
    out = []
    for i, first in enumerate(contribs[order[0]]):
        acc = np.array(first, dtype=first.dtype, copy=True)
        for k in order[1:]:
            acc += contribs[k][i]
        if np.issubdtype(acc.dtype, np.floating):
            acc /= acc.dtype.type(n)
        out.append(acc)
    return out


class GradHub(GradientExchange):
    """The designated publisher's side of the exchange (learner 0): an
    accept loop speaking the serde frame format. Spokes HELLO in with
    their learner id, ship ``KIND_GRAD`` frames per round, and receive the
    reduced ``KIND_GRAD_MEAN`` (which carries the round's delegated
    publish version). A flipped bit in a gradient frame is a loud
    ``SerdeError``, never a silently corrupted update.

    ``hub_id`` is this hub's own learner id (nonzero after a failover
    promotes a former spoke). ``start_round`` seeds the stale-round
    watermark: a resumed group at version v, or a hub taking over at
    round v, passes ``v - 1``, so round v is reducible and nothing older.
    ``dead`` pre-marks learner ids known lost (the failed-over hub) so
    rounds never wait on them; a reborn id that re-registers is
    un-marked. ``hold_disconnected`` (supervised runs) keeps a
    disconnected spoke in the round's wait set until the stale deadline
    instead of excluding it: under supervision a vanished spoke is being
    respawned, and a hub that raced through the remaining rounds alone
    would finish and unbind before the reborn spoke redials."""

    def __init__(self, num_learners: int, *,
                 listen: Address = ("127.0.0.1", 0),
                 stale_after_s: float = 180.0,
                 stop_event: Optional[Any] = None,
                 wire_codec: str = serde.DEFAULT_CODEC,
                 hub_id: int = 0,
                 start_round: int = -1,
                 dead: Any = (),
                 hold_disconnected: bool = False):
        if num_learners < 1:
            raise ValueError("num_learners must be >= 1")
        if not 0 <= hub_id < num_learners:
            raise ValueError(f"hub_id must be in [0, {num_learners}), "
                             f"got {hub_id}")
        self.learner_id = self.hub_id = int(hub_id)
        self.num_learners = num_learners
        self.stale_after_s = stale_after_s
        # KIND_GRAD_MEAN broadcasts are encoded with this; spokes must
        # announce the same codec in their HELLO or be refused: a
        # mixed-codec group would average quantization error unevenly
        self.wire_codec = serde.check_codec(wire_codec)
        self._ext_stop = stop_event
        self._stop = threading.Event()
        self._cond = threading.Condition()
        # round -> learner_id -> leaves (the hub's own included)
        self._contrib: Dict[int, Dict[int, List[np.ndarray]]] = {}
        self._done_round = int(start_round)
        self._spokes: Dict[int, FrameChannel] = {}
        self._dead: set = {int(d) for d in dead} - {self.hub_id}
        self._hold_disconnected = bool(hold_disconnected)
        self._mean_history: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()
        # telemetry
        self.rounds = 0
        self.stale_dropped = 0
        self.partial_rounds = 0     # rounds reduced past the deadline
        self.reduce_wait_s = 0.0
        self.bytes_in = 0
        self.bytes_out = 0

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(tuple(listen))
        self._lsock.listen(max(4, num_learners))
        self._lsock.settimeout(0.2)
        self.address: Address = self._lsock.getsockname()[:2]
        self._threads: List[threading.Thread] = []
        acceptor = threading.Thread(target=self._accept_loop,
                                    name="grad-hub-accept", daemon=True)
        acceptor.start()
        self._threads.append(acceptor)

    # ------------------------------------------------------------------

    def _stopped(self) -> bool:
        return self._stop.is_set() or (
            self._ext_stop is not None and self._ext_stop.is_set())

    def _accept_loop(self) -> None:
        while not self._stopped():
            try:
                sock, _peer = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._spoke_entry, args=(sock,),
                                 name="grad-hub-spoke", daemon=True)
            t.start()
            self._threads.append(t)

    def _spoke_entry(self, sock: socket.socket) -> None:
        chan = FrameChannel(sock)
        deadline = time.monotonic() + 10.0
        try:
            kind, _stream, payload = chan.recv(
                stop=lambda: self._stopped() or
                time.monotonic() > deadline)
            hello = json.loads(payload.decode("utf-8"))
            lid = int(hello["learner_id"])
            if kind != KIND_HELLO or hello.get("role") != "learner" or \
                    not 0 <= lid < self.num_learners or \
                    lid == self.hub_id:
                chan.close()
                return
            spoke_codec = hello.get("wire_codec", serde.DEFAULT_CODEC)
            if spoke_codec != self.wire_codec:
                # refuse with a named reason: the spoke raises
                # CodecMismatchError, not a generic "hub connection lost"
                msg = (CTRL_REFUSED + b" wire_codec mismatch: hub "
                       b"speaks " + self.wire_codec.encode() +
                       b", spoke announced " + str(spoke_codec).encode())
                bye = time.monotonic() + 5.0
                chan.send(KIND_CTRL, lid, msg,
                          stop=lambda: self._stopped() or
                          time.monotonic() > bye)
                chan.close()
                return
        except (Disconnected, serde.SerdeError, ValueError, KeyError):
            chan.close()
            return
        with self._cond:
            old = self._spokes.get(lid)
            if old is not None:
                old.close()
            self._spokes[lid] = chan
            self._dead.discard(lid)
            # replay the reduced rounds the spoke missed: it must apply
            # every mean in order to stay on the group's trajectory
            history = list(self._mean_history.items())
        for _rnd, buf in history:
            chan.send(KIND_GRAD_MEAN, lid, buf, stop=self._stopped)
        self._spoke_reader(lid, chan)

    def _spoke_reader(self, lid: int, chan: FrameChannel) -> None:
        while not self._stopped():
            try:
                kind, _stream, payload = chan.recv(stop=self._stopped)
            except (Disconnected, serde.SerdeError):
                break
            if kind == KIND_CTRL and payload == CTRL_BYE:
                break
            if kind != KIND_GRAD:
                continue
            try:
                leaves, meta = serde.decode_grads(payload)
            except serde.SerdeError:
                break                   # desynced/corrupt: drop the conn
            rnd = int(meta.get("round", -1))
            with self._cond:
                self.bytes_in += len(payload)
                if rnd <= self._done_round:
                    # the stale-grad drop rule: this round was already
                    # reduced; averaging it in now would fork the replicas
                    self.stale_dropped += 1
                else:
                    self._contrib.setdefault(rnd, {})[lid] = leaves
                    self._cond.notify_all()
        chan.close()
        with self._cond:
            if self._spokes.get(lid) is chan:
                # unsupervised, a vanished spoke is dead: rounds stop
                # waiting for it. Supervised, it is being respawned: it
                # stays in the wait set (the stale deadline still bounds
                # every round), so the reborn spoke finds the hub alive,
                # replays the means it missed and rejoins
                if not self._hold_disconnected:
                    self._dead.add(lid)
                self._cond.notify_all()

    # ------------------------------------------------------------------

    def allreduce(self, leaves, round_idx):
        t0 = time.monotonic()
        deadline = t0 + self.stale_after_s
        with self._cond:
            self._contrib.setdefault(round_idx, {})[self.hub_id] = \
                list(leaves)
            while True:
                got = self._contrib.get(round_idx, {})
                expected = self.num_learners - len(self._dead)
                if len(got) >= expected:
                    break
                if self._stopped():
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # reduce over what arrived: the hub's own contribution
                    # is always there, so the mean is over >= 1 learner
                    self.partial_rounds += 1
                    break
                self._cond.wait(min(0.2, remaining))
            got = self._contrib.pop(round_idx)
            # prune older rounds a laggard may have half-delivered
            for rnd in [r for r in self._contrib if r <= round_idx]:
                self.stale_dropped += len(self._contrib.pop(rnd))
            self._done_round = round_idx
        mean = _mean_leaves(got)
        version = round_idx + 1
        buf = serde.encode_grads(mean, round_idx=round_idx,
                                 learner_id=self.hub_id, version=version,
                                 codec=self.wire_codec)
        if self.wire_codec != "none":
            # lossy codec: spokes apply the DECODED broadcast, so the hub
            # applies the same round-tripped values, or the replicas fork
            mean, _meta = serde.decode_grads(buf, copy=True)
        with self._cond:
            # history before the spoke snapshot, under one lock: a spoke
            # registering concurrently either lands in this snapshot (gets
            # the broadcast) or registers after the insert (gets the
            # replay)
            self._mean_history[round_idx] = buf
            while len(self._mean_history) > MEAN_HISTORY:
                self._mean_history.popitem(last=False)
            spokes = dict(self._spokes)
        for lid, chan in sorted(spokes.items()):
            # bounded send: a wedged spoke must not stall the group's
            # round; past the deadline the channel is closed, its reader
            # marks the spoke dead, and later rounds stop expecting it
            send_deadline = time.monotonic() + 5.0
            if chan.send(KIND_GRAD_MEAN, lid, buf,
                         stop=lambda d=send_deadline:
                         self._stopped() or time.monotonic() > d):
                self.bytes_out += len(buf)
            elif not self._stopped():
                chan.close()
        self.rounds += 1
        self.reduce_wait_s += time.monotonic() - t0
        return mean, version

    # ------------------------------------------------------------------

    def snapshot(self):
        snap = super().snapshot()
        with self._cond:
            snap.update({
                "hub_id": self.hub_id,
                "rounds": self.rounds,
                "wire_codec": self.wire_codec,
                "stale_dropped": self.stale_dropped,
                "partial_rounds": self.partial_rounds,
                "dead_learners": sorted(self._dead),
                "reduce_wait_ms_mean": (1e3 * self.reduce_wait_s /
                                        self.rounds if self.rounds
                                        else 0.0),
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
            })
        return snap

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        with self._cond:
            spokes = dict(self._spokes)
            self._cond.notify_all()
        for _lid, chan in spokes.items():
            # unblock spokes waiting on a mean that will never come
            deadline = time.monotonic() + 2.0
            chan.send(KIND_CTRL, 0, CTRL_STOP,
                      stop=lambda d=deadline: time.monotonic() > d)
            chan.close()
        try:
            self._lsock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=5.0)


class SpokeExchange(GradientExchange):
    """A non-publisher learner's side: dial the hub, ship local gradients,
    block for the round's mean (the learner applies nothing it did not
    receive from the hub, which keeps the replicas bit identical)."""

    def __init__(self, address: Address, learner_id: int,
                 num_learners: int, *,
                 stop_event: Optional[Any] = None,
                 dial_timeout_s: float = 120.0,
                 reply_timeout_s: float = 600.0,
                 wire_codec: str = serde.DEFAULT_CODEC):
        if not 0 < learner_id < num_learners:
            raise ValueError(f"spoke learner_id must be in "
                             f"(0, {num_learners}), got {learner_id}")
        self.learner_id = learner_id
        self.num_learners = num_learners
        self.wire_codec = serde.check_codec(wire_codec)
        self._addr = tuple(address)
        self._ext_stop = stop_event
        self._stop = threading.Event()
        self._reply_timeout_s = reply_timeout_s
        self._cond = threading.Condition()
        self._means: Dict[int, Tuple[List[np.ndarray], int]] = {}
        self._hub_gone = False
        self._refused: Optional[str] = None
        # telemetry
        self.rounds = 0
        self.reduce_wait_s = 0.0
        self.bytes_in = 0
        self.bytes_out = 0

        deadline = time.monotonic() + dial_timeout_s
        delay = 0.05
        chan = None
        while not self._stopped():
            try:
                sock = socket.create_connection(self._addr, timeout=1.0)
                chan = FrameChannel(sock)
                hello = json.dumps({"role": "learner",
                                    "learner_id": learner_id,
                                    "wire_codec": self.wire_codec}
                                   ).encode()
                if chan.send(KIND_HELLO, learner_id, hello,
                             stop=self._stopped):
                    break
                chan.close()
                chan = None
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"could not reach gradient-exchange hub at "
                    f"{self._addr[0]}:{self._addr[1]} within "
                    f"{dial_timeout_s:.0f}s")
            time.sleep(delay)
            delay = min(delay * 2, 1.0)
        if chan is None:
            raise RuntimeError("stopped before the gradient-exchange "
                               "hub handshake completed")
        self._chan = chan
        self._reader = threading.Thread(target=self._read_loop,
                                        name="grad-spoke-reader",
                                        daemon=True)
        self._reader.start()

    # ------------------------------------------------------------------

    def _stopped(self) -> bool:
        return self._stop.is_set() or (
            self._ext_stop is not None and self._ext_stop.is_set())

    def _read_loop(self) -> None:
        while not self._stopped():
            try:
                kind, _stream, payload = self._chan.recv(
                    stop=self._stopped)
            except (Disconnected, serde.SerdeError):
                break
            if kind == KIND_CTRL and payload == CTRL_STOP:
                break
            if kind == KIND_CTRL and payload.startswith(CTRL_REFUSED):
                with self._cond:
                    self._refused = (
                        payload[len(CTRL_REFUSED):].strip().decode(
                            "utf-8", "replace") or "hub refused spoke")
                break
            if kind != KIND_GRAD_MEAN:
                continue
            try:
                leaves, meta = serde.decode_grads(payload, copy=True)
            except serde.SerdeError:
                break
            with self._cond:
                self.bytes_in += len(payload)
                self._means[int(meta["round"])] = (
                    leaves, int(meta["version"]))
                self._cond.notify_all()
        with self._cond:
            self._hub_gone = True
            self._cond.notify_all()

    def abort_wait(self) -> None:
        """Mark the hub lost from the outside (the supervision layer
        learned of its death before TCP did): wakes a blocked
        ``allreduce`` so failover can proceed instead of riding out the
        reply timeout."""
        with self._cond:
            self._hub_gone = True
            self._cond.notify_all()

    # ------------------------------------------------------------------

    def allreduce(self, leaves, round_idx):
        t0 = time.monotonic()
        buf = serde.encode_grads(list(leaves), round_idx=round_idx,
                                 learner_id=self.learner_id,
                                 codec=self.wire_codec)
        sent = self._chan.send(KIND_GRAD, self.learner_id, buf,
                               stop=self._stopped)
        # a failed send is not fatal by itself: the hub's stale rule
        # reduces without us and still broadcasts the mean we need
        if sent:
            self.bytes_out += len(buf)
        deadline = t0 + self._reply_timeout_s
        with self._cond:
            while round_idx not in self._means:
                if self._stopped():
                    return None
                if self._refused is not None:
                    raise serde.CodecMismatchError(
                        f"gradient-exchange hub refused learner "
                        f"{self.learner_id}: {self._refused}")
                if self._hub_gone:
                    raise RuntimeError(
                        "gradient-exchange hub connection lost "
                        f"(learner {self.learner_id}, round {round_idx})")
                if any(r > round_idx for r in self._means):
                    # a later round's mean arrived without ours: the hub
                    # reduced past us and our round fell out of its replay
                    # history. A replayed backlog can deliver briefly out
                    # of order, so give in-flight frames a short grace,
                    # then fail fast instead of riding out the timeout
                    deadline = min(deadline, time.monotonic() + 10.0)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"no gradient mean for round {round_idx} within "
                        f"{self._reply_timeout_s:.0f}s (learner "
                        f"{self.learner_id}"
                        + (", later rounds HAVE arrived — the round "
                           "was evicted from the hub's replay history"
                           if any(r > round_idx for r in self._means)
                           else "") + ")")
                self._cond.wait(min(0.2, remaining))
            mean, version = self._means.pop(round_idx)
            # prune means for rounds we will never request again
            for rnd in [r for r in self._means if r < round_idx]:
                del self._means[rnd]
        self.rounds += 1
        self.reduce_wait_s += time.monotonic() - t0
        return mean, version

    # ------------------------------------------------------------------

    def snapshot(self):
        snap = super().snapshot()
        with self._cond:
            snap.update({
                "rounds": self.rounds,
                "wire_codec": self.wire_codec,
                "hub": list(self._addr),
                "hub_gone": self._hub_gone,
                "reduce_wait_ms_mean": (1e3 * self.reduce_wait_s /
                                        self.rounds if self.rounds
                                        else 0.0),
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
            })
        return snap

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        if not self._chan.dead:
            deadline = time.monotonic() + 2.0
            self._chan.send(KIND_CTRL, 0, CTRL_BYE,
                            stop=lambda: time.monotonic() > deadline)
        self._chan.close()
        with self._cond:
            self._cond.notify_all()
        self._reader.join(timeout=5.0)


class ResilientExchange(GradientExchange):
    """The self-healing wrapper a *supervised* group worker puts around
    its exchange. The bare ``SpokeExchange`` keeps its fail-fast
    contract (hub gone => RuntimeError) — this class is where that
    error becomes a recoverable event:

    * ``allreduce`` catches the hub-gone/timeout error and blocks
      (bounded by ``failover_deadline_s``) for the parent's failover
      verdict, delivered through the worker's control thread via
      ``begin_failover`` / ``set_hub``.
    * If THIS learner is the promoted one, it builds a new ``GradHub``
      continuing at ``start_round = round_idx - 1`` (so the in-flight
      round reduces on the new hub) with the dead hub pre-marked, and
      reports the address via ``on_promoted`` (the worker ships it up
      the pipe; the parent relays it to the surviving spokes).
    * Otherwise it redials the relayed address as a fresh spoke and
      retries the same round — the round number never skips, so the
      group's monotonic version stream continues across the failover.
    * Past the deadline it degrades to *solo* training: the mean of a
      group of one, version ``round + 1`` continuity, and a loud
      ``degraded_solo`` telemetry flag (``/healthz`` shows degraded).

    Codec mismatches still raise (that is a config bug, not a fault).
    """

    def __init__(self, inner: GradientExchange, learner_id: int,
                 num_learners: int, *,
                 stop_event: Optional[Any] = None,
                 failover_deadline_s: float = 20.0,
                 stale_after_s: float = 180.0,
                 wire_codec: str = serde.DEFAULT_CODEC,
                 on_promoted=None,
                 initial_dead: Any = ()):
        self.learner_id = learner_id
        self.num_learners = num_learners
        self.wire_codec = serde.check_codec(wire_codec)
        self._inner = inner
        self._ext_stop = stop_event
        self._stop = threading.Event()
        self._cond = threading.Condition()
        self._failover_deadline_s = failover_deadline_s
        self._stale_after_s = stale_after_s
        self._on_promoted = on_promoted
        self._dead_ids = {int(d) for d in initial_dead}
        self._promote = False
        self._new_hub: Optional[Address] = None
        self.failovers = 0
        self.degraded_solo = False
        self.solo_rounds = 0

    # ------------------------------------------------------------------

    def _stopped(self) -> bool:
        return self._stop.is_set() or (
            self._ext_stop is not None and self._ext_stop.is_set())

    # control plane — called from the worker's parent-pipe reader thread

    def begin_failover(self, new_hub_id: int,
                       dead_id: Optional[int] = None) -> None:
        """The parent named a new hub. Arm the swap and wake a blocked
        allreduce (the inner spoke may not have noticed the death)."""
        with self._cond:
            if dead_id is not None:
                self._dead_ids.add(int(dead_id))
            self._promote = int(new_hub_id) == self.learner_id
            self._new_hub = None
            self._cond.notify_all()
        poke = getattr(self._inner, "abort_wait", None)
        if poke is not None:
            poke()

    def set_hub(self, addr: Address) -> None:
        """The promoted hub's address arrived (relayed by the parent)."""
        with self._cond:
            self._new_hub = tuple(addr)
            self._cond.notify_all()

    # ------------------------------------------------------------------

    def allreduce(self, leaves, round_idx):
        while not self._stopped():
            if self.degraded_solo:
                # the mean of a group of one; version stream continues
                self.solo_rounds += 1
                return list(leaves), round_idx + 1
            inner = self._inner
            try:
                out = inner.allreduce(leaves, round_idx)
            except serde.CodecMismatchError:
                raise               # config bug: never retried
            except RuntimeError:
                out = None          # hub gone / round evicted / timeout
                if self._stopped():
                    return None
            else:
                if out is not None:
                    return out
                if self._stopped():
                    return None
            if not self._swap(round_idx):
                if self._stopped():
                    return None
                self.degraded_solo = True
        return None

    def _swap(self, round_idx: int) -> bool:
        """Wait (bounded) for the failover verdict, then become the new
        hub or redial it. False => deadline passed, caller degrades."""
        try:
            self._inner.close()
        except Exception:
            pass
        deadline = time.monotonic() + self._failover_deadline_s
        while not self._stopped():
            with self._cond:
                promote, addr = self._promote, self._new_hub
                if not promote and addr is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cond.wait(min(0.2, remaining))
                    continue
                self._promote = False
                self._new_hub = None
                dead = set(self._dead_ids)
            if promote:
                # ResilientExchange only exists in supervised runs, so a
                # promoted hub always holds disconnected spokes for the
                # respawner rather than writing them off
                hub = GradHub(self.num_learners, hub_id=self.learner_id,
                              start_round=round_idx - 1,
                              stale_after_s=self._stale_after_s,
                              stop_event=self._ext_stop,
                              wire_codec=self.wire_codec,
                              dead=dead, hold_disconnected=True)
                self._inner = hub
                self.failovers += 1
                if self._on_promoted is not None:
                    self._on_promoted(hub.address)
                return True
            try:
                spoke = SpokeExchange(
                    tuple(addr), self.learner_id, self.num_learners,
                    stop_event=self._ext_stop,
                    dial_timeout_s=max(1.0,
                                       deadline - time.monotonic()),
                    reply_timeout_s=max(60.0, 4 * self._stale_after_s),
                    wire_codec=self.wire_codec)
            except RuntimeError:
                continue            # not up yet (or died again): wait on
            self._inner = spoke
            self.failovers += 1
            return True
        return False

    # ------------------------------------------------------------------

    def snapshot(self):
        snap = self._inner.snapshot()
        snap.update({
            "resilient": True,
            "learner_id": self.learner_id,
            "failovers": self.failovers,
            "degraded_solo": self.degraded_solo,
            "solo_rounds": self.solo_rounds,
        })
        return snap

    def close(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._inner.close()


# ---------------------------------------------------------------------------
# merged telemetry


def merge_telemetry(per_learner: Dict[int, Dict[str, Any]], *,
                    publisher: int = 0,
                    group_extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Fold N per-learner telemetry snapshots into one group snapshot.

    Each learner's full snapshot survives untouched under
    ``learners.learner_<k>``, and the top level carries the aggregates:
    summed frames and actor counters, the merged lag histogram, the
    publisher's update counter and rates, and a ``group`` section with
    the exchange's health."""
    if not per_learner:
        raise ValueError("merge_telemetry needs at least one snapshot")
    pub = per_learner.get(publisher,
                          per_learner[min(per_learner)])
    lag_hist: collections.Counter = collections.Counter()
    frames = 0
    fps = 0.0
    stale = 0
    actors = {"num_actors": 0, "frames": 0, "trajectories": 0,
              "rejected": 0, "actor_fps": 0.0,
              "backend": pub.get("actors", {}).get("backend", "?"),
              "per_learner_trajectories": {}}
    for k, snap in sorted(per_learner.items()):
        frames += snap.get("frames_consumed", 0)
        fps += snap.get("frames_per_sec", 0.0)
        for lag, n in snap.get("lag", {}).get("hist", {}).items():
            lag_hist[int(lag)] += n
        stale += snap.get("exchange", {}).get("stale_dropped", 0)
        a = snap.get("actors", {})
        actors["num_actors"] += a.get("num_actors", 0)
        actors["frames"] += a.get("frames", 0)
        actors["trajectories"] += a.get("trajectories", 0)
        actors["rejected"] += a.get("rejected", 0)
        actors["actor_fps"] += a.get("actor_fps", 0.0)
        actors["per_learner_trajectories"][f"learner_{k}"] = \
            a.get("trajectories", 0)
    n_lags = sum(lag_hist.values())
    replay = _merge_replay(per_learner)
    out = {
        "group": {
            "num_learners": len(per_learner),
            "publisher": publisher,
            "exchange_backend": "hub_spoke",
            "stale_dropped": stale,
        },
        "learners": {f"learner_{k}": snap
                     for k, snap in sorted(per_learner.items())},
        "learner_updates": pub.get("learner_updates", 0),
        "frames_consumed": frames,
        "updates_per_sec": pub.get("updates_per_sec", 0.0),
        "frames_per_sec": fps,
        "param_version": max(s.get("param_version", 0)
                             for s in per_learner.values()),
        "lag": {
            "hist": dict(sorted(lag_hist.items())),
            "mean": (sum(k * v for k, v in lag_hist.items()) / n_lags
                     if n_lags else 0.0),
            "max": max(lag_hist) if lag_hist else 0,
            "measured": n_lags,
        },
        "actors": actors,
        "actor_mode": pub.get("actor_mode", "unroll"),
        "donate": pub.get("donate", True),
    }
    if replay is not None:
        out["replay"] = replay
    if group_extra:
        out["group"].update(group_extra)
    return out


def _merge_replay(per_learner: Dict[int, Dict[str, Any]]
                  ) -> Optional[Dict[str, Any]]:
    """Aggregate the per-learner ``replay`` sections (present only with
    replay on): counters and histograms sum across replicas, the reuse
    ratio is recomputed from the summed frame counts, and config echoes
    come from the first reporting learner."""
    snaps = [s["replay"] for _k, s in sorted(per_learner.items())
             if isinstance(s.get("replay"), dict)]
    if not snaps:
        return None
    first = snaps[0]
    out = {k: first.get(k) for k in
           ("capacity", "reuse_limit", "priority_mode", "fraction",
            "fresh_max", "target_period")}
    for k in ("occupancy", "added", "sampled", "displaced",
              "evicted_fifo", "evicted_exhausted", "starved",
              "frames_trained", "trained_frames_per_sec",
              "target_syncs"):
        out[k] = sum(s.get(k, 0) for s in snaps)
    for hk in ("priority_hist",):
        h: collections.Counter = collections.Counter()
        for s in snaps:
            for b, n in s.get(hk, {}).items():
                h[int(b)] += n
        out[hk] = dict(sorted(h.items()))
    stale: collections.Counter = collections.Counter()
    for s in snaps:
        for b, n in s.get("staleness", {}).get("hist", {}).items():
            stale[int(b)] += n
    n_stale = sum(stale.values())
    out["staleness"] = {
        "hist": dict(sorted(stale.items())),
        "mean": (sum(k * v for k, v in stale.items()) / n_stale
                 if n_stale else 0.0),
        "max": max(stale) if stale else 0,
        "measured": n_stale,
    }
    frames = sum(s.get("frames_consumed", 0) for s in per_learner.values())
    out["reuse_ratio"] = (out["frames_trained"] / frames if frames else 0.0)
    return out


class GroupTracker:
    """The group's merged episode-return history: per-learner (completion
    time, return) streams interleaved chronologically, with the
    ``completed`` / ``mean_return`` surface of ``MultiTracker``."""

    def __init__(self, timed_returns: List[Tuple[float, float]]):
        ordered = sorted(timed_returns, key=lambda p: p[0])
        self._completed = [r for _t, r in ordered]

    @property
    def completed(self) -> List[float]:
        return list(self._completed)

    def mean_return(self, last_n: int = 100) -> float:
        if not self._completed:
            return float("nan")
        return float(np.mean(self._completed[-last_n:]))


# ---------------------------------------------------------------------------
# learner worker (spawn target)


def _learner_worker(learner_id: int, conn, stop_event,
                    spec: Dict[str, Any]) -> None:
    """One learner worker process: build the exchange first (cheap, so
    the hub is listening and every spoke registered while the workers
    set up), then the worker's graph through ``runtime._setup``, run the
    ``Learner``, ship the results up the pipe. Exits through ``os._exit``
    with an honest code, after flushing its output."""
    import os

    status = 1
    try:
        num_learners = int(spec["num_learners"])
        wire_codec = spec.get("wire_codec", serde.DEFAULT_CODEC)
        supervise = bool(spec.get("supervise", False))
        hub_id = int(spec.get("hub_id", 0))
        resume = spec.get("resume")
        start_step = int(resume["version"]) if resume is not None else 0
        # publisher duty follows the hub (a promotion flips it mid-run)
        state = {"publisher": learner_id == hub_id}
        pend_dead: set = set()
        exchange = None

        def _build_hub(dead=()):
            return GradHub(num_learners, hub_id=learner_id,
                           start_round=start_step - 1,
                           stale_after_s=spec["stale_after_s"],
                           stop_event=stop_event, wire_codec=wire_codec,
                           dead=dead, hold_disconnected=supervise)

        if num_learners > 1 and start_step >= int(spec["steps"]):
            # resumed at its last version: no round is left, so no peer is
            # needed (a spoke would dial a hub that has already finished)
            exchange = NullExchange()
        elif num_learners > 1:
            if learner_id == hub_id:
                exchange = _build_hub()
                conn.send(("hub", list(exchange.address)))
            else:
                while exchange is None:
                    msg = conn.recv()   # the parent relays the address
                    if msg[0] == "failover" and supervise:
                        # the hub died before it ever bound: the parent
                        # re-elected before the start
                        if len(msg) > 2 and msg[2] is not None:
                            pend_dead.add(int(msg[2]))
                        if int(msg[1]) == learner_id:
                            hub_id = learner_id
                            state["publisher"] = True
                            exchange = _build_hub(dead=pend_dead)
                            conn.send(("hub", list(exchange.address)))
                        continue
                    if msg[0] != "hub" or msg[1] is None:
                        raise RuntimeError("no gradient-exchange hub "
                                           "address (hub worker failed?)")
                    exchange = SpokeExchange(
                        tuple(msg[1]), learner_id, num_learners,
                        stop_event=stop_event,
                        reply_timeout_s=max(600.0,
                                            4 * spec["stale_after_s"]),
                        wire_codec=wire_codec)
        # num_learners == 1: no exchange at all; the worker then runs the
        # fused train step run_async_training runs

        if supervise and isinstance(exchange, (GradHub, SpokeExchange)):
            def _on_promoted(addr):
                state["publisher"] = True
                try:
                    conn.send(("hub", list(addr)))
                except (OSError, BrokenPipeError):
                    pass

            resilient = ResilientExchange(
                exchange, learner_id, num_learners,
                stop_event=stop_event,
                failover_deadline_s=float(
                    spec.get("failover_deadline_s", 20.0)),
                stale_after_s=spec["stale_after_s"],
                wire_codec=wire_codec, on_promoted=_on_promoted,
                initial_dead=pend_dead)
            exchange = resilient

            def _control():
                # after the handshake the parent sends only failover
                # verdicts and relayed hub addresses; the main thread never
                # recv()s again, so this thread owns the pipe's read side
                while not stop_event.is_set():
                    try:
                        if not conn.poll(0.2):
                            continue
                        msg = conn.recv()
                    except (EOFError, OSError):
                        return
                    if msg[0] == "failover":
                        resilient.begin_failover(
                            int(msg[1]),
                            dead_id=(int(msg[2])
                                     if len(msg) > 2 and
                                     msg[2] is not None else None))
                    elif msg[0] == "hub" and msg[1] is not None:
                        resilient.set_hub(tuple(msg[1]))

            threading.Thread(target=_control, name="group-control",
                             daemon=True).start()

        import torch

        from repro_torch import params as params_lib
        from repro_torch.distributed import runtime
        from repro_torch.kernels import vtrace as vk

        torch.set_num_threads(int(spec["num_threads"]))
        device = torch.device(spec["device"])
        if device.type == "cuda":
            # as the CLIs' resolve_device: full float32 on the card
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        initial_params = initial_opt = None
        if resume is not None:
            # group resume: the checkpointed replica and optimizer state
            # at its published version, so the version stream continues
            initial_params = params_lib.from_jax(
                serde.decode_tree(resume["params"], copy=True)[0], device)
            initial_opt = params_lib.from_jax(
                serde.decode_tree(resume["opt"], copy=True)[0], device,
                requires_grad=False)

        base, count = spec["shards"][learner_id]
        listen_addrs = spec.get("listen_addrs")
        learner = runtime._setup(
            spec["env"], spec["icfg"], spec["num_envs"],
            num_actors=count,
            actor_backend=spec["actor_backend"],
            actor_mode=spec["actor_mode"],
            transport=spec["transport"],
            listen_addr=(tuple(listen_addrs[learner_id])
                         if listen_addrs else None),
            spawn_remote=spec["spawn_remote"],
            queue_capacity=spec["queue_capacity"],
            queue_policy=spec["queue_policy"],
            max_batch_trajs=spec["max_batch_trajs"],
            seed=spec["seed"], arch=spec["arch"],
            start_step=start_step, donate=spec["donate"],
            initial_params=initial_params,
            initial_opt_state=initial_opt,
            infer_flush_timeout_s=spec["infer_flush_timeout_s"],
            slot_base=base, learner_id=learner_id,
            num_learners=num_learners, exchange=exchange,
            peer_addrs=spec.get("peer_addrs"),
            wire_codec=wire_codec,
            vtrace_impl=spec.get("vtrace_impl", "auto"),
            supervise=supervise, device=device)

        tel_every = int(spec.get("telemetry_every", 0))
        tel_interval = float(spec.get("telemetry_interval_s", 0.0))
        # the publisher's replica stands for all: they are identical.
        # Every supervised worker keeps the cadence (a promotion may hand
        # it publisher duty mid-run)
        ckpt_every = (int(spec.get("ckpt_every", 0))
                      if supervise or learner_id == hub_id else 0)
        ckpt_full = bool(spec.get("ckpt_full", False))
        last_tel = [time.monotonic()]

        def on_update(step, params, _metrics, snapshot_fn):
            # step-counted sends drive the caller's log lines; time-based
            # ones keep its view fresh when a learner's rounds crawl
            due = tel_every and step % tel_every == 0
            if not due and tel_interval:
                due = time.monotonic() - last_tel[0] >= tel_interval
            if due:
                last_tel[0] = time.monotonic()
                try:
                    conn.send(("telemetry", snapshot_fn()))
                except (OSError, BrokenPipeError):
                    pass
            if ckpt_every and step % ckpt_every == 0 and \
                    state["publisher"]:
                host = learner._host_jax(params)
                try:
                    if ckpt_full:
                        # a group checkpoint: params + optimizer state +
                        # published version, what a respawned spoke or a
                        # resumed group starts from
                        conn.send(("ckpt", step, int(learner.store.version),
                                   serde.encode_tree(host),
                                   serde.encode_tree(
                                       learner.opt_state_host())))
                    else:
                        conn.send(("params", step, serde.encode_tree(host)))
                except (OSError, BrokenPipeError):
                    pass

        metrics, tel = learner.run(
            spec["steps"],
            on_update=(on_update if (tel_every or tel_interval or ckpt_every)
                       else None),
            should_stop=stop_event.is_set)

        host = learner.published_host()
        result = {
            "learner_id": learner_id,
            "returns": learner.tracker.completed_timed,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "telemetry": tel,
            "param_version": learner.store.version,
            # every worker digests its final replica, so the parent checks
            # the group's invariant (identical replicas) without N trees
            "params_digest": params_digest(host),
            # the kernels' counters live in this process
            "kernel_counts": {
                "launches": {"vtrace": vk.vtrace.launches,
                             "loss_vtrace": vk.loss_vtrace.launches},
                "shapes": {"vtrace": sorted(vk.vtrace.shapes),
                           "loss_vtrace": sorted(vk.loss_vtrace.shapes)}},
        }
        if state["publisher"]:
            result["params"] = serde.encode_tree(host)
        conn.send(("result", result))
        status = 0
    except BaseException:
        try:
            conn.send(("error", learner_id, traceback.format_exc()))
        except (OSError, BrokenPipeError):
            pass
        try:
            stop_event.set()            # unwedge the peers' exchanges
        except Exception:
            pass
    finally:
        try:
            conn.close()
        except OSError:
            pass
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(status)


# ---------------------------------------------------------------------------
# the group runner


def run_group_training(
    env_name: str,
    icfg,
    num_envs: int,
    steps: int,
    *,
    num_learners: int = 2,
    num_actors: int = 2,
    actor_backend: str = "thread",
    actor_mode: str = "unroll",
    transport: Optional[str] = None,
    listen_addr: Optional[Address] = None,
    spawn_remote: bool = True,
    queue_capacity: int = 8,
    queue_policy: str = "block",
    max_batch_trajs: int = 4,
    seed: int = 0,
    arch=None,
    donate: bool = True,
    stale_after_s: float = 180.0,
    infer_flush_timeout_s: float = 0.02,
    wire_codec: str = serde.DEFAULT_CODEC,
    vtrace_impl: str = "auto",
    telemetry_every: int = 0,
    telemetry_interval_s: float = 0.0,
    on_progress=None,
    ckpt_every: int = 0,
    on_checkpoint=None,
    return_final_params: bool = False,
    obs=None,
    supervise: bool = False,
    restart_policy: Optional[RestartPolicy] = None,
    failover_deadline_s: float = 20.0,
    ckpt_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    kernel_counts: Optional[Dict[int, Dict]] = None,
    device="cuda",
):
    """Train ``steps`` synchronized rounds across ``num_learners`` learner
    worker processes on ``device`` (the card unless the caller asks for
    the CPU), the run's ``num_actors`` actor slots sharded contiguously
    over them.

    Every round each learner backward-passes one dynamic batch from its
    own transport, the gradients are mean-reduced over the framed
    channel, and every learner applies the same mean, so after round t
    all replicas hold identical parameters published at version ``t + 1``
    (``v + t + 1`` when resumed at version ``v``) by delegation from the
    hub (learner 0, the designated publisher). ``stale_after_s`` is the drop rule: a learner
    that misses the round deadline is left out of that round's mean
    (counted in ``group.stale_dropped``) but still receives and applies
    it. ``num_learners=1`` runs the same worker with no exchange: the
    worker is then ``run_async_training`` (same fused step, same seeds).

    ``telemetry_every``/``on_progress(learner_id, snapshot)`` stream
    per-learner snapshots to the caller mid-run (the CLI's log lines);
    ``telemetry_interval_s`` adds time-based sends (each worker also
    sends whenever that much wall time passed since its last send).
    ``ckpt_every``/``on_checkpoint(step, params)`` stream the publisher's
    replica (a host numpy tree in the JAX layout) every that many
    updates. ``ckpt_dir`` with ``ckpt_every`` saves fleet-v1 group
    checkpoints there (params, optimizer state, version); ``resume_from``
    starts every worker from the latest one, continuing the version
    stream. ``kernel_counts``, a dict, receives each learner's K1/K2
    launch counts and shapes: ``{k: {"launches": {...}, "shapes":
    {...}}}``.

    ``obs`` (an ``ObsConfig``) with ``metrics_port`` set runs one
    metrics endpoint for the whole group in this process: the workers
    also ship their snapshots every ``telemetry_interval_s`` (default
    ``obs.telemetry_interval_s``), and ``/metrics`` serves the
    ``merge_telemetry`` of the latest ones (a stub before the first),
    each learner's under a ``learner="k"`` label. The bound address lands
    in ``obs.bound_address``.

    ``supervise=True`` turns faults into events: a spoke learner worker
    that dies silently (SIGKILL, OOM) is respawned under
    ``restart_policy``'s budget from the latest group checkpoint (or from
    scratch), and catches up by applying the hub's replayed means through
    the same ``apply_step``; a dead hub triggers failover: the lowest live
    learner id is promoted, the survivors redial it, and the round and
    version stream continue. A survivor that cannot rejoin within
    ``failover_deadline_s`` degrades to solo training (``degraded_solo``).
    The merged telemetry gains a ``supervisor`` section, and the group
    section ``abandoned_learners`` (the failed-over hubs, whose actor
    shards are lost). A supervised run streams full checkpoints, and
    ``ckpt_dir`` saves them with the supervisor's ``restart_epochs``.

    Returns ``(tracker, last_metrics, merged_telemetry)``, shaped like
    ``run_async_training``'s triple with the telemetry merged by
    ``merge_telemetry``, or a 4-tuple with the publisher's final params
    (host numpy tree, JAX layout) appended when
    ``return_final_params=True``.
    """
    if not isinstance(env_name, str):
        raise ValueError("learner-group workers rebuild the env by "
                         "name; pass an env name, not an Env object")
    import torch

    device = torch.device(device)
    if transport is None:
        transport = {"process": "shm",
                     "remote": "socket"}.get(actor_backend, "inproc")
    shards = shard_slots(num_actors, num_learners)
    listen_addrs = None
    peer_addrs = None
    if transport == "socket":
        if listen_addr is not None:
            host, port = listen_addr
            listen_addrs = [(host, port + k) for k in range(num_learners)]
            peer_addrs = list(listen_addrs)
        elif not spawn_remote:
            raise ValueError("a learner group waiting for external "
                             "actors needs an explicit listen_addr "
                             "(worker k binds port+k)")

    resume_spec = None
    if resume_from is not None:
        from repro_torch.checkpoint import checkpoint as ckpt_lib
        tree, ck_step, extra = ckpt_lib.load_with_extra(resume_from)
        if not (isinstance(tree, dict) and "params" in tree
                and "opt" in tree):
            raise ValueError(
                f"group resume needs a combined params+opt checkpoint "
                f"(fleet-v1); {resume_from} holds a params-only tree")
        version = int((extra or {}).get("version", ck_step))
        resume_spec = {"params": serde.encode_tree(tree["params"]),
                       "opt": serde.encode_tree(tree["opt"]),
                       "version": version}
    if device.type == "cuda":
        # build the kernels once, here: the workers only load the library
        from repro_torch.kernels import build
        build.build()

    spec = {
        "env": env_name, "icfg": icfg, "num_envs": num_envs,
        "steps": steps, "num_learners": num_learners,
        "shards": shards, "actor_backend": actor_backend,
        "actor_mode": actor_mode, "transport": transport,
        "listen_addrs": listen_addrs, "peer_addrs": peer_addrs,
        "spawn_remote": spawn_remote,
        "queue_capacity": queue_capacity, "queue_policy": queue_policy,
        "max_batch_trajs": max_batch_trajs,
        "seed": seed, "arch": arch,
        "donate": donate, "stale_after_s": stale_after_s,
        "infer_flush_timeout_s": infer_flush_timeout_s,
        "wire_codec": serde.check_codec(wire_codec),
        "vtrace_impl": vtrace_impl,
        "telemetry_every": telemetry_every,
        "telemetry_interval_s": (
            telemetry_interval_s or
            (obs.telemetry_interval_s
             if obs is not None and obs.metrics_port is not None
             else 0.0)),
        "resume": resume_spec,
        "hub_id": 0, "supervise": supervise,
        "failover_deadline_s": failover_deadline_s,
        # full checkpoints (params + opt state) whenever the parent needs
        # restartable state: a directory a group can resume from, or a
        # supervised run (respawns start from the latest one)
        "ckpt_full": supervise or ckpt_dir is not None,
        "ckpt_every": (ckpt_every if (on_checkpoint is not None or
                                      supervise or ckpt_dir is not None)
                       else 0),
        # the workers take the caller's intra-op thread count
        "num_threads": torch.get_num_threads(),
        "device": str(device),
    }

    ctx = mp.get_context("spawn")
    # kill-safe: a killed worker must not hold the flag's lock
    stop = KillSafeEvent(ctx)
    conns: List[Any] = []
    procs: List[mp.process.BaseProcess] = []
    for k in range(num_learners):
        parent_conn, child_conn = ctx.Pipe()
        # not daemonic: a learner worker spawns actor children of its own
        # (process/remote backends), which daemons may not; the finally
        # block joins with a deadline and terminates stragglers
        p = ctx.Process(target=_learner_worker,
                        args=(k, child_conn, stop, spec),
                        name=f"learner-{k}")
        conns.append(parent_conn)
        procs.append(p)
        p.start()
        child_conn.close()
    all_procs: List[mp.process.BaseProcess] = list(procs)

    results: Dict[int, Dict] = {}
    errors: List[str] = []
    latest_tel: Dict[int, Dict] = {}
    hub_sent = False
    live = set(range(num_learners))

    # supervision state
    sup = Supervisor(restart_policy) if supervise else None
    current_hub = 0                     # publisher duty follows it
    hub_addr: Optional[List] = None
    failover_pending = False
    pending_respawn: Dict[int, Any] = {}    # k -> RestartDecision
    abandoned: set = set()              # hub ids lost to failover
    latest_ckpt: Optional[Dict[str, Any]] = None

    server = None
    if obs is not None and obs.metrics_port is not None:
        from repro_torch.obs.http import MetricsServer

        def group_snapshot() -> Dict[str, Any]:
            tels = dict(latest_tel)
            if not tels:        # nothing shipped yet: a stub, not a 500
                snap = {"group": {"num_learners": num_learners,
                                  "publisher": current_hub,
                                  "stale_dropped": 0,
                                  "awaiting_first_telemetry": True}}
            else:
                snap = merge_telemetry(tels, publisher=current_hub)
            if sup is not None:
                snap["supervisor"] = sup.snapshot()
            return snap

        server = MetricsServer(group_snapshot, host=obs.metrics_host,
                               port=obs.metrics_port).start()
        obs.bound_address = server.address
        print(f"[obs] group metrics at http://{server.address[0]}:"
              f"{server.address[1]}/metrics", flush=True)

    def _relay_hub(addr, exclude=frozenset((0,))) -> None:
        for j in range(num_learners):
            if j in exclude:
                continue
            try:
                conns[j].send(("hub", addr))
            except (OSError, BrokenPipeError):
                pass

    def _save_group_ckpt(step: int) -> None:
        if not ckpt_dir or latest_ckpt is None:
            return
        from repro_torch.checkpoint import checkpoint as ckpt_lib
        tree = {"params": serde.decode_tree(latest_ckpt["params"],
                                            copy=True)[0],
                "opt": serde.decode_tree(latest_ckpt["opt"],
                                         copy=True)[0]}
        extra = {"version": latest_ckpt["version"], "format": "fleet-v1"}
        if sup is not None:
            extra["restart_epochs"] = sup.restart_epochs()
        ckpt_lib.save(ckpt_dir, step, tree, extra=extra)

    def _fail(msg: str) -> None:
        nonlocal hub_sent
        errors.append(msg)
        stop.set()
        if not hub_sent:
            hub_sent = True
            _relay_hub(None)

    def _handle_death(k: int) -> None:
        """A worker died silently (no error message: SIGKILL, OOM).
        Supervised, that is an event (failover for the hub, respawn for a
        spoke), not an error that ends the run."""
        nonlocal current_hub, failover_pending
        if sup is None:
            _fail(f"learner worker {k} exited with code "
                  f"{procs[k].exitcode} before reporting")
            return
        if k == current_hub:
            survivors = sorted(live)
            if not survivors:
                _fail(f"hub learner {k} died with no survivors to "
                      f"promote")
                return
            # hub failover: promote the lowest live learner id; the dead
            # hub's actor shard is lost (graceful degradation), the round
            # and version stream continue on the new hub
            abandoned.add(k)
            sup.record_failover()
            current_hub = survivors[0]
            failover_pending = True
            for j in survivors:
                try:
                    conns[j].send(("failover", current_hub, k))
                except (OSError, BrokenPipeError):
                    pass
        else:
            decision = sup.record_death(f"learner-{k}")
            if decision is None:
                _fail(f"learner worker {k} died over its restart budget "
                      f"({sup.policy.max_restarts} per "
                      f"{sup.policy.window_s:.0f}s)")
                return
            pending_respawn[k] = decision

    def _maybe_respawn() -> None:
        now = time.monotonic()
        for k in [k for k, d in pending_respawn.items()
                  if d.not_before <= now]:
            d = pending_respawn.pop(k)
            respec = dict(spec)
            respec["hub_id"] = current_hub
            if latest_ckpt is not None:
                # restart from the latest group checkpoint; the hub's
                # mean-replay history carries it from that version to the
                # group's current round
                respec["resume"] = dict(latest_ckpt)
                # new RNG streams for the reborn actors, but only when the
                # params come from a checkpoint: a respawn from scratch
                # must re-derive the identical replica (same init, same
                # means), so its seed stays
                respec["seed"] = fold_restart_seed(seed, d.epoch)
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(target=_learner_worker,
                            args=(k, child_conn, stop, respec),
                            name=f"learner-{k}-r{d.epoch}")
            conns[k] = parent_conn
            procs[k] = p
            all_procs.append(p)
            p.start()
            child_conn.close()
            live.add(k)
            sup.note_restarted(f"learner-{k}")
            # mid-failover the only known address is the dead hub's; the
            # reborn spoke then waits for the relayed new one
            if hub_addr is not None and not failover_pending:
                try:
                    parent_conn.send(("hub", hub_addr))
                except (OSError, BrokenPipeError):
                    pass

    def _on_worker_gone(k: int) -> None:
        live.discard(k)
        if k in results or errors:
            return
        _handle_death(k)

    try:
        while live or pending_respawn:
            _maybe_respawn()
            ready = mp_connection.wait([conns[k] for k in live],
                                       timeout=0.2 if pending_respawn
                                       else 0.5)
            if not ready:
                for k in list(live):
                    if procs[k].exitcode is not None:
                        _on_worker_gone(k)
                continue
            for conn in ready:
                k = conns.index(conn)
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    if k not in results and sup is None and not errors:
                        _fail(f"learner worker {k} died without "
                              f"reporting (pipe EOF)")
                        live.discard(k)
                    else:
                        _on_worker_gone(k)
                    continue
                tag = msg[0]
                if tag == "hub":
                    hub_sent = True
                    hub_addr = msg[1]
                    _relay_hub(msg[1], exclude={k})
                    if failover_pending:
                        failover_pending = False
                        sup.note_failover_done()
                elif tag == "telemetry":
                    # the latest snapshot feeds the group's /metrics;
                    # on_progress(learner_id, snapshot) is the live-logging
                    # hook (the CLI prints from it)
                    latest_tel[k] = msg[1]
                    if on_progress is not None:
                        on_progress(k, msg[1])
                elif tag == "params":
                    if on_checkpoint is not None:
                        on_checkpoint(
                            msg[1],
                            serde.decode_tree(msg[2], copy=True)[0])
                elif tag == "ckpt":
                    # (step, version, params, opt state): the respawn
                    # source and the disk save
                    latest_ckpt = {"params": msg[3], "opt": msg[4],
                                   "version": int(msg[2])}
                    if on_checkpoint is not None:
                        on_checkpoint(
                            msg[1],
                            serde.decode_tree(msg[3], copy=True)[0])
                    _save_group_ckpt(int(msg[1]))
                elif tag == "error":
                    _fail(f"learner worker {msg[1]}:\n{msg[2]}")
                    live.discard(k)
                elif tag == "result":
                    results[k] = msg[1]
                    live.discard(k)
    finally:
        if server is not None:
            server.stop()
        if errors:
            stop.set()
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        for p in all_procs:
            p.join(max(0.1, deadline - time.monotonic()))
        for p in all_procs:
            if p.is_alive():                # no orphans, ever
                p.terminate()
                p.join(timeout=5.0)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    if errors:
        raise RuntimeError("learner group failed:\n" + errors[0])
    expected = set(range(num_learners)) - abandoned
    if not expected <= set(results):
        missing = sorted(expected - set(results))
        raise RuntimeError(f"learner worker(s) {missing} produced no "
                           f"result")

    if kernel_counts is not None:
        kernel_counts.update({k: r["kernel_counts"]
                              for k, r in sorted(results.items())})
    tracker = GroupTracker([tuple(p) for r in results.values()
                            for p in r["returns"]])
    versions = sorted(r["param_version"] for r in results.values())
    digests = {f"learner_{k}": r["params_digest"]
               for k, r in sorted(results.items())}
    group_extra = {"rounds": steps,
                   "wire_codec": wire_codec,
                   "param_versions": versions,
                   "param_digests": digests,
                   "replicas_identical": len(set(digests.values())) == 1,
                   "transport": transport}
    if abandoned:
        group_extra["abandoned_learners"] = sorted(abandoned)
    telemetry = merge_telemetry(
        {k: r["telemetry"] for k, r in results.items()},
        publisher=current_hub, group_extra=group_extra)
    if sup is not None:
        telemetry["supervisor"] = sup.snapshot()
    metrics = results[current_hub]["metrics"]
    if return_final_params:
        params, _meta = serde.decode_tree(results[current_hub]["params"],
                                          copy=True)
        return tracker, metrics, telemetry, params
    return tracker, metrics, telemetry
