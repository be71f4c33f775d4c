"""TCP socket transport (``repro.distributed.socket_transport``): the
serde buffers over a real network (the paper's cross-machine
actor->learner queue, IMPALA §3 Fig. 1). The frames, kinds and handshake
are the JAX package's.

``SocketTransport`` is the learner side: it listens, accepts remote
actors, and implements the uniform put/get/backpressure/counters
``Transport`` API — per-connection drain threads read length-prefixed,
CRC-checked frames (``serde.pack_frame``), decode trajectory items, and
apply the configured backpressure policy in the local
``TrajectoryQueue``, exactly where ``ShmTransport``'s drain thread does.
``SocketActorClient`` is the remote side: a machine that knows only the
learner's address dials in, receives its actor id and run configuration
in the handshake, and then needs nothing but env stepping —
trajectories go up, versioned parameters (and, in inference mode,
actions) come down.

Every actor holds TWO connections, mirroring the shm layout's separate
data wire and param pipe:

  data   carries only trajectory frames. Under the ``block`` policy the
         learner-side drain stalls in the local queue, stops reading,
         and TCP flow control pushes the stall back into the actor's
         ``send`` — real end-to-end backpressure over the network.
  ctrl   carries everything that must stay responsive while data is
         backpressured: the config handshake, parameter pulls,
         inference requests/replies, pause/resume hints, error reports,
         and the shutdown handshake.

Failure discipline (what the chaos suite pins down):

  * a frame that ends early (peer killed mid-write, link severed) is
    detected by the length prefix and **never delivered** — it is
    counted as a torn tail, and the connection is dropped;
  * a CRC or magic mismatch means the byte stream is desynchronised;
    there is no way to re-find frame boundaries, so the connection is
    dropped and counted, never "resynced";
  * the client reconnects with exponential backoff. A frame whose send
    did not complete is resent on the fresh connection (a partial frame
    is invisible to the learner, so the resend cannot duplicate);
    a frame fully handed to a dying kernel socket is the one
    trajectory a sever can lose;
  * shutdown reuses the discard protocol: the learner flips to discard
    but keeps draining, sends a ``stop`` control frame, and each actor
    answers ``bye`` before closing — so no shutdown ever tears a frame.

A learner group's shard map (``peer_addrs``: every learner's listen
address) rides the CONFIG handshake and a full learner's refusal, and a
refused client spills to a learner it has not tried.

Supervision: with ``heartbeat_timeout_s`` the CONFIG handshake asks each
actor to beacon on its ctrl link every third of the deadline
(``SocketActorClient._heartbeat_loop``), and a reaper thread revokes the
slot lease of any actor silent past it, so the slot can be reclaimed at
once. With ``elastic`` a dialer finding every slot held by a live actor
gets a new slot past ``max_actors`` instead of a refusal.
"""
from __future__ import annotations

import collections
import json
import random
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.distributed import serde
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.distributed.tqueue import POLICIES, TrajectoryQueue

# frame kinds multiplexed over one connection (serde.pack_frame kind)
KIND_HELLO = 1       # actor -> learner: {"role": "ctrl"|"data", "actor_id"}
KIND_CONFIG = 2      # learner -> actor: the run config json (ctrl only)
KIND_TRAJ = 3        # actor -> learner: serde-encoded TrajectoryItem
KIND_PARAM_REQ = 4   # actor -> learner: int64 have_version
KIND_PARAM = 5       # learner -> actor: int64 version + encoded params
KIND_PARAM_KEEP = 6  # learner -> actor: nothing newer than have_version
KIND_INFER_REQ = 7   # actor -> learner: serde obs request (stream=client)
KIND_INFER_REP = 8   # learner -> actor: serde reply (stream=client)
KIND_CTRL = 9        # both ways: stop / bye / pause / resume
KIND_ERROR = 10      # actor -> learner: traceback text
# learner <-> learner (the gradient exchange rides the same CRC frame
# format and torn-tail discipline as everything else on the wire)
KIND_GRAD = 11       # spoke -> hub: serde grad leaves (stream=learner)
KIND_GRAD_MEAN = 12  # hub -> spoke: reduced mean for one round
KIND_HEARTBEAT = 13  # actor -> learner: liveness beacon (ctrl only)

CTRL_STOP = b"stop"
CTRL_BYE = b"bye"
CTRL_REFUSED = b"refused"   # no free actor slot: distinct from run-end
CTRL_PAUSE = b"pause"
CTRL_RESUME = b"resume"

_I64 = struct.Struct("<q")

Address = Tuple[str, int]


class Disconnected(Exception):
    """The peer is gone (EOF/reset) or a stop was requested mid-read.

    ``partial`` is how many bytes of an in-flight frame had arrived —
    nonzero with ``stopped=False`` means the peer died mid-frame (a
    torn tail, counted but never delivered)."""

    def __init__(self, partial: int = 0, stopped: bool = False):
        super().__init__(f"disconnected (partial={partial}, "
                         f"stopped={stopped})")
        self.partial = partial
        self.stopped = stopped


def _recv_exactly(sock: socket.socket, n: int,
                  stop: Optional[Callable[[], bool]]) -> bytes:
    """Blocking read of exactly ``n`` bytes; the 0.2s socket timeout is
    the stop-poll cadence, not a deadline — a slow sender mid-frame just
    keeps accumulating."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if stop is not None and stop():
                raise Disconnected(len(buf), stopped=True)
            continue
        except (OSError, ValueError):
            raise Disconnected(len(buf))
        if not chunk:
            raise Disconnected(len(buf))
        buf += chunk
    return bytes(buf)


class FrameChannel:
    """One TCP connection speaking serde frames: a write-locked ``send``
    that either puts a *whole* frame on the wire or marks the channel
    dead (a partial write would tear the stream for every later frame),
    and a single-reader ``recv`` returning complete, CRC-verified
    frames."""

    # grace for finishing an in-flight frame once stop is requested: the
    # learner drains in discard mode during shutdown, so a healthy
    # connection completes in microseconds — this bounds a dead one
    STOP_FLUSH_GRACE_S = 5.0

    def __init__(self, sock: socket.socket):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover — not a TCP socket (tests)
            pass
        sock.settimeout(0.2)
        self._sock = sock
        self._wlock = threading.Lock()
        self.dead = False
        self.bytes_in = 0
        self.bytes_out = 0
        self.frames_in = 0
        self.frames_out = 0

    def send(self, kind: int, stream_id: int = 0, payload: bytes = b"",
             stop: Optional[Callable[[], bool]] = None) -> bool:
        """Write one whole frame. False = nothing (or only a torn
        prefix, invisible to the receiver as data) made it out and the
        channel is dead or stopping — safe to resend on a fresh
        connection."""
        frame = memoryview(serde.pack_frame(kind, stream_id, payload))
        with self._wlock:
            if self.dead:
                return False
            off = 0
            stop_deadline = None
            while off < len(frame):
                if stop is not None and stop():
                    if off == 0:
                        return False
                    # mid-frame: finishing is the only non-tearing exit
                    now = time.monotonic()
                    if stop_deadline is None:
                        stop_deadline = now + self.STOP_FLUSH_GRACE_S
                    elif now > stop_deadline:
                        self.dead = True
                        return False
                try:
                    off += self._sock.send(frame[off:])
                except socket.timeout:
                    continue
                except (OSError, ValueError):
                    self.dead = True
                    return False
            self.bytes_out += len(frame)
            self.frames_out += 1
            return True

    def recv(self, stop: Optional[Callable[[], bool]] = None
             ) -> Tuple[int, int, bytes]:
        """One complete frame: (kind, stream_id, payload). Raises
        ``Disconnected`` on EOF/stop (``partial`` > 0 = torn tail) and
        ``serde.SerdeError`` on magic/CRC corruption (stream is
        desynchronised: drop the connection)."""
        hdr = _recv_exactly(self._sock, serde.FRAME_HEADER_SIZE, stop)
        kind, stream_id, length, crc = serde.parse_frame_header(hdr)
        if length:
            try:
                payload = _recv_exactly(self._sock, length, stop)
            except Disconnected as d:
                raise Disconnected(serde.FRAME_HEADER_SIZE + d.partial,
                                   d.stopped)
        else:
            payload = b""
        serde.verify_frame_payload(kind, stream_id, payload, crc)
        self.bytes_in += serde.FRAME_HEADER_SIZE + length
        self.frames_in += 1
        return kind, stream_id, payload

    def close(self) -> None:
        self.dead = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _ActorSlot:
    """Per-remote-actor server-side state and telemetry."""

    __slots__ = ("actor_id", "ctrl", "data", "binds", "owner_nonce",
                 "frames", "bytes", "torn_tails", "reconnects", "losses",
                 "wait_sum", "wait_n", "last_seen", "lease_reaps",
                 "epoch")

    def __init__(self, actor_id: int):
        self.actor_id = actor_id
        self.ctrl: Optional[FrameChannel] = None
        self.data: Optional[FrameChannel] = None
        self.binds: Dict[str, int] = {}     # role -> connection count
        self.owner_nonce: Optional[str] = None
        self.frames = 0          # trajectory frames accepted
        self.bytes = 0
        self.torn_tails = 0
        self.reconnects = 0
        self.losses = 0          # rejected/evicted, attributed here
        self.wait_sum = 0.0      # recv -> accepted-into-queue latency
        self.wait_n = 0
        self.last_seen = time.monotonic()   # liveness stamp (any frame)
        self.lease_reaps = 0     # deadline-expired leases on this slot
        self.epoch = 0           # ownership transfers (restart epoch)


class SocketTransport:
    """Learner-side TCP transport: accept loop + per-connection drain
    threads feeding the in-proc policy queue.

    The policy (block / drop_oldest / drop_newest) runs here, at the
    drain side — like ``ShmTransport``, ``rejects_at_put`` is False and
    loss attribution arrives through the hooks:

      on_item(item)     decoded item accepted into the local queue
      on_reject(item)   decoded item rejected by drop_newest
      on_drop(item)     queued item evicted by drop_oldest (inner hook)

    Integration points (all optional, set before actors connect):

      config_extra      fn(actor_id) -> dict merged into the CONFIG
                        handshake payload (the pool ships env/arch/run
                        config through this). The handshake WAITS for
                        this to be bound — the accept loop starts with
                        the constructor, and an external actor dialing
                        the instant the port opens must not receive a
                        config-less handshake
      param_source      fn(have_version) -> None | (buf, version); the
                        pool binds ``ParameterStore.pull_serialized``
      handlers[kind]    fn(chan, stream_id, payload) for frame kinds
                        the transport doesn't own (inference requests)
      ctrl_handler      fn(stream_id, payload) for pause/resume hints
      on_error          fn(text) for remote error reports (also kept
                        in ``self.errors``)
    """

    rejects_at_put = False

    # Cap the kernel buffering of actor->learner trajectory bytes. TCP
    # would happily buffer megabytes per connection — several whole
    # trajectories sitting OUTSIDE the bounded queue, invisible to the
    # block policy. That silently deepens the pipeline (measured: +10-20
    # versions of policy lag on a loopback catch run) and raises how
    # much a severed link can lose. With ~256KB the flow control
    # engages at roughly trajectory granularity: backpressure reaches
    # the actor within a trajectory or two, like the shm wire.
    DATA_BUF_BYTES = 1 << 18
    # the byte cap exists to hold ~1-2 trajectory FRAMES in the kernel;
    # a quantizing codec shrinks frames (bf16/int8 float leaves + the
    # deflate pass over the rest measures 6-12x on the bench envs), so
    # the same byte budget would silently hold 8+ frames of invisible
    # pipeline and policy lag climbs right back up (measured: ~10 -> ~29
    # mean lag on loopback catch with bf16 under the fp32-sized cap).
    # Scale the cap with the codec so flow control stays at trajectory
    # granularity; the floor keeps the window sane for tiny payloads.
    QUANT_BUF_DIV = 8
    MIN_DATA_BUF = 1 << 14

    def __init__(self, capacity: int = 8, policy: str = "block",
                 listen: Address = ("127.0.0.1", 0),
                 max_actors: Optional[int] = None,
                 data_buf_bytes: int = DATA_BUF_BYTES,
                 slot_base: int = 0, registry=None,
                 wire_codec: str = serde.DEFAULT_CODEC,
                 heartbeat_timeout_s: Optional[float] = None,
                 elastic: bool = False):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        self.capacity = capacity
        self.policy = policy
        # liveness: when set, the CONFIG handshake asks actors to
        # heartbeat on ctrl (timeout/3 cadence) and a reaper thread
        # expires the slot lease of any actor silent past the deadline,
        # so its slot is reclaimable at once. None keeps the unsupervised
        # behaviour: leases move only when a relaunched actor claims a
        # dead slot
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # elastic membership: a dialer finding every slot held by a LIVE
        # actor gets a new slot past ``max_actors`` instead of a refusal;
        # ``on_slot_grown`` fires (outside the slot lock)
        self.elastic = elastic
        self.on_slot_grown: Optional[Callable[[int], None]] = None
        self.supervisor = None          # optional supervise.Supervisor
        # the run's wire codec: announced in the CONFIG handshake so
        # every actor encodes the way this learner expects (a peer that
        # doesn't speak it refuses loudly at connect, never mid-run)
        self.wire_codec = serde.check_codec(wire_codec)
        self.max_actors = max_actors
        if data_buf_bytes and self.wire_codec != "none":
            data_buf_bytes = max(data_buf_bytes // self.QUANT_BUF_DIV,
                                 self.MIN_DATA_BUF)
        self.data_buf_bytes = data_buf_bytes
        # shard-aware slot assignment: this learner hands out global
        # actor ids in [slot_base, slot_base + max_actors). peer_addrs
        # (set by the pool/group before actors connect) is the shard
        # map: every learner's listen address, shipped in the CONFIG
        # handshake and in refusals, so an external actor that dialed a
        # full learner spills to one with a free slot instead of dying
        self.slot_base = slot_base
        self.peer_addrs: Optional[List[Address]] = None
        self._inner = TrajectoryQueue(capacity, policy, registry=registry)
        self.registry = self._inner.registry
        self.on_item: Optional[Callable[[TrajectoryItem], None]] = None
        self.on_reject: Optional[Callable[[TrajectoryItem], None]] = None
        self.config_extra: Optional[Callable[[int],
                                             Dict[str, Any]]] = None
        self.param_source: Optional[
            Callable[[int], Optional[Tuple[bytes, int]]]] = None
        self.handlers: Dict[int, Callable[[FrameChannel, int, bytes],
                                          None]] = {}
        self.ctrl_handler: Optional[Callable[[int, bytes], None]] = None
        self.on_ctrl_gone: Optional[Callable[[int], None]] = None
        self.on_error: Optional[Callable[[str], None]] = None

        self._stop = threading.Event()
        self._discard = False
        self._closed = False
        self._close_lock = threading.Lock()
        self._lock = threading.Lock()           # slots / counters
        self._slots: Dict[int, _ActorSlot] = {}
        self._slot_by_nonce: Dict[str, _ActorSlot] = {}
        self._next_id = slot_base
        self._threads: List[threading.Thread] = []

        # telemetry (conn-thread writes under self._lock; snapshot()
        # reads). Stored as registry instruments so the live /metrics
        # endpoint and the end-of-run snapshot read the same storage;
        # the read-only properties below keep `t.frames_in` etc. working
        self._c_frames_in = self.registry.counter("socket.frames_in")
        self._c_bytes_in = self.registry.counter("socket.bytes_in")
        # trajectory compression accounting: payload bytes as they rode
        # the wire vs the raw leaf bytes they decoded to — the
        # bytes/frame numerator the bandwidth-diet benchmarks assert on
        self._c_traj_wire = self.registry.counter("socket.traj_wire_bytes")
        self._c_traj_raw = self.registry.counter("socket.traj_raw_bytes")
        self._c_torn_tails = self.registry.counter("socket.torn_tails")
        self._c_reconnects = self.registry.counter("socket.reconnects")
        self._c_discarded = self.registry.counter("socket.discarded")
        self._c_heartbeats = self.registry.counter("socket.heartbeats")
        self._c_lease_reaps = self.registry.counter("socket.lease_reaps")
        self.decode_errors: List[str] = []      # CRC/magic/serde failures
        self.errors: List[str] = []             # remote actor tracebacks
        self._t0: Optional[float] = None        # first-frame clock

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if data_buf_bytes:
            # must be set on the LISTENER (inherited by accepted
            # sockets) to take effect before the window opens
            try:
                self._lsock.setsockopt(socket.SOL_SOCKET,
                                       socket.SO_RCVBUF, data_buf_bytes)
            except OSError:  # pragma: no cover
                pass
        self._lsock.bind(tuple(listen))
        self._lsock.listen(64)
        self._lsock.settimeout(0.2)
        self.address: Address = self._lsock.getsockname()[:2]
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="socket-accept",
                                          daemon=True)
        self._acceptor.start()
        self._reaper: Optional[threading.Thread] = None
        if heartbeat_timeout_s is not None:
            self._reaper = threading.Thread(target=self._reap_loop,
                                            name="socket-reaper",
                                            daemon=True)
            self._reaper.start()

    # ------------------------------------------------------------------
    # eviction attribution passes straight through to the local queue

    @property
    def on_drop(self):
        return self._inner.on_drop

    @on_drop.setter
    def on_drop(self, fn):
        self._inner.on_drop = fn

    # counter views (the registry instruments are the storage)

    @property
    def frames_in(self) -> int:
        return self._c_frames_in.value

    @property
    def bytes_in(self) -> int:
        return self._c_bytes_in.value

    @property
    def torn_tails(self) -> int:
        return self._c_torn_tails.value

    @property
    def reconnects(self) -> int:
        return self._c_reconnects.value

    @property
    def discarded(self) -> int:
        return self._c_discarded.value

    # ------------------------------------------------------------------
    # accept + handshake

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _peer = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._conn_entry, args=(sock,),
                                 name="socket-conn", daemon=True)
            with self._lock:
                # prune reaped connections: a long run with flaky
                # actors must not accumulate dead Thread objects
                self._threads = [x for x in self._threads
                                 if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _reap_loop(self) -> None:
        """Deadline-based liveness: expire the slot lease of any actor
        silent past ``heartbeat_timeout_s``. The lease (nonce ownership)
        is what a reap revokes; the slot stays, with its accounting, for
        the next claimant, and a reaped actor that was merely wedged finds
        its redial refused (stale nonce) and exits visibly."""
        timeout = self.heartbeat_timeout_s
        poll = min(1.0, timeout / 4.0)
        while not self._stop.wait(poll):
            if self._discard:
                continue
            now = time.monotonic()
            reaped: List[int] = []
            with self._lock:
                for slot in self._slots.values():
                    live = ((slot.ctrl is not None and not slot.ctrl.dead)
                            or (slot.data is not None
                                and not slot.data.dead))
                    if not (live or slot.owner_nonce is not None):
                        continue            # nothing to reap
                    if now - slot.last_seen <= timeout:
                        continue
                    for k in [k for k, v in self._slot_by_nonce.items()
                              if v is slot]:
                        del self._slot_by_nonce[k]
                    slot.owner_nonce = None
                    slot.lease_reaps += 1
                    self._c_lease_reaps.inc()
                    reaped.append(slot.actor_id)
                chans = [c for s in self._slots.values()
                         if s.actor_id in reaped
                         for c in (s.ctrl, s.data) if c is not None]
            for chan in chans:      # close outside the slot lock
                chan.close()
            if self.supervisor is not None:
                for actor_id in reaped:
                    self.supervisor.record_lease_reap(f"slot-{actor_id}")

    def _conn_entry(self, sock: socket.socket) -> None:
        chan = FrameChannel(sock)
        deadline = time.monotonic() + 5.0
        try:
            kind, _stream, payload = chan.recv(
                stop=lambda: self._stop.is_set() or
                time.monotonic() > deadline)
        except (Disconnected, serde.SerdeError):
            chan.close()
            return
        if kind != KIND_HELLO:
            chan.close()
            return
        try:
            hello = json.loads(payload.decode("utf-8")) if payload else {}
        except ValueError:
            chan.close()
            return
        role = hello.get("role", "data")
        actor_id = int(hello.get("actor_id", -1))
        slot = self._bind(role, actor_id, chan,
                          nonce=hello.get("nonce"))
        if slot is None:
            # full house: refuse, distinctly from a run-end stop, so the
            # surplus actor exits NONZERO and an operator notices. With a
            # shard map bound, the refusal carries the OTHER learners'
            # addresses so the actor spills to one with a free slot
            payload = CTRL_REFUSED
            spill = [list(a) for a in (self.peer_addrs or [])
                     if tuple(a) != tuple(self.address)]
            if spill:
                payload += b" " + json.dumps(spill).encode("utf-8")
            chan.send(KIND_CTRL, 0, payload)
            chan.close()
            return
        try:
            if role == "ctrl":
                gate = time.monotonic() + 10.0
                while self.config_extra is None and \
                        not self._stop.is_set() and \
                        time.monotonic() < gate:
                    time.sleep(0.02)
                extra = self.config_extra
                cfg = {"actor_id": slot.actor_id,
                       "data_buf": self.data_buf_bytes,
                       "wire_codec": self.wire_codec}
                if self.heartbeat_timeout_s is not None:
                    # beacons at a third of the reap deadline: two missed
                    # beats of slack before the lease expires
                    cfg["heartbeat_s"] = self.heartbeat_timeout_s / 3.0
                if self.peer_addrs is not None:
                    # the group's shard map: every learner's listen
                    # address, the whole topology in one handshake
                    cfg["shard_map"] = [list(a) for a in self.peer_addrs]
                if extra is not None:
                    cfg.update(extra(slot.actor_id))
                if slot.epoch and "seed" in cfg:
                    # restart-epoch seed folding for a slot whose
                    # previous owner died: the run config is shared,
                    # so the fold happens per-slot at handshake time
                    from repro_torch.distributed.supervise import \
                        fold_restart_seed
                    cfg["seed"] = fold_restart_seed(int(cfg["seed"]),
                                                    slot.epoch)
                chan.send(KIND_CONFIG, 0,
                          json.dumps(cfg).encode("utf-8"),
                          stop=self._stop.is_set)
                if self._discard:       # late joiner during shutdown
                    chan.send(KIND_CTRL, 0, CTRL_STOP)
                self._ctrl_loop(slot, chan)
            else:
                self._data_loop(slot, chan)
        finally:
            chan.close()
            with self._lock:
                if getattr(slot, role, None) is chan:
                    setattr(slot, role, None)
            if role == "ctrl" and self.on_ctrl_gone is not None:
                # tell the serving layer this actor can no longer
                # submit or be replied to (until it reconnects): stale
                # pause hints and client counts must not outlive the
                # connection that made them
                try:
                    self.on_ctrl_gone(slot.actor_id)
                except Exception:   # a hook bug must not kill accept
                    pass

    def _bind(self, role: str, actor_id: int, chan: FrameChannel,
              nonce: Optional[str] = None) -> Optional[_ActorSlot]:
        if role not in ("ctrl", "data"):
            return None
        grew = False
        with self._lock:
            next_before = self._next_id
            if actor_id < 0:
                if role != "ctrl":
                    return None         # data conns must name their actor
                # idempotent assignment: a client whose handshake was
                # severed before CONFIG landed retries with the same
                # nonce and gets its already-allocated slot back — a
                # flaky link must not leak slots until the run refuses
                # its own actors
                slot = (self._slot_by_nonce.get(nonce)
                        if nonce else None)
                if slot is None and self.max_actors is not None and \
                        self._next_id >= self.slot_base + self.max_actors:
                    # all ids handed out: RECLAIM a slot with no live
                    # connections — a crashed external actor relaunched
                    # by an operator must get its capacity back, not a
                    # refusal (losses/frames remain attributed to the
                    # slot, which is the point: the slot IS the actor).
                    # Ownership moves to the claimant's nonce, so if
                    # the old actor was merely in reconnect backoff its
                    # later redial is refused outright instead of the
                    # two fighting over one slot forever.
                    for s in self._slots.values():
                        if (s.ctrl is None or s.ctrl.dead) and \
                                (s.data is None or s.data.dead):
                            slot = s
                            for k in [k for k, v in
                                      self._slot_by_nonce.items()
                                      if v is slot]:
                                del self._slot_by_nonce[k]
                            slot.owner_nonce = nonce
                            if nonce:
                                self._slot_by_nonce[nonce] = slot
                            # a NEW actor took over the slot: bump the
                            # restart epoch so the CONFIG handshake can
                            # fold it into the seed — the successor
                            # must not replay its predecessor's stream
                            slot.epoch += 1
                            break
                    if slot is None and not self.elastic:
                        return None     # every slot has a live actor
                    # elastic membership: every slot has a live actor, so
                    # grow: a new global id past the ceiling
                if slot is None:
                    actor_id = self._next_id
                    self._next_id += 1
                    slot = self._slots[actor_id] = _ActorSlot(actor_id)
                    slot.owner_nonce = nonce
                    if nonce:
                        self._slot_by_nonce[nonce] = slot
                actor_id = slot.actor_id
            else:
                slot = self._slots.get(actor_id)
                if slot is None:
                    if actor_id < self.slot_base or (
                            self.max_actors is not None and actor_id >=
                            self.slot_base + self.max_actors):
                        return None     # not this learner's shard
                    slot = self._slots[actor_id] = _ActorSlot(actor_id)
                    slot.owner_nonce = nonce
                    self._next_id = max(self._next_id, actor_id + 1)
                elif slot.owner_nonce and nonce and \
                        nonce != slot.owner_nonce:
                    # the slot was reclaimed by a relaunched actor while
                    # this one was away: its lease is gone, refuse
                    return None
            # a rebind of a previously-bound role is a reconnect whether
            # or not the dead connection's thread was reaped yet
            if slot.binds.get(role, 0):
                slot.reconnects += 1
                self._c_reconnects.inc()
            slot.binds[role] = slot.binds.get(role, 0) + 1
            old = getattr(slot, role)
            if old is not None:
                old.close()
            setattr(slot, role, chan)
            slot.last_seen = time.monotonic()
            grew = (self.max_actors is not None
                    and self._next_id > next_before
                    and slot.actor_id >=
                    self.slot_base + self.max_actors)
        if grew and self.on_slot_grown is not None:
            try:
                self.on_slot_grown(slot.actor_id)
            except Exception:       # accounting growth must not kill accept
                pass
        return slot

    # ------------------------------------------------------------------
    # connection drains

    def _data_loop(self, slot: _ActorSlot, chan: FrameChannel) -> None:
        while not self._stop.is_set():
            try:
                kind, _stream, payload = chan.recv(stop=self._stop.is_set)
            except Disconnected as d:
                if d.partial and not d.stopped:
                    with self._lock:
                        slot.torn_tails += 1
                        self._c_torn_tails.inc()
                return
            except serde.SerdeError as e:       # desynced: drop the conn
                self.decode_errors.append(repr(e))
                return
            with self._lock:
                self._c_bytes_in.inc(len(payload) + serde.FRAME_HEADER_SIZE)
                slot.last_seen = time.monotonic()
            if kind == KIND_CTRL:
                if payload == CTRL_BYE:         # clean shutdown handshake
                    return
                continue
            if kind != KIND_TRAJ:
                continue
            with self._lock:
                # trajectory frames only: frames_in is the numerator of
                # the throughput telemetry, and a bye must not open the
                # rate clock
                self._c_frames_in.inc()
                if self._t0 is None:
                    self._t0 = time.monotonic()
            if self._discard:
                with self._lock:
                    self._c_discarded.inc()
                continue
            t_recv = time.monotonic()
            try:
                item = serde.decode_item(payload)
            except Exception as e:              # corrupt *payload* spec
                self.decode_errors.append(repr(e))
                continue
            with self._lock:
                self._c_traj_wire.inc(len(payload))
                self._c_traj_raw.inc(serde.tree_nbytes(item.data))
            self._policy_put(slot, item, t_recv, len(payload))

    def _policy_put(self, slot: _ActorSlot, item: TrajectoryItem,
                    t_recv: float, nbytes: int) -> None:
        """The same drain discipline as ``ShmTransport``: block-policy
        stalls HERE (so TCP flow control reaches the producer), the
        drop policies decide immediately — and a put that fails because
        the queue closed under us is shutdown, never attributed as a
        policy rejection."""
        while not self._stop.is_set() and not self._discard:
            if self._inner.put(item, timeout=0.1):
                with self._lock:
                    slot.frames += 1
                    slot.bytes += nbytes
                    slot.wait_sum += time.monotonic() - t_recv
                    slot.wait_n += 1
                if self.on_item is not None:
                    self.on_item(item)
                return
            if self._inner.closed or self._discard:
                return                          # shutdown, not a policy
            if self._inner.policy == "drop_newest":
                with self._lock:
                    slot.losses += 1
                if self.on_reject is not None:
                    self.on_reject(item)
                return                          # genuine policy rejection
            # block policy: local queue full, learner slow — stall here
            # so this connection stops reading and backpressure travels

    def _ctrl_loop(self, slot: _ActorSlot, chan: FrameChannel) -> None:
        while not self._stop.is_set():
            try:
                kind, stream, payload = chan.recv(stop=self._stop.is_set)
            except Disconnected:
                return
            except serde.SerdeError as e:
                self.decode_errors.append(repr(e))
                return
            with self._lock:
                # any ctrl traffic proves liveness; the explicit
                # heartbeat only matters when the actor is otherwise
                # idle (e.g. data link stalled under backpressure)
                slot.last_seen = time.monotonic()
                if kind == KIND_HEARTBEAT:
                    self._c_heartbeats.inc()
            if kind == KIND_HEARTBEAT:
                pass
            elif kind == KIND_PARAM_REQ:
                self._serve_params(chan, payload)
            elif kind == KIND_CTRL:
                if payload == CTRL_BYE:
                    return
                if payload in (CTRL_PAUSE, CTRL_RESUME) and \
                        self.ctrl_handler is not None:
                    self.ctrl_handler(stream, payload)
            elif kind == KIND_ERROR:
                text = payload.decode("utf-8", "replace")
                self.errors.append(text)
                if self.on_error is not None:
                    self.on_error(text)
            else:
                handler = self.handlers.get(kind)
                if handler is not None:
                    handler(chan, stream, payload)

    def _serve_params(self, chan: FrameChannel, payload: bytes) -> None:
        if len(payload) != _I64.size:
            return
        (have_version,) = _I64.unpack(payload)
        src = self.param_source
        fresh = src(have_version) if src is not None and \
            not self._discard else None
        if fresh is None:
            chan.send(KIND_PARAM_KEEP, 0, b"", stop=self._stop.is_set)
        else:
            buf, version = fresh
            chan.send(KIND_PARAM, 0, _I64.pack(version) + buf,
                      stop=self._stop.is_set)

    # ------------------------------------------------------------------
    # Transport API (learner side)

    def put(self, item: TrajectoryItem, timeout: Optional[float] = None,
            count_stall: bool = True) -> bool:
        """Local (learner-process) put, straight into the policy queue —
        remote producers use ``SocketActorClient``; this exists for the
        Transport contract and learner-internal requeues."""
        return self._inner.put(item, timeout=timeout,
                               count_stall=count_stall)

    def get(self, timeout: Optional[float] = None):
        return self._inner.get(timeout)

    def get_nowait(self):
        return self._inner.get_nowait()

    def requeue_front(self, item: TrajectoryItem) -> None:
        self._inner.requeue_front(item)

    # ------------------------------------------------------------------
    # lifecycle

    def begin_shutdown(self) -> None:
        """Flip to discard and tell every actor to stop: data conns keep
        draining (an actor mid-send can always finish its frame — no
        torn frames at shutdown), the local queue closes so learner-side
        consumers drain what's left, and the ``stop`` control frame
        sends remote actors into their exit path. Call before joining
        actor processes; call ``close`` after."""
        self._discard = True
        self._inner.close()
        with self._lock:
            chans = [s.ctrl for s in self._slots.values()
                     if s.ctrl is not None]
        # bounded PER CHANNEL: a wedged peer must not stall shutdown,
        # and must not consume the budget of the healthy actors behind
        # it in this loop (the frame is tiny; a live link takes it
        # instantly)
        for chan in chans:
            deadline = time.monotonic() + 2.0
            chan.send(KIND_CTRL, 0, CTRL_STOP,
                      stop=lambda d=deadline: time.monotonic() > d)

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.begin_shutdown()
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            chans = [c for s in self._slots.values()
                     for c in (s.ctrl, s.data) if c is not None]
            threads = list(self._threads)
        for chan in chans:
            chan.close()
        self._acceptor.join(timeout=5.0)
        for t in threads:
            t.join(timeout=5.0)
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def __len__(self) -> int:
        return len(self._inner)

    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        snap = self._inner.snapshot()
        now = time.monotonic()
        with self._lock:
            dt = (now - self._t0) if self._t0 is not None else 0.0
            per_actor = {
                s.actor_id: {
                    "frames": s.frames,
                    "bytes": s.bytes,
                    "losses": s.losses,
                    "torn_tails": s.torn_tails,
                    "reconnects": s.reconnects,
                    "queue_wait_ms_mean": (1e3 * s.wait_sum / s.wait_n
                                           if s.wait_n else 0.0),
                    "connected": (s.data is not None and not s.data.dead)
                    or (s.ctrl is not None and not s.ctrl.dead),
                    "last_seen_age_s": now - s.last_seen,
                    "lease_reaps": s.lease_reaps,
                }
                for s in self._slots.values()
            }
            frames = self.frames_in
            snap.update({
                "transport": "socket",
                "listen": list(self.address),
                "actors_seen": len(self._slots),
                "frames_in": frames,
                "bytes_in": self.bytes_in,
                "wire_codec": self.wire_codec,
                "traj_wire_bytes": self._c_traj_wire.value,
                "traj_raw_bytes": self._c_traj_raw.value,
                "bytes_per_frame": (self._c_traj_wire.value / frames
                                    if frames else 0.0),
                "wire_compression": (
                    self._c_traj_raw.value / self._c_traj_wire.value
                    if self._c_traj_wire.value else 1.0),
                "bytes_per_sec": (self.bytes_in / dt if dt > 0 else 0.0),
                "frames_per_sec": (self.frames_in / dt if dt > 0 else 0.0),
                "reconnects": self.reconnects,
                "torn_tails": self.torn_tails,
                "discarded": self.discarded,
                "heartbeats": self._c_heartbeats.value,
                "lease_reaps": self._c_lease_reaps.value,
                "elastic": self.elastic,
                "decode_errors": len(self.decode_errors),
                "remote_errors": len(self.errors),
                "per_actor": per_actor,
            })
        return snap


# SocketTransport satisfies the Transport interface structurally (it is
# defined in its own module so ``transport.py`` stays import-light);
# make isinstance() agree.
from repro_torch.distributed.transport import Transport  # noqa: E402

Transport.register(SocketTransport)


class _InferReplyBox:
    """Per-client mailbox for inference replies arriving on the ctrl
    reader thread; ``wake`` unblocks waiters on disconnect so they can
    notice the generation change and resubmit."""

    def __init__(self):
        self._cond = threading.Condition()
        self._replies: collections.deque = collections.deque()

    def put(self, payload: bytes) -> None:
        with self._cond:
            self._replies.append(payload)
            self._cond.notify_all()

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def get(self, timeout: float) -> Optional[bytes]:
        with self._cond:
            if not self._replies:
                self._cond.wait(timeout)
            if not self._replies:
                return None
            return self._replies.popleft()


class SocketActorClient:
    """Remote-actor side: dial the learner, learn who you are (the
    CONFIG handshake carries the actor id and the whole run config),
    then ship trajectories and pull params. Reconnects with exponential
    backoff; safe-resends frames whose write did not complete (the
    learner never sees a partial frame as data, so a resend cannot
    duplicate).

    ``stop_event`` (optional, any object with ``is_set``) composes an
    external shutdown signal with the learner's ``stop`` control frame;
    ``stopped`` reflects both."""

    def __init__(self, address: Address, *,
                 stop_event: Optional[Any] = None,
                 backoff: Tuple[float, float] = (0.05, 1.0),
                 dial_timeout: float = 60.0,
                 heartbeat_s: Optional[float] = None):
        import uuid
        self._addr = tuple(address)
        self._tried_addrs: set = set()  # learners that refused us
        self._backoff = backoff
        self._dial_timeout = dial_timeout
        self._ext_stop = stop_event
        self._stopped = threading.Event()
        # idempotent-handshake token: a severed HELLO/CONFIG exchange
        # retried with the same nonce reuses the slot it already got
        self._nonce = uuid.uuid4().hex
        # per-client decorrelated backoff jitter: a fleet of actors
        # reconnecting to a restarted learner must not dial in phase
        self._rng = random.Random(self._nonce)
        self.dial_failed = False        # dial_timeout exhausted mid-run
        self.refused = False            # learner had no free actor slot
        self._chans: Dict[str, Optional[FrameChannel]] = {"ctrl": None,
                                                          "data": None}
        self._gen = {"ctrl": 0, "data": 0}
        self._dial_lock = threading.Lock()
        import queue as stdlib_queue
        self._param_q: "stdlib_queue.Queue" = stdlib_queue.Queue()
        self._infer_boxes: Dict[int, _InferReplyBox] = {}
        self._boxes_lock = threading.Lock()
        self.config: Dict[str, Any] = {}
        self.actor_id = -1
        self.wire_codec = serde.DEFAULT_CODEC   # set by the handshake
        self.reconnects = 0
        self.trajs_sent = 0
        self.heartbeat_s = heartbeat_s  # None: the learner's CONFIG decides
        self._hb_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set() or (
            self._ext_stop is not None and self._ext_stop.is_set())

    @property
    def connected_addr(self) -> Address:
        """The learner this client actually ended up on: differs from
        the dialed address after a refused-with-shard-map spill."""
        return tuple(self._addr)

    def _stop_check(self) -> bool:
        return self.stopped

    def _jittered(self, delay: float) -> float:
        """Decorrelate a backoff sleep: uniform in [delay/2, delay],
        capped by the backoff ceiling. Half-jitter keeps retries fast
        while spreading a fleet's redials across the window."""
        cap = self._backoff[1]
        return min(self._rng.uniform(delay * 0.5, delay), cap)

    def connect(self) -> Optional[Dict[str, Any]]:
        """Dial ctrl (handshake: HELLO up, CONFIG down) then data.
        Returns the config dict, or None if stopped/refused."""
        if self._channel("ctrl") is None:
            return None
        if self._channel("data") is None:
            return None
        interval = self.heartbeat_s or self.config.get("heartbeat_s")
        if interval and self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(float(interval),),
                name="socket-heartbeat", daemon=True)
            self._hb_thread.start()
        return self.config

    def _heartbeat_loop(self, interval: float) -> None:
        """Liveness beacon: a KIND_HEARTBEAT on ctrl every ``interval``
        seconds, so the learner's reaper tells a live but quiet actor
        (long episode, backpressured data link) from a dead one.
        Best-effort: a dead ctrl link is redialed by ``_channel``; a
        failed send is retried next tick."""
        while not self.stopped:
            if self._stopped.wait(interval):
                break
            try:
                chan = self._channel("ctrl")
                if chan is not None and not chan.dead:
                    chan.send(KIND_HEARTBEAT, 0, b"",
                              stop=self._stop_check)
            except Exception:   # liveness must never kill the actor
                pass

    # ------------------------------------------------------------------
    # connection management

    def _channel(self, role: str) -> Optional[FrameChannel]:
        chan = self._chans[role]
        if chan is not None and not chan.dead:
            return chan
        with self._dial_lock:
            chan = self._chans[role]            # raced a redialer?
            if chan is not None and not chan.dead:
                return chan
            if self.stopped:
                return None
            if chan is not None:
                chan.close()
                self.reconnects += 1
            fresh = self._dial(role)
            self._chans[role] = fresh
            if fresh is not None:
                self._gen[role] += 1
                if role == "ctrl":
                    t = threading.Thread(
                        target=self._ctrl_reader, args=(fresh,),
                        name="socket-ctrl-reader", daemon=True)
                    t.start()
            return fresh

    def _dial(self, role: str) -> Optional[FrameChannel]:
        delay = self._backoff[0]
        deadline = time.monotonic() + self._dial_timeout
        while not self.stopped and time.monotonic() < deadline:
            try:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                if role == "data":
                    # mirror the learner's receive cap (arrives in the
                    # CONFIG handshake): trajectory bytes the kernel
                    # would buffer are policy-invisible pipeline depth
                    buf = int(self.config.get("data_buf", 0) or 0)
                    if buf:
                        try:
                            sock.setsockopt(socket.SOL_SOCKET,
                                            socket.SO_SNDBUF, buf)
                        except OSError:  # pragma: no cover
                            pass
                sock.settimeout(1.0)
                sock.connect(self._addr)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                time.sleep(min(self._jittered(delay),
                               max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2, self._backoff[1])
                continue
            chan = FrameChannel(sock)
            hello = json.dumps({"role": role,
                                "actor_id": self.actor_id,
                                "nonce": self._nonce}).encode()
            if not chan.send(KIND_HELLO, 0, hello,
                             stop=self._stop_check):
                chan.close()
                continue
            if role == "data":
                return chan
            # ctrl: the handshake's reply is the run config
            try:
                kind, _stream, payload = chan.recv(stop=self._stop_check)
            except (Disconnected, serde.SerdeError):
                chan.close()
                time.sleep(self._jittered(delay))
                delay = min(delay * 2, self._backoff[1])
                continue
            if kind == KIND_CTRL and (
                    payload == CTRL_STOP or
                    payload.startswith(CTRL_REFUSED)):
                chan.close()
                if payload.startswith(CTRL_REFUSED):
                    # refused with a shard map: this learner's shard is
                    # full, but the refusal names its peers, so spill to
                    # the first one not tried yet. A wildcard bind host
                    # in the map is not dialable from here: the group's
                    # learners share one machine (port+k), so take the
                    # host this learner was reached on
                    spill = [((self._addr[0], p)
                              if h in ("0.0.0.0", "::", "") else (h, p))
                             for h, p in self._spill_addrs(payload)]
                    self._tried_addrs.add(tuple(self._addr))
                    nxt = next((a for a in spill
                                if a not in self._tried_addrs), None)
                    if nxt is not None:
                        self._addr = nxt
                        delay = self._backoff[0]
                        continue
                    self.refused = True
                else:
                    self.refused = False
                self._stopped.set()             # run closing / no slot
                return None
            if kind != KIND_CONFIG:
                chan.close()
                continue
            cfg = json.loads(payload.decode("utf-8"))
            # codec negotiation: the learner announced how this fleet
            # encodes the wire. A codec we don't speak must refuse NOW
            # with a distinct error — encoding frames the learner can't
            # decode (or vice versa) would surface as garbage decodes
            # or silent corruption deep in training instead
            try:
                self.wire_codec = serde.check_codec(
                    cfg.get("wire_codec", serde.DEFAULT_CODEC))
            except serde.CodecMismatchError:
                chan.send(KIND_CTRL, 0, CTRL_BYE, stop=self._stop_check)
                chan.close()
                self._stopped.set()
                raise
            self.actor_id = int(cfg.get("actor_id", self.actor_id))
            self.config = cfg
            return chan
        if not self.stopped:
            # dial_timeout exhausted on a live run: wedging silently in
            # a retry loop (or acting on frozen params) would hide the
            # outage — fail the actor visibly instead. The learner sees
            # a nonzero child exit (spawned) or an operator sees the
            # returned error (external machine).
            self.dial_failed = True
            self._stopped.set()
        return None

    @staticmethod
    def _spill_addrs(payload: bytes) -> List[Tuple[str, int]]:
        """The optional shard-map suffix of a refusal payload
        (``b"refused [[host, port], ...]"``); [] when absent or garbled."""
        rest = payload[len(CTRL_REFUSED):].strip()
        if not rest:
            return []
        try:
            addrs = json.loads(rest.decode("utf-8"))
            return [(str(h), int(p)) for h, p in addrs]
        except (ValueError, TypeError):
            return []

    def _ctrl_reader(self, chan: FrameChannel) -> None:
        while not self.stopped:
            try:
                kind, stream, payload = chan.recv(stop=self._stop_check)
            except (Disconnected, serde.SerdeError):
                chan.dead = True
                break
            if kind == KIND_PARAM:
                (version,) = _I64.unpack(payload[:_I64.size])
                self._param_q.put(("params", int(version),
                                   payload[_I64.size:]))
            elif kind == KIND_PARAM_KEEP:
                self._param_q.put(("keep",))
            elif kind == KIND_INFER_REP:
                with self._boxes_lock:
                    box = self._infer_boxes.get(stream)
                if box is not None:
                    box.put(payload)
            elif kind == KIND_CTRL and payload == CTRL_STOP:
                self._stopped.set()
                break
            # KIND_CONFIG re-sent on reconnect: already held, ignore
        with self._boxes_lock:
            boxes = list(self._infer_boxes.values())
        for box in boxes:
            box.wake()

    # ------------------------------------------------------------------
    # actor-facing API

    def send_traj(self, buf: bytes) -> bool:
        """Ship one encoded trajectory; blocks under learner
        backpressure (TCP flow control), reconnects on a dead link,
        False only when stopping."""
        while not self.stopped:
            chan = self._channel("data")
            if chan is None:
                return False
            if chan.send(KIND_TRAJ, 0, buf, stop=self._stop_check):
                self.trajs_sent += 1
                return True
            # dead mid-frame: the learner discarded the torn tail, so
            # resending the whole frame on a fresh link is duplicate-free
        return False

    def pull_params(self, have_version: int,
                    timeout: float = 2.0) -> Optional[Tuple]:
        """Version-gated pull over ctrl: ("params", version, buf) |
        ("keep",) | None on shutdown. Retries across reconnects; the
        reply wait doubles per retry (capped) so a large param frame on
        a slow link is not re-requested while it is still streaming —
        each redundant request would queue ANOTHER full-size reply
        behind the one in flight."""
        import queue as stdlib_queue
        wait = timeout
        while not self.stopped:
            try:                # drop replies from a timed-out attempt
                while True:
                    self._param_q.get_nowait()
            except stdlib_queue.Empty:
                pass
            chan = self._channel("ctrl")
            if chan is None:
                return None
            if not chan.send(KIND_PARAM_REQ, 0,
                             _I64.pack(int(have_version)),
                             stop=self._stop_check):
                continue
            try:
                return self._param_q.get(timeout=wait)
            except stdlib_queue.Empty:
                wait = min(wait * 2, 30.0)
                continue        # link died or learner slow: retry
        return None

    def ctrl_send(self, kind: int, stream_id: int = 0,
                  payload: bytes = b"") -> bool:
        while not self.stopped:
            chan = self._channel("ctrl")
            if chan is None:
                return False
            if chan.send(kind, stream_id, payload,
                         stop=self._stop_check):
                return True
        return False

    def ctrl_gen(self) -> int:
        return self._gen["ctrl"]

    def ensure_ctrl(self) -> Optional[FrameChannel]:
        """Redial the ctrl link if it died — the liveness hook for
        pollers (an inference client waiting on a reply must be the one
        to notice the dead link, or nobody bumps the generation)."""
        return self._channel("ctrl")

    def infer_box(self, client_id: int) -> _InferReplyBox:
        with self._boxes_lock:
            box = self._infer_boxes.get(client_id)
            if box is None:
                box = self._infer_boxes[client_id] = _InferReplyBox()
            return box

    def send_error(self, text: str) -> None:
        try:
            self.ctrl_send(KIND_ERROR, 0, text.encode("utf-8"))
        except Exception:
            pass

    def close(self, bye: bool = True) -> None:
        """Clean exit: say ``bye`` on both links (so the learner knows
        the EOF that follows is a handshake, not a torn frame), then
        close and stop."""
        for role in ("data", "ctrl"):
            chan = self._chans[role]
            if chan is not None:
                if bye and not chan.dead:
                    chan.send(KIND_CTRL, 0, CTRL_BYE,
                              stop=self._stop_check)
                chan.close()
        self._stopped.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        with self._boxes_lock:
            boxes = list(self._infer_boxes.values())
        for box in boxes:
            box.wake()
