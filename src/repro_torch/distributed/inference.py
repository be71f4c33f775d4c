"""Dynamic-batching inference service (``repro.distributed.inference``;
paper §3.1's batched actor inference, service-shaped).

Instead of every actor paying a full policy forward for its own env
batch, actors in ``actor_mode='inference'`` become thin host-side env
steppers: each submits its per-step observation batch to one
``InferenceService`` that lives next to the learner, runs one batched
per-step conv-LSTM forward on the learner's device, and replies with
actions, behaviour log-probs, the next recurrent state, and the
parameter version it acted with. The service collects requests into
**power-of-two-bucketed** batches and flushes on whichever comes first:

  full      a max-size bucket of requests is pending;
  ready     every connected client has a request in (nobody else can
            submit — waiting longer is pure stall);
  timeout   the oldest pending request has waited ``flush_timeout_s``
            (stragglers don't gate the fleet).

A partial flush is padded up to its bucket by repeating the last request
(its duplicate replies are discarded), so the forward sees at most
log2 shapes. Each bucket runs the forward eagerly.

Two client frontends share the service core:

  thread    ``service.connect()`` clients submit live numpy requests on
            a lock-protected deque and get replies through an Event.
            Their threads run the flushes themselves (leader-executed
            flushes, ``submit_and_wait``; ``drive_flushes`` for the
            one-thread inference driver; a ``wait`` past the flush
            deadline flushes the stragglers).
  process   ``service.process_frontend(ctx, n)``: requests travel as
            serde-encoded frames over a bounded multiprocessing wire,
            replies go back serde-encoded over a per-client pipe. Such
            requests have no waiting thread in this process, so
            attaching a frontend starts the service's own flusher thread
            (``_loop``), which applies the full/ready/timeout rules and
            so honours ``flush_timeout_s`` as a deadline. The socket
            transport's frontend (``netserve``) attaches the same way.

On the card a flush is one round trip: the requests are packed into one
pinned host buffer and cross to the card in one copy, on the service's
own CUDA stream, which first waits for the event the learner recorded
after writing the published params (pulled from the ``ParameterStore``
once a flush); the actions, log-probs and (h, c) are packed on the card
and come back in one copy, which the flush waits for before it replies.
Actions are sampled on the device from the service's own
``torch.Generator``, seeded from ``np.random.SeedSequence((seed, 0x1f5))``
in place of the reference's ``fold_in(key(seed), 0x1f5)`` key.

The service is deliberately limited to the paper's conv-LSTM agent
(``impala_cnn``): its per-step state is the explicit (h, c) pair the
client carries, so the service itself stays stateless and any flush can
mix any clients.

Telemetry: per-flush batch-size histogram, full/ready/timeout flush
counts, and request queue-wait quantiles, in a ``Registry``
(``snapshot()``, the learner's ``inference`` section).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import actor as actor_lib
from repro_torch.distributed import serde
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.models import backbone as bb
from repro_torch.params import tree_leaves

PyTree = Any

_STOP_FRAME = b""          # reply-pipe sentinel: service shut down


def require_cnn(arch_cfg) -> None:
    """The service batches the conv-LSTM's per-step policy only."""
    if arch_cfg.family != "impala_cnn":
        raise ValueError(
            "InferenceService batches the per-step conv-LSTM policy; "
            f"family {arch_cfg.family!r} decodes against a per-client "
            "cache — use actor_mode='unroll'")


class InferenceReply(NamedTuple):
    """One client's slice of a flushed batch (numpy)."""
    action: Any                # (B,) int32
    logprob: Any               # (B,) f32 — behaviour log pi(a|x)
    lstm_state: Tuple[Any, Any]  # ((B, W), (B, W)) next recurrent state
    param_version: int


class _Pending(NamedTuple):
    data: PyTree               # request dict of numpy leaves
    reply_fn: Callable[[Optional[InferenceReply]], None]
    submitted_at: float


class _Waiter:
    """Handle for an async in-process submission."""
    __slots__ = ("event", "slot")

    def __init__(self):
        self.event = threading.Event()
        self.slot: List[Optional[InferenceReply]] = [None]

    def deliver(self, r: Optional[InferenceReply]) -> None:
        self.slot[0] = r
        self.event.set()


def _wait_bucket(wait_s: float) -> int:
    """Power-of-two microsecond bucket for a queue wait: bucket ``k``
    covers ``[2^(k-1), 2^k)`` µs (k=0 is the sub-µs bucket)."""
    return max(0, int(wait_s * 1e6)).bit_length()


def _hist_quantile_ms(counts: Dict[int, int], q: float) -> float:
    """The q-quantile's bucket *upper bound* in ms, from a
    ``_wait_bucket`` histogram (a factor-of-two resolution)."""
    total = sum(counts.values())
    if not total:
        return 0.0
    rank = q * total
    acc = 0
    for k in sorted(counts):
        acc += counts[k]
        if acc >= rank:
            return (1 << k) / 1e3
    return (1 << max(counts)) / 1e3


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class _Layout:
    """One packed byte row per env: the image's bytes, then the int32
    last action, the f32 last reward, the done flag as f32, h and c,
    each field 4-byte aligned, so a batch of requests is one (N, row)
    uint8 buffer and crosses to the card in one copy."""

    def __init__(self, image_hw, width: int):
        self.image_hw = tuple(image_hw)
        self.img_bytes = int(np.prod(self.image_hw))
        self.f_off = (self.img_bytes + 3) // 4 * 4
        self.width = width
        self.row = self.f_off + 4 * (3 + 2 * width)

    def pack(self, reqs: List[Dict], out: np.ndarray) -> None:
        """Write the requests' rows into ``out`` (N, row) uint8."""
        fl = out.view(np.float32)
        c0, w = self.f_off // 4, self.width
        off = 0
        for r in reqs:
            b = r["last_action"].shape[0]
            out[off:off + b, :self.img_bytes] = r["obs_image"].reshape(b, -1)
            f = fl[off:off + b, c0:]
            f[:, 0].view(np.int32)[:] = r["last_action"]
            f[:, 1] = r["last_reward"]
            f[:, 2] = r["done"]
            f[:, 3:3 + w] = r["lstm_h"]
            f[:, 3 + w:] = r["lstm_c"]
            off += b

    def unpack(self, buf: torch.Tensor) -> Dict:
        """The model batch of a packed (N, row) uint8 tensor (views)."""
        n = buf.shape[0]
        f = buf.view(torch.float32)[:, self.f_off // 4:]
        w = self.width
        return {
            "image": buf[:, :self.img_bytes].reshape(
                (n, 1) + self.image_hw),
            "last_action": f[:, 0:1].view(torch.int32),
            "last_reward": f[:, 1:2],
            "done": f[:, 2:3] != 0,
            "lstm_state": (f[:, 3:3 + w], f[:, 3 + w:]),
        }


class InferenceService:
    """One batched per-step policy forward, shared by all actors.

    Request dict (numpy leaves batched over the client's envs)::

        {"obs_image": (B,H,W,C) u8, "last_action": (B,) i32,
         "last_reward": (B,) f32, "done": (B,) bool,
         "lstm_h": (B,W) f32, "lstm_c": (B,W) f32}

    Params come from the ``ParameterStore`` (pulled once per flush), so
    the behaviour policy advances with the learner and every reply is
    stamped with the version that produced it — the client stamps its
    trajectory with the version of the unroll's *first* step, keeping
    measured policy lag conservative. The forward runs on the device of
    the store's params.
    """

    def __init__(self, env, arch_cfg, icfg, store: ParameterStore, *,
                 num_clients: int, flush_timeout_s: float = 0.02,
                 max_batch_requests: Optional[int] = None, seed: int = 0,
                 rng_key=None, registry=None):
        """``rng_key`` (an int) overrides ``seed`` as the sampling
        stream's seed: a learner group passes each member's
        ``fold_replay_seed(seed, learner_id)``, so no two learners'
        services share an action-sampling stream. The JAX package passes
        a folded PRNG key there; the port seeds a ``torch.Generator``."""
        require_cnn(arch_cfg)
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        del icfg
        self._arch = arch_cfg
        self._num_actions = env.num_actions
        self._store = store
        self._layout = _Layout(env.image_hw, arch_cfg.lstm_width)
        self.flush_timeout_s = flush_timeout_s
        self.max_batch_requests = _pow2_floor(
            max_batch_requests or num_clients)
        self.device = tree_leaves(store.pull()[0])[0].device
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        base = seed if rng_key is None else int(rng_key)
        self._gen = torch.Generator(device=self.device).manual_seed(int(
            np.random.SeedSequence((base, 0x1f5)).generate_state(1)[0]))
        self._gen_lock = threading.Lock()

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: collections.deque = collections.deque()
        self._clients = 0           # connected clients (both frontends)
        self._paused = 0            # clients blocked outside the service
        self._stop = threading.Event()
        self._frontends: List[Any] = []
        self.errors: List[BaseException] = []
        # the background flusher serves frontends only: thread clients
        # flush for themselves
        self._thread = threading.Thread(target=self._loop,
                                        name="inference-service",
                                        daemon=True)
        self._started = False
        self._loop_needed = False

        # telemetry: written under self._lock, read by snapshot()
        if registry is None:
            from repro_torch.obs.metrics import Registry
            registry = Registry()
        self.registry = registry
        self.batch_hist = registry.int_histogram(
            "inference.batch_hist").counts
        self.wait_hist = registry.int_histogram(
            "inference.queue_wait_hist").counts
        self._c_requests = registry.counter("inference.requests")
        self._c_frames = registry.counter("inference.frames")
        self.flush_full = 0
        self.flush_ready = 0
        self.flush_timeouts = 0
        self.padded_requests = 0
        self._last_version = -1

    # counter views (the registry instruments are the storage)

    @property
    def requests(self) -> int:
        return self._c_requests.value

    @property
    def frames(self) -> int:
        return self._c_frames.value

    # ------------------------------------------------------------------
    # the flush: pack K requests -> one forward -> sample

    def forward(self, params, batch: Dict) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
        """The policy step of a model batch: (logits (N, A), h, c)."""
        with torch.no_grad():
            out = bb.apply_train(params, batch, self._arch,
                                 self._num_actions)
        h, c = out.cache
        return out.policy_logits[:, 0], h, c

    def _loop(self) -> None:
        """The flusher thread of the frontends: flush whenever the rules
        say so, sleeping until the oldest request's deadline otherwise."""
        try:
            while not self._stop.is_set():
                with self._cond:
                    batch, reason = self._take_locked()
                    if batch is None:
                        remaining = 0.05
                        if self._pending:
                            oldest = self._pending[0].submitted_at
                            remaining = max(0.0, self.flush_timeout_s -
                                            (time.monotonic() - oldest))
                        self._cond.wait(min(0.05, remaining))
                        continue
                self._run_flush(batch, reason)
        except BaseException as e:     # surfaces in the learner thread
            self.errors.append(e)
            self.stop()

    def _take_locked(self) -> Tuple[Optional[List[_Pending]], str]:
        """Decide (under the lock) whether to flush now; pops the batch."""
        n = len(self._pending)
        if n == 0:
            return None, ""
        active = self._clients - self._paused
        if n >= self.max_batch_requests:
            k, reason = self.max_batch_requests, "full"
        elif self._clients and n >= max(1, active):
            # every client that *can* submit has a request in (paused
            # ones are blocked elsewhere, on trajectory backpressure):
            # waiting out the timeout cannot grow the batch. Take
            # everything up to the bucket — the flush pads partial
            # batches
            k, reason = min(n, self.max_batch_requests), "ready"
        elif (time.monotonic() - self._pending[0].submitted_at
                >= self.flush_timeout_s):
            k, reason = min(n, self.max_batch_requests), "timeout"
        else:
            return None, ""
        return [self._pending.popleft() for _ in range(k)], reason

    def _run_flush(self, batch: List[_Pending], reason: str) -> None:
        """Run one flush on the calling thread and deliver its replies.
        Flushes may run concurrently (leader clients); only the sampling
        generator is shared between them, and is drawn under a lock."""
        k = len(batch)
        kb = min(_pow2_ceil(k), self.max_batch_requests)
        reqs = [p.data for p in batch] + [batch[-1].data] * (kb - k)
        lay = self._layout
        n = sum(r["last_action"].shape[0] for r in reqs)
        cuda = self._stream is not None
        host = torch.empty((n, lay.row), dtype=torch.uint8, pin_memory=cuda)
        lay.pack(reqs, host.numpy())
        params, version, ready = self._store.pull_ready()
        now = time.monotonic()
        with torch.cuda.stream(self._stream):
            if ready is not None:
                self._stream.wait_event(ready)
            buf = host.to(self.device, non_blocking=True)
            logits, h, c = self.forward(params, lay.unpack(buf))
            with self._gen_lock:
                action = actor_lib.sample(self._gen, logits)
            logp = actor_lib.action_logprob(logits, action)
            # one (N, 2 + 2W) f32 reply: action (exact in f32), log-prob,
            # h, c
            out = torch.cat([action.to(torch.float32)[:, None],
                             logp[:, None], h, c], dim=1)
            if cuda:
                reply = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
                reply.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
                done.synchronize()
            else:
                reply = out
        r = reply.numpy()
        w = lay.width
        actions = r[:, 0].astype(np.int32)

        with self._lock:        # snapshot() reads these concurrently
            self.batch_hist[k] += 1
            if reason == "full":
                self.flush_full += 1
            elif reason == "ready":
                self.flush_ready += 1
            else:
                self.flush_timeouts += 1
            self._c_requests.inc(k)
            self.padded_requests += kb - k
            self._last_version = version
            for p in batch:
                self._c_frames.inc(p.data["last_action"].shape[0])
                self.wait_hist[_wait_bucket(now - p.submitted_at)] += 1
        off = 0
        for p in batch:
            b = p.data["last_action"].shape[0]
            rows = slice(off, off + b)
            try:
                p.reply_fn(InferenceReply(
                    actions[rows], r[rows, 1],
                    (r[rows, 2:2 + w], r[rows, 2 + w:]), version))
            except Exception as e:      # a dead pipe must not kill a flush
                self.errors.append(e)
            off += b

    # ------------------------------------------------------------------
    # submission + thread frontend

    def submit(self, data: PyTree,
               reply_fn: Callable[[Optional[InferenceReply]], None],
               submitted_at: Optional[float] = None) -> bool:
        """Queue one request for the background flusher; False iff the
        service is shut down (no reply comes). The frontends' path."""
        with self._cond:
            if self._stop.is_set():
                return False
            self._pending.append(_Pending(
                data, reply_fn, submitted_at or time.monotonic()))
            self._cond.notify()
        return True

    def submit_async(self, data: PyTree) -> Optional[_Waiter]:
        """Queue one request and return a waiter (None if shut down).
        The caller, another client's thread or the flusher flushes it."""
        w = _Waiter()
        with self._cond:
            if self._stop.is_set():
                return None
            self._pending.append(_Pending(data, w.deliver,
                                          time.monotonic()))
            self._cond.notify()
        return w

    def wait(self, w: _Waiter) -> Optional[InferenceReply]:
        """Block until the waiter's flush lands. A waiter whose wait
        crosses the flush deadline turns **leader** and runs the partial
        flush itself. Returns None on shutdown."""
        while True:
            if w.event.wait(timeout=self.flush_timeout_s):
                return w.slot[0]
            if self._stop.is_set():
                return None
            with self._cond:
                batch, reason = self._take_locked()
            if batch is not None:
                self._run_flush(batch, reason)

    def submit_and_wait(self, data: PyTree) -> Optional[InferenceReply]:
        """Blocking submit, with **leader-executed flushes**: if this
        request completes a bucket (or makes every connected client
        pending), the submitting thread runs the flush itself. Returns
        None on shutdown."""
        with self._cond:
            if self._stop.is_set():
                return None
            w = _Waiter()
            self._pending.append(_Pending(data, w.deliver,
                                          time.monotonic()))
            batch, reason = self._take_locked()
        while batch is not None:
            self._run_flush(batch, reason)
            # the popped batch is the *oldest* pending; with more
            # requesters than the bucket holds, ours may not be in it
            if w.event.is_set():
                return w.slot[0]
            with self._cond:
                batch, reason = self._take_locked()
        return self.wait(w)

    def drive_flushes(self) -> None:
        """Flush everything pending, now, on the calling thread — the hot
        path of the single-threaded inference driver, which knows nobody
        else is about to submit: no full/ready/timeout rule, no
        cross-thread wake-up."""
        while True:
            with self._cond:
                n = len(self._pending)
                if n == 0:
                    return
                k = min(n, self.max_batch_requests)
                batch = [self._pending.popleft() for _ in range(k)]
            self._run_flush(
                batch, "full" if k >= self.max_batch_requests else "ready")

    def connect(self) -> "InferenceClient":
        with self._lock:
            self._clients += 1
        return InferenceClient(self)

    def _disconnect(self) -> None:
        with self._cond:
            self._clients = max(0, self._clients - 1)
            self._cond.notify()     # remaining pending may now be "ready"

    def _pause(self) -> None:
        """A client blocked outside the service (its transport put is
        backpressured): stop counting it towards the ready rule, so the
        others' batches flush without waiting out the deadline for it."""
        with self._cond:
            self._paused += 1
            self._cond.notify()

    def _resume(self) -> None:
        with self._cond:
            self._paused = max(0, self._paused - 1)

    def attach_frontend(self, fe, num_clients: int = 0) -> None:
        """Register a frontend (process pipes, sockets): count its clients
        towards the ready rule and make sure the flusher thread runs,
        since frontend submits have no waiting thread here."""
        with self._lock:
            self._clients += num_clients
        self._frontends.append(fe)
        self._loop_needed = True
        if self._started and not self._thread.is_alive():
            self._thread.start()

    def process_frontend(self, ctx, num_clients: int,
                         wire_capacity: Optional[int] = None
                         ) -> "ProcessFrontend":
        fe = ProcessFrontend(self, ctx, num_clients, wire_capacity)
        # clients are counted per register() call, not up front
        self.attach_frontend(fe, num_clients=0)
        return fe

    # ------------------------------------------------------------------
    # lifecycle

    def start(self) -> None:
        if not self._started:
            self._started = True
            if self._loop_needed:
                self._thread.start()

    def stop(self) -> None:
        """Shut down: wake every blocked client with a None reply. Safe
        to call from any thread, idempotent. Process frontends are closed
        by the pool that made them, after its children joined."""
        with self._cond:
            if self._stop.is_set():
                return
            self._stop.set()
            drained = list(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        for p in drained:
            try:
                p.reply_fn(None)
            except Exception:
                pass
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def raise_errors(self) -> None:
        if self.errors:
            raise RuntimeError("inference service failed") from \
                self.errors[0]

    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            waits = dict(self.wait_hist)
            flushes = (self.flush_full + self.flush_ready +
                       self.flush_timeouts)
            return {
                "flushes": flushes,
                "flush_full": self.flush_full,
                "flush_ready": self.flush_ready,
                "flush_timeout": self.flush_timeouts,
                "batch_size_hist": dict(sorted(self.batch_hist.items())),
                "requests": self.requests,
                "padded_requests": self.padded_requests,
                "frames": self.frames,
                "mean_batch": (self.requests / flushes if flushes else 0.0),
                "queue_wait_hist": dict(sorted(waits.items())),
                "queue_wait_ms_p50": _hist_quantile_ms(waits, 0.50),
                "queue_wait_ms_p95": _hist_quantile_ms(waits, 0.95),
                "flush_timeout_s": self.flush_timeout_s,
                "max_batch_requests": self.max_batch_requests,
                "param_version": self._last_version,
            }


class InferenceClient:
    """Thread-mode client: blocking ``infer`` against the in-process
    service (leader-executed flushes — see ``submit_and_wait``). One
    outstanding request per client by construction."""

    def __init__(self, service: InferenceService):
        self._svc = service
        self._paused = False

    def infer(self, data: PyTree) -> Optional[InferenceReply]:
        """None means the service shut down: stop producing."""
        return self._svc.submit_and_wait(data)

    def submit_async(self, data: PyTree) -> Optional[_Waiter]:
        """Pipeline half of ``infer``; pair with ``wait``."""
        return self._svc.submit_async(data)

    def wait(self, w: Optional[_Waiter]) -> Optional[InferenceReply]:
        return None if w is None else self._svc.wait(w)

    def pause(self) -> None:
        """This client left the request loop (transport backpressure):
        batches do not wait for it. Idempotent."""
        if not self._paused:
            self._paused = True
            self._svc._pause()

    def resume(self) -> None:
        if self._paused:
            self._paused = False
            self._svc._resume()

    def close(self) -> None:
        self.resume()       # a paused client must not leak the count
        self._svc._disconnect()


def _encode_reply(r: InferenceReply, meta: Dict[str, Any]) -> bytes:
    return serde.encode_tree(
        {"action": np.asarray(r.action),
         "logprob": np.asarray(r.logprob),
         "lstm_h": np.asarray(r.lstm_state[0]),
         "lstm_c": np.asarray(r.lstm_state[1])}, meta=meta)


def _decode_reply(buf: bytes) -> Tuple[InferenceReply, Dict[str, Any]]:
    tree, meta = serde.decode_tree(buf, copy=True)
    return (InferenceReply(tree["action"], tree["logprob"],
                           (tree["lstm_h"], tree["lstm_c"]),
                           int(meta["version"])), meta)


class ProcessFrontend:
    """Parent-side bridge for actor *processes*: serde request frames in
    over one bounded wire, encoded replies out over per-client pipes.

    Mirrors ``ShmTransport``'s shutdown discipline: ``begin_shutdown``
    flips the drain loop to discard so children winding down can always
    flush their queue feeders; ``close`` (after the children are joined)
    tears the wire down."""

    def __init__(self, service: InferenceService, ctx, num_clients: int,
                 wire_capacity: Optional[int] = None):
        self._svc = service
        self._ctx = ctx
        self._wire = ctx.Queue(maxsize=wire_capacity or
                               max(2, num_clients * 2))
        self._reply_conns: Dict[int, Any] = {}
        self._paused_cids: set = set()
        self._discard = False
        self._stop_evt = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="inference-frontend",
                                        daemon=True)

    def register(self, client_id: int) -> "PipeInferenceClient":
        """The picklable child-side handle of one client (one pipeline
        stream of one actor process). Call before spawning; the parent
        keeps the reply send-end."""
        recv_conn, send_conn = self._ctx.Pipe(duplex=False)
        self._reply_conns[client_id] = send_conn
        with self._svc._lock:
            self._svc._clients += 1
        return PipeInferenceClient(client_id, self._wire, recv_conn)

    def start(self) -> None:
        self._thread.start()

    def _reply_fn_for(self, client_id: int
                      ) -> Callable[[Optional[InferenceReply]], None]:
        conn = self._reply_conns[client_id]

        def reply(r: Optional[InferenceReply]) -> None:
            buf = (_STOP_FRAME if r is None else
                   _encode_reply(r, {"version": int(r.param_version)}))
            try:
                conn.send_bytes(buf)
            except (OSError, BrokenPipeError, ValueError):
                pass                    # client exited first: fine

        return reply

    def _loop(self) -> None:
        import queue as stdlib_queue
        while not self._stop_evt.is_set():
            try:
                buf = self._wire.get(timeout=0.1)
            except stdlib_queue.Empty:
                continue
            except (EOFError, OSError):
                break
            try:
                data, meta = serde.decode_tree(buf)   # zero-copy views
            except serde.SerdeError as e:
                self._svc.errors.append(e)
                continue
            cid = int(meta["client"])
            ctl = meta.get("ctl")
            if ctl is not None:
                # pause/resume hints, tracked per client id so duplicated
                # or reordered hints never over- or under-count the
                # service's paused total
                if ctl == "pause" and cid not in self._paused_cids:
                    self._paused_cids.add(cid)
                    self._svc._pause()
                elif ctl == "resume" and cid in self._paused_cids:
                    self._paused_cids.discard(cid)
                    self._svc._resume()
                continue
            if self._discard or self._svc.closed:
                # shutdown: keep the wire flowing so child feeders can
                # always flush, and unblock the sender promptly
                self._reply_fn_for(cid)(None)
                continue
            if not self._svc.submit(data, self._reply_fn_for(cid),
                                    float(meta.get("t0",
                                                   time.monotonic()))):
                self._reply_fn_for(cid)(None)

    def begin_shutdown(self) -> None:
        """Flip to discard: the wire keeps draining but nothing reaches
        the service anymore."""
        self._discard = True

    def close(self) -> None:
        """Call after the client processes are joined."""
        if self._closed:
            return
        self._closed = True
        self._discard = True
        self._stop_evt.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        try:
            while True:
                self._wire.get_nowait()
        except Exception:
            pass
        self._wire.close()
        self._wire.cancel_join_thread()
        for conn in self._reply_conns.values():
            try:
                conn.close()
            except OSError:
                pass


class PipeInferenceClient:
    """Picklable child-side handle: encodes the request tree, ships it
    over the shared wire, blocks (stop-aware) on its private reply pipe.
    Moves only serde buffers."""

    def __init__(self, client_id: int, wire: Any, conn: Any):
        self._id = client_id
        self._wire = wire
        self._conn = conn
        self._stop: Optional[Any] = None    # bound by the child at start
        self._paused = False

    def bind_stop(self, stop_event: Any) -> None:
        self._stop = stop_event

    def _send_ctl(self, ctl: str, tries: int = 1) -> None:
        import queue as stdlib_queue
        buf = serde.encode_tree(None, meta={"client": self._id,
                                            "ctl": ctl})
        for _ in range(tries):
            if self._stop is not None and self._stop.is_set():
                return
            try:
                self._wire.put(buf, timeout=0.05)
                return
            except stdlib_queue.Full:
                continue
            except Exception:
                return                  # closed wire: shutting down

    def pause(self) -> None:
        """Tell the service this client left the request loop. A tiny
        meta-only control frame rides the same FIFO wire, behind this
        client's requests. Best-effort: a lost pause costs the others one
        flush-deadline wait."""
        if not self._paused:
            self._paused = True
            self._send_ctl("pause")

    def resume(self) -> None:
        """A lost *resume* would leave the service under-counting active
        clients for the rest of the run, so it retries hard."""
        if self._paused:
            self._paused = False
            self._send_ctl("resume", tries=40)

    def submit_async(self, data: PyTree) -> Optional[bool]:
        """Ship the request frame; ``wait`` reads the reply. One
        outstanding request per client (each pipeline stream holds its
        own client, so FIFO on the private reply pipe is enough)."""
        import queue as stdlib_queue
        buf = serde.encode_tree(
            data, meta={"client": self._id, "t0": time.monotonic()})
        while True:
            if self._stop is not None and self._stop.is_set():
                return None
            try:
                self._wire.put(buf, timeout=0.1)
                return True
            except stdlib_queue.Full:
                continue
            except (ValueError, OSError):
                return None

    def wait(self, token: Optional[bool]) -> Optional[InferenceReply]:
        if token is None:
            return None
        while not self._conn.poll(0.1):
            if self._stop is not None and self._stop.is_set():
                return None
        try:
            rbuf = self._conn.recv_bytes()
        except (EOFError, OSError):
            return None
        if rbuf == _STOP_FRAME:
            return None
        return _decode_reply(rbuf)[0]

    def infer(self, data: PyTree) -> Optional[InferenceReply]:
        return self.wait(self.submit_async(data))

    def close(self) -> None:
        self.resume()
        try:
            self._conn.close()
        except OSError:
            pass
