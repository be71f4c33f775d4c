"""Actor *process* pools (``repro.distributed.procpool``): spawned
workers behind the same interface as ``ActorPool`` (paper §3's actors in
interpreters of their own: acting no longer competes with the learner
for the GIL).

``ProcessActorPool`` wires its children over multiprocessing primitives
(shm transport + param/control pipes). ``SocketActorPool`` wires them
over TCP (``SocketTransport``): children, or separate machines, dial the
learner's listen address, receive the whole run config in the handshake
and run the same loop bodies; with ``spawn_local=False`` the pool spawns
nothing and waits for remote actors to connect.

Each worker builds its own env batch and generator from picklable
ingredients (env *name*, config dataclasses, seed) and acts on the CPU;
the learner (and, in inference mode, the service) stays on the card.
Two channels connect a process child to the parent:

  params     a duplex pipe to the parent's *param server* thread. The
             child asks "anything newer than version v?"; the server
             answers from ``ParameterStore.pull_serialized`` (encoded
             once per version, shared by all children).
  data       the ``ShmTransport`` wire. The child ships serde-encoded
             trajectory buffers; the parent's drain thread decodes them
             and applies the backpressure policy.

Accounting happens parent-side through the transport's attribution hooks
(accepted / rejected / evicted per actor id), so ``stats()`` has the
thread pool's meaning, except that ``frames`` counts trajectories that
*arrived*.

Shutdown: set the shared stop flag; children leave their loops (wire
puts and param pulls poll it); join with a deadline; ``terminate()``
stragglers, so no child outlives the run. A child that fails reports its
traceback and fails the run: there is no fallback to thread actors, and
supervised respawns are not ported yet (ROADMAP.md, Queue 1 item 13:
supervision).
"""
from __future__ import annotations

import multiprocessing as mp
import threading
import time
from multiprocessing import connection as mp_connection
from typing import List

from repro_torch.distributed.actor_pool import PoolAccounting
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.runner import (inference_actor_main,
                                            process_actor_main)
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.distributed.supervise import KillSafeEvent
from repro_torch.distributed.transport import ShmTransport


class _SpawnedPool(PoolAccounting):
    """What both pools share: the stop flag, the children, joining them
    with ``terminate()`` for stragglers, and arrival accounting."""

    def _init_pool(self, env_name, num_envs: int, num_actors: int,
                   store: ParameterStore, transport, seed: int, icfg,
                   slot_base: int) -> None:
        if num_actors < 1:
            raise ValueError("num_actors must be >= 1")
        if not isinstance(env_name, str):
            raise ValueError("actor children rebuild the env by name; "
                             "pass an env name, not an Env object")
        self.env_name = env_name
        self.num_envs = num_envs
        self.store = store
        self.queue = transport
        self.seed = seed
        self._ctx = mp.get_context("spawn")
        # kill-safe: a SIGKILLed child holding mp.Event's lock would
        # deadlock stop()
        self._stop = KillSafeEvent(self._ctx)
        self._procs: List[mp.process.BaseProcess] = []
        self.errors: List[str] = []             # child tracebacks
        self._init_accounting(num_actors, num_envs * icfg.unroll_length,
                              slot_base)
        transport.on_item = self._note_arrival
        transport.on_reject = self._note_loss
        transport.on_drop = self._note_loss

    # accounting runs on the transport's drain / connection threads
    def _note_arrival(self, item: TrajectoryItem) -> None:
        with self._acct_lock:
            self.trajectories[item.actor_id - self.slot_base] += 1
        self._note_frames(item.actor_id - self.slot_base)

    def _join_children(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(max(0.1, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():                # no orphans, ever
                p.terminate()
                p.join(timeout=5.0)

    def raise_errors(self) -> None:
        if self.errors:
            raise RuntimeError(f"actor {self.backend} child died:\n"
                               + self.errors[0])
        if self._stop.is_set():
            return
        # a child that crashed before it could report (import error, OOM
        # kill) must not leave the learner polling forever
        for p in self._procs:
            if p.exitcode is not None and p.exitcode != 0:
                raise RuntimeError(
                    f"actor process {p.name} exited with code "
                    f"{p.exitcode} before reporting an error")


class ProcessActorPool(_SpawnedPool):
    backend = "process"

    def __init__(self, env_name: str, arch_cfg, icfg, num_envs: int,
                 num_actors: int, store: ParameterStore,
                 transport: ShmTransport, seed: int = 0, service=None,
                 infer_streams: int = 1, slot_base: int = 0):
        """``service`` (an ``InferenceService``) switches the children to
        inference mode: they hold no params and run no policy network;
        observation requests go up the service's process frontend wire,
        replies come back over per-stream pipes (``infer_streams``
        pipelined env sub-batches per child), and the param pipe carries
        only error reports. Children take global slot ids
        ``slot_base + i``, which seed their generators and pin their
        cores."""
        if not isinstance(transport, ShmTransport):
            raise ValueError("ProcessActorPool requires a serializing "
                             "transport (--transport shm)")
        self._init_pool(env_name, num_envs, num_actors, store, transport,
                        seed, icfg, slot_base)
        self._conns = []                        # parent ends of pipes
        self._arch_cfg = arch_cfg
        self._icfg = icfg
        self.service = service
        self.infer_streams = infer_streams
        self._frontend = (service.process_frontend(
            self._ctx, num_actors * infer_streams)
            if service is not None else None)
        self._server = threading.Thread(target=self._serve_params,
                                        name="param-server", daemon=True)

    # ------------------------------------------------------------------
    # param server: version-gated pub/sub over pipes

    def _serve_params(self) -> None:
        dead: set = set()
        while True:
            conns = [c for c in self._conns if c not in dead]
            if not conns:
                break                   # every child is gone
            for conn in mp_connection.wait(conns, timeout=0.2):
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    dead.add(conn)
                    continue
                if msg[0] == "pull":
                    if self._stop.is_set():
                        reply = ("stop",)
                    else:
                        fresh = self.store.pull_serialized(msg[2])
                        reply = (("params", fresh[1], fresh[0])
                                 if fresh is not None else ("keep",))
                    try:
                        conn.send(reply)
                    except (OSError, BrokenPipeError):
                        dead.add(conn)
                elif msg[0] == "error":
                    self.errors.append(msg[2])
                    self.queue.close()      # wake the learner
            if self._stop.is_set() and not any(
                    p.is_alive() for p in self._procs):
                break

    def _spawn_child(self, i: int):
        parent_conn, child_conn = self._ctx.Pipe()
        self._conns.append(parent_conn)
        clients = None
        if self._frontend is not None:
            # frontend client ids stay pool-local (the service is the
            # learner's); the child's actor id is global
            clients = [self._frontend.register(i * self.infer_streams + s)
                       for s in range(self.infer_streams)]
            target, args = inference_actor_main, (
                self.slot_base + i, self.env_name, self._arch_cfg,
                self._icfg, self.num_envs, self.seed,
                self.queue.producer(), clients, child_conn, self._stop,
                self.queue.wire_codec)
        else:
            target, args = process_actor_main, (
                self.slot_base + i, self.env_name, self._arch_cfg,
                self._icfg, self.num_envs, self.seed,
                self.queue.producer(), child_conn, self._stop,
                self.queue.wire_codec)
        p = self._ctx.Process(target=target, args=args,
                              name=f"actor-proc-{i}", daemon=True)
        self._procs.append(p)
        p.start()
        child_conn.close()              # the parent keeps only its end
        for c in clients or ():
            c.close()                   # ditto for the reply recv-ends

    def start(self) -> None:
        for i in range(self.num_actors):
            self._spawn_child(i)
        if self._frontend is not None:
            self._frontend.start()
        self._server.start()

    def stop(self) -> None:
        self._stop.set()
        # keep the wires flowing (discarding) while children wind down,
        # so their queue feeders can always flush and no child hangs at
        # exit mid-write into a full pipe
        self.queue.begin_shutdown()
        if self._frontend is not None:
            self._frontend.begin_shutdown()

    def join(self, timeout: float = 30.0) -> None:
        self._join_children(timeout)
        if self._frontend is not None:
            self._frontend.close()          # children are gone: safe
        if self._server.is_alive():
            self._server.join(timeout=5.0)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


class SocketActorPool(_SpawnedPool):
    """Remote actors over TCP behind the pool interface.

    The pool owns no channels of its own: it *configures* the
    ``SocketTransport`` it is given, with the CONFIG-handshake payload
    (env name, arch/impala config, seed, mode), so a connecting machine
    needs nothing but the address; the param source
    (``ParameterStore.pull_serialized``, encoded once per version for all
    subscribers); the inference frontend in inference mode; and the
    per-actor attribution hooks.

    ``spawn_local=True`` (the default, the single-box path) spawns
    ``num_actors`` loopback children running
    ``netserve.remote_actor_child``; ``spawn_local=False`` is the
    deployment shape: the learner listens, and ``num_actors`` remote
    machines run ``launch.train --connect host:port``."""

    backend = "remote"

    def __init__(self, env_name: str, arch_cfg, icfg, num_envs: int,
                 num_actors: int, store: ParameterStore, transport,
                 seed: int = 0, service=None, infer_streams: int = 1,
                 spawn_local: bool = True, slot_base: int = 0):
        from repro_torch.distributed import netserve
        from repro_torch.distributed.socket_transport import SocketTransport

        if not isinstance(transport, SocketTransport):
            raise ValueError("SocketActorPool requires a SocketTransport "
                             "(--transport socket)")
        self._init_pool(env_name, num_envs, num_actors, store, transport,
                        seed, icfg, slot_base)
        self.spawn_local = spawn_local
        self.service = service
        self.infer_streams = infer_streams
        mode = "inference" if service is not None else "unroll"
        cfg = netserve.build_actor_config(
            env_name=env_name, arch_cfg=arch_cfg, icfg=icfg,
            num_envs=num_envs, seed=seed, mode=mode,
            infer_streams=infer_streams)
        transport.max_actors = num_actors
        transport.config_extra = lambda actor_id: cfg
        transport.param_source = store.pull_serialized
        transport.on_error = self._note_error
        self._frontend = (netserve.SocketInferenceFrontend(
            service, transport, streams=infer_streams)
            if service is not None else None)

    def _note_error(self, text: str) -> None:
        self.errors.append(text)
        self.queue.close()                  # wake the learner

    def start(self) -> None:
        if not self.spawn_local:
            return                      # remote machines dial in
        from repro_torch.distributed.netserve import remote_actor_child
        for i in range(self.num_actors):
            p = self._ctx.Process(
                target=remote_actor_child,
                args=(tuple(self.queue.address), self._stop),
                name=f"actor-remote-{i}", daemon=True)
            self._procs.append(p)
            p.start()

    def stop(self) -> None:
        self._stop.set()
        if self._frontend is not None:
            self._frontend.begin_shutdown()
        # flips the transport to discard (data connections keep draining
        # so a child mid-send can finish its frame) and sends the stop
        # control frame to every connected actor
        self.queue.begin_shutdown()

    def join(self, timeout: float = 30.0) -> None:
        self._join_children(timeout)
