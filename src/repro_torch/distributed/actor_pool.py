"""Actor thread pool (``repro.distributed.actor_pool``): N workers, each
owning its own env batch, RNG stream and unroll (paper §3's distributed
actors, in-process).

Each worker's loop is (pull params) -> (unroll) -> (transport put); the
body lives in ``runner.run_actor_loop``. PyTorch releases the GIL inside
its ops and while a thread waits for the device, so workers overlap with
each other and with the learner as far as the host's launches allow.
On the card each worker issues its work on a CUDA stream of its own.

In inference mode (a ``service``) the pool runs one driver thread that
multiplexes every logical actor against the shared ``InferenceService``
(``runner.run_inference_driver_loop``); the actors hold no params.

The pool is written against the ``Transport`` interface, and
``stats()["rejected"]`` charges every lost trajectory (drop_newest
rejections *and* drop_oldest evictions) back to the actor that made it.

Supervised (``attach_supervisor``), a worker thread that dies is parked
and respawned on the learner's next ``raise_errors`` call, on the same
global slot with the restart epoch folded into its seed. The new thread
runs ``run_actor_loop`` from the start: a new CUDA stream, a new
``torch.Generator``, a new env batch. Nothing of the dead thread is read
again: a trajectory reaches the transport only after its unroll finished
(``runner._finish``), so one it left half-written is never enqueued.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.core import actor as actor_lib
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.runner import (run_actor_loop,
                                            run_inference_driver_loop)
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.distributed.supervise import Supervisor, fold_restart_seed
from repro_torch.distributed.transport import Transport


class PoolAccounting:
    """The per-actor ledger: frames / accepted trajectories / losses, the
    steady-state fps clock, and the stats dict the runtime's telemetry
    embeds. Loss attribution can arrive from several threads at once (a
    producer counting its own rejection, the queue's eviction callback),
    so the ``rejected`` ledger is written under a lock.

    ``slot_base`` is the pool's first *global* actor slot id: items carry
    global ids, the ledgers here are indexed locally."""

    backend = "?"

    def _init_accounting(self, num_actors: int, frames_per_traj: int,
                         slot_base: int = 0) -> None:
        self.num_actors = num_actors
        self.slot_base = slot_base
        self.frames = [0] * num_actors          # env frames produced
        self.trajectories = [0] * num_actors    # accepted into the queue
        self.rejected = [0] * num_actors        # lost (rejected/evicted)
        self._acct_lock = threading.Lock()
        self._steady_t0: Optional[float] = None
        self._steady_frames0 = 0
        self._frames_per_traj = frames_per_traj

    def _note_loss(self, item: TrajectoryItem) -> None:
        with self._acct_lock:
            self.rejected[item.actor_id - self.slot_base] += 1

    def _note_frames(self, idx: int) -> None:
        self.frames[idx] += self._frames_per_traj
        if self._steady_t0 is None:
            # fps clock starts at the first finished trajectory, mirroring
            # the learner's steady-state window; benign race
            self._steady_t0 = time.monotonic()
            self._steady_frames0 = sum(self.frames)

    def stats(self) -> Dict[str, float]:
        total_frames = sum(self.frames)
        fps = 0.0
        if self._steady_t0 is not None:
            dt = time.monotonic() - self._steady_t0
            if dt > 0:
                fps = (total_frames - self._steady_frames0) / dt
        return {
            "num_actors": self.num_actors,
            "slot_base": self.slot_base,
            "backend": self.backend,
            "frames": total_frames,
            "trajectories": sum(self.trajectories),
            "rejected": sum(self.rejected),
            "rejected_per_actor": list(self.rejected),
            "actor_fps": fps,
            "frames_per_actor": list(self.frames),
        }


class ActorPool(PoolAccounting):
    backend = "thread"

    def __init__(self, env, arch_cfg, icfg, num_envs: int, num_actors: int,
                 store: ParameterStore, queue: Transport, seed: int = 0,
                 service=None, slot_base: int = 0, device="cpu"):
        """Actors act on ``device``, the learner's. ``service`` (an
        ``InferenceService``) switches the pool to inference mode: one
        driver thread steps every logical actor's envs on the host and
        the service runs the policy (``_run_driver``)."""
        if num_actors < 1:
            raise ValueError("num_actors must be >= 1")
        self.env = env
        self.num_envs = num_envs
        self.store = store
        self.queue = queue
        self.seed = seed
        self.service = service
        self.device = device
        self._arch_cfg = arch_cfg
        self._icfg = icfg
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # per-actor closure => per-actor env batch
        self._builders = ([] if service is not None else
                          [actor_lib.build_actor(env, arch_cfg, icfg,
                                                 num_envs, device)
                           for _ in range(num_actors)])
        self.errors: List[BaseException] = []
        # supervised respawn (attach_supervisor): a dead worker thread
        # waits here for a restart grant instead of failing the run
        self._supervisor: Optional[Supervisor] = None
        self._dead: List[tuple] = []            # (idx, exc)
        self._respawns: Dict[str, tuple] = {}   # key -> (idx, decision)
        self._init_accounting(num_actors, num_envs * icfg.unroll_length,
                              slot_base)
        if hasattr(queue, "on_drop"):
            queue.on_drop = self._note_loss

    # ------------------------------------------------------------------

    def _emit(self, idx: int, item: TrajectoryItem) -> bool:
        """Transport put with the policy-aware retry loop. True = keep
        producing; False = shut down."""
        attempt = 0
        while not self._stop.is_set():
            if self.queue.put(item, timeout=0.1, count_stall=attempt == 0):
                self.trajectories[idx] += 1
                return True
            if self.queue.closed:
                return False                    # shutting down
            if self.queue.policy == "drop_newest":
                with self._acct_lock:
                    self.rejected[idx] += 1
                return True                     # genuine drop, move on
            # block policy timed out: re-check the stop flag and retry
            attempt += 1
        return False

    def _run(self, idx: int, epoch: int = 0) -> None:
        try:
            run_actor_loop(
                actor_id=self.slot_base + idx,
                builder=self._builders[idx],
                seed=fold_restart_seed(self.seed, epoch),
                pull_params=self.store.pull_ready,
                emit=lambda item: self._emit(idx, item),
                should_stop=self._stop.is_set,
                on_unroll=lambda: self._note_frames(idx),
                device=self.device)
        except BaseException as e:  # surface in the learner thread
            self._note_death(idx, e)

    def _run_driver(self, epoch: int = 0) -> None:
        """Inference mode: ONE thread multiplexes every logical actor,
        each with its own env batch, generator and trajectory stream."""
        try:
            run_inference_driver_loop(
                actor_ids=list(range(self.slot_base,
                                     self.slot_base + self.num_actors)),
                env=self.env, arch_cfg=self._arch_cfg, icfg=self._icfg,
                num_envs=self.num_envs,
                seed=fold_restart_seed(self.seed, epoch),
                service=self.service,
                emit=lambda aid, item: self._emit(aid - self.slot_base,
                                                  item),
                should_stop=self._stop.is_set,
                on_unroll=lambda aid: self._note_frames(
                    aid - self.slot_base))
        except BaseException as e:  # surface in the learner thread
            self._note_death(-1, e)

    def _note_death(self, idx: int, exc: BaseException) -> None:
        """Unsupervised, a worker death fails the run (close the queue so
        the learner wakes and ``raise_errors`` fires). Supervised, it is
        parked for ``raise_errors`` to respawn: the queue stays open, the
        remaining workers keep producing."""
        if self._supervisor is not None and not self._stop.is_set():
            with self._acct_lock:
                self._dead.append((idx, exc))
        else:
            self.errors.append(exc)
            self.queue.close()

    # ------------------------------------------------------------------

    def attach_supervisor(self, supervisor: Supervisor) -> None:
        """Opt into supervised respawn: a worker thread that dies is
        respawned on the next ``raise_errors`` call instead of failing
        the run, until the restart policy is exhausted; then
        ``raise_errors`` raises as the unsupervised pool does."""
        self._supervisor = supervisor

    def _spawn(self, idx: int, epoch: int = 0) -> None:
        if idx < 0:
            t = threading.Thread(target=self._run_driver, args=(epoch,),
                                 name="inference-driver", daemon=True)
        else:
            t = threading.Thread(target=self._run, args=(idx, epoch),
                                 name=f"actor-{idx}", daemon=True)
        self._threads.append(t)
        t.start()

    def start(self) -> None:
        if self.service is not None:
            self._spawn(-1)
            return
        for i in range(self.num_actors):
            self._spawn(i)

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 30.0) -> None:
        """Wait for every worker after ``stop``. One still running after
        ``timeout`` is an error, not something to leave behind: it would
        go on issuing work on the card after the run returned."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"actor threads {alive} still running "
                               f"{timeout} s after stop")

    def raise_errors(self) -> None:
        if self._supervisor is not None:
            self._heal()
        if self.errors:
            raise RuntimeError("actor thread died") from self.errors[0]

    def _heal(self) -> None:
        """Ask the supervisor for restart grants for parked deaths and
        launch every respawn whose backoff has elapsed. Non-blocking:
        called from the learner loop every iteration, so backoff waits
        ride the loop instead of stalling training."""
        sup = self._supervisor
        with self._acct_lock:
            dead, self._dead = self._dead, []
        for idx, exc in dead:
            key = (f"actor-{self.slot_base + idx}" if idx >= 0
                   else f"driver-{self.slot_base}")
            decision = sup.record_death(key)
            if decision is None:    # budget exhausted: fail loudly
                self.errors.append(exc)
                self.queue.close()
                continue
            self._respawns[key] = (idx, decision)
        now = time.monotonic()
        due = [k for k, (_i, d) in self._respawns.items()
               if d.not_before <= now]
        for key in due:
            idx, decision = self._respawns.pop(key)
            self._spawn(idx, decision.epoch)
            sup.note_restarted(key)
