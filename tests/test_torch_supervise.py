"""Supervision in the port, bottom to top, against the JAX package's
copy: the restart ledger (``RestartPolicy.delay_s``, the ``Supervisor``'s
decisions and snapshots, ``health()`` of a snapshot, each equal to the
reference's for the same sequence), heartbeat liveness, lease reaping and
elastic growth on the socket transport, the ``ResilientExchange``'s hub
failover (promote, redial, degrade to solo), and kill-and-respawn through
the entry points on the CPU: a thread actor, a process child and a remote
child of ``run_async_training(supervise=True)``, a spoke learner and the
hub learner of ``run_group_training(supervise=True)``.

The supervision modules of both packages are plain stdlib; the runs use
bandit at the smoke width for a few updates, on one torch thread."""
import multiprocessing as mp
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.distributed import supervise as j_sup
from repro.obs import http as j_http
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ImpalaConfig
from repro_torch.distributed import actor_pool as t_actor_pool
from repro_torch.distributed import supervise as t_sup
from repro_torch.distributed.supervise import (KillSafeEvent, RestartDecision,
                                               RestartPolicy, Supervisor,
                                               fold_restart_seed)
from repro_torch.obs import http as t_http

torch.set_num_threads(1)


def _wait_for(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {msg}"
        time.sleep(0.01)


def _assert_no_orphans():
    deadline = time.monotonic() + 30
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert mp.active_children() == []


def _icfg(**kw):
    base = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
                entropy_cost=0.003, rmsprop_eps=0.01)
    base.update(kw)
    return ImpalaConfig(**base)


# ---------------------------------------------------------------------------
# the restart ledger: parity with the JAX package's copy


def test_fold_restart_seed_identity_and_parity():
    assert fold_restart_seed(1234, 0) == 1234
    seeds = [fold_restart_seed(1234, e) for e in range(6)]
    assert len(set(seeds)) == 6
    for seed in (0, 7, 2 ** 31 - 2):
        for e in range(40):
            got = fold_restart_seed(seed, e)
            assert got == j_sup.fold_restart_seed(seed, e)
            assert 0 <= got < 2 ** 31 - 1 or e == 0


@pytest.mark.parametrize("kw", [
    {}, {"backoff_base_s": 0.1, "backoff_cap_s": 0.8, "jitter": 0.5},
    {"backoff_base_s": 0.0, "jitter": 0.0}, {"jitter": 2.0}])
def test_restart_policy_delay_equals_the_reference(kw):
    mine, ref = RestartPolicy(**kw), j_sup.RestartPolicy(**kw)
    for key in ("actor-0", "actor-1", "proc-3", "remote-7", "learner-1",
                "driver-0"):
        for epoch in range(10):
            assert mine.delay_s(key, epoch) == ref.delay_s(key, epoch)
    if kw.get("backoff_cap_s") == 0.8:
        d = [mine.delay_s("actor-0", e) for e in range(1, 8)]
        for i, lo in enumerate([0.1, 0.2, 0.4, 0.8]):
            assert lo <= d[i] <= lo * 1.5
        assert max(d) <= 0.8 * 1.5
        assert mine.delay_s("actor-1", 1) != d[0]


def test_supervisor_budget_window_and_exhaustion():
    sup = Supervisor(RestartPolicy(max_restarts=2, window_s=60.0,
                                   backoff_base_s=0.0, jitter=0.0))
    for expected_epoch in (1, 2):
        d = sup.record_death("actor-0")
        assert isinstance(d, RestartDecision) and d.epoch == expected_epoch
        sup.note_restarted("actor-0")
    assert sup.record_death("actor-0") is None
    assert sup.exhausted == ["actor-0"]
    snap = sup.snapshot()
    assert snap["restarts"] == 2
    assert snap["restarts_exhausted"] == ["actor-0"]
    assert sup.record_death("actor-1") is not None


def test_supervisor_pending_dedup_failover_and_lease_ledger():
    sup = Supervisor(RestartPolicy(backoff_base_s=0.0, jitter=0.0))
    d1 = sup.record_death("proc-3")
    assert sup.record_death("proc-3") is d1
    assert sup.snapshot()["restart_in_flight"] == 1
    sup.note_restarted("proc-3")
    snap = sup.snapshot()
    assert snap["restart_in_flight"] == 0 and snap["epochs"] == {"proc-3": 1}
    assert sup.child_epoch("proc-3") == 1
    assert sup.restart_epochs() == {"proc-3": 1}
    assert sup.child_epoch("never-died") == 0
    sup.record_failover()
    assert sup.snapshot()["failover_in_flight"] == 1
    sup.note_failover_done()
    sup.note_failover_done()                # no double counting
    assert sup.snapshot()["failovers"] == 1
    sup.record_lease_reap("slot-2")
    sup.record_lease_reap("slot-2")
    assert sup.snapshot()["lease_reaps"] == 2


def _drive(mod, clock):
    """One fixed sequence of deaths, restarts, failovers and reaps through
    ``mod.Supervisor`` on a fake clock; returns every decision and every
    snapshot (decisions as plain tuples, so both packages compare)."""
    sup = mod.Supervisor(mod.RestartPolicy(max_restarts=2, window_s=10.0))
    out = []

    def death(key):
        d = sup.record_death(key)
        out.append(None if d is None else
                   (d.key, d.epoch, d.delay_s, d.not_before))

    for t, op, key in [
            (0.0, "death", "actor-0"), (0.1, "death", "actor-0"),
            (0.2, "restart", "actor-0"), (1.0, "death", "proc-1"),
            (1.0, "failover", None), (1.5, "reap", "slot-3"),
            (2.0, "restart", "proc-1"), (2.5, "death", "actor-0"),
            (2.6, "restart", "actor-0"), (3.0, "done", None),
            (3.5, "death", "actor-0"), (14.0, "death", "proc-1"),
            (14.1, "restart", "proc-1"), (15.0, "death", "learner-1"),
            (15.0, "failover", None), (16.0, "reap", "slot-0")]:
        clock[0] = t
        if op == "death":
            death(key)
        elif op == "restart":
            sup.note_restarted(key)
        elif op == "failover":
            sup.record_failover()
        elif op == "done":
            sup.note_failover_done()
        else:
            sup.record_lease_reap(key)
        out.append(sup.snapshot())
    out.append(sup.restart_epochs())
    out.append(sup.exhausted)
    return out


def test_supervisor_sequence_and_health_equal_the_reference(monkeypatch):
    clock = [0.0]
    fake = types.SimpleNamespace(monotonic=lambda: 1e3 + clock[0])
    for mod in (t_sup, j_sup):
        monkeypatch.setattr(mod, "time", fake)
    mine, ref = _drive(t_sup, clock), _drive(j_sup, clock)
    assert mine == ref
    snaps = [s for s in mine if isinstance(s, dict) and "restarts" in s]
    assert snaps[-1]["restarts_exhausted"] == ["actor-0"]
    assert snaps[-1]["failover_in_flight"] == 1
    for snap in snaps:
        assert t_http.health({"supervisor": snap}) == \
            j_http.health({"supervisor": snap})
    assert t_http.health({"supervisor": snaps[-1]})[0] == 503


def _spin_on_stop_flag(ev, ack):
    ack.set()
    while not ev.is_set():      # hammer is_set: the poisoning window
        pass
    os._exit(0)


@pytest.mark.timeout_s(120)
def test_kill_safe_event_survives_sigkilled_sharer():
    ctx = mp.get_context("spawn")
    ev, ack = KillSafeEvent(ctx), KillSafeEvent(ctx)
    p = ctx.Process(target=_spin_on_stop_flag, args=(ev, ack))
    p.start()
    try:
        assert ack.wait(60), "child never came up"
        os.kill(p.pid, signal.SIGKILL)
        p.join(10)
        t0 = time.monotonic()
        ev.set()                            # must not block
        assert time.monotonic() - t0 < 1.0
        assert ev.is_set() and ev.wait(0.1)
        ev.clear()
        assert not ev.wait(0.15)
    finally:
        if p.is_alive():
            p.terminate()
            p.join(5)


def _send_and_idle(producer, bufs, ack):
    ack.set()
    for buf in bufs:
        while not producer.send(buf, timeout=0.1):
            pass
    while True:
        time.sleep(1)


@pytest.mark.timeout_s(120)
def test_shm_wire_survives_a_producer_killed_mid_write():
    """A producer SIGKILLed in the middle of a write tears only its own
    pipe: the drain drops it at end-of-file and the other producer's
    buffers still arrive, in order (one shared queue would leave a torn
    message in the shared pipe and its write lock held for ever)."""
    from repro_torch.distributed import serde
    from repro_torch.distributed.transport import ShmTransport

    def item(i):
        return serde.TrajectoryItem(
            {"rewards": np.full((2, 3), i, np.float32)}, param_version=i,
            actor_id=1, produced_at=float(i))

    ctx = mp.get_context("spawn")
    t = ShmTransport(capacity=1, policy="block")
    procs = []
    try:
        good = t.producer()
        ack_b = KillSafeEvent(ctx)
        b = ctx.Process(target=_send_and_idle, daemon=True, args=(
            good, [serde.encode_item(item(i)) for i in range(3)], ack_b))
        b.start()
        good.close()
        procs.append(b)
        # item 0 fills the local queue, the drain holds item 1: stalled
        _wait_for(lambda: t.wire_received >= 2, msg="drain stalled")
        torn = t.producer()
        ack_a = KillSafeEvent(ctx)
        a = ctx.Process(target=_send_and_idle, daemon=True,
                        args=(torn, [b"x" * (8 << 20)], ack_a))
        a.start()
        torn.close()
        procs.append(a)
        assert ack_a.wait(60)
        time.sleep(1.0)                 # a is blocked in its 8 MB write
        os.kill(a.pid, signal.SIGKILL)
        a.join(10)
        got = [t.get(timeout=30) for _ in range(3)]
        assert [g.param_version for g in got] == [0, 1, 2]
        assert t.snapshot()["drain_errors"] == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        t.close()


# ---------------------------------------------------------------------------
# heartbeat liveness, lease reaping and elastic growth (socket transport)


@pytest.mark.timeout_s(120)
def test_silent_actor_lease_is_reaped_and_counted():
    from repro_torch.distributed.socket_transport import (SocketActorClient,
                                                          SocketTransport)
    sup = Supervisor()
    t = SocketTransport(capacity=4, policy="block", max_actors=1,
                        heartbeat_timeout_s=0.6)
    t.supervisor = sup
    t.config_extra = lambda aid: {}
    stop = threading.Event()
    client = None
    try:
        # connected, then silent: what a wedged or dead actor looks like
        client = SocketActorClient(t.address, stop_event=stop,
                                   backoff=(0.01, 0.1), heartbeat_s=3600.0)
        cfg = client.connect()
        assert cfg["heartbeat_s"] == pytest.approx(0.2)
        _wait_for(lambda: t.snapshot()["lease_reaps"] >= 1,
                  msg="silent lease reaped")
        assert sup.snapshot()["lease_reaps"] >= 1
        assert t.snapshot()["per_actor"][0]["lease_reaps"] >= 1
        stop.set()
        client.close()
        client = None
        _wait_for(lambda: not t.snapshot()["per_actor"][0]["connected"],
                  msg="zombie disconnected")
        # a relaunched actor reclaims the dead slot: max_actors=1 leaves
        # no other
        relaunch = SocketActorClient(t.address, backoff=(0.01, 0.1),
                                     heartbeat_s=3600.0)
        cfg2 = relaunch.connect()
        assert cfg2["actor_id"] == 0 and not relaunch.refused
        relaunch.close()
    finally:
        if client is not None:
            client.close()
        t.close()


@pytest.mark.timeout_s(120)
def test_heartbeats_keep_a_quiet_actor_alive():
    from repro_torch.distributed.socket_transport import (SocketActorClient,
                                                          SocketTransport)
    t = SocketTransport(capacity=4, policy="block", max_actors=2,
                        heartbeat_timeout_s=0.6)
    t.config_extra = lambda aid: {}
    client = None
    try:
        # the CONFIG's cadence (timeout / 3)
        client = SocketActorClient(t.address, backoff=(0.01, 0.1))
        assert client.connect() is not None
        _wait_for(lambda: t.snapshot()["heartbeats"] >= 3,
                  msg="heartbeats arriving")
        assert t.snapshot()["lease_reaps"] == 0
    finally:
        if client is not None:
            client.close()
        t.close()
    # the reaper and the heartbeat thread end with their owners
    assert not any(th.name in ("socket-reaper", "socket-heartbeat")
                   for th in threading.enumerate())


@pytest.mark.timeout_s(120)
def test_elastic_membership_grows_slots_past_the_ceiling():
    from repro_torch.distributed.socket_transport import (SocketActorClient,
                                                          SocketTransport)
    grown = []
    t = SocketTransport(capacity=4, policy="block", max_actors=1,
                        elastic=True)
    t.on_slot_grown = grown.append
    t.config_extra = lambda aid: {}
    clients = []
    try:
        a = SocketActorClient(t.address, backoff=(0.01, 0.1))
        assert a.connect() is not None and a.actor_id == 0
        clients.append(a)
        b = SocketActorClient(t.address, backoff=(0.01, 0.1))
        cfg = b.connect()
        clients.append(b)
        assert cfg["actor_id"] == 1 and not b.refused
        assert grown == [1]
        snap = t.snapshot()
        assert snap["elastic"] is True and len(snap["per_actor"]) == 2
    finally:
        for c in clients:
            c.close()
        t.close()


# ---------------------------------------------------------------------------
# ResilientExchange: the hub-failover state machine (numpy + TCP)


def _leaves(scale):
    return [np.full((3,), scale, np.float32),
            np.full((2, 2), 10.0 * scale, np.float32)]


@pytest.mark.timeout_s(120)
def test_resilient_exchange_promotes_survivor_to_hub():
    from repro_torch.distributed import (GradHub, ResilientExchange,
                                         SpokeExchange)
    hub = GradHub(2, stale_after_s=30.0)
    spoke = SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0)
    promoted = []
    rex = ResilientExchange(spoke, 1, 2, failover_deadline_s=20.0,
                            on_promoted=promoted.append)
    try:
        hub.close()                             # the hub "dies"
        rex.begin_failover(1, dead_id=0)
        mean, version = rex.allreduce(_leaves(2.0), round_idx=0)
        assert version == 1
        np.testing.assert_array_equal(mean[0], _leaves(2.0)[0])
        assert promoted and len(promoted[0]) == 2
        snap = rex.snapshot()
        assert snap["resilient"] is True and snap["failovers"] == 1
        assert snap["hub_id"] == 1 and not snap["degraded_solo"]
    finally:
        rex.close()


@pytest.mark.timeout_s(120)
def test_resilient_exchange_redials_promoted_hub_and_reduces():
    from repro_torch.distributed import (GradHub, ResilientExchange,
                                         SpokeExchange)
    dead_hub = GradHub(3, stale_after_s=30.0)
    s1 = SpokeExchange(dead_hub.address, 1, 3, dial_timeout_s=20.0)
    s2 = SpokeExchange(dead_hub.address, 2, 3, dial_timeout_s=20.0)
    promoted = []
    r1 = ResilientExchange(s1, 1, 3, failover_deadline_s=20.0,
                           on_promoted=promoted.append)
    r2 = ResilientExchange(s2, 2, 3, failover_deadline_s=20.0)
    try:
        dead_hub.close()
        results = {}

        def run(key, rex, scale):
            results[key] = rex.allreduce(_leaves(scale), round_idx=0)

        t1 = threading.Thread(target=run, args=(1, r1, 1.0), daemon=True)
        t2 = threading.Thread(target=run, args=(2, r2, 3.0), daemon=True)
        t1.start(), t2.start()
        r1.begin_failover(1, dead_id=0)
        r2.begin_failover(1, dead_id=0)
        _wait_for(lambda: bool(promoted), msg="promoted hub address")
        r2.set_hub(promoted[0])
        t1.join(timeout=30), t2.join(timeout=30)
        assert not t1.is_alive() and not t2.is_alive()
        for key in (1, 2):
            mean, version = results[key]
            assert version == 1
            np.testing.assert_allclose(mean[0], np.full((3,), 2.0))
        assert r1.snapshot()["failovers"] == r2.snapshot()["failovers"] == 1
    finally:
        r1.close()
        r2.close()


@pytest.mark.timeout_s(120)
def test_resilient_exchange_degrades_to_solo_past_deadline():
    from repro_torch.distributed import (GradHub, ResilientExchange,
                                         SpokeExchange)
    hub = GradHub(2, stale_after_s=30.0)
    spoke = SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0)
    rex = ResilientExchange(spoke, 1, 2, failover_deadline_s=0.3)
    try:
        hub.close()
        t0 = time.monotonic()
        mean, version = rex.allreduce(_leaves(5.0), round_idx=7)
        assert time.monotonic() - t0 < 20.0
        assert version == 8
        np.testing.assert_array_equal(mean[0], _leaves(5.0)[0])
        assert rex.allreduce(_leaves(6.0), round_idx=8)[1] == 9
        snap = rex.snapshot()
        assert snap["degraded_solo"] is True and snap["solo_rounds"] == 2
    finally:
        rex.close()


# ---------------------------------------------------------------------------
# kill and respawn through the entry points


@pytest.mark.timeout_s(120)
def test_actor_pool_respawns_dead_thread_until_budget_exhausted():
    from repro_torch.core.driver import init_params, small_arch
    from repro_torch.data.envs import make_bandit
    from repro_torch.distributed import (ActorPool, ParameterStore,
                                         make_transport)

    env = make_bandit()
    arch = small_arch(env)
    store = ParameterStore(init_params(arch, env.num_actions, 0, "cpu"))
    queue = make_transport("inproc", 4, "block")
    pool = ActorPool(env, arch, _icfg(), num_envs=2, num_actors=1,
                     store=store, queue=queue, seed=0, device="cpu")
    sup = Supervisor(RestartPolicy(max_restarts=2, backoff_base_s=0.0,
                                   jitter=0.0))
    pool.attach_supervisor(sup)
    try:
        pool._note_death(0, RuntimeError("chaos: worker shot"))
        assert pool.errors == [] and not queue.closed
        pool.raise_errors()         # heals: the respawn is launched
        assert sup.snapshot()["restarts"] == 1
        assert sup.child_epoch("actor-0") == 1
        _wait_for(lambda: queue.get(timeout=0.2) is not None,
                  timeout=60.0, msg="respawned actor producing")
        pool._note_death(0, RuntimeError("chaos: again"))
        pool.raise_errors()
        assert sup.snapshot()["restarts"] == 2
        pool._note_death(0, RuntimeError("chaos: third"))
        with pytest.raises(RuntimeError, match="actor thread died"):
            pool.raise_errors()
        assert sup.snapshot()["restarts_exhausted"] == ["actor-0"]
    finally:
        pool.stop()
        queue.close()
        pool.join(timeout=30.0)


def _shoot_actor_thread(monkeypatch, state):
    """Make actor 0's thread raise from its next emit once ``state`` is
    armed: the thread dies the way a fault in its unroll would, and the
    trajectory it was about to hand over never reaches the queue."""
    real = t_actor_pool.run_actor_loop

    def loop(**kw):
        emit, epoch0 = kw["emit"], not state["fired"]

        def chaos_emit(item):
            if state["armed"] and epoch0 and kw["actor_id"] == 0 and \
                    not state["fired"]:
                state["fired"] = True
                raise RuntimeError("chaos: actor thread shot")
            return emit(item)

        kw["emit"] = chaos_emit
        return real(**kw)

    monkeypatch.setattr(t_actor_pool, "run_actor_loop", loop)


@pytest.mark.timeout_s(120)
def test_thread_actor_killed_mid_run_is_respawned(monkeypatch):
    from repro_torch.distributed import run_async_training
    state = {"armed": False, "fired": False}
    _shoot_actor_thread(monkeypatch, state)
    steps = 12
    after = []

    def on_update(step, params, m, snap):
        if step == 4:
            state["armed"] = True
        if state["fired"]:
            after.append(step)

    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=steps, num_actors=2,
        queue_capacity=4, max_batch_trajs=2, seed=0, supervise=True,
        on_update=on_update, device="cpu")
    assert state["fired"]
    assert tel["learner_updates"] == steps and after
    assert np.isfinite(float(metrics["loss/total"]))
    sup = tel["supervisor"]
    assert sup["restarts"] == 1 and sup["epochs"] == {"actor-0": 1}
    assert sup["restarts_exhausted"] == []
    assert not any(t.name.startswith("actor-")
                   for t in threading.enumerate())


def _kill_one_child_then_stall(state, step, kill_at, steps):
    """on_update hook: SIGKILL one actor child at ``kill_at``, then pace
    the remaining updates so the learner loop (which heals between
    updates) outlives the backoff."""
    if step == kill_at and not state["killed"]:
        victims = [p for p in mp.active_children() if p.pid]
        assert victims, "no actor children to kill"
        os.kill(victims[0].pid, signal.SIGKILL)
        state["killed"] = victims[0].pid
    elif state["killed"] and step < steps:
        time.sleep(0.05)


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("backend", ["process", "remote"])
def test_actor_child_sigkilled_is_respawned(backend):
    from repro_torch.distributed import run_async_training
    steps = 20
    state = {"killed": None}
    kw = ({"transport": "shm"} if backend == "process" else
          {"transport": "socket", "heartbeat_timeout_s": 2.0})
    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=steps, num_actors=2,
        actor_backend=backend, queue_capacity=4, queue_policy="block",
        max_batch_trajs=2, seed=0, supervise=True, device="cpu",
        on_update=lambda step, params, m, snap:
            _kill_one_child_then_stall(state, step, 5, steps), **kw)
    assert state["killed"] is not None
    assert tel["learner_updates"] == steps
    assert np.isfinite(float(metrics["loss/total"]))
    assert tel["supervisor"]["restarts"] >= 1
    assert tel["supervisor"]["restarts_exhausted"] == []
    if backend == "remote":
        assert tel["queue"]["decode_errors"] == 0
    _assert_no_orphans()


@pytest.mark.timeout_s(120)
def test_supervised_fleet_checkpoint_carries_restart_epochs(monkeypatch,
                                                           tmp_path):
    """A supervised run's fleet-v1 checkpoint holds the restart epochs,
    in the JAX package's format both ways."""
    from repro.checkpoint import checkpoint as j_ckpt
    from repro_torch.distributed import run_async_training
    state = {"armed": True, "fired": False}
    _shoot_actor_thread(monkeypatch, state)
    d = str(tmp_path / "fleet")
    run_async_training(
        "bandit", _icfg(), num_envs=4, steps=6, num_actors=2,
        queue_capacity=4, max_batch_trajs=2, seed=0, supervise=True,
        ckpt_dir=d, ckpt_every=3, device="cpu")
    _, step, extra = j_ckpt.load_with_extra(d)
    assert step == 6 and extra["format"] == "fleet-v1"
    assert extra["restart_epochs"] == {"actor-0": 1}
    # a JAX supervised checkpoint's epochs load into the port
    tree, _, _ = ckpt.load_with_extra(d)
    jd = str(tmp_path / "jax")
    j_ckpt.save(jd, 9, tree, extra={"version": 9, "format": "fleet-v1",
                                    "restart_epochs": {"proc-1": 2}})
    assert ckpt.load_with_extra(jd)[2]["restart_epochs"] == {"proc-1": 2}


def _kill_worker(name):
    for p in mp.active_children():
        if p.name == name and p.pid:
            os.kill(p.pid, signal.SIGKILL)
            return p.pid
    return None


@pytest.mark.timeout_s(120)
def test_spoke_learner_sigkilled_is_respawned_with_identical_replica(
        tmp_path):
    from repro_torch.distributed import run_group_training
    steps = 8
    state = {"killed": None}

    def on_progress(k, snap):
        if k == 1 and snap["learner_updates"] >= 2 and not state["killed"]:
            state["killed"] = _kill_worker("learner-1")

    counts = {}
    d = str(tmp_path / "fleet")
    _, _, tel = run_group_training(
        "bandit", _icfg(), 4, steps, num_learners=2, num_actors=2,
        queue_capacity=4, max_batch_trajs=2, seed=0, supervise=True,
        telemetry_every=1, on_progress=on_progress, ckpt_dir=d,
        ckpt_every=2, kernel_counts=counts,
        restart_policy=RestartPolicy(backoff_base_s=0.0, jitter=0.0),
        device="cpu")
    assert state["killed"], "spoke was never killed"
    sup = tel["supervisor"]
    assert sup["restarts"] == 1 and sup["epochs"] == {"learner-1": 1}
    assert sup["failovers"] == 0
    # the reborn spoke caught up from the hub's replayed means to a
    # bit-identical replica, and the version stream never forked
    assert tel["group"]["replicas_identical"], tel["group"]
    assert tel["group"]["param_versions"] == [steps, steps]
    assert tel["param_version"] == steps
    assert "abandoned_learners" not in tel["group"]
    assert sorted(counts) == [0, 1]         # the reborn worker's counters
    extra = ckpt.read_manifest(d)["extra"]
    assert extra["format"] == "fleet-v1" and extra["version"] == steps
    assert extra["restart_epochs"] == {"learner-1": 1}
    _assert_no_orphans()


@pytest.mark.timeout_s(120)
def test_hub_learner_sigkilled_fails_over_to_survivor():
    from repro_torch.distributed import run_group_training
    steps = 8
    state = {"killed": None}

    def on_progress(k, snap):
        if k == 1 and snap["learner_updates"] >= 2 and not state["killed"]:
            state["killed"] = _kill_worker("learner-0")

    counts = {}
    _, metrics, tel = run_group_training(
        "bandit", _icfg(), 4, steps, num_learners=2, num_actors=2,
        queue_capacity=4, max_batch_trajs=2, seed=0, supervise=True,
        telemetry_every=1, on_progress=on_progress, kernel_counts=counts,
        device="cpu")
    assert state["killed"], "hub was never killed"
    sup = tel["supervisor"]
    assert sup["failovers"] == 1 and sup["failover_in_flight"] == 0
    assert sup["restarts"] == 0             # the hub is not respawned
    assert tel["group"]["abandoned_learners"] == [0]
    assert tel["group"]["publisher"] == 1
    assert tel["param_version"] == steps
    ex = tel["learners"]["learner_1"]["exchange"]
    assert ex["resilient"] is True and ex["failovers"] == 1
    assert ex["hub_id"] == 1
    assert np.isfinite(float(metrics["loss/total"]))
    assert sorted(counts) == [1]            # the promoted worker's counters
    _assert_no_orphans()


@pytest.mark.timeout_s(120)
def test_cli_supervised_saves_are_fleet_v1_and_resume(tmp_path, capsys):
    """With ``--supervise``, ``--ckpt-dir`` receives the runtime's fleet-v1
    checkpoints (one learner and a group), so the CLI's own saves resume:
    a single learner restores params, optimizer state and version, a
    group resumes with ``--resume``."""
    from repro_torch.launch import train as train_lib

    base = ["--device", "cpu", "--smoke", "--env", "bandit", "--runtime",
            "async", "--supervise", "--ckpt-every", "2", "--log-every", "2"]
    one = str(tmp_path / "one")
    train_lib.train(base + ["--ckpt-dir", one, "--steps", "4"])
    extra = ckpt.read_manifest(one)["extra"]
    assert extra["format"] == "fleet-v1" and extra["version"] == 4
    assert extra["restart_epochs"] == {}
    capsys.readouterr()
    run = train_lib.train(base + ["--ckpt-dir", one, "--steps", "6"])
    assert "restored fleet checkpoint at version 4" in capsys.readouterr().out
    assert run.telemetry["param_version"] == 6
    group = str(tmp_path / "group")
    argv = base + ["--learners", "2", "--ckpt-dir", group]
    train_lib.train(argv + ["--steps", "2"])
    assert ckpt.read_manifest(group)["extra"]["format"] == "fleet-v1"
    capsys.readouterr()
    run = train_lib.train(argv + ["--steps", "4", "--resume"])
    assert "resuming learner group from fleet checkpoint (step 2)" in \
        capsys.readouterr().out
    assert run.telemetry["group"]["param_versions"] == [4, 4]
    assert run.telemetry["group"]["replicas_identical"]
    _assert_no_orphans()
