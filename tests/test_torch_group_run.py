"""Learner groups of the port end to end, on the CPU: a group of one is
the single-learner runtime bit for bit; two learners over threads,
process actors, remote actors, replay and inference mode keep their
replicas identical on one version stream; the socket transport's shard
map spills a refused actor to a learner with a free slot; each learner's
inference service samples from its own stream; a group resumes from a
fleet-v1 checkpoint; and the CLI's group route prints the JAX CLI's lines
and refuses what the JAX CLI refuses, with its messages.

Runs use bandit or catch with the smoke config and a few rounds; the
workers take this process's one torch thread."""
import json
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from repro_torch import params as P
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ImpalaConfig
from repro_torch.core.replay import fold_replay_seed
from repro_torch.distributed import (run_async_training,
                                     run_group_training)
from repro_torch.distributed import runtime
from repro_torch.distributed import serde
from repro_torch.distributed.group import params_digest
from repro_torch.distributed.socket_transport import (SocketActorClient,
                                                      SocketTransport)
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)


def _icfg(**kw):
    base = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
                entropy_cost=0.003, rmsprop_eps=0.01)
    base.update(kw)
    return ImpalaConfig(**base)


def _no_orphans():
    deadline = time.monotonic() + 30
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert mp.active_children() == []


def _check_pair(tel, steps):
    g = tel["group"]
    assert g["num_learners"] == 2 and g["publisher"] == 0
    assert g["param_versions"] == [steps, steps]
    assert g["replicas_identical"], g["param_digests"]
    assert g["stale_dropped"] == 0
    assert tel["learner_updates"] == tel["param_version"] == steps
    per = tel["actors"]["per_learner_trajectories"]
    assert per["learner_0"] > 0 and per["learner_1"] > 0
    for k in range(2):
        sub = tel["learners"][f"learner_{k}"]
        assert sub["learner_id"] == k and sub["slot_base"] == k
        assert sub["actors"]["slot_base"] == k
        assert sub["exchange"]["rounds"] == steps


@pytest.mark.timeout_s(300)
def test_group_of_one_bitmatches_the_single_learner_first_update():
    """A group of ONE learner (a worker process, no exchange, the fused
    step) publishes bit-identical params to ``run_async_training``'s
    first update: same init, same actor stream, same batch. The worker's
    telemetry has the single learner's key set."""
    icfg = _icfg()
    captured = []
    run_async_training(
        "bandit", icfg, num_envs=4, steps=1, num_actors=1,
        queue_capacity=4, max_batch_trajs=1, seed=5, device="cpu",
        on_update=lambda step, params, m, snap: captured.append(
            (P.to_jax(params), snap())))
    ref_params, ref_tel = captured[0]
    counts = {}
    _, _, tel, params = run_group_training(
        "bandit", icfg, 4, 1, num_learners=1, num_actors=1,
        queue_capacity=4, max_batch_trajs=1, seed=5,
        return_final_params=True, kernel_counts=counts, device="cpu")
    want, got = P.flatten(ref_params), P.flatten(params)
    assert set(want) == set(got)
    for k, v in want.items():
        assert v.dtype == got[k].dtype and v.shape == got[k].shape
        assert v.tobytes() == got[k].tobytes(), k
    assert sorted(tel["learners"]["learner_0"]) == sorted(ref_tel)
    assert tel["param_version"] == 1
    # on the CPU the wrappers take their plain versions, uncounted
    assert counts == {0: {"launches": {"vtrace": 0, "loss_vtrace": 0},
                          "shapes": {"vtrace": [], "loss_vtrace": []}}}


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("backend,extra", [
    ("thread", {}),
    ("process", {"transport": "shm"}),
    ("thread", {"replay": True}),
    ("remote", {"actor_mode": "inference"}),
])
def test_two_learner_group_keeps_identical_replicas(backend, extra):
    extra = dict(extra)
    icfg = _icfg(replay_fraction=0.5, replay_capacity=64) \
        if extra.pop("replay", False) else _icfg()
    steps = 4
    _, metrics, tel = run_group_training(
        "bandit", icfg, 4, steps, num_learners=2, num_actors=2,
        actor_backend=backend, queue_capacity=4, max_batch_trajs=2, seed=1,
        device="cpu", **extra)
    assert np.isfinite(float(metrics["loss/total"]))
    _check_pair(tel, steps)
    assert tel["actors"]["backend"] == backend
    if icfg.replay_fraction:
        assert tel["replay"]["sampled"] > 0
    if extra.get("actor_mode") == "inference":
        assert all(tel["learners"][f"learner_{k}"]["inference"]["flushes"]
                   for k in range(2))
    _no_orphans()


@pytest.mark.timeout_s(120)
def test_refusal_with_shard_map_spills_to_peer_learner():
    """Two learner transports sharding 1 + 1 slots: both publish the shard
    map; an actor dialing the full learner is refused with the map and
    lands on the peer's free slot; a third is refused by both."""
    t0 = SocketTransport(capacity=8, policy="block", max_actors=1,
                         slot_base=0)
    t1 = SocketTransport(capacity=8, policy="block", max_actors=1,
                         slot_base=1)
    shard_map = [t0.address, t1.address]
    for t in (t0, t1):
        t.peer_addrs = shard_map
        t.config_extra = lambda aid: {}
    clients = []
    try:
        a = SocketActorClient(t0.address, backoff=(0.01, 0.1))
        cfg = a.connect()
        clients.append(a)
        assert cfg is not None and cfg["actor_id"] == 0
        assert [tuple(x) for x in cfg["shard_map"]] == \
            [tuple(x) for x in shard_map]
        b = SocketActorClient(t0.address, backoff=(0.01, 0.1),
                              dial_timeout=10.0)
        cfg_b = b.connect()
        clients.append(b)
        assert cfg_b is not None and cfg_b["actor_id"] == 1
        assert tuple(b.connected_addr) == tuple(t1.address)
        assert not b.refused
        buf = serde.encode_item(serde.TrajectoryItem(
            {"rewards": np.zeros((2, 3), np.float32)}, 0, 1, 0.0))
        assert b.send_traj(buf)
        got = t1.get(timeout=10.0)
        assert got is not None and got.actor_id == 1
        assert t0.get_nowait() is None
        c = SocketActorClient(t0.address, backoff=(0.01, 0.1),
                              dial_timeout=10.0)
        assert c.connect() is None
        assert c.refused
    finally:
        for cl in clients:
            cl.close()
        t0.close()
        t1.close()


def test_each_learner_samples_from_its_own_stream():
    """The inference service of learner k of a group seeds its generator
    from ``fold_replay_seed(seed, k)``; alone, from the plain seed."""
    seeds = []
    for lid, n in ((0, 1), (0, 2), (1, 2), (2, 3)):
        learner = runtime._setup(
            "catch", _icfg(), 4, num_actors=1, actor_mode="inference",
            seed=7, learner_id=lid, num_learners=n, device="cpu")
        try:
            seeds.append(learner.service._gen.initial_seed())
        finally:
            learner.queue.close()
    alone = np.random.SeedSequence((7, 0x1f5)).generate_state(1)[0]
    assert seeds[0] == alone
    assert seeds[1] == alone            # fold_replay_seed(7, 0) == 7
    want = [np.random.SeedSequence((fold_replay_seed(7, k), 0x1f5))
            .generate_state(1)[0] for k in (1, 2)]
    assert seeds[2:] == want and len(set(seeds[1:])) == 3


@pytest.mark.timeout_s(300)
def test_group_resumes_from_a_fleet_checkpoint(tmp_path):
    """A group with a ``ckpt_dir`` writes fleet-v1; a group resumed from
    it with no round left publishes exactly the saved params in both
    workers; one resumed for two more rounds continues the versions, and
    its workers' time-based telemetry reaches ``on_progress``."""
    d = str(tmp_path / "fleet")
    kw = dict(num_learners=2, num_actors=2, queue_capacity=4,
              max_batch_trajs=2, seed=0, device="cpu")
    _, _, tel1 = run_group_training("bandit", _icfg(), 4, 2, ckpt_every=2,
                                    ckpt_dir=d, **kw)
    tree, step, extra = ckpt.load_with_extra(d)
    assert (step, extra) == (2, {"version": 2, "format": "fleet-v1"})
    saved = params_digest(tree["params"])
    assert set(tel1["group"]["param_digests"].values()) == {saved}
    _, _, tel2 = run_group_training("bandit", _icfg(), 4, 2, resume_from=d,
                                    **kw)
    assert set(tel2["group"]["param_digests"].values()) == {saved}
    assert tel2["group"]["param_versions"] == [2, 2]
    seen = []
    _, _, tel3 = run_group_training(
        "bandit", _icfg(), 4, 4, resume_from=d, telemetry_interval_s=1e-3,
        on_progress=lambda k, snap: seen.append(
            (k, snap["learner_updates"])), **kw)
    assert tel3["group"]["param_versions"] == [4, 4]
    # the time-based sends: every worker reported after each round
    assert {k for k, _ in seen} == {0, 1}
    assert {n for _, n in seen} <= {3, 4} and len(seen) >= 2
    assert tel3["group"]["replicas_identical"]
    assert [tel3["learners"][f"learner_{k}"]["exchange"]["rounds"]
            for k in range(2)] == [2, 2]
    # a params-only tree cannot seed a group
    ckpt.save(str(tmp_path / "plain"), 1, tree["params"])
    with pytest.raises(ValueError, match="fleet-v1"):
        run_group_training("bandit", _icfg(), 4, 2,
                           resume_from=str(tmp_path / "plain"), **kw)


_ASYNC = ["--device", "cpu", "--runtime", "async", "--smoke", "--env",
          "bandit"]
_GROUP = _ASYNC + ["--learners", "2", "--num-envs", "4", "--unroll", "8",
                   "--max-batch-trajs", "2"]


@pytest.mark.timeout_s(300)
def test_cli_group_prints_the_jax_lines(capsys):
    """``--learners 2 --smoke`` end to end: the banner, a ``learner K
    update N`` line from each learner at the log cadence, ``final
    return(100)``, the telemetry line with the JAX CLI's keys and the
    per-learner trajectories."""
    run = train_lib.train(_GROUP + ["--steps", "4", "--log-every", "2"])
    out = capsys.readouterr().out
    assert "learners=2 actors=2(thread/unroll)" in out
    for k in range(2):
        for n in (2, 4):
            assert f"learner {k} update {n:6d}" in out
    assert "reduce_ms=" in out and "stale=0" in out
    assert "final return(100) =" in out
    line = next(x for x in out.splitlines() if x.startswith("telemetry:"))
    tel = json.loads(line[len("telemetry:"):])
    assert list(tel) == ["group", "learner_updates", "frames_consumed",
                         "updates_per_sec", "frames_per_sec", "lag",
                         "actors", "param_version"]
    assert tel["group"]["param_versions"] == [4, 4]
    assert tel["group"]["replicas_identical"]
    per = json.loads(next(x for x in out.splitlines() if x.startswith(
        "per-learner trajectories:")).split(":", 1)[1])
    assert per == tel["actors"]["per_learner_trajectories"]
    assert isinstance(run, train_lib.GroupRun)
    assert set(run.kernel_counts) == {0, 1}


@pytest.mark.timeout_s(300)
def test_cli_group_checkpoint_rules(tmp_path, capsys):
    """The JAX CLI's rules: a group refuses an existing checkpoint without
    ``--resume``, refuses a params-only one with it, and resumes from a
    fleet-v1 one, continuing the version stream."""
    plain = str(tmp_path / "plain")
    argv = _GROUP + ["--steps", "2", "--log-every", "2", "--ckpt-dir",
                     plain, "--ckpt-every", "2"]
    train_lib.train(argv)
    assert ckpt.latest_step(plain) == 2
    with pytest.raises(SystemExit, match="already holds a checkpoint "
                                         r"\(step 2\); move it aside"):
        train_lib.train(argv)
    with pytest.raises(SystemExit, match="params-only checkpoint"):
        train_lib.train(argv + ["--resume"])
    fleet = str(tmp_path / "fleet")
    run_group_training("bandit", _icfg(), 4, 2, num_learners=2,
                       num_actors=2, max_batch_trajs=2, ckpt_every=2,
                       ckpt_dir=fleet, device="cpu", arch=None)
    argv = _GROUP + ["--steps", "3", "--log-every", "3", "--ckpt-dir",
                     fleet]
    with pytest.raises(SystemExit, match="pass --resume to continue it"):
        train_lib.train(argv)
    capsys.readouterr()
    run = train_lib.train(argv + ["--resume"])
    assert "resuming learner group from fleet checkpoint (step 2)" in \
        capsys.readouterr().out
    assert run.telemetry["group"]["param_versions"] == [3, 3]
    assert run.telemetry["group"]["replicas_identical"]


@pytest.mark.parametrize("argv,match", [
    (["--learners", "2", "--learner-mode", "spmd"],
     "keeps ONE learner process"),
    (["--runtime", "sync", "--learner-mode", "spmd"],
     "requires --runtime async"),
    (["--learners", "2", "--supervise", "--transport", "socket"],
     "requires --actor-backend remote"),
])
def test_cli_group_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_lib.train(_ASYNC + argv + ["--steps", "1"])


def test_group_api_refuses_supervision_and_hooks():
    # a supervised group still checks its env before it spawns a worker
    with pytest.raises(ValueError, match="env name"):
        run_group_training(object(), _icfg(), 4, 1, supervise=True,
                           device="cpu")
    with pytest.raises(ValueError, match="env name"):
        run_group_training(object(), _icfg(), 4, 1, device="cpu")
    with pytest.raises(ValueError, match="one learner"):
        train_lib.train(_GROUP + ["--steps", "1"],
                        on_update=lambda *a: None)
