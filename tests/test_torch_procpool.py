"""Process-backend actors of the port end to end on the CPU: spawned
children act on the CPU, ship serialized trajectories over the shm wire
and pull serialized params; in inference mode they submit to the
service's process frontend. Each run trains, keeps the JAX runtime's
telemetry keys and leaves no child behind. The learning bars of the JAX
tests are held on the card only (``chip_smoke.py``), since they are
load-dependent on a shared CPU."""
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ImpalaConfig
from repro_torch.distributed import run_async_training
from repro_torch.distributed import serde
from repro_torch.distributed.runner import _ParamSlots, _stream_seed, \
    actor_seed
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)

_KW = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
           entropy_cost=0.003, rmsprop_eps=0.01)


def _icfg(**kw):
    return ImpalaConfig(**dict(_KW, **kw))


def _no_orphans(t0):
    deadline = time.monotonic() + 30
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert mp.active_children() == [], (
        f"orphans after {time.monotonic() - t0:.0f}s")


@pytest.mark.timeout_s(120)
def test_process_actors_train_and_close_cleanly():
    t0 = time.monotonic()
    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=6, num_actors=2,
        actor_backend="process", transport="shm", queue_capacity=4,
        queue_policy="block", max_batch_trajs=2, seed=0, device="cpu")
    assert tel["learner_updates"] == 6
    assert tel["param_version"] == 6
    assert np.isfinite(float(metrics["loss/total"]))
    assert tel["actors"]["backend"] == "process"
    assert tel["actors"]["trajectories"] >= 6
    assert tel["queue"]["wire_received"] >= 6
    assert tel["queue"]["drain_errors"] == 0
    assert tel["lag"]["measured"] >= 6
    _no_orphans(t0)


@pytest.mark.timeout_s(120)
def test_process_inference_actors_train_and_close_cleanly():
    t0 = time.monotonic()
    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=6, num_actors=2,
        actor_backend="process", actor_mode="inference", transport="shm",
        queue_capacity=4, queue_policy="block", max_batch_trajs=2, seed=0,
        infer_streams=2, device="cpu")
    assert tel["learner_updates"] == 6
    assert np.isfinite(float(metrics["loss/total"]))
    assert tel["actors"]["backend"] == "process"
    assert tel["queue"]["wire_received"] >= 6
    inf = tel["inference"]
    assert inf["flushes"] > 0
    assert inf["flushes"] == (inf["flush_full"] + inf["flush_ready"] +
                              inf["flush_timeout"])
    assert tel["lag"]["measured"] >= 6
    _no_orphans(t0)


@pytest.mark.timeout_s(120)
def test_process_cli_runs_with_a_codec_and_prints_the_jax_keys(capsys):
    run = train_lib.train(["--device", "cpu", "--runtime", "async",
                           "--smoke", "--env", "catch", "--steps", "4",
                           "--num-envs", "4", "--unroll", "5",
                           "--log-every", "2", "--actor-backend", "process",
                           "--wire-codec", "int8"])
    out = capsys.readouterr().out
    assert "transport=shm" in out and "update      4" in out
    assert run.telemetry["queue"]["wire_codec"] == "int8"
    assert run.telemetry["actors"]["backend"] == "process"
    assert run.telemetry["learner_updates"] == 4


@pytest.mark.parametrize("argv,match", [
    (["--actor-backend", "process", "--transport", "inproc"],
     "requires --transport shm"),
    (["--actor-backend", "remote", "--transport", "shm"],
     "requires --transport socket"),
    (["--actor-backend", "thread", "--transport", "socket"], "socket"),
])
def test_cli_pairs_backends_with_their_transports(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_lib.train(["--device", "cpu", "--runtime", "async",
                         "--steps", "1"] + argv)


def test_param_slots_never_write_the_tree_in_use():
    """The child's subscriber decodes each version into the tree the
    unroll does not hold; a structure change allocates anew."""
    slots = _ParamSlots()
    assert slots.pull() is None

    def buf(v):
        return serde.encode_tree({"w": np.full(3, v, np.float32)})

    slots.install(buf(1), 1)
    a, va = slots.pull()
    assert va == 1
    slots.install(buf(2), 2)
    slots.install(buf(3), 3)
    assert a["w"].tolist() == [1, 1, 1]       # untouched while in use
    b, vb = slots.pull()
    assert vb == 3 and b["w"].tolist() == [3, 3, 3] and b is not a
    slots.install(buf(4), 4)
    assert b["w"].tolist() == [3, 3, 3]
    c, _ = slots.pull()
    assert c is a and c["w"].tolist() == [4, 4, 4]   # filled in place
    slots.install(serde.encode_tree({"w": np.zeros(5, np.float32)}), 5)
    assert slots.pull()[0]["w"].shape == (5,)


def test_stream_seeds_follow_the_thread_actors_scheme():
    assert _stream_seed(7, 3, 0, 1) == actor_seed(7, 3)
    seeds = {_stream_seed(7, 3, s, 2) for s in range(2)}
    assert len(seeds) == 2 and actor_seed(7, 3) not in seeds
