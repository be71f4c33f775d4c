"""Whole runs of the port's async runtime on the CPU: the final telemetry's
key set against the JAX runtime's, and the JAX runtime tests' own claims
(the synchronous handoff, each backpressure policy against a slow
learner, dynamic batching with measured lag) on the port; bandit learns
to the JAX bar with two actor threads; the CLI prints the reference's
log and telemetry lines.

RNG streams differ across the packages (threefry, Philox), so whole runs
are compared by their structure and counts, not their values."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.distributed import run_async_training as j_run_async

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.driver import run_training
from repro_torch.distributed import run_async_training
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)

_KW = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
           entropy_cost=0.003, rmsprop_eps=0.01)


def _icfg(**kw):
    return ImpalaConfig(**dict(_KW, **kw))


def _keys(tel):
    return {"top": set(tel), "lag": set(tel["lag"]),
            "queue": set(tel["queue"]), "actors": set(tel["actors"])}


def test_telemetry_key_set_matches_jax():
    kw = dict(num_envs=4, steps=4, num_actors=2, max_batch_trajs=2, seed=0)
    _, j_metrics, j_tel = j_run_async("bandit", JaxImpalaConfig(**_KW), **kw)
    _, t_metrics, t_tel = run_async_training("bandit", _icfg(), **kw,
                                             device="cpu")
    assert _keys(t_tel) == _keys(j_tel)
    assert set(t_metrics) == set(j_metrics)
    for tel in (j_tel, t_tel):
        assert tel["learner_updates"] == tel["param_version"] == 4
        assert tel["frames_consumed"] == \
            tel["lag"]["measured"] * 4 * _KW["unroll_length"]
        assert sum(tel["batch_size_hist"].values()) == 4
        assert tel["donate"] is True and tel["actor_mode"] == "unroll"


def test_async_one_actor_matches_sync_driver_step_count():
    """1 actor thread + block policy + capacity 1 + no dynamic batching is
    the synchronous handoff: the sync driver's step count, finite losses,
    every trajectory consumed exactly once."""
    steps = 6
    icfg = _icfg()
    _, metrics_s = run_training("bandit", icfg, num_envs=4, steps=steps,
                                seed=0, device="cpu")
    _, metrics_a, tel = run_async_training(
        "bandit", icfg, num_envs=4, steps=steps, num_actors=1,
        queue_capacity=1, queue_policy="block", max_batch_trajs=1, seed=0,
        device="cpu")
    assert tel["learner_updates"] == steps
    assert tel["param_version"] == steps
    assert tel["frames_consumed"] == steps * 4 * icfg.unroll_length
    assert np.isfinite(float(metrics_a["loss/total"]))
    assert np.isfinite(float(metrics_s["loss/total"]))
    assert tel["batch_size_hist"] == {1: steps}
    assert tel["queue"]["dropped"] == 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("actor-")]


@pytest.mark.parametrize("policy", ["block", "drop_oldest", "drop_newest"])
def test_async_stress_slow_learner_each_policy(policy):
    """4 actor threads against a slow learner: no deadlock, lag measured
    on every trajectory, and each policy's signature: stalls for block,
    drops for the others, measured lag where stale work queues up, and
    every loss charged back to the actor that made it."""
    def slow_update(step, params, metrics, snapshot_fn):
        time.sleep(0.05)

    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=8, num_actors=4,
        queue_capacity=2, queue_policy=policy, max_batch_trajs=2, seed=1,
        on_update=slow_update, device="cpu")
    assert tel["learner_updates"] == 8
    assert np.isfinite(float(metrics["loss/total"]))
    assert tel["lag"]["measured"] >= 8
    q, actors = tel["queue"], tel["actors"]
    if policy == "block":
        assert q["put_stalls"] > 0 and q["dropped"] == 0, q
        assert tel["lag"]["max"] > 0, tel["lag"]
    elif policy == "drop_newest":
        assert q["dropped"] > 0, q
        assert tel["lag"]["max"] > 0, tel["lag"]
    else:
        assert q["dropped"] > 0, q
        assert tel["lag"]["mean"] <= 2.0, tel["lag"]
    if policy != "block":
        assert actors["rejected"] > 0, (actors, q)
    assert abs(actors["rejected"] - q["dropped"]) <= 4, (actors, q)
    assert sum(actors["rejected_per_actor"]) == actors["rejected"]


def test_async_measured_lag_and_dynamic_batching():
    """Trajectories arrive faster than updates: stacked batches (k > 1)
    appear and the measured lag histogram is filled."""
    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=10, num_actors=2,
        queue_capacity=8, queue_policy="block", max_batch_trajs=4, seed=2,
        device="cpu")
    assert tel["learner_updates"] == 10
    assert sum(tel["lag"]["hist"].values()) == tel["lag"]["measured"]
    assert tel["lag"]["measured"] >= 10
    assert tel["frames_consumed"] == tel["lag"]["measured"] * 4 * 8
    assert np.isfinite(float(metrics["loss/total"]))


def test_bandit_learns_to_the_jax_bar_with_two_actor_threads():
    """tests/test_system.py's bandit bar (mean return over 200 > 0.6),
    with the same smoke agent and config, run async by two actor
    threads."""
    arch = get_smoke_config("impala-shallow").replace(image_hw=(4, 4, 3))
    icfg = ImpalaConfig(num_actions=4, unroll_length=16, learning_rate=1e-3,
                        entropy_cost=0.005, rmsprop_eps=0.01)
    tracker, metrics, tel = run_async_training(
        "bandit", icfg, num_envs=32, steps=150, num_actors=2, seed=0,
        arch=arch, device="cpu")
    assert tel["learner_updates"] == 150
    assert np.isfinite(float(metrics["loss/total"]))
    final = tracker.mean_return(200)
    assert final > 0.6, f"bandit should approach 1.0, got {final}"


def test_cli_runs_the_async_path_on_cpu(capsys):
    seen = []
    run = train_lib.train(["--device", "cpu", "--runtime", "async",
                           "--smoke", "--env", "catch", "--steps", "6",
                           "--num-envs", "4", "--unroll", "5",
                           "--log-every", "3", "--no-donate"],
                          on_update=lambda step, *_: seen.append(step))
    assert seen == [1, 2, 3, 4, 5, 6]
    out = capsys.readouterr().out
    assert "runtime=async actors=2(thread/unroll) transport=inproc " \
           "queue=8/block max_batch_trajs=4 donate=False" in out
    assert out.count("lag(mean/max)=") == 2
    line = next(ln for ln in out.splitlines()
                if ln.startswith("telemetry: "))
    tel = json.loads(line[len("telemetry: "):])
    assert list(tel) == list(train_lib.TELEMETRY_KEYS)
    assert tel["learner_updates"] == tel["param_version"] == 6
    assert run.telemetry["donate"] is False and run.params
