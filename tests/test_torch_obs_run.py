"""Whole runs of the port's async runtime with the flight recorder on, on
the CPU: the counterpart of ``tests/test_obs.py``'s end-to-end run (the
live server curled mid-run, the ``phases`` section, seven spans, the
sink); the same obs run through the JAX runtime and the port's giving
the same ``phases`` keys, Prometheus sample names and labels, and span
names; no ``phases`` without obs; traces from process actors across the
process boundary; one ``/metrics`` for a learner group of two; the CLI
with all nine observability flags.

RNG streams differ across the packages, so whole runs are compared by
their structure, not their values."""
import json
import multiprocessing as mp
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from repro import obs as j_obs
from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.distributed import run_async_training as j_run_async
from repro.obs.http import render_prometheus as j_render
from repro_torch.configs.base import ImpalaConfig
from repro_torch.distributed import run_async_training, run_group_training
from repro_torch.launch import train as train_lib
from repro_torch.obs import SPAN_NAMES, ObsConfig
from repro_torch.obs.http import render_prometheus

torch.set_num_threads(1)

_KW = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
           entropy_cost=0.003, rmsprop_eps=0.01)
# tests/test_obs.py's run: bandit, 4 envs, 6 updates, one actor
_RUN = dict(num_envs=4, steps=6, num_actors=1, queue_capacity=4,
            queue_policy="block", max_batch_trajs=2, seed=0)
PHASES = {"collect", "host_stage", "device_put", "step", "publish"}
PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
    r'"[^"]*")*\})? -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$')


def get(addr, route):
    url = f"http://{addr[0]}:{addr[1]}{route}"
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode("utf-8")


def samples(text):
    """The (name, label names) of each sample line; bucket values differ
    from run to run, so only the label's name is kept."""
    out = set()
    for ln in text.splitlines():
        head = ln.rsplit(" ", 1)[0]
        name, _, labels = head.partition("{")
        out.add((name, tuple(re.findall(r'([a-zA-Z_]+)="', labels))))
    return out


def span_names(path):
    doc = json.loads(path.read_text())
    return {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}


def no_orphans():
    deadline = time.monotonic() + 30
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert mp.active_children() == []


def test_async_run_with_full_observability(tmp_path):
    """The port's counterpart of test_obs.py's run: /metrics and /healthz
    curled mid-run through the live server, all seven spans in the
    exported trace, the ``phases`` section, the sink's time series."""
    obs = ObsConfig(metrics_port=0, trace_path=str(tmp_path / "trace.json"),
                    trace_every=1, sink_path=str(tmp_path / "tel.jsonl"),
                    sink_interval_s=0.1)
    mid = {}

    def on_update(step, params, metrics, snapshot_fn):
        if step == 3:
            mid["metrics"] = get(obs.bound_address, "/metrics")
            mid["healthz"] = get(obs.bound_address, "/healthz")

    _, _, tel = run_async_training("bandit", ImpalaConfig(**_KW), **_RUN,
                                   on_update=on_update, obs=obs,
                                   device="cpu")
    assert tel["learner_updates"] == 6
    code, text = mid["metrics"]
    lines = [ln for ln in text.splitlines() if ln]
    assert code == 200 and lines and all(PROM_LINE.match(ln) for ln in lines)
    assert any(ln.startswith("repro_learner_updates ") for ln in lines)
    assert any(ln.startswith("repro_frames_per_sec ") for ln in lines)
    code, text = mid["healthz"]
    assert code == 200 and json.loads(text)["status"] in ("ok", "degraded")
    ph = tel["phases"]
    assert ph["updates_timed"] == 6 and set(ph["total_s"]) == PHASES
    assert all(v >= 0.0 for v in ph["total_s"].values())
    assert span_names(tmp_path / "trace.json") == set(SPAN_NAMES)
    sink = [json.loads(ln) for ln in
            (tmp_path / "tel.jsonl").read_text().splitlines()]
    assert sink and sink[-1]["telemetry"]["learner_updates"] == 6
    with pytest.raises(urllib.error.URLError):       # the server stopped
        get(obs.bound_address, "/metrics")


def test_obs_run_has_the_jax_runs_structure(tmp_path):
    """The same obs run through both runtimes: equal ``phases`` keys,
    Prometheus sample names and labels rendered from the final snapshot,
    and span names. Without obs the port's snapshot has no ``phases`` and
    the same keys otherwise."""
    def obs(cls, name):
        return cls(trace_path=str(tmp_path / f"{name}.json"), trace_every=1)

    j_cfg = obs(j_obs.ObsConfig, "jax")
    _, _, j_tel = j_run_async("bandit", JaxImpalaConfig(**_KW), **_RUN,
                              obs=j_cfg)
    _, _, t_tel = run_async_training("bandit", ImpalaConfig(**_KW), **_RUN,
                                     obs=obs(ObsConfig, "port"),
                                     device="cpu")
    for key in ("total_s", "mean_ms"):
        assert set(t_tel["phases"][key]) == set(j_tel["phases"][key]) \
            == PHASES
    assert set(t_tel["phases"]) == set(j_tel["phases"])
    assert samples(render_prometheus(t_tel)) == samples(j_render(j_tel))
    assert span_names(tmp_path / "port.json") == \
        span_names(tmp_path / "jax.json") == set(SPAN_NAMES)
    _, _, plain = run_async_training("bandit", ImpalaConfig(**_KW), **_RUN,
                                     device="cpu")
    assert "phases" not in plain
    assert set(plain) == set(t_tel) - {"phases"}


@pytest.mark.timeout_s(120)
def test_process_actors_trace_across_the_process_boundary(tmp_path):
    """Children sample every unroll (the rate reaches them through the
    environment): their spans carry the encode stamps, on a row per
    actor that sent one; the variable is restored after the run."""
    path = tmp_path / "trace.json"
    _, _, tel = run_async_training(
        "bandit", ImpalaConfig(**_KW), num_envs=4, steps=4, num_actors=2,
        actor_backend="process", transport="shm", max_batch_trajs=2,
        seed=0, obs=ObsConfig(trace_path=str(path), trace_every=1),
        device="cpu")
    assert tel["learner_updates"] == 4
    events = json.loads(path.read_text())["traceEvents"]
    rows = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    enc = [e for e in events if e["name"] == "serde_encode"]
    wire = [e for e in events if e["name"] == "transport"]
    actors = {e["args"]["actor_id"] for e in enc}
    assert rows == {1: "learner",
                    **{1000 + a: f"actor-{a}" for a in actors}}
    assert actors <= {0, 1} and all(e["pid"] == 1000 + e["args"]["actor_id"]
                                    and e["dur"] > 0 for e in enc)
    assert len(wire) == len(enc) == tel["lag"]["measured"]
    assert "REPRO_TRACE_EVERY" not in os.environ
    no_orphans()


@pytest.mark.timeout_s(120)
def test_group_serves_one_metrics_port_for_both_learners():
    """``run_group_training(obs=ObsConfig(metrics_port=0))``: the parent's
    /metrics shows both learners under a ``learner`` label while the
    group runs, and /healthz answers 200."""
    obs = ObsConfig(metrics_port=0, telemetry_interval_s=0.1)
    seen, done = {"labels": set(), "healthz": None}, threading.Event()

    def scrape():
        while not done.is_set():
            if obs.bound_address is not None:
                try:
                    _, text = get(obs.bound_address, "/metrics")
                    seen["labels"] |= set(re.findall(
                        r'^repro_learner_updates\{learner="(\d)"\}', text,
                        re.M))
                    seen["healthz"] = get(obs.bound_address, "/healthz")[0]
                except (urllib.error.URLError, ConnectionError):
                    pass
                if len(seen["labels"]) == 2:
                    return
            time.sleep(0.05)

    poller = threading.Thread(target=scrape, daemon=True)
    poller.start()
    try:
        _, _, tel = run_group_training(
            "bandit", ImpalaConfig(**_KW), 4, 30, num_learners=2,
            num_actors=2, queue_capacity=4, max_batch_trajs=2, seed=1,
            obs=obs, device="cpu")
    finally:
        done.set()
        poller.join(timeout=10)
    assert tel["group"]["param_versions"] == [30, 30]
    assert obs.bound_address is not None and obs.bound_address[1] > 0
    assert seen["labels"] == {"0", "1"} and seen["healthz"] == 200
    no_orphans()


@pytest.mark.timeout_s(120)
def test_cli_with_all_nine_observability_flags(tmp_path):
    """``--runtime async --smoke`` with the nine flags: the trace, the
    sink, the telemetry JSON and the profile of updates 2-3 are written,
    and the returned telemetry has its ``phases``."""
    files = {k: tmp_path / k for k in ("t.json", "s.jsonl", "tel.json")}
    run = train_lib.train([
        "--device", "cpu", "--runtime", "async", "--smoke", "--env",
        "bandit", "--num-envs", "4", "--unroll", "8", "--steps", "6",
        "--log-every", "3", "--metrics-port", "0", "--metrics-host",
        "127.0.0.1", "--trace", str(files["t.json"]), "--trace-every", "1",
        "--telemetry-sink", str(files["s.jsonl"]), "--sink-interval-s",
        "0.1", "--profile-steps", "2:3", "--profile-dir",
        str(tmp_path / "prof"), "--telemetry-json", str(files["tel.json"])])
    assert run.telemetry["phases"]["updates_timed"] == 6
    assert span_names(files["t.json"]) == set(SPAN_NAMES)
    sink = files["s.jsonl"].read_text().splitlines()
    assert json.loads(sink[-1])["telemetry"]["learner_updates"] == 6
    assert json.loads(files["tel.json"].read_text())["phases"] == \
        json.loads(json.dumps(run.telemetry["phases"]))
    prof = tmp_path / "prof" / "updates_2_3.pt.trace.json"
    assert json.loads(prof.read_text())["traceEvents"]
