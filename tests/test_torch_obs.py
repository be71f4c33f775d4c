"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's: counterparts of ``tests/test_obs.py``'s unit tests (the
registry, Prometheus rendering, health, the HTTP server's routes and its
500, the trace recorder's spans, clock normalisation, partial stamps,
bound and exchange rounds, export, serde's ``e1`` stamp, the JSONL sink,
``parse_profile_steps``), then parity: the same snapshots render to the
same Prometheus text and health, the same stamps to the same Chrome
events, serde carries a trace between the packages both ways, and
``ObsConfig`` has JAX's fields and defaults. ``ProfileHook`` runs
``torch.profiler`` over a hand-driven window on the CPU."""
import dataclasses
import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.distributed import serde as j_serde
from repro.obs import http as j_http
from repro.obs import sink as j_sink
from repro.obs import trace as j_trace
from repro_torch import obs as t_obs
from repro_torch.distributed import serde as t_serde
from repro_torch.obs import http as t_http
from repro_torch.obs import sink as t_sink
from repro_torch.obs import trace as t_trace
from repro_torch.obs.http import MetricsServer, health, render_prometheus
from repro_torch.obs.metrics import Registry
from repro_torch.obs.sink import JsonlSink, ProfileHook, parse_profile_steps
from repro_torch.obs.trace import (EXCHANGE_SPAN_NAMES, SPAN_NAMES,
                                   TraceRecorder)

torch.set_num_threads(1)

# a Prometheus text-format sample line (tests/test_obs.py's pattern)
PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
    r'"[^"]*")*\})? -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$')


def get(addr, route):
    url = f"http://{addr[0]}:{addr[1]}{route}"
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode("utf-8")


# ---------------------------------------------------------------------------
# the registry


def test_registry_create_or_get_identity():
    reg = Registry()
    c1 = reg.counter("q.pushed")
    c2 = reg.counter("q.pushed")
    assert c1 is c2
    c1.inc(3)
    c2.inc()
    assert reg.collect()["q.pushed"] == 4
    reg.gauge("q.size").set(7.5)
    h = reg.int_histogram("lag")
    h.observe(0, 2)
    h.counts[3] += 1
    col = reg.collect()
    assert col["q.size"] == 7.5 and col["lag"] == {0: 2, 3: 1}
    col["lag"][9] = 99              # a copy, not the live storage
    assert 9 not in reg.collect()["lag"]


def test_registry_type_mismatch_raises():
    reg = Registry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.int_histogram("x")


def test_registry_producers_none_omitted_and_errors_captured():
    reg = Registry()
    reg.register_producer("queue", lambda: {"depth": 2})
    reg.register_producer("inference", lambda: None)

    def boom():
        raise RuntimeError("snapshot torn")
    reg.register_producer("exchange", boom)
    col = reg.collect()
    assert col["queue"] == {"depth": 2} and "inference" not in col
    assert "snapshot torn" in col["exchange"]["error"]
    reg.register_producer("queue", lambda: {"depth": 5})
    assert reg.collect()["queue"]["depth"] == 5


# ---------------------------------------------------------------------------
# Prometheus rendering and health


def test_render_prometheus_names_buckets_and_learner_label():
    snap = {"frames_per_sec": 1234.5,
            "queue": {"mean_occupancy": 1.25, "dropped": 0,
                      "policy": "block"},
            "lag": {"hist": {0: 10, 3: 2}, "mean": 0.5},
            "learners": {"learner_0": {"frames_per_sec": 600.0},
                         "learner_1": {"frames_per_sec": 634.5}},
            "learner.lag_hist": {1: 4},
            "actor_mode": "unroll", "donate": True}
    lines = [ln for ln in render_prometheus(snap).splitlines() if ln]
    assert all(PROM_LINE.match(ln) for ln in lines), lines
    for want in ("repro_frames_per_sec 1234.5",
                 'repro_lag_hist{bucket="0"} 10',
                 'repro_lag_hist{bucket="3"} 2',
                 'repro_frames_per_sec{learner="0"} 600',
                 'repro_frames_per_sec{learner="1"} 634.5',
                 'repro_learner_lag_hist{bucket="1"} 4',
                 "repro_donate 1"):
        assert want in lines
    assert not any("actor_mode" in ln or "policy" in ln for ln in lines)


def test_health_ok_degraded_unhealthy():
    assert health({"queue": {"dropped": 0}})[1]["status"] == "ok"
    code, body = health({"queue": {"dropped": 3},
                         "socket": {"reconnects": 1}})
    assert (code, body["status"]) == (200, "degraded")
    assert any("dropped=3" in r for r in body["reasons"])
    for snap in ({"group": {"dead_learners": [2]}, "queue": {"dropped": 3}},
                 {"exchange": {"hub_gone": True}},
                 {"group": {"replicas_identical": False}}):
        code, body = health(snap)
        assert (code, body["status"]) == (503, "unhealthy"), snap


def test_health_supervisor_tri_state():
    code, body = health({"supervisor": {
        "restarts": 0, "failovers": 0, "restart_in_flight": 0,
        "failover_in_flight": 0, "restarts_exhausted": []}})
    assert (code, body["status"]) == (200, "ok")
    for key in ("restart_in_flight", "failover_in_flight"):
        code, body = health({"supervisor": {key: 1}})
        assert (code, body["status"]) == (200, "degraded"), key
    assert health({"exchange": {"degraded_solo": True}})[1]["status"] == \
        "degraded"
    assert health({"supervisor": {"restarts": 4}})[1]["status"] == "ok"
    code, body = health({"supervisor": {"restarts_exhausted": ["actor-3"]}})
    assert code == 503 and any("actor-3" in r for r in body["reasons"])


# ---------------------------------------------------------------------------
# the HTTP server (loopback sockets)


def test_metrics_server_routes():
    state = {"snap": {"frames_per_sec": 10.0, "queue": {"dropped": 0}}}
    srv = MetricsServer(lambda: state["snap"], port=0).start()
    try:
        code, text = get(srv.address, "/metrics")
        assert code == 200 and "repro_frames_per_sec 10" in text
        code, text = get(srv.address, "/healthz")
        assert code == 200 and json.loads(text)["status"] == "ok"
        code, text = get(srv.address, "/telemetry")
        assert code == 200 and json.loads(text) == state["snap"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(srv.address, "/nope")
        assert ei.value.code == 404
        state["snap"] = {"queue": {"dropped": 9}}
        code, text = get(srv.address, "/healthz")
        assert code == 200 and json.loads(text)["status"] == "degraded"
        state["snap"] = {"exchange": {"hub_gone": True}}
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(srv.address, "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read().decode())["status"] == \
            "unhealthy"
    finally:
        srv.stop()


def test_metrics_server_snapshot_failure_is_500_not_crash():
    def boom():
        raise RuntimeError("mid-teardown")
    srv = MetricsServer(boom, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(srv.address, "/metrics")
        assert ei.value.code == 500
        # still serving after the failure
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(srv.address, "/telemetry")
        assert ei.value.code == 500
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the trace recorder


class Item:
    def __init__(self, trace, actor_id=0, param_version=5):
        self.trace = trace
        self.actor_id = actor_id
        self.param_version = param_version


def spans_by_name(events):
    return {e["name"]: e for e in events if e.get("ph") == "X"}


def test_trace_recorder_emits_all_seven_spans():
    rec = TraceRecorder()
    t = 100.0
    tr = {"u0": t, "u1": t + 1, "e0": t + 1.1, "e1": t + 1.2, "r": t + 1.3}
    rec.record_item(Item(tr), dequeued=t + 1.5, collected=t + 1.6,
                    step0=t + 1.7, step1=t + 1.9, published=t + 2.0, lag=2)
    spans = spans_by_name(rec.chrome_events())
    assert set(spans) == set(SPAN_NAMES) and rec.recorded == 1
    assert spans["env_unroll"]["dur"] == pytest.approx(1e6)
    assert spans["transport"]["ts"] == pytest.approx((t + 1.2) * 1e6)
    assert spans["queue_wait"]["ts"] == pytest.approx((t + 1.3) * 1e6)
    assert spans["publish"]["dur"] == pytest.approx(0.1e6, rel=1e-3)
    assert spans["train_step"]["args"]["lag"] == 2
    assert spans["env_unroll"]["pid"] == 1000
    assert spans["train_step"]["pid"] == 1
    names = {e["args"]["name"] for e in rec.chrome_events() if e["ph"] == "M"}
    assert names == {"actor-0", "learner"}


def test_trace_recorder_cross_clock_normalization():
    rec = TraceRecorder()
    lr, ar = 5000.0, 4000.0           # the actor's clock 1000 s behind
    tr = {"u0": ar, "u1": ar + 1, "e0": ar + 1, "e1": ar + 1.1, "r": lr}
    rec.record_item(Item(tr), dequeued=lr + 0.2, collected=lr + 0.3,
                    step0=lr + 0.3, step1=lr + 0.4, published=lr + 0.45)
    spans = spans_by_name(rec.chrome_events())
    assert spans["transport"]["ts"] == pytest.approx(lr * 1e6)
    assert spans["transport"]["dur"] == 0.0
    assert spans["env_unroll"]["ts"] == pytest.approx((lr - 1.1) * 1e6)
    assert spans["env_unroll"]["dur"] == pytest.approx(1e6)


def test_trace_recorder_partial_stamps_and_bound():
    rec = TraceRecorder(max_trajectories=2)
    rec.record_item(Item(None), dequeued=1, collected=1, step0=1, step1=1,
                    published=1)
    assert rec.recorded == 0
    for t in (10.0, 11.0, 12.0):
        rec.record_item(Item({"u0": t, "u1": t + 0.5}), dequeued=t + 0.6,
                        collected=t + 0.7, step0=t + 0.7, step1=t + 0.8,
                        published=t + 0.9)
    spans = spans_by_name(rec.chrome_events())
    assert set(spans) == set(SPAN_NAMES)
    assert spans["serde_encode"]["dur"] == 0.0
    assert rec.recorded == 2 and rec.dropped == 1


def test_trace_recorder_exchange_round_spans():
    rec = TraceRecorder(max_trajectories=2)
    t = 50.0
    rec.record_exchange_round(3, enter=t, gathered=t + 0.2,
                              reduced=t + 0.25, done=t + 0.3)
    spans = [e for e in rec.chrome_events() if e["ph"] == "X"]
    assert [s["name"] for s in spans] == list(EXCHANGE_SPAN_NAMES)
    assert all(s["pid"] == 2 and s["args"] == {"round": 3} for s in spans)
    assert spans[0]["dur"] == pytest.approx(0.2e6)
    assert spans[1]["ts"] == pytest.approx((t + 0.2) * 1e6)
    assert spans[2]["dur"] == pytest.approx(0.05e6)
    rec.record_exchange_round(4, enter=t, gathered=t, reduced=t, done=t)
    rec.record_exchange_round(5, enter=t, gathered=t, reduced=t, done=t)
    assert rec.recorded == 2 and rec.dropped == 1


def test_trace_export_loads_as_chrome_trace(tmp_path):
    rec = TraceRecorder()
    rec.record_item(Item({"u0": 1.0, "u1": 2.0}), dequeued=2.1,
                    collected=2.2, step0=2.2, step1=2.3, published=2.4)
    path = tmp_path / "trace.json"
    assert rec.export(str(path)) == 1
    doc = json.loads(path.read_text())
    assert {e["name"] for e in doc["traceEvents"]
            if e["ph"] == "X"} == set(SPAN_NAMES)


# ---------------------------------------------------------------------------
# serde carries the trace


def traj():
    return {"obs_image": np.arange(24, dtype=np.uint8).reshape(3, 8),
            "rewards": np.ones((3,), np.float32)}


def test_serde_roundtrips_trace_and_stamps_e1():
    before = time.monotonic()
    item = t_serde.TrajectoryItem(traj(), 4, 1, 123.0,
                                  trace={"u0": 1.0, "u1": 2.0, "e0": 2.5})
    out = t_serde.decode_item(t_serde.encode_item(item))
    assert out.trace["u0"] == 1.0 and out.trace["e0"] == 2.5
    assert before <= out.trace["e1"] <= time.monotonic()
    assert "e1" not in item.trace     # the sender's dict is left alone
    plain = t_serde.TrajectoryItem(traj(), 4, 1, 123.0)
    assert t_serde.decode_item(t_serde.encode_item(plain)).trace is None


# ---------------------------------------------------------------------------
# the sink and the profile window


def test_jsonl_sink_writes_lines(tmp_path):
    path = tmp_path / "tel.jsonl"
    sink = JsonlSink(str(path), lambda: {"x": 1}, interval_s=0.05).start()
    time.sleep(0.2)
    sink.stop()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert sink.lines_written == len(lines) >= 2
    assert all(ln["telemetry"] == {"x": 1} and "t" in ln for ln in lines)


def test_parse_profile_steps():
    assert parse_profile_steps("3:10") == (3, 10)
    assert parse_profile_steps("0:0") == (0, 0)
    for bad in ("10", "5:2", "-1:4", "a:b"):
        with pytest.raises(ValueError):
            parse_profile_steps(bad)


def test_profile_hook_writes_one_chrome_trace_of_its_window(tmp_path):
    """Updates [2, 3] of a hand-driven loop: the profiler starts before
    update 2 and stops before update 4, one Chrome trace that loads as
    JSON; ``stop()`` again changes nothing."""
    hook = ProfileHook("2:3", str(tmp_path / "prof"))
    x = torch.ones(64, 64)
    seen = []
    for update in range(6):
        hook.on_step(update)
        seen.append(hook.active)
        x = torch.tanh(x @ x / 64.0)
    assert seen == [False, False, True, True, False, False]
    assert hook.done and not hook.active
    files = list((tmp_path / "prof").iterdir())
    assert [f.name for f in files] == ["updates_2_3.pt.trace.json"]
    assert str(files[0]) == hook.path
    doc = json.loads(files[0].read_text())
    assert any(e.get("name") == "aten::mm" for e in doc["traceEvents"])
    mtime = files[0].stat().st_mtime_ns
    hook.stop()
    hook.on_step(2)
    assert not hook.active and files[0].stat().st_mtime_ns == mtime


# ---------------------------------------------------------------------------
# parity with the JAX package


# snapshots the renderer and health walk: a single learner's, a group's
# merged one with learners.learner_<k>, bucket dicts, dotted producer
# keys, bools, strings, lists and None, and each degraded and unhealthy
# key set and unset
_SINGLE = {
    "learner_updates": 6, "frames_consumed": 3840,
    "updates_per_sec": 2.5, "frames_per_sec": 1234.5,
    "batch_size_hist": {1: 2, 2: 4},
    "lag": {"hist": {0: 3, 1: 7, 4: 1}, "mean": 0.81818, "max": 4,
            "measured": 11},
    "queue": {"capacity": 8, "policy": "block", "size": 0, "pushed": 12,
              "dropped": 0, "put_stalls": 3, "mean_occupancy": 1.25},
    "actors": {"num_actors": 2, "backend": "thread",
               "rejected_per_actor": [0, 0], "actor_fps": 1e3},
    "param_version": 6, "actor_mode": "unroll", "donate": True,
    "phases": {"updates_timed": 6,
               "total_s": {"collect": 0.001, "step": 0.25},
               "mean_ms": {"collect": 0.16666, "step": 41.6667}},
    "learner.lag_hist": {1: 4, 2: 0}, "none_key": None,
    "big": 1e20, "neg": -3, "tiny": 1.5e-7,
}
_GROUP = {
    "group": {"num_learners": 2, "publisher": 0, "stale_dropped": 0,
              "replicas_identical": True, "param_versions": [6, 6],
              "param_digests": {"learner_0": "ab", "learner_1": "ab"}},
    "learner_updates": 6, "frames_per_sec": 2000.0,
    "lag": {"hist": {0: 5}, "mean": 0.0},
    "learners": {f"learner_{k}": dict(
        _SINGLE, learner_id=k, slot_base=k,
        exchange={"rounds": 6, "reduce_wait_ms_mean": 12.5,
                  "stale_dropped": 0, "bytes_in": 100, "bytes_out": 200,
                  "hub_gone": False}) for k in range(2)},
    "actors": {"per_learner_trajectories": {"learner_0": 5,
                                            "learner_1": 6}},
}
_DEGRADED = ("dropped", "reconnects", "torn_tails", "stale_dropped",
             "discarded", "decode_errors", "drain_errors",
             "partial_rounds", "hub_gone_retries")
_FLAGS = {"hub_gone": True, "dead_learners": [1],
          "replicas_identical": False, "restarts_exhausted": ["actor-0"],
          "restart_in_flight": 1, "failover_in_flight": True,
          "degraded_solo": True}
SNAPSHOTS = ([{}, _SINGLE, _GROUP]
             + [{"queue": {k: 2}} for k in _DEGRADED]
             + [{"queue": {k: [1, 2]}} for k in _DEGRADED]
             + [{"learners": {"learner_1": {"exchange": {k: v}}}}
                for k, v in _FLAGS.items()]
             + [dict(_GROUP, group=dict(_GROUP["group"], **{k: v}))
                for k, v in _FLAGS.items()])


@pytest.mark.parametrize("snap", SNAPSHOTS)
def test_prometheus_and_health_equal_jax(snap):
    assert t_http.render_prometheus(snap) == j_http.render_prometheus(snap)
    assert t_http.health(snap) == j_http.health(snap)


def test_the_parity_grid_reaches_every_health_state():
    states = {t_http.health(s)[1]["status"] for s in SNAPSHOTS}
    assert states == {"ok", "degraded", "unhealthy"}


def _stamp_grid(rec):
    """The same stamps into a recorder of either package: full, partial,
    cross-clock, traceless, labelled lag and none, exchange rounds, and
    past the bound."""
    t = 1000.0
    items = [
        ({"u0": t, "u1": t + 1, "e0": t + 1.1, "e1": t + 1.2, "r": t + 1.3},
         0, 7, 2),
        ({"u0": t, "u1": t + 0.5}, 1, 3, None),
        ({"u0": 4000.0, "u1": 4001.0, "e0": 4001.0, "e1": 4001.1,
          "r": t + 2}, 2, 9, 0),
        ({"r": t + 3}, 3, 1, 1),
        (None, 0, 1, 1),
        ({"u1": t + 4, "e1": t + 4.2}, 1, 2, 5),
    ]
    for k, (tr, aid, ver, lag) in enumerate(items):
        base = t + 5 + k
        rec.record_item(Item(tr, aid, ver), dequeued=base,
                        collected=base + 0.1,
                        step0=None if k == 1 else base + 0.2,
                        step1=base + 0.3, published=base + 0.35, lag=lag)
    rec.record_exchange_round(4, enter=t + 20, gathered=t + 20.5,
                              reduced=t + 20.6, done=t + 20.9)
    rec.record_exchange_round(5, enter=t + 21, gathered=t + 20.9,
                              reduced=t + 21, done=t + 21)


@pytest.mark.parametrize("bound", [2048, 3])
def test_chrome_events_equal_jax(bound, tmp_path):
    t_rec, j_rec = TraceRecorder(bound), j_trace.TraceRecorder(bound)
    _stamp_grid(t_rec)
    _stamp_grid(j_rec)
    assert t_rec.chrome_events() == j_rec.chrome_events()
    assert (t_rec.recorded, t_rec.dropped) == (j_rec.recorded, j_rec.dropped)
    assert t_rec.export(str(tmp_path / "t.json")) == \
        j_rec.export(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert (t_trace.SPAN_NAMES, t_trace.EXCHANGE_SPAN_NAMES,
            t_trace.CLOCK_SKEW_S) == (j_trace.SPAN_NAMES,
                                      j_trace.EXCHANGE_SPAN_NAMES,
                                      j_trace.CLOCK_SKEW_S)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_traced_items_cross_the_packages_both_ways(codec, monkeypatch):
    """A port item with a trace decodes in JAX's ``decode_item`` with
    ``e1`` set, and JAX's in the port's; with the clock held, the two
    packages' bytes are equal, traced or not."""
    data = {"obs_image": np.random.default_rng(0).integers(
        0, 255, (3, 5, 4, 4, 1)).astype(np.uint8),
        "rewards": np.linspace(-1, 1, 15, dtype=np.float32).reshape(3, 5)}
    tr = {"u0": 1.0, "u1": 2.0, "e0": 2.5}
    t_item = t_serde.TrajectoryItem(data, 4, 1, 123.0, trace=dict(tr))
    j_item = j_serde.TrajectoryItem(data, 4, 1, 123.0, dict(tr))
    before = time.monotonic()
    got = j_serde.decode_item(t_serde.encode_item(t_item, codec=codec))
    assert got.trace["e0"] == 2.5
    assert before <= got.trace["e1"] <= time.monotonic()
    back = t_serde.decode_item(j_serde.encode_item(j_item, codec=codec))
    assert back.trace["u1"] == 2.0
    assert before <= back.trace["e1"] <= time.monotonic()
    assert (back.param_version, back.actor_id) == (4, 1)
    monkeypatch.setattr(time, "monotonic", lambda: 77.25)
    assert t_serde.encode_item(t_item, codec=codec) == \
        j_serde.encode_item(j_item, codec=codec)
    assert t_serde.encode_item(
        t_serde.TrajectoryItem(data, 4, 1, 123.0), codec=codec) == \
        j_serde.encode_item(j_serde.TrajectoryItem(data, 4, 1, 123.0),
                            codec=codec)


def test_obs_config_has_jax_fields_and_defaults():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(t_obs.ObsConfig) == fields(j_obs.ObsConfig)
    assert (t_obs.SPAN_NAMES, t_obs.TraceRecorder.__name__) == \
        (j_obs.SPAN_NAMES, j_obs.TraceRecorder.__name__)
    for name in ("Counter", "Gauge", "IntHistogram", "Registry"):
        assert hasattr(t_obs, name)


@pytest.mark.parametrize("spec", ["3:10", "0:0", "10", "5:2", "-1:4",
                                  "a:b", "1:", ":2", " 2:3", "2:3:4"])
def test_parse_profile_steps_equals_jax(spec):
    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(t_sink.parse_profile_steps) == run(j_sink.parse_profile_steps)
