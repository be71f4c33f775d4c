"""The port's twins of ``examples/`` and the last pieces of the JAX
package they use: ``TrajectoryQueue``, ``median_normalised_score`` and
``all_configs`` beside the JAX package's; then each
``examples/<name>_torch.py`` run through its ``main`` on ``--device cpu``
at a tiny size (its ``--steps`` where it has that flag, its module
constants set before the call), every line it prints held to the format
of the JAX example's line (the same names, the same JSON keys as the JAX
runtime's telemetry), and its parameter counts to the JAX package's.
``train_remote_torch.py`` also runs as a learner on port 0 and its
actors as a second process dialing the port it printed.

RNG streams differ across the packages (threefry, Philox), so runs are
compared by what they print, not by its values."""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.core import metrics as j_metrics
from repro.core import queue as j_queue
from repro.data.envs import make_env as j_make_env
from repro.distributed.transport import make_transport as j_transport
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch.configs import registry
from repro_torch.core import metrics
from repro_torch.core.queue import TrajectoryQueue

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
NUM = r"-?\d+\.\d{3}|nan"


def _twin(name):
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys, name, argv, **consts):
    """What ``main(argv)`` of the twin prints, its module constants
    ``consts`` set first."""
    mod = _twin(name)
    for k, v in consts.items():
        assert hasattr(mod, k), k
        setattr(mod, k, v)
    mod.main(argv)
    return capsys.readouterr().out.splitlines()


def _match(lines, patterns):
    """Each line matches its pattern, in order; ``None`` skips a line."""
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        if pat is not None:
            assert re.fullmatch(pat, line), (pat, line)


def _jax_keys(kind):
    t = j_transport(kind, 8, "block")
    try:
        return set(t.snapshot())
    finally:
        t.close()


def _json_after(line, label):
    assert line.startswith(label), line
    return json.loads(line[len(label):])


# ---------------------------------------------------------------------------
# queue, metrics, registry


def test_trajectory_queue_matches_jax():
    """One put/get sequence past the capacity: the same answers, counts
    and objects (held by reference) from both rings."""
    items = [{"t": torch.full((2,), float(i))} for i in range(9)]
    got, want = TrajectoryQueue(3), j_queue.TrajectoryQueue(3)
    ops = ["put"] * 5 + ["get", "get", "put", "put", "get"] + \
        ["put"] * 2 + ["get"] * 5
    i = 0
    for op in ops:
        if op == "put":
            assert got.put(items[i]) is want.put(items[i]) is True
            i += 1
        else:
            a, b = got.get(), want.get()
            assert a is b
        assert (len(got), got.dropped, got.pushed) == \
            (len(want), want.dropped, want.pushed)
    assert got.get() is None and got.dropped == 3 and got.pushed == 9


def test_median_normalised_score_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 4, 57):
        random = rng.normal(size=n)
        human = random + rng.uniform(0.0, 5.0, size=n)
        scores = rng.normal(size=n) * 4.0
        human[0] = random[0]                  # a zero range is floored
        args = (scores.tolist(), human.tolist(), random.tolist())
        assert metrics.median_normalised_score(*args) == \
            j_metrics.median_normalised_score(*args)


def test_all_configs_matches_jax():
    """The same names in the same order; every field the port's config
    has equals JAX's, and JAX's others are the ones the port leaves out
    (no remat, no layer scan, no tied embeddings or LSTM switch)."""
    got, want = registry.all_configs(), j_registry.all_configs()
    assert list(got) == list(want)
    for name, cfg in got.items():
        mine = dataclasses.asdict(cfg)
        theirs = dataclasses.asdict(want[name])
        assert set(theirs) - set(mine) == {"tie_embeddings", "use_lstm",
                                           "scan_group", "scan_layers",
                                           "remat"}, name
        assert {k: theirs[k] for k in mine} == mine, name


# ---------------------------------------------------------------------------
# the twins of examples/


def test_every_jax_example_has_a_twin():
    names = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.endswith(".py"))
    jax = [f for f in names if not f.endswith("_torch.py")]
    assert len(jax) == 8
    assert [f for f in names if f.endswith("_torch.py")] == \
        sorted(f[:-3] + "_torch.py" for f in jax)


def test_quickstart_twin(capsys):
    from repro.configs.registry import get_smoke_config
    from repro.data.envs import make_catch
    env = make_catch()
    j_arch = get_smoke_config("impala-shallow").replace(
        image_hw=env.image_hw)
    count = j_common.param_count(j_bb.backbone_specs(j_arch,
                                                     env.num_actions))
    lines = _lines(capsys, "quickstart", ["--device", "cpu", "--steps", "2"],
                   NUM_ENVS=4, LOG_EVERY=2)
    _match(lines, [re.escape(f"params: {count:,}"),
                   rf"step 2: return\(100\) = ({NUM})  "
                   rf"\(optimal 1\.0, random ~ -0\.6\)",
                   r"done\."])


def test_vtrace_ablation_twin(capsys):
    lines = _lines(capsys, "vtrace_ablation", ["--device", "cpu", "--steps",
                                               "2"], NUM_ENVS=4)
    _match(lines, [r"env=catch policy_lag=6 steps=2",
                   re.escape(f"{'variant':<14s} {'no-replay':>10s} "
                             f"{'replay':>10s}")]
           + [rf"{m:<14s} +({NUM}) +({NUM})"
              for m in ("vtrace", "onestep_is", "eps", "none")]
           + ["", re.escape("Expected qualitative ordering (paper Table "
                            "2): vtrace >= onestep_is > eps/none, gap "
                            "widening with replay.")])


def test_train_100m_twin(capsys):
    """One layer (``LAYERS``) of the ~100M decoder, its count the JAX
    example's arch's at that depth; the step line at step 20."""
    env = j_make_env("bandit")
    j_arch = j_registry.get_config("qwen1.5-4b").replace(
        num_layers=1, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=3072, vocab_size=max(4096, env.vocab_size), remat=False)
    n = j_common.param_count(j_bb.backbone_specs(j_arch, env.num_actions))
    lines = _lines(capsys, "train_100m", [
        "--device", "cpu", "--steps", "20", "--num-envs", "1",
        "--unroll", "1"], LAYERS=1, MIN_PARAMS=0)
    _match(lines, [re.escape(f"backbone: qwen1.5-4b-100m  "
                             f"params={n/1e6:.1f}M"),
                   rf"step   20 return\(100\)= *({NUM}) loss= *-?\d+\.\d\d "
                   rf"fps= *\d+",
                   rf"final return\(100\) = ({NUM})"])


def test_serve_actors_twin(capsys):
    from repro.configs.registry import get_smoke_config
    cfg = get_smoke_config("mistral-nemo-12b").replace(vocab_size=4096)
    count = j_common.param_count(j_bb.backbone_specs(cfg, 18))
    lines = _lines(capsys, "serve_actors", ["--device", "cpu"],
                   DECODE_STEPS=4)
    _match(lines, [re.escape(f"backbone mistral-nemo-12b params="
                             f"{count:,}"),
                   re.escape("prefill: logits (16, 1, 18), cache ready"),
                   r"decode: 4 steps x 16 actors = 64 actions in "
                   r"\d+\.\d\ds \(\d+ actions/s\)",
                   r"values sample: \[.*\]"])


def test_multitask_pbt_twin(capsys):
    lines = _lines(capsys, "multitask_pbt", [
        "--device", "cpu", "--pop", "2", "--rounds", "1",
        "--steps-per-round", "2"])
    e = r"\d\.\d\de[-+]\d\d"
    _match(lines, [rf"round 0 member {i}: fitness=({NUM}) lr={e} "
                   rf"ent={e}( \(copied\))?" for i in range(2)]
           + ["", rf"best member [01]: fitness ({NUM})"])


def _update(extra):
    return (rf"update \d+: loss=-?\d+\.\d\d lag\(mean\)=\d+\.\d\d "
            + extra + r" fps=\d+")


@pytest.mark.timeout_s(120)
def test_train_async_twin(capsys):
    lines = _lines(capsys, "train_async", ["--device", "cpu"], STEPS=4,
                   INFERENCE_STEPS=4, NUM_ENVS=4, LOG_EVERY=2)
    ups = [i for i, line in enumerate(lines) if line.startswith("update ")]
    assert ups == [0, 1]
    _match(lines, [_update(r"queue_occ=\d+\.\d")] * 2 + [
        rf"return\(100\) = ({NUM}) \(optimal 1\.0, random ~ -0\.6\)",
        None, None, "",
        re.escape("-- same actors, inference mode: one dynamic-batching "
                  "service forward instead of per-actor unrolls --"),
        rf"return\(100\) = ({NUM}) after 4 updates",
        r"service: \d+ flushes \(full=\d+ ready=\d+ timeout=\d+\), "
        r"mean batch \d+\.\d\d",
        None, r"queue wait p50/p95 = \d+\.\d\d/\d+\.\d\d ms", r"done\."])
    hist = _json_after(lines[3], "measured lag histogram: ")
    assert all(k.isdigit() for k in hist) and sum(hist.values()) > 0
    assert set(_json_after(lines[4], "queue: ")) == _jax_keys("inproc")
    sizes = _json_after(lines[9], "batch-size histogram: ")
    assert all(k.isdigit() for k in sizes)


@pytest.mark.timeout_s(120)
def test_train_multiproc_twin(capsys):
    lines = _lines(capsys, "train_multiproc", ["--device", "cpu"], STEPS=4,
                   NUM_ENVS=4, LOG_EVERY=2)
    _match(lines, [_update(r"wire_mb=\d+\.\d")] * 2 + [
        rf"return\(100\) = ({NUM}) \(optimal 1\.0, random ~ -0\.6\)",
        None, None, r"done\."])
    assert set(_json_after(lines[3], "measured lag histogram: "))
    assert set(_json_after(lines[4], "transport: ")) == _jax_keys("shm")


# the keys of a socket transport's per-actor record, as the JAX
# package's ``SocketTransport.snapshot`` writes them
PER_ACTOR_KEYS = {"frames", "bytes", "losses", "torn_tails", "reconnects",
                  "queue_wait_ms_mean", "connected", "last_seen_age_s",
                  "lease_reaps"}
# the learner's run cut to 4 updates of 4 envs, a line every 2
REMOTE_CUT = {"STEPS": 4, "NUM_ENVS": 4, "LOG_EVERY": 2}
REMOTE_LINES = [_update(r"net=\d+\.\d\dMB/s reconnects=\d+")] * 2 + [
    rf"return\(100\) = ({NUM}) \(optimal 1\.0, random ~ -0\.6\)",
    r"socket: \d+ frames, \d+\.\dMB, 0 reconnects, 0 torn tails, "
    r"0 decode errors", None, r"done\."]


def _per_actor(socket_line, line):
    """The per-actor records: one for each of the two actors that had
    connected when the run ended (a cut run can end before the second
    child is up), each with the JAX package's keys, their frames summing
    to the socket line's."""
    per = _json_after(line, "per-actor: ")
    assert per and set(per) <= {"0", "1"}, per
    assert all(set(v) == PER_ACTOR_KEYS for v in per.values())
    frames = int(re.match(r"socket: (\d+) frames", socket_line).group(1))
    assert sum(v["frames"] for v in per.values()) == frames


@pytest.mark.timeout_s(120)
def test_train_remote_twin_demo(capsys):
    lines = _lines(capsys, "train_remote", ["demo", "--device", "cpu"],
                   **REMOTE_CUT)
    _match(lines, REMOTE_LINES)
    _per_actor(lines[3], lines[4])


@pytest.mark.timeout_s(120)
def test_train_remote_twin_learner_on_port_0_and_actors(tmp_path):
    """The launcher pair as two processes: the learner on port 0 prints
    the port it got, and ``actor --connect`` with two actors dials it.
    The learner's process sets the twin's constants to ``REMOTE_CUT``
    before its ``main``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    script = os.path.join(ROOT, "examples", "train_remote_torch.py")
    out = open(tmp_path / "learner.txt", "w+")
    boot = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('t', sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            f"vars(mod).update({REMOTE_CUT!r})\n"
            "mod.main(sys.argv[2:])\n")
    learner = subprocess.Popen(
        [sys.executable, "-c", boot, script, "learner", "--port", "0",
         "--host", "127.0.0.1", "--device", "cpu"], stdout=out,
        stderr=subprocess.STDOUT, env=env)
    actors = None
    try:
        deadline, port = time.time() + 60, None
        while port is None and time.time() < deadline:
            time.sleep(0.2)
            found = re.search(r"learner listening on 127\.0\.0\.1:(\d+)",
                              (tmp_path / "learner.txt").read_text())
            port = found and found.group(1)
            assert learner.poll() is None, \
                (tmp_path / "learner.txt").read_text()
        assert port and port != "0"
        actors = subprocess.run(
            [sys.executable, script, "actor", "--connect",
             f"127.0.0.1:{port}", "--num", "2"], env=env,
            capture_output=True, text=True, timeout=90)
        assert learner.wait(timeout=60) == 0
    finally:
        if learner.poll() is None:
            learner.kill()
            learner.wait()
        out.close()
    assert actors.returncode == 0, actors.stdout + actors.stderr
    lines = (tmp_path / "learner.txt").read_text().splitlines()
    assert lines[0].startswith(f"learner listening on 127.0.0.1:{port}")
    _match(lines[1:], REMOTE_LINES)
    _per_actor(lines[4], lines[5])
