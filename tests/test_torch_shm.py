"""The port's shm transport and serialized parameter path on the CPU:
thread actors over the shm wire (every byte of the serde boundary
without process start-up), the queue's wire keys against the JAX
runtime's, the drain side's policy and attribution, and
``ParameterStore.pull_serialized``."""
import multiprocessing as mp

import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.distributed import run_async_training as j_run_async

from repro_torch.configs.base import ImpalaConfig
from repro_torch.distributed import ParameterStore, run_async_training
from repro_torch.distributed import serde
from repro_torch.distributed.supervise import KillSafeEvent
from repro_torch.distributed.transport import ShmTransport, make_transport

torch.set_num_threads(1)

_KW = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
           entropy_cost=0.003, rmsprop_eps=0.01)


def _icfg(**kw):
    return ImpalaConfig(**dict(_KW, **kw))


def _item(i, actor_id=0):
    rng = np.random.default_rng(i)
    image = np.zeros((2, 3, 16, 16, 1), np.uint8)
    image[:, :, i, 3] = 255                    # sparse, like catch's
    return serde.TrajectoryItem(
        {"obs_image": image,
         "rewards": rng.standard_normal((2, 3)).astype(np.float32),
         "lstm_state": (rng.standard_normal((2, 256)).astype(np.float32),
                        np.zeros((2, 256), np.float32))},
        param_version=i, actor_id=actor_id, produced_at=float(i))


def test_paramstore_pull_serialized_is_version_gated_and_cached():
    store = ParameterStore({"w": torch.arange(4, dtype=torch.float32)})
    buf, version = store.pull_serialized(have_version=-1)
    assert version == 0
    tree, _ = serde.decode_tree(buf)
    assert tree["w"].tobytes() == np.arange(4, dtype=np.float32).tobytes()
    # a current subscriber: nothing newer, no re-encode
    assert store.pull_serialized(have_version=0) is None
    n = store.serialized_encodes
    # a second stale subscriber hits the per-version cache
    buf2, v2 = store.pull_serialized(have_version=-1)
    assert v2 == 0 and buf2 == buf
    assert store.serialized_encodes == n
    assert store.serialized_wire_bytes == len(buf)
    assert store.serialized_raw_bytes == 16
    # a publish invalidates: the next pull re-encodes exactly once
    store.publish({"w": torch.zeros(4)})
    buf3, v3 = store.pull_serialized(have_version=0)
    assert v3 == 1 and buf3 != buf
    store.pull_serialized(have_version=0)
    assert store.serialized_encodes == n + 1
    # the store's codec applies to the published tree
    q = ParameterStore({"w": torch.full((1024,), 1.0 / 3.0)},
                       wire_codec="bf16")
    qbuf, _ = q.pull_serialized()
    assert q.serialized_raw_bytes == 4096 and len(qbuf) < 0.6 * 4096
    np.testing.assert_allclose(serde.decode_tree(qbuf)[0]["w"], 1 / 3,
                               rtol=2 ** -8)
    with pytest.raises(serde.CodecMismatchError):
        ParameterStore({"w": torch.zeros(1)}, wire_codec="fp8")


@pytest.mark.timeout_s(60)
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_shm_transport_round_trips_items_with_wire_counters(codec):
    t = make_transport("shm", 4, "block", wire_codec=codec)
    try:
        assert isinstance(t, ShmTransport) and not t.rejects_at_put
        seen = []
        t.on_item = seen.append
        # capacity 4 leaves the wire one credit: each put waits for the
        # drain thread to read the previous buffer, so it gets the gets'
        # deadline, not the default 0.1 s
        for i in range(3):
            assert t.put(_item(i, actor_id=i), timeout=10)
        got = [t.get(timeout=10) for _ in range(3)]
        assert [g.param_version for g in got] == [0, 1, 2]
        for i, g in enumerate(got):
            want = _item(i).data
            np.testing.assert_array_equal(g.data["rewards"],
                                          want["rewards"])
            assert isinstance(g.data["obs_image"], np.ndarray)
            if codec == "none":
                np.testing.assert_array_equal(g.data["lstm_state"][0],
                                              want["lstm_state"][0])
        assert len(seen) == 3
        snap = t.snapshot()
        assert snap["transport"] == "shm" and snap["wire_codec"] == codec
        assert snap["wire_received"] == 3 and snap["drain_errors"] == 0
        assert snap["traj_raw_bytes"] == 3 * serde.tree_nbytes(
            _item(0).data)
        assert snap["traj_wire_bytes"] == snap["wire_bytes"] > 0
        if codec == "int8":
            assert snap["wire_compression"] > 1.0
    finally:
        t.close()
    assert t.closed and t.put(_item(9)) is False


@pytest.mark.timeout_s(60)
def test_shm_drop_newest_rejects_at_the_drain_and_counts_torn_buffers():
    t = ShmTransport(capacity=1, policy="drop_newest")
    try:
        rejected = []
        t.on_reject = rejected.append
        t.producer().send(b"not a serde buffer")
        for i in range(3):
            assert t.put(_item(i), timeout=5)
        deadline = 100
        while t.wire_received < 4 and deadline:
            deadline -= 1
            mp.connection.wait([], timeout=0.05)
        assert t.snapshot()["drain_errors"] == 1
        assert len(t) == 1 and len(rejected) == 2
    finally:
        t.close()


def test_kill_safe_event_is_a_latch():
    e = KillSafeEvent()
    assert not e.is_set() and e.wait(0.01) is False
    e.set()
    assert e.is_set() and e.wait(None) is True
    e.clear()
    assert not e.is_set()


@pytest.mark.timeout_s(120)
def test_thread_actors_over_shm_transport_train():
    kw = dict(num_envs=4, steps=8, num_actors=2, queue_capacity=4,
              queue_policy="block", max_batch_trajs=2, seed=3)
    _, metrics, tel = run_async_training(
        "bandit", _icfg(), actor_backend="thread", transport="shm",
        device="cpu", **kw)
    assert tel["learner_updates"] == 8
    assert np.isfinite(float(metrics["loss/total"]))
    q = tel["queue"]
    assert q["transport"] == "shm"
    assert q["wire_received"] >= 8 and q["wire_bytes"] > 0
    assert tel["lag"]["measured"] >= 8
    assert tel["actors"]["backend"] == "thread"
    # the queue section's keys are the JAX runtime's over the same wire
    _, _, j_tel = j_run_async("bandit", JaxImpalaConfig(**_KW),
                              actor_backend="thread", transport="shm",
                              **dict(kw, steps=2))
    assert set(q) == set(j_tel["queue"])
    assert set(tel) == set(j_tel)


@pytest.mark.timeout_s(120)
def test_thread_actors_over_shm_with_a_lossy_codec_train():
    _, metrics, tel = run_async_training(
        "catch", _icfg(), num_envs=4, steps=4, num_actors=1,
        actor_backend="thread", transport="shm", wire_codec="bf16",
        max_batch_trajs=1, seed=1, device="cpu")
    assert tel["learner_updates"] == 4
    assert np.isfinite(float(metrics["loss/total"]))
    q = tel["queue"]
    assert q["wire_codec"] == "bf16"
    # catch's sparse uint8 planes deflate, the lstm state halves
    assert q["traj_raw_bytes"] > 1.5 * q["traj_wire_bytes"]


def test_process_backend_requires_serializing_transport():
    with pytest.raises(ValueError, match="shm"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           actor_backend="process", transport="inproc",
                           device="cpu")
    with pytest.raises(ValueError, match="actor_backend"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           actor_backend="fiber", device="cpu")
