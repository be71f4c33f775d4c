"""The port's dynamic-batching inference service and the thread-mode
inference driver (paper §3.1) on the CPU: the JAX package's own thread
cases (tests/test_inference_service.py), then parity with the JAX service
and the JAX trajectory assembly.

A flush's forward is held to the JAX service's jitted flush from the
same params and request: logits, the log-prob of the action JAX sampled,
and the next (h, c), at 1e-5. Sampled actions cannot match (threefry
against Philox), so the log-prob is taken of JAX's action.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.data import envs as j_envs
from repro.distributed import runner as j_runner
from repro.distributed.inference import InferenceService as JaxService
from repro.distributed.paramstore import ParameterStore as JaxStore
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor as actor_lib
from repro_torch.core.driver import init_params, small_arch
from repro_torch.data.envs import make_bandit, make_catch
from repro_torch.distributed import ParameterStore, run_async_training
from repro_torch.distributed import inference as inf
from repro_torch.distributed import runner

torch.set_num_threads(1)


def _icfg(**kw):
    base = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
                entropy_cost=0.003, rmsprop_eps=0.01)
    base.update(kw)
    return ImpalaConfig(**base)


# ---------------------------------------------------------------------------
# service unit behaviour (no runtime)


def test_pow2_floor_and_ceil():
    assert [inf._pow2_floor(n) for n in (1, 2, 3, 4, 5, 7, 8, 9)] == \
        [1, 2, 2, 4, 4, 4, 8, 8]
    assert [inf._pow2_ceil(n) for n in (1, 2, 3, 4, 5, 7, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 16]


def _make_service(num_clients=2, flush_timeout_s=0.5, num_envs=3):
    env = make_bandit()
    arch = small_arch(env)
    store = ParameterStore(init_params(arch, env.num_actions, 0, "cpu"))
    svc = inf.InferenceService(env, arch, _icfg(num_actions=4), store,
                               num_clients=num_clients,
                               flush_timeout_s=flush_timeout_s, seed=0)
    return svc, arch, num_envs


def _request(num_envs, width, hw, seed=None):
    if seed is None:
        return {
            "obs_image": np.zeros((num_envs,) + hw, np.uint8),
            "last_action": np.zeros((num_envs,), np.int32),
            "last_reward": np.zeros((num_envs,), np.float32),
            "done": np.zeros((num_envs,), bool),
            "lstm_h": np.zeros((num_envs, width), np.float32),
            "lstm_c": np.zeros((num_envs, width), np.float32),
        }
    rng = np.random.default_rng(seed)
    return {
        "obs_image": ((rng.uniform(size=(num_envs,) + hw) < 0.2)
                      * 255).astype(np.uint8),
        "last_action": rng.integers(0, 3, num_envs).astype(np.int32),
        "last_reward": rng.choice([-1.0, 0.0, 1.0], num_envs).astype(
            np.float32),
        "done": rng.uniform(size=num_envs) < 0.3,
        "lstm_h": (rng.standard_normal((num_envs, width)) * 0.3).astype(
            np.float32),
        "lstm_c": (rng.standard_normal((num_envs, width)) * 0.3).astype(
            np.float32),
    }


def test_service_rejects_token_backbones():
    env = make_bandit()
    arch = get_smoke_config("mistral-nemo-12b")
    store = ParameterStore({"w": torch.zeros(1)})
    with pytest.raises(ValueError, match="unroll"):
        inf.InferenceService(env, arch, _icfg(), store, num_clients=1)


@pytest.mark.timeout_s(120)
def test_service_full_bucket_flush_and_reply_slicing():
    """Two clients, long flush timeout: replies must arrive via a *full*
    (or all-clients-ready) flush, not the timeout path, and each client
    must get exactly its own slice back: its rows of the batched
    forward."""
    svc, arch, n = _make_service(num_clients=2, flush_timeout_s=10.0)
    hw = make_bandit().image_hw
    c1, c2 = svc.connect(), svc.connect()
    reqs = {"a": _request(n, arch.lstm_width, hw, seed=1),
            "b": _request(n, arch.lstm_width, hw, seed=2)}
    out = {}

    def call(name, client):
        out[name] = client.infer(reqs[name])

    t1 = threading.Thread(target=call, args=("a", c1))
    t2 = threading.Thread(target=call, args=("b", c2))
    t1.start(); t2.start(); t1.join(30); t2.join(30)
    assert not t1.is_alive() and not t2.is_alive()
    params = svc._store.pull()[0]
    for name in ("a", "b"):
        r = out[name]
        assert r is not None and r.param_version == 0
        assert r.action.shape == (n,) and r.action.dtype == np.int32
        assert r.logprob.dtype == np.float32
        assert r.lstm_state[0].shape == (n, arch.lstm_width)
        # the client's own rows: its request's forward alone
        buf = np.zeros((n, svc._layout.row), np.uint8)
        svc._layout.pack([reqs[name]], buf)
        logits, h, c = svc.forward(params,
                                   svc._layout.unpack(torch.from_numpy(buf)))
        np.testing.assert_allclose(r.lstm_state[0], h.numpy(), atol=1e-5)
        np.testing.assert_allclose(r.lstm_state[1], c.numpy(), atol=1e-5)
        np.testing.assert_allclose(
            r.logprob, actor_lib.action_logprob(
                logits, torch.from_numpy(r.action)).numpy(), atol=1e-5)
    snap = svc.snapshot()
    assert snap["flush_timeout"] == 0
    assert snap["flush_full"] + snap["flush_ready"] >= 1
    assert snap["batch_size_hist"].get(2) == 1
    assert snap["requests"] == 2 and snap["frames"] == 2 * n
    svc.stop()


def test_packed_rows_unpack_to_the_request():
    """One request crosses to the device as one packed uint8 buffer; its
    fields come back bit for bit."""
    width, hw = 7, (10, 5, 3)
    lay = inf._Layout(hw, width)
    reqs = [_request(3, width, hw, seed=5), _request(2, width, hw, seed=6)]
    buf = np.zeros((5, lay.row), np.uint8)
    lay.pack(reqs, buf)
    got = lay.unpack(torch.from_numpy(buf))
    cat = {k: np.concatenate([r[k] for r in reqs]) for k in reqs[0]}
    np.testing.assert_array_equal(got["image"][:, 0].numpy(),
                                  cat["obs_image"])
    np.testing.assert_array_equal(got["last_action"][:, 0].numpy(),
                                  cat["last_action"])
    np.testing.assert_array_equal(got["last_reward"][:, 0].numpy(),
                                  cat["last_reward"])
    np.testing.assert_array_equal(got["done"][:, 0].numpy(), cat["done"])
    np.testing.assert_array_equal(got["lstm_state"][0].numpy(),
                                  cat["lstm_h"])
    np.testing.assert_array_equal(got["lstm_state"][1].numpy(),
                                  cat["lstm_c"])


@pytest.mark.timeout_s(120)
def test_service_single_straggler_flushes_without_timeout_stall():
    """One connected client: its lone request is a 'ready' flush (every
    possible requester is in) — it must not wait out a long timeout."""
    svc, arch, n = _make_service(num_clients=4, flush_timeout_s=30.0)
    c = svc.connect()
    req = _request(n, arch.lstm_width, make_bandit().image_hw)
    t0 = time.monotonic()
    r = c.infer(req)
    dt = time.monotonic() - t0
    assert r is not None
    assert dt < 10.0, f"lone request stalled {dt:.1f}s behind timeout"
    snap = svc.snapshot()
    assert snap["flush_ready"] >= 1
    # a lone request flushes as a bucket of its own, unpadded
    assert snap["max_batch_requests"] == 4
    assert snap["batch_size_hist"] == {1: 1} and snap["padded_requests"] == 0
    svc.stop()


@pytest.mark.timeout_s(120)
def test_partial_flush_pads_up_to_its_bucket():
    """Three requests in a bucket of 4 flush together, padded with a
    copy of the last request; the padding's replies are dropped."""
    svc, arch, n = _make_service(num_clients=4, flush_timeout_s=30.0)
    hw = make_bandit().image_hw
    waiters = [svc.submit_async(_request(n, arch.lstm_width, hw, seed=s))
               for s in range(3)]
    svc.drive_flushes()
    assert all(w.event.is_set() and w.slot[0] is not None for w in waiters)
    snap = svc.snapshot()
    assert snap["batch_size_hist"] == {3: 1}
    assert snap["padded_requests"] == 1 and snap["flush_ready"] == 1
    svc.stop()


@pytest.mark.timeout_s(120)
def test_service_stop_unblocks_clients():
    svc, arch, n = _make_service(num_clients=8, flush_timeout_s=30.0)
    c = svc.connect()
    c2 = svc.connect()          # 2 connected, so 1 pending is not "ready"
    del c2
    req = _request(n, arch.lstm_width, make_bandit().image_hw)
    got = []
    t = threading.Thread(target=lambda: got.append(c.infer(req)))
    t.start()
    time.sleep(0.3)
    svc.stop()
    t.join(15)
    assert not t.is_alive()
    assert got == [None]
    # submits after shutdown are refused outright
    assert c.infer(req) is None


@pytest.mark.timeout_s(60)
def test_process_frontends_are_not_ported():
    """The process frontend (ROADMAP.md Queue 1 item 10, done): a
    pipe client's request crosses the wire, waits for a second client
    that never submits, and is flushed by the service's own thread at
    the ``flush_timeout_s`` deadline, not before."""
    import multiprocessing as mp

    svc, arch, n = _make_service(num_clients=2, flush_timeout_s=0.3)
    fe = svc.process_frontend(mp.get_context("spawn"), 2)
    clients = [fe.register(0), fe.register(1)]
    stop = threading.Event()
    for c in clients:
        c.bind_stop(stop)
    svc.start()
    fe.start()
    try:
        req = _request(n, arch.lstm_width, make_bandit().image_hw)
        t0 = time.monotonic()
        reply = clients[0].infer(req)
        waited = time.monotonic() - t0
        assert reply is not None and reply.action.shape == (n,)
        assert reply.lstm_state[0].shape == (n, arch.lstm_width)
        assert waited >= 0.3
        snap = svc.snapshot()
        assert snap["flush_timeout"] == 1 and snap["flushes"] == 1
        # a paused client leaves the ready rule: the next request of the
        # other flushes as "ready", without the deadline
        clients[1].pause()
        deadline = time.monotonic() + 10
        while svc._paused != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert clients[0].infer(req) is not None
        assert svc.snapshot()["flush_ready"] == 1
    finally:
        fe.begin_shutdown()
        svc.stop()
        stop.set()
        fe.close()
    assert not svc._thread.is_alive()
    svc.raise_errors()


# ---------------------------------------------------------------------------
# parity with the JAX service and runner


@pytest.mark.parametrize("kb", [1, 2])
def test_flush_matches_the_jax_service(kb):
    """The JAX service's jitted flush of ``kb`` requests and the port's
    forward of the same packed requests, from one parameter set."""
    j_env, env = j_envs.make_catch(), make_catch()
    j_arch = j_smoke("impala-shallow").replace(image_hw=j_env.image_hw)
    arch = small_arch(env)
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_arch, 3), jax.random.key(4)))
    j_svc = JaxService(j_env, j_arch, JaxImpalaConfig(num_actions=3),
                       JaxStore(tree), num_clients=kb, seed=0)
    reqs = tuple(_request(5, arch.lstm_width, env.image_hw, seed=10 + i)
                 for i in range(kb))
    action, logp, h, c = (np.array(x) for x in j_svc._build_flush(kb)(
        tree, np.int64(1), reqs))
    cat = {k: np.concatenate([r[k] for r in reqs]) for k in reqs[0]}
    j_logits = j_bb.apply_train(tree, {
        "image": cat["obs_image"][:, None],
        "last_action": cat["last_action"][:, None],
        "last_reward": cat["last_reward"][:, None],
        "done": cat["done"][:, None],
        "lstm_state": (cat["lstm_h"], cat["lstm_c"])},
        j_arch, 3).policy_logits[:, 0]

    svc = inf.InferenceService(env, arch, _icfg(), ParameterStore(
        P.from_jax(tree, requires_grad=False)), num_clients=kb, seed=0)
    buf = np.zeros((5 * kb, svc._layout.row), np.uint8)
    svc._layout.pack(list(reqs), buf)
    logits, th, tc = svc.forward(svc._store.pull()[0],
                                 svc._layout.unpack(torch.from_numpy(buf)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        actor_lib.action_logprob(logits, torch.from_numpy(action)).numpy(), logp,
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), c, rtol=1e-5, atol=1e-5)


def _steps(rng, t_len, n, hw, width):
    steps = []
    for _ in range(t_len):
        steps.append({
            "obs_image": rng.integers(0, 256, (n,) + hw).astype(np.uint8),
            "last_action": rng.integers(0, 3, n).astype(np.int32),
            "last_reward": rng.standard_normal(n).astype(np.float32),
            "done_in": rng.uniform(size=n) < 0.2,
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "done": rng.uniform(size=n) < 0.2,
            "behaviour_logprob": -rng.uniform(0, 2, n).astype(np.float32),
        })
    return steps


def test_assemble_inference_traj_matches_jax():
    rng = np.random.default_rng(3)
    n, hw, width = 4, (10, 5, 3), 6
    steps = _steps(rng, 7, n, hw, width)
    boot = {"obs_image": rng.integers(0, 256, (n,) + hw).astype(np.uint8),
            "last_action": rng.integers(0, 3, n).astype(np.int32),
            "last_reward": rng.standard_normal(n).astype(np.float32),
            "done": rng.uniform(size=n) < 0.5}
    init = tuple(rng.standard_normal((n, width)).astype(np.float32)
                 for _ in range(2))
    want = j_runner.assemble_inference_traj(
        steps, boot, init, JaxImpalaConfig(num_actions=3, discount=0.97))
    got = runner.assemble_inference_traj(
        steps, boot, init, ImpalaConfig(num_actions=3, discount=0.97))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(v)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_driver_trajectory_has_the_unroll_actors_layout():
    """One unroll of the inference driver emits, for each logical actor,
    a numpy trajectory with the unroll actor's keys, shapes and dtypes,
    stamped with its id and the version of its first step."""
    env = make_catch()
    arch = small_arch(env)
    icfg = _icfg(unroll_length=5)
    params = init_params(arch, env.num_actions, 0, "cpu")
    svc = inf.InferenceService(env, arch, icfg, ParameterStore(params),
                               num_clients=2, seed=0)
    items = []

    def emit(aid, item):
        items.append(item)
        return len(items) < 2

    runner.run_inference_driver_loop(
        actor_ids=[3, 4], env=env, arch_cfg=arch, icfg=icfg, num_envs=6,
        seed=0, service=svc, emit=emit, should_stop=lambda: False)
    init_fn, unroll = actor_lib.build_actor(env, arch, icfg, 6)
    _, ref = unroll(params, init_fn(0))
    assert [it.actor_id for it in items] == [3, 4]
    assert all(it.param_version == 0 for it in items)
    for it in items:
        assert sorted(it.data) == sorted(ref)
        for k, v in ref.items():
            for a, b in zip(jax.tree.leaves(it.data[k]),
                            [v] if torch.is_tensor(v) else list(v)):
                assert isinstance(a, np.ndarray), k
                assert a.shape == tuple(b.shape), k
                assert a.dtype == b.numpy().dtype, k
    # the two actors draw from their own generators
    assert not np.array_equal(items[0].data["obs_image"],
                              items[1].data["obs_image"])
    assert svc.snapshot()["flushes"] == 5


# ---------------------------------------------------------------------------
# end to end through the runtime


@pytest.mark.timeout_s(300)
def test_thread_inference_actors_train():
    tracker, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=8, num_actors=2,
        actor_mode="inference", queue_capacity=4, queue_policy="block",
        max_batch_trajs=2, seed=3, device="cpu")
    assert tel["learner_updates"] == 8
    assert np.isfinite(float(metrics["loss/total"]))
    assert tel["actor_mode"] == "inference"
    inf_tel = tel["inference"]
    assert inf_tel["flushes"] > 0
    assert sum(inf_tel["batch_size_hist"].values()) == inf_tel["flushes"]
    assert inf_tel["requests"] >= 8 * _icfg().unroll_length
    assert inf_tel["queue_wait_ms_p95"] >= inf_tel["queue_wait_ms_p50"] >= 0
    assert tel["lag"]["measured"] >= 8
    assert not [t.name for t in threading.enumerate()
                if t.name == "inference-driver"]


@pytest.mark.timeout_s(300)
def test_inference_mode_requires_cnn_family():
    arch = get_smoke_config("mistral-nemo-12b")
    with pytest.raises(ValueError, match="unroll"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           actor_mode="inference", arch=arch, device="cpu")
    with pytest.raises(ValueError, match="actor_mode"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           actor_mode="batched", device="cpu")


def test_process_inference_actors_are_not_ported():
    """Process inference actors run (ROADMAP.md Queue 1 item 10, done;
    tests/test_torch_procpool.py trains them); what is still refused is
    refused before any child is spawned: a token arch, or a transport
    without a wire."""
    with pytest.raises(ValueError, match="unroll"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           actor_backend="process", transport="shm",
                           actor_mode="inference", device="cpu",
                           arch=get_smoke_config("mistral-nemo-12b"))
    with pytest.raises(ValueError, match="shm"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           actor_backend="process", transport="inproc",
                           actor_mode="inference", device="cpu")
