"""The pieces of the port's async runtime against the JAX package's: the
trajectory queue under each backpressure policy, the batch buckets and
collection, the trajectory stack and one ``Learner`` update from the same
parameters; then the JAX tests' own claims about the parameter store, the
host stager, the lag summary and a published snapshot, on the port
alone.

Inputs are made with numpy from a seed. JAX runs on the CPU with its CPU
default V-trace (``scan``); the port runs on the CPU, where the loss
takes the reverse loop too.
"""
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.distributed import learner as j_learner
from repro.distributed import tqueue as j_tqueue
from repro.distributed.serde import TrajectoryItem as JaxItem
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import learner as t_learner
from repro_torch.distributed import runtime as t_runtime
from repro_torch.distributed import tqueue as t_tqueue
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.serde import TrajectoryItem

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the queue


def _script(seed, n=60):
    """A scripted sequence of queue operations from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [("put", "get_nowait", "get", "requeue")[i]
            for i in rng.choice(4, n, p=[0.5, 0.2, 0.15, 0.15])]


class _Driver:
    """Runs scripted operations on one queue and records every observable
    result."""

    def __init__(self, q):
        self.q, self.out, self.popped, self.next = q, [], [], 0
        self.evicted = []
        q.on_drop = self.evicted.append

    def step(self, op):
        q = self.q
        if op == "put":
            self.out.append(("put", self.next, q.put(self.next,
                                                     timeout=0.002)))
            self.next += 1
        elif op in ("get_nowait", "get"):
            item = (q.get_nowait() if op == "get_nowait"
                    else q.get(timeout=0.002))
            self.out.append((op, item))
            if item is not None:
                self.popped.append(item)
        elif self.popped:
            q.requeue_front(self.popped.pop())
            self.out.append(("requeue", len(q)))

    def finish(self):
        q = self.q
        q.close()
        self.out.append(("put after close", q.put(-1, timeout=0.002)))
        drained = []
        while True:
            item = q.get(timeout=0.002)
            if item is None:
                break
            drained.append(item)
        self.out += [("drained", drained), ("evicted", self.evicted)]
        return self.out, q.snapshot()


@pytest.mark.parametrize("policy", ["block", "drop_oldest", "drop_newest"])
@pytest.mark.parametrize("seed", [0, 1])
def test_queue_matches_jax_under_a_script(policy, seed):
    """Both queues take each scripted operation in turn, a millisecond
    apart, so they sit at each depth for nearly the same time."""
    drivers = [_Driver(mod.TrajectoryQueue(capacity=3, policy=policy))
               for mod in (j_tqueue, t_tqueue)]
    for op in _script(seed):
        for d in drivers:
            d.step(op)
        time.sleep(0.001)
    (j_out, j_snap), (t_out, t_snap) = (d.finish() for d in drivers)
    assert t_out == j_out
    assert set(t_snap) == set(j_snap)
    occ_j, occ_t = j_snap.pop("mean_occupancy"), t_snap.pop("mean_occupancy")
    assert t_snap == j_snap
    assert abs(occ_t - occ_j) <= 0.1, (occ_t, occ_j)
    if policy != "block":
        assert j_snap["dropped"] > 0
    else:
        assert j_snap["put_stalls"] > 0


def test_queue_snapshot_occupancy_counts_time_at_current_depth():
    """tests/test_distributed_runtime.py's occupancy claim, on the port's
    queue: the mean folds in the time spent at the current depth."""
    q = t_tqueue.TrajectoryQueue(capacity=8, policy="block")
    assert q.put(1) and q.put(2)
    time.sleep(0.15)
    occ = q.snapshot()["mean_occupancy"]
    assert 1.7 <= occ <= 2.0, occ
    q.get_nowait()
    time.sleep(0.15)
    occ2 = q.snapshot()["mean_occupancy"]
    assert 1.0 <= occ2 < occ, (occ, occ2)


# ---------------------------------------------------------------------------
# buckets and batch collection


def test_buckets_match_jax():
    for n in range(1, 10):
        assert t_learner._buckets(n) == j_learner._buckets(n), n
    assert t_learner._buckets(6) == [4, 2, 1]


@pytest.mark.parametrize("queued", [1, 2, 3, 5, 7, 9])
@pytest.mark.parametrize("max_batch", [4, 8])
def test_collect_batch_matches_jax(queued, max_batch):
    """The same queue contents, linger 0: the same items in the same
    order, and the same overflow requeued ahead of what comes next."""
    got = []
    for tq, item_cls, learner in ((j_tqueue, JaxItem, j_learner),
                                  (t_tqueue, TrajectoryItem, t_learner)):
        q = tq.TrajectoryQueue(capacity=16, policy="block")
        for i in range(queued):
            q.put(item_cls({"n": i}, i, i % 3, float(i)))
        first = q.get_nowait()
        batch = learner._collect_batch(q, learner._buckets(max_batch), first)
        q.put(item_cls({"n": 99}, 99, 0, 99.0))
        rest = []
        while len(q):
            rest.append(q.get_nowait().param_version)
        got.append(([(it.param_version, it.actor_id) for it in batch], rest,
                    q.snapshot()["popped"]))
    assert got[1] == got[0]


def _titem(i, b=2, t=3):
    rng = np.random.default_rng(i)
    data = {"x": torch.from_numpy(rng.standard_normal((b, t)).astype(
        np.float32)), "n": torch.full((b,), i, dtype=torch.int32)}
    return TrajectoryItem(data, param_version=i, actor_id=0,
                          produced_at=float(i))


def test_collect_batch_partial_bucket_keeps_oldest_first():
    """tests/test_learner_hotpath.py's claim on the port: 5 queued with
    max bucket 4, the 4 oldest form the batch and the 5th goes back to
    the front."""
    q = t_tqueue.TrajectoryQueue(capacity=8, policy="block")
    for i in range(5):
        q.put(_titem(i))
    first = q.get_nowait()
    batch = t_learner._collect_batch(q, t_learner._buckets(4), first)
    assert [it.param_version for it in batch] == [0, 1, 2, 3]
    assert len(q) == 1
    assert q.get_nowait().param_version == 4


def test_collect_batch_trims_to_pow2_and_requeues_overflow_in_order():
    q = t_tqueue.TrajectoryQueue(capacity=8, policy="block")
    for i in range(3):
        q.put(_titem(i))
    first = q.get_nowait()
    batch = t_learner._collect_batch(q, t_learner._buckets(4), first)
    assert [it.param_version for it in batch] == [0, 1]
    q.put(_titem(99))
    nxt = q.get_nowait()
    assert nxt.param_version == 2
    batch2 = t_learner._collect_batch(q, t_learner._buckets(4), nxt)
    assert [it.param_version for it in batch2] == [2, 99]


# ---------------------------------------------------------------------------
# stack + one learner update against the JAX learner

_HW = (10, 5, 3)
_B, _T, _A = 4, 5, 3
_ICFG = dict(num_actions=_A, unroll_length=_T, rmsprop_eps=0.01,
             entropy_cost=0.003, learning_rate=6e-4)


def _traj(seed, width):
    """One (B, T) trajectory in the actor's layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    img = ((rng.uniform(size=(_B, _T + 1) + _HW) < 0.1) * 255).astype(
        np.uint8)
    actions = rng.integers(0, _A, (_B, _T)).astype(np.int32)
    done = rng.uniform(size=(_B, _T)) < 0.15
    return {
        "obs_image": img,
        "last_action": np.concatenate(
            [np.zeros((_B, 1), np.int32), actions], 1),
        "last_reward": rng.choice([-1.0, 0.0, 1.0], (_B, _T + 1)).astype(
            np.float32),
        "done_in": np.concatenate([np.zeros((_B, 1), bool), done], 1),
        "actions": actions,
        "rewards": rng.choice([-1.0, 0.0, 1.0], (_B, _T)).astype(np.float32),
        "discounts": (0.99 * (1.0 - done)).astype(np.float32),
        "behaviour_logprob": np.log(rng.uniform(0.2, 0.6, (_B, _T))).astype(
            np.float32),
        "done": done,
        "lstm_state": tuple(rng.standard_normal((_B, width)).astype(
            np.float32) * 0.3 for _ in range(2)),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_stack_and_one_update_match_jax(k):
    """k trajectories stacked by both packages' ``_stack`` are equal bit
    for bit; one ``Learner`` update from the same parameters then gives
    the same params and metrics, and publishes version 1."""
    j_arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
    trajs = [_traj(10 + i, j_arch.lstm_width) for i in range(k)]
    j_items = [JaxItem(d, 0, 0, 0.0) for d in trajs]
    t_items = [TrajectoryItem(_to_torch(d), 0, 0, 0.0) for d in trajs]
    j_batch = j_learner._stack(j_items)
    t_batch = t_learner._stack(t_items)
    j_leaves, t_leaves = (jax.tree.leaves(j_batch),
                          t_learner._flatten(t_batch)[0])
    assert len(j_leaves) == len(t_leaves) == 11
    for a, b in zip(j_leaves, t_leaves):
        assert tuple(b.shape) == (_B * k,) + a.shape[1:]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_arch, _A), jax.random.key(0)))
    j_l = j_learner.Learner(
        arch=j_arch, icfg=JaxImpalaConfig(**_ICFG), num_actions=_A,
        num_envs=_B, num_actors=1, transport=None, initial_params=tree,
        donate=False)
    t_l = t_learner.Learner(
        arch=t_arch, icfg=ImpalaConfig(**_ICFG), num_actions=_A,
        num_envs=_B, num_actors=1, transport=None,
        initial_params=P.from_jax(tree), device="cpu")
    assert t_l.store.version == j_l.store.version == 0
    j_pub, j_metrics = j_l._update_once(j_batch, jax.numpy, jax)
    t_pub, t_metrics = t_l._update_once(t_batch)
    assert t_l.store.version == j_l.store.version == 1
    for name, v in jax.device_get(j_metrics).items():
        np.testing.assert_allclose(float(t_metrics[name]), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    want = P.flatten(jax.device_get(j_pub))
    got = P.flatten(P.to_jax(t_pub))
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("donate", [True, False])
def test_published_snapshot_survives_the_next_in_place_update(donate):
    """The published tree is never written by a later update: the
    learner updates in place and publishes a copy. ``donate`` is only
    reported: both values give the same params, bit for bit."""
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
    tree = P.to_jax(P.from_jax(_init_params(t_arch)))   # numpy leaves
    learners = [t_learner.Learner(
        arch=t_arch, icfg=ImpalaConfig(**_ICFG), num_actions=_A,
        num_envs=_B, num_actors=1, transport=None,
        initial_params=P.from_jax(tree), donate=d, device="cpu")
        for d in (donate, not donate)]
    batch = _to_torch(_traj(3, t_arch.lstm_width))
    learner = learners[0]
    pub1, _ = learner._update_once(batch)
    kept = P.snapshot(pub1)
    pub2, _ = learner._update_once(batch)
    assert learner.store.version == 2
    assert learner.store.pull()[0] is pub2
    for a, b in zip(P.tree_leaves(pub1), P.tree_leaves(kept)):
        assert torch.equal(a.detach(), b)
    moved = [not torch.equal(a.detach(), b.detach())
             for a, b in zip(P.tree_leaves(pub1), P.tree_leaves(pub2))]
    assert any(moved)
    host = P.flatten(learner.published_host())
    for name, v in P.flatten(P.to_jax(pub2)).items():
        np.testing.assert_array_equal(host[name], v)
    other = learners[1]
    other._update_once(batch)
    other_pub, _ = other._update_once(batch)
    for a, b in zip(P.tree_leaves(pub2), P.tree_leaves(other_pub)):
        assert torch.equal(a.detach(), b.detach())
    assert learner.telemetry_snapshot()["donate"] is donate
    assert other.telemetry_snapshot()["donate"] is not donate


def _init_params(arch):
    from repro_torch.models import backbone as bb
    from repro_torch.models import common
    return common.init_params(bb.backbone_specs(arch, _A), 0)


# ---------------------------------------------------------------------------
# the parameter store


def test_paramstore_publish_pull_roundtrip():
    store = ParameterStore({"w": 0})
    params, v = store.pull()
    assert v == 0 and params == {"w": 0}
    assert store.publish({"w": 1}) == 1
    params, v = store.pull()
    assert v == 1 and params == {"w": 1}
    ready = object()
    assert store.publish({"w": 2}, ready) == 2
    assert store.pull_ready() == ({"w": 2}, 2, ready)
    with pytest.raises(ValueError, match="monotonic"):
        store.publish_at({"w": 3}, 2)
    assert store.publish_at({"w": 3}, 5) == 5


def test_paramstore_version_monotonic_under_concurrency():
    """4 publishers x 50 publishes each; 4 pullers observe versions that
    never go backwards and always match the params they came with."""
    store = ParameterStore(0)
    lock = threading.Lock()
    stop = threading.Event()
    violations = []

    def publisher():
        for _ in range(50):
            with lock:      # params = the version they are published at
                v = store.publish(store.version + 1)
            if v < 1:
                violations.append(("bad version", v))

    def puller():
        last = -1
        while not stop.is_set():
            params, v, _ = store.pull_ready()
            if v < last or params != v:
                violations.append(("torn or backwards", last, v, params))
            last = v

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pullers = [threading.Thread(target=puller) for _ in range(4)]
        pubs = [threading.Thread(target=publisher) for _ in range(4)]
        for t in pullers + pubs:
            t.start()
        for t in pubs:
            t.join(timeout=30)
        stop.set()
        for t in pullers:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pullers + pubs)
    assert not violations, violations[:5]
    assert store.version == 200 and store.publishes == 200


# ---------------------------------------------------------------------------
# the host stager


def _np_items(n, b=3, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        data = {
            "obs": rng.integers(0, 255, (b, 4, 5, 3)).astype(np.uint8),
            "r": rng.standard_normal((b, 4)).astype(np.float32),
            "d": rng.uniform(size=(b, 4)) < 0.5,
            "state": tuple(rng.standard_normal((b, 3)).astype(np.float32)
                           for _ in range(2)),
        }
        items.append(TrajectoryItem(data, i, 0, time.monotonic()))
    return items


def _cat_reference(items):
    flat = [t_learner._flatten(it.data) for it in items]
    return [torch.cat([torch.from_numpy(x) for x in xs])
            for xs in zip(*(f[0] for f in flat))]


def _assert_stacked(out, items):
    leaves = t_learner._flatten(out)[0]
    assert t_learner._flatten(out)[1] == t_learner._flatten(items[0].data)[1]
    for got, want in zip(leaves, _cat_reference(items)):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_staged_stack_matches_cat():
    stager = t_learner._HostStager("cpu")
    items = _np_items(4)
    _assert_stacked(t_learner._stack(items, stager), items)
    assert not stager._slots    # a CPU target never reuses its buffers


def test_staged_stack_sequence_does_not_corrupt_earlier_batches():
    stager = t_learner._HostStager("cpu")
    first = _np_items(2, seed=1)
    a = t_learner._stack(first, stager)
    t_learner._stack(_np_items(2, seed=2), stager)
    t_learner._stack(_np_items(2, seed=3), stager)
    _assert_stacked(a, first)


def test_staged_stack_falls_back_on_ragged_batches():
    stager = t_learner._HostStager("cpu")
    i1 = TrajectoryItem({"x": np.ones((2, 3), np.float32)}, 0, 0, 0.0)
    i2 = TrajectoryItem({"x": np.zeros((4, 3), np.float32)}, 1, 0, 0.0)
    out = t_learner._stack([i1, i2], stager)
    assert out["x"].shape == (6, 3)
    assert torch.equal(out["x"][:2], torch.ones(2, 3))
    assert not stager._slots


def test_stack_single_item_passthrough_and_device_leaves():
    stager = t_learner._HostStager("cpu")
    d1 = TrajectoryItem({"x": torch.ones(2, 3)}, 0, 0, 0.0)
    assert t_learner._stack([d1], stager) is d1.data
    d2 = TrajectoryItem({"x": torch.zeros(2, 3)}, 1, 0, 0.0)
    out = t_learner._stack([d1, d2], stager)
    assert out["x"].shape == (4, 3)
    assert not stager._slots
    # one host item still lands as tensors
    h1 = TrajectoryItem({"x": np.ones((2, 3), np.float32)}, 0, 0, 0.0)
    assert torch.equal(t_learner._stack([h1], stager)["x"], torch.ones(2, 3))


# ---------------------------------------------------------------------------
# telemetry


def test_learner_lag_summary_math():
    """tests/test_distributed_runtime.py's lag-summary arithmetic, on the
    port's learner."""
    icfg = ImpalaConfig(num_actions=3, unroll_length=8, learning_rate=1e-3,
                        entropy_cost=0.003, rmsprop_eps=0.01)
    learner = t_runtime._setup("bandit", icfg, 4, num_actors=1,
                               device="cpu")
    try:
        learner.lag_hist.update({0: 3, 2: 1, 5: 2})
        lag = learner.telemetry_snapshot()["lag"]
        assert lag["measured"] == 6
        assert lag["mean"] == pytest.approx(2.0)
        assert lag["max"] == 5
        assert lag["hist"] == {0: 3, 2: 1, 5: 2}
    finally:
        learner.queue.close()


def test_warm_buckets_leave_params_opt_state_and_queue_as_they_were():
    """``_warm`` runs one update per bucket on copies: the working params
    and optimizer state, the published version and the queued item are
    what they were."""
    from repro_torch.core import actor as actor_lib

    icfg = ImpalaConfig(num_actions=4, unroll_length=5, learning_rate=1e-3,
                        rmsprop_eps=0.01)
    learner = t_runtime._setup("bandit", icfg, 4, num_actors=1,
                               max_batch_trajs=4, device="cpu")
    try:
        init_fn, unroll = actor_lib.build_actor(
            learner.pool.env, learner.arch, icfg, 4)
        _, traj = unroll(learner.store.pull()[0], init_fn(0))
        item = TrajectoryItem(traj, 0, 0, 0.0)
        learner.queue.put(item)
        params, opt_state = (P.snapshot(learner._params),
                             P.snapshot(learner._opt_state))
        learner._warm()
        for a, b in zip(P.tree_leaves(learner._params),
                        P.tree_leaves(params)):
            assert torch.equal(a.detach(), b)
        for a, b in zip(P.tree_leaves(learner._opt_state),
                        P.tree_leaves(opt_state)):
            assert torch.equal(a, b)
        assert learner.store.version == 0 and learner.updates == 0
        assert len(learner.queue) == 1 and learner.queue.get_nowait() is item
    finally:
        learner.queue.close()


def test_pool_join_raises_on_a_worker_that_outlives_it():
    """A worker still running after ``join``'s timeout is an error: left
    behind, it would go on issuing work after the run returned. Workers
    that stop are joined without one."""
    icfg = ImpalaConfig(num_actions=3, unroll_length=4, learning_rate=1e-3,
                        rmsprop_eps=0.01)
    learner = t_runtime._setup("bandit", icfg, 2, num_actors=1,
                               device="cpu")
    pool = learner.pool
    release = threading.Event()
    stuck = threading.Thread(target=release.wait, name="actor-stuck",
                             daemon=True)
    try:
        pool.start()
        pool.stop()
        pool.join()
        assert not any(t.is_alive() for t in pool._threads)
        pool._threads.append(stuck)
        stuck.start()
        with pytest.raises(RuntimeError, match="actor-stuck"):
            pool.join(timeout=0.2)
    finally:
        release.set()
        stuck.join(timeout=30)
        learner.queue.close()
