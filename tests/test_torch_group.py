"""Learner groups of the port against the JAX package, unit by unit: the
grad/apply split of the learner step, the gradient exchange's frames in
both pairings (a port spoke on a JAX hub and the reverse), the hub and
spoke on their own (means, versions, lossy codecs, the codec refusal, the
stale-drop rule, a dead hub), ``merge_telemetry``, ``shard_slots`` and the
replicas' digest.

Inputs are made with numpy from a seed. JAX runs its learner step with the
CPU's V-trace (``scan``), the port with its reverse loop (the CPU's plain
route); tolerances are 1e-5 for f32 gradients and parameters, and bit for
bit where the test says so. ``repro.distributed.group`` imports no jax at
module level, so its hub and spoke run here on numpy alone."""
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import learner as j_learner
from repro.distributed import group as j_group
from repro.distributed import serde as j_serde
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import learner as t_learner
from repro_torch.distributed import group as t_group
from repro_torch.distributed import serde as t_serde
from repro_torch.distributed.learner import MultiTracker
from repro_torch.distributed.paramstore import ParameterStore

torch.set_num_threads(1)

_HW = (10, 5, 3)
_B, _T, _A = 4, 5, 3
_ICFG = dict(num_actions=_A, unroll_length=_T, rmsprop_eps=0.01,
             entropy_cost=0.003, learning_rate=6e-4)


# ---------------------------------------------------------------------------
# the grad/apply split


def _batch(seed, width, replay_mask=None):
    rng = np.random.default_rng(seed)
    img = ((rng.uniform(size=(_B, _T + 1) + _HW) < 0.1) * 255).astype(
        np.uint8)
    actions = rng.integers(0, _A, (_B, _T)).astype(np.int32)
    done = rng.uniform(size=(_B, _T)) < 0.15
    batch = {
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
    if replay_mask is not None:
        batch["replay_mask"] = np.asarray(replay_mask, np.float32)
    return batch


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _setup(replay):
    j_arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
    specs = j_bb.backbone_specs(j_arch, _A)
    params = jax.device_get(j_common.init_params(specs, jax.random.key(0)))
    target = jax.device_get(j_common.init_params(specs, jax.random.key(1)))
    batch = _batch(2, j_arch.lstm_width, [1, 1, 0, 0] if replay else None)
    return j_arch, t_arch, params, target, batch


def _split_steps(replay):
    return ((j_learner.build_replay_grad_apply_steps,
             t_learner.build_replay_grad_apply_steps) if replay else
            (j_learner.build_grad_apply_steps,
             t_learner.build_grad_apply_steps))


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("replay", [False, True])
def test_grad_step_matches_jax(replay):
    """``grad_step`` on the same params and batch: the gradient leaves,
    mapped to the JAX layout, and the metrics at 1e-5."""
    j_arch, t_arch, params, target, batch = _setup(replay)
    j_build, t_build = _split_steps(replay)
    j_grad, _, _ = j_build(j_arch, JaxImpalaConfig(**_ICFG), _A,
                           vtrace_impl="scan")
    t_grad, _, _ = t_build(t_arch, ImpalaConfig(**_ICFG), _A)
    tp = P.from_jax(params)
    if replay:
        j_grads, j_metrics = j_grad(params, target, batch)
        leaves, t_metrics = t_grad(tp, P.from_jax(target, requires_grad=False),
                                   _to_torch(batch))
    else:
        j_grads, j_metrics = j_grad(params, batch)
        leaves, t_metrics = t_grad(tp, _to_torch(batch))
    assert isinstance(leaves, list) and len(leaves) == len(P.tree_leaves(tp))
    assert set(t_metrics) == set(j_metrics)
    got = P.flatten(P.to_jax(P.tree_unflatten_like(tp, leaves)))
    want = P.flatten(jax.device_get(j_grads))
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], np.asarray(v), f"d/d {k}")
    for k, v in j_metrics.items():
        _close(t_metrics[k].numpy(), np.asarray(v), k)


@pytest.mark.parametrize("replay", [False, True])
def test_apply_step_on_the_same_mean_matches_jax(replay):
    """``apply_step`` on one random mean gradient (the exchange's output),
    three times over: params and optimizer state at 1e-6, the clip's norm
    and the learning rate too."""
    j_arch, t_arch, params, _, _ = _setup(replay)
    j_build, t_build = _split_steps(replay)
    _, j_apply, j_opt = j_build(j_arch, JaxImpalaConfig(**_ICFG), _A)
    _, t_apply, t_opt = t_build(t_arch, ImpalaConfig(**_ICFG), _A)
    rng = np.random.default_rng(7)
    jp, js = params, j_opt.init(params)
    tp = P.from_jax(params)
    ts = t_opt.init(tp)
    for step in range(3):
        mean = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32),
            params)
        jp, js, jm = jax.jit(j_apply)(jp, js, jnp.int32(step), mean)
        leaves = P.tree_leaves(P.from_jax(mean, requires_grad=False))
        tp, ts, tm = t_apply(tp, ts, step, leaves)
        _close(float(tm["opt/grad_norm"]), float(jm["opt/grad_norm"]),
               "grad_norm", 1e-6)
        assert tm["opt/lr"] == pytest.approx(float(jm["opt/lr"]), rel=1e-7)
    for k, v in P.flatten(jax.device_get(jp)).items():
        _close(P.flatten(P.to_jax(tp))[k], np.asarray(v), k, 1e-6)
    for k, v in P.flatten(jax.device_get(js)).items():
        _close(P.flatten(P.to_jax(ts))[k], np.asarray(v), f"opt {k}", 1e-6)


@pytest.mark.parametrize("replay", [False, True])
def test_composed_halves_equal_the_fused_train_step(replay):
    """``apply_step(grad_step(...))`` is ``build_train_step``'s update bit
    for bit, params, optimizer state and metrics, over two updates."""
    _, t_arch, params, target, batch = _setup(replay)
    icfg = ImpalaConfig(**_ICFG)
    _, t_build = _split_steps(replay)
    grad, apply, o = t_build(t_arch, icfg, _A)
    fused_build = (t_learner.build_replay_train_step if replay
                   else t_learner.build_train_step)
    fused, _ = fused_build(t_arch, icfg, _A)
    tb = _to_torch(batch)
    tt = P.from_jax(target, requires_grad=False)
    pa, pb = P.from_jax(params), P.from_jax(params)
    sa, sb = o.init(pa), o.init(pb)
    for step in range(2):
        extra = (tt,) if replay else ()
        leaves, ma = grad(pa, *extra, tb)
        pa, sa, am = apply(pa, sa, step, leaves)
        ma.update(am)
        pb, sb, mb = fused(pb, *extra, sb, step, tb)
        assert set(ma) == set(mb)
        for k in ma:
            assert np.asarray(ma[k]).tobytes() == np.asarray(mb[k]).tobytes()
    for a, b in zip(P.tree_leaves(pa) + P.tree_leaves(sa),
                    P.tree_leaves(pb) + P.tree_leaves(sb)):
        assert a.detach().numpy().tobytes() == b.detach().numpy().tobytes()


# ---------------------------------------------------------------------------
# the exchange's frames across the packages

_GROUPS = {"jax": j_group, "torch": t_group}


def _leaves(scale, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(3) * scale).astype(np.float32),
            (rng.standard_normal((2, 5)) * 10 * scale).astype(np.float32)]


def _two_rounds(hub, spoke):
    """Two rounds of the exchange: the spoke in a thread, the hub here.
    Returns {round: (hub mean, hub version, spoke mean, spoke version)}."""
    got = {}

    def spoke_rounds():
        for rnd in range(2):
            got[rnd] = spoke.allreduce(_leaves(1.0 + rnd, seed=rnd),
                                       round_idx=rnd)

    t = threading.Thread(target=spoke_rounds, daemon=True)
    t.start()
    out = {}
    for rnd in range(2):
        mean, version = hub.allreduce(_leaves(3.0 + rnd, seed=10 + rnd),
                                      round_idx=rnd)
        out[rnd] = (mean, version)
    t.join(timeout=30)
    assert not t.is_alive()
    return {rnd: out[rnd] + got[rnd] for rnd in range(2)}


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("hub_pkg,spoke_pkg", [("jax", "torch"),
                                               ("torch", "jax")])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_exchange_interoperates_with_the_jax_package(hub_pkg, spoke_pkg,
                                                     codec):
    """A port spoke on a JAX hub, and a JAX spoke on a port hub, over
    loopback: both sides apply the same means bit for bit at the hub's
    versions, and those equal the same exchange run inside one package."""
    runs = {}
    for hp, sp in ((hub_pkg, spoke_pkg), (hub_pkg, hub_pkg)):
        hub = _GROUPS[hp].GradHub(2, stale_after_s=30.0, wire_codec=codec)
        try:
            spoke = _GROUPS[sp].SpokeExchange(hub.address, 1, 2,
                                              dial_timeout_s=20.0,
                                              wire_codec=codec)
            try:
                runs[(hp, sp)] = _two_rounds(hub, spoke)
                assert hub.snapshot()["stale_dropped"] == 0
            finally:
                spoke.close()
        finally:
            hub.close()
    mixed, alone = runs[(hub_pkg, spoke_pkg)], runs[(hub_pkg, hub_pkg)]
    for rnd in range(2):
        h_mean, h_ver, s_mean, s_ver = mixed[rnd]
        assert h_ver == s_ver == rnd + 1
        for h, s, a in zip(h_mean, s_mean, alone[rnd][0]):
            assert h.dtype == s.dtype == np.float32
            assert h.tobytes() == s.tobytes() == a.tobytes()
        if codec == "none":
            want = [(a + b) / np.float32(2) for a, b in zip(
                _leaves(3.0 + rnd, seed=10 + rnd), _leaves(1.0 + rnd,
                                                           seed=rnd))]
            for h, w in zip(h_mean, want):
                assert h.tobytes() == w.tobytes()


def test_grad_payload_bytes_equal_jax():
    for codec in ("none", "bf16", "int8"):
        kw = dict(round_idx=3, learner_id=1, version=4, codec=codec)
        assert t_serde.encode_grads(_leaves(2.0), **kw) == \
            j_serde.encode_grads(_leaves(2.0), **kw)


# ---------------------------------------------------------------------------
# the hub and the spoke (port counterparts of tests/test_group.py)


def test_null_exchange_identity_and_version():
    ex = t_group.NullExchange()
    leaves = [np.arange(4, dtype=np.float32)]
    out, version = ex.allreduce(leaves, round_idx=5)
    assert version == 6
    np.testing.assert_array_equal(out[0], leaves[0])
    assert ex.snapshot()["rounds"] == 1


@pytest.mark.timeout_s(120)
def test_hub_spoke_allreduce_means_and_versions():
    hub = t_group.GradHub(2, stale_after_s=30.0)
    try:
        spoke = t_group.SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0)
        try:
            results = {}

            def spoke_rounds():
                for rnd in range(3):
                    results[rnd] = spoke.allreduce(
                        [np.full((3,), 1.0 + rnd, np.float32)], round_idx=rnd)

            t = threading.Thread(target=spoke_rounds, daemon=True)
            t.start()
            for rnd in range(3):
                mean, version = hub.allreduce(
                    [np.full((3,), 3.0 + rnd, np.float32)], round_idx=rnd)
                assert version == rnd + 1
                np.testing.assert_array_equal(
                    mean[0], np.full((3,), 2.0 + rnd, np.float32))
            t.join(timeout=20)
            assert not t.is_alive()
            for rnd in range(3):
                s_mean, s_version = results[rnd]
                assert s_version == rnd + 1
                np.testing.assert_array_equal(
                    s_mean[0], np.full((3,), 2.0 + rnd, np.float32))
            snap = hub.snapshot()
            assert snap["stale_dropped"] == 0 and snap["rounds"] == 3
            assert snap["bytes_in"] > 0 and snap["bytes_out"] > 0
            assert spoke.snapshot()["rounds"] == 3
        finally:
            spoke.close()
    finally:
        hub.close()


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_quantized_exchange_replicas_apply_identical_means(codec):
    """Under a lossy codec the hub applies the round-tripped mean the
    spoke decodes: bit-identical on both sides, and a fixed point of the
    codec."""
    hub = t_group.GradHub(2, stale_after_s=30.0, wire_codec=codec)
    try:
        spoke = t_group.SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0,
                                      wire_codec=codec)
        try:
            got = _two_rounds(hub, spoke)
            for rnd in range(2):
                h_mean, h_ver, s_mean, s_ver = got[rnd]
                assert h_ver == s_ver == rnd + 1
                for h, s in zip(h_mean, s_mean):
                    assert h.tobytes() == s.tobytes()
                buf = t_serde.encode_grads(h_mean, round_idx=rnd,
                                           learner_id=0, codec=codec)
                rt, _ = t_serde.decode_grads(buf)
                if codec == "bf16":
                    for h, r in zip(h_mean, rt):
                        assert h.tobytes() == r.tobytes()
            assert hub.snapshot()["wire_codec"] == codec
        finally:
            spoke.close()
    finally:
        hub.close()


@pytest.mark.timeout_s(120)
def test_spoke_codec_mismatch_refused_distinctly():
    hub = t_group.GradHub(2, stale_after_s=30.0, wire_codec="int8")
    try:
        spoke = t_group.SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0,
                                      wire_codec="none")
        try:
            with pytest.raises(t_serde.CodecMismatchError,
                               match="wire_codec mismatch"):
                spoke.allreduce(_leaves(1.0), round_idx=0)
        finally:
            spoke.close()
    finally:
        hub.close()


@pytest.mark.timeout_s(120)
def test_hub_stale_drop_rule_keeps_laggard_on_trajectory():
    """A spoke that misses the deadline is left out of the round's mean
    (counted stale) but still receives the broadcast mean."""
    hub = t_group.GradHub(2, stale_after_s=0.5)
    four = [np.full((3,), 4.0, np.float32)]
    try:
        spoke = t_group.SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0)
        try:
            mean, version = hub.allreduce(four, round_idx=0)
            assert version == 1
            np.testing.assert_array_equal(mean[0], four[0])
            assert hub.snapshot()["partial_rounds"] == 1
            late = spoke.allreduce([np.full((3,), 100.0, np.float32)],
                                   round_idx=0)
            assert late is not None and late[1] == 1
            np.testing.assert_array_equal(late[0][0], four[0])
            deadline = time.monotonic() + 10
            while hub.snapshot()["stale_dropped"] == 0 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert hub.snapshot()["stale_dropped"] == 1
            got = {}
            t = threading.Thread(target=lambda: got.update(
                r1=spoke.allreduce([np.full((3,), 2.0, np.float32)],
                                   round_idx=1)), daemon=True)
            t.start()
            mean, version = hub.allreduce([np.full((3,), 6.0, np.float32)],
                                          round_idx=1)
            t.join(timeout=20)
            assert version == 2 and got["r1"][1] == 2
            np.testing.assert_array_equal(mean[0], four[0])
        finally:
            spoke.close()
    finally:
        hub.close()


@pytest.mark.timeout_s(120)
def test_spoke_raises_when_hub_dies():
    hub = t_group.GradHub(2, stale_after_s=30.0)
    spoke = t_group.SpokeExchange(hub.address, 1, 2, dial_timeout_s=20.0)
    try:
        hub.close()
        with pytest.raises(RuntimeError, match="hub"):
            for _ in range(2):
                out = spoke.allreduce(_leaves(1.0), round_idx=0)
                assert out is None
    finally:
        spoke.close()


def test_hub_start_round_refuses_rounds_before_a_resume():
    """A resumed group's hub (``start_round = version - 1``) reduces the
    next round and drops a contribution to an older one as stale."""
    hub = t_group.GradHub(1, start_round=9)
    try:
        mean, version = hub.allreduce(_leaves(1.0), round_idx=10)
        assert version == 11
        assert mean[0].tobytes() == _leaves(1.0)[0].tobytes()
        assert hub._done_round == 10
    finally:
        hub.close()


def test_paramstore_publish_at_is_monotonic_delegation():
    store = ParameterStore({"w": torch.zeros(2)}, version=3)
    assert store.publish_at({"w": torch.ones(2)}, 7) == 7
    params, version = store.pull()
    assert version == 7 and float(params["w"][0]) == 1.0
    with pytest.raises(ValueError, match="monotonic"):
        store.publish_at({"w": torch.zeros(2)}, 7)
    with pytest.raises(ValueError, match="monotonic"):
        store.publish_at({"w": torch.zeros(2)}, 5)
    assert store.publish({"w": torch.zeros(2)}) == 8


# ---------------------------------------------------------------------------
# merged telemetry, shard_slots, trackers, the digest


def _fake_snap(learner_id, updates, frames, trajs, lag_hist, replay=False):
    snap = {
        "learner_updates": updates,
        "frames_consumed": frames,
        "updates_per_sec": 2.0,
        "frames_per_sec": 100.0 * (learner_id + 1),
        "batch_size_hist": {1: updates},
        "lag": {"hist": lag_hist, "mean": 1.0, "max": max(lag_hist),
                "measured": sum(lag_hist.values())},
        "queue": {"transport": "inproc", "pushed": trajs, "capacity": 8},
        "actors": {"num_actors": 2, "slot_base": 2 * learner_id,
                   "backend": "thread", "frames": frames,
                   "trajectories": trajs, "rejected": learner_id,
                   "actor_fps": 50.0},
        "inference": {"mean_batch": 3.0 + learner_id},
        "param_version": updates,
        "actor_mode": "unroll",
        "donate": True,
        "learner_id": learner_id,
        "slot_base": 2 * learner_id,
        "exchange": {"stale_dropped": learner_id, "rounds": updates},
    }
    if replay:
        snap["replay"] = {
            "capacity": 64, "reuse_limit": 2, "priority_mode": "pertd",
            "fraction": 0.5, "fresh_max": 2, "target_period": 16,
            "occupancy": 3 + learner_id, "added": 10, "sampled": 7,
            "displaced": 0, "evicted_fifo": learner_id,
            "evicted_exhausted": 2, "starved": 0,
            "frames_trained": 2 * frames, "trained_frames_per_sec": 9.0,
            "target_syncs": 1, "priority_hist": {-1: 2, learner_id: 3},
            "staleness": {"hist": {1: 2, 2 + learner_id: 3}}}
    return snap


@pytest.mark.parametrize("n,replay", [(2, False), (3, True)])
def test_merge_telemetry_equals_jax(n, replay):
    specs = [(10, 1000, 12, {0: 5, 1: 5}), (10, 800, 9, {1: 4, 2: 6}),
             (10, 600, 7, {2: 1, 7: 3})]
    snaps = {k: _fake_snap(k, *specs[k], replay=replay) for k in range(n)}
    extra = {"transport": "inproc", "param_versions": [10] * n}
    got = t_group.merge_telemetry(snaps, publisher=0, group_extra=extra)
    want = j_group.merge_telemetry(snaps, publisher=0, group_extra=extra)
    assert got == want
    assert got["group"]["num_learners"] == n
    assert got["group"]["stale_dropped"] == sum(range(n))
    if replay:
        assert got["replay"]["reuse_ratio"] == want["replay"]["reuse_ratio"]
    with pytest.raises(ValueError):
        t_group.merge_telemetry({})


def test_shard_slots_equals_jax_over_a_grid():
    for actors in range(1, 13):
        for learners in range(1, 6):
            try:
                want = j_group.shard_slots(actors, learners)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    t_group.shard_slots(actors, learners)
                continue
            assert t_group.shard_slots(actors, learners) == want
    with pytest.raises(ValueError, match="num_learners"):
        t_group.shard_slots(4, 0)


def test_params_digest_equals_the_jax_crc32():
    """One parameter set, held by the port as tensors: its digest in the
    JAX layout is the JAX package's ``crc32(encode_tree(...))``."""
    arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    host = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(arch, _A), jax.random.key(3)))
    want = zlib.crc32(j_serde.encode_tree(jax.tree.map(np.asarray, host)))
    port = P.from_jax(host)
    assert t_group.params_digest(P.to_jax(port)) == want
    with torch.no_grad():
        P.tree_leaves(port)[0].view(-1)[0] += 1e-3
    assert t_group.params_digest(P.to_jax(port)) != want


def test_group_tracker_merges_chronologically():
    g = t_group.GroupTracker([(3.0, 30.0), (1.0, 10.0), (2.0, 20.0)])
    assert g.completed == [10.0, 20.0, 30.0]
    assert g.mean_return() == 20.0
    assert g.mean_return(last_n=1) == 30.0
    assert np.isnan(t_group.GroupTracker([]).mean_return())


def test_multitracker_timed_returns_and_slot_base():
    t = MultiTracker(num_actors=2, num_envs=1, slot_base=4)
    t.update(4, rewards=[[1.0]], dones=[[False]])
    t.update(4, rewards=[[2.0]], dones=[[True]])
    t.update(5, rewards=[[5.0]], dones=[[True]])
    assert t.completed == [3.0, 5.0]
    timed = t.completed_timed
    assert [r for _t, r in timed] == [3.0, 5.0]
    assert timed[1][0] >= timed[0][0]
    with pytest.raises(IndexError):
        t.update(9, rewards=[[1.0]], dones=[[True]])
