"""The port's replay path against the JAX package's: the serde bytes the
ring stores, the replay buffer's sample stream and snapshot under the
same seed, the JAX replay unit tests run on both packages, the replay
loss with its gradients and one replay update from the same parameters,
and whole async and sync runs with replay on the CPU.

Inputs are made with numpy from a seed. JAX runs on the CPU with its CPU
default V-trace (``scan``); the port runs on the CPU, where the replay
loss takes the reverse loop too (on the card, K1)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import learner as j_learner
from repro.core import losses as j_losses
from repro.core import replay as j_replay
from repro.distributed import run_async_training as j_run_async
from repro.distributed import serde as j_serde
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import learner as t_learner
from repro_torch.core import losses as t_losses
from repro_torch.core import replay as t_replay
from repro_torch.core.driver import run_training
from repro_torch.distributed import learner as t_dlearner
from repro_torch.distributed import run_async_training
from repro_torch.distributed import serde as t_serde
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)

PKGS = {"jax": (j_replay, j_serde), "torch": (t_replay, t_serde)}


# ---------------------------------------------------------------------------
# serde: the bytes the ring stores


def _serde_trees():
    rng = np.random.default_rng(0)
    return {
        "trajectory": {
            "obs_image": (rng.uniform(size=(4, 6, 5, 3)) < 0.1).astype(
                np.uint8),
            "actions": rng.integers(0, 3, (4, 5)).astype(np.int32),
            "rewards": rng.standard_normal((4, 5)).astype(np.float32),
            "done": rng.uniform(size=(4, 5)) < 0.2,
            "lstm_state": (rng.standard_normal((4, 8)).astype(np.float32),
                           rng.standard_normal((4, 8)).astype(np.float32)),
        },
        "nodes": {"z": None, "l": [np.float64(1.5), np.arange(3)],
                  "s": np.array(7, np.int16), "e": np.zeros((0, 2))},
    }


@pytest.mark.parametrize("name", ["trajectory", "nodes"])
def test_serde_bytes_equal_jax_and_decode_across(name):
    tree = _serde_trees()[name]
    j_buf = j_serde.encode_item(j_serde.TrajectoryItem(tree, 3, 1, 2.5))
    t_buf = t_serde.encode_item(t_serde.TrajectoryItem(tree, 3, 1, 2.5))
    assert t_buf == j_buf
    assert t_buf[:4] == t_serde.MAGIC == j_serde.MAGIC
    assert t_serde.encode_tree(tree, {"v": 1}) == \
        j_serde.encode_tree(tree, {"v": 1})
    for dec, buf in ((t_serde.decode_item, j_buf),
                     (j_serde.decode_item, t_buf)):
        item = dec(buf)
        assert (item.param_version, item.actor_id, item.produced_at) == \
            (3, 1, 2.5)
        got, want = jax.tree.leaves(item.data), jax.tree.leaves(tree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)
        assert jax.tree.structure(item.data) == jax.tree.structure(tree)


def test_serde_encodes_tensors_as_their_numpy_bytes():
    tree = _serde_trees()["trajectory"]
    as_tensors = _to_torch(tree)             # keeps the keys' order
    assert t_serde.encode_item(t_serde.TrajectoryItem(as_tensors, 0, 0, 0.)) \
        == j_serde.encode_item(j_serde.TrajectoryItem(tree, 0, 0, 0.))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_serde_lossy_codecs_name_their_roadmap_item(codec):
    """The lossy codecs (ROADMAP.md Queue 1 item 10, done) encode the
    replay ring's trees to JAX's bytes, and decode JAX's buffers."""
    tree = _serde_trees()["trajectory"]
    t_buf = t_serde.encode_item(t_serde.TrajectoryItem(tree, 0, 0, 0.),
                                codec)
    j_buf = j_serde.encode_item(j_serde.TrajectoryItem(tree, 0, 0, 0.),
                                codec)
    assert t_buf == j_buf
    got, want = t_serde.decode_item(j_buf), j_serde.decode_item(t_buf)
    for g, w in zip(jax.tree.leaves(got.data), jax.tree.leaves(want.data)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the replay buffer: the same sample stream as JAX's


@pytest.mark.parametrize("priority", ["pertd", "uniform"])
@pytest.mark.parametrize("reuse", [0, 2])
def test_buffer_stream_and_snapshot_match_jax(priority, reuse):
    """One script of add_item / add_batch / sample_items /
    update_priorities on both packages from the same seed: the same uids,
    the same sampling_probs and equal snapshot() dicts at every step."""
    rng = np.random.default_rng(1)
    bufs = [mod.ReplayBuffer(6, seed=11, learner_id=1, reuse_limit=reuse,
                             priority=priority)
            for mod, _ in PKGS.values()]
    version = 0
    for step in range(40):
        op = rng.choice(4, p=[0.35, 0.15, 0.3, 0.2])
        version += int(rng.integers(0, 2))
        outs = []
        for (mod, serde), buf in zip(PKGS.values(), bufs):
            if op == 0:
                item = serde.TrajectoryItem(_traj(step), version, 0, 0.0)
                outs.append(buf.add_item(item, priority=None
                                         if step % 3 else 0.5 + step,
                                         uses=step % 2))
            elif op == 1:
                outs.append(buf.add_batch(_traj(step), version))
            elif op == 2:
                s = buf.sample_items(2, version_now=version)
                outs.append(None if s is None else
                            [(x.uid, x.priority, x.version,
                              x.item.data["x"].tolist()) for x in s])
            else:
                uids = sorted(buf.sampling_probs())[:3]
                outs.append(buf.update_priorities(
                    uids, [0.1 * (step + i) for i in range(len(uids))]))
            outs.append(buf.sampling_probs())
            outs.append(buf.snapshot())
        assert outs[:3] == outs[3:], (step, op)


# ---------------------------------------------------------------------------
# tests/test_replay.py's unit tests, on both packages


def _traj(i, n_envs=2, t=3):
    """A tiny trajectory batch tree with an lstm-state tuple leaf."""
    return {
        "x": np.full((n_envs, t), float(i), np.float32),
        "lstm_state": (np.full((n_envs, 4), float(i), np.float32),
                       np.full((n_envs, 4), -float(i), np.float32)),
    }


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_buffer_requires_explicit_seed_or_rng(pkg):
    mod, _ = pkg
    with pytest.raises(ValueError, match="explicit rng or seed"):
        mod.ReplayBuffer(capacity=4)
    mod.ReplayBuffer(capacity=4, seed=0)
    mod.ReplayBuffer(capacity=4, rng=np.random.default_rng(7))


def test_fold_replay_seed_identity_and_distinct_streams(pkg):
    mod, _ = pkg
    assert mod.fold_replay_seed(123, 0) == 123
    assert len({mod.fold_replay_seed(123, k) for k in range(4)}) == 4
    assert [mod.fold_replay_seed(123, k) for k in range(4)] == \
        [j_replay.fold_replay_seed(123, k) for k in range(4)]

    def draws(lid):
        buf = mod.ReplayBuffer(capacity=16, seed=5, learner_id=lid)
        for i in range(8):
            buf.add_batch(_traj(i))
        return [s.uid for s in buf.sample_items(6)]

    assert draws(1) == draws(1)
    assert draws(1) != draws(2)


def test_invalid_priority_mode_rejected(pkg):
    mod, _ = pkg
    with pytest.raises(ValueError, match="priority"):
        mod.ReplayBuffer(capacity=4, seed=0, priority="rank")
    assert set(mod.PRIORITY_MODES) == {"uniform", "pertd"}


def test_fifo_eviction_and_wraparound_at_capacity(pkg):
    mod, _ = pkg
    buf = mod.ReplayBuffer(capacity=4, seed=0, priority="uniform")
    for i in range(6):
        buf.add_batch(_traj(i))
    assert len(buf) == 4
    assert buf.added == 12
    assert buf.evicted_fifo == 8
    vals = set()
    for _ in range(10):
        for s in buf.sample_items(4):
            vals.add(float(s.item.data["x"][0]))
    assert vals == {4.0, 5.0}


def test_lstm_state_tuple_roundtrips_through_add_batch_sample(pkg):
    mod, _ = pkg
    buf = mod.ReplayBuffer(capacity=8, seed=0)
    buf.add_batch(_traj(3), param_version=7)
    out = buf.sample(2)
    assert isinstance(out["lstm_state"], tuple)
    np.testing.assert_array_equal(out["x"], np.full((2, 3), 3.0))
    np.testing.assert_array_equal(out["lstm_state"][0],
                                  np.full((2, 4), 3.0))
    np.testing.assert_array_equal(out["lstm_state"][1],
                                  np.full((2, 4), -3.0))
    assert type(out["x"]) is np.ndarray


def test_sample_returns_none_under_occupancy(pkg):
    mod, _ = pkg
    buf = mod.ReplayBuffer(capacity=8, seed=0)
    buf.add_batch(_traj(0))
    assert buf.sample(4) is None
    assert buf.sample_items(3) is None
    assert buf.starved == 2
    assert buf.sample_items(0) == []
    assert len(buf.sample_items(2)) == 2


def test_staleness_recorded_at_sample_time(pkg):
    mod, _ = pkg
    buf = mod.ReplayBuffer(capacity=8, seed=0)
    buf.add_batch(_traj(0), param_version=10)
    buf.sample_items(2, version_now=14)
    assert buf.snapshot()["staleness"]["hist"] == {4: 2}
    assert buf.snapshot()["staleness"]["max"] == 4


def test_priority_update_math_and_stale_uid_skip(pkg):
    mod, serde = pkg
    buf = mod.ReplayBuffer(capacity=8, seed=0, priority_eps=0.0)
    uids = buf.add_batch(_traj(0))
    assert buf.sampling_probs()[uids[0]] == pytest.approx(0.5)
    assert buf.update_priorities(uids, [3.0, 1.0]) == 2
    probs = buf.sampling_probs()
    assert probs[uids[0]] == pytest.approx(0.75)
    assert probs[uids[1]] == pytest.approx(0.25)
    assert buf.update_priorities([999], [5.0]) == 0
    new = buf.add_item(serde.TrajectoryItem(_traj(1), 0, 0, 0.0))
    live = {s.uid: s for s in buf._live_slots()}
    assert live[new].priority == 3.0


def test_uniform_mode_ignores_priorities(pkg):
    mod, _ = pkg
    buf = mod.ReplayBuffer(capacity=8, seed=0, priority="uniform")
    uids = buf.add_batch(_traj(0))
    buf.update_priorities(uids, [100.0, 1e-9])
    assert buf.sampling_probs()[uids[0]] == pytest.approx(0.5)


def test_reuse_limit_retires_slots(pkg):
    mod, serde = pkg
    buf = mod.ReplayBuffer(capacity=8, seed=0, reuse_limit=2)
    buf.add_batch(_traj(0))
    assert len(buf.sample_items(2)) == 2
    assert len(buf) == 2
    assert len(buf.sample_items(2)) == 2
    assert len(buf) == 0
    assert buf.evicted_exhausted == 2
    buf.add_item(serde.TrajectoryItem(_traj(1), 0, 0, 0.0), uses=1)
    assert len(buf) == 1
    buf1 = mod.ReplayBuffer(capacity=8, seed=0, reuse_limit=1)
    buf1.add_item(serde.TrajectoryItem(_traj(1), 0, 0, 0.0), uses=1)
    assert len(buf1) == 0 and buf1.evicted_exhausted == 1


def test_plan_mix_top_up_math(pkg):
    plan_mix = pkg[0].plan_mix
    assert plan_mix(2, 4, 0.5, 100) == 2
    assert plan_mix(2, 4, 0.5, 1) == 0
    assert plan_mix(3, 4, 0.5, 1) == 1
    assert plan_mix(2, 4, 0.0, 100) == 0
    assert plan_mix(0, 4, 0.5, 100) == 0
    assert plan_mix(2, 4, 0.5, 0) == 0
    assert plan_mix(3, 4, 0.5, 100) == 1
    assert plan_mix(1, 8, 0.5, 100) == 1
    assert plan_mix(4, 8, 0.5, 100) == 4
    assert plan_mix(4, 4, 0.5, 100) == 0
    for args in [(1, 4, 0.5, 9), (2, 4, 0.5, 9), (1, 4, 0.5, 0)]:
        assert plan_mix(*args) == j_replay.plan_mix(*args)


def test_mix_batches_edges_and_displaced_counting(pkg):
    mod, _ = pkg
    online = {"x": np.zeros((8, 2), np.float32)}
    rep = {"x": np.ones((8, 2), np.float32)}
    assert mod.mix_batches(online, rep, 0.0) is online
    assert mod.mix_batches(online, None, 0.5) is online
    assert float(mod.mix_batches(online, rep, 1.0)["x"].sum()) == 16.0
    small = {"x": np.ones((2, 2), np.float32)}
    assert float(mod.mix_batches(online, small, 0.5)["x"].sum()) == 4.0
    assert type(mod.mix_batches(online, rep, 0.5)["x"]) is np.ndarray
    buf = mod.ReplayBuffer(capacity=8, seed=0)
    mod.mix_batches(online, rep, 0.5, buffer=buf)
    assert buf.displaced == 4
    assert buf.snapshot()["displaced"] == 4


def test_mix_batches_puts_replayed_rows_first_on_tensor_batches():
    """The sync loop's batch is tensors (on the card, there): the replayed
    numpy rows move to the online leaf's device and lead it."""
    online = {"x": torch.zeros((8, 2)), "s": (torch.zeros(8, 3),)}
    rep = {"x": np.ones((8, 2), np.float32),
           "s": (np.full((8, 3), 2.0, np.float32),)}
    buf = t_replay.ReplayBuffer(capacity=8, seed=0)
    out = t_replay.mix_batches(online, rep, 0.5, buffer=buf)
    assert isinstance(out["x"], torch.Tensor) and isinstance(out["s"], tuple)
    assert out["x"][:4].eq(1).all() and out["x"][4:].eq(0).all()
    assert out["s"][0][:4].eq(2).all() and out["s"][0][4:].eq(0).all()
    assert buf.displaced == 4


def test_add_batch_stores_tensor_trajectories_as_jax_does():
    """A batch of tensors (the port's actor output) is split and stored as
    the same bytes JAX stores for the numpy batch."""
    tree = _serde_trees()["trajectory"]
    tb = t_replay.ReplayBuffer(capacity=8, seed=0)
    jb = j_replay.ReplayBuffer(capacity=8, seed=0)
    tb.add_batch(_to_torch(tree), param_version=2)
    jb.add_batch(tree, param_version=2)
    assert [s.buf for s in tb._live_slots()] == \
        [s.buf for s in jb._live_slots()]


# ---------------------------------------------------------------------------
# the replay loss and one replay update against the JAX learner

_HW = (10, 5, 3)
_B, _T, _A = 4, 5, 3
_ICFG = dict(num_actions=_A, unroll_length=_T, rmsprop_eps=0.01,
             entropy_cost=0.003, learning_rate=6e-4)
_MASKS = {"zeros": [0, 0, 0, 0], "ones": [1, 1, 1, 1],
          "mixed": [1, 1, 0, 0]}


def _batch(seed, width):
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


def _setup(mask):
    j_arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
    specs = j_bb.backbone_specs(j_arch, _A)
    params = jax.device_get(j_common.init_params(specs, jax.random.key(0)))
    target = jax.device_get(j_common.init_params(specs, jax.random.key(1)))
    batch = _batch(2, j_arch.lstm_width)
    batch["replay_mask"] = np.asarray(_MASKS[mask], np.float32)
    return j_arch, t_arch, params, target, batch


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("mask", list(_MASKS))
def test_replay_loss_and_gradients_match_jax(mask):
    """Total, metrics (traj_adv_mag included) and the gradients through
    ``params`` at 1e-5, with a target network other than the params."""
    j_arch, t_arch, params, target, batch = _setup(mask)
    j_loss = j_learner.build_replay_loss_fn(j_arch, JaxImpalaConfig(**_ICFG),
                                            _A)
    (j_total, j_metrics), j_grads = jax.value_and_grad(
        j_loss, has_aux=True)(params, target, batch)
    t_loss = t_learner.build_replay_loss_fn(t_arch, ImpalaConfig(**_ICFG),
                                            _A)
    tp, tt = P.from_jax(params), P.from_jax(target)
    t_total, t_metrics = t_loss(tp, tt, _to_torch(batch))
    grads = torch.autograd.grad(t_total, P.tree_leaves(tp))
    assert set(t_metrics) == set(j_metrics)
    assert t_metrics["vtrace/traj_adv_mag"].shape == (_B,)
    _close(float(t_total.detach()), float(j_total), "total")
    for k, v in j_metrics.items():
        _close(t_metrics[k].detach().numpy(), np.asarray(v), k)
    got = P.flatten(P.to_jax(P.tree_unflatten_like(tp, list(grads))))
    for k, v in P.flatten(jax.device_get(j_grads)).items():
        _close(got[k], np.asarray(v), f"d/d {k}")
    # no gradient reaches the target network
    assert all(x.grad is None for x in P.tree_leaves(tt))


def test_replay_loss_with_mask_zero_is_the_standard_loss():
    """With an all-zero mask the replay loss is the standard loss (rel
    1e-6), against a target other than the params; an all-one mask with
    the params as target is too (rel 1e-5), as the JAX test holds."""
    _, t_arch, params, target, batch = _setup("zeros")
    icfg = ImpalaConfig(**_ICFG)
    tb = _to_torch(batch)
    tp = P.from_jax(params)
    with torch.no_grad():
        std, _ = t_learner.build_loss_fn(t_arch, icfg, _A)(tp, tb)
        rep = t_learner.build_replay_loss_fn(t_arch, icfg, _A)
        total0, _ = rep(tp, P.from_jax(target), tb)
        tb["replay_mask"] = torch.ones(_B)
        total1, _ = rep(tp, P.from_jax(target), tb)
        same, _ = rep(tp, P.from_jax(params), tb)
    assert float(total0) == pytest.approx(float(std), rel=1e-6)
    assert float(total1) != pytest.approx(float(std), rel=1e-6)
    assert float(same) == pytest.approx(float(std), rel=1e-5)


@pytest.mark.parametrize("mask", ["mixed"])
def test_one_replay_update_matches_jax(mask):
    """One ``build_replay_train_step`` update from the same params, target
    and batch: params at 1e-5, metrics at 1e-5."""
    j_arch, t_arch, params, target, batch = _setup(mask)
    j_step, j_opt = j_learner.build_replay_train_step(
        j_arch, JaxImpalaConfig(**_ICFG), _A)
    jp, js, jm = jax.jit(j_step)(params, target, j_opt.init(params),
                                 jnp.int32(0), batch)
    t_step, t_opt = t_learner.build_replay_train_step(
        t_arch, ImpalaConfig(**_ICFG), _A)
    tp = P.from_jax(params)
    tt = P.from_jax(target, requires_grad=False)
    before = P.snapshot(tt)
    tp, ts, tm = t_step(tp, tt, t_opt.init(tp), 0, _to_torch(batch))
    for k, v in jax.device_get(jm).items():
        _close(np.asarray(tm[k]), np.asarray(v), k)
    got = P.flatten(P.to_jax(tp))
    for k, v in P.flatten(jax.device_get(jp)).items():
        _close(got[k], np.asarray(v), k)
    for a, b in zip(P.tree_leaves(tt), P.tree_leaves(before)):
        assert torch.equal(a, b)                 # the target is only read


def test_impala_loss_replay_arguments_match_jax():
    """``corr_values``/``corr_bootstrap``/``per_traj`` of ``impala_loss``
    on its own, from (B,T) inputs: the same total and metrics at 1e-5.
    ``fused`` drops to the plain V-trace route on both sides."""
    rng = np.random.default_rng(3)
    b, t, a = 3, 7, 4
    logits = rng.standard_normal((b, t, a)).astype(np.float32)
    values = rng.standard_normal((b, t)).astype(np.float32)
    corr = rng.standard_normal((b, t)).astype(np.float32)
    boot = rng.standard_normal(b).astype(np.float32)
    batch = {
        "actions": rng.integers(0, a, (b, t)).astype(np.int32),
        "rewards": rng.standard_normal((b, t)).astype(np.float32),
        "discounts": np.full((b, t), 0.97, np.float32),
        "behaviour_logprob": np.log(rng.uniform(0.1, 0.5, (b, t))).astype(
            np.float32),
        "bootstrap_value": rng.standard_normal(b).astype(np.float32),
    }
    cfg = dict(num_actions=a, entropy_cost=0.01)
    jt, jm = j_losses.impala_loss(JaxImpalaConfig(**cfg), logits, values,
                                  batch, impl="fused", corr_values=corr,
                                  corr_bootstrap=boot, per_traj=True)
    tt, tm = t_losses.impala_loss(
        ImpalaConfig(**cfg), torch.from_numpy(logits),
        torch.from_numpy(values), _to_torch(batch), impl="fused",
        corr_values=torch.from_numpy(corr),
        corr_bootstrap=torch.from_numpy(boot), per_traj=True)
    assert set(tm) == set(jm)
    _close(float(tt), float(jt), "total")
    for k, v in jm.items():
        _close(tm[k].numpy(), np.asarray(v), k)


# ---------------------------------------------------------------------------
# the async learner's replay batch


def test_stack_lays_replayed_host_rows_before_fresh_tensor_rows():
    width = get_smoke_config("impala-shallow").lstm_width
    rep = [t_serde.decode_item(t_serde.encode_item(
        t_serde.TrajectoryItem(_batch(s, width), 0, 0, 0.0)))
        for s in (5, 6)]
    fresh = [t_serde.TrajectoryItem(_to_torch(_batch(s, width)), 0, 0, 0.0)
             for s in (7, 8)]
    got = t_dlearner._stack(rep + fresh, t_dlearner._HostStager("cpu"))
    want = t_dlearner._stack([t_serde.TrajectoryItem(_to_torch(it.data), 0,
                                                     0, 0.0)
                              for it in rep + fresh])
    g, _ = t_dlearner._flatten(got)
    w, _ = t_dlearner._flatten(want)
    assert len(g) == len(w) == 11
    for x, y in zip(g, w):
        assert isinstance(x, torch.Tensor) and torch.equal(x, y)
    with pytest.raises(ValueError, match="host items"):
        t_dlearner._stack(fresh[:1] + rep, t_dlearner._HostStager("cpu"))


def test_collect_batch_caps_fresh_items_as_jax():
    from repro.distributed import learner as j_dlearner
    from repro.distributed import tqueue as j_tqueue
    from repro_torch.distributed import tqueue as t_tqueue

    out = []
    for mod, tq in ((j_dlearner, j_tqueue), (t_dlearner, t_tqueue)):
        q = tq.TrajectoryQueue(8, "block")
        for i in range(1, 6):
            q.put(i)
        first = q.get_nowait()
        got = mod._collect_batch(q, mod._buckets(4), first, max_items=2)
        out.append((got, q.get_nowait()))
    assert out[0] == out[1] == ([1, 2], 3)


# ---------------------------------------------------------------------------
# end to end


def _async_icfg(**kw):
    return ImpalaConfig(**dict(dict(
        num_actions=2, unroll_length=8, learning_rate=1e-3,
        entropy_cost=0.003, rmsprop_eps=0.01), **kw))


def test_async_run_with_replay_populates_telemetry():
    """tests/test_replay.py's test, on the port; and the ``replay`` key
    set is the JAX runtime's."""
    kw = dict(replay_fraction=0.5, replay_reuse=2, replay_capacity=256)
    run_kw = dict(num_actors=2, actor_backend="thread", queue_capacity=4,
                  queue_policy="block", max_batch_trajs=4, seed=0)
    tracker, metrics, tel = run_async_training(
        "bandit", _async_icfg(**kw), 4, 24, **run_kw, device="cpu")
    assert np.isfinite(float(metrics["loss/total"]))
    assert "vtrace/traj_adv_mag" not in metrics
    rp = tel["replay"]
    assert rp["sampled"] > 0
    assert rp["frames_trained"] > tel["frames_consumed"]
    assert rp["reuse_ratio"] > 1.3
    assert rp["staleness"]["measured"] == rp["sampled"]
    assert rp["fresh_max"] == 2
    assert sum(rp["priority_hist"].values()) == rp["occupancy"]
    assert rp["reuse_limit"] == 2 and rp["priority_mode"] == "pertd"
    assert rp["target_syncs"] == 1 and rp["target_period"] == 16
    _, j_metrics, j_tel = j_run_async(
        "bandit", JaxImpalaConfig(**dict(_async_icfg(**kw).__dict__)), 4, 4,
        **run_kw)
    assert set(rp) == set(j_tel["replay"])
    assert set(rp["staleness"]) == set(j_tel["replay"]["staleness"])
    assert set(tel) == set(j_tel)
    assert set(metrics) == set(j_metrics)


def test_async_run_without_replay_keeps_pinned_keys():
    _, metrics, tel = run_async_training(
        "bandit", _async_icfg(), 4, 4, num_actors=1, actor_backend="thread",
        queue_capacity=4, queue_policy="block", max_batch_trajs=2, seed=0,
        device="cpu")
    assert "replay" not in tel


def test_sync_driver_with_replay_mixes_batches():
    tracker, metrics = run_training(
        "bandit", _async_icfg(replay_fraction=0.5), num_envs=4, steps=5,
        device="cpu")
    assert np.isfinite(float(metrics["loss/total"]))
    assert len(tracker.completed) > 0


def test_cli_replay_telemetry_line(capsys):
    run = train_lib.train(["--device", "cpu", "--smoke", "--runtime",
                           "async", "--env", "bandit", "--num-envs", "4",
                           "--unroll", "8", "--replay-fraction", "0.5",
                           "--replay-target-period", "4", "--steps", "12",
                           "--log-every", "6"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("telemetry: ")][-1]
    tel = json.loads(line[len("telemetry: "):])
    assert set(tel) == set(train_lib.TELEMETRY_KEYS) | {"replay"}
    assert tel["replay"]["target_syncs"] == 3
    assert tel["replay"]["target_period"] == 4
    assert run.icfg.replay_fraction == 0.5


class _Pool:
    """What ``Learner.run`` drives, with no actor: the queue is filled
    before the run."""
    frames = [1]

    def start(self):
        pass

    def stop(self):
        pass

    def join(self, timeout=None):
        pass

    def raise_errors(self):
        pass

    def stats(self):
        return {}


def test_replay_learner_loop_matches_jax_over_updates():
    """The same queued trajectories through both packages' ``Learner``
    with replay: the same batches (sizes, replayed uids), priorities,
    target syncs and replay snapshot, and params at 1e-4 after 8 updates
    (f32 sums in another order, compounded over updates)."""
    from repro.distributed import learner as j_dlearner
    from repro.distributed import tqueue as j_tqueue
    from repro.distributed.serde import TrajectoryItem as JaxItem
    from repro_torch.distributed import tqueue as t_tqueue

    j_arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
    # reuse 3: a stored trajectory is replayed up to twice, so the ring
    # holds more than a batch's worth and the draws choose
    kw = dict(_ICFG, replay_fraction=0.5, replay_reuse=3,
              replay_target_period=2, replay_capacity=8)
    params = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_arch, _A), jax.random.key(0)))
    trajs = [_batch(20 + i, j_arch.lstm_width) for i in range(16)]
    common = dict(num_actions=_A, num_envs=_B, num_actors=1,
                  transport=None, max_batch_trajs=4, seed=3)
    j_l = j_dlearner.Learner(arch=j_arch, icfg=JaxImpalaConfig(**kw),
                             initial_params=params, donate=False, **common)
    t_l = t_dlearner.Learner(arch=t_arch, icfg=ImpalaConfig(**kw),
                             initial_params=P.from_jax(params),
                             device="cpu", **common)
    for learner, tq, item in ((j_l, j_tqueue, JaxItem),
                              (t_l, t_tqueue, t_serde.TrajectoryItem)):
        learner.queue = tq.TrajectoryQueue(16, "block")
        for i, d in enumerate(trajs):
            learner.queue.put(item(d if learner is j_l else _to_torch(d),
                                   i // 2, 0, 0.0))
        learner.attach(_Pool())
    seen = {id(j_l): [], id(t_l): []}

    def hook(learner):
        def fn(step, published, metrics, snapshot_fn):
            rp = snapshot_fn()["replay"]
            seen[id(learner)].append((
                step, dict(snapshot_fn()["batch_size_hist"]),
                rp["sampled"], rp["target_syncs"], rp["occupancy"],
                {u: round(p, 4) for u, p in
                 learner._replay.sampling_probs().items()}))
        return fn

    j_l.run(8, on_update=hook(j_l))
    t_l.run(8, on_update=hook(t_l))
    assert seen[id(t_l)] == seen[id(j_l)]
    j_snap, t_snap = (j_l.telemetry_snapshot()["replay"],
                      t_l.telemetry_snapshot()["replay"])
    for key in ("trained_frames_per_sec", "priority_hist"):
        j_snap.pop(key), t_snap.pop(key)
    assert t_snap == j_snap
    got = P.flatten(P.to_jax(t_l._params))
    for k, v in P.flatten(jax.device_get(j_l._params)).items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
