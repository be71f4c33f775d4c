"""The port's optimizer, learner step, envs, actor and sync trainer
against the JAX package.

Random draws cannot match across the two packages (JAX threefry, torch
Philox), so parity tests inject them: the same gradients, the same fixed
batch and one parameter tree through ``repro_torch.params.from_jax``, the
same env state, action and fresh reset state. Whole runs are held to the
JAX package's learning bar instead (tests/test_system.py: bandit).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import actor as j_actor
from repro.core import learner as j_learner
from repro.data import envs as j_envs
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.optim import optimizer as j_opt

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor, learner
from repro_torch.core.queue import LagController
from repro_torch.data import envs
from repro_torch.launch import train as train_lib
from repro_torch.optim import optimizer as opt

torch.set_num_threads(1)


def _tree(seed, shapes=((3, 4), (5,))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# optimizer


@pytest.mark.parametrize("name,kw", [
    ("rmsprop", dict(decay=0.99, eps=0.01)),
    ("rmsprop", dict(decay=0.9, eps=0.1, momentum=0.5)),
    ("adam", dict()),
])
def test_optimizer_matches_jax_over_steps(name, kw):
    params = _tree(0)
    j_o = getattr(j_opt, name)(**kw)
    t_o = getattr(opt, name)(**kw)
    jp, tp = params, _torch_tree(params)
    js, ts = j_o.init(jp), t_o.init(tp)
    for k in range(5):
        g = _tree(100 + k)
        upd, js = j_o.update(g, js, jp, 6e-4)
        jp = j_opt.apply_updates(jp, upd)
        upd_t, ts = t_o.update(_torch_tree(g), ts, tp, 6e-4)
        tp = opt.apply_updates(tp, upd_t)
        for key in params:
            np.testing.assert_allclose(np.asarray(jp[key]),
                                       tp[key].numpy(), atol=1e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("max_norm", [0.5, 40.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(3)
    jc, jn = j_opt.clip_by_global_norm(g, max_norm)
    tc, tn = opt.clip_by_global_norm(_torch_tree(g), max_norm)
    np.testing.assert_allclose(np.asarray(jn), tn.item(), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(np.asarray(jc[k]), tc[k].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_linear_schedule_matches_jax():
    for steps in (0, 100):
        j_fn = j_opt.linear_schedule(6e-4, 0.0, steps)
        t_fn = opt.linear_schedule(6e-4, 0.0, steps)
        for step in (0, 1, 50, 99, 100, 250):
            assert float(j_fn(jnp.int32(step))) == t_fn(step)


# ---------------------------------------------------------------------------
# the learner step


def _fixed_batch(b, t, hw, num_actions, width, seed):
    rng = np.random.default_rng(seed)
    img = ((rng.uniform(size=(b, t + 1) + hw) < 0.1) * 255).astype(np.uint8)
    actions = rng.integers(0, num_actions, (b, t)).astype(np.int32)
    done = rng.uniform(size=(b, t)) < 0.15
    return {
        "obs_image": img,
        "last_action": np.concatenate(
            [np.zeros((b, 1), np.int32), actions], 1),
        "last_reward": rng.choice([-1.0, 0.0, 1.0], (b, t + 1)).astype(
            np.float32),
        "done_in": np.concatenate([np.zeros((b, 1), bool), done], 1),
        "actions": actions,
        "rewards": rng.choice([-1.0, 0.0, 1.0], (b, t)).astype(np.float32),
        "discounts": (0.99 * (1.0 - done)).astype(np.float32),
        "behaviour_logprob": np.log(rng.uniform(0.2, 0.6, (b, t))).astype(
            np.float32),
        "done": done,
        "lstm_state": tuple(rng.standard_normal((b, width)).astype(
            np.float32) * 0.3 for _ in range(2)),
    }


_HW = (10, 5, 3)
_STEP_KW = dict(num_actions=3, unroll_length=5, rmsprop_eps=0.01,
                entropy_cost=0.003)


@functools.lru_cache(maxsize=None)
def _jax_three_steps():
    """The JAX side, once for every impl case: initial params, the fixed
    batch, and (metrics, params) after each of 3 jitted steps."""
    j_arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_arch, 3), jax.random.key(0)))
    batch = _fixed_batch(4, 5, _HW, 3, j_arch.lstm_width, seed=1)
    j_step, j_o = j_learner.build_train_step(
        j_arch, JaxImpalaConfig(**_STEP_KW), 3)
    j_step = jax.jit(j_step)
    jp, js = tree, j_o.init(tree)
    jb = jax.tree.map(jnp.asarray, batch)
    metrics = []
    for step in range(3):
        jp, js, jm = j_step(jp, js, jnp.int32(step), jb)
        metrics.append(jax.device_get(jm))
    return tree, batch, metrics, jax.device_get(jp)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_train_step_three_steps_match_jax(impl):
    """Loss, metrics and params after each of 3 steps on one fixed batch,
    at rtol 1e-4 (f32 sums in another order through a conv-LSTM and its
    backward); JAX runs its CPU default (impl 'scan')."""
    tree, batch, j_metrics, j_params = _jax_three_steps()
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
    t_step, t_o = learner.build_train_step(
        t_arch, ImpalaConfig(**_STEP_KW), 3, vtrace_impl=impl)
    tp = P.from_jax(tree)
    ts = t_o.init(tp)
    tb = {k: (tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
              else torch.from_numpy(v)) for k, v in batch.items()}
    for step in range(3):
        tp, ts, tm = t_step(tp, ts, step, tb)
        for k, v in j_metrics[step].items():
            np.testing.assert_allclose(np.asarray(v), float(tm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    back = P.flatten(P.to_jax(tp))
    for k, v in P.flatten(j_params).items():
        np.testing.assert_allclose(np.asarray(v), back[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# envs


def _jax_batched_step(env, state, action, seed):
    keys = jax.random.split(jax.random.key(seed), action.shape[0])
    nxt, ts = jax.vmap(env.step)(state, jnp.asarray(action), keys)
    fresh = jax.vmap(env.reset)(keys)  # the reset step() drew inside
    return nxt, ts, fresh


def _assert_timestep(ts_j, ts_t):
    for name in ("obs_token", "obs_image", "reward", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(ts_j, name)),
                                      getattr(ts_t, name).numpy(),
                                      err_msg=name)


def test_catch_step_matches_jax_from_an_injected_state():
    j_env, t_env = j_envs.make_catch(), envs.make_catch()
    n = 12
    rng = np.random.default_rng(0)
    cols = np.int32
    raw = dict(ball_r=rng.integers(6, 9, n).astype(cols),
               ball_c=rng.integers(0, 5, n).astype(cols),
               paddle=rng.integers(0, 5, n).astype(cols),
               t=rng.integers(0, 9, n).astype(cols))
    action = rng.integers(0, 3, n).astype(np.int32)
    S = type(j_env.reset(jax.random.key(0)))
    state = S(**{k: jnp.asarray(v) for k, v in raw.items()})
    nxt_j, ts_j, fresh_j = _jax_batched_step(j_env, state, action, 1)
    fresh = envs.CatchState(*(torch.from_numpy(np.array(x))
                              for x in fresh_j))
    nxt_t, ts_t = t_env.step(
        envs.CatchState(**{k: torch.from_numpy(v) for k, v in raw.items()}),
        torch.from_numpy(action), fresh)
    assert ts_t.done.any() and not ts_t.done.all()
    for a, b in zip(nxt_j, nxt_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_timestep(ts_j, ts_t)
    obs_j = jax.vmap(j_env.observe)(state)
    obs_t = t_env.observe(envs.CatchState(
        **{k: torch.from_numpy(v) for k, v in raw.items()}))
    _assert_timestep(obs_j, obs_t)


def test_bandit_step_matches_jax_from_an_injected_state():
    j_env, t_env = j_envs.make_bandit(), envs.make_bandit()
    n = 16
    ctx = np.arange(n, dtype=np.int32)
    action = (np.arange(n) % 4).astype(np.int32)
    action[::3] = (action[::3] + 1) % 4
    S = type(j_env.reset(jax.random.key(0)))
    nxt_j, ts_j, fresh_j = _jax_batched_step(j_env, S(jnp.asarray(ctx)),
                                             action, 2)
    nxt_t, ts_t = t_env.step(
        envs.BanditState(torch.from_numpy(ctx)), torch.from_numpy(action),
        envs.BanditState(torch.from_numpy(np.array(fresh_j.ctx))))
    np.testing.assert_array_equal(np.asarray(nxt_j.ctx), nxt_t.ctx.numpy())
    _assert_timestep(ts_j, ts_t)


# ---------------------------------------------------------------------------
# actor, lag, trainer


def test_actor_unroll_has_the_jax_trajectory_structure():
    hw = (10, 5, 3)
    j_arch = j_smoke("impala-shallow").replace(image_hw=hw, lstm_width=16)
    t_arch = get_smoke_config("impala-shallow").replace(image_hw=hw,
                                                        lstm_width=16)
    kw = dict(num_actions=3, unroll_length=4)
    n = 5
    j_init, j_unroll = j_actor.build_actor(j_envs.make_catch(), j_arch,
                                           JaxImpalaConfig(**kw), n)
    jparams = j_common.init_params(j_bb.backbone_specs(j_arch, 3),
                                   jax.random.key(0))
    _, traj_j = j_unroll(jparams, j_init(jax.random.key(1)))
    t_init, t_unroll = actor.build_actor(envs.make_catch(), t_arch,
                                         ImpalaConfig(**kw), n)
    tparams = P.from_jax(jax.device_get(jparams))
    carry, traj_t = t_unroll(tparams, t_init(1))
    assert set(traj_j) == set(traj_t)
    for k in traj_j:
        js = jax.tree.leaves(traj_j[k])
        ts = list(traj_t[k]) if isinstance(traj_t[k], tuple) else \
            [traj_t[k]]
        assert len(js) == len(ts), k
        for a, b in zip(js, ts):
            assert tuple(a.shape) == tuple(b.shape), k
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), k
    # the behaviour log-prob is the policy's own at the taken action
    assert bool((traj_t["behaviour_logprob"] <= 0).all())
    np.testing.assert_allclose(
        traj_t["discounts"].numpy(),
        0.99 * (1.0 - traj_t["done"].numpy().astype(np.float32)))
    assert carry.obs_image.shape == (n,) + hw


def test_lag_controller_snapshot_survives_an_in_place_update():
    params = {"w": torch.ones(3, requires_grad=True)}
    lag = LagController(1, params)
    opt.apply_updates(params, {"w": torch.full((3,), 0.5)})
    lag.on_update(params)
    torch.testing.assert_close(lag.actor_params()["w"], torch.ones(3))
    opt.apply_updates(params, {"w": torch.full((3,), 0.5)})
    lag.on_update(params)
    torch.testing.assert_close(lag.actor_params()["w"], torch.full((3,), 1.5))
    assert torch.equal(params["w"].detach(), torch.full((3,), 2.0))
    assert not lag.actor_params()["w"].requires_grad


def test_cli_runs_the_sync_path_on_cpu(capsys):
    assert train_lib.main(["--device", "cpu", "--smoke", "--steps", "4",
                           "--num-envs", "4", "--unroll", "5",
                           "--log-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=impala-shallow params=" in out and "runtime=sync" in out
    assert out.count("return(100)=") == 2
    assert "final return(100) = " in out


def test_bandit_learns_to_the_jax_bar():
    """tests/test_system.py::test_full_pipeline_learns_bandit, in the
    port and through its CLI (the same smoke agent, config and seeds, as
    chip_smoke.py runs it on the card): mean_return(200) > 0.6 after 150
    steps."""
    run = train_lib.train([
        "--device", "cpu", "--env", "bandit", "--smoke", "--unroll", "16",
        "--lr", "1e-3", "--entropy-cost", "0.005", "--rmsprop-eps", "0.01",
        "--policy-lag", "1", "--num-envs", "32", "--steps", "150",
        "--log-every", "150"])
    assert run.arch.image_hw == (4, 4, 3) and run.arch.lstm_width == 64
    assert np.isfinite(float(run.metrics["loss/total"]))
    final = run.tracker.mean_return(200)
    assert final > 0.6, f"bandit should approach 1.0, got {final}"
