"""The port's rooms, tmaze and chase envs, ``make_suite`` and
``data.multitask`` against the JAX package's, and the env contract over
all five envs.

Random draws cannot match across the packages (JAX threefry, torch
Philox), so parity is checked from injected states and actions, with each
step's draws made by JAX from the per-env keys its ``step`` is given (the
fresh state of ``reset(key)``; chase's sideways move
``randint(key, (2,), -1, 2)`` and fresh state ``reset(fold_in(key, 1))``)
and handed to the port's ``step``. Every field must be equal: the envs
compute on integers, and their rewards are the same f32 constants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import envs as j_envs
from repro.data import multitask as j_multitask

from repro_torch.data import envs
from repro_torch.data import multitask

torch.set_num_threads(1)


def _assert_timestep(ts_j, ts_t):
    for name in ("obs_token", "obs_image", "reward", "done"):
        want = np.asarray(getattr(ts_j, name))
        got = getattr(ts_t, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_state(nxt_j, nxt_t):
    for name, a, b in zip(nxt_t._fields, nxt_j, nxt_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


def _torch_state(cls, raw):
    return cls(**{k: torch.from_numpy(np.array(v)) for k, v in raw.items()})


def _jax_state(j_env, raw):
    S = type(j_env.reset(jax.random.key(0)))
    return S(**{k: jnp.asarray(v) for k, v in raw.items()})


def _keys(seed, n):
    return jax.random.split(jax.random.key(seed), n)


def _jax_step(j_env, state, action, keys):
    return jax.vmap(j_env.step)(state, jnp.asarray(action), keys)


def _rooms_raw(rng, n, num_objects=4, size=7, horizon=80):
    pos = rng.integers(0, size, (n, 2)).astype(np.int32)
    objects = rng.integers(0, size, (n, num_objects, 2)).astype(np.int32)
    # put objects next to the agent (reachable this step) and on top of
    # each other (hit together), and leave some rows one collection or
    # one step from their end
    objects[::2, 0] = np.clip(pos[::2] + [1, 0], 0, size - 1)
    objects[::3, 1] = objects[::3, 0]
    alive = rng.uniform(size=(n, num_objects)) < 0.7
    alive[::3, 1] = alive[::3, 0]
    alive[1::4] = False
    alive[1::4, 0] = True
    objects[1::4, 0] = np.clip(pos[1::4] + [0, 1], 0, size - 1)
    t = rng.integers(0, horizon, n).astype(np.int32)
    t[::5] = horizon - 1
    return dict(pos=pos, objects=objects, alive=alive, t=t)


def test_rooms_step_matches_jax_from_injected_states():
    j_env, t_env = j_envs.make_rooms(), envs.make_rooms()
    n = 40
    rng = np.random.default_rng(0)
    raw = _rooms_raw(rng, n)
    action = rng.integers(0, 5, n).astype(np.int32)
    action[::2] = 1                     # down: onto objects[::2, 0]
    action[1::4] = 3                    # right: onto objects[1::4, 0]
    keys = _keys(1, n)
    nxt_j, ts_j = _jax_step(j_env, _jax_state(j_env, raw), action, keys)
    fresh = _torch_state(envs.RoomsState, jax.vmap(j_env.reset)(keys)
                         ._asdict())
    nxt_t, ts_t = t_env.step(_torch_state(envs.RoomsState, raw),
                             torch.from_numpy(action), fresh)
    assert ts_t.done.any() and not ts_t.done.all()
    assert (ts_t.reward > 0).any()
    assert (ts_t.reward > 1).any()      # co-located objects, hit together
    _assert_state(nxt_j, nxt_t)
    _assert_timestep(ts_j, ts_t)
    obs_j = jax.vmap(j_env.observe)(_jax_state(j_env, raw))
    _assert_timestep(obs_j, t_env.observe(_torch_state(envs.RoomsState,
                                                       raw)))


def test_tmaze_step_matches_jax_from_injected_states():
    j_env, t_env = j_envs.make_tmaze(), envs.make_tmaze()
    n = 36
    rng = np.random.default_rng(2)
    raw = dict(pos=rng.integers(0, 10, n).astype(np.int32),
               cue=rng.integers(0, 2, n).astype(np.int32),
               t=rng.integers(0, 30, n).astype(np.int32))
    raw["pos"][::3] = 9                 # at the junction: choose
    raw["pos"][1::6] = 0                # the cue pixel shows
    raw["t"][2::7] = 29                 # one step from the time limit
    action = rng.integers(0, 3, n).astype(np.int32)
    keys = _keys(3, n)
    nxt_j, ts_j = _jax_step(j_env, _jax_state(j_env, raw), action, keys)
    fresh = _torch_state(envs.TmazeState, jax.vmap(j_env.reset)(keys)
                         ._asdict())
    nxt_t, ts_t = t_env.step(_torch_state(envs.TmazeState, raw),
                             torch.from_numpy(action), fresh)
    assert (ts_t.reward == 1).any() and (ts_t.reward == -1).any()
    assert ts_t.done.any() and not ts_t.done.all()
    _assert_state(nxt_j, nxt_t)
    _assert_timestep(ts_j, ts_t)
    obs_t = t_env.observe(_torch_state(envs.TmazeState, raw))
    _assert_timestep(jax.vmap(j_env.observe)(_jax_state(j_env, raw)), obs_t)
    # the cue pixel is (cue + 1) * 100 where the agent stands at the start
    shown = raw["pos"] == 0
    np.testing.assert_array_equal(obs_t.obs_image[:, 0, 0, 2].numpy(),
                                  np.where(shown, (raw["cue"] + 1) * 100, 0))


def _chase_draws(j_env, keys):
    """The draws chase's JAX ``step`` makes from its keys."""
    sideways = jax.vmap(lambda k: jax.random.randint(k, (2,), -1, 2))(keys)
    fresh = jax.vmap(lambda k: j_env.reset(jax.random.fold_in(k, 1)))(keys)
    return envs.ChaseDraws(
        _torch_state(envs.ChaseState, fresh._asdict()),
        torch.from_numpy(np.array(sideways)))


def test_chase_step_matches_jax_from_injected_states():
    j_env, t_env = j_envs.make_chase(), envs.make_chase()
    n = 48
    rng = np.random.default_rng(4)
    agent = rng.integers(0, 9, (n, 2)).astype(np.int32)
    bot = rng.integers(0, 9, (n, 2)).astype(np.int32)
    bot[::3, 0] = agent[::3, 0]         # level on an axis: sideways draw
    bot[1::4] = np.clip(agent[1::4] + [1, 0], 0, 8)   # one step away
    raw = dict(agent=agent, bot=bot,
               t=rng.integers(0, 120, n).astype(np.int32),
               caught=rng.integers(0, 3, n).astype(np.int32))
    raw["t"][::5] = 119
    action = rng.integers(0, 5, n).astype(np.int32)
    action[1::4] = 1
    keys = _keys(5, n)
    nxt_j, ts_j = _jax_step(j_env, _jax_state(j_env, raw), action, keys)
    nxt_t, ts_t = t_env.step(_torch_state(envs.ChaseState, raw),
                             torch.from_numpy(action),
                             _chase_draws(j_env, keys))
    assert ts_t.done.any() and not ts_t.done.all()
    assert (ts_t.reward == 1).any()
    _assert_state(nxt_j, nxt_t)
    _assert_timestep(ts_j, ts_t)
    obs_j = jax.vmap(j_env.observe)(_jax_state(j_env, raw))
    _assert_timestep(obs_j, t_env.observe(_torch_state(envs.ChaseState,
                                                       raw)))


def test_chase_rollout_matches_jax_draw_for_draw():
    """Sixty steps of 16 chase envs from JAX's resets, their clocks set
    late in the episode: each step's keys are split as the JAX actor
    splits them, and the port is handed the draws those keys give;
    states, tokens, images, rewards and dones stay equal throughout,
    across episode ends."""
    j_env, t_env = j_envs.make_chase(), envs.make_chase()
    n = 16
    rng = np.random.default_rng(7)
    state_j = jax.vmap(j_env.reset)(_keys(6, n))._replace(
        t=jnp.asarray(rng.integers(60, 120, n).astype(np.int32)))
    state_t = _torch_state(envs.ChaseState, state_j._asdict())
    step = jax.jit(jax.vmap(j_env.step))
    dones = 0
    for i in range(60):
        action = rng.integers(0, 5, n).astype(np.int32)
        keys = _keys(100 + i, n)
        state_j, ts_j = step(state_j, jnp.asarray(action), keys)
        state_t, ts_t = t_env.step(state_t, torch.from_numpy(action),
                                   _chase_draws(j_env, keys))
        _assert_state(state_j, state_t)
        _assert_timestep(ts_j, ts_t)
        dones += int(ts_t.done.sum())
    assert dones > 0


def test_rooms_paints_co_located_objects_deterministically():
    """Co-located objects share a cell in the image: the cell is 255 iff
    an alive object lies on it, as the JAX env's scatter paints it (its
    co-located objects' alive flags always agree). The port paints with
    an ``any`` over objects, no scatter with duplicate indices."""
    j_env, t_env = j_envs.make_rooms(), envs.make_rooms()
    objects = np.array([[[2, 3], [2, 3], [2, 3], [5, 5]],
                        [[0, 0], [0, 0], [6, 6], [6, 6]],
                        [[1, 1], [1, 1], [1, 1], [1, 1]]], np.int32)
    alive = np.array([[True, True, True, False],
                      [False, False, True, True],
                      [False, False, False, False]])
    raw = dict(pos=np.array([[0, 0], [3, 3], [4, 4]], np.int32),
               objects=objects, alive=alive,
               t=np.zeros(3, np.int32))
    obs_t = t_env.observe(_torch_state(envs.RoomsState, raw))
    _assert_timestep(jax.vmap(j_env.observe)(_jax_state(j_env, raw)), obs_t)
    want = np.zeros((3, 7, 7), np.uint8)
    want[0, 2, 3] = want[1, 6, 6] = 255
    np.testing.assert_array_equal(obs_t.obs_image[..., 0].numpy(), want)


def test_vocab_sizes_and_shapes_match_jax():
    for name in envs.ENV_MAKERS:
        j_env, t_env = j_envs.make_env(name), envs.make_env(name)
        assert (t_env.num_actions, t_env.vocab_size, t_env.image_hw) == \
            (j_env.num_actions, j_env.vocab_size, j_env.image_hw), name
    suite = envs.make_suite()
    assert [e.name for e in suite] == [e.name for e in j_envs.make_suite()]


# ---------------------------------------------------------------------------
# the contract (tests/test_envs.py), over all five envs


@pytest.mark.parametrize("name", sorted(envs.ENV_MAKERS))
def test_env_basic_contract(name):
    env = envs.make_env(name)
    gen = torch.Generator().manual_seed(0)
    n = 8
    s = env.reset(n, gen, "cpu")
    ts = env.observe(s)
    assert ts.obs_token.dtype == torch.int32
    assert ts.obs_image.dtype == torch.uint8
    assert tuple(ts.obs_image.shape) == (n,) + env.image_hw
    assert ((0 <= ts.obs_token) & (ts.obs_token < env.vocab_size)).all()
    for _ in range(50):
        a = torch.randint(0, env.num_actions, (n,), generator=gen)
        s, ts = env.step(s, a, env.draw(n, gen, "cpu"))
        assert ((0 <= ts.obs_token) & (ts.obs_token < env.vocab_size)).all()
        assert tuple(ts.reward.shape) == (n,)
        assert ts.reward.dtype == torch.float32
        assert ts.done.dtype == torch.bool
        assert torch.isfinite(ts.reward).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(envs.ENV_MAKERS))
def test_env_episodes_terminate(name, seed):
    """Every one of 16 envs emits done within 200 random steps."""
    env = envs.make_env(name)
    gen = torch.Generator().manual_seed(seed)
    n = 16
    s = env.reset(n, gen, "cpu")
    seen = torch.zeros(n, dtype=torch.bool)
    for _ in range(200):
        a = torch.randint(0, env.num_actions, (n,), generator=gen)
        s, ts = env.step(s, a, env.draw(n, gen, "cpu"))
        seen |= ts.done
        if seen.all():
            break
    assert seen.all(), f"{name}: envs {(~seen).nonzero().tolist()} never " \
                       f"terminated in 200 steps"


# ---------------------------------------------------------------------------
# multitask


def test_common_frame_matches_jax():
    names = ("catch", "bandit", "tmaze")
    assert multitask.common_frame([envs.make_env(n) for n in names]) == \
        j_multitask.common_frame([j_envs.make_env(n) for n in names])


def test_padded_env_matches_jax():
    """tmaze padded to catch+bandit+tmaze's frame (10, 11, 3) with 4
    actions: out-of-range actions clamp to the last, images sit at the
    top left of the frame."""
    names = ("catch", "bandit", "tmaze")
    hw, na = j_multitask.common_frame([j_envs.make_env(x) for x in names])
    j_env = j_multitask.padded_env(j_envs.make_tmaze(), hw, na)
    t_env = multitask.padded_env(envs.make_tmaze(), hw, na)
    assert (t_env.num_actions, t_env.image_hw) == (na, hw) == \
        (j_env.num_actions, j_env.image_hw)
    n = 24
    rng = np.random.default_rng(8)
    raw = dict(pos=rng.integers(7, 10, n).astype(np.int32),
               cue=rng.integers(0, 2, n).astype(np.int32),
               t=rng.integers(0, 30, n).astype(np.int32))
    action = np.arange(n, dtype=np.int32) % na     # 3 clamps to 2
    keys = _keys(9, n)
    nxt_j, ts_j = _jax_step(j_env, _jax_state(j_env, raw), action, keys)
    fresh = _torch_state(envs.TmazeState,
                         jax.vmap(j_env.reset)(keys)._asdict())
    nxt_t, ts_t = t_env.step(_torch_state(envs.TmazeState, raw),
                             torch.from_numpy(action), fresh)
    assert tuple(ts_t.obs_image.shape) == (n,) + hw
    _assert_state(nxt_j, nxt_t)
    _assert_timestep(ts_j, ts_t)
    obs_t = t_env.observe(_torch_state(envs.TmazeState, raw))
    _assert_timestep(jax.vmap(j_env.observe)(_jax_state(j_env, raw)), obs_t)
    assert not obs_t.obs_image[:, 3:].any() and \
        not obs_t.obs_image[:, :, 11:].any()
