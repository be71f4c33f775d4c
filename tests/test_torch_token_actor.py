"""The token actor and token training end to end, in the port: the
trajectory's structure against the JAX actor's, the behaviour log-probs
against the JAX learner's on the same tokens and weights, the JAX
package's ``test_actor_learner_logprob_alignment`` (log-rhos near 0 at
zero lag) and ``test_token_backbone_actor_pipeline`` (10 steps, a finite
loss, completed episodes) run on the port, and the CLI on the CPU: the
sync runtime, and the async one with thread and process actors.

Random draws cannot match across the two packages (JAX threefry, torch
Philox), so the JAX side sees the port's own trajectory. Tolerances: the
JAX tests' 5e-2 on log-rhos in bf16; float32 log-probs at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import actor as j_actor
from repro.core import learner as j_learner
from repro.core import vtrace as j_vtrace
from repro.data import envs as j_envs
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor, learner
from repro_torch.core import vtrace as vt
from repro_torch.core.driver import init_params, sync_loop
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.data import envs
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)

TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
            d_ff=128)


def _tiny(arch, env, **kw):
    """The JAX tests' tiny widths, in the port: two layers, d_model 64."""
    cfg = get_smoke_config(arch)
    if cfg.family == "dense":
        cfg = cfg.replace(**TINY)
    return cfg.replace(vocab_size=max(env.vocab_size, 32), **kw)


def test_token_actor_has_the_jax_trajectory_structure():
    """Keys, shapes and dtypes of a token unroll equal the JAX actor's:
    ``obs_token`` (B, T+1) and no image, LSTM or last-action keys."""
    kw = dict(num_actions=4, unroll_length=5)
    n = 3
    env_j = j_envs.make_bandit()
    j_arch = j_smoke("stablelm-1.6b").replace(
        **TINY, vocab_size=max(env_j.vocab_size, 32))
    j_init, j_unroll = j_actor.build_actor(env_j, j_arch,
                                           JaxImpalaConfig(**kw), n)
    jparams = j_common.init_params(j_bb.backbone_specs(j_arch, 4),
                                   jax.random.key(0))
    _, traj_j = j_unroll(jparams, j_init(jax.random.key(1)))
    env = envs.make_bandit()
    t_init, t_unroll = actor.build_actor(env, _tiny("stablelm-1.6b", env),
                                         ImpalaConfig(**kw), n)
    carry, traj_t = t_unroll(P.from_jax(jax.device_get(jparams),
                                        requires_grad=False), t_init(1))
    assert set(traj_j) == set(traj_t)
    assert "obs_image" not in traj_t and "lstm_state" not in traj_t
    for k in traj_j:
        assert tuple(traj_j[k].shape) == tuple(traj_t[k].shape), k
        assert str(traj_j[k].dtype) == \
            str(traj_t[k].dtype).replace("torch.", ""), k
    assert tuple(traj_t["obs_token"].shape) == (n, 6)
    assert carry.obs_token.shape == (n,)
    # the carry's token is the trajectory's bootstrap observation
    assert torch.equal(traj_t["obs_token"][:, -1], carry.obs_token)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b",
                                  "recurrentgemma-2b"])
def test_actor_logprobs_equal_the_jax_learners(arch):
    """Float32 weights and activations: the port's decode-step log-probs
    (a cache of unroll + 1 slots, K5 and the SSM / RG-LRU decode steps'
    plain versions here) equal JAX's ``apply_train`` over the port's own
    trajectory, at the actions taken."""
    env = envs.make_bandit()
    t_arch = _tiny(arch, env, dtype="float32")
    j_arch = j_smoke(arch).replace(dtype="float32")
    if j_arch.family == "dense":
        j_arch = j_arch.replace(**TINY)
    j_arch = j_arch.replace(vocab_size=t_arch.vocab_size)
    icfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=7)
    params = init_params(t_arch, env.num_actions, seed=3, device="cpu")
    init_fn, unroll = actor.build_actor(env, t_arch, icfg, 4)
    _, traj = unroll(params, init_fn(4))
    tree = P.to_jax(params)
    logits, _, _ = j_learner.forward_trajectory(
        tree, {"obs_token": jnp.asarray(traj["obs_token"].numpy())},
        j_arch, env.num_actions)
    want = j_vtrace.action_log_probs(logits[:, :-1],
                                     jnp.asarray(traj["actions"].numpy()))
    np.testing.assert_allclose(np.asarray(want),
                               traj["behaviour_logprob"].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_actor_learner_logprob_alignment():
    """tests/test_system.py::test_actor_learner_logprob_alignment
    (stablelm), on the port: with zero lag the learner's recomputed
    log pi(a_t|x_t) equals what the actor shipped, |log rho| < 5e-2."""
    env = envs.make_bandit()
    arch = _tiny("stablelm-1.6b", env)
    icfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=10)
    params = init_params(arch, env.num_actions, seed=0, device="cpu")
    init_fn, unroll = actor.build_actor(env, arch, icfg, 4)
    carry = init_fn(1)
    carry, traj = unroll(params, carry)          # warm-up unroll
    carry, traj = unroll(params, carry)
    with torch.no_grad():
        logits, _, _ = learner.forward_trajectory(params, traj, arch,
                                                  env.num_actions)
    log_rhos = vt.action_log_probs(logits[:, :-1], traj["actions"]) - \
        traj["behaviour_logprob"]
    assert float(log_rhos.abs().max()) < 5e-2


def test_token_backbone_actor_pipeline():
    """tests/test_system.py::test_token_backbone_actor_pipeline on the
    port: a tiny transformer acts through the decode cache and trains on
    the whole trajectory for 10 steps; the loss is finite and episodes
    complete."""
    env = envs.make_bandit()
    arch = _tiny("stablelm-1.6b", env)
    icfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=8,
                        learning_rate=1e-3, rmsprop_eps=0.01)
    tracker = EpisodeTracker(8)
    metrics = {}
    for _, _, metrics, _ in sync_loop(env, arch, icfg, 8, 10, tracker,
                                      seed=0, device="cpu"):
        pass
    assert np.isfinite(float(metrics["loss/total"]))
    assert len(tracker.completed) > 0


def test_cli_trains_a_token_backbone_on_the_cpu(capsys):
    run = train_lib.train(["--device", "cpu", "--smoke", "--arch",
                           "stablelm-1.6b", "--steps", "2", "--num-envs",
                           "4", "--unroll", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=stablelm-1.6b" in out and out.count("return(100)=") == 2
    assert run.arch.vocab_size >= run.env.vocab_size
    assert tuple(run.last_batch["obs_token"].shape) == (4, 9)
    assert np.isfinite(float(run.metrics["loss/total"]))


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_cli_async_trains_a_token_backbone(backend):
    """``--runtime async`` with thread actors (each unroll through
    ``build_actor``'s token branch), and with process actors (CPU
    children, as the JAX CLI runs them); inference mode refuses the
    token families, as in JAX."""
    run = train_lib.train(["--device", "cpu", "--smoke", "--runtime",
                           "async", "--arch", "stablelm-1.6b", "--steps",
                           "3", "--num-envs", "4", "--unroll", "8",
                           "--actor-threads", "1", "--actor-backend",
                           backend])
    assert run.telemetry["learner_updates"] == 3
    assert np.isfinite(float(run.metrics["loss/total"]))
    if backend == "thread":
        with pytest.raises(ValueError, match="use actor_mode='unroll'"):
            train_lib.train(["--device", "cpu", "--smoke", "--runtime",
                             "async", "--arch", "stablelm-1.6b",
                             "--actor-mode", "inference", "--steps", "1"])
