"""Multi-task training (``core.driver.multitask_loop``, paper §5.3)
against the JAX learner, and ``run_pbt`` on the CPU.

The actors' draws cannot match across the packages, so the learner step
is held to JAX on the batch the port's loop made: catch, bandit and
tmaze, 8 envs each, padded to the (10, 11, 3) frame and 4 actions and
concatenated on B in task order, one update at (T, B, A) = (16, 24, 4)
from the same initial params, through JAX's ``build_train_step`` with
the multi-task settings (``benchmarks/multitask.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import learner as j_learner

from repro_torch import params as P
from repro_torch.core import driver
from repro_torch.core.metrics import EpisodeTracker

torch.set_num_threads(1)

TASKS = ("catch", "bandit", "tmaze")
HW, A, N = (10, 11, 3), 4, 8


def _numpy(batch):
    return {k: (tuple(x.numpy() for x in v) if isinstance(v, tuple)
                else v.numpy()) for k, v in batch.items()}


def test_multitask_step_matches_jax_on_the_concatenated_batch():
    """Params after the update at atol 1e-5 (and rtol 1e-5), the loss
    metrics at rtol 1e-5; JAX runs its CPU default V-trace."""
    trackers = [EpisodeTracker(N) for _ in TASKS]
    loop = driver.multitask_loop(TASKS, 1, trackers, N, seed=0,
                                 device="cpu")
    arch = driver.get_smoke_config("impala_shallow").replace(image_hw=HW)
    init = P.to_jax(driver.init_params(arch, A, 0, "cpu"))
    step, params, metrics, batch = next(loop)
    batch = _numpy(batch)
    assert step == 0
    assert batch["actions"].shape == (3 * N, 16)
    assert batch["obs_image"].shape == (3 * N, 17) + HW
    # task order on B, each image at the top left of the common frame
    assert not batch["obs_image"][N:2 * N, :, 4:].any()       # bandit 4x4
    assert not batch["obs_image"][2 * N:, :, 3:].any()        # tmaze 3x11
    assert not batch["obs_image"][:N, :, :, 5:].any()         # catch 10x5
    assert (batch["actions"][N:2 * N] < 4).all() and \
        (batch["actions"][:N] < 4).all()

    j_arch = j_smoke("impala-shallow").replace(image_hw=HW)
    j_cfg = JaxImpalaConfig(num_actions=A, unroll_length=16,
                            learning_rate=1e-3, entropy_cost=0.005,
                            rmsprop_eps=0.01, policy_lag=1)
    j_step, j_opt = j_learner.build_train_step(j_arch, j_cfg, A)
    jp, _, jm = jax.jit(j_step)(init, j_opt.init(init), jnp.int32(0),
                                jax.tree.map(jnp.asarray, batch))
    for k, v in jax.device_get(jm).items():
        np.testing.assert_allclose(float(metrics[k]), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got = P.flatten(P.to_jax(params))
    for k, v in P.flatten(jax.device_get(jp)).items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_train_multitask_reports_every_task():
    out = driver.train_multitask(list(TASKS), 4, num_envs_per_task=4,
                                 device="cpu")
    assert list(out) == list(TASKS)
    assert all(np.isfinite(v) for v in out.values())
    expert = driver.train_multitask(["bandit"], 2, num_envs_per_task=4,
                                    device="cpu")
    assert list(expert) == ["bandit"] and np.isfinite(expert["bandit"])


def test_run_pbt_exploit_leaves_the_source_member_untouched():
    """Two rounds of a population of 4: a member that copied in round
    0's exploits trains on its copy in round 1, and the member it copied
    from stays exactly as it was while it does."""
    before = {}

    def before_turn(rnd, i, weights):
        before[(rnd, i)] = [P.flatten(P.to_jax(w)) for w in weights]

    pbt, weights, history = driver.run_pbt(
        pop=4, rounds=2, steps_per_round=2, num_envs=4, seed=1,
        device="cpu", before_turn=before_turn)
    assert len(weights) == 4 and len(history) == 8
    assert all(np.isfinite(m.fitness) for m in pbt.members)
    copies = [(h["member"], h["copied_from"]) for h in history
              if h["round"] == 0 and h["copied_from"] is not None]
    assert copies, history
    for i, src in copies:
        start = before[(1, i)]
        end = before[(1, i + 1)]
        assert any(not np.array_equal(end[i][k], v)
                   for k, v in start[i].items())
        for k, v in start[src].items():
            np.testing.assert_array_equal(end[src][k], v, err_msg=k)
