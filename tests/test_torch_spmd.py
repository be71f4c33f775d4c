"""The port's SPMD learner against the JAX package's documented semantics.

``build_spmd_train_step`` and ``build_spmd_replay_train_step`` run on
spawned gloo ranks on the CPU, each rank on its rows of the batch, for
three rounds. The oracle is the JAX package's split route: its
``grad_step`` on each shard, the numpy mean of the gradients, its
``apply_step`` (the update its ``build_spmd_train_step`` documents). JAX's
``shard_map`` step is not the oracle: under jax 0.9 it applies the
shards' sum, and the port must not match that (ROADMAP.md Queue 3).

* Distinct halves on 2 ranks: JAX's split route with the halves' mean.
* Duplicated halves: JAX's fused ``build_train_step`` on one half.
* The replay variant on distinct halves, ``vtrace/traj_adv_mag`` the
  global vector in row order.
* An odd row count takes the replicated variant (``Rules``' divisibility
  fallback) and equals the fused step on the whole batch.
* The same four on 4 ranks (quarters; the all-reduce's sum order may
  differ from numpy's).

Then ``CollectiveExchange`` against JAX's, and whole runs of
``run_async_training(spmd_devices=1)`` and ``spmd_devices=2`` (plain and
replay) with the ``group`` section's keys and values and identical
replicas; the CLI's SPMD runs are in ``test_torch_guard.py``.

Inputs are numpy draws from seeds; JAX runs its loss with the CPU's
V-trace (``scan``), the port with its reverse loop; f32 at 1e-5. This
module imports jax only inside its fixtures: the spawned ranks import it.
"""
import numpy as np
import pytest
import torch

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import learner as t_learner
from repro_torch.sharding.rules import Rules

from test_torch_moe_ep import run_ranks

torch.set_num_threads(1)

_HW = (10, 5, 3)
_B, _T, _A = 4, 5, 3          # rows a shard, unroll, actions
_K = 3                        # rounds
_ICFG = dict(num_actions=_A, unroll_length=_T, rmsprop_eps=0.01,
             entropy_cost=0.003, learning_rate=6e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(seed, width, rows=_B, replay_mask=None):
    rng = np.random.default_rng(seed)
    img = ((rng.uniform(size=(rows, _T + 1) + _HW) < 0.1) * 255).astype(
        np.uint8)
    actions = rng.integers(0, _A, (rows, _T)).astype(np.int32)
    done = rng.uniform(size=(rows, _T)) < 0.15
    batch = {
        "obs_image": img,
        "last_action": np.concatenate(
            [np.zeros((rows, 1), np.int32), actions], 1),
        "last_reward": rng.choice([-1.0, 0.0, 1.0], (rows, _T + 1)).astype(
            np.float32),
        "done_in": np.concatenate([np.zeros((rows, 1), bool), done], 1),
        "actions": actions,
        "rewards": rng.choice([-1.0, 0.0, 1.0], (rows, _T)).astype(
            np.float32),
        "discounts": (0.99 * (1.0 - done)).astype(np.float32),
        "behaviour_logprob": np.log(rng.uniform(0.2, 0.6, (rows, _T))
                                    ).astype(np.float32),
        "done": done,
        "lstm_state": tuple(rng.standard_normal((rows, width)).astype(
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


def _scenarios(n, width):
    """name -> (each round's batch for every rank, replay)."""
    mask = [1.0, 0.0, 1.0, 0.0]
    distinct = [[_batch(100 * i + r, width) for r in range(n)]
                for i in range(_K)]
    # 3 rows divide over neither 2 nor 4: every rank takes the whole batch
    odd = [_batch(900 + i, width, rows=3) for i in range(_K)]
    return {"distinct": (distinct, False),
            "duplicated": ([[d[0]] * n for d in distinct], False),
            "replay": ([[_batch(500 + 100 * i + r, width, replay_mask=mask)
                         for r in range(n)] for i in range(_K)], True),
            "odd": ([[o] * n for o in odd], False)}


@pytest.fixture(scope="module")
def setup():
    """The JAX side: params, target, every scenario's batches and the
    oracle's params (and traj vectors) after each scenario's rounds."""
    import jax

    from repro.configs.base import ImpalaConfig as JaxImpalaConfig
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.core import learner as j_learner
    from repro.models import backbone as j_bb
    from repro.models import common as j_common

    j_arch = j_smoke("impala-shallow").replace(image_hw=_HW)
    specs = j_bb.backbone_specs(j_arch, _A)
    params = jax.device_get(j_common.init_params(specs, jax.random.key(0)))
    target = jax.device_get(j_common.init_params(specs, jax.random.key(1)))
    icfg = JaxImpalaConfig(**_ICFG)
    grad, apply, opt = j_learner.build_grad_apply_steps(
        j_arch, icfg, _A, vtrace_impl="scan")
    r_grad, r_apply, r_opt = j_learner.build_replay_grad_apply_steps(
        j_arch, icfg, _A, vtrace_impl="scan")
    fused, f_opt = j_learner.build_train_step(j_arch, icfg, _A,
                                              vtrace_impl="scan")
    grad, apply, r_grad, r_apply, fused = (
        jax.jit(f) for f in (grad, apply, r_grad, r_apply, fused))

    def split(rounds, replay, scale=1.0):
        p = params
        o = (r_opt if replay else opt).init(params)
        trajs = []
        for i, shards in enumerate(rounds):
            outs = [r_grad(p, target, s) if replay else grad(p, s)
                    for s in shards]
            leaves = [jax.tree.leaves(g) for g, _ in outs]
            acc = [np.array(x, np.float32) for x in leaves[0]]
            for other in leaves[1:]:
                for a, x in zip(acc, other):
                    a += np.asarray(x)
            mean = [a / np.float32(len(outs)) * np.float32(scale)
                    for a in acc]
            tree = jax.tree.unflatten(jax.tree.structure(outs[0][0]), mean)
            p, o, _ = (r_apply if replay else apply)(p, o, i, tree)
            if replay:
                trajs.append(np.concatenate(
                    [np.asarray(m["vtrace/traj_adv_mag"]) for _, m in outs]))
        return jax.device_get(p), trajs

    def whole(rounds):
        p, o = params, f_opt.init(params)
        for i, shards in enumerate(rounds):
            p, o, _ = fused(p, o, i, shards[0])
        return jax.device_get(p)

    cases = {}
    for n in (2, 4):
        for name, (rounds, replay) in _scenarios(n, j_arch.lstm_width
                                                 ).items():
            if name in ("duplicated", "odd"):
                want, trajs = whole(rounds), []
            else:
                want, trajs = split(rounds, replay)
            rows = sum(s["actions"].shape[0] for s in rounds[0]) \
                if name != "odd" else rounds[0][0]["actions"].shape[0]
            cases[(n, name)] = {"rounds": rounds, "replay": replay,
                                "rows": rows, "want": want, "trajs": trajs}
    # the sum the jax 0.9 shard_map step applies, for the distinct halves
    summed, _ = split(cases[(2, "distinct")]["rounds"], False, scale=2.0)
    return {"params": params, "target": target, "cases": cases,
            "summed": summed}


def _rank_main(rank, n, addr, params, target, cases, conn):
    """One rank: every scenario of its group size, from the same params,
    ``_K`` rounds each on its rows; the params after each (JAX layout) and
    the replay's traj vectors back up the pipe."""
    import traceback

    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_data_mesh

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=addr, world_size=n,
                                rank=rank)
        mesh = make_data_mesh(n, "cpu")
        mesh.device_mesh("cpu")
        rules = Rules(mesh)
        arch = get_smoke_config("impala-shallow").replace(image_hw=_HW)
        icfg = ImpalaConfig(**_ICFG)
        # each scenario's backward passes on this rank
        backwards = {}
        grad_fn = t_learner._grad_fn

        def counting_grad_fn(loss_fn):
            grad_step = grad_fn(loss_fn)

            def counted(*args):
                backwards[name] = backwards.get(name, 0) + 1
                return grad_step(*args)
            return counted
        t_learner._grad_fn = counting_grad_fn
        out = {"backwards": backwards}
        for name, case in cases.items():
            replay = case["replay"]
            build = (t_learner.build_spmd_replay_train_step if replay
                     else t_learner.build_spmd_train_step)
            # the learner's choice: rows the mesh divides are sharded
            sharded = rules.spec(("batch",), (case["rows"],))[0] is not None
            if name == "odd":
                assert not sharded, rows
            step, opt = build(arch, icfg, _A, mesh,
                              batch_replicated=not sharded)
            p = P.from_jax(params)
            tp = P.from_jax(target, requires_grad=False)
            o = opt.init(p)
            trajs = []
            for i, shards in enumerate(case["rounds"]):
                batch = _to_torch(shards[rank])
                if replay:
                    p, o, m = step(p, tp, o, i, batch)
                    trajs.append(m["vtrace/traj_adv_mag"].numpy().copy())
                else:
                    p, o, m = step(p, o, i, batch)
                assert np.isfinite(float(m["loss/total"]))
            out[name] = (P.to_jax(p), trajs)
        dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


@pytest.fixture(scope="module")
def ranks(setup):
    """Every rank's results, one gloo group of 2 and one of 4."""
    out = {}
    for n in (2, 4):
        cases = {name: {k: c[k] for k in ("rounds", "replay", "rows")}
                 for (k, name), c in setup["cases"].items() if k == n}
        out[n] = run_ranks(_rank_main, n, setup["params"], setup["target"],
                           cases)
    return out


def _leaves(tree):
    return P.flatten(tree)


def _assert_tree_close(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   err_msg=f"{what}: {k}", **TOL)


CASES = [(n, name) for n in (2, 4)
         for name in ("distinct", "duplicated", "replay", "odd")]


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("n,name", CASES,
                         ids=[f"{n}ranks-{name}" for n, name in CASES])
def test_spmd_step_matches_the_split_route_mean(setup, ranks, n, name):
    """After ``_K`` rounds every rank holds the oracle's params (and, for
    replay, each round's global traj vector in row order); the ranks'
    replicas are bit identical."""
    case = setup["cases"][(n, name)]
    first = None
    for r, got in sorted(ranks[n].items()):
        params, trajs = got[name]
        _assert_tree_close(params, case["want"], f"{name} rank {r}")
        for got, want in zip(trajs, case["trajs"], strict=True):
            np.testing.assert_allclose(got, want, **TOL)
        flat = _leaves(params)
        if first is None:
            first = flat
        else:
            for k in flat:
                np.testing.assert_array_equal(flat[k], first[k])


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_step_runs_one_backward_a_round(ranks, n):
    """The replicated variant's mean is rank 0's gradient, broadcast: the
    other ranks run the backward pass only on their first batch of a shape
    (it measures the buffer they receive into), then only receive. The
    sharded step runs it on every rank every round."""
    for r, got in sorted(ranks[n].items()):
        calls = got["backwards"]
        assert calls["odd"] == (_K if r == 0 else 1), (r, calls)
        assert calls["distinct"] == _K, (r, calls)


def test_spmd_step_is_not_the_shards_sum(setup, ranks):
    """The port applies the halves' mean: JAX's split route fed twice that
    gradient (what JAX's shard_map step applies under jax 0.9) lands
    measurably elsewhere."""
    got = _leaves(ranks[2][0]["distinct"][0])
    summed = _leaves(setup["summed"])
    assert max(float(np.abs(np.asarray(got[k]) - np.asarray(summed[k])).max())
               for k in got) > 1e-4


def test_collective_exchange_matches_jax():
    """The JAX test's case (``tests/test_group.py``) on both exchanges:
    the version contract, the latency histogram, no byte counters."""
    from repro.distributed import CollectiveExchange as JaxCollective

    from repro_torch.distributed import CollectiveExchange

    snaps = []
    for cls in (JaxCollective, CollectiveExchange):
        ex = cls(4)
        assert ex.in_xla
        leaves, version = ex.allreduce([], round_idx=7)
        assert leaves == [] and version == 8
        ex.observe_round_s(0.004, round_idx=7)
        snap = ex.snapshot()
        assert snap["exchange_backend"] == "collective"
        assert snap["devices"] == 4 and snap["rounds"] == 1
        assert "bytes_in" not in snap and "bytes_out" not in snap
        # 4000 us has bit_length 12 -> the [2048, 4096) us bucket
        assert snap["round_us_hist"] == {12: 1}
        assert snap["round_ms_mean"] == pytest.approx(4.0)
        snaps.append(snap)
    j, t = snaps
    assert set(j) == set(t)
    assert {k: v for k, v in j.items() if k != "kind"} == \
        {k: v for k, v in t.items() if k != "kind"}
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        CollectiveExchange(0)


# ---------------------------------------------------------------------------
# whole runs on the CPU

_RUN_ICFG = dict(num_actions=3, unroll_length=5, learning_rate=1e-3,
                 entropy_cost=0.003, rmsprop_eps=0.01)
_GROUP_KEYS = {"num_learners", "publisher", "exchange_backend",
               "spmd_devices", "rounds"}


def _check_group(tel, n, steps):
    assert tel["learner_updates"] == tel["param_version"] == steps
    assert set(tel["group"]) == _GROUP_KEYS
    assert tel["group"] == {"num_learners": 1, "publisher": 0,
                            "exchange_backend": "collective",
                            "spmd_devices": n, "rounds": steps}
    assert tel["exchange"]["devices"] == n
    assert sum(tel["exchange"]["round_us_hist"].values()) == steps
    assert tel["learner_id"] == 0 and tel["slot_base"] == 0


@pytest.mark.timeout_s(120)
def test_run_async_training_spmd_one_device():
    from repro_torch.distributed import run_async_training

    _, metrics, tel = run_async_training(
        "catch", ImpalaConfig(**_RUN_ICFG), num_envs=4, steps=10,
        num_actors=2, max_batch_trajs=2, seed=0, spmd_devices=1,
        device="cpu")
    _check_group(tel, 1, 10)
    assert np.isfinite(float(metrics["loss/total"]))


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("replay", [False, True], ids=["plain", "replay"])
def test_run_async_training_spmd_two_ranks(replay):
    """Two ranks: the group section, the batch sizes through both the
    sharded and (where a batch's rows are odd) the replicated step, and
    the step rank's final params bit for bit rank 0's."""
    import torch.distributed as dist

    from repro_torch.distributed import runtime
    from repro_torch.distributed.spmd import params_crc

    icfg = ImpalaConfig(**_RUN_ICFG, **(
        dict(replay_fraction=0.5, replay_capacity=64, replay_reuse=2,
             replay_target_period=4) if replay else {}))
    learner = runtime._setup("catch", icfg, 3, num_actors=2,
                             max_batch_trajs=2, seed=0, spmd_devices=2,
                             device="cpu")
    _, tel = learner.run(10, warm_buckets=True)
    _check_group(tel, 2, 10)
    assert not dist.is_initialized()            # the group went down
    assert learner._spmd.replica_crcs == {1: params_crc(learner._params)}
    assert ("replay" in tel) == replay
    if replay:
        assert tel["replay"]["sampled"] > 0
        assert tel["replay"]["target_syncs"] == 2


@pytest.mark.timeout_s(120)
def test_a_dead_step_rank_ends_the_run_with_its_error():
    """No fallback to one rank: a step rank killed before the first update
    fails the run, naming the rank, and the group goes down."""
    import torch.distributed as dist

    from repro_torch.distributed import runtime

    learner = runtime._setup("catch", ImpalaConfig(**_RUN_ICFG), 4,
                             num_actors=2, max_batch_trajs=2, seed=0,
                             spmd_devices=2, device="cpu")
    rank1 = learner._spmd._procs[0]
    rank1.kill()
    rank1.join(timeout=10)
    with pytest.raises(RuntimeError, match=r"SPMD step rank 1 died"):
        learner.run(5)
    assert not dist.is_initialized()
