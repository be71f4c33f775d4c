"""The port's checkpoints against the JAX package's: one format, read and
written by both. A JAX checkpoint restores into the port bit for bit
after the layout map, for both IMPALA torsos; a port checkpoint restores
through JAX's ``restore`` and ``load_with_extra`` with the same manifest;
the combined fleet-v1 tree ``{"params", "opt"}`` keeps its conv kernels
HWIO on the JAX side both ways. Then resumes through the async runtime
(the version stream continues) and through both CLIs."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs.registry import get_config as j_config
from repro.models import backbone as j_bb
from repro.models import common as j_common

from repro_torch import params as P
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.configs.base import ImpalaConfig
from repro_torch.distributed import run_async_training
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)

ARCHS = ["impala-shallow", "impala-deep"]
_CONV = {"impala-shallow": "torso/conv1/kernel",
         "impala-deep": "torso/section0/conv/kernel"}


def _jax_params(arch: str, seed: int = 0):
    """Numpy params of the full-width torso agent, JAX layout."""
    specs = j_bb.backbone_specs(j_config(arch), 3)
    return jax.device_get(j_common.init_params(specs, jax.random.key(seed)))


def _fleet(arch: str):
    """A fleet-v1 tree in the JAX layout with non-zero RMSProp moments."""
    params = _jax_params(arch)
    ms = jax.tree.map(lambda x: np.square(x) + 0.5, params)
    return {"params": params, "opt": {"ms": ms}}


def _assert_trees_equal(got, want):
    got, want = P.flatten(got), P.flatten(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# the params bridge under a prefix


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_maps_conv_kernels_under_any_prefix(arch):
    """The conv kernels of ``params`` and of the optimizer's ``ms`` come
    out OIHW in the port and HWIO again on the JAX side."""
    fleet = _fleet(arch)
    conv = _CONV[arch]
    hwio = fleet["params"]
    for part in conv.split("/"):
        hwio = hwio[part]
    kh, kw, cin, cout = hwio.shape
    port = P.from_jax(fleet, requires_grad=False)
    for prefix in ("params", "opt/ms"):
        node = port
        for part in f"{prefix}/{conv}".split("/"):
            node = node[part]
        assert tuple(node.shape) == (cout, cin, kh, kw), prefix
    for prefix in ("ms", "opt/ms", "a/b/c"):
        tree = fleet["opt"]["ms"]
        for part in reversed(prefix.split("/")):
            tree = {part: tree}
        back = P.to_jax(P.from_jax(tree, requires_grad=False))
        _assert_trees_equal(back, tree)
    _assert_trees_equal(P.to_jax(port), fleet)


# ---------------------------------------------------------------------------
# JAX -> port and port -> JAX


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(arch, tmp_path):
    d = str(tmp_path)
    saved = _jax_params(arch, seed=1)
    j_ckpt.save(d, 7, saved)
    like = P.from_jax(_jax_params(arch, seed=2))
    got, step = t_ckpt.restore(d, like)
    assert step == 7 == t_ckpt.latest_step(d)
    assert all(x.requires_grad for x in P.tree_leaves(got))
    _assert_trees_equal(P.to_jax(got), saved)
    tree, step, extra = t_ckpt.load_with_extra(d)
    assert (step, extra) == (7, {})
    _assert_trees_equal(tree, saved)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_through_jax(arch, tmp_path):
    """Saved from the port's tensors: JAX's ``restore`` and
    ``load_with_extra`` read it, and the manifest is the one JAX writes for
    the same tree."""
    saved = _jax_params(arch, seed=3)
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    path = t_ckpt.save(t_dir, 5, P.from_jax(saved), extra={"note": "x"})
    j_ckpt.save(j_dir, 5, saved, extra={"note": "x"})
    assert os.path.basename(path) == "ckpt_00000005.npz"
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    assert t_ckpt.read_manifest(t_dir) == j_ckpt.read_manifest(j_dir)
    got, step = j_ckpt.restore(t_dir, _jax_params(arch, seed=4))
    assert step == 5
    _assert_trees_equal(got, saved)
    tree, step, extra = j_ckpt.load_with_extra(t_dir)
    assert (step, extra) == (5, {"note": "x"})
    _assert_trees_equal(tree, saved)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_tree_roundtrips_both_ways_with_hwio_kernels(writer,
                                                           tmp_path):
    """The fleet-v1 tree ``{"params", "opt"}``: written by the port from
    its tensors, JAX reads HWIO conv kernels in both; written by JAX, the
    port reads it back to the same tensors."""
    d = str(tmp_path)
    fleet = _fleet("impala-shallow")
    extra = {"version": 6, "format": "fleet-v1"}

    def port_tree():
        # as the learner holds them: params and moments mapped apart,
        # conv kernels OIHW, then combined under the fleet keys
        return {"params": P.from_jax(fleet["params"], requires_grad=False),
                "opt": {"ms": P.from_jax(fleet["opt"]["ms"],
                                         requires_grad=False)}}

    if writer == "port":
        t_ckpt.save(d, 6, port_tree(), extra)
    else:
        j_ckpt.save(d, 6, fleet, extra)
    for load in (j_ckpt.load_with_extra, t_ckpt.load_with_extra):
        tree, step, got_extra = load(d)
        assert (step, got_extra) == (6, extra)
        _assert_trees_equal(tree, fleet)
    restored, _ = t_ckpt.restore(d, port_tree())
    want = port_tree()
    for a, b in zip(P.tree_leaves(restored), P.tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_restore_refuses_a_shape_that_does_not_fit(tmp_path):
    d = str(tmp_path)
    j_ckpt.save(d, 1, _jax_params("impala-shallow"))
    like = P.from_jax(_jax_params("impala-deep"))
    with pytest.raises((ValueError, KeyError)):
        t_ckpt.restore(d, like)
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "empty"), like)


def test_save_replaces_the_archive_atomically(tmp_path):
    """No temporary file is left behind, and a second save of the same
    step replaces the first."""
    d = str(tmp_path)
    tree = {"w": torch.ones(3)}
    t_ckpt.save(d, 2, tree)
    t_ckpt.save(d, 2, {"w": torch.full((3,), 2.0)})
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_00000002.json",
                                     "ckpt_00000002.npz"]
    np.testing.assert_array_equal(t_ckpt.load_with_extra(d)[0]["w"],
                                  np.full(3, 2.0, np.float32))


# ---------------------------------------------------------------------------
# resume


def _icfg():
    return ImpalaConfig(num_actions=2, unroll_length=8, learning_rate=1e-3,
                        entropy_cost=0.003, rmsprop_eps=0.01)


def test_single_run_resume_restores_optimizer_state_and_versions(tmp_path):
    """tests/test_supervise.py's resume test on the port: the runtime saves
    fleet-v1 (params, optimizer state, version), JAX reads it, and a run
    resumed from it continues the version stream at 7, 8, 9, 10."""
    d = str(tmp_path / "ckpt")
    kw = dict(num_envs=4, num_actors=2, actor_backend="thread",
              queue_capacity=4, queue_policy="block", max_batch_trajs=2,
              seed=0, device="cpu")
    _, _, tel_fresh = run_async_training("bandit", _icfg(), steps=6,
                                         ckpt_dir=d, ckpt_every=3, **kw)
    man = j_ckpt.read_manifest(d)
    assert man["extra"] == {"version": 6, "format": "fleet-v1"}
    tree, step, extra = j_ckpt.load_with_extra(d)
    assert step == 6 and set(tree) == {"params", "opt"}
    assert any(np.any(x != 0) for x in jax.tree.leaves(tree["opt"]))
    seen = []
    tree_t, _, _ = t_ckpt.load_with_extra(d)
    _, _, tel_resumed = run_async_training(
        "bandit", _icfg(), steps=10,
        initial_params=P.from_jax(tree_t["params"]),
        initial_opt_state=P.from_jax(tree_t["opt"], requires_grad=False),
        start_step=6, on_update=lambda step, p, m, snap: seen.append(step),
        **kw)
    assert seen == [7, 8, 9, 10]
    assert tel_resumed["param_version"] == 10
    assert tel_resumed["learner_updates"] == 10
    assert sorted(tel_resumed) == sorted(tel_fresh)


def test_async_cli_resumes_a_fleet_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    run_async_training("bandit", _icfg(), num_envs=4, steps=3, num_actors=1,
                       max_batch_trajs=2, seed=0, device="cpu", ckpt_dir=d,
                       ckpt_every=3)
    run = train_lib.train(["--device", "cpu", "--smoke", "--runtime",
                           "async", "--env", "bandit", "--num-envs", "4",
                           "--unroll", "8", "--steps", "5", "--log-every",
                           "5", "--ckpt-dir", d, "--ckpt-every", "100"])
    out = capsys.readouterr().out
    assert "restored fleet checkpoint at version 3" in out
    assert run.telemetry["param_version"] == 5
    # the CLI's own saves are params-only, as the JAX CLI's are
    assert t_ckpt.latest_step(d) == 5
    assert j_ckpt.read_manifest(d)["extra"] == {}


def test_fleet_checkpoint_opt_state_is_the_learners(tmp_path):
    """The saved optimizer state is the learner's (JAX layout): each
    fleet-v1 save holds the moments the learner had after that update,
    and they move between saves. A fleet checkpoint of the full-width
    agent keeps its conv kernels HWIO in both halves."""
    from repro_torch.distributed import learner as t_learner
    from repro_torch.distributed import runtime

    d = str(tmp_path / "ckpt")
    learner = runtime._setup("bandit", _icfg(), 4, num_actors=1,
                             max_batch_trajs=2, seed=0, device="cpu")
    live = {}

    def keep(step, params, metrics, snapshot_fn):
        live[step] = (P.to_jax(params), learner.opt_state_host())

    learner.run(4, on_update=keep,
                on_checkpoint=runtime.fleet_checkpointer(d), ckpt_every=2)
    saved = {}
    for step in (2, 4):
        tree, got_step, extra = j_ckpt.load_with_extra(d, step=step)
        assert (got_step, extra) == (step, {"version": step,
                                            "format": "fleet-v1"})
        _assert_trees_equal(tree["params"], live[step][0])
        _assert_trees_equal(tree["opt"], live[step][1])
        saved[step] = jax.tree.leaves(tree["opt"])
    assert any(np.any(a != b) for a, b in zip(saved[2], saved[4]))

    arch = "impala-shallow"
    fleet = _fleet(arch)
    from repro_torch.configs.registry import get_config
    learner = t_learner.Learner(
        arch=get_config(arch), icfg=ImpalaConfig(num_actions=3),
        num_actions=3, num_envs=2, num_actors=1, transport=None,
        initial_params=P.from_jax(fleet["params"]),
        initial_opt_state=P.from_jax(fleet["opt"], requires_grad=False),
        device="cpu")
    _assert_trees_equal(learner.opt_state_host(), fleet["opt"])
    _assert_trees_equal(learner.published_host(), fleet["params"])


def test_sync_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--smoke", "--env", "bandit", "--num-envs",
            "4", "--unroll", "8", "--log-every", "2", "--ckpt-dir", d,
            "--ckpt-every", "3", "--replay-fraction", "0.5"]
    first = train_lib.train(argv + ["--steps", "6"])
    assert sorted(os.listdir(d)) == [
        "LATEST", "ckpt_00000003.json", "ckpt_00000003.npz",
        "ckpt_00000006.json", "ckpt_00000006.npz"]
    out = capsys.readouterr().out
    assert "restored checkpoint" not in out
    saved, _ = j_ckpt.restore(d, P.to_jax(first.params))
    _assert_trees_equal(saved, P.to_jax(first.params))
    second = train_lib.train(argv + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 6" in out
    steps = [int(ln.split()[1]) for ln in out.splitlines()
             if ln.startswith("step ")]
    assert steps == [8]                     # continues from step 6
    assert t_ckpt.latest_step(d) == 8
    assert len(second.log) == 1


def test_async_cli_saves_params_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--smoke", "--runtime", "async", "--env",
            "bandit", "--num-envs", "4", "--unroll", "8", "--log-every",
            "4", "--ckpt-dir", d, "--ckpt-every", "4"]
    train_lib.train(argv + ["--steps", "4"])
    man = j_ckpt.read_manifest(d)
    assert man["step"] == 4 and man["extra"] == {}
    capsys.readouterr()
    run = train_lib.train(argv + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out
    assert run.telemetry["param_version"] == 8
    assert run.telemetry["learner_updates"] == 8
    tel = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("telemetry: ")][-1][11:])
    assert "replay" not in tel
    assert t_ckpt.latest_step(d) == 8
