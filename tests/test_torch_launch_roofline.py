"""The port's step builders, dry run, sweep and roofline against the JAX
package's.

* ``input_specs``, ``pair_supported`` and ``decode_cache_len`` equal
  JAX's for every assigned config x shape; ``step_cost`` and
  ``forward_cost`` equal JAX's exactly on every config x shape x
  (devices, model axis) of (256, 16), (512, 16), (8, 2) and (1, 1);
  ``memory_model.estimate`` equals JAX's dict, bar the fit key, on the
  16x16 and 2x16x16 meshes under the baseline rules; ``model_flops``
  equals JAX's.
* ``build_steps`` at smoke widths in float32 (stablelm, granite-moe,
  mamba2, recurrentgemma; impala-shallow's train step only) against
  JAX's ``build_steps`` under ``use_rules`` on a 1x1 mesh of ``Auto``
  axes, built here (``jax.make_mesh``'s default axes are ``Explicit``
  under this jax, where ``with_sharding_constraint`` refuses them):
  the train step's loss and updated params, the prefill's logits,
  values and cache, and the serve step's value, cache and the log-prob
  of the port's action under JAX's logits (the two draw from other
  generators). Weights from numpy at the JAX spec tree's shapes, float32
  forwards at 1e-5, updated params at 1e-5.
* ``eager_cost`` of a step on ``meta`` tensors at published widths: a
  prefill's FLOPs within 2% of ``forward_cost`` at (1, 1), a train
  step's within 2% of 0.75 x ``step_cost`` (the port has no remat); the
  kernels' meta route reports the FLOPs their plain versions count on
  meta and the bytes of their operands and results; recurrentgemma-2b's
  ``prefill_32k`` traces in under 30 s.
* One subprocess each of the dry run (``--list``, an ``ok`` pair, a
  ``skip`` pair with JAX's reason) and of the sweep's ``--skip-done``;
  the records render in ``roofline.table``.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.configs.mistral_nemo_12b import swa_variant as j_swa
from repro.launch import steps as j_steps
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.roofline import analysis as j_analysis
from repro.roofline import flops_model as j_flops
from repro.roofline import memory_model as j_memory
from repro.sharding import rules as j_rules

from repro_torch import params as P
from repro_torch.configs import base, registry
from repro_torch.configs.mistral_nemo_12b import swa_variant
from repro_torch.kernels import meta, ops
from repro_torch.kernels import vtrace as vk
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import backbone as bb
from repro_torch.models import common
from repro_torch.roofline import analysis, flops_model, memory_model, table
from repro_torch.sharding.rules import Rules

from test_torch_attention import spec_params
from test_torch_learner import _fixed_batch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = registry.ASSIGNED
MESHES = [(256, 16), (512, 16), (8, 2), (1, 1)]
FWD = dict(atol=1e-5, rtol=1e-5)


def _cfgs(name):
    return j_registry.get_config(name), registry.get_config(name)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + env.get("PYTHONPATH", "").split(
            os.pathsep))
    return env


# ---------------------------------------------------------------------------
# Inputs, applicability, the analytic models


@pytest.mark.parametrize("name", NAMES)
def test_inputs_and_applicability_equal_jax(name):
    j_cfg, t_cfg = _cfgs(name)
    pairs = [(j_cfg, t_cfg)]
    if name == "mistral_nemo_12b":
        pairs.append((j_swa(), swa_variant()))
    for j_c, t_c in pairs:
        for s, shape in base.INPUT_SHAPES.items():
            j_shape = j_base.INPUT_SHAPES[s]
            assert steps.pair_supported(t_c, shape) == \
                j_steps.pair_supported(j_c, j_shape)
            assert steps.decode_cache_len(t_c, shape.seq_len) == \
                j_steps.decode_cache_len(j_c, shape.seq_len)
            t_in = P.flatten(steps.input_specs(t_c, shape))
            j_in = P.flatten(j_steps.input_specs(j_c, j_shape))
            assert sorted(t_in) == sorted(j_in)
            for k, x in t_in.items():
                assert x.device.type == "meta", k
                assert tuple(x.shape) == tuple(j_in[k].shape), k
                assert str(x.dtype) == f"torch.{j_in[k].dtype}", k


@pytest.mark.parametrize("name", NAMES)
def test_flops_model_equals_jax(name):
    j_cfg, t_cfg = _cfgs(name)
    for s, shape in base.INPUT_SHAPES.items():
        j_shape = j_base.INPUT_SHAPES[s]
        for n_dev, m in MESHES:
            assert flops_model.step_cost(t_cfg, shape, n_dev, m) == \
                j_flops.step_cost(j_cfg, j_shape, n_dev, m), (s, n_dev, m)
            for decode in (False, True):
                kw = dict(decode=decode)
                t = flops_model.forward_cost(t_cfg, 2, 64, shape.seq_len, m,
                                             **kw)
                j = j_flops.forward_cost(j_cfg, 2, 64, shape.seq_len, m,
                                         **kw)
                assert (t.flops, t.bytes) == (j.flops, j.bytes), (s, m)
        count = common.param_count(bb.backbone_specs(t_cfg,
                                                     steps.NUM_ACTIONS))
        for per_device in (False, True):
            assert analysis.model_flops(t_cfg, count, shape, per_device,
                                        256) == j_analysis.model_flops(
                j_cfg, count, j_shape, per_device, 256)


@pytest.mark.parametrize("name", NAMES)
def test_memory_model_equals_jax_bar_the_fit(name):
    j_cfg, t_cfg = _cfgs(name)
    for names, sizes in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16))):
        t_mesh = mesh_lib.Mesh(names, sizes)
        t_rules, j_r = Rules(t_mesh), j_rules.Rules(t_mesh)
        for s, shape in base.INPUT_SHAPES.items():
            got = memory_model.estimate(t_cfg, shape, t_rules)
            want = j_memory.estimate(j_cfg, j_base.INPUT_SHAPES[s], j_r)
            assert got.pop("fits_80g") == (got["total"] < 80e9)
            want.pop("fits_16g")
            assert got == want, (s, sizes)


def test_analyse_bottleneck_without_and_with_collectives():
    hw = mesh_lib.HW
    r = analysis.analyse({"flops": 1e12, "bytes accessed": 1e9}, {}, hw,
                         model_flops=5e11)
    assert r.bottleneck == "compute" and r.collective_s is None
    assert r.compute_s == 1e12 / 989e12 and r.memory_s == 1e9 / 3.35e12
    assert 0 < r.useful_flops_ratio <= 1
    r = analysis.analyse({"flops": 1e9, "bytes accessed": 1e9},
                         {"all-reduce": 10**12}, hw)
    assert r.bottleneck == "collective"
    assert r.collective_s == 1e12 / hw["nvlink_bw_one_way"]
    assert hw["hbm_bytes"] == 80e9


# ---------------------------------------------------------------------------
# build_steps against JAX's


STEP_ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m", "mamba2-1.3b",
              "recurrentgemma-2b", "impala-shallow"]
B, S, CACHE, INDEX = 2, 9, 16, 5
CONV_HW = (10, 5, 3)


def _step_cfgs(name):
    j_cfg = j_registry.get_smoke_config(name).replace(dtype="float32")
    t_cfg = registry.get_smoke_config(name).replace(dtype="float32")
    if t_cfg.family == "impala_cnn":
        j_cfg, t_cfg = (c.replace(image_hw=CONV_HW) for c in (j_cfg, t_cfg))
    return j_cfg, t_cfg


def _jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    return mesh, j_rules.Rules(mesh)


def _port_rules():
    return Rules(mesh_lib.make_mesh(base.MeshConfig(data_axis=1,
                                                    model_axis=1)))


def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    a = steps.NUM_ACTIONS
    if cfg.family == "impala_cnn":
        batch = _fixed_batch(B, S - 1, CONV_HW, a, cfg.lstm_width, seed)
        del batch["done"]
        return batch
    return {
        "obs_token": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "actions": rng.integers(0, a, (B, S - 1)).astype(np.int32),
        "rewards": rng.standard_normal((B, S - 1)).astype(np.float32),
        "discounts": (0.99 * (rng.uniform(size=(B, S - 1)) > 0.1)
                      ).astype(np.float32),
        "behaviour_logprob": -rng.uniform(0.5, 1.5, (B, S - 1)
                                          ).astype(np.float32),
    }


def _torch(tree):
    """Copies (the port writes caches and params in place)."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch(v) for v in tree)
    return torch.tensor(np.asarray(tree))


def _close(want, got, name="", **tol):
    if torch.is_tensor(got):
        got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               np.asarray(got, np.float32), err_msg=name,
                               **(tol or FWD))


def _close_trees(want, got):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for k in w:
        _close(w[k], g[k], k)


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_build_steps_match_jax(name):
    j_cfg, t_cfg = _step_cfgs(name)
    mesh, j_r = _jax_rules()
    j_st = j_steps.build_steps(j_cfg, j_r)
    t_st = steps.build_steps(t_cfg, _port_rules())
    tree = spec_params(j_bb.backbone_specs(j_cfg, steps.NUM_ACTIONS), 0)
    j_params = jax.tree.map(jnp.asarray, tree)

    batch = _train_batch(t_cfg, 3)
    with mesh:
        j_new, _, j_m = jax.jit(j_st["train"])(
            j_params, j_st["optimizer"].init(j_params), jnp.int32(0),
            jax.tree.map(jnp.asarray, batch))
    t_params = P.from_jax(tree)
    t_new, _, t_m = t_st["train"](t_params, t_st["optimizer"].init(
        t_params), 0, _torch(batch))
    _close(j_m["loss/total"], t_m["loss/total"], "loss")
    _close_trees(jax.device_get(j_new), P.to_jax(t_new))
    if t_cfg.family == "impala_cnn":
        return

    rng = np.random.default_rng(4)
    tokens = rng.integers(0, t_cfg.vocab_size, (B, S)).astype(np.int32)
    with mesh:
        j_out = jax.jit(j_st["prefill"])(j_params,
                                         {"tokens": jnp.asarray(tokens)})
    t_params = P.from_jax(tree, requires_grad=False)
    t_out = t_st["prefill"](t_params, {"tokens": _torch(tokens)})
    for k in ("policy_logits", "values"):
        _close(j_out[k], t_out[k], k)
    _close_trees(jax.device_get(j_out["cache"]), t_out["cache"])

    cache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
             for k, v in P.flatten(bb.cache_abstract(B, CACHE,
                                                     t_cfg)).items()}
    cache_tree = P.tree_unflatten_like(
        bb.cache_abstract(B, CACHE, t_cfg),
        [cache[k] for k in sorted(cache)])
    token = rng.integers(0, t_cfg.vocab_size, (B, 1)).astype(np.int32)
    j_cache = jax.tree.map(jnp.asarray, cache_tree)
    with mesh:
        j_serve = jax.jit(j_st["serve"])(
            j_params, jnp.asarray(token), j_cache, jnp.int32(INDEX),
            jax.random.key_data(jax.random.key(1)))
        j_dec = jax.jit(lambda p, t, c: j_bb.apply_decode(
            p, t, c, jnp.int32(INDEX), j_cfg, steps.NUM_ACTIONS))(
                j_params, jnp.asarray(token), j_cache)
    gen = torch.Generator().manual_seed(1)
    t_serve = t_st["serve"](t_params, _torch(token), _torch(cache_tree),
                            INDEX, gen)
    _close(j_serve["value"], t_serve["value"], "value")
    _close_trees(jax.device_get(j_serve["cache"]), t_serve["cache"])
    _close(j_dec.policy_logits[:, 0], t_serve["policy_logits"],
           "policy_logits")
    logp = jax.nn.log_softmax(j_dec.policy_logits[:, 0])
    action = t_serve["action"].long().numpy()
    assert t_serve["action"].dtype == torch.int32
    _close(np.asarray(logp)[np.arange(B), action],
           t_serve["behaviour_logprob"], "behaviour_logprob")


# ---------------------------------------------------------------------------
# eager_cost on meta tensors, the kernels' meta route


def _trace(name, shape):
    cfg = registry.get_config(name)
    cost, info = steps.trace_pair(cfg, shape, None, _port_rules())
    assert info["local_batch"] == shape.global_batch
    assert not torch.cuda.is_initialized()
    return cfg, cost


@pytest.mark.parametrize("name,seq", [("stablelm-1.6b", 1024),
                                      ("mamba2-1.3b", 1024),
                                      ("olmoe-1b-7b", 512)])
def test_prefill_flops_on_meta_match_forward_cost(name, seq):
    cfg, cost = _trace(name, base.InputShape("p", seq, 1, "prefill"))
    want = flops_model.forward_cost(cfg, 1, seq, seq, 1).flops
    assert abs(cost["flops"] / want - 1) < 0.02, cost["flops"] / want
    assert cost["bytes accessed"] > 0


@pytest.mark.parametrize("name,shape", [
    ("stablelm-1.6b", base.InputShape("t", 512, 2, "train")),
    ("gemma-7b", base.INPUT_SHAPES["train_4k"])])
def test_train_flops_on_meta_are_three_quarters_of_step_cost(name, shape):
    cfg, cost = _trace(name, shape)
    want = 0.75 * flops_model.step_cost(cfg, shape, 1, 1)[0]
    assert abs(cost["flops"] / want - 1) < 0.02, cost["flops"] / want
    assert cost["kernel_launches"] == 1                  # K2, once


def test_recurrentgemma_prefill_32k_traces_on_meta_in_30s():
    t0 = time.time()
    _, cost = _trace("recurrentgemma-2b", base.InputShape(
        "prefill_32k", 32_768, 1, "prefill"))
    assert time.time() - t0 < 30
    # 26 layers: K3 in the 18 recurrent ones, K4 in the 8 local ones
    assert cost["kernel_launches"] == 26


def _meta_rand(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


KERNEL_CASES = {
    "K1": lambda impl: ops.vtrace(*(_meta_rand(3, 7) for _ in range(4)),
                                  _meta_rand(3), impl=impl),
    "K2": lambda impl: (vk.loss_vtrace_plain if impl == "ref" else
                        vk.loss_vtrace)(
        _meta_rand(7, 3, 5), _meta_rand(7, 3, 5),
        *(_meta_rand(7, 3) for _ in range(5))),
    "K3": lambda impl: ops.linear_scan(_meta_rand(6, 10), _meta_rand(6, 10),
                                       _meta_rand(10), impl=impl),
    "K4": lambda impl: ops.flash_attention(
        _meta_rand(2, 5, 4, 32, dtype=torch.bfloat16),
        _meta_rand(2, 9, 2, 32, dtype=torch.bfloat16),
        _meta_rand(2, 9, 2, 32, dtype=torch.bfloat16), True, 3, impl=impl),
    "K4 G=1": lambda impl: ops.flash_attention(
        _meta_rand(1, 1, 2, 64), _meta_rand(1, 3, 2, 64),
        _meta_rand(1, 3, 2, 64), False, 0, impl=impl),
    "K5": lambda impl: ops.decode_attention(
        _meta_rand(3, 8, 64, dtype=torch.bfloat16),
        _meta_rand(3, 11, 2, 64, dtype=torch.bfloat16),
        _meta_rand(3, 11, 2, 64, dtype=torch.bfloat16), _meta_rand(3, 11),
        impl=impl),
}
# the kernels' operand and result bytes (K1 sees (T, B) copies of the
# batch-major inputs, made by ops.vtrace)
KERNEL_BYTES = {"K1": 4 * 21 * 8, "K2": 4 * (2 * 105 + 5 * 21 + 4 * 21),
                "K3": 4 * (60 + 60 + 10 + 60),
                "K4": 2 * (40 + 36 + 36 + 40) * 32,
                "K4 G=1": 4 * (2 + 6 + 6 + 2) * 64,
                "K5": 2 * (24 + 66 + 66 + 24) * 64 + 4 * 33}


@pytest.mark.parametrize("kernel", list(KERNEL_CASES))
def test_meta_route_counts_what_the_plain_version_counts(kernel):
    run = KERNEL_CASES[kernel]
    plain = FlopCounterMode(display=False)
    with plain:
        want = run("ref")
    with meta.counting() as cost, FlopCounterMode(display=False) as fc:
        got = run("pallas")
    assert fc.get_total_flops() == 0          # no operator inside
    assert cost["flops"] == plain.get_total_flops()
    assert cost["launches"] == 1
    assert cost["bytes"] == KERNEL_BYTES[kernel]
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    # a CPU tensor takes the plain version and reports nothing
    with meta.counting() as cost:
        ops.linear_scan(torch.ones(2, 3), torch.ones(2, 3), impl="pallas")
    assert cost == {"flops": 0.0, "bytes": 0.0, "launches": 0}


# ---------------------------------------------------------------------------
# The dry run, the sweep and the table, as subprocesses


def _run(args, timeout=120):
    r = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                       text=True, env=_env(), timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_dryrun_list_equals_jax():
    want = [f"{a.replace('_', '-')} {s}" for a in j_registry.ASSIGNED
            for s in j_base.INPUT_SHAPES]
    assert _run(["repro_torch.launch.dryrun", "--list"]).split("\n")[:-1] \
        == want


def test_dryrun_records_and_table(tmp_path):
    out = str(tmp_path)
    line = _run(["repro_torch.launch.dryrun", "--arch", "stablelm-1.6b",
                 "--shape", "decode_32k", "--out", out])
    assert line.startswith("[ok   ] stablelm-1.6b"), line
    with open(tmp_path / "stablelm-1.6b_decode_32k_pod1_baseline.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["collectives"] == {}
    assert rec["roofline"]["collective_s"] is None
    assert rec["memory"]["temp_bytes"] is None
    j_cfg = j_registry.get_config("stablelm-1.6b")
    j_shape = j_base.INPUT_SHAPES["decode_32k"]
    a_flops, a_bytes = j_flops.step_cost(j_cfg, j_shape, 256)
    assert rec["analytic"]["flops_per_device"] == a_flops
    assert rec["analytic"]["bytes_per_device"] == a_bytes
    assert rec["analytic"]["compute_s"] == a_flops / 989e12
    mm = dict(rec["memory_model"])
    assert mm.pop("fits_80g") is True
    want = j_memory.estimate(j_cfg, j_shape, j_rules.Rules(
        mesh_lib.make_production_mesh()))
    want.pop("fits_16g")
    assert mm == want
    assert rec["n_params"] == j_common.param_count(
        j_bb.backbone_specs(j_cfg, 18))
    assert "batch 8 of 128" in rec["cost_view"]
    assert rec["cost"]["kernel_launches"] == 24          # K5 a layer

    line = _run(["repro_torch.launch.dryrun", "--arch", "gemma-7b",
                 "--shape", "long_500k", "--out", out])
    assert line.startswith("[skip ] gemma-7b")
    with open(tmp_path / "gemma-7b_long_500k_pod1_baseline.json") as f:
        skip = json.load(f)
    assert skip["reason"] == j_steps.pair_supported(
        j_registry.get_config("gemma-7b"),
        j_base.INPUT_SHAPES["long_500k"])[1]

    md = table.render(table.load(out, "16x16"))
    assert "| stablelm-1.6b | decode_32k | ok |" in md
    assert "| gemma-7b | long_500k | SKIP" in md
    assert "| none | **memory** |" in md


@pytest.mark.parametrize("argv,match", [
    (["--moe-impl", "dense_einsum"], "dense_einsum"),
    (["--moe-impl", "shard_map_a2a"], "shard_map_a2a"),
    (["--remat-off"], r"no remat \(ROADMAP\.md, Queue 3\)"),
    (["--moe-impl", "shard_map_a2a", "--shape", "train_4k"],
     "shard_map_a2a")])
def test_dryrun_refuses_the_variants_the_port_lacks(tmp_path, argv, match):
    """``--remat-off`` names a variant the port does not have and ends the
    run before anything is traced or written. Both ``--moe-impl``
    dispatches run olmoe's decode step, the record naming which, and the
    expert-parallel one also its ``train_4k`` step (forward and
    backward). The expert-parallel route counts one expert rank's E/n
    experts (n = 16, the model axis), so its record's FLOPs differ from
    the one-device dispatch's by exactly 15/16 of the expert products:
    their forward at decode, their forward and backward (three times the
    forward: each product's input and weight gradients) at ``train_4k``.
    The train record's analytic fields are the JAX package's models'."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.models import moe as moe_lib

    shape = argv[argv.index("--shape") + 1] if "--shape" in argv \
        else "decode_32k"
    base_argv = ["--arch", "olmoe-1b-7b", "--shape", "decode_32k",
                 "--out", str(tmp_path)]
    if "--remat-off" in argv:
        with pytest.raises(SystemExit, match=match):
            dryrun.main(base_argv + argv)
        assert not os.listdir(tmp_path)
        return
    assert dryrun.main(base_argv + argv) == 0
    tag = "baseline+densemoe" if match == "dense_einsum" else "baseline"
    with open(tmp_path / f"olmoe-1b-7b_{shape}_pod1_{tag}.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["moe_impl"] == match
    if match == "dense_einsum":
        assert rec["cost_view"].endswith("on their one-device dispatch")
        return
    assert "one expert rank's 4 of 64 experts" in rec["cost_view"]
    assert ("forward and backward" in rec["cost_view"]) == \
        (shape == "train_4k")
    assert dryrun.main(base_argv + ["--shape", shape, "--moe-impl",
                                    "dense_einsum"]) == 0
    with open(tmp_path / f"olmoe-1b-7b_{shape}_pod1_baseline+densemoe"
              ".json") as f:
        dense = json.load(f)
    cfg = registry.get_config("olmoe-1b-7b")
    m = cfg.moe
    in_shape = base.INPUT_SHAPES[shape]
    b_local = in_shape.global_batch // 16
    if shape == "train_4k":
        # one dispatch row a sequence, each of seq_len tokens
        rows, passes = b_local, 3
        cap = moe_lib._capacity(in_shape.seq_len, cfg)
    else:
        rows, passes = 1, 1
        cap = 2 * moe_lib._capacity(b_local, cfg)
    # up, gate and down: 2 * E * cap * d * ff FLOPs each, a layer and row
    experts = passes * rows * cfg.num_layers * 3 * 2 * m.num_experts * \
        cap * cfg.d_model * cfg.d_ff
    assert dense["cost"]["flops_per_device"] - \
        rec["cost"]["flops_per_device"] == experts * 15 // 16
    if shape != "train_4k":
        return
    j_cfg = j_registry.get_config("olmoe-1b-7b")
    j_cfg = j_cfg.replace(moe=dataclasses.replace(
        j_cfg.moe, dispatch_impl="shard_map_a2a"))
    j_shape = j_base.INPUT_SHAPES[shape]
    a_flops, a_bytes = j_flops.step_cost(j_cfg, j_shape, 256)
    assert rec["analytic"]["flops_per_device"] == a_flops
    assert rec["analytic"]["bytes_per_device"] == a_bytes
    mm = dict(rec["memory_model"])
    mm.pop("fits_80g")
    want = j_memory.estimate(j_cfg, j_shape, j_rules.Rules(
        mesh_lib.make_production_mesh()))
    want.pop("fits_16g")
    assert mm == want


def test_chip_smoke_dryrun_figures_are_jax_models():
    """chip_smoke.py holds its dry-run child's record to fixed figures:
    they are the JAX package's ``step_cost`` (256 devices) and memory
    model total (16x16, baseline rules) for its pair."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    arch, shape = smoke.DRYRUN_PAIR
    j_cfg, j_shape = j_registry.get_config(arch), j_base.INPUT_SHAPES[shape]
    flops, nbytes = j_flops.step_cost(j_cfg, j_shape, n_devices=256)
    total = j_memory.estimate(j_cfg, j_shape, j_rules.Rules(
        mesh_lib.make_production_mesh()))["total"]
    assert smoke.DRYRUN_WANT == {"flops_per_device": flops,
                                 "bytes_per_device": nbytes,
                                 "memory_total": total}


def test_sweep_skips_a_finished_pair(tmp_path):
    rec = {"status": "ok", "rules": "baseline"}
    with open(tmp_path / "gemma-7b_train_4k_pod1_baseline.json", "w") as f:
        json.dump(rec, f)
    out = _run(["repro_torch.launch.sweep", "--arch", "gemma-7b", "--shape",
                "train_4k", "--single-pod-only", "--skip-done", "--out",
                str(tmp_path)])
    assert out.startswith("sweep: 0 jobs"), out
