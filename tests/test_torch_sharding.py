"""The port's spec trees, sharding rules, profiles and meshes against the
JAX package's.

Every config of the registry, at its published widths and its smoke
widths: ``backbone_specs`` and ``opt_state_specs`` (f32 and mixed) equal
JAX's leaf for leaf (path, shape, logical axes, dtype, init, scale).
``Rules.spec`` equals ``tuple(jax Rules.spec)`` on every param,
optimizer, cache and batch leaf, under every profile, on the production
meshes (16x16, 2x16x16, the 16x4x4 ``tp2d`` mesh) and on data meshes of
1, 2, 4 and 8, each given to JAX as a stand-in with ``axis_names`` and a
``shape`` dict (the pattern of ``tests/test_sharding.py``), so no device
is needed. Then JAX's own cases mirrored, the DTensor placements of a
few specs, and ``use_rules``'s nesting and thread-locality.
"""
import functools
import threading

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.core import learner as j_learner
from repro.launch import steps as j_steps
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.sharding import profiles as j_profiles
from repro.sharding import rules as j_rules

from repro_torch import params as P
from repro_torch.configs import base
from repro_torch.configs import registry
from repro_torch.core import learner
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import backbone as bb
from repro_torch.models import common
from repro_torch.sharding import profiles
from repro_torch.sharding.rules import Rules, get_rules, use_rules

torch.set_num_threads(1)

CONFIGS = registry.list_configs()
PROFILES = ["baseline", "seq_data", "kv_data", "expert_data", "fsdp",
            "tp2d", "fsdp_moe", "fsdp_cp", "kv_head_dim", "head_dim_tp",
            "fsdp_pure"]
MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "16x4x4": (("data", "model_a", "model_b"), (16, 4, 4)),
    "data1": (("data",), (1,)),
    "data2": (("data",), (2,)),
    "data4": (("data",), (4,)),
    "data8": (("data",), (8,)),
}


def _fake_mesh(names, sizes):
    class FakeMesh:
        axis_names = names
        shape = dict(zip(names, sizes))
    return FakeMesh()


def _configs(name, smoke):
    if smoke:
        return j_registry.get_smoke_config(name), \
            registry.get_smoke_config(name)
    return j_registry.get_config(name), registry.get_config(name)


def _leaves(specs):
    return {k: (tuple(s.shape), tuple(s.logical), s.dtype, s.init,
                float(s.scale)) for k, s in P.flatten(specs).items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", CONFIGS)
def test_spec_trees_equal_jax(name, smoke):
    j_cfg, t_cfg = _configs(name, smoke)
    j_specs = j_bb.backbone_specs(j_cfg, steps.NUM_ACTIONS)
    t_specs = bb.backbone_specs(t_cfg, steps.NUM_ACTIONS)
    assert _leaves(t_specs) == _leaves(j_specs)
    assert common.param_count(t_specs) == j_common.param_count(j_specs)
    for momentum in (0.0, 0.9):
        j_icfg = j_base.ImpalaConfig(rmsprop_momentum=momentum)
        t_icfg = base.ImpalaConfig(rmsprop_momentum=momentum)
        for mixed in (False, True):
            assert _leaves(learner.opt_state_specs(
                t_specs, t_icfg, mixed)) == _leaves(
                    j_learner.opt_state_specs(j_specs, j_icfg, mixed))


def test_abstract_params_are_meta_and_init_reads_no_axes():
    specs = {"w": common.Spec((8, 32), ("embed", "ff")),
             "nested": {"b": common.Spec((4,), ("ff",), init="zeros"),
                        "h": common.Spec((2,), (None,), dtype="bfloat16")}}
    abstract = common.abstract_params(specs)
    assert abstract["w"].device.type == "meta"
    assert abstract["w"].shape == (8, 32)
    assert abstract["nested"]["h"].dtype == torch.bfloat16
    assert common.param_count(specs) == 262
    # the logical axes change no draw: the same seed, the same tensors
    bare = {"w": common.Spec((8, 32), (None, None)),
            "nested": {"b": common.Spec((4,), (None,), init="zeros"),
                       "h": common.Spec((2,), (None,))}}
    a, b = common.init_params(specs, 0), common.init_params(bare, 0)
    for k, v in P.flatten(a).items():
        assert torch.equal(v, P.flatten(b)[k]), k
    with pytest.raises(ValueError, match="rank"):
        common.Spec((8, 4), ("embed",))
    shardings = common.param_shardings(
        specs, Rules(mesh_lib.make_production_mesh()))
    assert shardings["w"] == (Replicate(), Shard(1))


@functools.lru_cache(maxsize=None)
def _pairs(name):
    """Every (logical, shape) of a param, optimizer, cache and batch leaf
    of ``name``'s published config, from the port's trees, after checking
    that JAX's trees give the same ones at the same paths."""
    j_cfg, t_cfg = _configs(name, False)
    t_specs = bb.backbone_specs(t_cfg, steps.NUM_ACTIONS)
    pairs = {(s[1], s[0]) for s in _leaves(
        learner.opt_state_specs(t_specs, base.ImpalaConfig(), True)
    ).values()}
    pairs |= {(s[1], s[0]) for s in _leaves(t_specs).values()}
    if t_cfg.family == "impala_cnn":
        return sorted(pairs, key=repr)
    for shape in base.INPUT_SHAPES.values():
        j_shape = j_base.INPUT_SHAPES[shape.name]
        t_in = P.flatten(steps.input_specs(t_cfg, shape))
        t_ax = P.flatten(steps.batch_logical_axes(t_cfg, shape))
        j_in = P.flatten(j_steps.input_specs(j_cfg, j_shape))
        j_ax = P.flatten(j_steps.batch_logical_axes(j_cfg, j_shape))
        assert sorted(t_in) == sorted(j_in) == sorted(t_ax) == sorted(j_ax)
        for k in t_in:
            assert tuple(t_in[k].shape) == tuple(j_in[k].shape), k
            assert tuple(t_ax[k]) == tuple(j_ax[k]), k
            pairs.add((tuple(t_ax[k]), tuple(t_in[k].shape)))
    return sorted(pairs, key=repr)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_rules_spec_equals_jax_on_every_leaf(name, mesh):
    names, sizes = MESHES[mesh]
    t_mesh = mesh_lib.Mesh(names, sizes)
    j_mesh = _fake_mesh(names, sizes)
    shape = base.INPUT_SHAPES["train_4k"]
    j_shape = j_base.INPUT_SHAPES["train_4k"]
    cfg = registry.get_config(name)
    j_cfg = j_registry.get_config(name)
    pairs = _pairs(name)
    for prof in PROFILES:
        t_rules = Rules(t_mesh, profiles.get_profile(prof, cfg, shape))
        j_r = j_rules.Rules(j_mesh, j_profiles.get_profile(prof, j_cfg,
                                                           j_shape))
        assert t_rules.table == j_r.table, prof
        for logical, shp in pairs:
            assert t_rules.spec(logical, shp) == \
                tuple(j_r.spec(logical, shp)), (prof, logical, shp)
        assert t_rules.spec(("batch", "heads")) == \
            tuple(j_r.spec(("batch", "heads")))


@pytest.mark.parametrize("prof", PROFILES)
def test_profiles_equal_jax(prof):
    for name in ("mamba2-1.3b", "qwen1.5-4b", "mistral-nemo-12b"):
        for shape in base.INPUT_SHAPES:
            assert profiles.get_profile(
                prof, registry.get_config(name),
                base.INPUT_SHAPES[shape]) == j_profiles.get_profile(
                    prof, j_registry.get_config(name),
                    j_base.INPUT_SHAPES[shape])


def test_unknown_profile_raises_keyerror():
    with pytest.raises(KeyError):
        profiles.get_profile("nope", registry.get_config("gemma-7b"),
                             base.INPUT_SHAPES["train_4k"])


# ---------------------------------------------------------------------------
# JAX's own cases (tests/test_sharding.py), mirrored


def _rules(mesh_shape=(16, 16), overrides=None):
    return Rules(mesh_lib.Mesh(("data", "model"), mesh_shape), overrides)


def test_divisibility_fallback():
    rules = _rules()
    # 10 heads on a 16-way model axis -> replicated
    s = rules.spec(("batch", None, "heads", None), (256, 4096, 10, 256))
    assert s == ("data", None, None, None)
    # divisible -> sharded
    s2 = rules.spec(("batch", None, "heads", None), (256, 4096, 16, 256))
    assert s2[2] == "model"


def test_axis_used_once():
    # experts and ff both map to model; only the first gets it
    s = _rules().spec(("experts", "embed", "ff"), (32, 1024, 512))
    assert s[0] == "model" and s[2] is None


def test_missing_mesh_axis_dropped():
    assert _rules().spec(("batch", None), (256, 64))[0] == "data"
    assert _rules().table["batch"] == ("data",)


def test_profile_overrides():
    arch = registry.get_config("mamba2-1.3b")
    shape = base.INPUT_SHAPES["long_500k"]
    assert profiles.get_profile("baseline", arch, shape) is None
    rules = _rules(overrides=profiles.get_profile("seq_data", arch, shape))
    s = rules.spec(("batch", "seq", "embed"), (1, 524288, 2048))
    assert s[0] is None and s[1] is not None


def test_tp2d_profile_resolution():
    prof = profiles.get_profile("tp2d", registry.get_config("qwen1.5-4b"),
                                base.INPUT_SHAPES["train_4k"])
    rules = Rules(mesh_lib.make_mesh_2d_tp(), prof)
    # qwen's 20 heads shard on model_a (20 % 4 == 0)
    assert rules.spec(("embed", "heads", "head_dim"),
                      (2560, 20, 128))[1] == "model_a"
    # ff uses the full 16-way product
    assert rules.spec(("embed", "ff"), (2560, 6912))[1] == \
        ("model_a", "model_b")


def test_fsdp_pure_profile_resolution():
    prof = profiles.get_profile("fsdp_pure",
                                registry.get_config("mistral-nemo-12b"),
                                base.INPUT_SHAPES["train_4k"])
    rules = _rules(overrides=prof)
    # batch shards over every axis; weights shard on embed dim
    s = rules.spec(("batch", None, None), (256, 4096, 5120))
    assert set(s[0]) == {"data", "model"}
    w = rules.spec(("embed", "heads", "head_dim"), (5120, 32, 128))
    assert w[0] == ("data", "model") and w[1] is None


def test_data_mesh_replicates_the_conv_agent():
    """IMPALA's conv-LSTM tree on an 8-way ('data',) mesh: every leaf
    replicated (the fallback, not a crash); 32 rows shard, 20 do not."""
    rules = Rules(mesh_lib.Mesh(("data",), (8,)))
    specs = bb.backbone_specs(registry.get_smoke_config("impala-shallow"),
                              3)
    for pl in P.flatten(common.param_shardings(specs, rules)).values():
        assert pl == (Replicate(),)
    assert rules.spec(("batch",), (32,)) == ("data",)
    assert rules.spec(("batch",), (20,)) == (None,)


# ---------------------------------------------------------------------------
# Placements, meshes, use_rules


@pytest.mark.parametrize("logical,shape,mesh,prof,want", [
    (("batch", None, "heads", None), (256, 4096, 16, 256), "16x16",
     "baseline", (Shard(0), Shard(2))),
    (("batch", None, "heads", None), (256, 4096, 10, 256), "16x16",
     "baseline", (Shard(0), Replicate())),
    (("batch", None), (256, 64), "2x16x16", "baseline",
     (Shard(0), Shard(0), Replicate())),
    (("embed", "ff"), (2560, 6912), "16x4x4", "tp2d",
     (Replicate(), Shard(1), Shard(1))),
    (("layers", "embed", "ff"), (24, 2048, 5632), "data8", "baseline",
     (Replicate(),)),
])
def test_placements(logical, shape, mesh, prof, want):
    rules = Rules(mesh_lib.Mesh(*MESHES[mesh]), profiles.get_profile(
        prof, registry.get_config("qwen1.5-4b"),
        base.INPUT_SHAPES["train_4k"]))
    assert rules.placements(logical, shape) == want


def test_meshes_equal_jax_shapes():
    assert mesh_lib.make_production_mesh().shape == {"data": 16,
                                                     "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).sizes == \
        (2, 16, 16)
    assert mesh_lib.make_mesh_2d_tp(multi_pod=True).axis_names == \
        ("pod", "data", "model_a", "model_b")
    for cfg in (base.MeshConfig(), base.MeshConfig(multi_pod=True),
                base.MeshConfig(data_axis=1, model_axis=1)):
        m = mesh_lib.make_mesh(cfg)
        j_cfg = j_base.MeshConfig(**{f: getattr(cfg, f) for f in (
            "multi_pod", "data_axis", "model_axis", "pod_axis")})
        assert m.axis_names == tuple(j_cfg.axis_names)
        assert m.sizes == tuple(j_cfg.shape)
    assert mesh_lib.make_data_mesh(1, "cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match=r"spmd mesh needs 1\.\.1 devices, "
                       r"got 2"):
        mesh_lib.make_data_mesh(2, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh().device_mesh("cpu")
    assert mesh_lib.make_rules(mesh_lib.make_production_mesh()).table[
        "batch"] == ("data",)


def test_input_shapes_equal_jax():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in base.INPUT_SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in j_base.INPUT_SHAPES.items()}
    assert registry.ASSIGNED == j_registry.ASSIGNED


def test_use_rules_nests_and_is_thread_local():
    outer, inner = _rules(), _rules((4, 4))
    assert get_rules() is None
    seen = {}

    def other():
        seen["other"] = get_rules()
        with use_rules(inner):
            seen["other_inner"] = get_rules()

    with use_rules(outer):
        assert get_rules() is outer
        with use_rules(inner):
            assert get_rules() is inner
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            assert get_rules() is inner
        assert get_rules() is outer
        with pytest.raises(RuntimeError):
            with use_rules(inner):
                raise RuntimeError
        assert get_rules() is outer
    assert get_rules() is None
    assert seen == {"other": None, "other_inner": inner}


def test_jax_rules_accept_the_port_mesh():
    """The port's Mesh has what JAX's Rules read (``axis_names`` and a
    ``shape`` dict): one mesh object resolves in both packages alike."""
    m = mesh_lib.make_production_mesh(multi_pod=True)
    logical, shp = ("batch", None, "kv_heads", "head_dim"), (256, 9, 8, 128)
    assert tuple(j_rules.Rules(m).spec(logical, shp)) == \
        Rules(m).spec(logical, shp)
    assert np.prod(m.sizes) == m.size == 512
