"""The mixed-precision learner step (bf16 live params, an f32 master in
the optimizer state) against the JAX package's, ``common.cast``,
``opt_state_specs``, and the conv agents on bf16 params.

Weights are drawn with numpy at the JAX spec tree's shapes
(``spec_params``), carried over by ``from_jax`` and cast to bf16 on both
sides; batches come from numpy seeds. JAX's mixed step runs jitted on its
CPU routes (the ``scan`` V-trace, dense or chunked attention: no Pallas
kernel). Tolerances: loss and metrics at 1e-5 in float32 compute (bf16
weights, f32 activations); the new master within one bf16 ulp (2^-7
relative) of each element's update, since a bf16 gradient may round to
the other neighbour where the two f32 backwards differ by an f32 ulp,
plus an f32 ulp of the master; the config's own bf16 compute at 5e-3.

The JAX package is imported inside the tests that use it, so that the
card, which has no jax, can collect this file and run its ``cuda`` case:
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_mixed_precision.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import learner
from repro_torch.kernels import linear_scan as lk
from repro_torch.kernels import vtrace as vk
from repro_torch.models import backbone as bb
from repro_torch.models import common
from repro_torch.optim import optimizer as opt_lib

torch.set_num_threads(1)

A = 3
CONV_HW = (10, 5, 3)
FAMILIES = ["impala-shallow", "stablelm-1.6b", "mamba2-1.3b",
            "recurrentgemma-2b", "granite-moe-1b-a400m", "whisper-small"]
METRICS = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=5e-3, rtol=5e-3)


def _j():
    """The JAX package's modules these tests compare with."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ImpalaConfig as JaxImpalaConfig
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.core import learner as j_learner
    from repro.models import backbone as j_bb
    from repro.models import common as j_common
    return jax, jnp, JaxImpalaConfig, j_smoke, j_learner, j_bb, j_common


def _port_config(arch, dtype="float32"):
    """``arch``'s smoke config in ``dtype`` compute; the conv agents on a
    small frame."""
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    if cfg.family == "impala_cnn":
        cfg = cfg.replace(image_hw=CONV_HW)
    return cfg


def _configs(arch, dtype="float32"):
    """(JAX config, port config) of ``_port_config``'s settings."""
    j_cfg = _j()[3](arch).replace(dtype=dtype)
    if j_cfg.family == "impala_cnn":
        j_cfg = j_cfg.replace(image_hw=CONV_HW)
    return j_cfg, _port_config(arch, dtype)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """numpy weights at the JAX spec tree's shapes, drawn once an arch."""
    from test_torch_attention import spec_params
    j_bb = _j()[5]
    return spec_params(j_bb.backbone_specs(_configs(arch)[0], A), 0)


def _token_batch(cfg, seed, b=2, t=9):
    """``tests/test_torch_token_train.py``'s learner batch, drawn from the
    port's config (the card has no jax to import that file with)."""
    rng = np.random.default_rng(seed)
    batch = {
        "obs_token": rng.integers(0, cfg.vocab_size,
                                  (b, t + 1)).astype(np.int32),
        "actions": rng.integers(0, A, (b, t)).astype(np.int32),
        "rewards": rng.standard_normal((b, t)).astype(np.float32),
        "discounts": (0.99 * (rng.uniform(size=(b, t)) > 0.1)
                      ).astype(np.float32),
        "behaviour_logprob": -rng.uniform(0.5, 1.5, (b, t)
                                          ).astype(np.float32),
    }
    key = {"vlm": "image_embed", "audio": "enc_embed"}.get(cfg.family)
    if key:
        batch[key] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _batch(arch, seed):
    """A seeded learner batch: the conv agents' frames, LSTM state and
    resets, or tokens with the stub frontend's embeddings."""
    cfg = get_smoke_config(arch)
    if cfg.family != "impala_cnn":
        return _token_batch(cfg, seed)
    from test_torch_learner import _fixed_batch
    batch = _fixed_batch(2, 5, CONV_HW, A, cfg.lstm_width, seed)
    del batch["done"]
    return batch


def _torch_batch(batch):
    return {k: (tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
                else torch.from_numpy(v)) for k, v in batch.items()}


def _impala(lr=1e-3, momentum=0.0):
    """(JAX, port) ``ImpalaConfig`` of the same settings; the port's alone
    where jax is not installed."""
    kw = dict(num_actions=A, unroll_length=9, learning_rate=lr,
              rmsprop_momentum=momentum)
    try:
        j_ic = _j()[2](**kw)
    except ImportError:
        j_ic = None
    return j_ic, ImpalaConfig(**kw)


def _f32(x):
    return np.asarray(x.detach().to("cpu", torch.float32)
                      if torch.is_tensor(x) else x, np.float32)


def _jax_mixed_step(arch, dtype="float32"):
    """JAX's jitted mixed step from the f32 params: (metrics, new master,
    new live params), as numpy trees."""
    jax, jnp, _, _, j_learner, _, j_common = _j()
    j_cfg = _configs(arch, dtype)[0]
    p = _params(arch)
    step, opt = j_learner.build_train_step(j_cfg, _impala()[0], A,
                                           vtrace_impl="scan",
                                           mixed_precision=True)
    master = jax.tree.map(jnp.asarray, p)
    live, state, metrics = jax.jit(step)(
        j_common.cast(master, jnp.bfloat16),
        {"opt": opt.init(master), "master": master}, jnp.int32(0),
        jax.tree.map(jnp.asarray, _batch(arch, 13)))
    return (jax.device_get(metrics), jax.device_get(state["master"]),
            jax.device_get(live))


def _port_mixed_step(arch, dtype="float32", device="cpu", tree=None,
                     **kw):
    """The port's mixed step from the f32 JAX-layout ``tree`` (``_params``
    unless given) on ``_batch(arch, 13)``: (metrics, master, live, the
    master before the step)."""
    t_cfg = _port_config(arch, dtype)
    step, opt = learner.build_train_step(t_cfg, _impala()[1], A,
                                         mixed_precision=True, **kw)
    master = P.from_jax(_params(arch) if tree is None else tree, device)
    before = P.snapshot(master)
    live = common.cast(master, torch.bfloat16)
    batch = {k: (tuple(x.to(device) for x in v) if isinstance(v, tuple)
                 else v.to(device))
             for k, v in _torch_batch(_batch(arch, 13)).items()}
    live, state, metrics = step(
        live, {"opt": opt.init(master), "master": master}, 0, batch)
    return metrics, state["master"], live, before


def _check_live_is_bf16_master(live, master):
    master = P.flatten(master)
    for name, p in P.flatten(live).items():
        m = master[name]
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32, name
        assert torch.equal(p, m.to(torch.bfloat16)), name


def _check_master(want, got, before, rel=2.0 ** -7):
    """Each element of the new master within ``rel`` of its update (the
    reference's new master less the old), plus two f32 ulps of its size."""
    want, got, before = (P.flatten(t) for t in (want, got, before))
    assert sorted(want) == sorted(got)
    for name in want:
        w, g, b = _f32(want[name]), _f32(got[name]), _f32(before[name])
        tol = rel * np.abs(w - b) + 2.0 ** -22 * np.abs(w) + 1e-12
        bad = np.abs(g - w) > tol
        assert not bad.any(), (name, float(np.abs(g - w).max()),
                               int(bad.sum()))


# ---------------------------------------------------------------------------
# cast, opt_state_specs


def test_cast_matches_jax_on_float_and_int_leaves():
    """Floating leaves cast (bf16 and back to f32), the others the same
    objects; a cast leaf keeps requires_grad and is never an alias."""
    jax, jnp, *_, j_common = _j()
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"x": rng.standard_normal(5).astype(np.float32),
                  "step": np.arange(3, dtype=np.int32)}}
    t_tree = {"w": torch.from_numpy(tree["w"]).requires_grad_(True),
              "b": {"x": torch.from_numpy(tree["b"]["x"]),
                    "step": torch.from_numpy(tree["b"]["step"])}}
    for j_dtype, t_dtype in ((jnp.bfloat16, torch.bfloat16),
                             (jnp.float32, torch.float32)):
        want = P.flatten(jax.device_get(j_common.cast(
            jax.tree.map(jnp.asarray, tree), j_dtype)))
        got = common.cast(t_tree, t_dtype)
        flat = P.flatten(got)
        assert sorted(flat) == sorted(want)
        for name, w in want.items():
            g = flat[name]
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            np.testing.assert_array_equal(_f32(w), _f32(g), err_msg=name)
        assert got["b"]["step"] is t_tree["b"]["step"]
        assert got["w"].requires_grad and not got["b"]["x"].requires_grad
        assert got["w"].data_ptr() != t_tree["w"].data_ptr()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_opt_state_specs_mirror_jax(momentum, mixed):
    """The same tree of the same spec leaves as JAX's, over the stablelm
    smoke config's spec tree."""
    _, _, j_ic, _, j_learner, j_bb, _ = _j()
    specs = j_bb.backbone_specs(_configs("stablelm-1.6b")[0], A)
    j_cfg, t_cfg = _impala(momentum=momentum)
    want = j_learner.opt_state_specs(specs, j_cfg, mixed_precision=mixed)
    got = learner.opt_state_specs(specs, t_cfg, mixed_precision=mixed)
    assert set(got) == ({"opt", "master"} if mixed else set(want))
    flat_want, flat_got = P.flatten(want), P.flatten(got)
    assert sorted(flat_want) == sorted(flat_got)
    assert all(flat_got[k] is flat_want[k] for k in flat_want)


# ---------------------------------------------------------------------------
# the conv agents on bf16 params


@pytest.mark.parametrize("arch", ["impala-shallow", "impala-deep"])
def test_conv_agents_on_bf16_params_match_jax(arch):
    """``apply_train`` with every floating leaf bf16: the conv casts its
    kernel and bias to the frames' dtype, as JAX's ``_conv`` does (the
    port raised a dtype error here before)."""
    jax, jnp, *_, j_bb, j_common = _j()
    j_cfg, t_cfg = _configs(arch)
    batch = _batch(arch, 21)
    model = {"image": batch["obs_image"], "last_action":
             batch["last_action"], "last_reward": batch["last_reward"],
             "done": batch["done_in"], "lstm_state": batch["lstm_state"]}
    p = _params(arch)
    want = jax.jit(lambda p_, b_: j_bb.apply_train(p_, b_, j_cfg, A))(
        j_common.cast(jax.tree.map(jnp.asarray, p), jnp.bfloat16),
        jax.tree.map(jnp.asarray, model))
    got = bb.apply_train(common.cast(P.from_jax(p), torch.bfloat16),
                         _torch_batch(model), t_cfg, A)
    for w, g in ((want.policy_logits, got.policy_logits),
                 (want.values, got.values)):
        np.testing.assert_allclose(_f32(w), _f32(g), **METRICS)


# ---------------------------------------------------------------------------
# the mixed step


@pytest.mark.parametrize("arch", FAMILIES)
def test_mixed_step_matches_jax(arch):
    """Loss and metrics at 1e-5, the master within a bf16 ulp of its
    update, and live == bf16(master) on both sides (bf16 weights, f32
    compute)."""
    j_metrics, j_master, j_live = _jax_mixed_step(arch)
    metrics, master, live, before = _port_mixed_step(arch,
                                                     vtrace_impl="scan")
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(np.asarray(v), float(metrics[k]),
                                   err_msg=k, **METRICS)
    j_master = P.from_jax(j_master, requires_grad=False)
    _check_master(j_master, master, before)
    _check_live_is_bf16_master(live, master)
    j_live = P.flatten(P.from_jax(j_live))
    for name, m in P.flatten(j_master).items():
        assert torch.equal(j_live[name], m.to(torch.bfloat16)), name


def test_mixed_step_in_bf16_compute_matches_jax():
    """stablelm's smoke config in its own bf16 compute: loss and metrics
    at 5e-3; each leaf's update within 2^-5 of its norm, since its
    gradient went through a bf16 rounding (2^-8 relative) at each of the
    backward's products and casts, in other orders on each side (1.5e-2
    at most seen)."""
    arch = "stablelm-1.6b"
    j_metrics, j_master, _ = _jax_mixed_step(arch, "bfloat16")
    metrics, master, live, before = _port_mixed_step(
        arch, "bfloat16", vtrace_impl="scan")
    for k, v in j_metrics.items():
        np.testing.assert_allclose(np.asarray(v), float(metrics[k]),
                                   err_msg=k, **BF16)
    got, old = P.flatten(master), P.flatten(before)
    for name, w in P.flatten(P.from_jax(j_master)).items():
        want_upd = _f32(w) - _f32(old[name])
        got_upd = _f32(got[name]) - _f32(old[name])
        assert np.linalg.norm(got_upd - want_upd) <= \
            2.0 ** -5 * np.linalg.norm(want_upd), name
    _check_live_is_bf16_master(live, master)


def test_mixed_loss_is_within_005_of_the_f32_step():
    """``tests/test_core.py``'s check, in the port: stablelm's smoke
    config, the mixed step's loss within 0.05 of the f32 step's, the
    live leaves bf16 and the master f32."""
    t_cfg = get_smoke_config("stablelm-1.6b")
    _, ic = _impala()
    batch = _torch_batch(_batch("stablelm-1.6b", 13))
    step32, o32 = learner.build_train_step(t_cfg, ic, A)
    p32 = P.from_jax(_params("stablelm-1.6b"))
    _, _, m32 = step32(p32, o32.init(p32), 0, batch)
    step, opt = learner.build_train_step(t_cfg, ic, A, mixed_precision=True)
    master = P.from_jax(_params("stablelm-1.6b"))
    live, state, metrics = step(common.cast(master, torch.bfloat16),
                                {"opt": opt.init(master), "master": master},
                                0, batch)
    assert abs(float(m32["loss/total"]) - float(metrics["loss/total"])) \
        < 0.05
    assert all(x.dtype == torch.bfloat16 for x in P.tree_leaves(live))
    assert all(x.dtype == torch.float32
               for x in P.tree_leaves(state["master"]))


def _treewise_apply(ic, opt, params, state, step, grads):
    """The learner's apply written a whole tree at a time, from the
    optimizer library: the clip by the global norm, the optimizer's
    update of the tree, ``apply_updates``."""
    lr = opt_lib.linear_schedule(ic.learning_rate, 0.0,
                                 ic.lr_anneal_steps)(step)
    grads, norm = opt_lib.clip_by_global_norm(
        P.tree_unflatten_like(params, grads), ic.grad_clip_norm)
    updates, state = opt.update(grads, state, params, lr)
    return (opt_lib.apply_updates(params, updates), state,
            {"opt/grad_norm": norm, "opt/lr": lr})


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_leafwise_apply_is_the_treewise_apply_bit_for_bit(momentum, mixed):
    """Fed the same f32 gradients, the learner's leaf-wise ``_apply_fn``
    leaves the master (the params themselves where not ``mixed``), the
    optimizer's state and the metrics exactly where the tree-wise apply
    leaves an f32 tree, over two steps (the clip active in the first
    only), each gradient dropped from the list once used, and the live
    leaves at bf16 of the master."""
    rng = np.random.default_rng(3)
    shapes = {"a": {"k": (6, 4), "b": (4,)}, "c": (3, 5, 2), "d": (7,)}

    def draw(tree, scale=1.0):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        return torch.from_numpy(
            (scale * rng.standard_normal(tree)).astype(np.float32))

    init = draw(shapes)
    ic = ImpalaConfig(num_actions=A, learning_rate=1e-2, grad_clip_norm=2.0,
                      rmsprop_momentum=momentum)
    opt = learner._optimizer(ic, None)
    leaf_apply = learner._apply_fn(ic, opt, mixed)
    ref = P.snapshot(init)
    ref_state = opt.init(ref)
    master = P.snapshot(init)
    if mixed:
        live = common.cast(master, torch.bfloat16)
        state = {"opt": opt.init(master), "master": master}
    else:
        live, state = master, opt.init(master)
    norms = []
    for step, scale in ((0, 5.0), (1, 0.01)):
        grads = P.tree_leaves(draw(shapes, scale))
        ref, ref_state, want = _treewise_apply(ic, opt, ref, ref_state, step,
                                               [g.clone() for g in grads])
        live, state, got = leaf_apply(live, state, step, grads)
        assert torch.equal(want["opt/grad_norm"], got["opt/grad_norm"])
        assert want["opt/lr"] == got["opt/lr"]
        for w, g in zip(P.tree_leaves(ref), P.tree_leaves(master)):
            assert torch.equal(w, g)
        for w, g in zip(P.tree_leaves(ref_state),
                        P.tree_leaves(state["opt"] if mixed else state)):
            assert torch.equal(w, g)
        assert grads == [None] * len(grads)
        norms.append(float(got["opt/grad_norm"]))
    assert norms[0] > ic.grad_clip_norm > norms[1]
    if mixed:
        _check_live_is_bf16_master(live, master)


@pytest.mark.parametrize("build,kw", [
    ("build_train_step", dict(mixed_precision=True)),
    ("build_train_step", dict()),
    ("build_grad_apply_steps", dict()),
    ("build_replay_train_step", dict())])
def test_an_optimizer_whose_state_is_not_a_mirror_is_refused(build, kw):
    """The learner applies the optimizer one leaf at a time, so each step
    builder refuses, when built, an optimizer whose state does not mirror
    the params: Adam's step count ``t`` is one scalar. JAX's builders take
    it (a difference by design, ROADMAP.md Queue 3)."""
    with pytest.raises(ValueError, match=r"mirror the params.*\['t'\]"):
        getattr(learner, build)(_port_config("impala-shallow"), _impala()[1],
                                A, optimizer=opt_lib.adam(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,k3", [("stablelm-1.6b", 0),
                                     ("mamba2-1.3b", 2 * 2)])
def test_mixed_step_kernel_route_matches_plain_on_the_card(arch, k3):
    """The mixed step on the card at smoke size, the kernel route (K2,
    and K3 forward and backward in mamba2's layers) against the plain
    route (the reverse loop, ``impl='ref'``): loss and metrics at 1e-5,
    the master within a bf16 ulp of its update, live == bf16(master)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = common.init_params(bb.backbone_specs(_port_config(arch), A), 0)
    vk.reset_launch_counts()
    lk.reset_launch_counts()
    got = _port_mixed_step(arch, device="cuda", tree=tree)
    assert (vk.loss_vtrace.launches, lk.linear_scan.launches) == (1, k3)
    want = _port_mixed_step(arch, device="cuda", tree=tree,
                            vtrace_impl="scan", impl="ref")
    for k, v in want[0].items():
        np.testing.assert_allclose(float(v), float(got[0][k]), err_msg=k,
                                   **METRICS)
    _check_master(want[1], got[1], got[3])
    _check_live_is_bf16_master(got[2], got[1])
