"""The port's RG-LRU hybrid (recurrentgemma-2b) against the JAX package:
``rglru_core`` (its recurrence one ``ops.linear_scan`` over (T, B*W))
and ``rglru_core_step``, ``apply_rglru``'s prefill and decode states,
the hybrid stack with its unrolled ``tail<i>`` blocks, prefill then
decode past the local window's ring wrap, ``cache_abstract``, and the
``serve`` CLI end to end on the CPU.

Inputs are drawn with numpy from seeds and handed to both packages;
weights are drawn with numpy at the JAX spec tree's shapes and carried
to the port by ``from_jax``. The JAX model functions reach no Pallas
kernel, so they are called directly. Tolerances: float32 at 1e-5, and
1e-4 for a scan over more than one of the JAX package's 256-step chunks
(its sums are taken in another order), as ``tests/test_kernels.py``
holds its long scans.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.models import rglru as j_rglru
from repro.models import transformer as j_tfm

from repro_torch import params as P
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import linear_scan as lk
from repro_torch.launch import serve as serve_lib
from repro_torch.models import backbone as bb
from repro_torch.models import common, rglru, transformer

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 18
ARCH = "recurrentgemma-2b"
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_CHUNKS = dict(atol=1e-4, rtol=1e-4)
# five layers: one group of (recurrent, recurrent, local) and a tail of
# two recurrent blocks, as the published 26 layers leave two
TAIL_LAYERS = 5


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def _close_tree(want, got, **tol):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        _close(w[key], g[key], **tol)


def _cfgs(dtype="float32", **kw):
    return (j_smoke(ARCH).replace(dtype=dtype, **kw),
            get_smoke_config(ARCH).replace(dtype=dtype, **kw))


def _setup(seed=0, dtype="float32", **kw):
    j_cfg, t_cfg = _cfgs(dtype, **kw)
    p = spec_params(j_bb.backbone_specs(j_cfg, A), seed)
    return j_cfg, t_cfg, p, P.from_jax(p, requires_grad=False)


def _block(seed):
    """One RG-LRU block's params (JAX tree, port tree) at the smoke
    config's widths. A block's tree alone holds ``conv/kernel`` at its
    root, which the bridge takes for a torso's conv layer, so it crosses
    leaf by leaf (the whole model's tree crosses through ``from_jax``)."""
    j_cfg, t_cfg = _cfgs()
    p = spec_params(j_rglru.rglru_specs(j_cfg), seed)
    return j_cfg, t_cfg, p, P.tree_map(torch.from_numpy, p)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _spec_table(specs):
    return {k: (tuple(s.shape), s.init, s.scale)
            for k, s in P.flatten(specs).items()}


# ---------------------------------------------------------------------------
# configs, specs, the layer plan and the weights bridge


def test_config_copies_the_jax_module():
    for j_cfg, t_cfg in ((j_get_config(ARCH), get_config(ARCH)),
                         (j_smoke(ARCH), get_smoke_config(ARCH))):
        for field in t_cfg.__dataclass_fields__:
            want, got = getattr(j_cfg, field), getattr(t_cfg, field)
            if field == "rglru":          # each package's own RGLRUConfig
                want, got = dataclasses.asdict(want), dataclasses.asdict(got)
            assert got == want, field
    assert get_config(ARCH).source == "arXiv:2402.19427"


@pytest.mark.parametrize("layers", [None, TAIL_LAYERS, 26])
def test_specs_and_layer_plan_match_jax(layers):
    """The smoke config (3 layers: one group, no tail), 5 layers (a tail
    of two) and the published config (8 groups and a tail of two)."""
    j_cfg, t_cfg = (j_get_config(ARCH), get_config(ARCH)) if layers == 26 \
        else _cfgs()
    if layers is not None:
        j_cfg = j_cfg.replace(num_layers=layers)
        t_cfg = t_cfg.replace(num_layers=layers)
    plan = transformer.layer_plan(t_cfg)
    assert plan == j_tfm.layer_plan(j_cfg)
    assert plan[0] == ["recurrent", "recurrent", "local"]
    assert plan[1] == {None: [], TAIL_LAYERS: ["recurrent", "recurrent"],
                       26: ["recurrent", "recurrent"]}[layers]
    assert transformer.num_groups(t_cfg) == j_tfm.num_groups(j_cfg)
    j_specs = j_bb.backbone_specs(j_cfg, A)
    t_specs = bb.backbone_specs(t_cfg, A)
    assert _spec_table(t_specs) == _spec_table(j_specs)
    assert common.param_count(t_specs) == j_common.param_count(j_specs)
    if layers == 26:
        assert transformer.num_groups(t_cfg) == 8
        assert common.param_count(t_specs) == 2_894_622_739


def test_rglru_leaf_names_match_jax():
    j_cfg, t_cfg = _cfgs()
    assert sorted(P.flatten(rglru.rglru_specs(t_cfg))) == \
        sorted(P.flatten(j_rglru.rglru_specs(j_cfg)))
    assert set(rglru.rglru_specs(t_cfg)) == {
        "in_gate", "in_rec", "conv", "gate_a", "gate_x", "lam", "out"}


def test_bridge_round_trips_the_tail_and_conv_leaves():
    j_cfg = j_smoke(ARCH).replace(num_layers=TAIL_LAYERS)
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_cfg, A), jax.random.key(2)))
    flat = P.flatten(tree)
    assert flat["stack/tail0/rglru/conv/kernel"].shape == (4, 128)
    assert flat["stack/tail1/rglru/gate_a/kernel"].shape == (128, 128)
    assert flat["stack/scan/l2/attn/q/kernel"].shape == (1, 128, 2, 64)
    port = P.from_jax(tree, requires_grad=False)
    for key, t in P.flatten(port).items():
        assert tuple(t.shape) == flat[key].shape, key
        np.testing.assert_array_equal(t.numpy(), flat[key])
    back = P.flatten(P.to_jax(port))
    assert sorted(back) == sorted(flat)
    for key, x in flat.items():
        np.testing.assert_array_equal(back[key], x)


# ---------------------------------------------------------------------------
# the recurrence


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_core_matches_jax_across_chunks(with_h0):
    """(B, T, W) = (2, 300, 128): more than one of the JAX scan's 256-step
    chunks."""
    _, _, jp, tp = _block(3)
    u = _normal((2, 300, 128), 4)
    h0 = _normal((2, 128), 5) if with_h0 else None
    want_h, want_f = j_rglru.rglru_core(
        jp, jnp.asarray(u), None if h0 is None else jnp.asarray(h0))
    got_h, got_f = rglru.rglru_core(
        tp, torch.from_numpy(u), None if h0 is None else torch.from_numpy(h0))
    assert got_h.shape == (2, 300, 128) and got_f.shape == (2, 128)
    _close(want_h, got_h, **TOL_CHUNKS)
    _close(want_f, got_f, **TOL_CHUNKS)
    np.testing.assert_array_equal(got_h[:, -1].numpy(), got_f.numpy())


def test_rglru_core_takes_the_kernel_route_and_the_plain_route_alike():
    """On CPU tensors K3's wrapper (``impl='pallas'``) runs its plain
    version, uncounted: the same numbers as the oracle's route."""
    _, _, _, tp = _block(6)
    u = torch.from_numpy(_normal((2, 20, 128), 7))
    lk.reset_launch_counts()
    h1, f1 = rglru.rglru_core(tp, u, impl="pallas")
    h2, f2 = rglru.rglru_core(tp, u, impl="ref")
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    assert lk.linear_scan.launches == 0


def test_rglru_core_step_matches_jax():
    _, _, jp, tp = _block(8)
    u, h = _normal((3, 128), 9), _normal((3, 128), 10)
    want_y, want_h = j_rglru.rglru_core_step(jp, jnp.asarray(u),
                                             jnp.asarray(h))
    got_y, got_h = rglru.rglru_core_step(tp, torch.from_numpy(u),
                                         torch.from_numpy(h))
    _close(want_y, got_y)
    _close(want_h, got_h)


@pytest.mark.parametrize("t", [1, 2, 3, 12])
def test_apply_rglru_prefill_and_decode_states_match_jax(t):
    """Prefill's output and state, the conv state the last conv_width - 1
    rows of in_rec(x) before the conv, left-padded when T is shorter
    (T = 1, 2); then three decode steps through that state, written in
    place."""
    j_cfg, t_cfg, jp, tp = _block(11)
    x = _normal((2, t, 128), 12)
    want_y, want_s = j_rglru.apply_rglru(jp, jnp.asarray(x), j_cfg,
                                         mode="prefill")
    got_y, got_s = rglru.apply_rglru(tp, torch.from_numpy(x), t_cfg,
                                     mode="prefill")
    _close(want_y, got_y)
    _close_tree(want_s, got_s)
    assert tuple(got_s["conv"].shape) == (2, 3, 128)
    if t < 3:
        assert not bool(got_s["conv"][:, :3 - t].any())
    state = got_s
    for i in range(3):
        xs = _normal((2, 1, 128), 13 + i)
        want_y, want_s = j_rglru.apply_rglru(jp, jnp.asarray(xs), j_cfg,
                                             mode="decode", state=want_s)
        got_y, got = rglru.apply_rglru(tp, torch.from_numpy(xs), t_cfg,
                                       mode="decode", state=state)
        assert got is state
        _close(want_y, got_y)
        _close_tree(want_s, got)


def test_prefill_state_owns_its_storage():
    """h and the conv tail are copies, not views of the prefill's (T,
    B*W) states or its projections, which the cache would keep alive."""
    _, t_cfg, _, tp = _block(16)
    _, st = rglru.apply_rglru(tp, torch.from_numpy(_normal((2, 9, 128), 17)),
                              t_cfg, mode="prefill")
    for leaf in st.values():
        assert leaf.untyped_storage().nbytes() == \
            leaf.numel() * leaf.element_size()


# ---------------------------------------------------------------------------
# the hybrid stack, prefill and decode


def test_hybrid_stack_prefill_matches_jax_with_its_tail():
    j_cfg, t_cfg, jp, tp = _setup(18, num_layers=TAIL_LAYERS)
    b, t = 2, 10
    x = _normal((b, t, j_cfg.d_model), 19)
    pos = np.arange(t)[None].repeat(b, 0)
    want, want_c, want_aux = j_tfm.apply_stack(jp["stack"], jnp.asarray(x),
                                               jnp.asarray(pos), j_cfg,
                                               mode="prefill")
    got, got_c, got_aux = transformer.apply_stack(
        tp["stack"], torch.from_numpy(x), torch.from_numpy(pos), t_cfg,
        mode="prefill")
    assert float(got_aux) == float(want_aux) == 0.0     # no MoE layer
    assert sorted(got_c) == ["scan", "tail0", "tail1"]
    _close(want, got)
    _close_tree(want_c, got_c)


def test_prefill_then_decode_past_the_ring_wrap_match_jax():
    """ctx 40 under the smoke config's window of 32: the local layer's
    cache is a ring of 32 slots, and four decode steps (positions 40-43)
    write past its wrap. Logits, values and every cache, the tail's
    included, against JAX."""
    j_cfg, t_cfg, jp, tp = _setup(20, num_layers=TAIL_LAYERS)
    assert t_cfg.rglru.attention_window == 32
    b, t = 2, 40
    toks = _tokens(b, t, j_cfg.vocab_size, 21)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    assert tuple(got.cache["scan"]["l2"]["kv"]["k"].shape) == (1, b, 32, 1,
                                                                64)
    _close(want.policy_logits, got.policy_logits)
    _close(want.values, got.values)
    _close_tree(want.cache, got.cache)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(b, 4, j_cfg.vocab_size, 22)
    for i in range(4):
        tok = step_toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(t + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, t + i,
                              t_cfg, A)
        j_cache = want.cache
        assert got.cache is t_cache          # written in place
        _close(want.policy_logits, got.policy_logits)
        _close(want.values, got.values)
        _close_tree(j_cache, t_cache)


def test_prefill_then_decode_bf16_match_jax():
    """bf16 at ``test_torch_serve.py``'s tolerance for the logits (1e-3
    absolute, ~3% of their scale)."""
    j_cfg, t_cfg, jp, tp = _setup(23, "bfloat16", num_layers=TAIL_LAYERS)
    toks = _tokens(2, 40, j_cfg.vocab_size, 24)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)
    j_cache, t_cache = want.cache, got.cache
    for i in range(2):
        tok = toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(40 + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, 40 + i,
                              t_cfg, A)
        j_cache, t_cache = want.cache, got.cache
        _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)


def test_decode_from_cache_init_matches_jax():
    j_cfg, t_cfg, jp, tp = _setup(25, num_layers=TAIL_LAYERS)
    b, steps, room = 2, 4, 6
    j_cache = j_bb.cache_init(b, room, j_cfg)
    t_cache = bb.cache_init(b, room, t_cfg)
    _close_tree(j_cache, t_cache)
    toks = _tokens(b, steps, j_cfg.vocab_size, 26)
    for i in range(steps):
        tok = toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, i, t_cfg,
                              A)
        j_cache = want.cache
        _close(want.policy_logits, got.policy_logits)
    _close_tree(j_cache, t_cache)


@pytest.mark.parametrize("length", [20, 40])
def test_cache_abstract_is_meta_and_matches_jax_shapes(length):
    """The local layer's ring holds min(ctx, window) slots; the recurrent
    layers' h is float32 and their conv state in the activations'
    dtype."""
    j_cfg, t_cfg = _cfgs("bfloat16", num_layers=TAIL_LAYERS)
    w = P.flatten(j_bb.cache_abstract(3, length, j_cfg))
    g = P.flatten(bb.cache_abstract(3, length, t_cfg))
    assert sorted(w) == sorted(g)
    assert "tail1/rglru/h" in g
    for key in w:
        assert g[key].device.type == "meta"
        assert tuple(g[key].shape) == w[key].shape
        assert g[key].dtype == {"h": torch.float32}.get(
            key.rsplit("/", 1)[1], torch.bfloat16)
    assert g["scan/l2/kv/k"].shape[2] == min(length, 32)


# ---------------------------------------------------------------------------
# the serve CLI


def test_serve_recurrentgemma_smoke_on_cpu_runs_end_to_end():
    """ctx 40 past the smoke window of 32; the CPU takes every kernel's
    plain version, so nothing is launched."""
    for k in (lk, fk, dk):
        k.reset_launch_counts()
    run = serve_lib.serve(["--device", "cpu", "--smoke", "--arch", ARCH,
                           "--requests", "3", "--batch", "2", "--ctx", "40",
                           "--decode-steps", "3"])
    assert run.arch.family == "hybrid"
    assert (run.served, run.batches, run.decode_steps) == (3, 2, 3)
    for lg in run.first_batch["logits"]:
        assert lg.shape == (2, 1, A) and bool(torch.isfinite(lg).all())
    assert (lk.linear_scan.launches, fk.flash_attention.launches,
            dk.decode_attention.launches) == (0, 0, 0)
