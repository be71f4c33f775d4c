"""The port's MoE backbones granite-moe-1b-a400m and olmoe-1b-7b against
the JAX package: their config modules and specs (the published widths'
parameter counts included), the router, the capacity dispatch with and
without dropped tokens, prefill and decode (t = 1, the whole batch one
dispatch row), the literal per-token computation at a capacity that
drops nothing, the smoke slices' ``apply_prefill`` then four
``apply_decode`` steps with their aux losses, the decode cache, the
weights bridge on the stacked 4-D expert kernels, and the ``serve`` CLI
end to end on the CPU.

Weights are drawn with numpy at the JAX spec tree's shapes and carried to
the port by ``from_jax``; inputs come from numpy seeds. The JAX model
functions reach no Pallas kernel (their attention is the dense path and
their experts are einsums), so they are called directly. Tolerances:
float32 at 1e-5; bf16 at the tolerance ``test_torch_serve.py`` states
for it.
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
from repro.models import moe as j_moe
from repro.models import transformer as j_tfm

from repro_torch import params as P
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.launch import serve as serve_lib
from repro_torch.models import backbone as bb
from repro_torch.models import common, moe, transformer

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 18
TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["granite-moe-1b-a400m", "olmoe-1b-7b"]
# the published widths' parameter counts with 18 actions (f32, as served)
FULL_PARAMS = {"granite-moe-1b-a400m": 1_334_647_827,
               "olmoe-1b-7b": 6_816_112_659}


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def _close_tree(want, got, **tol):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        _close(w[key], g[key], **tol)


def _cfgs(arch, dtype="float32", capacity_factor=None):
    j_cfg, t_cfg = j_smoke(arch), get_smoke_config(arch)
    if capacity_factor is not None:
        j_cfg = j_cfg.replace(moe=dataclasses.replace(
            j_cfg.moe, capacity_factor=capacity_factor))
        t_cfg = t_cfg.replace(moe=dataclasses.replace(
            t_cfg.moe, capacity_factor=capacity_factor))
    return j_cfg.replace(dtype=dtype), t_cfg.replace(dtype=dtype)


def _moe_params(j_cfg, seed):
    p = spec_params(j_moe.moe_specs(j_cfg), seed)
    return p, P.from_jax(p, requires_grad=False)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _spec_table(specs):
    return {k: (tuple(s.shape), s.init, s.scale)
            for k, s in P.flatten(specs).items()}


# ---------------------------------------------------------------------------
# configs, specs and the weights bridge


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_jax_modules(arch):
    """Every field the port's ArchConfig has equals the JAX module's, at
    full width and in the smoke config; ``moe`` field by field (the two
    packages' MoEConfig classes differ)."""
    for j_cfg, t_cfg in ((j_get_config(arch), get_config(arch)),
                         (j_smoke(arch), get_smoke_config(arch))):
        for field in t_cfg.__dataclass_fields__:
            if field != "moe":
                assert getattr(t_cfg, field) == getattr(j_cfg, field), field
        assert dataclasses.asdict(t_cfg.moe) == \
            dataclasses.asdict(j_cfg.moe)
    assert get_config(arch).source == j_get_config(arch).source != ""


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_at_smoke_and_published_widths(arch):
    for j_cfg, t_cfg in ((j_smoke(arch), get_smoke_config(arch)),
                         (j_get_config(arch), get_config(arch))):
        j_specs = j_bb.backbone_specs(j_cfg, A)
        t_specs = bb.backbone_specs(t_cfg, A)
        assert _spec_table(t_specs) == _spec_table(j_specs)
        assert common.param_count(t_specs) == j_common.param_count(j_specs)
        assert transformer.layer_plan(t_cfg) == j_tfm.layer_plan(j_cfg) == \
            (["moe"], [])
    assert common.param_count(bb.backbone_specs(get_config(arch), A)) == \
        FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_the_stacked_expert_kernels(arch):
    """The stacked expert kernels are 4-D, (groups, E, d, ff): the bridge
    keeps their layout (no conv permutation) both ways."""
    j_cfg = j_smoke(arch)
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_cfg, A), jax.random.key(1)))
    flat = P.flatten(tree)
    e, d, ff = j_cfg.moe.num_experts, j_cfg.d_model, j_cfg.d_ff
    assert flat["stack/scan/l0/ffn/up/kernel"].shape == (2, e, d, ff)
    assert flat["stack/scan/l0/ffn/gate/kernel"].shape == (2, e, d, ff)
    assert flat["stack/scan/l0/ffn/down/kernel"].shape == (2, e, ff, d)
    assert flat["stack/scan/l0/ffn/router/kernel"].shape == (2, d, e)
    port = P.from_jax(tree, requires_grad=False)
    for key, t in P.flatten(port).items():
        assert tuple(t.shape) == flat[key].shape, key
        np.testing.assert_array_equal(t.numpy(), flat[key])
    back = P.flatten(P.to_jax(port))
    assert sorted(back) == sorted(flat)
    for key, x in flat.items():
        np.testing.assert_array_equal(back[key], x)


# ---------------------------------------------------------------------------
# the router and the dispatch


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _moe_params(j_cfg, 0)
    x = _normal((3, 11, j_cfg.d_model), 1)
    gates, idx, aux = j_moe.route(jp, jnp.asarray(x), j_cfg)
    t_gates, t_idx, t_aux = moe.route(tp, torch.from_numpy(x), t_cfg)
    np.testing.assert_array_equal(np.asarray(idx), t_idx.numpy())
    _close(gates, t_gates)
    _close(aux, t_aux)
    assert t_aux.dtype == torch.float32 and t_aux.dim() == 0


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("t", [12, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, t, capacity_factor):
    """Prefill (t = 12, a row a sequence) and decode (t = 1, the batch one
    row with twice the capacity), at the default capacity and at 0.25,
    where tokens are dropped."""
    j_cfg, t_cfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _moe_params(j_cfg, 2)
    b = 16
    x = _normal((b, t, j_cfg.d_model), 3)
    want, want_aux = j_moe.apply_moe(jp, jnp.asarray(x), j_cfg)
    got, got_aux = moe.apply_moe(tp, torch.from_numpy(x), t_cfg)
    assert got.shape == (b, t, j_cfg.d_model)
    _close(want, got)
    _close(want_aux, got_aux)
    if capacity_factor == 0.25:
        # tokens were dropped: an expert got more pairs than its capacity
        rows = torch.from_numpy(x).reshape(-1 if t > 1 else 1,
                                           t if t > 1 else b,
                                           j_cfg.d_model)
        cap = moe._capacity(rows.shape[1], t_cfg) * (2 if t == 1 else 1)
        _, idx, _ = moe.route(tp, rows, t_cfg)
        counts = torch.stack([
            torch.bincount(r.flatten(), minlength=t_cfg.moe.num_experts)
            for r in idx])
        assert int(counts.max()) > cap


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_equals_the_literal_per_token_loop(arch):
    """With capacity >= tokens * k nothing is dropped, and the dispatch
    must equal every token through its top-k experts, gate-weighted (the
    loop of tests/test_layers.py, here in float32 at 1e-5)."""
    j_cfg, t_cfg = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _moe_params(j_cfg, 4)
    b, t = 2, 10
    x = _normal((b, t, j_cfg.d_model), 5)
    y, aux = moe.apply_moe(tp, torch.from_numpy(x), t_cfg)
    gates, idx, _ = moe.route(tp, torch.from_numpy(x), t_cfg)
    up, gate_w, down = (torch.from_numpy(jp[n]["kernel"])
                        for n in ("up", "gate", "down"))
    y_ref = torch.zeros(b, t, j_cfg.d_model)
    for bi in range(b):
        for ti in range(t):
            xt = torch.from_numpy(x[bi, ti])
            for ki in range(t_cfg.moe.num_experts_per_tok):
                e = int(idx[bi, ti, ki])
                h = torch.nn.functional.silu(xt @ gate_w[e]) * (xt @ up[e])
                y_ref[bi, ti] += gates[bi, ti, ki] * (h @ down[e])
    torch.testing.assert_close(y, y_ref, **TOL)
    want, _ = j_moe.apply_moe(jp, jnp.asarray(x), j_cfg)
    _close(want, y)
    assert float(aux) > 0


def test_capacity_follows_the_reference_rule():
    cfg = get_smoke_config("olmoe-1b-7b")     # 4 experts, top-2
    assert moe._capacity(12, cfg) == int(12 * 2 / 4 * 1.25)
    assert moe._capacity(1, cfg) == 2         # never below k
    full = get_config("olmoe-1b-7b")          # 64 experts, top-8
    assert moe._capacity(128, full) == 20     # a prefill row at ctx 128
    assert 2 * moe._capacity(16, full) == 16  # a decode row of batch 16


# ---------------------------------------------------------------------------
# prefill and decode against JAX


def _setup(arch, seed, dtype="float32"):
    j_cfg, t_cfg = _cfgs(arch, dtype)
    p = spec_params(j_bb.backbone_specs(j_cfg, A), seed)
    return j_cfg, t_cfg, p, P.from_jax(p, requires_grad=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax_f32(arch):
    """Prefill a context of 8, then decode 4 steps through the prefill's
    own cache, as the server does; the aux loss (the routers' summed
    load-balancing loss) at every call."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 6)
    b, t = 3, 8
    toks = _tokens(b, t, j_cfg.vocab_size, 7)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    _close(want.policy_logits, got.policy_logits)
    _close(want.values, got.values)
    _close(want.aux_loss, got.aux_loss)
    assert got.aux_loss.dtype == torch.float32 and float(got.aux_loss) > 0
    _close_tree(want.cache, got.cache)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(b, 4, j_cfg.vocab_size, 8)
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
        _close(want.aux_loss, got.aux_loss)
        _close_tree(j_cache, t_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax_bf16(arch):
    """bf16, the working dtype, at ``test_torch_serve.py``'s tolerance:
    the logits (~0.03) held to 1e-3 absolute."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 9, "bfloat16")
    toks = _tokens(2, 8, j_cfg.vocab_size, 10)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    assert got.policy_logits.dtype == torch.float32
    _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(2, 4, j_cfg.vocab_size, 11)
    for i in range(4):
        tok = step_toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(8 + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, 8 + i,
                              t_cfg, A)
        j_cache, t_cache = want.cache, got.cache
        _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_abstract_is_meta_and_matches_jax_shapes(arch):
    j_cfg, t_cfg = _cfgs(arch, "bfloat16")
    w = P.flatten(j_bb.cache_abstract(3, 9, j_cfg))
    g = P.flatten(bb.cache_abstract(3, 9, t_cfg))
    assert sorted(w) == sorted(g)
    for key in w:
        assert g[key].device.type == "meta"
        assert tuple(g[key].shape) == w[key].shape
        assert g[key].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the serve CLI


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_on_cpu_runs_end_to_end(arch):
    fk.reset_launch_counts()
    dk.reset_launch_counts()
    run = serve_lib.serve(["--device", "cpu", "--smoke", "--arch", arch,
                           "--requests", "3", "--batch", "2", "--ctx", "8",
                           "--decode-steps", "3"])
    assert run.arch.name == arch
    assert (run.served, run.batches, run.decode_steps) == (3, 2, 3)
    assert run.param_count == common.param_count(
        bb.backbone_specs(run.arch, A))
    for lg in run.first_batch["logits"]:
        assert lg.shape == (2, 1, A) and bool(torch.isfinite(lg).all())
    # the CPU took the plain versions: no kernel launched
    assert fk.flash_attention.launches == 0
    assert dk.decode_attention.launches == 0
