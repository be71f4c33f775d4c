"""The port's dense configs gemma-7b, qwen1.5-4b and stablelm-1.6b against
the JAX package: their config modules and specs (the published widths'
parameter counts included), the weights bridge on their trees (gemma's
4-D q/k/v/o kernels, whose head axis H*Dh differs from d_model), the
smoke slice's ``apply_prefill`` then four ``apply_decode`` steps, its
decode cache, and the ``serve`` CLI end to end on the CPU.

Weights are drawn with numpy at the JAX spec tree's shapes and carried to
the port by ``from_jax``; tokens come from numpy seeds. The JAX model
functions reach no Pallas kernel (their attention is the dense path), so
they are called directly. Tolerances: float32 at 1e-5; bf16 at the
tolerance ``test_torch_serve.py`` states for it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.models import transformer as j_tfm

from repro_torch import params as P
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.launch import serve as serve_lib
from repro_torch.models import backbone as bb
from repro_torch.models import common, transformer

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 18
TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["gemma-7b", "qwen1.5-4b", "stablelm-1.6b"]
# the published widths' parameter counts with 18 actions (f32, as served)
FULL_PARAMS = {"gemma-7b": 8_537_739_283, "qwen1.5-4b": 3_561_461_779,
               "stablelm-1.6b": 1_439_033_363}


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def _close_tree(want, got, **tol):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        _close(w[key], g[key], **tol)


def _cfgs(arch, dtype="float32", **kw):
    return (j_smoke(arch).replace(dtype=dtype, **kw),
            get_smoke_config(arch).replace(dtype=dtype, **kw))


def _setup(arch, seed=0, dtype="float32"):
    j_cfg, t_cfg = _cfgs(arch, dtype)
    p = spec_params(j_bb.backbone_specs(j_cfg, A), seed)
    return j_cfg, t_cfg, p, P.from_jax(p, requires_grad=False)


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
    full width and in the smoke config."""
    for j_cfg, t_cfg in ((j_get_config(arch), get_config(arch)),
                         (j_smoke(arch), get_smoke_config(arch))):
        for field in t_cfg.__dataclass_fields__:
            assert getattr(t_cfg, field) == getattr(j_cfg, field), field
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
            (["attn"], [])
    assert common.param_count(bb.backbone_specs(get_config(arch), A)) == \
        FULL_PARAMS[arch]


def test_gemma_head_axis_differs_from_d_model():
    """gemma-7b's q/k/v/o kernels are 4-D with H*Dh = 4096 against
    d_model = 3072: the bridge must keep the head axes, not fold them."""
    flat = P.flatten(bb.backbone_specs(get_config("gemma-7b"), A))
    assert flat["stack/scan/l0/attn/q/kernel"].shape == (28, 3072, 16, 256)
    assert flat["stack/scan/l0/attn/o/kernel"].shape == (28, 16, 256, 3072)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_a_jax_tree(arch):
    """A JAX init tree crosses to the port and back with every shape and
    value kept. The head dim is widened so that H*Dh = 1.5 d_model, as at
    gemma's published widths, where a folded head axis would show."""
    j_cfg = j_smoke(arch)
    j_cfg = j_cfg.replace(head_dim=3 * j_cfg.d_model // (2 * j_cfg.num_heads))
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_cfg, A), jax.random.key(1)))
    flat = P.flatten(tree)
    h, dh = j_cfg.num_heads, j_cfg.head_dim
    assert flat["stack/scan/l0/attn/q/kernel"].shape == \
        (2, j_cfg.d_model, h, dh)
    assert h * dh != j_cfg.d_model
    port = P.from_jax(tree, requires_grad=False)
    for key, t in P.flatten(port).items():
        assert tuple(t.shape) == flat[key].shape, key
        np.testing.assert_array_equal(t.numpy(), flat[key])
    back = P.flatten(P.to_jax(port))
    assert sorted(back) == sorted(flat)
    for key, x in flat.items():
        np.testing.assert_array_equal(back[key], x)


# ---------------------------------------------------------------------------
# prefill and decode against JAX


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax_f32(arch):
    """Prefill a context of 8, then decode 4 steps through the prefill's
    own cache (exactly 8 slots: each step writes the last slot, the
    reference's ``min(index, S-1)`` rule), as the server does."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 1)
    b, t = 2, 8
    toks = _tokens(b, t, j_cfg.vocab_size, 2)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    _close(want.policy_logits, got.policy_logits)
    _close(want.values, got.values)
    _close_tree(want.cache, got.cache)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(b, 4, j_cfg.vocab_size, 3)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax_bf16(arch):
    """bf16, the working dtype, at ``test_torch_serve.py``'s tolerance:
    JAX's dense attention rounds scores and probabilities to bf16, the
    port's keeps them in f32 and rounds once; the logits (~0.03) are held
    to 1e-3 absolute."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 4, "bfloat16")
    toks = _tokens(2, 8, j_cfg.vocab_size, 5)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    assert got.policy_logits.dtype == torch.float32
    _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(2, 4, j_cfg.vocab_size, 6)
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
