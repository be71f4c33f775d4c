"""The port's Mamba-2 SSM path against the JAX package: the weights bridge
on SSM and RG-LRU trees, ``ssd_chunked`` (its cross-chunk pass one
``ops.linear_scan``) and ``ssd_step``, and the mamba2-1.3b smoke slice
(``apply_prefill`` then ``apply_decode``) and its ``serve`` CLI on the
CPU.

Inputs are drawn with numpy from seeds and handed to both packages;
weights are drawn with numpy at the JAX spec tree's shapes and carried to
the port by ``from_jax``. Tolerances: float32 at 1e-5 within one chunk
and 1e-4 across chunks (the chunked sums and cumulative sums are taken in
another order); bf16 at the tolerance stated beside its test.
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
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tfm

from repro_torch import params as P
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import linear_scan as lk
from repro_torch.launch import serve as serve_lib
from repro_torch.models import backbone as bb
from repro_torch.models import common, ssm, transformer

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 18
ARCH = "mamba2-1.3b"
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_CHUNKS = dict(atol=1e-4, rtol=1e-4)


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def _close_tree(want, got, **tol):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        _close(w[key], g[key], **tol)


def _cfgs(dtype="float32"):
    return (j_smoke(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


def _setup(seed=0, dtype="float32"):
    j_cfg, t_cfg = _cfgs(dtype)
    p = spec_params(j_bb.backbone_specs(j_cfg, A), seed)
    return j_cfg, t_cfg, p, P.from_jax(p, requires_grad=False)


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


# ---------------------------------------------------------------------------
# the weights bridge on SSM and RG-LRU trees


@pytest.mark.parametrize("arch,conv_key,shape", [
    ("mamba2-1.3b", "stack/scan/l0/ssm/conv/kernel", (2, 4, 288)),
    ("recurrentgemma-2b", "stack/scan/l0/rglru/conv/kernel", (1, 4, 128)),
])
def test_from_jax_keeps_ssm_and_rglru_conv_kernels(arch, conv_key, shape):
    """The SSM and RG-LRU blocks' depthwise conv kernels are (layers, W, C)
    under a segment named ``conv``, like no torso conv. A JAX smoke tree
    crosses to the port and back with every shape and value kept."""
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_smoke(arch), A), jax.random.key(0)))
    flat = P.flatten(tree)
    assert flat[conv_key].shape == shape
    port = P.from_jax(tree, requires_grad=False)
    for key, t in P.flatten(port).items():
        assert tuple(t.shape) == flat[key].shape, key
        np.testing.assert_array_equal(t.numpy(), flat[key])
    back = P.flatten(P.to_jax(port))
    assert sorted(back) == sorted(flat)
    for key, x in flat.items():
        np.testing.assert_array_equal(back[key], x)


def test_ssm_specs_match_jax_and_count_the_published_params():
    j_cfg, t_cfg = _cfgs()
    j_specs = j_bb.backbone_specs(j_cfg, A)
    t_specs = bb.backbone_specs(t_cfg, A)
    assert {k: (s.shape, s.init, s.scale)
            for k, s in P.flatten(t_specs).items()} == \
        {k: (s.shape, s.init, s.scale) for k, s in P.flatten(j_specs).items()}
    assert transformer.layer_plan(t_cfg) == j_tfm.layer_plan(j_cfg) == \
        (["ssm"], [])
    # full width and depth: the count the serving path reports
    full = common.param_count(bb.backbone_specs(get_config(ARCH), A))
    assert full == j_common.param_count(
        j_bb.backbone_specs(j_get_config(ARCH), A)) == 1_343_779_859


# ---------------------------------------------------------------------------
# SSD: chunked and step


def _ssd_inputs(bsz, t, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, t, h)))).astype(
        np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    b = rng.standard_normal((bsz, t, n)).astype(np.float32)
    c = rng.standard_normal((bsz, t, n)).astype(np.float32)
    d_skip = np.full(h, 0.5, np.float32)
    s0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return (x, dt, a_log, b, c, d_skip), s0


def _naive_ssd(x, dt, a_log, b, c, d_skip, state):
    """The literal per-step recurrence in float64."""
    a = -np.exp(np.asarray(a_log, np.float64))
    state = np.asarray(state, np.float64)
    ys = np.zeros(x.shape)
    for s in range(x.shape[1]):
        decay = np.exp(dt[:, s] * a)[:, :, None, None]
        state = decay * state + np.einsum(
            "bhp,bn->bhpn", x[:, s] * dt[:, s][:, :, None], b[:, s])
        ys[:, s] = np.einsum("bhpn,bn->bhp", state, c[:, s])
    ys += d_skip[None, None, :, None] * x
    return ys, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,chunk", [(8, 4), (17, 4), (32, 8), (5, 16)])
def test_ssd_chunked_matches_jax_and_the_recurrence(t, chunk, with_state):
    args, s0 = _ssd_inputs(2, t, 3, 4, 5, t * 10 + chunk)
    init = s0 if with_state else None
    want_y, want_s = j_ssm.ssd_chunked(
        *map(jnp.asarray, args), chunk,
        None if init is None else jnp.asarray(init))
    lk.reset_launch_counts()
    got_y, got_s = ssm.ssd_chunked(
        *map(torch.from_numpy, args), chunk,
        None if init is None else torch.from_numpy(init))
    assert lk.linear_scan.launches == 0        # the CPU took the plain loop
    tol = TOL if t <= chunk else TOL_CHUNKS
    _close(want_y, got_y, **tol)
    _close(want_s, got_s, **tol)
    lit_y, lit_s = _naive_ssd(*args, np.zeros_like(s0) if init is None
                              else init)
    _close(lit_y, got_y, **tol)
    _close(lit_s, got_s, **tol)


def test_ssd_chunked_takes_the_kernel_route_and_the_plain_route_alike():
    """``impl='pallas'`` reaches K3's wrapper (its plain loop on the CPU),
    ``impl='ref'`` the oracle: the same numbers."""
    args, s0 = _ssd_inputs(2, 37, 3, 4, 5, 1)
    targs = tuple(map(torch.from_numpy, args))
    y1, s1 = ssm.ssd_chunked(*targs, 8, torch.from_numpy(s0), impl="pallas")
    y2, s2 = ssm.ssd_chunked(*targs, 8, torch.from_numpy(s0), impl="ref")
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


def test_ssd_step_matches_jax():
    args, s0 = _ssd_inputs(2, 1, 3, 4, 5, 7)
    x, dt, a_log, b, c, d_skip = args
    step = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d_skip)
    want_y, want_s = j_ssm.ssd_step(jnp.asarray(s0),
                                    *map(jnp.asarray, step))
    got_y, got_s = ssm.ssd_step(torch.from_numpy(s0),
                                *map(torch.from_numpy, step))
    _close(want_y, got_y)
    _close(want_s, got_s)


def test_causal_conv_streaming_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    kernel = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for st in (None, state):
        want, want_st = j_ssm._causal_conv(
            *map(jnp.asarray, (x, kernel, bias)),
            None if st is None else jnp.asarray(st))
        got, got_st = ssm._causal_conv(
            *map(torch.from_numpy, (x, kernel, bias)),
            None if st is None else torch.from_numpy(st))
        _close(want, got)
        if st is not None:
            _close(want_st, got_st)


# ---------------------------------------------------------------------------
# the mamba2 smoke slice: prefill then decode, against JAX


def _prefill_decode(j_cfg, t_cfg, jp, tp, toks, steps):
    """Prefill ``toks`` then decode ``steps``, both packages; yields the
    (want, got) outputs of prefill and of each decode step."""
    b, t = toks.shape
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    yield want, got
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(b, steps, j_cfg.vocab_size, 99)
    for i in range(steps):
        tok = step_toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(t + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, t + i,
                              t_cfg, A)
        assert got.cache is t_cache             # written in place
        j_cache = want.cache
        yield want, got


def test_prefill_then_decode_match_jax_f32():
    """T = 40: three chunks of 16, the last ragged; then 4 decode steps
    through the prefill's states. Logits, values, SSM and conv states."""
    j_cfg, t_cfg, jp, tp = _setup(1)
    toks = _tokens(2, 40, j_cfg.vocab_size, 2)
    for want, got in _prefill_decode(j_cfg, t_cfg, jp, tp, toks, 4):
        _close(want.policy_logits, got.policy_logits, **TOL_CHUNKS)
        _close(want.values, got.values, **TOL_CHUNKS)
        _close_tree(want.cache, got.cache, **TOL_CHUNKS)
        c = got.cache["scan"]["l0"]["ssm"]
        assert c["ssm"].shape == (2, 2, 8, 32, 16) and \
            c["ssm"].dtype == torch.float32
        assert c["conv"].shape == (2, 2, 3, 288)


def test_prefill_then_decode_match_jax_bf16():
    """bf16, the working dtype: the conv's products and sums and the silu
    round to bf16 at other points in the two frameworks, the SSD carries
    the difference in f32, and the second layer's inputs differ by it.
    The logits and values (~0.15 at most) are held to 2e-3 absolute (max
    2.7e-4 seen); the float32 SSM states (~1-3) to 5e-2 absolute (3e-2
    seen in the second layer); the bf16 conv states (~2.5 at most) to
    4e-2, two bf16 ulps at the top of their range (the first layer's
    match bit for bit)."""
    j_cfg, t_cfg, jp, tp = _setup(3, "bfloat16")
    toks = _tokens(2, 40, j_cfg.vocab_size, 4)
    for want, got in _prefill_decode(j_cfg, t_cfg, jp, tp, toks, 4):
        assert got.policy_logits.dtype == torch.float32
        _close(want.policy_logits, got.policy_logits, atol=2e-3, rtol=0)
        _close(want.values, got.values, atol=2e-3, rtol=0)
        w, g = P.flatten(want.cache), P.flatten(got.cache)
        _close(w["scan/l0/ssm/ssm"], g["scan/l0/ssm/ssm"], atol=5e-2,
               rtol=0)
        conv = g["scan/l0/ssm/conv"]
        assert conv.dtype == torch.bfloat16
        _close(w["scan/l0/ssm/conv"][0], conv[0], atol=0, rtol=0)
        _close(w["scan/l0/ssm/conv"], conv, atol=4e-2, rtol=0)


def test_prefill_state_owns_its_storage():
    """The state a layer's prefill returns is a copy, not a view of the
    layer's transients (all chunks' states, the conv's whole input), which
    the stacked cache would otherwise keep alive for every layer."""
    _, t_cfg, _, tp = _setup(9)
    p0 = P.tree_map(lambda a: a[0], tp["stack"]["scan"])["l0"]["ssm"]
    for b in (1, 2):
        x = torch.from_numpy(np.random.default_rng(b).standard_normal(
            (b, 40, t_cfg.d_model)).astype(np.float32))
        _, st = ssm.apply_ssm(p0, x, t_cfg, mode="prefill")
        for v in st.values():
            assert v.untyped_storage().nbytes() == \
                v.numel() * v.element_size()


def test_decode_continues_the_prefill():
    """Prefill of 44 tokens gives the last logits of prefill of 40 plus 4
    decode steps on the same tokens: each decode step starts from the
    state the last one wrote."""
    _, t_cfg, _, tp = _setup(5)
    toks = torch.from_numpy(_tokens(2, 44, t_cfg.vocab_size, 6))
    full = bb.apply_prefill(tp, {"tokens": toks}, t_cfg, A)
    out = bb.apply_prefill(tp, {"tokens": toks[:, :40]}, t_cfg, A)
    cache = out.cache
    for i in range(40, 44):
        out = bb.apply_decode(tp, toks[:, i:i + 1], cache, i, t_cfg, A)
    _close(full.policy_logits.numpy(), out.policy_logits, **TOL_CHUNKS)
    _close(full.values.numpy(), out.values, **TOL_CHUNKS)
    _close_tree(P.to_jax(full.cache), out.cache, **TOL_CHUNKS)


def test_decode_from_cache_init_matches_jax():
    j_cfg, t_cfg, jp, tp = _setup(7)
    b = 2
    j_cache = j_bb.cache_init(b, 9, j_cfg)
    t_cache = bb.cache_init(b, 9, t_cfg)
    _close_tree(j_cache, t_cache)
    assert P.flatten(t_cache).keys() == P.flatten(
        {"scan": {"l0": {"ssm": ssm.ssm_state_init(b, t_cfg,
                                                   torch.bfloat16)}}}).keys()
    toks = _tokens(b, 3, j_cfg.vocab_size, 8)
    for i in range(3):
        tok = toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, i, t_cfg,
                              A)
        j_cache = want.cache
        _close(want.policy_logits, got.policy_logits)
    _close_tree(j_cache, t_cache)


def test_cache_abstract_is_meta_and_matches_jax_shapes():
    j_cfg, t_cfg = _cfgs("bfloat16")
    w = P.flatten(j_bb.cache_abstract(3, 9, j_cfg))
    g = P.flatten(bb.cache_abstract(3, 9, t_cfg))
    assert sorted(w) == sorted(g)
    for key in w:
        assert g[key].device.type == "meta"
        assert tuple(g[key].shape) == w[key].shape
        assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype)


# ---------------------------------------------------------------------------
# the serve CLI


def test_serve_mamba2_smoke_on_cpu_runs_end_to_end():
    lk.reset_launch_counts()
    run = serve_lib.serve(["--device", "cpu", "--smoke", "--arch", ARCH,
                           "--requests", "3", "--batch", "2", "--ctx", "40",
                           "--decode-steps", "3"])
    assert run.arch.name == ARCH and run.arch.family == "ssm"
    assert (run.served, run.batches, run.decode_steps) == (3, 2, 3)
    fb = run.first_batch
    assert tuple(fb["tokens"].shape) == (2, 40)
    assert len(fb["logits"]) == 4
    for lg in fb["logits"]:
        assert lg.shape == (2, 1, A) and bool(torch.isfinite(lg).all())
    assert lk.linear_scan.launches == 0     # plain versions on the CPU
