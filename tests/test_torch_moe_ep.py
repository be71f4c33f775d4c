"""The port's expert-parallel MoE against the JAX package's.

``_dispatch_compute_combine`` for every ``e_base`` at 1, 2 and 4 expert
shards, prefill and decode, on the smoke olmoe and granite-moe configs;
then ``apply_moe`` with ``dispatch_impl='shard_map_a2a'`` under
``use_rules`` on gloo groups of 2 ranks, a ``(1, 2)`` ``("data",
"model")`` mesh, and 4 ranks, ``(2, 2)``: each rank holds its batch shard
and computes its experts, the partial outputs summed over the ``model``
subgroup. Held to JAX's ``_apply_moe_shard_map`` on an ``Auto`` mesh of
the same shape (8 forced host devices, in a subprocess) and to the port's
one-device route, aux loss included.

Then the route's backward on the same groups: each rank's gradients of
``sum(y * r) + C * aux`` (``r`` drawn from the seed, ``C`` nonzero, so an
aux part counted once a rank would show) for its batch shard of ``x``,
the router and its expert slices, held to ``jax.grad`` of JAX's
``_apply_moe_shard_map`` on the ``Auto`` mesh and of JAX's one-device
route, both of the mean over batch shards of that loss (a data-parallel
step's mean: a replicated leaf's gradient is the mean of the ranks'
gradients over the batch axis, a shard of ``x``'s its rank's over the
number of batch shards). A third config, olmoe's smoke config with a
``gelu`` activation, covers the experts without a ``gate``.

Weights and inputs are drawn with numpy from seeds at the JAX spec
tree's shapes, f32; tolerance 1e-5. This module imports no jax: the
spawned ranks import it, and JAX runs in its subprocess.
"""
import dataclasses
import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import traceback

import numpy as np
import pytest
import torch

from repro_torch import params as P
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import moe
from repro_torch.sharding.rules import Rules, use_rules

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
KINDS = {"prefill": (4, 16), "decode": (4, 1)}
MESHES = [(1, 2), (2, 2)]
TOL = dict(atol=1e-5, rtol=1e-5)
# "+gelu": the smoke config with an ungated activation (no "gate" leaf)
GRAD_ARCHS = ARCHS + ["olmoe-1b-7b+gelu"]
AUX_COEF = 0.5

JAX_ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config
    from repro.models import moe
    from repro.sharding.rules import Rules, use_rules

    archs, grad_archs, kinds, meshes, coef = json.loads(sys.argv[2])

    def smoke(arch):
        name, _, act = arch.partition("+")
        cfg = get_smoke_config(name).replace(dtype="float32")
        return cfg.replace(activation=act) if act else cfg

    out = {}
    for ai, arch in enumerate(grad_archs):
        cfg = smoke(arch)
        ep = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch_impl="shard_map_a2a"))
        rng = np.random.default_rng(ai)
        params = {}
        for name, sub in moe.moe_specs(cfg).items():
            shape = sub["kernel"].shape
            w = rng.standard_normal(shape) / np.sqrt(shape[-2])
            params[name] = {"kernel": w.astype(np.float32)}
            out[f"{arch}/w/{name}"] = params[name]["kernel"]
        d, e = cfg.d_model, cfg.moe.num_experts
        for kind, (b, t) in kinds.items():
            x = rng.standard_normal((b, t, d)).astype(np.float32)
            out[f"{arch}/{kind}/x"] = x
            r = rng.standard_normal((b, t, d)).astype(np.float32)
            out[f"{arch}/{kind}/r"] = r
            for shape in meshes:
                nb, rows = shape[0], b // shape[0]
                mesh = jax.make_mesh(
                    tuple(shape), ("data", "model"),
                    axis_types=(AxisType.Auto, AxisType.Auto),
                    devices=jax.devices()[:shape[0] * shape[1]])
                rules = Rules(mesh)

                def ep_loss(p, x):
                    with use_rules(rules):
                        y, aux = moe.apply_moe(p, x, ep)
                    return jnp.sum(y * r) / nb + coef * aux

                def dense_loss(p, x, c=coef):
                    tot = 0.0
                    for i in range(nb):
                        sl = slice(i * rows, (i + 1) * rows)
                        y, aux = moe.apply_moe(p, x[sl], cfg)
                        tot = tot + (jnp.sum(y * r[sl]) + c * aux) / nb
                    return tot
                tag = f"{shape[0]}x{shape[1]}"
                with mesh:
                    g_ep = jax.jit(jax.grad(ep_loss, (0, 1)))(params, x)
                g_dense = jax.jit(jax.grad(dense_loss, (0, 1)))(params, x)
                # the aux term's part alone (the router's, with r's part
                # taken out): what a second count of it would add
                g_r = jax.jit(jax.grad(lambda p, x: dense_loss(p, x, 0.0),
                                       (0, 1)))(params, x)
                for route, g in (("ep", g_ep), ("dense", g_dense)):
                    out[f"{arch}/{kind}/{tag}/g/{route}/x"] = g[1]
                    for k in params:
                        out[f"{arch}/{kind}/{tag}/g/{route}/{k}"] = \
                            g[0][k]["kernel"]
                out[f"{arch}/{kind}/{tag}/g/aux_router"] = np.asarray(
                    g_dense[0]["router"]["kernel"]
                    - g_r[0]["router"]["kernel"])
            if arch not in archs:
                continue
            xr = x.reshape(1, b, d) if t == 1 else x
            gates, idx, _ = moe.route(params, xr, cfg)
            cap = moe._capacity(xr.shape[1], cfg) * (2 if t == 1 else 1)
            for n in (1, 2, 4):
                el = e // n
                for c in range(n):
                    lw = {k: params[k]["kernel"][c * el:(c + 1) * el]
                          for k in params if k != "router"}
                    out[f"{arch}/{kind}/dcc/{n}/{c}"] = np.asarray(
                        moe._dispatch_compute_combine(
                            lw, jnp.asarray(xr), gates, idx, cap, cfg,
                            c * el, el))
            for shape in meshes:
                mesh = jax.make_mesh(
                    tuple(shape), ("data", "model"),
                    axis_types=(AxisType.Auto, AxisType.Auto),
                    devices=jax.devices()[:shape[0] * shape[1]])
                rules = Rules(mesh)

                def f(p, x):
                    with use_rules(rules):
                        return moe.apply_moe(p, x, ep)
                with mesh:
                    y, aux = jax.jit(f)(params, x)
                tag = f"{shape[0]}x{shape[1]}"
                out[f"{arch}/{kind}/{tag}/y"] = np.asarray(y)
                out[f"{arch}/{kind}/{tag}/aux"] = np.asarray(aux)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """JAX's outputs (and the weights and inputs it drew), from one
    subprocess."""
    path = str(tmp_path_factory.mktemp("moe_ep") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_ORACLE, path,
                        json.dumps([ARCHS, GRAD_ARCHS, KINDS, MESHES,
                                   AUX_COEF])],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, path


def _cfg(arch, ep=False):
    name, _, act = arch.partition("+")
    cfg = get_smoke_config(name).replace(dtype="float32")
    if act:
        cfg = cfg.replace(activation=act)
    if ep:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch_impl="shard_map_a2a"))
    return cfg


def _params(z, arch, requires_grad=False):
    return P.from_jax({k: {"kernel": z[f"{arch}/w/{k}"]}
                       for k in ("router", "up", "gate", "down")
                       if f"{arch}/w/{k}" in z},
                      requires_grad=requires_grad)


def _grads(p, x, r, cfg):
    """The gradients of ``sum(y * r) + AUX_COEF * aux`` through
    ``apply_moe`` for ``x`` and every leaf of ``p``."""
    x = x.clone().requires_grad_(True)
    y, aux = moe.apply_moe(p, x, cfg)
    (torch.sum(y * r) + AUX_COEF * aux).backward()
    out = {"x": x.grad.numpy()}
    for k in p:
        out[k] = p[k]["kernel"].grad.numpy().copy()
    return out


class _Mesh:
    """A mesh of names and sizes with no group (``Rules`` take any)."""
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.shape = dict(zip(self.axis_names, shape))


# ---------------------------------------------------------------------------
# _dispatch_compute_combine


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_compute_combine_matches_jax_at_every_e_base(
        oracle, arch, kind, n):
    """Each expert shard's part, for every ``e_base``, equals JAX's; the
    parts sum to the one-device route's output."""
    z, _ = oracle
    cfg = _cfg(arch)
    p = _params(z, arch)
    x = torch.from_numpy(z[f"{arch}/{kind}/x"])
    b, t, d = x.shape
    xr = x.reshape(1, b, d) if t == 1 else x
    gates, idx, _ = moe.route(p, xr, cfg)
    cap = moe._capacity(xr.shape[1], cfg) * (2 if t == 1 else 1)
    el = cfg.moe.num_experts // n
    total = 0
    for c in range(n):
        lw = {k: p[k]["kernel"][c * el:(c + 1) * el]
              for k in ("up", "gate", "down")}
        part = moe._dispatch_compute_combine(lw, xr, gates, idx, cap, cfg,
                                             c * el, el)
        np.testing.assert_allclose(part.numpy(),
                                   z[f"{arch}/{kind}/dcc/{n}/{c}"], **TOL)
        total = total + part
    y, _ = moe.apply_moe(p, x, cfg)
    np.testing.assert_allclose(total.reshape(b, t, d).numpy(), y.numpy(),
                               **TOL)


# ---------------------------------------------------------------------------
# apply_moe over gloo groups


def _rank_main(rank, n, addr, shape, npz, conn):
    """One rank: join the group, build the mesh's DeviceMesh, run the
    expert-parallel ``apply_moe`` on its batch shard for every (arch,
    kind), send the outputs up its pipe."""
    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import Mesh

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=addr, world_size=n,
                                rank=rank)
        mesh = Mesh(("data", "model"), tuple(shape))
        dm = mesh.device_mesh("cpu")
        dc = dm.get_local_rank("data")
        out = {"coord": (dc, dm.get_local_rank("model"))}
        with np.load(npz) as z, use_rules(Rules(mesh)), torch.no_grad():
            for arch in ARCHS:
                p = _params(z, arch)
                for kind in KINDS:
                    x = torch.from_numpy(z[f"{arch}/{kind}/x"])
                    rows = x.shape[0] // shape[0]
                    xs = x[dc * rows:(dc + 1) * rows]
                    y, aux = moe.apply_moe(p, xs, _cfg(arch, ep=True))
                    out[(arch, kind)] = (y.numpy(), float(aux))
                    # a rank that holds only its slice of the expert
                    # leaves (init_params' keep hook) computes the same
                    keep = moe.rank_expert_keep(Rules(mesh),
                                                dm.get_local_rank("model"))
                    specs = moe.moe_specs(_cfg(arch))
                    cut = {k: {"kernel": keep((k, "kernel"), specs[k][
                        "kernel"], p[k]["kernel"])} for k in p}
                    e = _cfg(arch).moe.num_experts // shape[1]
                    assert cut["up"]["kernel"].shape[0] == e
                    assert cut["router"]["kernel"].shape[-1] == e * shape[1]
                    y2, aux2 = moe.apply_moe(cut, xs, _cfg(arch, ep=True))
                    assert torch.equal(y, y2) and torch.equal(aux, aux2)
        mc = dm.get_local_rank("model")
        with np.load(npz) as z, use_rules(Rules(mesh)):
            for arch in GRAD_ARCHS:
                cfg = _cfg(arch, ep=True)
                e = cfg.moe.num_experts // shape[1]
                for kind in KINDS:
                    x = torch.from_numpy(z[f"{arch}/{kind}/x"])
                    r = torch.from_numpy(z[f"{arch}/{kind}/r"])
                    rows = x.shape[0] // shape[0]
                    sl = slice(dc * rows, (dc + 1) * rows)
                    # whole expert leaves: the gradient lands in the
                    # rank's slice and nowhere else
                    g = _grads(_params(z, arch, True), x[sl], r[sl], cfg)
                    for k in ("up", "gate", "down"):
                        if k in g:
                            rest = np.delete(g[k], np.s_[mc * e:(mc + 1) * e],
                                             axis=0)
                            assert not rest.any(), (arch, kind, k)
                            g[k] = g[k][mc * e:(mc + 1) * e]
                    # a rank holding only its slice gets the same
                    specs = moe.moe_specs(_cfg(arch))
                    keep = moe.rank_expert_keep(Rules(mesh), mc)
                    cut = P.tree_map(lambda a: a.detach().clone(),
                                     _params(z, arch))
                    cut = {k: {"kernel": keep((k, "kernel"), specs[k][
                        "kernel"], cut[k]["kernel"]).requires_grad_(True)}
                        for k in cut}
                    g2 = _grads(cut, x[sl], r[sl], cfg)
                    for k in g:
                        np.testing.assert_array_equal(g2[k], g[k])
                    out[("grad", arch, kind)] = g
        out["train"] = _train_step_case(mesh.sizes, mc)
        dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BT = (2, 6)


def _token_batch(cfg, num_actions):
    """A learner batch of ``TRAIN_BT`` trajectories drawn with numpy."""
    b, t = TRAIN_BT
    rng = np.random.default_rng(5)
    return {
        "obs_token": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, t + 1))),
        "actions": torch.from_numpy(rng.integers(0, num_actions, (b, t))),
        "rewards": torch.from_numpy(
            rng.standard_normal((b, t)).astype(np.float32)),
        "discounts": torch.full((b, t), 0.99),
        "behaviour_logprob": torch.from_numpy(
            -rng.random((b, t)).astype(np.float32) - 0.5),
    }


def _train_step_case(sizes, mc):
    """``build_steps``' train step of the smoke granite-moe config, f32,
    its experts split over the ``model`` axis of a mesh of ``sizes`` (each
    rank drawing only its slices), against the one-device route from the
    same seed: the gradients (the learner's ``grad_step`` under the rules)
    and the params after one step, leaf by leaf as the rank holds them,
    and the clip's global norm. The steps are built before the mesh's
    DeviceMesh, so the step finds its group when it runs. A mesh whose
    batch axis spans ranks is refused."""
    from repro_torch.core import learner as learner_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    cfg, ep = _cfg(TRAIN_ARCH), _cfg(TRAIN_ARCH, ep=True)
    na = steps_lib.NUM_ACTIONS
    mesh = Mesh(("data", "model"), tuple(sizes))
    rules = Rules(mesh)
    steps = steps_lib.build_steps(ep, rules)
    mesh.device_mesh("cpu")
    batch = _token_batch(cfg, na)
    if mesh.shape["data"] > 1:
        p = P.from_jax(common.init_params(bb.backbone_specs(cfg, na), 0))
        try:
            steps["train"](p, steps["optimizer"].init(p), 0, batch)
        except NotImplementedError as e:
            return {"refused": str(e)}
        return {"refused": None}
    specs = bb.backbone_specs(cfg, na)
    grad_step, apply_step, opt = learner_lib.build_grad_apply_steps(
        cfg, steps["icfg"], na)
    dense = P.from_jax(common.init_params(specs, 0))
    g_dense, _ = grad_step(dense, batch)
    dense, _, m_dense = apply_step(dense, opt.init(dense), 0, list(g_dense))
    p = P.from_jax(common.init_params(
        specs, 0, keep=moe.rank_expert_keep(rules, mc)))
    ep_grad, _, _ = learner_lib.build_grad_apply_steps(ep, steps["icfg"], na)
    with use_rules(rules):
        g_ep, _ = ep_grad(p, batch)
    p, _, m = steps["train"](p, steps["optimizer"].init(p), 0, batch)
    e = cfg.moe.num_experts // mesh.shape["model"]
    out = {"norm": (float(m["opt/grad_norm"]), float(m_dense[
        "opt/grad_norm"])), "grads": {}, "params": {}}
    for (k, got), want, gg, gw in zip(P.flatten(p).items(),
                                      P.tree_leaves(dense), g_ep, g_dense):
        if tuple(got.shape) != tuple(want.shape):
            want, gw = (a[:, mc * e:(mc + 1) * e] for a in (want, gw))
        out["grads"][k] = (gg.numpy(), gw.numpy())
        out["params"][k] = (got.detach().numpy(), want.detach().numpy())
    return out


def run_ranks(target, n, *args, timeout=120.0):
    """Spawn ``n`` gloo ranks of ``target(rank, n, addr, *args, conn)``
    and return their results by rank; a rank's error fails the call, and
    a rank still running at ``timeout`` is killed."""
    from repro_torch.distributed.spmd import free_port

    ctx = mp.get_context("spawn")
    addr = f"tcp://127.0.0.1:{free_port()}"
    conns, procs = [], []
    for r in range(n):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=target, args=(r, n, addr) + args + (child,),
                        daemon=True)
        p.start()
        child.close()
        conns.append(parent)
        procs.append(p)
    out = {}
    try:
        for r, conn in enumerate(conns):
            if not conn.poll(timeout):
                raise TimeoutError(f"rank {r} sent nothing in {timeout} s")
            status, got = conn.recv()
            if status != "ok":
                raise AssertionError(f"rank {r} failed:\n{got}")
            out[r] = got
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.exitcode is None:
                p.kill()
    return out


@pytest.fixture(scope="module")
def ranks(oracle):
    """Every rank's outputs on each mesh shape (one group a shape)."""
    _, npz = oracle
    return {shape: run_ranks(_rank_main, shape[0] * shape[1], shape, npz)
            for shape in MESHES}


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_apply_moe_matches_jax_and_one_device(
        oracle, ranks, arch, kind, shape):
    """Every rank's output for its batch shard equals JAX's
    ``_apply_moe_shard_map`` rows and the port's one-device route on the
    same shard; the ranks of one data coordinate agree; the aux loss is
    JAX's, the mean of the one-device route's over the batch shards."""
    z, _ = oracle
    tag = f"{shape[0]}x{shape[1]}"
    want_y, want_aux = z[f"{arch}/{kind}/{tag}/y"], z[f"{arch}/{kind}/{tag}/aux"]
    p = _params(z, arch)
    x = torch.from_numpy(z[f"{arch}/{kind}/x"])
    rows = x.shape[0] // shape[0]
    one = [moe.apply_moe(p, x[i * rows:(i + 1) * rows], _cfg(arch))
           for i in range(shape[0])]
    seen = set()
    for got in ranks[shape].values():
        dc, mc = got["coord"]
        seen.add((dc, mc))
        y, aux = got[(arch, kind)]
        np.testing.assert_allclose(y, want_y[dc * rows:(dc + 1) * rows],
                                   **TOL)
        np.testing.assert_allclose(y, one[dc][0].numpy(), **TOL)
        np.testing.assert_allclose(aux, want_aux, **TOL)
        np.testing.assert_allclose(
            aux, np.mean([float(a) for _, a in one]), **TOL)
    assert seen == {(i, j) for i in range(shape[0]) for j in range(shape[1])}


# ---------------------------------------------------------------------------
# refusals and the meta route


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_expert_parallel_gradients_match_jax_and_one_device(
        oracle, ranks, arch, kind, shape):
    """Every rank's gradients for its shard of ``x``, the router and its
    expert slices equal ``jax.grad`` of JAX's ``_apply_moe_shard_map``
    and of JAX's one-device route, as the module's docstring relates
    them; the ranks of one batch coordinate agree on ``x`` and the
    router. The aux term's part of the router's gradient is far above
    the tolerance, so counting it once an expert rank would fail."""
    z, _ = oracle
    tag = f"{shape[0]}x{shape[1]}"
    nb, ne = shape
    rows = z[f"{arch}/{kind}/x"].shape[0] // nb
    e = _cfg(arch).moe.num_experts // ne
    assert np.abs(z[f"{arch}/{kind}/{tag}/g/aux_router"]).max() > 100 * \
        TOL["atol"]
    got = {got["coord"]: got[("grad", arch, kind)]
           for got in ranks[shape].values()}
    assert sorted(got) == [(i, j) for i in range(nb) for j in range(ne)]
    for route in ("ep", "dense"):
        want = {k: z[f"{arch}/{kind}/{tag}/g/{route}/{k}"]
                for k in ("x", "router", "up", "gate", "down")
                if f"{arch}/{kind}/{tag}/g/{route}/{k}" in z}
        assert ("gate" in want) == (not arch.endswith("+gelu"))
        for (dc, mc), g in got.items():
            np.testing.assert_allclose(
                g["x"] / nb, want["x"][dc * rows:(dc + 1) * rows], **TOL)
            np.testing.assert_array_equal(g["x"], got[(dc, 0)]["x"])
            np.testing.assert_array_equal(g["router"],
                                          got[(dc, 0)]["router"])
        np.testing.assert_allclose(
            np.mean([got[(dc, 0)]["router"] for dc in range(nb)], 0),
            want["router"], **TOL)
        for mc in range(ne):
            for k in want.keys() - {"x", "router"}:
                np.testing.assert_allclose(
                    np.mean([got[(dc, mc)][k] for dc in range(nb)], 0),
                    want[k][mc * e:(mc + 1) * e], **TOL)


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_expert_parallel_train_step_matches_one_device(ranks, shape):
    """``build_steps``' train step with the experts split 2 ways: every
    rank's gradients and updated params, leaf by leaf (its expert slices
    and the replicated rest), equal the one-device route's from the same
    seed, and its clip's global norm is the whole tree's. With the batch
    axis split too, the step is refused (its mean is the SPMD
    learner's)."""
    for got in ranks[shape].values():
        case = got["train"]
        if shape[0] > 1:
            assert case["refused"] and "build_spmd_train_step" in \
                case["refused"]
            continue
        norm, want_norm = case["norm"]
        assert norm == pytest.approx(want_norm, rel=1e-5)
        assert len(case["grads"]) == 16
        for k, (g, w) in case["grads"].items():
            np.testing.assert_allclose(g, w, **TOL, err_msg=k)
        for k, (g, w) in case["params"].items():
            np.testing.assert_allclose(g, w, **TOL, err_msg=k)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_expert_parallel_route_refuses_grad_requiring_inputs(oracle, arch):
    """On a mesh of one device the route needs no group, forward or
    backward: it takes grad-requiring inputs and gives the one-device
    route's values and gradients."""
    z, _ = oracle
    cfg = _cfg(arch, ep=True)
    x = torch.from_numpy(z[f"{arch}/prefill/x"])
    r = torch.from_numpy(z[f"{arch}/prefill/r"])
    with use_rules(Rules(_Mesh((1, 1)))):
        grad_p = _params(z, arch, True)
        got = _grads(grad_p, x, r, cfg)
        with torch.no_grad():
            y, aux = moe.apply_moe(grad_p, x, cfg)
    p = _params(z, arch)
    want, want_aux = moe.apply_moe(p, x, _cfg(arch))
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)
    one = _grads(_params(z, arch, True), x, r, _cfg(arch))
    assert sorted(got) == sorted(one)
    for k in one:
        np.testing.assert_allclose(got[k], one[k], **TOL)


def test_expert_parallel_route_needs_its_group_except_on_meta(oracle):
    """Without a group a split mesh refuses real tensors; on meta it
    counts one expert rank's E/n experts (the dry run's view)."""
    z, _ = oracle
    cfg = _cfg("olmoe-1b-7b", ep=True)
    p = _params(z, "olmoe-1b-7b")
    x = torch.from_numpy(z["olmoe-1b-7b/prefill/x"])
    with use_rules(Rules(_Mesh((1, 2)))), torch.no_grad():
        with pytest.raises(RuntimeError, match=r"Mesh\.device_mesh"):
            moe.apply_moe(p, x, cfg)
        meta = P.tree_map(lambda a: a.to("meta"), p)
        y, aux = moe.apply_moe(meta, x.to("meta"), cfg)
    assert y.device.type == "meta" and tuple(y.shape) == tuple(x.shape)
    assert aux.shape == ()


def test_expert_parallel_norm_needs_its_group_except_on_meta():
    """The train step's clip over a split tree looks its group up when it
    runs: without one it refuses real gradients, and on meta it gives the
    rank's own tree's norm (the dry run's one expert rank)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    ep = _cfg(TRAIN_ARCH, ep=True)
    assert steps_lib.expert_parallel_norm(
        ep, Rules(_Mesh((1, 1)))) is None
    assert steps_lib.expert_parallel_norm(
        _cfg(TRAIN_ARCH), Rules(_Mesh((1, 2)))) is None
    norm = steps_lib.expert_parallel_norm(ep, Rules(_Mesh((1, 2))))
    p = P.from_jax(common.init_params(
        bb.backbone_specs(_cfg(TRAIN_ARCH), steps_lib.NUM_ACTIONS), 0))
    grads = P.tree_leaves(p)
    with pytest.raises(RuntimeError, match=r"Mesh\.device_mesh"):
        norm(p, grads)
    meta = [g.to("meta") for g in grads]
    got = norm(P.tree_map(lambda a: a.to("meta"), p), meta)
    assert got.device.type == "meta" and got.shape == ()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keep_hook_draws_the_same_tree(arch, n):
    """``common.init_params`` with a rank's ``keep`` hook draws what it
    draws without one: every leaf but the expert FFN leaves is equal, and
    each of those is the rank's slice of the whole leaf. The backbone's
    spec tree holds leaves before and after the MoE blocks in draw order,
    so a hook that changed the order would show here."""
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    cfg = get_smoke_config(arch)
    specs = bb.backbone_specs(cfg, 5)
    rules = Rules(_Mesh((1, n)))
    whole = P.flatten(common.init_params(specs, 3))
    e = cfg.moe.num_experts // n
    assert moe.expert_shards(rules) == n
    for c in range(n):
        got = P.flatten(common.init_params(
            specs, 3, keep=moe.rank_expert_keep(rules, c)))
        assert sorted(got) == sorted(whole)
        cut = 0
        for k, w in whole.items():
            if got[k].shape != w.shape:
                assert k.split("/")[-2] in ("up", "gate", "down"), k
                w, cut = w[..., c * e:(c + 1) * e, :, :], cut + 1
            assert torch.equal(got[k], w), k
        assert cut >= 2
