"""The port's expert-parallel MoE against the JAX package's.

``_dispatch_compute_combine`` for every ``e_base`` at 1, 2 and 4 expert
shards, prefill and decode, on the smoke olmoe and granite-moe configs;
then ``apply_moe`` with ``dispatch_impl='shard_map_a2a'`` under
``use_rules`` on gloo groups of 2 ranks, a ``(1, 2)`` ``("data",
"model")`` mesh, and 4 ranks, ``(2, 2)``: each rank holds its batch shard
and computes its experts, the partial outputs summed over the ``model``
subgroup. Held to JAX's ``_apply_moe_shard_map`` on an ``Auto`` mesh of
the same shape (8 forced host devices, in a subprocess) and to the port's
one-device route, aux loss included. The route refuses grad-requiring
inputs (its backward is ROADMAP.md Queue 1 item 15E).

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

    archs, kinds, meshes = json.loads(sys.argv[2])
    out = {}
    for ai, arch in enumerate(archs):
        cfg = get_smoke_config(arch).replace(dtype="float32")
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
                        json.dumps([ARCHS, KINDS, MESHES])],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, path


def _cfg(arch, ep=False):
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if ep:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch_impl="shard_map_a2a"))
    return cfg


def _params(z, arch):
    return P.from_jax({k: {"kernel": z[f"{arch}/w/{k}"]}
                       for k in ("router", "up", "gate", "down")},
                      requires_grad=False)


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
        dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


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


def test_expert_parallel_route_refuses_grad_requiring_inputs(oracle):
    z, _ = oracle
    cfg = _cfg("olmoe-1b-7b", ep=True)
    p = _params(z, "olmoe-1b-7b")
    x = torch.from_numpy(z["olmoe-1b-7b/prefill/x"])
    with use_rules(Rules(_Mesh((1, 1)))):
        with pytest.raises(NotImplementedError, match=r"item 15E"):
            moe.apply_moe(p, x.clone().requires_grad_(True), cfg)
        grad_p = P.from_jax(P.to_jax(p))          # leaves require grad
        with pytest.raises(NotImplementedError, match=r"forward only"):
            moe.apply_moe(grad_p, x, cfg)
        # a one-device mesh needs no group: the one-device route's values
        with torch.no_grad():
            y, aux = moe.apply_moe(grad_p, x, cfg)
        want, want_aux = moe.apply_moe(p, x, _cfg("olmoe-1b-7b"))
        np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
        assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)


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
