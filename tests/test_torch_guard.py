"""Guard rails of the PyTorch port: it imports neither jax nor any module
of ``repro``, its entry points asked for ``cuda`` raise where there is no
card, and on CPU tensors the kernel wrappers take their plain versions
without counting a launch. On a card, the ``cuda``-marked cases hold each
kernel against its plain version.

This file imports no jax, so it also runs where only the port is
installed: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_guard.py`` on the card."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import linear_scan as lk
from repro_torch.kernels import vtrace as vk
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models.attention import decode_bias

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_port_imports_no_jax_and_no_repro_module():
    """Import every module of repro_torch, and chip_smoke.py, in a fresh
    interpreter; then neither jax nor ``repro``/``repro.*`` nor
    ``ml_dtypes`` may be loaded (``repro_torch`` itself starts with
    ``repro`` and is allowed)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "need = {'repro_torch.checkpoint.checkpoint', "
        "'repro_torch.core.replay', 'repro_torch.distributed.serde', "
        "'repro_torch.data.multitask', 'repro_torch.core.pbt', "
        "'repro_torch.distributed.inference', "
        "'repro_torch.distributed.procpool', "
        "'repro_torch.distributed.socket_transport', "
        "'repro_torch.distributed.netserve', "
        "'repro_torch.distributed.group', "
        "'repro_torch.distributed.spmd', "
        "'repro_torch.distributed.transport', 'repro_torch.obs.http', "
        "'repro_torch.obs.trace', 'repro_torch.obs.sink', "
        "'repro_torch.models.rglru', 'repro_torch.configs.gemma_7b', "
        "'repro_torch.configs.qwen1_5_4b', "
        "'repro_torch.configs.stablelm_1_6b', "
        "'repro_torch.configs.recurrentgemma_2b', "
        "'repro_torch.models.moe', "
        "'repro_torch.configs.granite_moe_1b_a400m', "
        "'repro_torch.configs.olmoe_1b_7b', "
        "'repro_torch.configs.llama_3_2_vision_11b', "
        "'repro_torch.configs.whisper_small', "
        "'repro_torch.sharding.rules', 'repro_torch.sharding.profiles', "
        "'repro_torch.roofline.analysis', "
        "'repro_torch.roofline.flops_model', "
        "'repro_torch.roofline.memory_model', "
        "'repro_torch.roofline.table', 'repro_torch.launch.mesh', "
        "'repro_torch.launch.steps', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.sweep', 'repro_torch.kernels.meta'}\n"
        "assert need <= set(names), need - set(names)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'ml_dtypes' or m.startswith('ml_dtypes.')]\n"
        "print(len(names))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT])
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip()) >= 20     # every module was walked


TWINS = ["quickstart", "vtrace_ablation", "train_100m", "serve_actors",
         "multitask_pbt", "train_async", "train_multiproc", "train_remote"]


def _twin_path(name):
    return os.path.join(ROOT, "examples", f"{name}_torch.py")


def test_example_twins_import_no_jax_and_no_repro_module():
    """Import each ``examples/*_torch.py`` by its path in one fresh
    interpreter (the ``__main__`` guard keeps its run from starting);
    then neither jax, ``repro``/``repro.*`` nor ``ml_dtypes`` may be
    loaded."""
    assert sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.endswith("_torch.py")) == \
        sorted(f"{n}_torch.py" for n in TWINS)
    code = (
        "import importlib.util, sys\n"
        "for i, path in enumerate(sys.argv[1:]):\n"
        "    spec = importlib.util.spec_from_file_location(f't{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'ml_dtypes' or m.startswith('ml_dtypes.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code]
                       + [_twin_path(n) for n in TWINS], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_asked_for_cuda_raise_without_a_card(monkeypatch,
                                                           name):
    """Each twin's ``--device`` defaults to cuda; without a card it
    raises and does not carry on on the CPU."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  _twin_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["demo"] if name == "train_remote" else []
    with pytest.raises(SystemExit, match="is_available"):
        mod.main(argv)


def test_trainer_asked_for_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        train_lib.train(["--device", "cuda", "--steps", "1"])


def test_server_asked_for_cuda_raises_without_a_card(monkeypatch):
    """The default device is cuda; the server does not carry on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        serve_lib.serve(["--smoke", "--requests", "1"])


_ASYNC = ["--runtime", "async"]


_SPMD_RUN = ["--smoke", "--num-envs", "4", "--unroll", "5"]


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("argv,match", [
    (["--learner-mode", "spmd"], "requires --runtime async"),
    (_ASYNC + ["--learners", "2", "--learner-mode", "spmd"],
     "keeps ONE learner process"),
    (_ASYNC + ["--actor-backend", "remote", "--transport", "socket",
               "--learner-mode", "spmd"], 1),
    (_ASYNC + ["--learner-mode", "spmd", "--spmd-devices", "2", "--steps",
               "3"], 2),
])
def test_unported_paths_exit_with_the_roadmap_item(argv, match, capsys):
    """The SPMD learner's CLI: its two refusals are the JAX CLI's, and,
    ported since, ``--learner-mode spmd`` runs as the JAX CLI's does (with
    remote actors too) and ends printing the ``group`` section; an int
    ``match`` is the spmd device count the run must report."""
    argv = ["--device", "cpu", "--steps", "1"] + argv
    if isinstance(match, str):
        with pytest.raises(SystemExit, match=match):
            train_lib.train(argv)
        return
    run = train_lib.train(argv + _SPMD_RUN)
    out = capsys.readouterr().out
    assert f"learner_mode=spmd spmd_devices={match}" in out
    line = [x for x in out.splitlines() if x.startswith("telemetry: ")][-1]
    tel = json.loads(line[len("telemetry: "):])
    steps = run.telemetry["learner_updates"]
    assert tel["group"] == {"num_learners": 1, "publisher": 0,
                            "exchange_backend": "collective",
                            "spmd_devices": match, "rounds": steps}
    assert tel["exchange"]["rounds"] == steps


@pytest.mark.parametrize("hosts", [["--num-hosts", "0"],
                                   ["--num-hosts", "2", "--host-id", "2"]])
def test_coord_addr_checks_its_hosts(hosts):
    """The multi-host stub's validation exits, with the JAX CLI's
    message, before any group is brought up."""
    import torch.distributed as dist

    with pytest.raises(SystemExit, match=r"--coord-addr needs --num-hosts "
                       r">= 1 and 0 <= --host-id < num_hosts, got"):
        train_lib.train(["--device", "cpu", "--coord-addr",
                         "127.0.0.1:1"] + hosts)
    assert not dist.is_initialized()


@pytest.mark.timeout_s(120)
def test_coord_addr_brings_a_group_up_and_goes_no_further(capsys):
    """One host: the stub brings the group up (gloo on the CPU) and says
    so; the SPMD learner of one rank steps over it; the group goes down
    with the run."""
    import torch.distributed as dist

    from repro_torch.distributed.spmd import free_port

    addr = f"127.0.0.1:{free_port()}"
    run = train_lib.train(["--device", "cpu", "--coord-addr", addr,
                           "--runtime", "async", "--learner-mode", "spmd",
                           "--steps", "2"] + _SPMD_RUN)
    out = capsys.readouterr().out
    assert (f"torch.distributed up: host 0/1 coordinator={addr} "
            f"backend=gloo devices=1 (local 1)") in out
    assert run.telemetry["group"]["spmd_devices"] == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b",
                                  "olmoe-1b-7b", "mistral-nemo-12b",
                                  "mamba2-1.3b", "whisper-small"])
def test_token_archs_train_through_the_cli(monkeypatch, arch):
    """Token training: one ``--smoke`` step on the CPU for each token
    family the CLI trains; the audio backbone (like the vlm one) needs the
    stub frontend's embeddings, so the CLI stops before any weight is
    drawn and names the backbone API that trains it."""
    argv = ["--device", "cpu", "--smoke", "--arch", arch, "--steps", "1",
            "--num-envs", "2", "--unroll", "4"]
    if arch == "whisper-small":
        from repro_torch.models import common

        def drawn(*args, **kw):
            raise AssertionError("a weight was drawn")

        monkeypatch.setattr(common, "init_params", drawn)
        with pytest.raises(SystemExit, match=r"repro_torch\.models\."
                           r"backbone \(apply_train with "
                           r"batch\['enc_embed'\]\)"):
            train_lib.train(argv)
        return
    run = train_lib.train(argv)
    assert run.arch.name == arch
    assert np.isfinite(float(run.metrics["loss/total"]))
    assert tuple(run.last_batch["obs_token"].shape) == (2, 5)


@pytest.mark.parametrize("arch,key", [
    ("llama-3.2-vision-11b", "image_embed"), ("whisper-small", "enc_embed")])
def test_server_refuses_the_vlm_and_audio_backbones(monkeypatch, arch, key):
    """The server sends tokens only; the vlm and audio backbones need the
    stub frontend's embeddings, so it stops, before any weight is drawn,
    and names the backbone API that runs them."""
    from repro_torch.models import common

    def drawn(*args, **kw):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(common, "init_params", drawn)
    with pytest.raises(SystemExit, match=rf"sends tokens only.*"
                       rf"repro_torch\.models\.backbone.*{key}"):
        serve_lib.serve(["--device", "cpu", "--arch", arch])


class _Reached(Exception):
    pass


# the supervision keywords the JAX CLI hands each runtime: a single
# learner takes the transport's (heartbeat, elastic), a group the
# failover deadline; supervised, both get --ckpt-dir (here unset: "")
_ONE = {"supervise": True, "heartbeat_timeout_s": 10.0, "elastic": False,
        "ckpt_dir": ""}
_GROUP = {"supervise": True, "failover_deadline_s": 20.0, "ckpt_dir": ""}


@pytest.mark.parametrize("argv,runtime,want", [
    (_ASYNC + ["--actor-backend", "process", "--learners", "2",
               "--supervise"], "group", _GROUP),
    (["--supervise"], None, None),
    (_ASYNC + ["--actor-backend", "process", "--actor-mode", "inference",
               "--supervise"], "one", _ONE),
    (_ASYNC + ["--actor-backend", "remote", "--elastic"], "one",
     dict(_ONE, supervise=False, elastic=True, ckpt_dir=None)),
    (_ASYNC + ["--transport", "shm", "--actor-mode", "inference",
               "--learners", "2", "--elastic"], "group",
     dict(_GROUP, supervise=False, ckpt_dir=None)),
    (_ASYNC + ["--learners", "2", "--supervise"], "group", _GROUP),
    (_ASYNC + ["--supervise"], "one", _ONE),
    (_ASYNC + ["--learners", "2", "--resume", "--supervise"], "group",
     _GROUP),
    (_ASYNC + ["--actor-backend", "remote", "--supervise", "--elastic",
               "--heartbeat-timeout-s", "3", "--failover-deadline-s", "7"],
     "one", dict(_ONE, heartbeat_timeout_s=3.0, elastic=True)),
])
def test_supervision_flags_reach_the_runtime(monkeypatch, argv, runtime,
                                             want):
    """The supervision flags reach ``run_async_training`` (one learner)
    or ``run_group_training`` (``--learners N``) as the JAX CLI passes
    them; on the sync runtime ``--supervise`` changes nothing and the run
    takes its step."""
    import repro_torch.distributed as dist

    seen = {}

    def fake(name):
        def run(*args, **kw):
            seen[name] = kw
            raise _Reached
        return run

    monkeypatch.setattr(dist, "run_async_training", fake("one"))
    monkeypatch.setattr(dist, "run_group_training", fake("group"))
    full = ["--device", "cpu", "--smoke", "--steps", "1"] + argv
    if runtime is None:
        run = train_lib.train(full)
        assert seen == {} and run.params
        return
    with pytest.raises(_Reached):
        train_lib.train(full)
    assert list(seen) == [runtime]
    got = seen[runtime]
    assert {k: got.get(k, "absent") for k in want} == want
    absent = (("failover_deadline_s",) if runtime == "one" else
              ("heartbeat_timeout_s", "elastic"))
    assert not any(k in got for k in absent)


def test_a_cuda_device_turns_tf32_off(monkeypatch):
    """Both CLIs resolve --device through ``resolve_device``; on a card it
    turns TF32 off, so the convolutions and matmuls compute in the full
    float32 that every check verified."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert train_lib.resolve_device("cuda").type == "cuda"
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert serve_lib.resolve_device is train_lib.resolve_device
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_the_served_loop_synchronises_once_a_batch(monkeypatch):
    """The reference blocks once a batch, after its decode loop; so does
    the port: no synchronise between a batch's prefill and its last
    decode step."""
    from repro_torch.models import backbone as bb

    events = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            events.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(serve_lib, "_sync", recorder("sync",
                                                     serve_lib._sync))
    monkeypatch.setattr(bb, "apply_prefill", recorder("prefill",
                                                      bb.apply_prefill))
    monkeypatch.setattr(bb, "apply_decode", recorder("decode",
                                                     bb.apply_decode))
    run = serve_lib.serve(["--device", "cpu", "--smoke", "--requests", "2",
                           "--batch", "1", "--ctx", "8",
                           "--decode-steps", "3"])
    assert run.batches == 2
    served = events[events.index("prefill"):]
    assert served == ["prefill", "decode", "decode", "decode", "sync"] * 2
    assert len(run.prefill_ms) == 2 and len(run.decode_ms) == 6


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    t, b, a = 5, 3, 4
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    rho, c, disc, rew, v, vtp1 = (f(t, b) for _ in range(6))
    logits = f(t, b, a)
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, a, (t, b))), a).to(torch.float32)
    vk.reset_launch_counts()
    got = vk.vtrace(rho, c, disc, rew, v, vtp1)
    want = vk.vtrace_plain(rho, c, disc, rew, v, vtp1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got2 = vk.loss_vtrace(logits, onehot, rew, disc, rew, v, vtp1)
    want2 = vk.loss_vtrace_plain(logits, onehot, rew, disc, rew, v, vtp1)
    for g, w in zip(got2, want2):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    vk.fused_loss_vtrace(logits, onehot, rew, disc, rew, v, vtp1)
    assert vk.vtrace.launches == 0
    assert vk.loss_vtrace.launches == 0


def test_vtrace_shape_records_grow_only_with_launches():
    """``shapes`` names the problem shapes a wrapper launched at: a CPU
    call adds none, and resetting the counts keeps what was recorded, so
    a caller can collect the shapes of several runs."""
    t, b, a = 4, 3, 5
    f = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    before = (set(vk.vtrace.shapes), set(vk.loss_vtrace.shapes))
    vk.vtrace.shapes.add((-1, -1))
    vk.reset_launch_counts()
    vk.vtrace(*(f(t, b) for _ in range(6)))
    vk.loss_vtrace(f(t, b, a), f(t, b, a), *(f(t, b) for _ in range(5)))
    try:
        assert vk.vtrace.shapes == before[0] | {(-1, -1)}
        assert vk.loss_vtrace.shapes == before[1]
    finally:
        vk.vtrace.shapes.discard((-1, -1))


def _scan_inputs(t, n, seed, dev="cpu"):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(t, n, generator=g)
    b = torch.randn(t, n, generator=g)
    h0 = torch.randn(n, generator=g)
    return tuple(x.to(dev) for x in (a, b, h0))


def test_linear_scan_wrapper_takes_the_plain_version_on_cpu_uncounted():
    a, b, h0 = _scan_inputs(7, 5, 0)
    lk.reset_launch_counts()
    for init in (h0, None):
        torch.testing.assert_close(lk.linear_scan(a, b, init),
                                   lk.linear_scan_plain(a, b, init),
                                   rtol=0, atol=0)
    assert lk.linear_scan.launches == 0


def test_linear_scan_wrapper_refuses_what_the_kernel_does_not_take():
    a, b, h0 = _scan_inputs(7, 5, 1)
    with pytest.raises(TypeError, match="float32"):
        lk.linear_scan(a.double(), b, h0)
    with pytest.raises(TypeError, match="float32"):
        lk.linear_scan(a, b, h0.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        lk.linear_scan(a.t().contiguous().t(), b, h0)
    with pytest.raises(ValueError, match="shape"):
        lk.linear_scan(a, b[:, :4], h0)
    with pytest.raises(ValueError, match="shape"):
        lk.linear_scan(a, b, h0[:4])
    with pytest.raises(ValueError, match="non-empty"):
        lk.linear_scan(a[0], b[0], h0)


def _attn_inputs(b, t, s, h, kh, d, seed, dtype=torch.float32, dev="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, d, generator=g)
    k = torch.randn(b, s, kh, d, generator=g)
    v = torch.randn(b, s, kh, d, generator=g)
    return tuple(x.to(dev, dtype) for x in (q, k, v))


def test_attention_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v = _attn_inputs(2, 9, 9, 4, 2, 16, 0)
    fk.reset_launch_counts()
    dk.reset_launch_counts()
    torch.testing.assert_close(fk.flash_attention(q, k, v, True, 3),
                               fk.flash_attention_plain(q, k, v, True, 3),
                               rtol=0, atol=0)
    bias = decode_bias(5, 9, 0, 2, "cpu")
    q1 = q[:, 0].contiguous()
    torch.testing.assert_close(dk.decode_attention(q1, k, v, bias),
                               dk.decode_attention_plain(q1, k, v, bias),
                               rtol=0, atol=0)
    assert fk.flash_attention.launches == 0
    assert dk.decode_attention.launches == 0


def test_scan_and_attention_shape_records_grow_only_with_launches():
    """K3's, K4's and K5's ``shapes``, as K1's and K2's: a CPU call adds
    none, and resetting the counts keeps what was recorded."""
    before = (set(lk.linear_scan.shapes), set(fk.flash_attention.shapes),
              set(dk.decode_attention.shapes))
    a, b, h0 = _scan_inputs(7, 5, 2)
    q, k, v = _attn_inputs(2, 9, 9, 4, 2, 16, 3)
    lk.linear_scan.shapes.add((-1, -1, False))
    for mod in (lk, fk, dk):
        mod.reset_launch_counts()
    lk.linear_scan(a, b, h0)
    fk.flash_attention(q, k, v, True, 0)
    dk.decode_attention(q[:, 0].contiguous(), k, v,
                        decode_bias(9, 9, 0, 2, "cpu"))
    try:
        assert lk.linear_scan.shapes == before[0] | {(-1, -1, False)}
        assert fk.flash_attention.shapes == before[1]
        assert dk.decode_attention.shapes == before[2]
    finally:
        lk.linear_scan.shapes.discard((-1, -1, False))


def test_attention_wrappers_refuse_what_the_kernel_does_not_take():
    q, k, v = _attn_inputs(2, 9, 9, 4, 2, 16, 1)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        fk.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        fk.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="H % K"):
        fk.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="window"):
        fk.flash_attention(q, k, v, True, -1)
    bias = decode_bias(5, 9, 0, 2, "cpu")
    q1 = q[:, 0].contiguous()
    with pytest.raises(ValueError, match="bias"):
        dk.decode_attention(q1, k, v, bias.double())
    with pytest.raises(ValueError, match="bias"):
        dk.decode_attention(q1, k, v, bias[:, :4].contiguous())
    with pytest.raises(ValueError, match="dims"):
        dk.decode_attention(q, k, v, bias)


@pytest.mark.parametrize("which", ["flash", "decode"])
def test_attention_kernels_refuse_a_graph_they_would_cut(which):
    """K4 and K5 have no backward and write through a raw pointer: the
    route that launches them (``impl='pallas'``) raises on inputs that
    require grad while grad mode is on, on the CPU as on the card, and
    runs under ``torch.no_grad()``."""
    from repro_torch.kernels import ops
    q, k, v = _attn_inputs(2, 9, 9, 4, 2, 16, 4)
    if which == "decode":
        q = q[:, 0].contiguous()
        bias = decode_bias(5, 9, 0, 2, "cpu")

        def call():
            return ops.decode_attention(q, k, v, bias, impl="pallas")
    else:
        def call():
            return ops.flash_attention(q, k, v, True, 0, impl="pallas")
    for x in (q, k, v):
        x.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None
        x.requires_grad_(False)
    assert call().grad_fn is None


def test_linear_scan_wrapper_keeps_the_graph_through_its_function():
    """K3 goes through its autograd Function where an input requires
    grad: the output has a grad_fn and the gradients reach a, b and h0."""
    a, b, h0 = _scan_inputs(7, 5, 5)
    for x in (a, b, h0):
        x.requires_grad_(True)
    h = lk.linear_scan(a, b, h0)
    assert type(h.grad_fn).__name__.startswith("LinearScanFn")
    h.sum().backward()
    assert all(x.grad is not None and bool(x.grad.abs().sum() > 0)
               for x in (a, b, h0))
    with torch.no_grad():
        assert lk.linear_scan(a, b, h0).grad_fn is None


@pytest.mark.parametrize("b,kh,s,sms,want", [
    (16, 8, 128, 132, (1, 128)),        # the serving path: one pass
    (8, 8, 32768, 132, (17, 1984)),     # decode_32k: ~8 blocks an SM
    (4, 8, 1000, 132, (2, 512)),        # no split shorter than 512 keys
    (1, 1, 100, 132, (1, 128)),
    (64, 8, 32768, 132, (3, 10944)),
])
def test_decode_attention_splits_s_when_the_blocks_are_few(b, kh, s, sms,
                                                            want):
    n, split_len = dk.plan_splits(b, kh, s, sms)
    assert (n, split_len) == want
    assert split_len % dk.CHUNK == 0 and (n - 1) * split_len < s <= \
        n * split_len


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(4, 3)
    with pytest.raises(TypeError, match="float32"):
        vk.vtrace(x.double(), x, x, x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(3, 4).t()
        vk.vtrace(y, y, y, y, y, y)
    with pytest.raises(ValueError, match="shape"):
        vk.vtrace(x, x, x, x, x, torch.zeros(4, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,a", [(20, 32, 3), (37, 130, 5),
                                   (100, 256, 18), (16, 8, 130),
                                   (100, 32, 9), (33, 45, 4), (1000, 1, 3),
                                   (1000, 256, 18), (4, 64, 1000),
                                   (20, 64, 3), (20, 128, 3)])
def test_kernels_match_plain_on_the_card(t, b, a):
    """Clipped weights (the defaults), so every output is held to 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(t + b + a)
    logits = torch.randn(t, b, a, generator=g) * 2.0
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, a, (t, b), generator=g), a).to(torch.float32)
    blp = torch.sum(torch.log_softmax(logits, -1) * onehot, -1) - 0.2
    disc = torch.full((t, b), 0.97)
    rew, v, vtp1 = (torch.randn(t, b, generator=g) for _ in range(3))
    inp = tuple(x.to(dev) for x in (logits, onehot, blp, disc, rew, v,
                                    vtp1))
    vk.reset_launch_counts()
    for got, want in zip(vk.loss_vtrace(*inp), vk.loss_vtrace_plain(*inp)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    rho = torch.clamp(torch.exp(inp[2] + 1.0), max=1.0)
    args = (rho, rho) + inp[3:]
    for got, want in zip(vk.vtrace(*args), vk.vtrace_plain(*args)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert (vk.vtrace.launches, vk.loss_vtrace.launches) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,h,kh,d,causal,window", [
    (16, 128, 128, 32, 8, 128, True, 0), (2, 100, 160, 32, 8, 128, True, 0),
    (2, 160, 100, 8, 8, 64, False, 0), (1, 300, 300, 4, 1, 32, True, 64),
    (2, 128, 128, 16, 16, 256, True, 0), (1, 300, 300, 10, 1, 256, True, 128),
    # cross-attention: non-causal with S > T, ragged on both sides
    (2, 100, 1600, 32, 8, 128, False, 0), (2, 37, 1500, 12, 12, 64, False, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_matches_plain_on_the_card(b, t, s, h, kh, d, causal,
                                                   window, dtype):
    """f32: a few ulps of outputs of size ~1 (1e-5); bf16: one rounding of
    an f32 result each, so one bf16 ulp (2^-7 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(b, t, s, h, kh, d, t + s, dtype, "cuda")
    fk.reset_launch_counts()
    got = fk.flash_attention(q, k, v, causal, window)
    want = fk.flash_attention_plain(q, k, v, causal, window)
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                               rtol=rtol)
    assert fk.flash_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d,index,window", [
    (16, 32, 8, 128, 128, 160, 0), (4, 32, 8, 1000, 128, 300, 0),
    (4, 32, 8, 1024, 128, 2000, 256), (3, 8, 8, 130, 64, 100, 0),
    (2, 16, 16, 128, 256, 135, 0), (2, 10, 1, 512, 256, 700, 512),
    # cross-attention decode: every one of 1,500 or 1,600 keys valid
    (4, 12, 12, 1500, 64, 1500, 0), (4, 32, 8, 1600, 128, 1600, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_matches_plain_on_the_card(b, h, kh, s, d, index,
                                                    window, dtype):
    """Tolerances as for flash attention; biases as the decode path
    builds them (masked suffix, ring buffer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(b, 1, s, h, kh, d, s + index, dtype, "cuda")
    bias = decode_bias(index, s, window, b, "cuda")
    dk.reset_launch_counts()
    q1 = q[:, 0].contiguous()
    got = dk.decode_attention(q1, k, v, bias)
    want = dk.decode_attention_plain(q1, k, v, bias)
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                               rtol=rtol)
    assert dk.decode_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(1, 1), (33, 7), (257, 129), (512, 1024),
                                 (8, 16 * 64 * 64 * 128)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_linear_scan_matches_plain_on_the_card(t, n, with_h0):
    """Built with -fmad=false, the kernel rounds as the plain loop does:
    held to 1e-5 absolute, bit for bit expected. (8, 8388608) is the
    mamba2-1.3b serving path's cross-chunk pass at batch 16, ctx 2048."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    a, b, h0 = _scan_inputs(t, n, t + n, "cuda")
    h0 = h0 if with_h0 else None
    lk.reset_launch_counts()
    got = lk.linear_scan(a, b, h0)
    want = lk.linear_scan_plain(a, b, h0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert lk.linear_scan.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(1, 16 * 64 * 64 * 128), (21, 81920),
                                 (37, 1000)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_linear_scan_backward_matches_plain_on_the_card(t, n, with_h0):
    """K3's gradient (K3 on reversed time) against autograd through the
    plain loop: 1e-5 absolute, one launch each way. (1, 16777216) is
    mamba2-1.3b's training pass at 32 envs (one chunk of T = 21), (21,
    81920) recurrentgemma-2b's RG-LRU at 32 envs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    a, b, h0 = _scan_inputs(t, n, t + n, "cuda")
    h0 = h0 if with_h0 else None
    ct = torch.randn(t, n, device="cuda")
    ins = [x.requires_grad_(True) for x in (a, b, h0) if x is not None]
    lk.reset_launch_counts()
    got = torch.autograd.grad((lk.linear_scan(a, b, h0) * ct).sum(), ins)
    assert lk.linear_scan.launches == 2
    want = torch.autograd.grad((lk.linear_scan_plain(a, b, h0) * ct).sum(),
                               ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_host_stager_on_the_card_ping_pongs_pinned_buffers():
    """Numpy items staged for the card: every batch equals ``torch.cat``
    of the items, a third stack of one bucket reuses the first buffer set
    (after its copies' event) and the first batch keeps its values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: pinned staging has no CPU mode")
    from repro_torch.distributed.learner import _HostStager, _flatten, _stack
    from repro_torch.distributed.serde import TrajectoryItem

    def items(seed):
        rng = np.random.default_rng(seed)
        return [TrajectoryItem({
            "obs": rng.integers(0, 255, (32, 21, 10, 5, 3)).astype(np.uint8),
            "r": rng.standard_normal((32, 20)).astype(np.float32),
            "state": (rng.standard_normal((32, 256)).astype(np.float32),)},
            i, 0, 0.0) for i in range(4)]

    def want(its):
        flat = [_flatten(it.data)[0] for it in its]
        return [torch.cat([torch.from_numpy(x) for x in xs])
                for xs in zip(*flat)]

    stager = _HostStager("cuda")
    batches = [items(s) for s in range(3)]
    outs = [_stack(its, stager) for its in batches]
    torch.cuda.synchronize()
    assert len(stager._slots) == 1
    for out, its in zip(outs, batches):
        for got, w in zip(_flatten(out)[0], want(its)):
            assert got.is_cuda and torch.equal(got.cpu(), w)


def _fake_nvcc(tmp_path, fail_on=""):
    """An ``nvcc`` on PATH that writes its -o target (listing its inputs)
    and fails on a source whose name contains ``fail_on``."""
    script = tmp_path / "bin" / "nvcc"
    script.parent.mkdir()
    script.write_text(
        "#!" + sys.executable + "\n"
        "import sys\n"
        "a = sys.argv[1:]\n"
        "ins = [x for x in a if x.endswith(('.cu', '.o'))]\n"
        f"if any({fail_on!r} and {fail_on!r} in x for x in ins):\n"
        "    print('error: bad source'); sys.exit(2)\n"
        "open(a[a.index('-o') + 1], 'w').write(' '.join(ins))\n")
    script.chmod(0o755)
    return str(script.parent)


def test_build_compiles_each_source_then_links_them(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", _fake_nvcc(tmp_path) + os.pathsep +
                       os.environ["PATH"])
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
    lib, _ = build.build()
    linked = lib.read_text().split()
    assert sorted(os.path.basename(x) for x in linked) == sorted(
        src.stem + ".o" for src in build.sources())
    assert {"vtrace.o", "flash_attention.o", "decode_attention.o",
            "linear_scan.o"} <= \
        {os.path.basename(x) for x in linked}
    assert build.build()[0] == lib          # built once per key


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", _fake_nvcc(tmp_path, "decode") + os.pathsep +
                       os.environ["PATH"])
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
    with pytest.raises(RuntimeError, match="bad source"):
        build.build()
    assert not list((tmp_path / "out").glob("*/*.so"))


def test_chip_smoke_device_busy_is_the_union_of_device_spans():
    """chip_smoke.py's idle share counts overlapping device spans once and
    ignores host-side events."""
    import importlib.util
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def ev(name, start, end, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [ev("k", 0.0, 4.0), ev("k", 10.0, 12.0), ev("conv", 3.0, 6.0),
              ev("conv", 11.0, 11.5), ev("host op", 0.0, 100.0,
                                         DeviceType.CPU)]
    busy, count, by_name = smoke._device_busy(events)
    assert busy == 8.0          # [0, 6] and [10, 12]
    assert count == 4
    assert by_name == {"k": (6.0, 2), "conv": (3.5, 2)}
