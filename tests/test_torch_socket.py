"""The port's TCP socket transport and remote actors on the CPU: the
handshake ships the id and run config, a full house refuses, a codec the
client does not speak is refused at connect, a corrupt frame drops its
connection and the actor reconnects, the frames and CONFIG JSON are the
JAX package's, the paths not ported name their ROADMAP.md item, and a
loopback run trains in both actor modes with no decode error, torn tail
or leftover child."""
import json
import multiprocessing as mp
import socket
import time

import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke_config
from repro.distributed import netserve as j_netserve
from repro.distributed import serde as j_serde

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed import netserve, run_async_training, serde
from repro_torch.distributed import socket_transport as st
from repro_torch.distributed.socket_transport import (SocketActorClient,
                                                      SocketTransport)
from repro_torch.launch import train as train_lib

torch.set_num_threads(1)

_KW = dict(num_actions=3, unroll_length=8, learning_rate=1e-3,
           entropy_cost=0.003, rmsprop_eps=0.01)


def _icfg(**kw):
    return ImpalaConfig(**dict(_KW, **kw))


def _buf(actor_id: int, seq: int, codec: str = "none") -> bytes:
    data = {"obs_image": np.zeros((4, 3, 10, 5, 1), np.uint8),
            "x": np.full((16, 8), actor_id * 1000 + seq, np.float32),
            "seq": np.int32(seq)}
    return serde.encode_item(serde.TrajectoryItem(data, seq, actor_id,
                                                  time.monotonic()), codec)


def _dial_data(addr, actor_id: int) -> st.FrameChannel:
    chan = st.FrameChannel(socket.create_connection(addr, timeout=5.0))
    assert chan.send(st.KIND_HELLO, 0, json.dumps(
        {"role": "data", "actor_id": actor_id}).encode())
    return chan


def _wait_for(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {msg}"
        time.sleep(0.01)


def test_frame_kinds_and_ctrl_words_are_the_jax_packages():
    from repro.distributed import socket_transport as j_st
    names = [n for n in dir(j_st) if n.startswith(("KIND_", "CTRL_"))]
    assert names and all(getattr(st, n) == getattr(j_st, n)
                         for n in names)
    payload = _buf(2, 5)
    assert serde.pack_frame(st.KIND_TRAJ, 0, payload) == \
        j_serde.pack_frame(j_st.KIND_TRAJ, 0, payload)


def test_config_json_uses_the_jax_scheme_and_round_trips():
    arch = get_smoke_config("impala-shallow")
    cfg = netserve.build_actor_config(
        env_name="catch", arch_cfg=arch, icfg=_icfg(), num_envs=8, seed=3,
        mode="inference", infer_streams=2)
    j_cfg = j_netserve.build_actor_config(
        env_name="catch", arch_cfg=j_smoke_config("impala-shallow"),
        icfg=JaxImpalaConfig(**_KW), num_envs=8, seed=3, mode="inference",
        infer_streams=2)
    assert {k: v for k, v in cfg.items() if k not in ("arch", "icfg")} == \
        {k: v for k, v in j_cfg.items() if k not in ("arch", "icfg")}
    for key in ("arch", "icfg"):
        mine, ref = cfg[key], j_cfg[key]
        assert mine["__dc__"] == ref["__dc__"]
        shared = set(mine["fields"]) & set(ref["fields"])
        assert shared and {k: mine["fields"][k] for k in shared} == \
            {k: ref["fields"][k] for k in shared}
    back = json.loads(json.dumps(cfg))
    assert netserve.cfg_from_jsonable(back["arch"]) == arch
    assert netserve.cfg_from_jsonable(back["icfg"]) == _icfg()


@pytest.mark.timeout_s(60)
def test_socket_transport_roundtrip_and_counters():
    t = SocketTransport(capacity=8, policy="block")
    try:
        chan = _dial_data(t.address, actor_id=3)
        buf = _buf(3, 0)
        assert chan.send(st.KIND_TRAJ, 0, buf)
        got = t.get(timeout=10.0)
        assert got is not None and got.actor_id == 3
        np.testing.assert_array_equal(got.data["x"], 3000.0)
        _wait_for(lambda: t.snapshot()["frames_in"] == 1)
        snap = t.snapshot()
        assert snap["transport"] == "socket"
        assert snap["bytes_in"] > len(buf)
        assert snap["per_actor"][3]["frames"] == 1
        assert snap["torn_tails"] == 0 and snap["decode_errors"] == 0
        chan.send(st.KIND_CTRL, 0, st.CTRL_BYE)
        chan.close()
    finally:
        t.close()


@pytest.mark.timeout_s(60)
def test_client_handshake_assigns_ids_ships_config_and_refuses_extras():
    t = SocketTransport(capacity=8, policy="block", max_actors=2)
    t.config_extra = lambda aid: {"env": "bandit", "note": f"actor{aid}"}
    clients = []
    try:
        for expect in (0, 1):
            c = SocketActorClient(t.address, backoff=(0.01, 0.1))
            cfg = c.connect()
            clients.append(c)
            assert cfg["actor_id"] == expect and cfg["env"] == "bandit"
            assert cfg["note"] == f"actor{expect}"
            assert cfg["wire_codec"] == "none"
        extra = SocketActorClient(t.address, backoff=(0.01, 0.1),
                                  dial_timeout=5.0)
        assert extra.connect() is None
        assert extra.stopped and extra.refused
        assert clients[0].send_traj(_buf(0, 0))
        got = t.get(timeout=10.0)
        assert got is not None and got.actor_id == 0
        # versioned params over ctrl: "keep" without a source, the
        # encoded tree with one
        assert clients[1].pull_params(-1) == ("keep",)
        t.param_source = lambda have: (b"params", 4) if have < 4 else None
        assert clients[1].pull_params(-1) == ("params", 4, b"params")
        assert clients[1].pull_params(4) == ("keep",)
    finally:
        for c in clients:
            c.close()
        t.close()


@pytest.mark.timeout_s(60)
def test_codec_mismatch_refused_at_handshake():
    t = SocketTransport(capacity=8, policy="block")
    t.config_extra = lambda aid: {}
    t.wire_codec = "fp4-blocked"     # a learner build this side predates
    client = SocketActorClient(t.address, backoff=(0.01, 0.1))
    try:
        with pytest.raises(serde.CodecMismatchError, match="fp4-blocked"):
            client.connect()
        assert client.stopped
    finally:
        client.close(bye=False)
        t.close()


@pytest.mark.timeout_s(60)
def test_matching_codec_negotiates_and_accounts_bytes():
    t = SocketTransport(capacity=8, policy="block", wire_codec="bf16")
    t.config_extra = lambda aid: {}
    client = SocketActorClient(t.address, backoff=(0.01, 0.1))
    try:
        cfg = client.connect()
        assert cfg["wire_codec"] == "bf16" and client.wire_codec == "bf16"
        # the flow-control cap shrinks with a quantizing codec
        assert cfg["data_buf"] == max(
            SocketTransport.DATA_BUF_BYTES // SocketTransport.QUANT_BUF_DIV,
            SocketTransport.MIN_DATA_BUF)
        assert client.send_traj(_buf(cfg["actor_id"], 0, "bf16"))
        assert t.get(timeout=10.0) is not None
        snap = t.snapshot()
        assert snap["traj_raw_bytes"] > 1.5 * snap["traj_wire_bytes"]
    finally:
        client.close()
        t.close()


@pytest.mark.timeout_s(60)
def test_corrupt_frame_drops_connection_loudly_and_recovers():
    t = SocketTransport(capacity=8, policy="block")
    try:
        chan = _dial_data(t.address, actor_id=1)
        frame = bytearray(serde.pack_frame(st.KIND_TRAJ, 0, _buf(1, 0)))
        frame[serde.FRAME_HEADER_SIZE + 4] ^= 0x40      # flip one bit
        chan._sock.sendall(bytes(frame))
        _wait_for(lambda: t.snapshot()["decode_errors"] == 1,
                  msg="corruption detected")
        assert t.get_nowait() is None       # nothing decoded from it
        _wait_for(lambda: not t.snapshot()["per_actor"][1]["connected"],
                  msg="corrupt connection dropped")
        chan2 = _dial_data(t.address, actor_id=1)
        assert chan2.send(st.KIND_TRAJ, 0, _buf(1, 1))
        got = t.get(timeout=10.0)
        assert got is not None and int(got.data["seq"]) == 1
        assert t.snapshot()["per_actor"][1]["reconnects"] == 1
        chan2.close()
    finally:
        t.close()


@pytest.mark.timeout_s(60)
def test_a_frame_cut_mid_write_is_a_torn_tail_never_data():
    t = SocketTransport(capacity=8, policy="block")
    try:
        chan = _dial_data(t.address, actor_id=0)
        frame = serde.pack_frame(st.KIND_TRAJ, 0, _buf(0, 0))
        chan._sock.sendall(frame[:len(frame) // 2])
        chan.close()
        _wait_for(lambda: t.snapshot()["torn_tails"] == 1,
                  msg="torn tail counted")
        assert t.get_nowait() is None
    finally:
        t.close()


def test_supervision_and_groups_name_their_roadmap_items():
    """Supervision is ported: the transport takes the reaper's deadline
    and elastic membership (its snapshot shows both, the reaper thread
    ends with it). The SPMD learner is ported too: it refuses, with the
    reference's messages, a device count below one and a hub/spoke
    exchange beside its own."""
    import threading

    t = SocketTransport(heartbeat_timeout_s=5.0, elastic=True)
    try:
        assert t.heartbeat_timeout_s == 5.0
        snap = t.snapshot()
        assert snap["elastic"] is True and snap["lease_reaps"] == 0
        assert any(th.name == "socket-reaper"
                   for th in threading.enumerate())
    finally:
        t.close()
    assert not any(th.name == "socket-reaper"
                   for th in threading.enumerate())
    from repro_torch.distributed import NullExchange
    from repro_torch.distributed import runtime

    with pytest.raises(ValueError, match="spmd_devices must be >= 1"):
        run_async_training("bandit", _icfg(), num_envs=4, steps=1,
                           spmd_devices=-1, device="cpu")
    with pytest.raises(ValueError, match="cannot combine with a hub/spoke "
                       "exchange"):
        runtime._setup("bandit", _icfg(), 4, spmd_devices=2,
                       exchange=NullExchange(), device="cpu")


def _no_orphans(t0):
    deadline = time.monotonic() + 30
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert mp.active_children() == [], (
        f"orphans after {time.monotonic() - t0:.0f}s")


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("mode,codec", [("unroll", "none"),
                                        ("inference", "bf16")])
def test_remote_actors_train_over_loopback_and_close_cleanly(mode, codec):
    t0 = time.monotonic()
    _, metrics, tel = run_async_training(
        "bandit", _icfg(), num_envs=4, steps=6, num_actors=2,
        actor_backend="remote", actor_mode=mode, transport="socket",
        wire_codec=codec, queue_capacity=4, max_batch_trajs=2, seed=0,
        device="cpu")
    assert tel["learner_updates"] == tel["param_version"] == 6
    assert np.isfinite(float(metrics["loss/total"]))
    q = tel["queue"]
    assert q["transport"] == "socket" and q["wire_codec"] == codec
    assert q["frames_in"] >= 6
    assert q["decode_errors"] == 0 and q["torn_tails"] == 0
    assert q["remote_errors"] == 0
    assert tel["actors"]["backend"] == "remote"
    assert tel["lag"]["measured"] >= 6
    if mode == "inference":
        assert tel["inference"]["flushes"] > 0
    _no_orphans(t0)


@pytest.mark.timeout_s(120)
def test_listen_and_connect_run_a_learner_and_external_actors():
    """The deployment shape through the CLI: a learner with --listen
    waits; an actor machine with --connect contributes two children."""
    import threading

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    result = {}

    def both_dialed(step, params, metrics, snapshot_fn):
        # hold the first update until the second actor is in too
        _wait_for(lambda: snapshot_fn()["queue"]["actors_seen"] == 2,
                  timeout=60, msg="both actors dialed in")

    def learner():
        result["run"] = train_lib.train(
            ["--device", "cpu", "--runtime", "async", "--smoke",
             "--env", "catch", "--steps", "3", "--num-envs", "4",
             "--unroll", "5", "--actor-threads", "2",
             "--actor-backend", "remote", "--listen", f"127.0.0.1:{port}"],
            on_update=both_dialed)

    t = threading.Thread(target=learner)
    t.start()
    rc = train_lib.main(["--connect", f"127.0.0.1:{port}",
                         "--actor-threads", "2"])
    t.join(60)
    assert not t.is_alive()
    assert rc == 0
    tel = result["run"].telemetry
    assert tel["learner_updates"] == 3
    assert tel["queue"]["actors_seen"] == 2
