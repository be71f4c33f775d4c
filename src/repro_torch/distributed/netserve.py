"""Network serving layer on top of ``socket_transport``
(``repro.distributed.netserve``): everything a *remote machine* needs
beyond the raw trajectory pipe.

Three pieces:

  config codec          the learner ships the entire run configuration
                        (env name, ``ArchConfig``, ``ImpalaConfig``,
                        seed, actor id, mode) inside the CONFIG
                        handshake frame, in the JAX package's JSON
                        scheme — a remote actor dials in knowing only
                        the learner's address. In a learner group the
                        handshake also carries the ``shard_map`` (every
                        learner's listen address), and a learner whose
                        shard is full refuses with that map, so the
                        client spills to a learner with a free slot.
  SocketInferenceFrontend / SocketInferenceClient
                        the ``InferenceService`` over TCP: observation
                        request frames ride the ctrl connection up,
                        action replies come back routed by client id —
                        a remote machine in inference mode holds *no
                        parameters at all*, only env stepping (on its
                        CPU, as every remote actor acts).
  remote actor entry    ``remote_actor_main`` drives one remote actor
                        end to end (handshake -> build env -> the same
                        loop bodies every other backend runs), and
                        ``remote_actor_child`` is its picklable spawn
                        target for loopback children.

Requests carry a monotonically increasing per-client ``seq``; replies
echo it. If the ctrl link dies with a request in flight, the client
resubmits on the fresh link and discards any reply whose seq is not the
one awaited — at-most-once delivery per step, so a reconnect can never
desynchronise the recurrent state an actor carries between steps.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ArchConfig, ImpalaConfig, SSMConfig
from repro_torch.distributed import serde
from repro_torch.distributed import socket_transport as st

_DATACLASSES = {cls.__name__: cls for cls in
                (ArchConfig, ImpalaConfig, SSMConfig)}


# ---------------------------------------------------------------------------
# config codec: frozen config dataclasses <-> JSON-able trees


def cfg_to_jsonable(obj: Any) -> Any:
    """Encode nested config dataclasses/tuples into plain JSON types.
    Tuples are tagged so the round trip restores them exactly (frozen
    dataclasses stay hashable only if their tuple-typed fields come back
    as tuples)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _DATACLASSES:
            raise ValueError(f"unregistered config dataclass {name!r}")
        return {"__dc__": name,
                "fields": {f.name: cfg_to_jsonable(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return {"__tuple__": [cfg_to_jsonable(v) for v in obj]}
    if isinstance(obj, list):
        return [cfg_to_jsonable(v) for v in obj]
    return obj


def cfg_from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__dc__" in obj:
            cls = _DATACLASSES[obj["__dc__"]]
            return cls(**{k: cfg_from_jsonable(v)
                          for k, v in obj["fields"].items()})
        if "__tuple__" in obj:
            return tuple(cfg_from_jsonable(v) for v in obj["__tuple__"])
        return {k: cfg_from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [cfg_from_jsonable(v) for v in obj]
    return obj


def build_actor_config(*, env_name: str, arch_cfg: ArchConfig,
                       icfg: ImpalaConfig, num_envs: int, seed: int,
                       mode: str, infer_streams: int = 1
                       ) -> Dict[str, Any]:
    """The CONFIG-handshake payload (minus the server-assigned
    ``actor_id``): everything a remote machine needs to act."""
    return {
        "env": env_name,
        "arch": cfg_to_jsonable(arch_cfg),
        "icfg": cfg_to_jsonable(icfg),
        "num_envs": int(num_envs),
        "seed": int(seed),
        "mode": mode,
        "infer_streams": int(infer_streams),
    }


# ---------------------------------------------------------------------------
# inference service over sockets


class SocketInferenceFrontend:
    """Learner-side bridge: INFER_REQ frames (arriving on remote actors'
    ctrl connections) into ``InferenceService.submit``; replies are
    encoded once and sent back on the same connection, routed by client
    id in the frame's stream field. Mirrors ``ProcessFrontend``'s
    shutdown discipline: ``begin_shutdown`` answers every request with
    the stop sentinel so remote clients wind down promptly."""

    def __init__(self, service, transport: st.SocketTransport,
                 streams: int = 1):
        self._svc = service
        self._transport = transport
        self._streams = max(1, streams)
        self._paused_cids: set = set()
        # clients are counted on their FIRST request and uncounted when
        # their ctrl connection drops — the service's all-clients-ready
        # rule must track who can actually submit right now, not who
        # might eventually dial in (up-front counting would make every
        # batch wait out the flush timeout until the last remote
        # machine connects)
        self._seen_cids: set = set()
        self._cid_lock = threading.Lock()
        self._discard = False
        transport.handlers[st.KIND_INFER_REQ] = self._on_request
        transport.ctrl_handler = self._on_ctrl
        transport.on_ctrl_gone = self._on_ctrl_gone
        service.attach_frontend(self, num_clients=0)

    def _count_client(self, cid: int) -> None:
        with self._cid_lock:
            if cid in self._seen_cids:
                return
            self._seen_cids.add(cid)
        with self._svc._lock:
            self._svc._clients += 1

    def _on_ctrl_gone(self, actor_id: int) -> None:
        """The actor's ctrl link dropped: it can neither submit nor
        receive replies until it reconnects, so its clients leave the
        ready rule and any pause hints it left behind are cleared (a
        crashed-while-paused actor must not skew batches forever; on
        reconnect its first request re-counts it, and it re-pauses if
        still backpressured)."""
        for s in range(self._streams):
            cid = actor_id * self._streams + s
            with self._cid_lock:
                seen = cid in self._seen_cids
                self._seen_cids.discard(cid)
            if seen:
                self._svc._disconnect()
            if cid in self._paused_cids:
                self._paused_cids.discard(cid)
                self._svc._resume()

    def _reply_fn(self, chan: st.FrameChannel, cid: int, seq: int):
        import numpy as np

        def reply(r) -> None:
            if r is None:
                buf = b""                       # stop sentinel
            else:
                buf = serde.encode_tree(
                    {"action": np.asarray(r.action),
                     "logprob": np.asarray(r.logprob),
                     "lstm_h": np.asarray(r.lstm_state[0]),
                     "lstm_c": np.asarray(r.lstm_state[1])},
                    meta={"version": int(r.param_version),
                          "seq": int(seq)})
            # bounded send: this runs on the service's flush thread (or
            # a leader client's), shared by every actor — a partitioned
            # peer whose TCP buffer is full must not wedge the fleet's
            # inference. Past the deadline the link is marked dead and
            # the reply dropped; the client resubmits after reconnect.
            deadline = time.monotonic() + 5.0
            if not chan.send(st.KIND_INFER_REP, cid, buf,
                             stop=lambda: time.monotonic() > deadline):
                chan.close()    # wedged link: drop it, the client's
                # reconnect + resubmit machinery takes over

        return reply

    def _on_request(self, chan: st.FrameChannel, cid: int,
                    payload: bytes) -> None:
        try:
            data, meta = serde.decode_tree(payload)  # payload owns bytes
        except serde.SerdeError as e:
            self._svc.errors.append(e)
            return
        seq = int(meta.get("seq", 0))
        if self._discard or self._svc.closed:
            self._reply_fn(chan, cid, seq)(None)
            return
        self._count_client(cid)
        # submitted_at is stamped HERE, on the learner's clock: the
        # request's meta t0 is a *remote* CLOCK_MONOTONIC reading whose
        # origin is unrelated to ours — trusting it would make the
        # flush-timeout rule fire never (remote clock ahead) or always
        # (behind), destroying the dynamic batching cross-machine
        if not self._svc.submit(data, self._reply_fn(chan, cid, seq),
                                time.monotonic()):
            self._reply_fn(chan, cid, seq)(None)

    def _on_ctrl(self, cid: int, payload: bytes) -> None:
        # pause/resume hints, deduplicated per client id so repeated or
        # reordered frames never over-/under-count the paused total
        if payload == st.CTRL_PAUSE and cid not in self._paused_cids:
            self._paused_cids.add(cid)
            self._svc._pause()
        elif payload == st.CTRL_RESUME and cid in self._paused_cids:
            self._paused_cids.discard(cid)
            self._svc._resume()

    def begin_shutdown(self) -> None:
        self._discard = True

    close = begin_shutdown


class SocketInferenceClient:
    """Remote-side inference handle, one per pipeline stream: the same
    submit_async/wait/infer/pause/resume surface as
    ``PipeInferenceClient``, but over the shared ``SocketActorClient``
    ctrl link with seq-tagged at-most-once delivery."""

    def __init__(self, net: st.SocketActorClient, client_id: int):
        self._net = net
        self._id = client_id
        self._box = net.infer_box(client_id)
        self._seq = 0
        self._paused = False

    def bind_stop(self, stop_event: Any) -> None:
        pass                    # stop flows through the net client

    def submit_async(self, data: Any) -> Optional[Dict[str, Any]]:
        self._seq += 1
        buf = serde.encode_tree(data, meta={"client": self._id,
                                            "seq": self._seq,
                                            "t0": time.monotonic()})
        gen = self._net.ctrl_gen()
        if not self._net.ctrl_send(st.KIND_INFER_REQ, self._id, buf):
            return None
        return {"seq": self._seq, "buf": buf, "gen": gen}

    def wait(self, token: Optional[Dict[str, Any]]):
        from repro_torch.distributed.inference import InferenceReply
        if token is None:
            return None
        while not self._net.stopped:
            payload = self._box.get(timeout=0.2)
            if payload is None:
                # nothing yet: redial if the link died (waiters are the
                # only ones who notice) — if the generation moved, the
                # request may be gone with the old link, so resubmit
                if self._net.ensure_ctrl() is None:
                    return None
                gen = self._net.ctrl_gen()
                if gen != token["gen"]:
                    token["gen"] = gen
                    if not self._net.ctrl_send(st.KIND_INFER_REQ,
                                               self._id, token["buf"]):
                        return None
                continue
            if payload == b"":
                return None                     # service shut down
            tree, meta = serde.decode_tree(payload, copy=True)
            if int(meta.get("seq", -1)) != token["seq"]:
                continue        # stale duplicate from a resubmit race
            return InferenceReply(tree["action"], tree["logprob"],
                                  (tree["lstm_h"], tree["lstm_c"]),
                                  int(meta["version"]))
        return None

    def infer(self, data: Any):
        return self.wait(self.submit_async(data))

    def pause(self) -> None:
        if not self._paused:
            self._paused = True
            self._net.ctrl_send(st.KIND_CTRL, self._id, st.CTRL_PAUSE)

    def resume(self) -> None:
        if self._paused:
            self._paused = False
            self._net.ctrl_send(st.KIND_CTRL, self._id, st.CTRL_RESUME)

    def close(self) -> None:
        self.resume()


# ---------------------------------------------------------------------------
# remote actor entry points


class _ComposedStop:
    """threading.Event-alike that also honours an external (possibly
    multiprocessing) stop event and the net client's learner-sent stop."""

    def __init__(self, net: st.SocketActorClient,
                 ext: Optional[Any] = None):
        self._net = net
        self._ext = ext
        self._local = threading.Event()

    def set(self) -> None:
        self._local.set()

    def is_set(self) -> bool:
        return self._local.is_set() or self._net.stopped or (
            self._ext is not None and self._ext.is_set())

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while True:
            if self.is_set():
                return True
            remaining = 0.1 if deadline is None else \
                min(0.1, deadline - time.monotonic())
            if remaining <= 0:
                return False
            if self._local.wait(remaining):
                return True


def remote_actor_main(address, stop_event: Optional[Any] = None,
                      *, backoff=(0.05, 1.0),
                      dial_timeout: float = 60.0) -> Optional[str]:
    """Run ONE remote actor against the learner at ``address``.

    Everything else — actor id, env, arch, impala config, seed, actor
    mode — arrives in the CONFIG handshake, so a remote machine needs
    only this function and a reachable address. ``address`` may be any
    learner of a group: a full learner refuses with the shard map and the
    client spills to one with a free slot. Returns None on a clean run,
    or the error traceback string (also reported to the learner over the
    ctrl link) on failure."""
    from repro_torch.distributed import runner

    net = st.SocketActorClient(tuple(address), stop_event=stop_event,
                               backoff=backoff,
                               dial_timeout=dial_timeout)
    cfg = net.connect()
    if cfg is None:
        net.close(bye=False)
        if net.refused:
            return (f"refused by learner at {address[0]}:{address[1]}: "
                    "no free actor slot (every learner in the shard "
                    "map has live actors on all its slots)")
        if net.dial_failed:
            return (f"could not reach learner at "
                    f"{address[0]}:{address[1]} (dial timeout)")
        return None if net.stopped else "connect failed"
    stop = _ComposedStop(net, stop_event)
    if tuple(net.connected_addr) != tuple(address):
        # the refusal's shard map landed us on another learner
        h, p = net.connected_addr
        print(f"actor {cfg.get('actor_id')}: spilled to learner "
              f"{h}:{p}", flush=True)
    try:
        runner._tune_child_scheduling(int(cfg["actor_id"]))
        arch_cfg = cfg_from_jsonable(cfg["arch"])
        icfg = cfg_from_jsonable(cfg["icfg"])
        common = dict(actor_id=int(cfg["actor_id"]),
                      env_name=cfg["env"], arch_cfg=arch_cfg, icfg=icfg,
                      num_envs=int(cfg["num_envs"]),
                      seed=int(cfg["seed"]), send_buf=net.send_traj,
                      stop=stop,
                      # negotiated at the handshake: check_codec already
                      # vetted it (an unknown codec refused the dial)
                      wire_codec=net.wire_codec)
        if cfg.get("mode", "unroll") == "inference":
            clients: List[SocketInferenceClient] = [
                SocketInferenceClient(
                    net, int(cfg["actor_id"]) *
                    int(cfg.get("infer_streams", 1)) + s)
                for s in range(int(cfg.get("infer_streams", 1)))]
            runner.run_serialized_inference_actor(
                infer_clients=clients, **common)
        else:
            runner.run_serialized_unroll_actor(
                pull_msg=net.pull_params, **common)
    except BaseException:
        text = traceback.format_exc()
        net.send_error(text)
        net.close(bye=True)
        return text
    net.close(bye=True)
    if net.dial_failed:
        return ("lost connection to learner at "
                f"{address[0]}:{address[1]} (dial timeout exhausted)")
    return None


def remote_actor_child(address, stop_event) -> None:
    """Picklable spawn target for loopback remote-actor children (the
    single-box path); real remote machines call ``remote_actor_main``
    (or ``launch.train --connect``) directly. The exit code says whether
    the actor failed; its traceback went to the learner over the ctrl
    link."""
    import os
    err = remote_actor_main(tuple(address), stop_event)
    os._exit(0 if err is None else 1)
