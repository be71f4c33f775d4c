"""The SPMD learner's process group (``--learner-mode spmd``): one learner
process whose train step runs on N ranks of a ``torch.distributed`` group.

The reference runs the step as a ``shard_map`` over a ``('data',)`` mesh
of N devices in one process. PyTorch has no ``shard_map``: the learner
process is rank 0, and ``StepRanks`` spawns ranks 1..N-1 as step workers
(``_step_rank``). Rank 0 owns the actors, the queue, the store and the
publishing; every rank holds a replica of the params and the optimizer
state, and every update runs ``core.learner.build_spmd_train_step`` (or
its replay twin) on all of them at once, each on its rows of the batch,
with the gradients' mean all-reduced inside the step.

Backends: NCCL on the card, one card a rank (rank r on ``cuda:r``: NCCL
refuses two ranks on one device), so N is at most the cards there are;
gloo on the CPU, where a rank is a process and any N >= 1 runs. Two
ranks that share one card run over gloo, which takes CUDA tensors for
``all_reduce`` and ``broadcast``; that is a caller's group
(``chip_smoke.py`` phase 27), not the learner's.

Each update rank 0 hands the ranks their rows, in collectives of the
group (in this order on every rank):

  header   a (7,) int64 tensor, broadcast: command (step or stop), the
           update index, whether the batch is replicated, the payload's
           bytes, the layout's id, whether it is a warm-up step, and how
           many times rank 0 has synced its replay target;
  layout   when the id is new, the batch's tree structure and each
           leaf's (shape, dtype) at one rank's rows, broadcast as an
           object;
  payload  the rows as one flat byte buffer a rank (every leaf's bytes,
           16-byte aligned): ``scatter`` when the rows divide by N (rank r
           gets the r-th N-th), ``broadcast`` of the whole batch when they
           do not (the rules' divisibility fallback: every rank steps on
           the whole batch).

At start the params and the optimizer state are broadcast from rank 0 in
one flat buffer each, so every replica starts from rank 0's (a resumed
run's included). Both sides build their steps with ``build_step_pair``.
A warm-up step runs on copies and is discarded on every rank. Rank 0
owns the replay target's policy: when the header's sync count is past a
step rank's, that rank snapshots its own params (equal to the copy rank
0 published after the last update) as its target before it steps.

No fallback hides a fault: a group that does not come up, or a step rank
that dies, ends the run with its error (``raise_errors``); nothing falls
back to one rank. One limit: over NCCL a rank that dies inside a
collective leaves rank 0 blocked in it until the group's timeout
(``_PG_TIMEOUT_S``) runs out; only then does ``raise_errors`` name the
dead rank. Over gloo the peers' closed sockets end the wait at once.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import sys
import traceback
import time
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import params as params_lib

_CMD_STOP, _CMD_STEP = 0, 1
# a collective waits this long for its peers before it fails (the first
# update waits for the actors' start-up and, on the card, for cuDNN)
_PG_TIMEOUT_S = 600.0
_JOIN_TIMEOUT_S = 30.0
_ALIGN = 16


def build_step_pair(arch, icfg, num_actions: int, mesh,
                    vtrace_impl: str = "auto"):
    """``(sharded, replicated, optimizer)``: the SPMD step on each rank's
    rows and its divisibility fallback on the whole batch (the replay
    twins when ``icfg.replay_fraction > 0``), sharing one optimizer. Rank
    0 and every step rank build their steps here."""
    from repro_torch.core import learner as learner_lib

    build = (learner_lib.build_spmd_replay_train_step
             if icfg.replay_fraction > 0.0
             else learner_lib.build_spmd_train_step)
    sharded, opt = build(arch, icfg, num_actions, mesh,
                         vtrace_impl=vtrace_impl)
    repl, _ = build(arch, icfg, num_actions, mesh, optimizer=opt,
                    vtrace_impl=vtrace_impl, batch_replicated=True)
    return sharded, repl, opt


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# byte packing: a list of tensors as one flat uint8 buffer and back


def layout_of(leaves: List[torch.Tensor]) -> Tuple[Tuple[Tuple[int, ...],
                                                         torch.dtype], ...]:
    return tuple((tuple(x.shape), x.dtype) for x in leaves)


def _offsets(layout) -> Tuple[List[int], int]:
    offs, at = [], 0
    for shape, dtype in layout:
        offs.append(at)
        n = torch.Size(shape).numel() * torch.empty(
            (), dtype=dtype).element_size()
        at += -(-n // _ALIGN) * _ALIGN
    return offs, at


def pack(leaves: List[torch.Tensor]) -> torch.Tensor:
    """The leaves' bytes in one uint8 buffer, each at a 16-byte offset
    (the padding zero: it is part of the bytes sent and digested)."""
    offs, total = _offsets(layout_of(leaves))
    out = torch.zeros(total, dtype=torch.uint8, device=leaves[0].device)
    for x, at in zip(leaves, offs):
        raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
        out[at:at + raw.numel()].copy_(raw)
    return out


def unpack(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """Views of ``buf`` shaped as ``layout``: ``pack``'s inverse."""
    offs, _ = _offsets(layout)
    out = []
    for (shape, dtype), at in zip(layout, offs):
        n = torch.Size(shape).numel() * torch.empty(
            (), dtype=dtype).element_size()
        out.append(buf[at:at + n].view(dtype).reshape(shape))
    return out


def params_crc(tree) -> int:
    """CRC-32 of the tree's leaves' bytes, in flatten order: equal
    replicas give equal CRCs."""
    import zlib

    return zlib.crc32(pack(params_lib.tree_leaves(tree)).cpu().numpy()
                      .tobytes())


def broadcast_tree(tree, src: int = 0) -> None:
    """Every leaf of ``tree`` (same structure on every rank) set to rank
    ``src``'s, in one broadcast."""
    import torch.distributed as dist

    leaves = params_lib.tree_leaves(tree)
    buf = pack(leaves)
    dist.broadcast(buf, src)
    with torch.no_grad():
        for x, y in zip(leaves, unpack(buf, layout_of(leaves))):
            x.copy_(y)


# ---------------------------------------------------------------------------
# rank 0's side


class StepRanks:
    """Rank 0's handle on the SPMD learner's group of ``n`` ranks: it
    spawns ranks 1..n-1 (``_step_rank``), joins the group as rank 0 and
    builds the ``('data',)`` mesh's DeviceMesh (``mesh``). ``spec`` is
    what a step rank needs to build its step: ``arch``, ``icfg``,
    ``num_actions``, ``vtrace_impl``, ``seed``.

    Where a group is already up (the CLI's ``--coord-addr``), a one-rank
    learner steps over it; a larger one is refused: the learner brings up
    its own group over its step ranks."""

    def __init__(self, n: int, device, spec: Dict[str, Any]):
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_data_mesh

        self.n = int(n)
        self.device = torch.device(device)
        self.mesh = make_data_mesh(self.n, self.device)
        # NCCL on the card (one card a rank), gloo on the CPU
        self.backend = "nccl" if self.device.type == "cuda" else "gloo"
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._layouts: Dict[Any, int] = {}
        self._owns_group = not dist.is_initialized()
        # each step rank's final params' CRC-32 (``params_crc``), sent
        # when it stops: equal to rank 0's, the replicas are identical
        self.replica_crcs: Dict[int, int] = {}
        self._closed = False
        if not self._owns_group:
            if dist.get_world_size() != 1 or self.n != 1:
                raise RuntimeError(
                    f"a process group of {dist.get_world_size()} rank(s) is "
                    f"already up: the SPMD learner brings up its own over "
                    f"its {self.n} step rank(s)")
        else:
            if self.device.type == "cuda":
                # build the kernels once, here: the ranks only load them
                from repro_torch.kernels import build
                build.build()
            addr = f"tcp://127.0.0.1:{free_port()}"
            ctx = mp.get_context("spawn")
            spec = dict(spec, num_threads=torch.get_num_threads(),
                        device=str(self.device))
            for r in range(1, self.n):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_step_rank,
                                args=(r, self.n, addr, self.backend, spec,
                                      child),
                                name=f"spmd-rank-{r}", daemon=True)
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device.index or 0)
                dist.init_process_group(
                    self.backend, init_method=addr, world_size=self.n,
                    rank=0, timeout=datetime.timedelta(seconds=_PG_TIMEOUT_S))
            except BaseException:
                self._terminate()
                raise
        self.dm = self.mesh.device_mesh(self.device.type)
        self.group = self.dm.get_group("data")
        self._header = torch.zeros(7, dtype=torch.int64, device=self.device)

    def share(self, tree) -> None:
        """Broadcast rank 0's ``tree`` (the params, then the optimizer
        state) to the step ranks."""
        broadcast_tree(tree, 0)

    def hand_out(self, batch, step: int, replicated: bool,
                 warm: bool = False, target_syncs: int = 0):
        """Send ``batch`` (rank 0's stacked batch, on its device) to the
        step ranks for update ``step``: each its rows, or all of it when
        ``replicated``. ``target_syncs``: how many times rank 0 has synced
        its replay target so far (a step rank behind it resyncs before it
        steps). Returns rank 0's own batch: its rows (views), or the batch
        itself."""
        import torch.distributed as dist

        from repro_torch.distributed.learner import _flatten, _unflatten

        leaves, structure = _flatten(batch)
        rows = leaves[0].shape[0]
        per = rows if replicated else rows // self.n
        shards = [[x[r * per:(r + 1) * per] for x in leaves]
                  for r in range(1 if replicated else self.n)]
        layout = (structure, layout_of(shards[0]))
        lid = self._layouts.get(layout)
        new = lid is None
        if new:
            lid = self._layouts[layout] = len(self._layouts)
        nbytes = _offsets(layout[1])[1]
        self._header.copy_(torch.tensor(
            [_CMD_STEP, step, int(replicated), nbytes, lid, int(warm),
             target_syncs]))
        if self.n > 1:
            dist.broadcast(self._header, 0)
            if new:
                dist.broadcast_object_list(
                    [layout], 0,
                    device=self.device if self.backend == "nccl" else None)
            if replicated:
                dist.broadcast(pack(leaves), 0)
            else:
                out = torch.empty(nbytes, dtype=torch.uint8,
                                  device=self.device)
                dist.scatter(out, [pack(s) for s in shards], 0)
        return _unflatten(structure, shards[0])

    def raise_errors(self, wait_s: float = 0.0) -> None:
        """Raise the error of a step rank that died, with its traceback
        where it sent one; ``wait_s``: how long to wait for one to die
        (after a collective of the group failed)."""
        deadline = time.monotonic() + wait_s
        while wait_s and time.monotonic() < deadline and \
                all(p.exitcode is None for p in self._procs):
            time.sleep(0.05)
        for r, (p, conn) in enumerate(zip(self._procs, self._conns), 1):
            if p.exitcode is None:
                continue
            msg = None
            try:
                while conn.poll():
                    got = conn.recv()
                    if got[0] == "error":
                        msg = got[2]
            except (EOFError, OSError):
                pass
            if msg is not None or p.exitcode != 0 or not self._closed:
                raise RuntimeError(
                    f"SPMD step rank {r} died (exit code {p.exitcode})"
                    + (f":\n{msg}" if msg else ""))

    def close(self) -> None:
        """Stop the step ranks (a stop header), collect their params'
        CRCs, join them and take the group down; a rank that does not
        stop is terminated."""
        import torch.distributed as dist

        if self._closed:
            return
        self._closed = True
        try:
            if self.n > 1 and all(p.exitcode is None for p in self._procs):
                self._header.zero_()
                dist.broadcast(self._header, 0)
        except Exception:           # a dead rank: raise_errors says which
            pass
        for r, (p, conn) in enumerate(zip(self._procs, self._conns), 1):
            try:
                if conn.poll(_JOIN_TIMEOUT_S):
                    got = conn.recv()
                    if got[0] == "done":
                        self.replica_crcs[r] = got[1]
            except (EOFError, OSError):
                pass
            p.join(timeout=_JOIN_TIMEOUT_S)
        self._terminate()
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()

    def _terminate(self) -> None:
        for p in self._procs:
            if p.exitcode is None:
                p.terminate()
                p.join(timeout=5)


# ---------------------------------------------------------------------------
# a step rank (spawn target)


def _step_rank(rank: int, n: int, addr: str, backend: str,
               spec: Dict[str, Any], conn) -> None:
    """One step rank of the SPMD learner: join the group, take rank 0's
    params and optimizer state, then step on every batch rank 0 hands out
    until it says stop. Sends ``("done", params_crc)`` or
    ``("error", rank, traceback)`` up its pipe and exits through
    ``os._exit`` with an honest code."""
    status = 1
    try:
        import torch.distributed as dist

        from repro_torch.core.driver import init_params
        from repro_torch.distributed.learner import _unflatten
        from repro_torch.launch.mesh import make_data_mesh

        torch.set_num_threads(int(spec["num_threads"]))
        base = torch.device(spec["device"])
        device = (torch.device("cuda", (base.index or 0) + rank)
                  if base.type == "cuda" else base)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(backend, init_method=addr, world_size=n,
                                rank=rank, timeout=datetime.timedelta(
                                    seconds=_PG_TIMEOUT_S))
        mesh = make_data_mesh(n, device)
        mesh.device_mesh(device.type)
        arch, icfg = spec["arch"], spec["icfg"]
        na, impl = spec["num_actions"], spec["vtrace_impl"]
        replay = icfg.replay_fraction > 0.0
        params = init_params(arch, na, spec["seed"], device)
        broadcast_tree(params)
        sharded, repl, opt = build_step_pair(arch, icfg, na, mesh, impl)
        opt_state = opt.init(params)
        broadcast_tree(opt_state)
        target = params_lib.snapshot(params) if replay else None
        synced = 0
        header = torch.zeros(7, dtype=torch.int64, device=device)
        layouts: List[Any] = []
        while True:
            dist.broadcast(header, 0)
            cmd, step, replicated, nbytes, lid, warm, syncs = \
                header.tolist()
            if cmd == _CMD_STOP:
                break
            if lid == len(layouts):
                got = [None]
                dist.broadcast_object_list(
                    got, 0, device=device if backend == "nccl" else None)
                layouts.append(got[0])
            structure, layout = layouts[lid]
            buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
            if replicated:
                dist.broadcast(buf, 0)
            else:
                dist.scatter(buf, None, 0)
            batch = _unflatten(structure, unpack(buf, layout))
            if replay and syncs != synced:
                # rank 0 synced its target to the params it published
                # after the last update: these params, on this rank
                target = params_lib.snapshot(params)
                synced = syncs
            p, o = ((params_lib.copy(params), params_lib.copy(opt_state))
                    if warm else (params, opt_state))
            step_fn = repl if replicated else sharded
            if replay:
                step_fn(p, target, o, step, batch)
            else:
                step_fn(p, o, step, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        conn.send(("done", params_crc(params)))
        status = 0
    except BaseException:
        try:
            conn.send(("error", rank, traceback.format_exc()))
        except (OSError, BrokenPipeError):
            pass
    finally:
        try:
            conn.close()
        except OSError:
            pass
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(status)
