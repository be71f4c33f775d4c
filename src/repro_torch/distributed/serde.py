"""What flows through a transport, and the byte layout the replay ring
stores it in (``repro.distributed.serde``).

A ``TrajectoryItem`` (trajectory tree + provenance) is flattened into a
single spec-described contiguous byte buffer and restored *exactly*:
same nesting, same key order, same dtypes, same bits. The layout is the
JAX package's, byte for byte, so a buffer encoded by either package
decodes in the other::

    [4B magic 'RTJ1'][4B uint32 header length][header JSON utf-8][payload]

The header is a JSON *spec*: a recursive structure descriptor whose leaf
nodes carry ``(dtype, shape, byte offset, byte length)`` into the
payload, plus the item's provenance (param version, actor id,
produced_at). The payload is the leaves' raw bytes, concatenated in spec
order. Decoding is zero-copy: each leaf is a read-only numpy view into
the buffer.

Supported nodes: dict (string keys, insertion order kept), list, tuple,
None, and array leaves (numpy arrays, torch tensors, python scalars).
Only the raw wire codec ``"none"`` is ported: the lossy ``bf16``/``int8``
codecs, bfloat16 leaves and the frame layer come with the process and
socket transports (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

MAGIC = b"RTJ1"
_HDR = struct.Struct("<4sI")

# dtype registry: what a trajectory or parameter tree may carry
_DTYPES: Dict[str, np.dtype] = {
    np.dtype(t).name: np.dtype(t)
    for t in (np.float64, np.float32, np.float16, np.int64, np.int32,
              np.int16, np.int8, np.uint64, np.uint32, np.uint16, np.uint8,
              np.bool_, np.complex64, np.complex128)
}

WIRE_CODECS = ("none",)
DEFAULT_CODEC = "none"

_ITEM_10 = ("(ROADMAP.md, Queue 1 item 10: process and socket actor "
            "pools)")


@dataclasses.dataclass
class TrajectoryItem:
    """The trajectory tree plus the provenance needed for measured lag and
    per-actor accounting.

    ``host`` holds the leaves the learner reads on the host (``rewards``
    and ``done``, for the episode returns) as numpy arrays, copied by the
    actor while it finished the trajectory, so the learner's thread never
    waits on the device for them; None when ``data`` is on the host
    already. ``trace`` is the flight recorder's stamp dict (None: not
    sampled)."""
    data: PyTree
    param_version: int
    actor_id: int
    produced_at: float
    trace: Optional[Dict[str, float]] = None
    host: Optional[Dict[str, np.ndarray]] = None


class SerdeError(ValueError):
    pass


class CodecMismatchError(SerdeError):
    """A caller asked for a wire codec this side does not speak."""


def check_codec(codec: str) -> str:
    if codec not in WIRE_CODECS:
        raise CodecMismatchError(
            f"wire codec {codec!r} is not ported yet {_ITEM_10}; this "
            f"side speaks {', '.join(WIRE_CODECS)}")
    return codec


# ---------------------------------------------------------------------------
# encoding


def _as_array(leaf, path: str) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().cpu().numpy()
        except TypeError as e:        # bfloat16 has no numpy dtype
            raise SerdeError(f"leaf dtype {leaf.dtype} at {path} is not "
                             f"ported yet {_ITEM_10}") from e
    return np.asarray(leaf)


def _encode_node(tree: PyTree, chunks: List[bytes], offset: int,
                 path: str) -> Tuple[Dict[str, Any], int]:
    """Append ``tree``'s leaves to ``chunks`` (starting at byte ``offset``)
    and return (spec node, next offset)."""
    if tree is None:
        return {"t": "none"}, offset
    if isinstance(tree, dict):
        keys, children = [], []
        for k in tree:                      # insertion order IS the spec
            if not isinstance(k, str):
                raise SerdeError(f"non-string dict key {k!r} at {path}")
            node, offset = _encode_node(tree[k], chunks, offset,
                                        f"{path}/{k}")
            keys.append(k)
            children.append(node)
        return {"t": "dict", "keys": keys, "children": children}, offset
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        children = []
        for i, child in enumerate(tree):
            node, offset = _encode_node(child, chunks, offset,
                                        f"{path}[{i}]")
            children.append(node)
        return {"t": kind, "children": children}, offset
    # tobytes() gives a C-order copy whatever the strides, and keeps 0-d
    # shapes 0-d
    arr = _as_array(tree, path)
    name = arr.dtype.name
    if name not in _DTYPES:
        raise SerdeError(f"unsupported leaf dtype {name!r} at {path}")
    raw = arr.tobytes()
    chunks.append(raw)
    node = {"t": "a", "dtype": name, "shape": list(arr.shape),
            "off": offset, "n": len(raw)}
    return node, offset + len(raw)


def _pack(spec: Dict[str, Any], meta: Dict[str, Any],
          chunks: List[bytes]) -> bytes:
    header = json.dumps({"meta": meta, "tree": spec},
                        separators=(",", ":")).encode("utf-8")
    return b"".join([_HDR.pack(MAGIC, len(header)), header] + chunks)


def encode_tree(tree: PyTree, meta: Optional[Dict[str, Any]] = None,
                codec: str = DEFAULT_CODEC) -> bytes:
    """Flatten ``tree`` into one contiguous buffer. ``meta`` must be
    JSON-serializable; it rides in the header."""
    check_codec(codec)
    chunks: List[bytes] = []
    spec, _ = _encode_node(tree, chunks, 0, "$")
    return _pack(spec, meta or {}, chunks)


# ---------------------------------------------------------------------------
# decoding


def _decode_node(node: Dict[str, Any], payload: memoryview,
                 copy: bool) -> PyTree:
    t = node["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode_node(c, payload, copy)
                for k, c in zip(node["keys"], node["children"])}
    if t == "list":
        return [_decode_node(c, payload, copy) for c in node["children"]]
    if t == "tuple":
        return tuple(_decode_node(c, payload, copy)
                     for c in node["children"])
    if t == "a":
        dtype = _DTYPES.get(node["dtype"])
        if dtype is None:
            raise SerdeError(f"leaf dtype {node['dtype']!r} in spec is not "
                             f"ported yet {_ITEM_10}")
        if node.get("enc") is not None:
            raise SerdeError(f"{node['enc']!r}-encoded leaves (lossy wire "
                             f"codecs) are not ported yet {_ITEM_10}")
        off, n = node["off"], node["n"]
        arr = np.frombuffer(payload[off:off + n], dtype=dtype)
        arr = arr.reshape(node["shape"])
        return arr.copy() if copy else arr
    raise SerdeError(f"unknown spec node type {t!r}")


def decode_tree(buf: bytes, copy: bool = False
                ) -> Tuple[PyTree, Dict[str, Any]]:
    """Inverse of ``encode_tree``: returns (tree, meta). ``copy=False``
    decodes leaves as zero-copy read-only views of ``buf``."""
    if len(buf) < _HDR.size:
        raise SerdeError(f"buffer too short ({len(buf)} bytes)")
    magic, hlen = _HDR.unpack_from(buf)
    if magic != MAGIC:
        raise SerdeError(f"bad magic {magic!r} (expected {MAGIC!r})")
    start = _HDR.size
    header = json.loads(bytes(buf[start:start + hlen]).decode("utf-8"))
    payload = memoryview(buf)[start + hlen:]
    tree = _decode_node(header["tree"], payload, copy)
    return tree, header.get("meta", {})


# ---------------------------------------------------------------------------
# TrajectoryItem layer


def encode_item(item: TrajectoryItem, codec: str = DEFAULT_CODEC) -> bytes:
    """``item.data`` and its provenance. ``host`` is not encoded (decoded
    data is on the host already), nor is ``trace``: the flight recorder
    that stamps it joins with observability (ROADMAP.md, Queue 1 item
    13)."""
    check_codec(codec)
    meta = {
        "param_version": int(item.param_version),
        "actor_id": int(item.actor_id),
        "produced_at": float(item.produced_at),
    }
    chunks: List[bytes] = []
    spec, _ = _encode_node(item.data, chunks, 0, "$")
    return _pack(spec, meta, chunks)


def decode_item(buf: bytes, copy: bool = False) -> TrajectoryItem:
    data, meta = decode_tree(buf, copy=copy)
    trace = meta.get("trace")
    return TrajectoryItem(data, int(meta["param_version"]),
                          int(meta["actor_id"]),
                          float(meta["produced_at"]),
                          dict(trace) if trace else None)
