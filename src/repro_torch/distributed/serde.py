"""What flows through a transport, and the byte layout every wire and the
replay ring carry it in (``repro.distributed.serde``).

A ``TrajectoryItem`` (trajectory tree + provenance) is flattened into a
single spec-described contiguous byte buffer and restored *exactly*:
same nesting, same key order, same dtypes (bfloat16 included), same
bits. The layout is the JAX package's, byte for byte, under every wire
codec, so a buffer encoded by either package decodes in the other::

    [4B magic 'RTJ1'][4B uint32 header length][header JSON utf-8][payload]

The header is a JSON *spec*: a recursive structure descriptor whose leaf
nodes carry ``(dtype, shape, byte offset, byte length)`` into the
payload, plus the item's provenance (param version, actor id,
produced_at). The payload is the leaves' raw bytes, concatenated in spec
order. Decoding is zero-copy: each leaf is a read-only numpy view into
the buffer (bfloat16 leaves, which numpy has no dtype for, decode to
``torch.bfloat16`` tensors).

Supported nodes: dict (string keys, insertion order kept), list, tuple,
None, and array leaves (numpy arrays, torch tensors, python scalars).

Wire codecs: ``"none"`` is the raw little-endian wire, bit-exact.
``"bf16"`` ships float32/float64 leaves as bfloat16, rounded to nearest
even (a float64 leaf rounds through float32 first, as ``ml_dtypes``
does); ``"int8"`` ships them as int8 with a per-leaf absmax scale (max
abs error absmax/127). Under either lossy codec every leaf that is not
quantized rides deflate-compressed (level 1, leaves of 64 bytes and
more) when that is smaller. The spec stays per-leaf self-describing: a
leaf node carries its *logical* dtype plus an ``enc`` tag
(``bf16``/``q8``/``z``) and, for ``q8``, the scale, so decode always
restores the logical dtype and shape. Trajectory items quantize only
their observation side (``_traj_select``); the leaves V-trace reads
(rewards, discounts, behaviour log-probs) stay bit-exact.

The frame layer (``pack_frame`` and friends) is the socket transport's
unit of transmission. This module imports neither jax nor ``ml_dtypes``:
the bfloat16 rounding is done on the bits with numpy.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

MAGIC = b"RTJ1"
_HDR = struct.Struct("<4sI")

# dtype registry: what a trajectory or parameter tree may carry
# (bfloat16 is handled apart: numpy has no dtype for it)
_DTYPES: Dict[str, np.dtype] = {
    np.dtype(t).name: np.dtype(t)
    for t in (np.float64, np.float32, np.float16, np.int64, np.int32,
              np.int16, np.int8, np.uint64, np.uint32, np.uint16, np.uint8,
              np.bool_, np.complex64, np.complex128)
}
BF16 = "bfloat16"

WIRE_CODECS = ("none", "bf16", "int8")
DEFAULT_CODEC = "none"

# deflate: the cheapest level (the compressible leaves crush at any
# level, and the actor's encode sits on the trajectory hot path); leaves
# smaller than the floor are not worth a deflate header
_Z_LEVEL = 1
_Z_MIN_BYTES = 64


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
    """A peer announced (or a caller asked for) a wire codec this side
    does not speak: a handshake refuses loudly instead of feeding garbage
    to a decoder."""


def check_codec(codec: str) -> str:
    if codec not in WIRE_CODECS:
        raise CodecMismatchError(
            f"unsupported wire codec {codec!r} "
            f"(this side speaks {', '.join(WIRE_CODECS)})")
    return codec


# ---------------------------------------------------------------------------
# bfloat16 on the bits


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 patterns of a float32/float64 array, rounded to
    nearest even; float64 goes through float32 first, and NaN becomes the
    quiet NaN 0x7fc0 with its sign (``ml_dtypes``' rounding)."""
    with np.errstate(invalid="ignore", over="ignore"):
        f = arr.astype(np.float32, order="C")
    u = f.view(np.uint32)
    rounded = ((u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))))
               >> 16).astype(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        sign = ((u >> 16) & np.uint32(0x8000)).astype(np.uint16)
        rounded = np.where(nan, sign | np.uint16(0x7FC0), rounded)
    return rounded


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """float32 values of uint16 bfloat16 patterns (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# encoding


def _as_leaf(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array of the leaf's bytes, logical dtype name). A bfloat16
    tensor is carried as its uint16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().view(torch.int16).numpy().view(np.uint16), BF16
        return t.cpu().numpy(), ""
    arr = np.asarray(leaf)
    return arr, ""


def _encode_leaf(arr: np.ndarray, name: str, path: str, codec: str,
                 select) -> Tuple[bytes, Dict[str, Any]]:
    """One leaf's payload bytes + the spec fields beyond dtype/shape.

    ``codec != "none"``: float32/float64 leaves passing ``select`` are
    quantized (``enc``: ``bf16`` or ``q8`` + per-leaf ``scale``); every
    other leaf is deflated when that wins (``enc``: ``z``)."""
    raw = arr.tobytes()                      # contiguous little-endian copy
    if codec == "none":
        return raw, {}
    quantizable = (name != BF16 and arr.dtype.kind == "f" and
                   arr.itemsize >= 4 and arr.size > 0 and
                   (select is None or select(path, arr)))
    if quantizable:
        if codec == "bf16":
            return f32_to_bf16_bits(arr).tobytes(), {"enc": "bf16"}
        if codec == "int8":
            absmax = float(np.max(np.abs(arr)))
            if np.isfinite(absmax):
                scale = absmax / 127.0
                if scale == 0.0:
                    q = np.zeros(arr.shape, np.int8)
                else:
                    q = np.clip(np.rint(arr / scale), -127,
                                127).astype(np.int8)
                return q.tobytes(), {"enc": "q8", "scale": scale}
            # non-finite leaves (inf/nan) have no absmax scale: ship raw
        else:
            raise CodecMismatchError(f"unsupported wire codec {codec!r}")
    if len(raw) >= _Z_MIN_BYTES:
        z = zlib.compress(raw, _Z_LEVEL)
        if len(z) < len(raw):
            return z, {"enc": "z"}
    return raw, {}


def _encode_node(tree: PyTree, chunks: List[bytes], offset: int,
                 path: str, codec: str = DEFAULT_CODEC,
                 select=None) -> Tuple[Dict[str, Any], int]:
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
                                        f"{path}/{k}", codec, select)
            keys.append(k)
            children.append(node)
        return {"t": "dict", "keys": keys, "children": children}, offset
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        children = []
        for i, child in enumerate(tree):
            node, offset = _encode_node(child, chunks, offset,
                                        f"{path}[{i}]", codec, select)
            children.append(node)
        return {"t": kind, "children": children}, offset
    arr, name = _as_leaf(tree)
    name = name or arr.dtype.name
    if name != BF16 and name not in _DTYPES:
        raise SerdeError(f"unsupported leaf dtype {name!r} at {path}")
    stored, extra = _encode_leaf(arr, name, path, codec, select)
    chunks.append(stored)
    node = {"t": "a", "dtype": name, "shape": list(arr.shape),
            "off": offset, "n": len(stored)}
    node.update(extra)
    return node, offset + len(stored)


def _pack(spec: Dict[str, Any], meta: Dict[str, Any],
          chunks: List[bytes]) -> bytes:
    header = json.dumps({"meta": meta, "tree": spec},
                        separators=(",", ":")).encode("utf-8")
    return b"".join([_HDR.pack(MAGIC, len(header)), header] + chunks)


def tree_spec(tree: PyTree, codec: str = DEFAULT_CODEC) -> Dict[str, Any]:
    """The structure descriptor alone (offsets included): what the header
    carries."""
    spec, _ = _encode_node(tree, [], 0, "$", codec)
    return spec


def tree_nbytes(tree: PyTree) -> int:
    """Raw (uncompressed) leaf bytes of ``tree``: the denominator of the
    wire-compression accounting. Reads no device memory."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.element_size() * tree.numel()
    return np.asarray(tree).nbytes


def encode_tree(tree: PyTree, meta: Optional[Dict[str, Any]] = None,
                codec: str = DEFAULT_CODEC, select=None) -> bytes:
    """Flatten ``tree`` into one contiguous buffer. ``meta`` must be
    JSON-serializable; it rides in the header. ``codec``/``select`` pick
    the wire codec (module docstring)."""
    check_codec(codec)
    chunks: List[bytes] = []
    spec, _ = _encode_node(tree, chunks, 0, "$", codec, select)
    return _pack(spec, meta or {}, chunks)


# ---------------------------------------------------------------------------
# decoding


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def _decode_encoded_leaf(node: Dict[str, Any], stored: memoryview):
    """Restore one quantized/deflated leaf to its logical dtype/shape."""
    enc, shape, name = node["enc"], node["shape"], node["dtype"]
    try:
        if enc == "z":
            raw = zlib.decompress(bytes(stored))
            if name == BF16:
                return _bf16_tensor(np.frombuffer(
                    raw, np.uint16).reshape(shape))
            return np.frombuffer(raw, dtype=_DTYPES[name]).reshape(
                shape).copy()
        dtype = _DTYPES[name]
        if enc == "bf16":
            src = np.frombuffer(stored, dtype=np.uint16).reshape(shape)
            return bf16_bits_to_f32(src).astype(dtype)
        if enc == "q8":
            src = np.frombuffer(stored, dtype=np.int8).reshape(shape)
            out = src.astype(dtype)
            np.multiply(out, dtype.type(node["scale"]), out=out)
            return out
    except (zlib.error, ValueError, KeyError) as e:
        raise SerdeError(f"corrupt {enc!r}-encoded leaf: {e}") from e
    raise SerdeError(f"unknown leaf encoding {enc!r}")


def _decode_leaf(node: Dict[str, Any], payload: memoryview, copy: bool):
    name = node["dtype"]
    if name != BF16 and name not in _DTYPES:
        raise SerdeError(f"unknown dtype in spec: {name!r}")
    off, n = node["off"], node["n"]
    stored = payload[off:off + n]
    if node.get("enc") is not None:
        # encoded leaves always allocate (the dequantized/inflated array
        # cannot be a view of the wire buffer)
        return _decode_encoded_leaf(node, stored)
    if name == BF16:
        return _bf16_tensor(np.frombuffer(stored, np.uint16).reshape(
            node["shape"]))
    arr = np.frombuffer(stored, dtype=_DTYPES[name]).reshape(node["shape"])
    return arr.copy() if copy else arr


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
        return _decode_leaf(node, payload, copy)
    raise SerdeError(f"unknown spec node type {t!r}")


def _header(buf: bytes) -> Tuple[Dict[str, Any], memoryview]:
    if len(buf) < _HDR.size:
        raise SerdeError(f"buffer too short ({len(buf)} bytes)")
    magic, hlen = _HDR.unpack_from(buf)
    if magic != MAGIC:
        raise SerdeError(f"bad magic {magic!r} (expected {MAGIC!r})")
    start = _HDR.size
    try:
        header = json.loads(bytes(buf[start:start + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise SerdeError(f"corrupt header: {e}") from e
    return header, memoryview(buf)[start + hlen:]


def decode_tree(buf: bytes, copy: bool = False
                ) -> Tuple[PyTree, Dict[str, Any]]:
    """Inverse of ``encode_tree``: returns (tree, meta). ``copy=False``
    decodes leaves as zero-copy read-only views of ``buf``."""
    header, payload = _header(buf)
    tree = _decode_node(header["tree"], payload, copy)
    return tree, header.get("meta", {})


def _fill_node(node: Dict[str, Any], payload: memoryview, dst: PyTree,
               path: str) -> None:
    t = node["t"]
    if t == "none":
        if dst is not None:
            raise SerdeError(f"structure mismatch at {path}: buffer has "
                             f"None, destination has {type(dst).__name__}")
        return
    if t == "dict":
        if not isinstance(dst, dict) or list(dst) != node["keys"]:
            raise SerdeError(f"structure mismatch at {path}: dict keys "
                             f"differ")
        for k, c in zip(node["keys"], node["children"]):
            _fill_node(c, payload, dst[k], f"{path}/{k}")
        return
    if t in ("list", "tuple"):
        if not isinstance(dst, (list, tuple)) or \
                len(dst) != len(node["children"]):
            raise SerdeError(f"structure mismatch at {path}: sequence "
                             f"arity differs")
        for i, c in enumerate(node["children"]):
            _fill_node(c, payload, dst[i], f"{path}[{i}]")
        return
    if t == "a":
        name = node["dtype"]
        if isinstance(dst, torch.Tensor):
            have = str(dst.dtype).replace("torch.", "")
        else:
            have = getattr(getattr(dst, "dtype", None), "name", None)
        if have != name or list(getattr(dst, "shape", ())) != node["shape"]:
            raise SerdeError(f"leaf mismatch at {path}: buffer is "
                             f"{name}{node['shape']}, destination is "
                             f"{have}{list(getattr(dst, 'shape', ()))}")
        src = _decode_leaf(node, payload, copy=False)
        if isinstance(dst, torch.Tensor):
            with torch.no_grad():
                dst.copy_(src if isinstance(src, torch.Tensor)
                          else torch.from_numpy(np.array(src)))
        elif isinstance(dst, np.ndarray):
            np.copyto(dst, src)
        else:
            raise SerdeError(f"leaf at {path} is not writable in place")
        return
    raise SerdeError(f"unknown spec node type {t!r}")


def decode_tree_into(buf: bytes, dst: PyTree) -> Dict[str, Any]:
    """Decode ``buf`` *into* an existing tree of writable leaves (numpy
    arrays or CPU tensors), in place: the steady-state receive path for
    repeated same-shaped payloads (a child's params at every published
    version). Structure, dtypes and shapes must match the buffer's spec
    exactly; a mismatch raises ``SerdeError`` naming the path, and the
    caller falls back to a fresh decode. Returns the header meta."""
    header, payload = _header(buf)
    _fill_node(header["tree"], payload, dst, "$")
    return header.get("meta", {})


# ---------------------------------------------------------------------------
# TrajectoryItem layer


# trajectory leaves a lossy codec may quantize: the observation side (the
# image/token inputs and the recurrent state the unroll starts from). The
# V-trace-critical scalars (rewards, discounts, behaviour_logprob) stay
# bit-exact: quantizing the behaviour policy's log-probs would corrupt
# the importance weights the correction is built on.
_TRAJ_QUANT_KEYS = ("obs_image", "obs_token", "lstm_state")


def _traj_select(path: str, arr: np.ndarray) -> bool:
    return any(f"/{k}" in path for k in _TRAJ_QUANT_KEYS)


def encode_item(item: TrajectoryItem, codec: str = DEFAULT_CODEC) -> bytes:
    """``item.data`` and its provenance. ``host`` is not encoded (decoded
    data is on the host already). A sampled item's ``trace`` rides in the
    meta, stamped with ``e1`` once the payload bytes are built: the stamp
    still fits in the header that closes over those bytes, so the
    receiver sees when encoding finished. The sender's dict is left as
    it was."""
    meta = {
        "param_version": int(item.param_version),
        "actor_id": int(item.actor_id),
        "produced_at": float(item.produced_at),
    }
    check_codec(codec)
    chunks: List[bytes] = []
    spec, _ = _encode_node(item.data, chunks, 0, "$", codec, _traj_select)
    if item.trace is not None:
        meta["trace"] = dict(item.trace, e1=time.monotonic())
    return _pack(spec, meta, chunks)


def decode_item(buf: bytes, copy: bool = False) -> TrajectoryItem:
    data, meta = decode_tree(buf, copy=copy)
    trace = meta.get("trace")
    return TrajectoryItem(data, int(meta["param_version"]),
                          int(meta["actor_id"]),
                          float(meta["produced_at"]),
                          dict(trace) if trace else None)


# ---------------------------------------------------------------------------
# gradient exchange payloads (the learner group's frames): a flat list of
# gradient leaves plus the round bookkeeping. The tree structure is not
# shipped: every learner of a data-parallel group holds the same
# parameter structure.


def encode_grads(leaves: List[Any], *, round_idx: int, learner_id: int,
                 version: int = -1, codec: str = DEFAULT_CODEC) -> bytes:
    """One gradient-exchange payload: ``leaves`` in flatten order,
    stamped with the update round and sender (``version``: the hub's
    delegated publish version; spokes send -1)."""
    return encode_tree(list(leaves), meta={
        "round": int(round_idx),
        "learner": int(learner_id),
        "version": int(version),
    }, codec=codec)


def decode_grads(buf: bytes, copy: bool = False
                 ) -> Tuple[List[Any], Dict[str, Any]]:
    """Inverse of ``encode_grads``: (leaves, meta with round / learner /
    version)."""
    leaves, meta = decode_tree(buf, copy=copy)
    if not isinstance(leaves, list):
        raise SerdeError(f"gradient payload must decode to a list of "
                         f"leaves, got {type(leaves).__name__}")
    return leaves, meta


# ---------------------------------------------------------------------------
# wire framing (the socket transport's unit of transmission)
#
# Each message travels as a frame::
#
#     [4B magic 'RFR1'][1B kind][4B uint32 stream id]
#     [4B uint32 payload length][4B crc32(payload)][payload]
#
# ``kind`` multiplexes message types over one connection; ``stream_id``
# is kind-specific routing (client id, ...). The CRC covers the kind,
# stream and length fields AND the payload, so a flipped bit in the
# routing fields or the payload is a loud ``SerdeError`` at the receiver
# rather than a valid payload delivered to the wrong client. A frame that
# ends early (peer killed mid-write) is detected by length, never
# delivered.


FRAME_MAGIC = b"RFR1"
_FRAME_HDR = struct.Struct("<4sBIII")      # magic, kind, stream, len, crc
_FRAME_META = struct.Struct("<BII")        # the crc-covered header part
FRAME_HEADER_SIZE = _FRAME_HDR.size
# sanity cap: a corrupt length field must not provoke a giant allocation
MAX_FRAME_PAYLOAD = 1 << 30


def frame_crc(kind: int, stream_id: int, payload: bytes) -> int:
    """crc32 over (kind, stream_id, length, payload), no payload copy."""
    meta = _FRAME_META.pack(kind, stream_id, len(payload))
    return zlib.crc32(payload, zlib.crc32(meta))


def pack_frame(kind: int, stream_id: int, payload: bytes = b"") -> bytes:
    """One wire frame: header (magic/kind/stream/length/crc) + payload."""
    if not 0 <= kind <= 0xFF:
        raise SerdeError(f"frame kind must fit a byte, got {kind}")
    if not 0 <= stream_id <= 0xFFFFFFFF:
        raise SerdeError(f"stream id must fit uint32, got {stream_id}")
    if len(payload) > MAX_FRAME_PAYLOAD:
        raise SerdeError(f"payload too large ({len(payload)} bytes)")
    return _FRAME_HDR.pack(FRAME_MAGIC, kind, stream_id, len(payload),
                           frame_crc(kind, stream_id, payload)) + payload


def parse_frame_header(hdr: bytes) -> Tuple[int, int, int, int]:
    """Validate a 17-byte frame header; returns (kind, stream_id, payload
    length, expected crc32). Bad magic or an implausible length raise
    ``SerdeError``: the stream is desynchronised and the caller drops the
    connection (a byte stream has no way to re-find frame boundaries)."""
    if len(hdr) != FRAME_HEADER_SIZE:
        raise SerdeError(f"frame header must be {FRAME_HEADER_SIZE} "
                         f"bytes, got {len(hdr)}")
    magic, kind, stream_id, length, crc = _FRAME_HDR.unpack(hdr)
    if magic != FRAME_MAGIC:
        raise SerdeError(f"bad frame magic {magic!r} "
                         f"(expected {FRAME_MAGIC!r})")
    if length > MAX_FRAME_PAYLOAD:
        raise SerdeError(f"implausible frame length {length}")
    return kind, stream_id, length, crc


def verify_frame_payload(kind: int, stream_id: int, payload: bytes,
                         crc: int) -> None:
    """CRC check over routing fields + payload; ``SerdeError`` on
    mismatch (corrupt frame)."""
    actual = frame_crc(kind, stream_id, payload)
    if actual != crc:
        raise SerdeError(f"frame crc mismatch: header says {crc:#010x}, "
                         f"computed {actual:#010x}")


def unpack_frame(buf: bytes) -> Tuple[int, int, bytes, int]:
    """Decode one complete frame from the head of ``buf``; returns (kind,
    stream_id, payload, bytes consumed)."""
    kind, stream_id, length, crc = parse_frame_header(
        buf[:FRAME_HEADER_SIZE])
    end = FRAME_HEADER_SIZE + length
    if len(buf) < end:
        raise SerdeError(f"frame truncated: need {end} bytes, "
                         f"have {len(buf)}")
    payload = bytes(buf[FRAME_HEADER_SIZE:end])
    verify_frame_payload(kind, stream_id, payload, crc)
    return kind, stream_id, payload, end
