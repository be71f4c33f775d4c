"""The port's wire serde against the JAX package's: the same seeded
mixed-dtype trees encode to the same bytes under every wire codec, each
package decodes the other's buffers, and the frame layer's bytes and CRC
agree."""
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import serde as j_serde
from repro_torch.distributed import serde as t_serde

torch.set_num_threads(1)

_BF16 = np.dtype(ml_dtypes.bfloat16)


def _specials(dtype) -> np.ndarray:
    """NaN (two payloads), +-inf, +-0, the smallest subnormal and the
    largest finite value of ``dtype``, and a value that halves to a
    bfloat16 tie."""
    fi = np.finfo(dtype)
    return np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                     fi.smallest_subnormal, -fi.smallest_subnormal,
                     fi.max, -fi.max, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8],
                    dtype)


def _mixed(seed: int) -> dict:
    """A numpy tree with every dtype the wire carries, non-finite and
    signed-zero leaves among them. bfloat16 leaves are ml_dtypes arrays
    (the JAX side's type)."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((4, 6)).astype(np.float32)
    f32[0, :] = _specials(np.float32)[:6]
    f64 = (rng.standard_normal((3, 5)) * 1e3).astype(np.float64)
    f64.flat[:12] = _specials(np.float64)
    # float64 values between bfloat16 neighbours (round through float32)
    f64.flat[12] = 1.0 + 2.0 ** -8 + 2.0 ** -30
    f64.flat[13] = 1e39
    f64.flat[14] = 2.0 ** -140
    sub32 = (rng.integers(1, 1 << 23, (5,)).astype(np.uint32)
             .view(np.float32))              # float32 subnormals
    return {
        "obs_image": rng.integers(0, 2, (4, 3, 8, 8, 1)).astype(np.uint8)
        * 255,
        "lstm_state": (f32, f64),
        "rewards": rng.standard_normal((4, 3)).astype(np.float32),
        "done": rng.uniform(size=(4, 3)) < 0.3,
        "actions": rng.integers(0, 5, (4, 3)).astype(np.int32),
        "bf16": (rng.standard_normal((6, 7)) * 10).astype(_BF16),
        "f16": rng.standard_normal((9, 8)).astype(np.float16),
        "zeros": np.zeros((16, 4), np.float32),
        "sub": sub32,
        "nonfinite": np.array([1.0, np.inf, -2.0], np.float32),
        "scalar": np.float32(-0.0),
        "nested": {"none": None, "list": [np.arange(40, dtype=np.int32)]},
    }


def _to_port(tree):
    """The same tree for the port: bfloat16 leaves as torch.bfloat16
    tensors of the same bits, everything else as is."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_port(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype == _BF16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return tree


def _bits(x) -> np.ndarray:
    """The leaf's raw bytes as uint8, whichever package decoded it."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).ravel()


def _assert_same_leaves(got, want):
    g_leaves = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    w_leaves = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(_bits(g), _bits(w))


CODECS = ["none", "bf16", "int8"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_tree_bytes_equal_jax(codec, seed):
    tree = _mixed(seed)
    meta = {"v": seed}
    j_buf = j_serde.encode_tree(tree, meta, codec=codec)
    t_buf = t_serde.encode_tree(_to_port(tree), meta, codec=codec)
    assert t_buf == j_buf
    assert t_serde.tree_spec(_to_port(tree), codec) == \
        j_serde.tree_spec(tree, codec)
    assert t_serde.tree_nbytes(_to_port(tree)) == j_serde.tree_nbytes(tree)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_item_bytes_equal_jax_and_decode_across(codec, seed):
    tree = _mixed(seed)
    j_buf = j_serde.encode_item(j_serde.TrajectoryItem(tree, 7, 2, 1.25),
                                codec)
    t_buf = t_serde.encode_item(
        t_serde.TrajectoryItem(_to_port(tree), 7, 2, 1.25), codec)
    assert t_buf == j_buf
    # each package decodes the other's buffer to the same bits (to the
    # same quantized values under the lossy codecs)
    t_item = t_serde.decode_item(j_buf)
    j_item = j_serde.decode_item(t_buf)
    assert (t_item.param_version, t_item.actor_id, t_item.produced_at) \
        == (7, 2, 1.25)
    _assert_same_leaves(t_item.data, j_item.data)
    assert isinstance(t_item.data["bf16"], torch.Tensor)
    assert t_item.data["bf16"].dtype == torch.bfloat16
    if codec == "none":
        _assert_same_leaves(t_item.data, tree)
    else:
        # the V-trace leaves stay bit-exact; the observation side is
        # quantized only where it is float
        for k in ("rewards", "done", "actions", "obs_image"):
            np.testing.assert_array_equal(_bits(t_item.data[k]),
                                          _bits(tree[k]))


@pytest.mark.parametrize("codec", CODECS)
def test_encode_grads_bytes_equal_jax(codec):
    tree = _mixed(3)
    leaves = [tree["rewards"], tree["lstm_state"][0], tree["f16"],
              tree["bf16"], tree["zeros"]]
    j_buf = j_serde.encode_grads(leaves, round_idx=4, learner_id=1,
                                 version=9, codec=codec)
    t_buf = t_serde.encode_grads(_to_port(leaves), round_idx=4,
                                 learner_id=1, version=9, codec=codec)
    assert t_buf == j_buf
    t_leaves, meta = t_serde.decode_grads(j_buf)
    j_leaves, _ = j_serde.decode_grads(t_buf)
    assert meta == {"round": 4, "learner": 1, "version": 9}
    _assert_same_leaves(t_leaves, j_leaves)
    with pytest.raises(t_serde.SerdeError, match="list"):
        t_serde.decode_grads(t_serde.encode_tree({"a": np.zeros(2)}))


def test_bf16_rounding_equals_ml_dtypes_on_random_bits():
    """Every float32 class (normals, subnormals, NaN payloads, infs,
    zeros) and float64 values on both sides of bfloat16 ties round as
    ``ml_dtypes`` rounds them."""
    rng = np.random.default_rng(5)
    f32 = rng.integers(0, 1 << 32, 200_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want32 = f32.astype(_BF16).view(np.uint16)
    np.testing.assert_array_equal(t_serde.f32_to_bf16_bits(f32), want32)
    ties = (np.float64(1.0) + rng.integers(0, 256, 1000) * 2.0 ** -8
            + rng.choice([-1, 1], 1000) * 2.0 ** -9
            + rng.choice([-1, 0, 1], 1000) * 2.0 ** -40)
    f64 = np.concatenate([ties, rng.standard_normal(1000) * 1e300,
                          rng.standard_normal(1000) * 1e-300,
                          _specials(np.float64)])
    with np.errstate(invalid="ignore", over="ignore"):
        want64 = f64.astype(_BF16).view(np.uint16)
    np.testing.assert_array_equal(t_serde.f32_to_bf16_bits(f64), want64)


def test_decode_tree_into_fills_tensors_and_arrays_in_place():
    src = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": (np.ones(3, np.float64), np.int32(7)),
           "h": _to_port({"x": np.full((2,), 1.5, _BF16)})["x"]}
    buf = t_serde.encode_tree(src, {"version": 3})
    dst = {"w": torch.zeros(2, 3, requires_grad=True),
           "b": (np.zeros(3, np.float64), np.zeros((), np.int32)),
           "h": torch.zeros(2, dtype=torch.bfloat16)}
    w_before = dst["w"]
    assert t_serde.decode_tree_into(buf, dst) == {"version": 3}
    assert dst["w"] is w_before
    np.testing.assert_array_equal(dst["w"].detach().numpy(), src["w"])
    np.testing.assert_array_equal(dst["b"][0], src["b"][0])
    assert int(dst["b"][1]) == 7
    assert torch.equal(dst["h"], src["h"])
    # a lossy buffer fills the same tree with the dequantized values
    q = t_serde.encode_tree(src, codec="bf16")
    t_serde.decode_tree_into(q, dst)
    np.testing.assert_array_equal(dst["w"].detach().numpy(), src["w"])
    with pytest.raises(t_serde.SerdeError, match=r"\$/w"):
        t_serde.decode_tree_into(buf, {"w": torch.zeros(3, 2),
                                       "b": dst["b"], "h": dst["h"]})
    with pytest.raises(t_serde.SerdeError, match="keys"):
        t_serde.decode_tree_into(buf, {"w": dst["w"]})


@pytest.mark.parametrize("payload", [b"", b"x", bytes(range(256)) * 9])
def test_frames_equal_jax_and_reject_corruption(payload):
    frame = t_serde.pack_frame(7, 0xDEADBEEF, payload)
    assert frame == j_serde.pack_frame(7, 0xDEADBEEF, payload)
    assert t_serde.frame_crc(7, 3, payload) == \
        j_serde.frame_crc(7, 3, payload)
    kind, stream, got, used = t_serde.unpack_frame(frame + b"tail")
    assert (kind, stream, got, used) == (7, 0xDEADBEEF, payload,
                                         len(frame))
    assert t_serde.parse_frame_header(frame[:t_serde.FRAME_HEADER_SIZE]) \
        == j_serde.parse_frame_header(frame[:j_serde.FRAME_HEADER_SIZE])
    # a flipped routing bit or payload bit fails the CRC
    bad = bytearray(frame)
    bad[5] ^= 1
    with pytest.raises(t_serde.SerdeError, match="crc"):
        t_serde.unpack_frame(bytes(bad))
    if payload:
        bad = bytearray(frame)
        bad[-1] ^= 0x80
        with pytest.raises(t_serde.SerdeError, match="crc"):
            t_serde.unpack_frame(bytes(bad))
        with pytest.raises(t_serde.SerdeError, match="truncated"):
            t_serde.unpack_frame(frame[:-1])
    with pytest.raises(t_serde.SerdeError, match="magic"):
        t_serde.unpack_frame(b"XXXX" + frame[4:])


def test_unknown_codec_and_corrupt_leaf_fail_loudly():
    with pytest.raises(t_serde.CodecMismatchError, match="zstd"):
        t_serde.encode_tree({"a": np.zeros(3, np.float32)}, codec="zstd")
    buf = t_serde.encode_tree({"a": np.zeros(64, np.int32)}, codec="int8")
    header_len = int.from_bytes(buf[4:8], "little")
    spec = json.loads(buf[8:8 + header_len])
    assert spec["tree"]["children"][0]["enc"] == "z"
    corrupt = buf[:8 + header_len] + b"\x00" * (len(buf) - 8 - header_len)
    with pytest.raises(t_serde.SerdeError, match="corrupt"):
        t_serde.decode_tree(corrupt)
