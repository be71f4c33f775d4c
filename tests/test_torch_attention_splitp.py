"""The numerics of the tensor-core flash attention (K4) and the plan of the
pipelined decode attention (K5), on the CPU.

* ``splitp_emulation`` repeats, in plain PyTorch, the arithmetic of K4's
  bf16 kernel (``csrc/flash_attention.cu``): the same 128-row query tiles
  and kv tiles (128 keys, 64 at D = 256) in the same order, the online
  softmax in float32, the probabilities P split into P_hi = bf16(P) and
  P_lo = bf16(P - P_hi) before the products with V, both summed in f32,
  and one rounding to bf16 at the end. It is held against
  ``flash_attention_pallas`` in interpret mode at the tolerance
  ``chip_smoke.py`` holds the kernel to on the card (ATTN_BF16_*: one bf16
  ulp, 2^-7 relative, plus 1e-5).
* The same emulation with P rounded once to bf16 (what FlashAttention and
  the library call do) breaks that tolerance at the serving shape: the
  reason for the split, pinned.
* K5's plan: every key falls in exactly one (split, warp), as the kernel's
  loop bounds assign them; split lengths are multiples of the warp tile;
  no split is empty; long caches get at least two blocks an SM.

Inputs are standard normals drawn with numpy from seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.kernels import decode_attention as dk

torch.set_num_threads(1)

NEG_INF = -1e30
BLOCK_M = 128                    # query rows a block of the kernel
ATTN_BF16_ATOL, ATTN_BF16_RTOL = 1e-5, 2.0 ** -7


def kv_tile(d: int) -> int:
    """Keys a kv tile of the kernel (``Cfg<D>::kBN``)."""
    return 64 if d == 256 else 128


def splitp_emulation(q, k, v, causal: bool, window: int,
                     split: bool = True) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, S, K, D) bf16 -> (B, T, H, D) bf16, as K4's
    bf16 kernel rounds; ``split=False`` rounds P once to bf16 instead."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    bn = kv_tile(d)
    qf = q.float().reshape(b, t, kh, g, d).permute(0, 2, 3, 1, 4)
    pad = (0, 0, 0, 0, 0, bn)        # the TMA box's zero fill past S
    kf = torch.nn.functional.pad(k.float(), pad).permute(0, 2, 1, 3)
    vf = torch.nn.functional.pad(v.float(), pad).permute(0, 2, 1, 3)
    out = torch.zeros(b, kh, g, t, d)
    for q0 in range(0, t, BLOCK_M):
        rows = min(BLOCK_M, t - q0)
        kv_lo = max(0, q0 - window + 1) if window else 0
        kv_hi = min(s, q0 + rows) if causal else s
        qt = qf[:, :, :, q0:q0 + rows]
        qpos = torch.arange(q0, q0 + rows)[:, None]
        m = torch.full((b, kh, g, rows), NEG_INF)
        l = torch.zeros(b, kh, g, rows)
        acc = torch.zeros(b, kh, g, rows, d)
        for kv0 in range(kv_lo, kv_hi, bn):
            kt = kf[:, :, None, kv0:kv0 + bn]
            vt = vf[:, :, None, kv0:kv0 + bn]
            sc = torch.matmul(qt, kt.transpose(-1, -2)) * d ** -0.5
            kpos = torch.arange(kv0, kv0 + bn)[None, :]
            ok = kpos < s
            if causal:
                ok = ok & (kpos <= qpos)
            if window:
                ok = ok & (kpos > qpos - window)
            sc = torch.where(ok, sc, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            if split:
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                pv = torch.matmul(hi, vt) + torch.matmul(lo, vt)
            else:
                pv = torch.matmul(p.to(torch.bfloat16).float(), vt)
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, :, q0:q0 + rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(torch.bfloat16)


def _inputs(b, t, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, kh, d), (b, s, kh, d))]


def _pallas_bf16(q, k, v, causal, window, block=64):
    want = flash_attention_pallas(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        window=window, q_block=block, kv_block=block, interpret=True)
    return torch.from_numpy(np.asarray(want, np.float32))


def _over(got, want) -> int:
    """Outputs past chip_smoke's bf16 tolerance."""
    allow = ATTN_BF16_ATOL + ATTN_BF16_RTOL * want.abs()
    return int(((got.float() - want).abs() > allow).sum())


@pytest.mark.parametrize("b,t,s,h,kh,d,causal,window", [
    (1, 40, 40, 4, 2, 32, True, 0),        # G = 2, D = 32 (64-byte rows)
    (2, 37, 37, 4, 1, 64, True, 0),        # G = 4, ragged T
    (1, 30, 45, 2, 2, 128, True, 0),       # G = 1, S > T
    (1, 45, 30, 4, 1, 128, True, 0),       # S < T
    (1, 50, 50, 4, 1, 64, True, 12),       # window
    (1, 33, 33, 2, 2, 256, False, 0),      # non-causal, D = 256 (64 keys)
    (1, 200, 330, 4, 1, 64, True, 0),      # two query tiles, ragged kv
    (1, 300, 300, 4, 4, 32, True, 64),     # window across query tiles
])
def test_splitp_emulation_matches_pallas_interpret(b, t, s, h, kh, d, causal,
                                                   window):
    q, k, v = _inputs(b, t, s, h, kh, d, t * 7 + s + d)
    want = _pallas_bf16(q, k, v, causal, window)
    got = splitp_emulation(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal, window)
    assert got.dtype == torch.bfloat16
    assert _over(got, want) == 0, float((got.float() - want).abs().max())


def test_bf16_p_breaks_the_tolerance_that_split_p_keeps():
    """The serving path's prefill heads at B = 2 (T = S = 128, 32 heads
    over 8 kv heads, D = 128, causal): P rounded once to bf16 puts several
    percent of the outputs past one bf16 ulp of the reference; P_hi + P_lo
    puts none."""
    q, k, v = _inputs(2, 128, 128, 32, 8, 128, 14)
    want = _pallas_bf16(q, k, v, True, 0, block=128)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    over_bf16_p = _over(splitp_emulation(tq, tk, tv, True, 0, split=False),
                        want)
    over_split = _over(splitp_emulation(tq, tk, tv, True, 0), want)
    assert over_split == 0
    assert over_bf16_p > 0.01 * want.numel(), over_bf16_p


# ---------------------------------------------------------------------------
# K5's plan


def kernel_key_owners(s: int, nsplit: int, split_len: int,
                      tile: int) -> np.ndarray:
    """(split, warp) of each key as the kernel's loop bounds give them
    (``decode_attention.cu``: split_tiles, my_tiles, s0), with -1 for a
    key no warp reads and -2 for a key read twice."""
    owner = np.full((s, 2), -1)
    for z in range(nsplit):
        s_lo = z * split_len
        s_hi = min(s, s_lo + split_len)
        split_tiles = -(-(s_hi - s_lo) // tile)
        for w in range(dk.WARPS):
            my_tiles = -(-(split_tiles - w) // dk.WARPS) \
                if split_tiles > w else 0
            for n in range(my_tiles):
                s0 = s_lo + (w + n * dk.WARPS) * tile
                for key in range(s0, min(s0 + tile, s_hi)):
                    owner[key] = (z, w) if owner[key, 0] == -1 else (-2, -2)
    return owner


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,kh,s,d,itemsize", [
    (16, 8, 128, 128, 2),         # the serving path's decode: one split
    (8, 8, 32768, 128, 2),        # decode_32k
    (4, 8, 4097, 128, 2),         # one key past a power of two
    (4, 8, 1000, 128, 4),         # float32 (4-key tiles at D = 128)
    (4, 2, 65, 128, 2),           # G = 16's kv heads, a short cache
    (3, 8, 1, 64, 2),             # S = 1
    (2, 4, 17, 32, 2),            # 32-key tiles at D = 32
    (1, 8, 5000, 256, 2),         # 4-key tiles at D = 256
    (1, 8, 131072, 128, 2),       # one sequence, a long cache
])
def test_decode_plan_covers_every_key_once(b, kh, s, d, itemsize, sms):
    nsplit, split_len = dk.plan_splits(b, kh, s, sms)
    tile = dk.tile_keys(d, itemsize)
    assert dk.CHUNK % tile == 0 and split_len % tile == 0
    assert split_len % dk.CHUNK == 0
    assert (nsplit - 1) * split_len < s <= nsplit * split_len  # none empty
    owner = kernel_key_owners(s, nsplit, split_len, tile)
    assert (owner >= 0).all(), "a key read by no warp, or by two"
    # split z holds keys [z * split_len, (z + 1) * split_len); its warp w
    # the tiles w, w + WARPS, ... of them
    key = np.arange(s)
    np.testing.assert_array_equal(owner[:, 0], key // split_len)
    np.testing.assert_array_equal(owner[:, 1],
                                  key % split_len // tile % dk.WARPS)
    if s >= 4 * sms * dk.MIN_SPLIT // (b * kh):
        # a long cache: at least two waves of one block an SM
        assert b * kh * nsplit >= 2 * sms, (nsplit, split_len)


def test_decode_tiles_are_2kb_of_k_rows():
    assert [dk.tile_keys(d, 2) for d in (32, 64, 128, 256)] == \
        [32, 16, 8, 4]
    assert [dk.tile_keys(d, 4) for d in (32, 64, 128, 256)] == \
        [16, 8, 4, 4]
