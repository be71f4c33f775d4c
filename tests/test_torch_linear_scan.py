"""K3, the linear scan: the port's wrapper (its plain version on the CPU),
``ops.linear_scan`` and ``ref.linear_scan_ref`` against the JAX
package's ``linear_scan_pallas`` in interpret mode and its oracle.

Inputs are drawn with numpy from seeds (a in [0, 1], as the decays of the
SSM and the RG-LRU are) and handed to both packages. Tolerance 1e-5
absolute and relative: the same multiply-then-add per step in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.linear_scan import linear_scan_pallas

from repro_torch.kernels import linear_scan as lk
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (t, n)).astype(np.float32)
    b = rng.standard_normal((t, n)).astype(np.float32)
    h0 = rng.standard_normal(n).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("t,n", [(1, 1), (16, 64), (100, 300), (512, 1024),
                                 (33, 7), (257, 129)])
def test_k3_plain_matches_pallas_interpret_and_ref(t, n, with_h0):
    a, b, h0 = _inputs(t, n, t * 1000 + n)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = np.asarray(linear_scan_pallas(jnp.asarray(a), jnp.asarray(b), jh0,
                                         t_chunk=64, n_block=128,
                                         interpret=True))
    np.testing.assert_allclose(
        np.asarray(j_ref.linear_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                         jh0)), want, **TOL)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    th0 = None if h0 is None else torch.from_numpy(h0)
    lk.reset_launch_counts()
    got = lk.linear_scan(ta, tb, th0)
    assert got.shape == (t, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the oracle, and both routes of ops, give the wrapper's numbers
    for other in (ref.linear_scan_ref(ta, tb, th0),
                  ops.linear_scan(ta, tb, th0),
                  ops.linear_scan(ta, tb, th0, impl="pallas"),
                  ops.linear_scan(ta, tb, th0, impl="ref")):
        torch.testing.assert_close(other, got, rtol=0, atol=0)
    assert lk.linear_scan.launches == 0     # plain versions on the CPU


def test_ops_linear_scan_casts_to_f32_and_refuses_an_unknown_route():
    a, b, h0 = _inputs(9, 5, 0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = ops.linear_scan(ta.to(torch.bfloat16), tb.to(torch.bfloat16),
                          torch.from_numpy(h0))
    assert got.dtype == torch.float32
    want = ref.linear_scan_ref(ta.to(torch.bfloat16).float(),
                               tb.to(torch.bfloat16).float(),
                               torch.from_numpy(h0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.linear_scan(ta, tb, impl="triton")


def test_linear_scan_ref_multiplies_then_adds():
    """Each step is a rounded multiply, then a rounded add, as the kernel
    built with -fmad=false does: with a = h0 = 1 + 2^-23 and b = -1 the
    product rounds to 1 + 2^-22, so h = 2^-22; a fused multiply-add would
    keep the 2^-46 term."""
    a = torch.tensor([[1.0 + 2.0 ** -23]], dtype=torch.float32)
    h0 = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32)
    b = torch.tensor([[-1.0]], dtype=torch.float32)
    got = ref.linear_scan_ref(a, b, h0)
    assert float(got[0, 0]) == 2.0 ** -22
