"""Plain-PyTorch oracle for the V-trace kernel (``repro.kernels.ref``).

The oracles of the token kernels (linear scan, flash and decode
attention) join with those kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch


def vtrace_ref(rho, c, discounts, rewards, values, values_tp1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All inputs (T, B) float32 (time-major, matching the kernel layout).

    acc_s = delta_s + disc_s * c_s * acc_{s+1};  vs_s = v_s + acc_s
    pg_adv_s = rho_s * (r_s + disc_s * (v_tp1_s + acc_{s+1}) - v_s)
    Returns (vs, pg_adv), each (T, B).
    """
    t = rho.shape[0]
    acc = torch.zeros_like(rho[0])
    vs = [None] * t
    pg = [None] * t
    for s in reversed(range(t)):
        pg[s] = rho[s] * (rewards[s] + discounts[s] * (values_tp1[s] + acc)
                          - values[s])
        delta = rho[s] * (rewards[s] + discounts[s] * values_tp1[s]
                          - values[s])
        acc = delta + discounts[s] * c[s] * acc
        vs[s] = values[s] + acc
    return torch.stack(vs, dim=0), torch.stack(pg, dim=0)
