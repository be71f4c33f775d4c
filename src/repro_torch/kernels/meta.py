"""The kernels' ``meta`` route: what a kernel wrapper does with tensors on
PyTorch's ``meta`` device, which have shapes and dtypes and no storage.

The dry run (``repro_torch.launch.dryrun``) traces a whole step on meta
tensors. A wrapper given meta tensors returns empty meta outputs of the
kernel's shapes and dtypes, with no loop (K1-K3's plain versions loop over
T, 32,768 steps a layer at ``prefill_32k``), and reports the kernel's cost
to every ``counting()`` block open in this thread: the operations its
plain version counts under ``torch.utils.flop_counter.FlopCounterMode`` at
the same shapes (K1-K3 have no matrix product, so none; K4 and K5 their
two einsums), and the bytes of the kernel's operands and results, each
read or written once. Only meta tensors take this route: a CUDA tensor
launches the kernel or raises, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Sequence

_state = threading.local()


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, float]]:
    """Collect the cost the meta route reports while the block runs:
    ``{"flops": ..., "bytes": ..., "launches": ...}``. Blocks nest."""
    cost = {"flops": 0.0, "bytes": 0.0, "launches": 0}
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(cost)
    try:
        yield cost
    finally:
        stack.remove(cost)


def nbytes(tensors: Sequence) -> int:
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None)


def report(flops: float, inputs: Sequence, outputs: Sequence) -> None:
    """Add one kernel launch's operations and bytes to every open
    ``counting()`` block."""
    moved = nbytes(inputs) + nbytes(outputs)
    for cost in getattr(_state, "stack", ()):
        cost["flops"] += flops
        cost["bytes"] += moved
        cost["launches"] += 1


def attention_flops(b: int, h: int, t: int, s: int, d: int) -> float:
    """The plain versions' matrix products as the flop counter counts
    them: q·kᵀ and p·v, 2 b h t s d each, masked positions included."""
    return 4.0 * b * h * t * s * d
