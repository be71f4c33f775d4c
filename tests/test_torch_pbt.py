"""The port's ``PBTController`` against the JAX package's, and its
exploit's copy semantics.

The controller is numpy on both sides and draws from
``np.random.default_rng(seed)`` in the same order, so the same seed and
the same fitness reports must give equal hyperparameters, ``copied``
flags, ``copied_from`` and ``best()``, exactly. The port's weights are
trees of tensors that its optimizer updates in place, so an exploit must
copy the source's tree: training the copy leaves the source as it was.
"""
import numpy as np
import pytest
import torch

from repro.core.pbt import PBTController as JaxPBT

from repro_torch.core.pbt import PBTController

torch.set_num_threads(1)


def _tree(value: float):
    return {"torso": {"w": torch.full((3, 2), value, requires_grad=True)},
            "b": torch.full((2,), value, requires_grad=True)}


@pytest.mark.parametrize("seed,pop", [(0, 4), (3, 6), (11, 2)])
def test_controller_matches_jax_report_for_report(seed, pop):
    j_pbt, t_pbt = JaxPBT(pop, seed=seed, burn_in_steps=2), \
        PBTController(pop, seed=seed, burn_in_steps=2)
    assert [m.hypers for m in t_pbt.members] == \
        [m.hypers for m in j_pbt.members]
    j_w = [f"w{i}" for i in range(pop)]
    t_w = [_tree(float(i)) for i in range(pop)]
    rng = np.random.default_rng(seed + 100)
    copies = 0
    for rnd in range(6):
        for i in range(pop):
            f = float(rng.uniform(-1.0, 1.0))
            j_pbt.report_fitness(i, f)
            t_pbt.report_fitness(i, f)
        for i in range(pop):
            jh, jc = j_pbt.exploit_explore(i, rnd, j_w)
            th, tc = t_pbt.exploit_explore(i, rnd, t_w)
            assert (th, tc) == (jh, jc), (rnd, i)
            copies += tc
        assert [(m.hypers, m.fitness, m.copied_from)
                for m in t_pbt.members] == \
            [(m.hypers, m.fitness, m.copied_from) for m in j_pbt.members]
        assert t_pbt.best() == j_pbt.best()
        # the port's slots hold what the JAX slots name
        for i in range(pop):
            src = int(j_w[i][1:])
            assert float(t_w[i]["b"].detach()[0]) == float(src)
    assert copies > 0


# ---------------------------------------------------------------------------
# tests/test_core.py's PBT cases, with tensor trees for weights


def test_pbt_exploit_copies_better_member():
    c = PBTController(pop_size=2, seed=0, threshold=0.05)
    c.report_fitness(0, 0.1)
    c.report_fitness(1, 0.9)
    weights = [_tree(0.0), _tree(1.0)]
    copied_any = False
    for _ in range(10):
        _, copied = c.exploit_explore(0, step=100, weights=weights)
        copied_any |= copied
    assert copied_any
    assert torch.equal(weights[0]["torso"]["w"], weights[1]["torso"]["w"])
    assert c.members[0].copied_from == 1


def test_pbt_burn_in_blocks_exploit():
    c = PBTController(pop_size=2, seed=0, burn_in_steps=1000)
    c.report_fitness(0, 0.0)
    c.report_fitness(1, 1.0)
    weights = [_tree(0.0), _tree(1.0)]
    _, copied = c.exploit_explore(0, step=10, weights=weights)
    assert not copied and float(weights[0]["b"].detach()[0]) == 0.0


def test_pbt_explore_perturbs_by_factor():
    c = PBTController(pop_size=1, seed=0)
    h0 = dict(c.members[0].hypers)
    for _ in range(50):
        c.exploit_explore(0, step=0, weights=[_tree(0.0)])
    h1 = c.members[0].hypers
    for k in h0:
        ratio = np.log(h1[k] / h0[k]) / np.log(1.2)
        assert abs(ratio - round(ratio)) < 1e-6  # power of 1.2 exactly


def test_exploit_is_a_copy_not_an_alias():
    """The copy is trainable where the source is, shares no storage with
    it, and an in-place update of the copy (what the port's optimizer
    does) leaves the source as it was."""
    c = PBTController(pop_size=2, seed=0)
    c.report_fitness(0, -1.0)
    c.report_fitness(1, 1.0)
    weights = [_tree(0.0), _tree(1.0)]
    source = weights[1]
    while not c.exploit_explore(0, step=0, weights=weights)[1]:
        pass
    assert weights[1] is source
    for got, src in ((weights[0]["b"], source["b"]),
                     (weights[0]["torso"]["w"], source["torso"]["w"])):
        assert got.requires_grad and got.is_leaf
        assert got.data_ptr() != src.data_ptr()
        with torch.no_grad():
            got.add_(5.0)
        assert torch.equal(src, torch.full_like(src, 1.0))
