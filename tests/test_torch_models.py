"""The port's models and weights bridge against the JAX package.

One parameter tree in the JAX layout, drawn with numpy from a seed at the
shapes and scales of the JAX spec tree, goes to both packages (to the
port through ``repro_torch.params.from_jax``); inputs are made with numpy
from a seed. Tolerances: the torsos and the LSTM at 1e-5 (f32 sums
of a few hundred terms in another order); the whole trajectory forward at
full width (a 3456-wide fc at 72x96, LSTM 256) at 1e-4, the slack of f32
conv and matmul sums taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.registry import get_config as j_get_config
from repro.core import learner as j_learner
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.models import convnets as j_conv
from repro.models import lstm as j_lstm

from repro_torch import params as P
from repro_torch.configs.registry import get_config
from repro_torch.core import learner
from repro_torch.models import backbone as bb
from repro_torch.models import common
from repro_torch.models import convnets
from repro_torch.models import lstm

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_params(specs, seed=0):
    """numpy leaves at each JAX Spec's shape: normal with the JAX init's
    std for kernels, small normal values for biases (not zeros, so a
    wrong bias layout shows)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 \
            else spec.shape[0]
        std = spec.scale / np.sqrt(fan_in) if spec.init == "normal" else 0.1
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)

    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: isinstance(x, j_common.Spec))


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(),
                               **(tol or TOL))


def _images(n, hw, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n,) + tuple(hw)) < 0.3).astype(np.uint8) * \
        rng.integers(0, 256, (n,) + tuple(hw)).astype(np.uint8)


# ---------------------------------------------------------------------------
# specs and the bridge


@pytest.mark.parametrize("arch,hw", [("impala-shallow", (10, 5, 3)),
                                     ("impala-deep", (72, 96, 3))])
def test_specs_match_jax_and_the_bridge_round_trips(arch, hw):
    j_arch = j_get_config(arch).replace(image_hw=hw)
    t_arch = get_config(arch).replace(image_hw=hw)
    j_specs = j_bb.backbone_specs(j_arch, 3)
    t_specs = bb.backbone_specs(t_arch, 3)
    assert common.param_count(t_specs) == j_common.param_count(j_specs)
    j_shapes = {k: s.shape for k, s in P.flatten(j_specs).items()}
    t_shapes = {k: s.shape for k, s in P.flatten(t_specs).items()}
    assert j_shapes == t_shapes

    tree = _jax_params(j_specs)
    port = P.from_jax(tree)
    # checkpoint keys: the port's flatten gives the npz's leaf names
    assert sorted(P.flatten(port)) == sorted(_flatten_with_paths(tree))
    conv1 = port["torso"]["conv1" if arch == "impala-shallow"
                          else "section0"]
    kernel = conv1["kernel"] if "kernel" in conv1 else conv1["conv"]["kernel"]
    assert kernel.dim() == 4 and kernel.shape[1] == 3     # OIHW
    back = P.to_jax(port)
    for k, v in P.flatten(tree).items():
        np.testing.assert_array_equal(P.flatten(back)[k], np.asarray(v))


def test_init_params_draws_the_reference_distributions():
    specs = bb.backbone_specs(get_config("impala-shallow"), 3)
    tree = common.init_params(specs, seed=0)
    again = common.init_params(specs, seed=0)
    fc = tree["torso"]["fc"]["kernel"]
    assert torch.equal(fc, again["torso"]["fc"]["kernel"])
    # normal with std = scale / sqrt(prod(shape[:-1]))
    np.testing.assert_allclose(float(fc.std()), 1 / np.sqrt(fc.shape[0]),
                               rtol=0.02)
    policy = tree["policy"]["kernel"]
    np.testing.assert_allclose(float(policy.std()),
                               0.01 / np.sqrt(policy.shape[0]), rtol=0.1)
    assert not tree["torso"]["fc"]["bias"].any()


# ---------------------------------------------------------------------------
# SAME padding and the torsos


def test_same_padding_is_xla_asymmetric_on_the_catch_frame():
    assert convnets.same_pads(10, 8, 4) == (3, 3)     # conv1, H
    assert convnets.same_pads(5, 8, 4) == (3, 4)      # conv1, W
    assert convnets.same_pads(3, 4, 2) == (1, 2)      # conv2, H
    assert convnets.same_pads(2, 4, 2) == (1, 1)      # conv2, W
    port = P.from_jax(_jax_params(j_conv.shallow_specs((10, 5, 3))))
    x = convnets._to_nchw(torch.zeros(1, 10, 5, 3, dtype=torch.uint8))
    assert convnets._conv(port["conv1"], x, 4).shape[2:] == (3, 2)


@pytest.mark.parametrize("hw", [(10, 5, 3), (72, 96, 3)])
def test_shallow_torso_matches_jax(hw):
    specs = j_conv.shallow_specs(hw)
    tree = _jax_params(specs, seed=1)
    img = _images(3, hw, seed=2)
    want = j_conv.shallow_apply(tree, jnp.asarray(img))
    got = convnets.shallow_apply(P.from_jax(tree), torch.from_numpy(img))
    _close(want, got)


def test_deep_torso_matches_jax():
    hw = (72, 96, 3)
    tree = _jax_params(j_conv.deep_specs(hw), seed=3)
    img = _images(2, hw, seed=4)
    want = j_conv.deep_apply(tree, jnp.asarray(img))
    got = convnets.deep_apply(P.from_jax(tree), torch.from_numpy(img))
    _close(want, got)


def test_maxpool_pads_with_minus_infinity():
    rng = np.random.default_rng(5)
    x = -np.abs(rng.standard_normal((2, 7, 9, 3))).astype(np.float32) - 1.0
    want = j_conv._maxpool(jnp.asarray(x))
    got = convnets._maxpool(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(want, got.permute(0, 2, 3, 1), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# LSTM


def test_lstm_with_mid_trajectory_resets_matches_jax():
    b, t, d_in, w = 3, 6, 5, 8
    tree = _jax_params(j_lstm.lstm_specs(d_in, w), seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, d_in)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    c0 = rng.standard_normal((b, w)).astype(np.float32)
    done = np.zeros((b, t), bool)
    done[0, 0] = done[1, 3] = done[2, 5] = True
    ys_j, (h_j, c_j) = j_lstm.lstm_apply(tree, jnp.asarray(x),
                                         (jnp.asarray(h0), jnp.asarray(c0)),
                                         done=jnp.asarray(done))
    ys, (h, c) = lstm.lstm_apply(P.from_jax(tree), torch.from_numpy(x),
                                 (torch.from_numpy(h0), torch.from_numpy(c0)),
                                 done=torch.from_numpy(done))
    _close(ys_j, ys)
    _close(h_j, h)
    _close(c_j, c)
    # a reset before step 3 makes row 1 forget its initial state there
    ys2, _ = lstm.lstm_apply(P.from_jax(tree), torch.from_numpy(x),
                             (torch.zeros(b, w), torch.zeros(b, w)),
                             done=torch.from_numpy(done))
    torch.testing.assert_close(ys[1, 3:], ys2[1, 3:])
    assert not torch.allclose(ys[1, :3], ys2[1, :3])


# ---------------------------------------------------------------------------
# the whole trajectory forward


def _trajectory_batch(b, t, hw, num_actions, width, seed):
    rng = np.random.default_rng(seed)
    done_in = rng.uniform(size=(b, t + 1)) < 0.2
    return {
        "obs_image": _images(b * (t + 1), hw, seed).reshape(
            (b, t + 1) + tuple(hw)),
        "last_action": rng.integers(0, num_actions, (b, t + 1)).astype(
            np.int32),
        "last_reward": rng.choice([-1.0, 0.0, 1.0], (b, t + 1)).astype(
            np.float32),
        "done_in": done_in,
        "lstm_state": tuple(rng.standard_normal((b, width)).astype(
            np.float32) * 0.5 for _ in range(2)),
    }


def _to_jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def _to_torch(batch):
    return {k: (tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
                else torch.from_numpy(v)) for k, v in batch.items()}


def test_forward_trajectory_full_width_shallow_on_catch_matches_jax():
    arch_j = j_get_config("impala-shallow").replace(image_hw=(10, 5, 3))
    arch_t = get_config("impala-shallow").replace(image_hw=(10, 5, 3))
    assert arch_t.lstm_width == 256
    tree = _jax_params(j_bb.backbone_specs(arch_j, 3), seed=8)
    batch = _trajectory_batch(4, 5, (10, 5, 3), 3, 256, seed=9)
    lj, vj, _ = j_learner.forward_trajectory(tree, _to_jax(batch), arch_j, 3)
    lt, vt, _ = learner.forward_trajectory(P.from_jax(tree),
                                           _to_torch(batch), arch_t, 3)
    assert tuple(lt.shape) == (4, 6, 3) and tuple(vt.shape) == (4, 6)
    _close(lj, lt, atol=1e-4, rtol=1e-4)
    _close(vj, vt, atol=1e-4, rtol=1e-4)


def test_forward_trajectory_deep_at_72x96_matches_jax():
    arch_j = j_get_config("impala-deep").replace(lstm_width=32)
    arch_t = get_config("impala-deep").replace(lstm_width=32)
    tree = _jax_params(j_bb.backbone_specs(arch_j, 4), seed=10)
    batch = _trajectory_batch(2, 2, (72, 96, 3), 4, 32, seed=11)
    lj, vj, _ = j_learner.forward_trajectory(tree, _to_jax(batch), arch_j, 4)
    lt, vt, _ = learner.forward_trajectory(P.from_jax(tree),
                                           _to_torch(batch), arch_t, 4)
    _close(lj, lt, atol=1e-4, rtol=1e-4)
    _close(vj, vt, atol=1e-4, rtol=1e-4)
